"""`InfoModelSpec`, the frozen description of an agent-level information
model: the port of ``sbr_tpu.infomodels.spec``, with the same fields,
defaults, validation, errors and wire form.

Three orthogonal axes:

- ``channel``: "gossip" (the SI rumor channel of ``social.agents``) or
  "bayes" (Bayesian withdrawal-observers: each agent accumulates the
  naive-Bayes log-likelihood ratio of its in-neighbours' withdrawals and
  joins the run the first time awareness·belief crosses its private
  logistic threshold);
- ``dynamics``: "static" (one graph) or "rewire" (panic rewiring; the
  port's engine does not run it yet);
- ``groups``: K groups of (weight, threshold, awareness), or ``()`` for a
  homogeneous population.

`infomodel_fingerprint` keys infomodel products on the spec, as the
reference's does, and equals its hex on the same inputs.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Tuple

from sbr_tpu_torch.utils.checkpoint import dtype_name, params_fingerprint

CHANNELS = ("gossip", "bayes")
DYNAMICS = ("static", "rewire")

# The version of the engine's numerics, as in the JAX package: part of
# every infomodel fingerprint there, so a cache never serves bytes from an
# older belief/rewire law.
INFOMODEL_PROGRAM_VERSION = 1


@dataclasses.dataclass(frozen=True)
class InfoModelSpec:
    """One information model (see module docstring).

    A plain frozen dataclass: hashable and comparable, so a spec can key a
    cache and a parsed wire form compares equal to the spec it came
    from."""

    channel: str = "gossip"
    dynamics: str = "static"
    # Bayes observation channel: per-observation withdrawal probabilities
    # under the run / calm hypotheses (llr constants derive from these).
    # The defaults are calibrated so the Figure-12 economics produce a
    # Bayesian run: q_calm ≪ q_run makes withdrawal sightings strong
    # evidence, and the logistic threshold tail supplies the panic-prone
    # cohort that bootstraps the cascade.
    q_run: float = 0.35
    q_calm: float = 1e-3
    # Group-mean log-odds threshold and the logistic spread of private
    # thresholds around it (s > 0 keeps the population curve smooth and
    # the mean-field CDF closed-form).
    threshold: float = 3.0
    threshold_scale: float = 1.5
    awareness: float = 3.0
    # K-group heterogeneity: ((weight, threshold, awareness), ...);
    # weights must sum to 1. () = homogeneous.
    groups: Tuple[Tuple[float, float, float], ...] = ()
    # Panic rewiring: steps per epoch and the attention tilt.
    epoch_steps: int = 25
    rewire_bias: float = 4.0

    def __post_init__(self):
        if self.channel not in CHANNELS:
            raise ValueError(
                f"unknown channel {self.channel!r}; expected one of {CHANNELS}"
            )
        if self.dynamics not in DYNAMICS:
            raise ValueError(
                f"unknown dynamics {self.dynamics!r}; expected one of {DYNAMICS}"
            )
        if not (0.0 < self.q_calm < self.q_run < 1.0):
            raise ValueError(
                f"need 0 < q_calm < q_run < 1, got q_calm={self.q_calm}, "
                f"q_run={self.q_run}"
            )
        if not (self.threshold_scale > 0):
            raise ValueError("threshold_scale must be positive")
        if not (self.awareness > 0):
            raise ValueError("awareness must be positive")
        groups = tuple(
            (float(w), float(t), float(a)) for w, t, a in self.groups
        )
        object.__setattr__(self, "groups", groups)
        if groups:
            if len(groups) < 2:
                raise ValueError(
                    "groups needs K >= 2 entries (use the scalar "
                    "threshold/awareness fields for a homogeneous model)"
                )
            if any(w < 0 for w, _, _ in groups):
                raise ValueError("group weights must be non-negative")
            if abs(sum(w for w, _, _ in groups) - 1.0) > 1e-10:
                raise ValueError(
                    f"group weights must sum to 1, got "
                    f"{sum(w for w, _, _ in groups)}"
                )
            if any(a <= 0 for _, _, a in groups):
                raise ValueError("group awareness values must be positive")
        if self.epoch_steps < 1:
            raise ValueError("epoch_steps must be >= 1")
        if self.rewire_bias < 0:
            raise ValueError("rewire_bias must be non-negative")

    # -- derived constants ---------------------------------------------------
    @property
    def llr(self) -> Tuple[float, float]:
        """(llr0, llr1): the log-likelihood-ratio contributions of a calm
        and a withdrawn neighbor observation (llr0 < 0 < llr1)."""
        llr1 = math.log(self.q_run / self.q_calm)
        llr0 = math.log((1.0 - self.q_run) / (1.0 - self.q_calm))
        return llr0, llr1

    def group_table(self) -> Tuple[Tuple[float, ...], ...]:
        """(weights, thresholds, awareness) — the K-group constants with
        the homogeneous case rendered as one group, so every consumer
        loops the same shape."""
        if self.groups:
            w = tuple(g[0] for g in self.groups)
            t = tuple(g[1] for g in self.groups)
            a = tuple(g[2] for g in self.groups)
            return w, t, a
        return (1.0,), (self.threshold,), (self.awareness,)

    @classmethod
    def from_hetero_params(
        cls, params, threshold: float = 3.0, threshold_scale: float = 1.5,
        **kw,
    ) -> "InfoModelSpec":
        """Lift a hetero-stack K-group structure
        (`models.params.LearningParamsHetero` betas/dist, or a
        `ModelParamsHetero` carrying one) into an infomodel: group
        weights = dist, group awareness = β_k/⟨β⟩ (relative information
        intake), thresholds shared. The satellite bridge from the
        equilibrium stack's heterogeneity to agent space."""
        lrn = getattr(params, "learning", params)
        betas, dist = tuple(lrn.betas), tuple(lrn.dist)
        mean_b = sum(b * d for b, d in zip(betas, dist))
        groups = tuple(
            (d, float(threshold), b / mean_b) for b, d in zip(betas, dist)
        )
        return cls(
            threshold=threshold, threshold_scale=threshold_scale,
            groups=groups, **kw,
        )

    # -- reductions ----------------------------------------------------------
    def reduces_to_gossip(self) -> bool:
        """True when this spec IS the legacy `social.agents` step — the
        bit-identity contract's domain: static SI gossip, homogeneous
        (group-free) population."""
        return (
            self.channel == "gossip"
            and self.dynamics == "static"
            and not self.groups
        )

    # -- wire form -----------------------------------------------------------
    def to_doc(self) -> dict:
        """JSON-ready document (the `POST /query` ``population.infomodel``
        field) — non-default fields only, like `ScenarioSpec.to_doc`."""
        doc = {}
        fields = type(self).__dataclass_fields__
        for f in fields:
            v = getattr(self, f)
            if v != fields[f].default:
                doc[f] = [list(g) for g in v] if f == "groups" else v
        return doc

    @classmethod
    def from_doc(cls, doc: dict) -> "InfoModelSpec":
        """Parse the wire form; unknown keys are a loud error (a typo like
        ``"chanel"`` must not silently serve the default model)."""
        if not isinstance(doc, dict):
            raise ValueError(
                f"infomodel must be a JSON object, got {type(doc).__name__}"
            )
        unknown = set(doc) - set(cls.__dataclass_fields__)
        if unknown:
            raise ValueError(f"unknown infomodel field(s): {sorted(unknown)}")
        kw = dict(doc)
        if "groups" in kw:
            kw["groups"] = tuple(tuple(g) for g in kw["groups"])
        return cls(**kw)


def default_spec() -> InfoModelSpec:
    """The process-default information model: channel from
    ``SBR_INFOMODEL`` (``gossip``/``bayes``, default gossip), dynamics
    from ``SBR_INFOMODEL_DYNAMICS`` (``static``/``rewire``), epoch length
    from ``SBR_INFOMODEL_EPOCH_STEPS``: the environment that scripts
    read when they are given no explicit spec."""
    kw: dict = {}
    env = os.environ.get("SBR_INFOMODEL", "").strip().lower()
    if env:
        if env not in CHANNELS:
            raise ValueError(f"SBR_INFOMODEL must be one of {CHANNELS}, got {env!r}")
        kw["channel"] = env
    dyn = os.environ.get("SBR_INFOMODEL_DYNAMICS", "").strip().lower()
    if dyn:
        if dyn not in DYNAMICS:
            raise ValueError(
                f"SBR_INFOMODEL_DYNAMICS must be one of {DYNAMICS}, got {dyn!r}"
            )
        kw["dynamics"] = dyn
    ep = os.environ.get("SBR_INFOMODEL_EPOCH_STEPS", "").strip()
    if ep:
        kw["epoch_steps"] = int(ep)
    return InfoModelSpec(**kw)


def infomodel_fingerprint(
    spec: InfoModelSpec, params=None, config=None, dtype=None, extra=None
) -> str:
    """Stable sha256 of (spec[, params, config, dtype, extra]), the key
    infomodel products are cached and served under. It rides
    `utils.checkpoint.params_fingerprint`, and the dtype enters as numpy's
    name, so the hex equals the reference's on the same inputs."""
    payload = [spec, INFOMODEL_PROGRAM_VERSION]
    if params is not None:
        payload.append(params)
    if config is not None:
        payload.append(config)
    if dtype is not None:
        payload.append(dtype_name(dtype))
    if extra is not None:
        payload.append(extra)
    return params_fingerprint(tuple(payload))
