"""`ScenarioSpec`, the frozen, hashable, fingerprintable description of a
composed solve pipeline: the port of ``sbr_tpu.scenario.spec``, with the
same fields, defaults, validation, errors and wire form.

A spec is structure only: which learning stage runs Stage 1, which
hazard/buffer modifiers rewrite Stage 2, and how many banks couple through
which interbank exposure network. Parameter values (β, u, κ, the policy
knobs insurance_cap / suspension_t / lolr_rate, the hetero groups, the
interest rate r and maturity δ) live in the params structs
(`models.params`). A spec and a params struct determine a solve, and
`spec_fingerprint` hashes the pair through `utils.checkpoint`'s canonical
form, so its hex equals the reference's on the same inputs.

Composition matrix (what `__post_init__` accepts and what it rejects):

==========  ========  ============================  =====================
learning    banks     modifiers                     notes
==========  ========  ============================  =====================
baseline    1         any subset, any order         reduces to the plain
                                                    baseline/interest
                                                    solves when trivial
hetero      1         any subset                    interest V solved per
                                                    group row
social      1         any subset                    modifiers apply to
                                                    every inner iterate
baseline    >= 2      any subset                    multi-bank contagion
hetero      >= 2      REJECTED                      per-bank group axes
social      >= 2      REJECTED                      no fixed point inside
                                                    the contagion loop
==========  ========  ============================  =====================

Modifiers (applied to the hazard in spec order; ``lolr`` acts on κ at the
ξ stage wherever it stands):

- ``"interest"``: the HJB value function and the effective hazard h − r·V
  (`interest.solver.effective_hazard_stage`; needs params with r/δ).
- ``"insurance_cap"``: h ← (1 − insurance_cap)·h, the insured deposits
  abstain from the withdrawal race.
- ``"suspension"``: h ← h·1[τ̄ < suspension_t], convertibility is
  suspended from suspension_t on.
- ``"lolr"``: κ_eff = κ·(1 + lolr_rate), lender-of-last-resort
  injections.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from sbr_tpu_torch.utils.checkpoint import dtype_name, params_fingerprint

LEARNING_STAGES = ("baseline", "hetero", "social")
HAZARD_MODIFIERS = ("interest", "insurance_cap", "suspension", "lolr")


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """One composed scenario (see module docstring).

    A frozen dataclass: hashable (the program caches key on its
    projections) and canonicalizable (`utils.checkpoint.canonicalize`
    renders dataclasses by sorted field name, so the spec drops into
    `params_fingerprint` unchanged).
    """

    learning: str = "baseline"
    # Ordered hazard/buffer modifiers; hazard rewrites apply in this order.
    modifiers: Tuple[str, ...] = ()
    # Multi-bank contagion (banks >= 2): interbank exposure edges
    # (src, dst, weight) — bank `dst` holds `weight` of exposure to bank
    # `src` and suffers when `src` fails. () = independent banks.
    banks: int = 1
    exposure: Tuple[Tuple[int, int, float], ...] = ()
    # Social fixed-point knobs (`solve_equilibrium_social`'s defaults).
    social_tol: float = 1e-4
    social_max_iter: int = 250
    social_damping: float = 0.5
    # Contagion-loop knobs: damped κ-erosion iteration (multibank.py).
    contagion_max_iter: int = 32
    contagion_tol: float = 1e-10
    contagion_damping: float = 1.0
    # Loss-given-default on interbank exposure and the κ erosion floor.
    lgd: float = 0.5
    kappa_floor: float = 1e-3

    def __post_init__(self):
        if self.learning not in LEARNING_STAGES:
            raise ValueError(
                f"unknown learning stage {self.learning!r}; "
                f"expected one of {LEARNING_STAGES}"
            )
        mods = tuple(self.modifiers)
        object.__setattr__(self, "modifiers", mods)
        unknown = [m for m in mods if m not in HAZARD_MODIFIERS]
        if unknown:
            raise ValueError(
                f"unknown modifier(s) {unknown}; expected a subset of "
                f"{HAZARD_MODIFIERS}"
            )
        if len(set(mods)) != len(mods):
            raise ValueError(f"duplicate modifiers in {mods}")
        if self.banks < 1:
            raise ValueError(f"banks must be >= 1, got {self.banks}")
        if self.banks > 1 and self.learning != "baseline":
            # The composition matrix's loud rejections (module docstring).
            raise ValueError(
                f"multi-bank contagion supports learning='baseline' only "
                f"(got learning={self.learning!r} with banks={self.banks}); "
                f"see the composition matrix in sbr_tpu_torch/scenario/spec.py"
            )
        exposure = tuple((int(s), int(d), float(w)) for s, d, w in self.exposure)
        object.__setattr__(self, "exposure", exposure)
        if exposure and self.banks < 2:
            raise ValueError("exposure edges require banks >= 2")
        for s, d, w in exposure:
            if not (0 <= s < self.banks and 0 <= d < self.banks):
                raise ValueError(
                    f"exposure edge ({s}, {d}) out of range for {self.banks} banks"
                )
            if s == d:
                raise ValueError(f"self-exposure edge ({s}, {d}) is not allowed")
            if w < 0:
                raise ValueError(f"exposure weight must be non-negative, got {w}")
        if not (self.social_tol > 0 and self.social_max_iter >= 1):
            raise ValueError("social_tol must be > 0 and social_max_iter >= 1")
        if not (0 < self.social_damping <= 1):
            raise ValueError(f"social_damping must be in (0, 1], got {self.social_damping}")
        if not (self.contagion_max_iter >= 1 and self.contagion_tol >= 0):
            raise ValueError("contagion_max_iter must be >= 1 and contagion_tol >= 0")
        if not (0 < self.contagion_damping <= 1):
            raise ValueError(
                f"contagion_damping must be in (0, 1], got {self.contagion_damping}"
            )
        if not (0 <= self.lgd <= 1):
            raise ValueError(f"lgd must be in [0, 1], got {self.lgd}")
        if not (0 < self.kappa_floor < 1):
            raise ValueError(f"kappa_floor must be in (0, 1), got {self.kappa_floor}")

    # -- reductions ----------------------------------------------------------
    def reduces_to(self) -> Optional[str]:
        """The plain solve this spec is exactly ("baseline", "interest",
        "hetero" or "social"), or None for a genuine composition. Reducible
        specs route through the plain entry points, so their bits are the
        plain solve's by construction."""
        if self.banks != 1:
            return None
        if self.learning == "baseline" and self.modifiers == ():
            return "baseline"
        if self.learning == "baseline" and self.modifiers == ("interest",):
            return "interest"
        if self.learning == "hetero" and self.modifiers == ():
            return "hetero"
        if self.learning == "social" and self.modifiers == ():
            return "social"
        return None

    @property
    def policy_modifiers(self) -> Tuple[str, ...]:
        """The policy subset of the active modifiers."""
        return tuple(m for m in self.modifiers if m != "interest")

    def cell_program_spec(self) -> "ScenarioSpec":
        """The spec projected onto the fields a single-bank cell program
        depends on (learning + modifiers). Program caches key on this, not
        on the full spec: the host-side knobs (contagion_*, lgd,
        kappa_floor, social_* for non-social cells, banks/exposure) never
        enter the cell, and keying on them would grow one entry per
        wire-supplied float value on a server."""
        return ScenarioSpec(learning=self.learning, modifiers=self.modifiers)

    def social_program_spec(self) -> "ScenarioSpec":
        """Like `cell_program_spec`, for the composed social fixed point:
        its tol, max_iter and damping shape the loop, so they stay; only
        the contagion/multibank fields are projected away."""
        return ScenarioSpec(
            learning=self.learning, modifiers=self.modifiers,
            social_tol=self.social_tol, social_max_iter=self.social_max_iter,
            social_damping=self.social_damping,
        )

    def grad_reduction(self) -> Optional[str]:
        """Which gradient-covered solve this spec reduces to ("baseline" /
        "interest"), or None: the reference's gradient-coverage matrix
        (the port's gradients are ROADMAP 1.A item 7)."""
        red = self.reduces_to()
        return red if red in ("baseline", "interest") else None

    # -- wire form -----------------------------------------------------------
    def to_doc(self) -> dict:
        """JSON-ready document (the `POST /query` ``scenario`` field)."""
        doc = {"learning": self.learning, "modifiers": list(self.modifiers)}
        if self.banks != 1:
            doc["banks"] = self.banks
            doc["exposure"] = [list(e) for e in self.exposure]
        for f in (
            "social_tol", "social_max_iter", "social_damping",
            "contagion_max_iter", "contagion_tol", "contagion_damping",
            "lgd", "kappa_floor",
        ):
            if getattr(self, f) != getattr(type(self), "__dataclass_fields__")[f].default:
                doc[f] = getattr(self, f)
        return doc

    @classmethod
    def from_doc(cls, doc: dict) -> "ScenarioSpec":
        """Parse the wire form; unknown keys are a loud error (a typo like
        ``"modfiers"`` must not silently serve the default pipeline)."""
        if not isinstance(doc, dict):
            raise ValueError(f"scenario must be a JSON object, got {type(doc).__name__}")
        known = set(cls.__dataclass_fields__)
        unknown = set(doc) - known
        if unknown:
            raise ValueError(f"unknown scenario field(s): {sorted(unknown)}")
        kw = dict(doc)
        if "modifiers" in kw:
            kw["modifiers"] = tuple(str(m) for m in kw["modifiers"])
        if "exposure" in kw:
            kw["exposure"] = tuple(tuple(e) for e in kw["exposure"])
        return cls(**kw)


# The version of a composed cell's numerics, the reference's: part of every
# scenario fingerprint, so a cache never serves bytes from older pipeline
# math (the serving engine's keys add the backend tag besides).
SCENARIO_PROGRAM_VERSION = 1


def spec_fingerprint(spec: ScenarioSpec, params=None, config=None, dtype=None) -> str:
    """Stable sha256 of (spec[, params, config, dtype]), the key composed
    scenarios are cached and served under. It rides
    `utils.checkpoint.params_fingerprint`, and the dtype (torch or numpy)
    enters as numpy's name, so the hex equals the reference's on the same
    inputs."""
    payload = [spec, SCENARIO_PROGRAM_VERSION]
    if params is not None:
        payload.append(params)
    if config is not None:
        payload.append(config)
    if dtype is not None:
        payload.append(dtype_name(dtype))
    return params_fingerprint(tuple(payload))
