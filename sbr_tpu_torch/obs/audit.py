"""Numerics audit of the port: one golden-surface registry, one canary
runner, four legacy parity CLIs behind one protocol; the port of
``sbr_tpu.obs.audit``.

- a versioned **golden-surface registry**: expected fingerprints of small
  canonical solve surfaces, keyed per environment (the backend tag
  ``"torch"``, the probe device's type and, on CUDA, the card's name, the
  torch and CUDA versions, the battery's dtype and the program versions).
  Golden files are JSON (``goldens_<keyhash>.json``) under
  ``SBR_AUDIT_REGISTRY_DIR`` (default ``~/.cache/sbr_tpu_torch/
  audit_goldens``), stamped with ``AUDIT_REGISTRY_VERSION`` and refused
  loudly on a version mismatch, with the regeneration hint: a stale golden
  tolerated in silence is a green light on drifted math. A golden that
  ``sbr_tpu`` wrote never shares a key with the port's, so a registry that
  holds only the reference's file gives the port "no goldens" (exit 3),
  never a verdict.
- a **canary runner** (`run_battery`) that runs the probe battery on one
  device in one dtype (the CUDA card and float64 unless told otherwise),
  classifies each probe against the registry at its contract tier, emits
  ``audit`` obs events and a manifest roll-up, and writes a per-cycle
  artifact (``audit/battery_NNNN.json``) into the active run directory.
  ``python -m sbr_tpu_torch.obs.audit`` is the CLI: exit 0 pass, 1 drift,
  2 registry-version or usage error, 3 no goldens.
- an **AuditScheduler** that a serving engine runs off the hot path when
  ``SBR_AUDIT=1`` (``SBR_AUDIT_INTERVAL_S``): a cycle starts only while
  the engine is idle (nothing inflight, empty queue) and runs on the
  engine's device in its dtype. Status and the last pass ride ``/statz``
  and ``/metrics`` (``sbr_audit_status``, per-probe ``sbr_audit_probe_ms``
  histograms); a drift verdict latches and flips ``/healthz`` degraded
  with an ``audit_drift`` reason.

Probe matrix (contract tier per probe):

=====================  =========  =============================================
probe                  tier       canonical surface
=====================  =========  =============================================
``grid.baseline``      bitwise    default-params baseline equilibrium solve
``grid.hetero``        bitwise    two-group hetero equilibrium (Figure-9 shape)
``grid.interest``      bitwise    interest-rate equilibrium (r=0.06, δ=0.1)
``grid.social``        ulp        social fixed point (Figure-12 params); values
                                  match to ≤ ``max_ulps``
``scenario.composed``  bitwise    6×6 composed grid (insurance_cap + lolr)
``infomodel.gossip``   bitwise    static gossip trajectory on a seeded ER graph;
                                  every step ends in the infection kernel on
                                  the card
``graphgen.layout``    bitwise    canonical dst-sorted edge stream
``grad.ift_fd``        tolerance  IFT-vs-central-FD worst relative error
                                  (float64 only: skipped in float32)
=====================  =========  =============================================

A probe is ``fn(device=None, dtype="float64")`` and returns
``{"fingerprint": sha256-hex, "values": {name: float}, "meta": {...}}``
(and optionally ``"ok": bool``, a tolerance-tier self-check).

``SBR_AUDIT`` unset or ``0`` (the default) is a structural no-op: the
engine never imports this module, builds no scheduler, launches no kernel
and notes no program.

Fault injection: every probe execution fires the ``audit.canary`` fault
point (`resilience.faults`) with the probe name as target; a ``nan`` or
``corrupt`` rule perturbs the canary result before the comparison (never
the serving path), so the drift detection itself can be tested.

The module imports no torch: probes import their stacks when they run, so
the torch-free report can import the retention helper.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import sys
import threading
import time
from collections import OrderedDict
from pathlib import Path
from typing import Callable, Optional

AUDIT_REGISTRY_VERSION = 1
TIERS = ("bitwise", "ulp", "tolerance")
DEFAULT_INTERVAL_S = 300.0
DTYPES = ("float64", "float32")
_GOLDEN_PREFIX = "goldens_"
_ARTIFACT_DIR = "audit"


class AuditRegistryVersionError(RuntimeError):
    """A golden file written under a different AUDIT_REGISTRY_VERSION.

    Raised loudly, never passed in silence: the classification a golden
    was captured under may have changed, so comparing against it proves
    nothing. The message carries the regeneration hint."""


# ---------------------------------------------------------------------------
# Environment knobs
# ---------------------------------------------------------------------------


def enabled() -> bool:
    """``SBR_AUDIT`` opt-in; empty or "0" (the default) means fully off."""
    return os.environ.get("SBR_AUDIT", "").strip() not in ("", "0")


def interval_s() -> float:
    """Scheduled canary cadence (``SBR_AUDIT_INTERVAL_S``, default 300)."""
    raw = os.environ.get("SBR_AUDIT_INTERVAL_S", "").strip()
    try:
        return float(raw) if raw else DEFAULT_INTERVAL_S
    except ValueError:
        return DEFAULT_INTERVAL_S


def registry_dir() -> Path:
    """Golden registry root (``SBR_AUDIT_REGISTRY_DIR`` or the port's own
    user cache, beside the reference's)."""
    raw = os.environ.get("SBR_AUDIT_REGISTRY_DIR", "").strip()
    if raw:
        return Path(raw)
    return Path.home() / ".cache" / "sbr_tpu_torch" / "audit_goldens"


def probe_filter() -> Optional[tuple]:
    """``SBR_AUDIT_PROBES`` csv restriction (None = full battery)."""
    raw = os.environ.get("SBR_AUDIT_PROBES", "").strip()
    if not raw:
        return None
    names = tuple(p.strip() for p in raw.split(",") if p.strip())
    return names or None


def dtype_name(dtype) -> str:
    """The battery's dtype as "float64" or "float32", from None (float64),
    a name, or a torch or numpy dtype."""
    name = "float64" if dtype is None else str(getattr(dtype, "name", dtype)).removeprefix("torch.")
    if name not in DTYPES:
        raise ValueError(f"the audit battery runs in {DTYPES}, got {dtype!r}")
    return name


# ---------------------------------------------------------------------------
# Probe protocol + registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Probe:
    """One canonical solve surface and its classification contract.

    ``fn(device=..., dtype=...)`` returns ``{"fingerprint": sha256-hex,
    "values": {name: float}, "meta": {...}}`` (and optionally ``"ok":
    bool`` for tolerance-tier self-checks). The fingerprint covers the
    whole host-converted result; ``values`` are the scalar summaries the
    ulp and tolerance tiers compare. ``requires_x64`` keeps the
    reference's name: the probe runs only in a float64 battery."""

    name: str
    tier: str
    fn: Callable[..., dict]
    max_ulps: int = 4
    tol: float = 1e-5
    requires_x64: bool = False
    doc: str = ""

    def __post_init__(self):
        if self.tier not in TIERS:
            raise ValueError(f"probe {self.name!r}: tier must be one of {TIERS}")


_PROBES: "OrderedDict[str, Probe]" = OrderedDict()
_BUILTINS_REGISTERED = False


def register_probe(
    name: str,
    tier: str,
    fn: Callable[..., dict],
    *,
    max_ulps: int = 4,
    tol: float = 1e-5,
    requires_x64: bool = False,
    doc: str = "",
) -> Probe:
    """Register (or replace) a probe in the process-global battery."""
    p = Probe(name=name, tier=tier, fn=fn, max_ulps=max_ulps, tol=tol,
              requires_x64=requires_x64, doc=doc)
    _PROBES[name] = p
    return p


def probes() -> "OrderedDict[str, Probe]":
    """The full battery (built-ins registered on first call)."""
    _ensure_builtin_probes()
    return _PROBES


# ---------------------------------------------------------------------------
# Fingerprint helpers
# ---------------------------------------------------------------------------


def _to_host(obj):
    """Recursively convert a solver result (nested dataclasses of tensors
    on any device) into a canonicalize-able host structure. Wall-clock
    fields (``solve_time``) are left out: a fingerprint depends on the
    math, never on the stopwatch. A value that converts only to a numpy
    object array raises, since its bytes would be addresses."""
    import numpy as np

    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {
            f.name: _to_host(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if f.name != "solve_time" and getattr(obj, f.name) is not None
        }
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_host(v) for v in obj]
    if isinstance(obj, (type(None), bool, int, float, str, bytes)):
        return obj
    if isinstance(obj, (np.generic, np.ndarray)):
        return np.asarray(obj)
    if hasattr(obj, "detach") and hasattr(obj, "cpu"):  # a torch tensor
        return obj.detach().cpu().numpy()
    out = np.asarray(obj)
    if out.dtype == object:
        raise TypeError(f"cannot fingerprint a {type(obj).__name__}")
    return out


def payload_fingerprint(payload) -> str:
    """sha256 hex of the canonical textual form of a host payload: the
    bitwise-tier identity. It rides `utils.checkpoint.canonicalize` (dtype
    and raw bytes, sorted keys), so the hex equals the reference's on the
    same arrays."""
    from sbr_tpu_torch.utils.checkpoint import canonicalize

    return hashlib.sha256(
        canonicalize(_to_host(payload)).encode("utf-8")
    ).hexdigest()


def ulp_diff(a: float, b: float) -> float:
    """Distance in float64 ulps between two scalars (inf when exactly one
    is NaN; 0 when both are: a NaN ξ on a no-run surface compares equal to
    its golden)."""
    import math

    import numpy as np

    a64, b64 = float(a), float(b)
    a_nan, b_nan = math.isnan(a64), math.isnan(b64)
    if a_nan and b_nan:
        return 0.0
    if a_nan or b_nan:
        return math.inf
    ia = np.frombuffer(np.float64(a64).tobytes(), dtype=np.int64)[0]
    ib = np.frombuffer(np.float64(b64).tobytes(), dtype=np.int64)[0]
    # Map the sign-magnitude float ordering onto a monotone integer line.
    ia = int(ia) if ia >= 0 else -(int(ia) & 0x7FFFFFFFFFFFFFFF)
    ib = int(ib) if ib >= 0 else -(int(ib) & 0x7FFFFFFFFFFFFFFF)
    return float(abs(ia - ib))


# ---------------------------------------------------------------------------
# Built-in probes (stacks imported when a probe runs)
# ---------------------------------------------------------------------------


def _probe_result(payload, values: dict, ok: Optional[bool] = None, **meta) -> dict:
    import numpy as np

    out = {
        "fingerprint": payload_fingerprint(payload),
        "values": {k: float(np.float64(_to_host(v))) for k, v in values.items()},
        "meta": meta,
    }
    if ok is not None:
        out["ok"] = bool(ok)
    return out


def _torch_dtype(dtype: str):
    import torch

    return getattr(torch, dtype_name(dtype))


def _probe_grid_baseline(device=None, dtype="float64") -> dict:
    from sbr_tpu_torch.baseline.learning import solve_learning
    from sbr_tpu_torch.baseline.solver import solve_equilibrium_baseline
    from sbr_tpu_torch.models.params import SolverConfig, make_model_params

    cfg = SolverConfig(n_grid=256, bisect_iters=60)
    m = make_model_params()
    ls = solve_learning(m.learning, cfg, dtype=_torch_dtype(dtype), device=device)
    res = solve_equilibrium_baseline(ls, m.economic, cfg)
    return _probe_result(
        res, {"xi": res.xi, "aw_max": res.aw_max, "status": res.status},
        stack="baseline", n_grid=cfg.n_grid,
    )


def _probe_grid_hetero(device=None, dtype="float64") -> dict:
    from sbr_tpu_torch.hetero import solve_equilibrium_hetero, solve_learning_hetero
    from sbr_tpu_torch.models.params import SolverConfig, make_hetero_params

    cfg = SolverConfig(n_grid=256, bisect_iters=60)
    m = make_hetero_params(
        betas=[0.125, 12.5], dist=[0.9, 0.1], eta_bar=30.0, u=0.1, p=0.9,
        kappa=0.3, lam=0.1,
    )
    lsh = solve_learning_hetero(m.learning, cfg, dtype=_torch_dtype(dtype), device=device)
    res = solve_equilibrium_hetero(lsh, m.economic, cfg)
    return _probe_result(
        res, {"xi": res.xi, "status": res.status}, stack="hetero", n_grid=cfg.n_grid,
    )


def _probe_grid_interest(device=None, dtype="float64") -> dict:
    from sbr_tpu_torch.baseline.learning import solve_learning
    from sbr_tpu_torch.interest import solve_equilibrium_interest
    from sbr_tpu_torch.models.params import SolverConfig, make_interest_params

    cfg = SolverConfig(n_grid=256, bisect_iters=60)
    m = make_interest_params(u=0.0, r=0.06, delta=0.1)
    ls = solve_learning(m.learning, cfg, dtype=_torch_dtype(dtype), device=device)
    res = solve_equilibrium_interest(ls, m.economic, cfg)
    return _probe_result(
        res, {"xi": res.base.xi, "status": res.base.status},
        stack="interest", n_grid=cfg.n_grid,
    )


def _probe_grid_social(device=None, dtype="float64") -> dict:
    from sbr_tpu_torch.models.params import SolverConfig, make_model_params
    from sbr_tpu_torch.social.solver import solve_equilibrium_social

    m = make_model_params(beta=0.9, eta_bar=30.0, u=0.5, p=0.99, kappa=0.25, lam=0.25)
    res = solve_equilibrium_social(m, SolverConfig(n_grid=512), tol=1e-4, max_iter=400,
                                   dtype=_torch_dtype(dtype), device=device)
    return _probe_result(
        res,
        {"xi": res.xi, "error": res.error, "iterations": res.iterations,
         "converged": res.converged},
        stack="social",
    )


def _probe_scenario_composed(device=None, dtype="float64") -> dict:
    import numpy as np

    from sbr_tpu_torch import scenario
    from sbr_tpu_torch.models.params import SolverConfig, make_model_params
    from sbr_tpu_torch.scenario.spec import ScenarioSpec, spec_fingerprint

    spec = ScenarioSpec(modifiers=("insurance_cap", "lolr"))
    base = make_model_params(insurance_cap=0.25, lolr_rate=0.3)
    cfg = SolverConfig(n_grid=256, bisect_iters=50, refine_crossings=False)
    betas = np.linspace(0.4, 1.6, 6)
    us = np.linspace(0.1, 0.9, 6)
    grid = scenario.scenario_grid(spec, betas, us, base, config=cfg,
                                  dtype=_torch_dtype(dtype), device=device)
    payload = _to_host({"xi": grid.xi, "max_aw": grid.max_aw, "status": grid.status})
    return _probe_result(
        payload,
        {"run_cells": float(np.sum(payload["status"] == 0))},
        scenario=spec_fingerprint(spec, None, cfg, None)[:12],
    )


def _probe_infomodel_gossip(device=None, dtype="float64") -> dict:
    from sbr_tpu_torch.infomodels import InfoModelSpec, simulate_info
    from sbr_tpu_torch.social.agents import AgentSimConfig
    from sbr_tpu_torch.social.graphgen import ErdosRenyiSpec

    # static gossip, the legacy-reduction surface; its float32 simulation
    # (simulate_info's default, as in the reference) ends every step in the
    # infection kernel on the card
    spec = InfoModelSpec()
    graph = ErdosRenyiSpec(n=400, avg_degree=6.0)
    cfg = AgentSimConfig(n_steps=20, dt=0.1)
    r = simulate_info(spec, graph, beta=1.2, x0=0.02, config=cfg, seed=7, device=device)
    payload = _to_host({
        f: getattr(r, f) for f in ("informed", "t_inf", "informed_frac", "withdrawn_frac")
    })
    return _probe_result(
        payload,
        {"informed_frac_end": payload["informed_frac"][-1]},
        n=graph.n, channel=spec.channel,
    )


def _probe_graphgen_layout(device=None, dtype="float64") -> dict:
    from sbr_tpu_torch.social.graphgen import ErdosRenyiSpec, generate_edges

    # the canonical dst-sorted (src, dst) stream is the layout the device
    # build is tested bit for bit against (`graphgen._selfcheck`): its
    # bytes are the layout hash
    spec = ErdosRenyiSpec(n=300, avg_degree=6.0)
    src, dst = generate_edges(spec, seed=3, device=device)
    return _probe_result(
        [src, dst],
        {"n_edges": float(len(src))},
        n=spec.n, seed=3,
    )


def _probe_grad_ift_fd(device=None, dtype="float64") -> dict:
    from sbr_tpu_torch.grad.parity import run_battery as grad_battery
    from sbr_tpu_torch.models.params import SolverConfig

    rep = grad_battery(
        n=4, seed=0, tol=1e-5,
        config=SolverConfig(n_grid=384, bisect_iters=80, refine_crossings=True),
        device=device,
    )
    values = {"worst_rel": rep["worst_rel"], "n_checked": float(rep["n_checked"])}
    return _probe_result(values, values, ok=rep["ok"], tol=rep["tol"])


def _ensure_builtin_probes() -> None:
    global _BUILTINS_REGISTERED
    if _BUILTINS_REGISTERED:
        return
    _BUILTINS_REGISTERED = True
    register_probe("grid.baseline", "bitwise", _probe_grid_baseline,
                   doc="default-params baseline equilibrium")
    register_probe("grid.hetero", "bitwise", _probe_grid_hetero,
                   doc="two-group hetero equilibrium")
    register_probe("grid.interest", "bitwise", _probe_grid_interest,
                   doc="interest-rate equilibrium (r=0.06, delta=0.1)")
    register_probe("grid.social", "ulp", _probe_grid_social, max_ulps=4,
                   doc="social fixed point (Figure-12 params)")
    register_probe("scenario.composed", "bitwise", _probe_scenario_composed,
                   doc="6x6 composed grid (insurance_cap + lolr)")
    register_probe("infomodel.gossip", "bitwise", _probe_infomodel_gossip,
                   doc="static gossip trajectory on seeded ER graph")
    register_probe("graphgen.layout", "bitwise", _probe_graphgen_layout,
                   doc="canonical dst-sorted device layout hash")
    register_probe("grad.ift_fd", "tolerance", _probe_grad_ift_fd, tol=1e-5,
                   requires_x64=True,
                   doc="IFT vs central-FD worst relative error (f64)")


# ---------------------------------------------------------------------------
# Golden registry
# ---------------------------------------------------------------------------


def env_key(device=None, dtype=None) -> dict:
    """The registry's content address: everything a golden is conditioned
    on. Same key ⇒ probes must reproduce the goldens at their tier. The
    backend tag keeps the port's goldens apart from the reference's."""
    import torch

    from sbr_tpu_torch.scenario.spec import SCENARIO_PROGRAM_VERSION
    from sbr_tpu_torch.social.agents import default_device
    from sbr_tpu_torch.sweeps.baseline_sweeps import GRID_PROGRAM_VERSION
    from sbr_tpu_torch.utils.checkpoint import BACKEND

    dev = torch.device(device) if device is not None else default_device()
    key = {"backend": BACKEND, "platform": dev.type, "torch": torch.__version__}
    if dev.type == "cuda":
        key["device_name"] = torch.cuda.get_device_name(dev)
        key["cuda"] = torch.version.cuda
    key.update(dtype=dtype_name(dtype), grid_program=GRID_PROGRAM_VERSION,
               scenario_program=SCENARIO_PROGRAM_VERSION)
    return key


def key_hash(key: dict) -> str:
    from sbr_tpu_torch.utils.checkpoint import canonicalize

    return hashlib.sha256(canonicalize(key).encode("utf-8")).hexdigest()[:16]


def golden_path(reg_dir: Optional[Path] = None, key: Optional[dict] = None) -> Path:
    reg_dir = Path(reg_dir) if reg_dir is not None else registry_dir()
    key = key if key is not None else env_key()
    return reg_dir / f"{_GOLDEN_PREFIX}{key_hash(key)}.json"


def load_goldens(reg_dir: Optional[Path] = None, key: Optional[dict] = None) -> Optional[dict]:
    """Read the golden file for this environment key, or None when absent.

    Raises :class:`AuditRegistryVersionError` (with the regeneration
    hint) when the file was written under a different
    ``AUDIT_REGISTRY_VERSION``: a stale golden never passes in silence."""
    path = golden_path(reg_dir, key)
    if not path.is_file():
        return None
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    version = doc.get("registry_version")
    if version != AUDIT_REGISTRY_VERSION:
        raise AuditRegistryVersionError(
            f"golden file {path} was written at AUDIT_REGISTRY_VERSION "
            f"{version!r} but this build expects {AUDIT_REGISTRY_VERSION}; "
            "regenerate it with `python -m sbr_tpu_torch.obs.audit "
            "--update-goldens` (the old file is archived, not overwritten)"
        )
    return doc


def write_goldens(report: dict, reg_dir: Optional[Path] = None) -> Path:
    """Persist a battery report as the golden set for its key. An existing
    golden is archived (``goldens_<key>.NNN.json``) first: the history
    that ``report gc --audit-keep`` prunes."""
    reg_dir = Path(reg_dir) if reg_dir is not None else registry_dir()
    reg_dir.mkdir(parents=True, exist_ok=True)
    path = reg_dir / f"{_GOLDEN_PREFIX}{report['key_hash']}.json"
    if path.is_file():
        n = 0
        while (archive := path.with_suffix(f".{n:03d}.json")).exists():
            n += 1
        os.replace(path, archive)
    doc = {
        "registry_version": AUDIT_REGISTRY_VERSION,
        "key": report["key"],
        "key_hash": report["key_hash"],
        "written_at": time.time(),
        "probes": {
            name: {
                "tier": p["tier"],
                "fingerprint": p["fingerprint"],
                "values": p["values"],
            }
            for name, p in report["probes"].items()
            if p["verdict"] not in ("skipped", "error")
        },
    }
    tmp = path.with_suffix(".tmp")
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return path


# ---------------------------------------------------------------------------
# Classification + the canary runner
# ---------------------------------------------------------------------------


def classify(probe: Probe, result: dict, golden: Optional[dict]) -> tuple:
    """Classify one probe result against its golden at the probe's
    contract tier. Returns ``(verdict, detail)``: verdict "pass",
    "drift", or "no_golden"."""
    import math

    if golden is None:
        return "no_golden", "no golden recorded for this probe/key"
    if probe.tier == "bitwise":
        if result["fingerprint"] == golden["fingerprint"]:
            return "pass", "fingerprint match"
        return "drift", (
            f"fingerprint {result['fingerprint'][:12]} != golden "
            f"{golden['fingerprint'][:12]}"
        )
    if probe.tier == "ulp":
        gv = golden.get("values") or {}
        if set(result["values"]) != set(gv):
            return "drift", "value key set changed vs golden"
        worst = max((ulp_diff(result["values"][k], gv[k]) for k in gv),
                    default=0.0)
        if worst <= probe.max_ulps:
            return "pass", f"worst {worst:g} ulp (max {probe.max_ulps})"
        return "drift", f"worst {worst:g} ulp over max {probe.max_ulps}"
    # tolerance tier: internal self-check + relative match on each value.
    if result.get("ok") is False:
        return "drift", "probe internal self-check failed"
    gv = golden.get("values") or {}
    if set(result["values"]) != set(gv):
        return "drift", "value key set changed vs golden"
    worst = 0.0
    for k in gv:
        a, b = float(result["values"][k]), float(gv[k])
        if math.isnan(a) or math.isnan(b):
            return "drift", f"non-finite value {k}"
        worst = max(worst, abs(a - b) / max(1.0, abs(b)))
    if worst <= probe.tol:
        return "pass", f"worst rel {worst:.3e} (tol {probe.tol:g})"
    return "drift", f"worst rel {worst:.3e} over tol {probe.tol:g}"


def _apply_canary_fault(result: dict, kind: str) -> None:
    """Apply an ``audit.canary`` injection to a probe result, in place,
    before the comparison. ``nan`` poisons the values; ``corrupt``
    perturbs the fingerprint and values deterministically. The classifier
    must catch both; the serving path never sees them."""
    if kind == "nan":
        result["values"] = {k: float("nan") for k in result["values"]}
        result["fingerprint"] = hashlib.sha256(
            ("nan:" + result["fingerprint"]).encode()
        ).hexdigest()
        result["ok"] = False
    elif kind == "corrupt":
        result["values"] = {
            k: v * (1.0 + 1e-3) + 1e-6 for k, v in result["values"].items()
        }
        result["fingerprint"] = hashlib.sha256(
            ("corrupt:" + result["fingerprint"]).encode()
        ).hexdigest()
    result.setdefault("meta", {})["injected_fault"] = kind


def run_battery(
    probe_names=None,
    reg_dir: Optional[Path] = None,
    update: bool = False,
    key: Optional[dict] = None,
    cycle: Optional[int] = None,
    emit: bool = True,
    device=None,
    dtype=None,
) -> dict:
    """Execute the canary battery and classify it against the registry.

    ``probe_names`` restricts the battery (default: ``SBR_AUDIT_PROBES``
    or everything registered); entries may be names or `Probe` objects
    (the test hook). ``update=True`` records the results as the new
    goldens instead of classifying. Probes run on ``device`` (default:
    the CUDA card) in ``dtype`` (default float64; a float32 battery skips
    the ``requires_x64`` probes). ``key=None`` derives the environment key
    from the device and dtype (imports torch); tests pass an explicit key.
    ``emit`` controls obs ``audit`` events and the per-cycle artifact.
    """
    from sbr_tpu_torch.resilience import faults

    battery = []
    if probe_names is None:
        probe_names = probe_filter()
    if probe_names is None:
        battery = list(probes().values())
    else:
        reg = probes()
        for entry in probe_names:
            if isinstance(entry, Probe):
                battery.append(entry)
            elif entry in reg:
                battery.append(reg[entry])
            else:
                raise KeyError(
                    f"unknown audit probe {entry!r}; registered: {sorted(reg)}"
                )

    dtype = dtype_name(dtype)
    key = key if key is not None else env_key(device, dtype)
    kh = key_hash(key)
    goldens = None
    golden_file = golden_path(reg_dir, key)
    if not update:
        goldens = load_goldens(reg_dir, key)  # may raise the version error

    t_battery = time.perf_counter()
    report_probes: "OrderedDict[str, dict]" = OrderedDict()
    drift, missing = [], []
    for probe in battery:
        entry = {"tier": probe.tier, "doc": probe.doc}
        if probe.requires_x64 and dtype != "float64":
            entry.update(verdict="skipped",
                         detail=f"requires float64 (the battery runs in {dtype})",
                         duration_ms=0.0)
            report_probes[probe.name] = entry
            _emit_probe_event(emit, probe, entry, cycle)
            continue
        t0 = time.perf_counter()
        try:
            result = probe.fn(device=device, dtype=dtype)
        except Exception as err:
            entry.update(verdict="error", detail=repr(err),
                         duration_ms=round((time.perf_counter() - t0) * 1e3, 3))
            drift.append(probe.name)
            report_probes[probe.name] = entry
            _emit_probe_event(emit, probe, entry, cycle)
            continue
        # The injection point: a planted nan/corrupt rule perturbs this
        # canary result before the comparison (the serving path never sees
        # it), and the detection must flag it as drift.
        rule = faults.fire("audit.canary", probe.name)
        if rule is not None and rule.kind in ("nan", "corrupt"):
            _apply_canary_fault(result, rule.kind)
        duration_ms = round((time.perf_counter() - t0) * 1e3, 3)
        entry.update(
            fingerprint=result["fingerprint"],
            values=result["values"],
            meta=result.get("meta", {}),
            duration_ms=duration_ms,
        )
        if "ok" in result:
            entry["ok"] = bool(result["ok"])
        if update:
            entry["verdict"] = "golden"
            entry["detail"] = "recorded as golden"
        else:
            g = (goldens or {}).get("probes", {}).get(probe.name)
            verdict, detail = classify(probe, entry, g)
            entry["verdict"] = verdict
            entry["detail"] = detail
            if g is not None:
                entry["golden_fingerprint"] = g["fingerprint"]
            if verdict == "drift":
                drift.append(probe.name)
            elif verdict == "no_golden":
                missing.append(probe.name)
        report_probes[probe.name] = entry
        _emit_probe_event(emit, probe, entry, cycle)

    report = {
        "registry_version": AUDIT_REGISTRY_VERSION,
        "key": key,
        "key_hash": kh,
        "golden_path": str(golden_file),
        "cycle": cycle,
        "updated": bool(update),
        "probes": report_probes,
        "drift": drift,
        "missing": missing,
        "ok": not update and not drift and not missing and bool(report_probes),
        "duration_s": round(time.perf_counter() - t_battery, 4),
    }
    if update:
        report["golden_path"] = str(write_goldens(report, reg_dir))
    if emit:
        _emit_cycle(report)
    return report


def _emit_probe_event(emit: bool, probe: Probe, entry: dict, cycle) -> None:
    if not emit:
        return
    try:
        from sbr_tpu_torch import obs

        obs.log_audit(
            "probe", probe=probe.name, tier=probe.tier,
            verdict=entry["verdict"], detail=entry.get("detail"),
            duration_ms=entry.get("duration_ms"),
            **({"cycle": cycle} if cycle is not None else {}),
        )
    except Exception:
        pass  # telemetry must never sink the battery


def _emit_cycle(report: dict) -> None:
    """One roll-up ``cycle`` event + the per-cycle artifact file."""
    try:
        from sbr_tpu_torch import obs
        from sbr_tpu_torch.obs import runlog

        verdict = (
            "golden" if report["updated"]
            else "drift" if report["drift"]
            else "no_golden" if report["missing"]
            else "pass"
        )
        obs.log_audit(
            "cycle",
            cycle=report["cycle"], probes=len(report["probes"]),
            drift=len(report["drift"]), missing=len(report["missing"]),
            verdict=verdict, duration_s=report["duration_s"],
            key_hash=report["key_hash"],
        )
        run = runlog.current_run()
        if run is not None:
            _write_battery_artifact(Path(run.run_dir), report)
    except Exception:
        pass


def _write_battery_artifact(run_dir: Path, report: dict) -> None:
    """Land ``audit/battery_NNNN.json`` in the run directory (atomic tmp +
    replace, like `runlog.live_snapshot`); the aged files are what
    ``report gc --audit-keep`` prunes."""
    adir = run_dir / _ARTIFACT_DIR
    adir.mkdir(parents=True, exist_ok=True)
    n = 0
    while (path := adir / f"battery_{n:04d}.json").exists():
        n += 1
    tmp = adir / f".battery_{n:04d}.tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(report, fh, sort_keys=True, default=str)
    os.replace(tmp, path)


# ---------------------------------------------------------------------------
# Legacy parity-CLI delegation
# ---------------------------------------------------------------------------


def run_legacy_cli(probe_name: str, check_fn: Callable[[], object],
                   obs_dir: Optional[str] = None) -> int:
    """Run one legacy parity battery through the audit protocol.

    The four CLIs (`grad.parity`, `scenario.parity`, `infomodels.parity`,
    `graphgen_cli --selfcheck`) keep their flags and output and route
    execution here: the check runs inside an obs run (when ``obs_dir`` is
    given, its directory printed), its verdict lands as an ``audit``
    probe event and manifest roll-up, and the exit code is the audit one
    (0 pass, 1 drift). ``check_fn`` signals failure by raising
    AssertionError (the parity batteries) or by returning a nonzero int
    (graphgen)."""
    from sbr_tpu_torch import obs
    from sbr_tpu_torch.obs import runlog

    run = None
    if obs_dir:
        run = obs.start_run(label=f"audit-{probe_name}", run_dir=obs_dir)
        print(f"obs run dir: {run.run_dir}")
    t0 = time.perf_counter()
    verdict, detail, rc = "pass", "legacy battery passed", 0
    try:
        out = check_fn()
        if isinstance(out, int) and out != 0:
            verdict, detail, rc = "drift", f"legacy battery exit {out}", 1
    except AssertionError as err:
        verdict, detail, rc = "drift", str(err) or "assertion failed", 1
    finally:
        duration_ms = round((time.perf_counter() - t0) * 1e3, 3)
        try:
            obs.log_audit("probe", probe=probe_name, tier="legacy",
                          verdict=verdict, detail=detail,
                          duration_ms=duration_ms)
        except Exception:
            pass
        if run is not None:
            runlog._finalize_if_active(run)
    if verdict == "drift":
        print(f"audit[{probe_name}]: DRIFT — {detail}", file=sys.stderr)
    return rc


# ---------------------------------------------------------------------------
# Scheduler (serving engines)
# ---------------------------------------------------------------------------


class AuditScheduler:
    """Scheduled background canaries inside a serving engine, off the hot
    path. A cycle starts only while the engine is idle (no inflight
    batch, empty queue); a due cycle defers, tick by tick, until the
    window clears, so canaries never ride a batch window. Probes run on
    the engine's device in its dtype. A drift verdict latches (an engine
    that failed a correctness canary stays flagged until an operator
    recycles it): `/healthz` degrades with an ``audit_drift`` reason.
    Each probe runs inside the engine's ``_on_device()`` (its dispatch
    lock), as a served population query does, so a probe never overlaps a
    bucket's CUDA-graph capture or replay; a query that arrives during a
    cycle waits for one probe at most."""

    def __init__(self, engine=None, reg_dir=None, interval: Optional[float] = None,
                 probe_names=None, device=None, dtype=None) -> None:
        from sbr_tpu_torch.obs.metrics import DEFAULT_LATENCY_BOUNDS_MS, LabeledHistograms

        self.engine = engine
        self.reg_dir = Path(reg_dir) if reg_dir is not None else registry_dir()
        self.interval = float(interval) if interval is not None else interval_s()
        self.probe_names = tuple(probe_names) if probe_names else probe_filter()
        self.device = device if device is not None else getattr(engine, "device", None)
        self.dtype = dtype if dtype is not None else getattr(engine, "dtype", None)
        self.status = "pending"  # pending | pass | drift
        self.cycles = 0
        self.last_pass_ts: Optional[float] = None
        self.last_run_ts: Optional[float] = None
        self.drift_probes: list = []
        self.last_error: Optional[str] = None
        self.hist = LabeledHistograms(DEFAULT_LATENCY_BOUNDS_MS)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle --
    def start(self) -> "AuditScheduler":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="sbr-audit-canary", daemon=True
            )
            self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=60.0)

    # -- scheduling --
    def _idle(self) -> bool:
        eng = self.engine
        if eng is None:
            return True
        try:
            return (
                eng.live.inflight == 0
                and eng.live.queue_depth == 0
                and eng._queue.qsize() == 0
            )
        except Exception:
            return True

    def _loop(self) -> None:
        dev = self.device
        if dev is not None and getattr(dev, "type", None) == "cuda":
            import torch

            torch.cuda.set_device(dev)
        next_at = time.monotonic() + self.interval
        while not self._stop.wait(0.2):
            if time.monotonic() < next_at:
                continue
            if not self._idle():
                continue  # defer the due cycle; re-check next tick
            self.run_cycle()
            next_at = time.monotonic() + self.interval

    def _battery(self) -> Optional[list]:
        """The cycle's probes, each held on the engine's device; None (the
        battery's own default) without an engine."""
        hold = getattr(self.engine, "_on_device", None)
        if hold is None:
            return self.probe_names
        reg = probes()
        names = self.probe_names if self.probe_names is not None else tuple(reg)
        battery = []
        for entry in names:
            p = entry if isinstance(entry, Probe) else reg.get(entry)
            if p is None:
                raise KeyError(f"unknown audit probe {entry!r}; registered: {sorted(reg)}")
            battery.append(dataclasses.replace(p, fn=_held(p.fn, hold)))
        return battery

    def run_cycle(self) -> Optional[dict]:
        """Execute one canary cycle now (also the test hook)."""
        cycle = self.cycles + 1
        try:
            report = run_battery(
                probe_names=self._battery(), reg_dir=self.reg_dir, cycle=cycle,
                device=self.device, dtype=self.dtype,
            )
        except Exception as err:
            with self._lock:
                self.cycles = cycle
                self.last_run_ts = time.time()
                self.last_error = repr(err)
            try:
                from sbr_tpu_torch import obs

                obs.log_audit("error", cycle=cycle, error=repr(err))
            except Exception:
                pass
            return None
        with self._lock:
            self.cycles = cycle
            self.last_run_ts = time.time()
            self.last_error = None
            for name, p in report["probes"].items():
                if p.get("duration_ms"):
                    self.hist.record(name, p["duration_ms"])
            if report["drift"]:
                self.status = "drift"  # latched
                self.drift_probes = list(report["drift"])
            elif self.status != "drift" and report["ok"]:
                self.status = "pass"
                self.last_pass_ts = time.time()
        return report

    # -- surfacing --
    def snapshot(self) -> dict:
        with self._lock:
            return {
                "status": self.status,
                "cycles": self.cycles,
                "interval_s": self.interval,
                "last_pass_ts": self.last_pass_ts,
                "last_run_ts": self.last_run_ts,
                "drift_probes": list(self.drift_probes),
                "last_error": self.last_error,
                "probe_ms": self.hist.summaries(),
            }

    def heartbeat_block(self) -> dict:
        """The compact block a fleet worker's heartbeat carries (what the
        router's quarantine check reads, `serve.router.Router`)."""
        with self._lock:
            return {
                "status": self.status,
                "cycles": self.cycles,
                "last_pass_ts": self.last_pass_ts,
                "drift_probes": list(self.drift_probes),
            }

    def status_gauge(self) -> int:
        """``sbr_audit_status`` encoding: 1 pass, 0 pending, -1 drift."""
        return {"pass": 1, "drift": -1}.get(self.status, 0)

    def prometheus_lines(self) -> list:
        lines = [
            "# TYPE sbr_audit_status gauge",
            f"sbr_audit_status {self.status_gauge()}",
        ]
        lines.extend(self.hist.to_prometheus("sbr_audit_probe_ms",
                                             label_key="probe"))
        return lines


def _held(fn: Callable[..., dict], hold) -> Callable[..., dict]:
    """``fn`` run inside the context ``hold()``."""

    def run(**kw) -> dict:
        with hold():
            return fn(**kw)

    return run


# ---------------------------------------------------------------------------
# Retention (report gc --audit-keep)
# ---------------------------------------------------------------------------


def gc_audit_files(root, keep: int = 4, reg_dir: Optional[Path] = None,
                   running_grace_s: float = 6 * 3600.0) -> list:
    """Prune aged audit artifacts, the ``--trace-keep`` contract: per run
    directory under ``root``, keep the newest ``keep``
    ``audit/battery_NNNN.json`` files; live runs (manifest "running" with
    a recent mtime) are never touched. Also prunes archived golden
    snapshots (``goldens_<key>.NNN.json``) beyond ``keep`` per key in
    ``reg_dir`` (default: the active registry directory, when it exists);
    active ``goldens_<key>.json`` files are never candidates (the glob
    needs the archive's second dot). Returns the removed paths."""
    from sbr_tpu_torch.obs import runlog

    keep = max(int(keep), 0)
    removed: list = []
    root = Path(root)
    if root.is_dir():
        for d in sorted(p for p in root.iterdir() if p.is_dir()):
            adir = d / _ARTIFACT_DIR
            if not adir.is_dir():
                continue
            if runlog._run_is_live(d, running_grace_s):
                continue
            batteries = sorted(adir.glob("battery_*.json"))
            for path in batteries[: max(len(batteries) - keep, 0)]:
                try:
                    path.unlink()
                    removed.append(str(path))
                except OSError:
                    pass
    reg_dir = Path(reg_dir) if reg_dir is not None else registry_dir()
    if reg_dir.is_dir():
        by_key: dict = {}
        for path in reg_dir.glob(f"{_GOLDEN_PREFIX}*.*.json"):
            stem = path.name.split(".")[0]
            by_key.setdefault(stem, []).append(path)
        for archives in by_key.values():
            archives.sort()
            for path in archives[: max(len(archives) - keep, 0)]:
                try:
                    path.unlink()
                    removed.append(str(path))
                except OSError:
                    pass
    return removed


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m sbr_tpu_torch.obs.audit",
        description="Unified numerics audit battery: golden-surface "
        "registry + canary probes at documented contract tiers "
        "(bitwise/ulp/tolerance). Exit 0 pass, 1 drift, 2 registry "
        "version error, 3 no goldens for this environment key.",
    )
    parser.add_argument("--update-goldens", action="store_true",
                        help="record this battery's results as the golden "
                        "set for the current environment key (--update "
                        "abbreviates it)")
    parser.add_argument("--registry", default=None,
                        help="golden registry dir (default "
                        "SBR_AUDIT_REGISTRY_DIR or ~/.cache/sbr_tpu_torch/"
                        "audit_goldens)")
    parser.add_argument("--probes", default=None,
                        help="csv probe subset (default SBR_AUDIT_PROBES "
                        "or the full battery)")
    parser.add_argument("--obs-dir", default=None,
                        help="run the battery inside an obs run rooted "
                        "here (dir printed; report audit gates on it)")
    parser.add_argument("--device", default=None,
                        help="torch device of the probes (default: the CUDA card)")
    parser.add_argument("--dtype", default="float64", choices=DTYPES,
                        help="the battery's dtype (default float64; float32 "
                        "skips grad.ift_fd)")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable report on stdout")
    parser.add_argument("--list", action="store_true",
                        help="list registered probes and exit")
    args = parser.parse_args(argv)

    if args.list:
        for p in probes().values():
            print(f"{p.name:20s} {p.tier:10s} {p.doc}")
        return 0

    probe_names = None
    if args.probes:
        probe_names = tuple(p.strip() for p in args.probes.split(",") if p.strip())
    try:
        key = env_key(args.device, args.dtype)
    except RuntimeError as err:  # no CUDA card and no --device
        print(f"audit: {err}", file=sys.stderr)
        return 2

    from sbr_tpu_torch import obs
    from sbr_tpu_torch.obs import runlog

    run = None
    if args.obs_dir:
        run = obs.start_run(label="audit", run_dir=args.obs_dir)
        print(f"obs run dir: {run.run_dir}")
    try:
        report = run_battery(
            probe_names=probe_names, reg_dir=args.registry,
            update=args.update_goldens, key=key, device=args.device, dtype=args.dtype,
        )
    except AuditRegistryVersionError as err:
        print(f"audit: {err}", file=sys.stderr)
        return 2
    except KeyError as err:  # an unknown probe name
        print(f"audit: {err.args[0]}", file=sys.stderr)
        return 2
    finally:
        if run is not None:
            runlog._finalize_if_active(run)

    if args.json:
        print(json.dumps(report, default=str))
    else:
        for name, p in report["probes"].items():
            mark = {"pass": "PASS ", "golden": "GOLD ", "drift": "DRIFT",
                    "no_golden": "MISS ", "skipped": "SKIP ",
                    "error": "ERROR"}.get(p["verdict"], "?    ")
            print(f"{mark} {name:20s} [{p['tier']:9s}] "
                  f"{p.get('duration_ms', 0):9.1f} ms  {p.get('detail', '')}")
        print(
            f"audit battery: {len(report['probes'])} probe(s), "
            f"{len(report['drift'])} drift, {len(report['missing'])} "
            f"missing, key {report['key_hash']} "
            f"-> {report['golden_path']}"
        )
    if args.update_goldens:
        return 0
    if report["drift"]:
        return 1
    if report["missing"] or not report["probes"]:
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
