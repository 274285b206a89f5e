"""The port's host helpers of the serving slice against sbr_tpu's, on the
CPU: the canonical parameter fingerprints (sbr_tpu_torch.utils.checkpoint),
infomodel_fingerprint, the retry policy and budget
(sbr_tpu_torch.resilience.retry), the integrity sidecars
(sbr_tpu_torch.resilience.heal), the latency histograms
(sbr_tpu_torch.obs.metrics) and the loadgen's pool and mix.

Contract: the same inputs give the same strings, hex digests, delays,
quantiles, Prometheus lines and pools as the reference, exactly.
"""

import importlib
import os
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sbr_tpu.infomodels import spec as jspec  # noqa: E402
from sbr_tpu.models import params as jparams  # noqa: E402
from sbr_tpu.resilience import heal as jheal  # noqa: E402
from sbr_tpu.resilience import retry as jretry  # noqa: E402
from sbr_tpu.serve import fleet as jfleet  # noqa: E402
from sbr_tpu.serve import loadgen as jloadgen  # noqa: E402
from sbr_tpu.utils import checkpoint as jckpt  # noqa: E402
from sbr_tpu_torch.infomodels import spec as tspec  # noqa: E402
from sbr_tpu_torch.models import params as tparams  # noqa: E402
from sbr_tpu_torch.obs import metrics as tmetrics  # noqa: E402
from sbr_tpu_torch.resilience import heal as theal  # noqa: E402
from sbr_tpu_torch.resilience import retry as tretry  # noqa: E402
from sbr_tpu_torch.serve import fleet as tfleet  # noqa: E402
from sbr_tpu_torch.serve import loadgen as tloadgen  # noqa: E402
from sbr_tpu_torch.utils import checkpoint as tckpt  # noqa: E402

# sbr_tpu.obs exports a `metrics()` function under the module's name
jmetrics = importlib.import_module("sbr_tpu.obs.metrics")

REPO = Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------------------
# Fingerprints
# ---------------------------------------------------------------------------

def _pair(kind):
    """The same logical value built from each package's classes."""
    if kind == "model_params":
        return (jparams.make_model_params(beta=1.5, u=0.2),
                tparams.make_model_params(beta=1.5, u=0.2))
    if kind == "solver_config":
        kw = dict(n_grid=128, bisect_iters=30, refine_crossings=False, numerics="adaptive")
        return jparams.SolverConfig(**kw), tparams.SolverConfig(**kw)
    if kind == "served_key":
        # the engine's (params, cfg_tag) payload, before the backend tag
        j = (jparams.make_model_params(beta=2.5, u=0.33),
             jckpt.canonicalize((jparams.SolverConfig(refine_crossings=False), "float64", 1)))
        t = (tparams.make_model_params(beta=2.5, u=0.33),
             tckpt.canonicalize((tparams.SolverConfig(refine_crossings=False), "float64", 1)))
        return j, t
    value = {
        "dict": {"beta": 1.5, "u": 0.2, "nested": {"x": 1, "y": [2, 3.5]}, 7: None},
        "tuple": (1, 2.0, "three", b"four", True, None, (5.5,)),
        "numpy_scalars": [np.float32(0.1), np.float64(0.1), np.int64(7), np.bool_(True),
                          np.int32(-3)],
        "numpy_arrays": [np.linspace(0, 1, 5), np.arange(6, dtype=np.int32).reshape(2, 3),
                         np.asfortranarray(np.eye(3, dtype=np.float32))],
        "floats": [0.1, -0.0, float("inf"), float("nan"), 1e-300, 2.0 ** 60],
    }[kind]
    return value, value


KINDS = ["model_params", "solver_config", "served_key", "dict", "tuple", "numpy_scalars",
         "numpy_arrays", "floats"]


@pytest.mark.parametrize("kind", KINDS)
def test_canonical_form_and_hex_equal_the_reference(kind):
    j, t = _pair(kind)
    assert tckpt.canonicalize(t) == jckpt.canonicalize(j)
    assert tckpt.params_fingerprint(t) == jckpt.params_fingerprint(j)


def test_dict_order_does_not_matter():
    a = {"beta": 1.5, "u": 0.2, "nested": {"x": 1, "y": 2}}
    b = {"nested": {"y": 2, "x": 1}, "u": 0.2, "beta": 1.5}
    assert tckpt.params_fingerprint(a) == tckpt.params_fingerprint(b)
    assert tckpt.params_fingerprint(tparams.make_model_params(u=0.2)) != \
        tckpt.params_fingerprint(tparams.make_model_params(u=0.2000001))
    assert "ModelParams(" in tckpt.canonicalize(tparams.make_model_params())


@pytest.mark.parametrize("value", [torch.zeros(3), torch.tensor(1.0), object(),
                                   {1, 2}, [torch.ones(1)]],
                         ids=["tensor", "scalar_tensor", "object", "set", "nested_tensor"])
def test_unknown_types_raise(value):
    with pytest.raises(TypeError):
        tckpt.canonicalize(value)
    with pytest.raises(TypeError):
        tckpt.params_fingerprint(value)


def test_fingerprint_stable_across_processes():
    expected = tckpt.params_fingerprint(tparams.make_model_params(beta=2.5, u=0.33))
    code = (
        "from sbr_tpu_torch.models.params import make_model_params\n"
        "from sbr_tpu_torch.utils.checkpoint import params_fingerprint\n"
        "print(params_fingerprint(make_model_params(beta=2.5, u=0.33)))"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(REPO), "PYTHONHASHSEED": "123"}, cwd=str(REPO),
    )
    assert out.returncode == 0, out.stderr[-800:]
    assert out.stdout.strip() == expected
    assert expected == jckpt.params_fingerprint(jparams.make_model_params(beta=2.5, u=0.33))


@pytest.mark.parametrize("extra", [
    {},
    {"params": "model"},
    {"params": "model", "config": True, "dtype": "float32"},
    {"config": True, "dtype": "float64", "extra": {"seeds": 4, "vary": "beta"}},
])
def test_infomodel_fingerprint_equals_the_reference(extra):
    groups = ((0.5, 0.0, 1.0), (0.5, 1.0, 2.0))
    jkw, tkw = {}, {}
    if "params" in extra:
        jkw["params"] = jparams.make_model_params(beta=2.0)
        tkw["params"] = tparams.make_model_params(beta=2.0)
    if extra.get("config"):
        jkw["config"] = jparams.SolverConfig(n_grid=256)
        tkw["config"] = tparams.SolverConfig(n_grid=256)
    if "dtype" in extra:
        jkw["dtype"] = np.dtype(extra["dtype"])
        tkw["dtype"] = getattr(torch, extra["dtype"])
    if "extra" in extra:
        jkw["extra"] = tkw["extra"] = extra["extra"]
    j = jspec.infomodel_fingerprint(jspec.InfoModelSpec(channel="bayes", groups=groups), **jkw)
    t = tspec.infomodel_fingerprint(tspec.InfoModelSpec(channel="bayes", groups=groups), **tkw)
    assert t == j
    if "dtype" in extra:  # a numpy dtype or its name keys the same
        tkw["dtype"] = np.dtype(extra["dtype"])
        assert tspec.infomodel_fingerprint(
            tspec.InfoModelSpec(channel="bayes", groups=groups), **tkw) == j


# ---------------------------------------------------------------------------
# Retry policy and budget
# ---------------------------------------------------------------------------

def _run_policy(mod, policy_kw, failures, budget_total=None, refill_s=None):
    """Drive ``mod.RetryPolicy.call`` with a flaky function, a patched
    sleep and clock; returns (outcome, sleeps, observed records)."""
    clock = [100.0]
    sleeps, records = [], []

    def sleep(s):
        sleeps.append(s)
        clock[0] += s

    budget = (mod.RetryBudget(budget_total, refill_s=refill_s, clock=lambda: clock[0])
              if budget_total is not None else None)
    calls = [0]

    def flaky():
        calls[0] += 1
        if calls[0] <= failures:
            raise RuntimeError(f"transient {calls[0]}")
        return "ok"

    policy = mod.RetryPolicy(**policy_kw)
    try:
        out = policy.call(flaky, scope="s", budget=budget, sleep=sleep,
                          rng=random.Random(3), observer=lambda **r: records.append(r))
    except mod.RetryError as err:
        out = ("RetryError", str(err))
    return out, sleeps, records, (budget.used if budget else None)


@pytest.mark.parametrize("case", [
    (dict(max_attempts=4, base_delay_s=0.5, multiplier=3.0, max_delay_s=2.0), 2, None),
    (dict(max_attempts=3, base_delay_s=0.1, jitter=0.5), 5, None),
    (dict(max_attempts=5, base_delay_s=0.2), 4, 2),
    (dict(max_attempts=2, base_delay_s=0.0), 1, 0),
])
def test_retry_policy_equals_the_reference(case):
    kw, failures, budget = case
    assert _run_policy(tretry, kw, failures, budget) == _run_policy(jretry, kw, failures, budget)


def test_deterministic_errors_are_not_retried():
    def bad():
        raise ValueError("bug")

    for mod in (tretry, jretry):
        with pytest.raises(ValueError):
            mod.RetryPolicy(max_attempts=5).call(bad, sleep=lambda s: None,
                                                 observer=lambda **r: None)
    # the port's default observer writes nothing, and the call still works
    assert tretry.RetryPolicy(max_attempts=1).call(lambda: 3) == 3


def test_retry_budget_refill_equals_the_reference():
    trace = {}
    for name, mod in (("port", tretry), ("ref", jretry)):
        clock = [0.0]
        b = mod.RetryBudget(3, refill_s=10.0, clock=lambda: clock[0])
        seen = []
        for step in range(12):
            clock[0] = step * 2.5
            seen.append((b.take(), b.remaining, b.used))
        trace[name] = seen
    assert trace["port"] == trace["ref"]


def test_policy_from_env_equals_the_reference(monkeypatch):
    monkeypatch.setenv("SBR_SERVE_RETRY_ATTEMPTS", "5")
    monkeypatch.setenv("SBR_SERVE_RETRY_JITTER", "0.25")
    kw = dict(max_attempts=2, base_delay_s=0.05, multiplier=2.0, max_delay_s=2.0)
    t = tretry.policy_from_env("SBR_SERVE_RETRY", **kw)
    j = jretry.policy_from_env("SBR_SERVE_RETRY", **kw)
    assert (t.max_attempts, t.base_delay_s, t.multiplier, t.max_delay_s, t.jitter) == \
        (j.max_attempts, j.base_delay_s, j.multiplier, j.max_delay_s, j.jitter) == \
        (5, 0.05, 2.0, 2.0, 0.25)


# ---------------------------------------------------------------------------
# Circuit breaker
# ---------------------------------------------------------------------------

def test_circuit_breaker_equals_the_reference():
    trace = {}
    for name, mod in (("port", tfleet), ("ref", jfleet)):
        clock = [0.0]
        seen = []
        br = mod.CircuitBreaker(threshold=2, cooldown_s=5.0, clock=lambda: clock[0],
                                on_transition=lambda old, new: seen.append((old, new)))
        for t, action in ((0, "fail"), (1, "fail"), (2, "allow"), (7, "allow"), (7, "allow"),
                          (7, "fail"), (13, "allow"), (13, "ok"), (14, "allow")):
            clock[0] = t
            if action == "allow":
                seen.append(br.allow())
            elif action == "fail":
                br.record_failure()
            else:
                br.record_success()
            seen.append((br.state, br.consecutive_failures))
        trace[name] = seen
    assert trace["port"] == trace["ref"]


# ---------------------------------------------------------------------------
# Integrity sidecars
# ---------------------------------------------------------------------------

def test_sidecar_verifies_and_a_mismatch_is_quarantined(tmp_path):
    f = tmp_path / "entry.json"
    f.write_text('{"xi": 1.0}')
    assert theal.verify_file(f) == "legacy"
    side = theal.write_sidecar(f)
    assert side == theal.sidecar_path(f) and side.read_text() == jheal.sidecar_path(f).read_text()
    assert theal.verify_file(f) == jheal.verify_file(f) == "ok"
    f.write_text('{"xi": 2.0}')
    assert theal.verify_file(f) == "mismatch"
    dest = theal.quarantine(f)
    assert dest == tmp_path / "quarantine" / "entry.json" and dest.exists()
    assert Path(str(dest) + ".sha256").exists() and not f.exists() and not side.exists()
    f.write_text("again")
    assert theal.quarantine(f) == tmp_path / "quarantine" / "entry.json.1"


# ---------------------------------------------------------------------------
# Latency histograms
# ---------------------------------------------------------------------------

def _fill(mod, values, bounds=None):
    h = mod.LogHistogram(bounds or mod.DEFAULT_LATENCY_BOUNDS_MS)
    for v in values:
        h.record(v)
    return h


def test_log_bounds_equal_the_reference():
    assert tmetrics.DEFAULT_LATENCY_BOUNDS_MS == jmetrics.DEFAULT_LATENCY_BOUNDS_MS
    assert tmetrics.log_bounds(0.1, 1000.0, 3) == jmetrics.log_bounds(0.1, 1000.0, 3)


def test_histogram_quantiles_delta_and_prometheus_equal_the_reference():
    rng = np.random.default_rng(0)
    warm = list(rng.lognormal(5.0, 1.0, 50))
    measured = list(rng.lognormal(0.0, 1.5, 400)) + [1e7]  # one in the overflow bucket
    out = {}
    for name, mod in (("port", tmetrics), ("ref", jmetrics)):
        h = _fill(mod, warm)
        before = h.copy()
        for v in measured:
            h.record(v)
        d = h.delta(before)
        out[name] = (
            [h.quantile(q) for q in (0.0, 0.5, 0.9, 0.99, 1.0)], h.summary(),
            d.summary(), d.counts, d.count, d.to_prometheus("lat", 'k="v"'),
            h.to_dict(), mod.LogHistogram.from_dict(h.to_dict()).summary(),
        )
        with pytest.raises(ValueError):
            h.delta(mod.LogHistogram((1.0, 2.0)))
        with pytest.raises(ValueError):
            h.add(mod.LogHistogram((1.0, 2.0)))
    assert out["port"] == out["ref"]
    assert out["port"][2]["count"] == 401 and out["port"][2]["max"] == 1e7


def test_histogram_overflow_and_empty():
    h = _fill(tmetrics, [99999.0], bounds=(1.0, 10.0))
    assert h.counts[-1] == 1 and h.quantile(0.99) == 99999.0
    assert tmetrics.LogHistogram((1.0,)).quantile(0.5) is None


# ---------------------------------------------------------------------------
# The loadgen's pool and mix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,n", [(0, 64), (1, 4096), (7, 3)])
def test_pool_and_mix_equal_the_reference(seed, n):
    t, j = tloadgen.build_pool(seed, n), jloadgen.build_pool(seed, n)
    assert [tckpt.canonicalize(p) for p in t] == [jckpt.canonicalize(p) for p in j]
    assert [tloadgen.params_doc(p) for p in t[:5]] == [jloadgen.params_doc(p) for p in j[:5]]
    assert tloadgen.query_mix(seed, n, 500) == jloadgen.query_mix(seed, n, 500)
