"""The port's chaos drills (sbr_tpu_torch.resilience.chaos) against the
reference's (sbr_tpu/resilience/chaos.py, read with ``ast``), on the CPU.

Contracts:

- every drill's ``checks`` keys are the reference's, in its order; the
  fault plans, the sweep and fleet shapes, the answer fields and
  `_prewarm_pool_coords` are the reference's;
- the drills' own process imports no torch (its workers do);
- the base drill and the churn drill, run as ``python -m
  sbr_tpu_torch.resilience.chaos [--churn] --device cpu --json``, exit 0
  with ``"ok": true``; the base drill's fault-free grid equals the
  reference's `beta_u_grid` on the same 4×4 axes and solver: statuses
  equal, floats within 1e-12 in float64.

The serving drills are in tests/test_torch_chaos_fleet.py and
tests/test_torch_chaos_prewarm.py, so the suite's workers spread them.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import torch_chaos as tc  # noqa: E402
from sbr_tpu_torch.resilience import chaos  # noqa: E402
from sbr_tpu_torch.serve.loadgen import build_pool  # noqa: E402

F64_TOL = 1e-12


@pytest.mark.parametrize("drill", sorted(tc.DRILLS))
def test_drill_check_keys_equal_the_reference(drill):
    ref_fn, port_fn, _ = tc.DRILLS[drill]
    want = tc.check_keys(tc.REFERENCE, ref_fn)
    assert want and tc.check_keys(tc.PORT, port_fn) == want


@pytest.mark.parametrize("name", ["FAULT_PLAN", "CHURN_FAULT_PLAN", "_PREWARM_HANG_PLAN",
                                  "_PREWARM_OUTAGE_PLAN", "_AUDIT_FAULT_PLAN", "_AUDIT_ENV",
                                  "_FLEET", "_SWEEP", "_FIELDS", "_ANSWER_FIELDS"])
def test_plans_and_shapes_equal_the_reference(name):
    assert tc.constant(tc.PORT, name) == tc.constant(tc.REFERENCE, name)
    assert getattr(chaos, name) == tc.constant(tc.REFERENCE, name)


@pytest.mark.parametrize("seed, pool", [(0, 6), (3, 17)])
def test_prewarm_pool_coords_equal_the_reference_and_loadgen(seed, pool):
    want = tc.reference_function("_prewarm_pool_coords")(seed, pool)
    assert chaos._prewarm_pool_coords(seed, pool) == want
    # and the pool loadgen serves
    got = [(float(p.learning.beta), float(p.economic.u)) for p in build_pool(seed, pool)]
    assert got == want
    plan = {"tiles": [{"betas": [want[0][0], want[1][0]], "us": [want[0][1]]},
                      {"betas": [want[0][0]], "us": []}]}
    assert chaos._prewarm_expanded_tiles(plan) == \
        tc.reference_function("_prewarm_expanded_tiles")(plan) == 2


def test_chaos_module_imports_no_torch():
    code = ("import sys\n"
            "import sbr_tpu_torch.resilience.chaos\n"
            "assert 'torch' not in sys.modules\n"
            "print('ok')\n")
    env = {**os.environ, "PYTHONPATH": str(tc.REPO)}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    helped = subprocess.run([sys.executable, "-m", "sbr_tpu_torch.resilience.chaos", "--help"],
                            env=env, capture_output=True, text=True, timeout=120)
    assert helped.returncode == 0 and "--device" in helped.stdout


@pytest.fixture(scope="module")
def base_drill(tmp_path_factory):
    out = tmp_path_factory.mktemp("chaos") / "base"
    return (*tc.run_drill("base", out), out)


def test_base_drill_passes_on_the_cpu(base_drill):
    rc, doc, seconds, out = base_drill
    assert rc == 0 and doc.get("ok") is True, (
        [k for k, v in (doc.get("checks") or {}).items() if not v], doc)
    assert list(doc["checks"]) == tc.check_keys(tc.REFERENCE, "main")
    assert doc["out"] == str(out)


def test_base_grid_equals_the_reference_beta_u_grid(base_drill):
    """The drill's fault-free grid against `sbr_tpu.sweeps.beta_u_grid` on
    the same axes and solver (the reference's worker pins x64 off; the
    port's grid is float64, so the reference runs it in float64 here)."""
    from sbr_tpu.models.params import SolverConfig, make_model_params
    from sbr_tpu.sweeps import beta_u_grid

    rc, _doc, _s, out = base_drill
    assert rc == 0
    got = np.load(out / "baseline.npz")
    betas, us = chaos._sweep_values()
    assert jax.config.jax_enable_x64  # the suite's conftest turns it on
    want = beta_u_grid(betas, us, make_model_params(),
                       config=SolverConfig(n_grid=chaos._SWEEP["n_grid"],
                                           bisect_iters=chaos._SWEEP["bisect_iters"]),
                       dtype=np.float64)
    want = {f: np.asarray(getattr(want, f)) for f in chaos._FIELDS}
    np.testing.assert_array_equal(got["status"], want["status"])
    for f in ("xi", "max_aw"):
        assert got[f].dtype == np.float64
        np.testing.assert_array_equal(np.isnan(got[f]), np.isnan(want[f]))
        ok = ~np.isnan(want[f])
        assert np.abs(got[f][ok] - want[f][ok]).max() <= F64_TOL, f
    # the resumed grid is the baseline byte for byte (the drill's headline)
    assert chaos._bit_identical(out / "baseline.npz", out / "resumed.npz")


def test_churn_drill_passes_on_the_cpu(tmp_path):
    rc, doc, _seconds = tc.run_drill("churn", tmp_path / "churn")
    assert rc == 0 and doc.get("ok") is True, (
        [k for k, v in (doc.get("checks") or {}).items() if not v], doc)
    assert list(doc["checks"]) == tc.check_keys(tc.REFERENCE, "main_churn")
