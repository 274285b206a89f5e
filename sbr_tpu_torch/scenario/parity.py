"""Composed-vs-legacy parity smoke, the port of ``sbr_tpu.scenario.parity``.

    python -m sbr_tpu_torch.scenario.parity [--n 48] [--banks 3]
        [--device cpu] [--obs-dir DIR]

Two checks, both exact:

1. **Grid parity**: an n×n float64 β×u grid through `scenario.scenario_grid`
   with the baseline-reducible spec must give a status grid equal to
   `sweeps.beta_u_grid`'s, and ξ bit-equal where finite: the composed
   cell is `solve_param_cell`, so a divergence means the composition
   layer perturbed the shared cell.
2. **Multi-bank sanity**: N banks with an empty exposure network must be
   bit-identical to N independent single-bank solves through the same
   batched cell: zero spillover is a structural no-op, not an
   approximate one.

It runs on the CUDA card unless ``--device`` names another, through
`obs.audit.run_legacy_cli` (probe ``scenario.composed``): exit 0 on
success; an AssertionError (exit 1, a drift verdict) names the first
divergence.
"""

from __future__ import annotations

import argparse
import sys


def run_checks(n: int = 48, banks: int = 3, device=None) -> int:
    """Run both parity checks; raises AssertionError naming the first
    divergence, returns 0 on success (the audit legacy-CLI contract)."""
    import numpy as np
    import torch

    from sbr_tpu_torch import scenario
    from sbr_tpu_torch.models.params import SolverConfig, make_model_params
    from sbr_tpu_torch.scenario.engine import batch_fn
    from sbr_tpu_torch.scenario.multibank import _bank_columns
    from sbr_tpu_torch.social.agents import default_device
    from sbr_tpu_torch.sweeps.baseline_sweeps import beta_u_grid

    device = torch.device(device) if device is not None else default_device()
    f64 = torch.float64
    base = make_model_params()
    config = SolverConfig(n_grid=512, bisect_iters=60, refine_crossings=False)
    betas = np.linspace(0.25, 3.0, n)
    us = np.linspace(0.01, 0.99, n)

    spec = scenario.ScenarioSpec()  # baseline-reducible
    composed = scenario.scenario_grid(spec, betas, us, base, config=config, dtype=f64,
                                      device=device)
    legacy = beta_u_grid(betas, us, base, config=config, dtype=f64, device=device)

    st_c = composed.status.cpu().numpy()
    st_l = legacy.status.cpu().numpy()
    assert np.array_equal(st_c, st_l), (
        f"composed-vs-legacy status grids diverged in {np.sum(st_c != st_l)} cells"
    )
    xi_c = composed.xi.cpu().numpy()
    xi_l = legacy.xi.cpu().numpy()
    assert np.array_equal(np.isfinite(xi_c), np.isfinite(xi_l)), "finite masks diverged"
    both = np.isfinite(xi_c)
    assert np.array_equal(xi_c[both], xi_l[both]), (
        "composed ξ grid is not bit-identical to the legacy grid"
    )
    print(f"grid parity ok: {st_c.size} cells, {int((st_c == 0).sum())} runs, "
          f"ξ bitwise equal")

    # Multi-bank sanity: empty exposure == independent solves, bitwise.
    plist = [make_model_params(beta=1.0 + 0.2 * i, u=0.05 + 0.02 * i) for i in range(banks)]
    mb_spec = scenario.ScenarioSpec(banks=banks)
    mb = scenario.solve_multibank(mb_spec, plist, config=config, dtype=f64, device=device)
    assert mb.converged and mb.iterations == 1, (mb.converged, mb.iterations)

    cell_batch = batch_fn(scenario.ScenarioSpec(), config, "float64")
    cols = _bank_columns(mb_spec, plist, f64, device)
    xi_i, _tau_i, _aw_i, st_i, _h = cell_batch(*cols)
    xi_mb = mb.xi.cpu().numpy()
    xi_ind = xi_i.cpu().numpy()
    assert np.array_equal(mb.status.cpu().numpy(), st_i.cpu().numpy()), "multibank status diverged"
    both = np.isfinite(xi_mb)
    assert np.array_equal(both, np.isfinite(xi_ind)), "multibank finite masks diverged"
    assert np.array_equal(xi_mb[both], xi_ind[both]), (
        "empty-exposure multibank ξ is not bit-identical to independent solves"
    )
    kappa_col = cols[scenario.SCENARIO_KEYS.index("kappa")]
    assert np.array_equal(mb.kappa_eff.cpu().numpy(), kappa_col.cpu().numpy()), (
        "empty-exposure κ_eff drifted from the input κ column"
    )
    print(f"multibank sanity ok: {banks} banks, empty network bit-identical "
          f"to independent solves")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m sbr_tpu_torch.scenario.parity")
    parser.add_argument("--n", type=int, default=48, help="grid side (default 48)")
    parser.add_argument("--banks", type=int, default=3, help="banks in the sanity check")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    parser.add_argument("--obs-dir", default=None,
                        help="record the verdict as an audit probe event "
                        "under this obs run root")
    args = parser.parse_args(argv)

    # the audit protocol: an AssertionError becomes a drift verdict and
    # exit 1, the legacy contract
    from sbr_tpu_torch.obs import audit

    return audit.run_legacy_cli(
        "scenario.composed",
        lambda: run_checks(n=args.n, banks=args.banks, device=args.device),
        obs_dir=args.obs_dir,
    )


if __name__ == "__main__":
    sys.exit(main())
