"""Gradient parity battery: IFT gradients against central finite
differences, the port of ``sbr_tpu.grad.parity``.

A seeded sample of parameter points in float64; dξ/dβ, dξ/du and dξ/dκ
from `grad.api.xi_and_grad` against central differences of the same
forward value; exit 1 on a relative disagreement beyond the tolerance.
Autograd leaking through the root-finders' iterations would give a zero
gradient (grad/ift.py) and fail the match, so a pass shows that the IFT
rule carries the derivative.

    python -m sbr_tpu_torch.grad.parity [--n 6] [--seed 0] [--tol 1e-5] [--json]
        [--device cpu] [--obs-dir DIR]

It runs on the CUDA card unless ``--device`` names another. It runs
through `obs.audit.run_legacy_cli`: with ``--obs-dir`` the verdict lands
as an ``audit`` probe event (``grad.ift_fd``) in a run directory there.
"""

from __future__ import annotations

import argparse
import json
import sys


def run_battery(n: int = 6, seed: int = 0, tol: float = 1e-5, config=None,
                device=None) -> dict:
    """Sample ``n`` seeded points in the run region and compare IFT with
    FD in each ``wrt`` dimension. Returns a JSON-ready report with each
    point's worst relative error; ``report["ok"]`` is the verdict."""
    import numpy as np
    import torch

    from sbr_tpu_torch.grad import api
    from sbr_tpu_torch.models.params import SolverConfig, make_model_params, with_overrides

    if config is None:
        # Refinement on: the crossings are then roots of the continuous
        # hazard, smooth in θ, so central differences are an oracle at
        # 1e-5. The grid estimator has derivative kinks at knot handoffs,
        # which a difference straddles.
        config = SolverConfig(n_grid=512, bisect_iters=90, refine_crossings=True)
    rng = np.random.RandomState(seed)
    wrt = ("beta", "u", "kappa")
    f64 = torch.float64
    points, checked, worst = [], 0, 0.0
    # points that land on non-run cells are reported, not compared: the
    # battery gates on equilibria, the flags cover the rest
    for _ in range(n):
        beta = float(rng.uniform(0.8, 2.0))
        u = float(rng.uniform(0.05, 0.14))
        kappa = float(rng.uniform(0.4, 0.7))
        params = make_model_params(beta=beta, u=u, kappa=kappa)
        res = api.xi_and_grad(params, wrt=wrt, config=config, dtype=f64, device=device)
        entry = {"beta": beta, "u": u, "kappa": kappa, "status": int(res.status),
                 "flags": int(res.flags), "xi": float(res.xi_candidate)}
        if int(res.status) == 0 and int(res.flags) == 0:
            checked += 1
            rels = {}
            for k in wrt:
                h = 1e-6 * max(1.0, abs(entry[k]))
                # with_overrides pins the resolved η and tspan, so the
                # difference varies one θ entry: the partial derivative
                pp = with_overrides(params, **{k: entry[k] + h})
                pm = with_overrides(params, **{k: entry[k] - h})
                fd = (
                    float(api.xi_value(pp, config=config, dtype=f64, device=device))
                    - float(api.xi_value(pm, config=config, dtype=f64, device=device))
                ) / (2 * h)
                ift = float(res.grads[k])
                rel = abs(ift - fd) / max(abs(fd), 1e-12)
                rels[k] = {"ift": ift, "fd": fd, "rel": rel}
                worst = max(worst, rel)
            entry["rel_errors"] = rels
        points.append(entry)
    return {
        "n_points": n,
        "n_checked": checked,
        "worst_rel": worst,
        "tol": tol,
        "ok": bool(checked > 0 and worst <= tol),
        "points": points,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m sbr_tpu_torch.grad.parity",
        description="IFT-vs-finite-difference gradient parity battery (float64); "
        "exit 1 on disagreement beyond tolerance",
    )
    parser.add_argument("--n", type=int, default=6, help="parameter points (default 6)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--tol", type=float, default=1e-5,
                        help="max allowed relative error (default 1e-5)")
    parser.add_argument("--json", action="store_true", help="machine-readable output")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    parser.add_argument("--obs-dir", default=None,
                        help="record the verdict as an audit probe event "
                        "under this obs run root")
    args = parser.parse_args(argv)

    def _check() -> int:
        report = run_battery(n=args.n, seed=args.seed, tol=args.tol, device=args.device)
        if args.json:
            print(json.dumps(report))
        else:
            for pt in report["points"]:
                rels = pt.get("rel_errors")
                head = f"β={pt['beta']:.3f} u={pt['u']:.3f} κ={pt['kappa']:.3f}"
                if rels is None:
                    print(f"  skip  {head} (status {pt['status']}, flags {pt['flags']})")
                    continue
                line = " ".join(f"d{k}: {v['rel']:.2e}" for k, v in rels.items())
                print(f"  ok    {head}  {line}")
            print(
                f"grad parity: {report['n_checked']}/{report['n_points']} run points, "
                f"worst rel {report['worst_rel']:.3e} vs tol {report['tol']:g} "
                f"-> {'OK' if report['ok'] else 'FAIL'}"
            )
        if not report["ok"]:
            print("grad parity FAILED", file=sys.stderr)
            return 1
        return 0

    # the audit protocol: the verdict lands as an ``audit`` probe event;
    # flags, output and exit code are the battery's
    from sbr_tpu_torch.obs import audit

    return audit.run_legacy_cli("grad.ift_fd", _check, obs_dir=args.obs_dir)


if __name__ == "__main__":
    sys.exit(main())
