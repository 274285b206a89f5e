"""Information-model parity smoke, the port of ``sbr_tpu.infomodels.parity``.

    python -m sbr_tpu_torch.infomodels.parity [--n 600] [--device cpu]
        [--obs-dir DIR]

Three checks:

1. **Gossip bitwise reduction**: the group-free static gossip
   `InfoModelSpec` must reproduce the legacy `simulate_agents` trajectory
   byte for byte across {gather, incremental} × {f32, f64} × the two
   lowerings of the infection step. The reference's two are "lax" and
   "interpret" (the Pallas kernel's body); the port's are "lax" (the
   plain step) and the kernel: "pallas" on the card, where it is
   ``csrc/infection_update.cu``, and on the CPU "interpret", which names
   the plain step again. Each lowering's trajectory must also equal the
   other's, so on the card the kernel is held to the plain step bit for
   bit.
2. **Bayes close-the-loop**: a small Bayesian-observer population (every
   step in the belief kernel on the card) must close against its
   mean-field fixed point (converged, bank run, errors inside the smoke
   tolerance).
3. **Population determinism**: the same population query twice must give
   identical records and identical fingerprints (the serving cache key).

It runs on the CUDA card unless ``--device`` names another, through
`obs.audit.run_legacy_cli` (probe ``infomodel.gossip``): with
``--obs-dir`` the battery runs inside an obs run whose directory is
printed (the input of ``report infomodel`` and ``report audit``). Exit 0
on success; an AssertionError (exit 1) names the first divergence.
"""

from __future__ import annotations

import argparse
import sys

_FIELDS = ("informed", "t_inf", "informed_frac", "withdrawn_frac")


def lowerings(device) -> tuple:
    """The two lowerings the gossip reduction runs: the plain step, and
    the kernel on the card (the plain step under the reference's second
    name on the CPU)."""
    import torch

    return ("lax", "pallas" if torch.device(device).type == "cuda" else "interpret")


def run_checks(n: int = 600, device=None) -> int:
    """Run all three checks; raises AssertionError naming the first
    divergence, returns 0 on success (the audit legacy-CLI contract)."""
    import numpy as np
    import torch

    from sbr_tpu_torch.infomodels import (
        InfoModelSpec,
        population_fingerprint,
        population_query,
        simulate_info,
    )
    from sbr_tpu_torch.models.params import SolverConfig, make_model_params
    from sbr_tpu_torch.social.agents import AgentSimConfig, default_device, simulate_agents
    from sbr_tpu_torch.social.closure import close_loop
    from sbr_tpu_torch.social.graphgen import ErdosRenyiSpec, prepare_generated_graph

    device = torch.device(device) if device is not None else default_device()
    graph = ErdosRenyiSpec(n=n, avg_degree=8.0)
    spec = InfoModelSpec()  # gossip, static, homogeneous: the reduction
    modes = lowerings(device)
    for engine in ("gather", "incremental"):
        for dtype in (np.float32, np.float64):
            by_mode = {}
            for fused in modes:
                cfg = AgentSimConfig(n_steps=25, dt=0.1, fused=fused)
                r_info = simulate_info(
                    spec, graph, beta=1.2, x0=0.02, config=cfg, seed=7,
                    dtype=dtype, engine=engine, device=device,
                )
                pg = prepare_generated_graph(
                    graph, seed=7, betas=1.2, config=cfg, dtype=dtype,
                    engine=engine, device=device,
                )
                r_leg = simulate_agents(prepared=pg, x0=0.02, config=cfg, seed=7)
                label = f"{engine}/{np.dtype(dtype).name}/{fused}"
                for f in _FIELDS:
                    a = getattr(r_info, f).cpu().numpy()
                    b = getattr(r_leg, f).cpu().numpy()
                    assert np.array_equal(a, b), f"gossip reduction diverged at {label}.{f}"
                by_mode[fused] = r_info
            a, b = (by_mode[m] for m in modes)
            for f in _FIELDS:
                assert np.array_equal(getattr(a, f).cpu().numpy(), getattr(b, f).cpu().numpy()), (
                    f"{engine}/{np.dtype(dtype).name}: {modes[1]} diverged from {modes[0]} at {f}"
                )
    print("gossip reduction ok: bitwise across "
          f"{{gather,incremental}} x {{f32,f64}} x {{{','.join(modes)}}}")

    # Bayes close-the-loop at smoke scale.
    model = make_model_params(beta=0.9, eta_bar=30.0, u=0.5, p=0.99, kappa=0.25, lam=0.25)
    bayes = InfoModelSpec(channel="bayes")
    tol = 0.25
    comp = close_loop(
        model=model, infomodel=bayes, n_agents=4000, avg_degree=15.0,
        dt=0.05, g0=0.2, t_max=8.0, n_reps=2,
        config=SolverConfig(n_grid=512), tolerance=tol, device=device,
    )
    assert bool(comp.fp.converged), "bayes fixed point did not converge"
    assert bool(comp.fp.equilibrium.bankrun), "bayes fixed point has no run"
    assert comp.err_aw_sup < tol, f"bayes closure err_aw_sup {comp.err_aw_sup:.4f} over {tol}"
    print(f"bayes close-the-loop ok: err_aw_sup {comp.err_aw_sup:.4f} "
          f"(< {tol}), xi {float(comp.fp.xi):.4f}")

    # Population determinism + fingerprint stability.
    pop_graph = ErdosRenyiSpec(n=1500, avg_degree=10.0)
    recs = [
        population_query(bayes, pop_graph, model, seeds=3, vary="sim", g0=None,
                         config=SolverConfig(n_grid=256), device=device)
        for _ in range(2)
    ]
    assert recs[0] == recs[1], "population query is not deterministic"
    kw = {"spec": bayes, "graph": pop_graph, "seeds": 3, "vary": "sim", "seed": 0, "dt": 0.1}
    f1 = population_fingerprint(kw, model, SolverConfig(n_grid=256), "float64")
    f2 = population_fingerprint(kw, model, SolverConfig(n_grid=256), "float64")
    assert f1 == f2, "population fingerprint unstable"
    assert population_fingerprint(
        {**kw, "seeds": 4}, model, SolverConfig(n_grid=256), "float64"
    ) != f1, "population fingerprint ignores the seed count"
    print(f"population determinism ok: run_p {recs[0]['run_probability']:.2f}, "
          f"fingerprint {f1[:12]}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m sbr_tpu_torch.infomodels.parity")
    parser.add_argument("--n", type=int, default=600, help="agents (default 600)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    parser.add_argument(
        "--obs-dir", default=None,
        help="run the battery inside an obs run rooted here (dir printed)",
    )
    args = parser.parse_args(argv)

    # the audit protocol: run_legacy_cli owns the obs run (the "obs run
    # dir:" line), records the verdict as an audit probe event beside the
    # infomodel events the checks emit, and keeps AssertionError → exit 1
    from sbr_tpu_torch.obs import audit

    return audit.run_legacy_cli(
        "infomodel.gossip", lambda: run_checks(n=args.n, device=args.device),
        obs_dir=args.obs_dir,
    )


if __name__ == "__main__":
    sys.exit(main())
