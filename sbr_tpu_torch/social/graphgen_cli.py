"""CLI of the device graph-generation self-check, the port of
``sbr_tpu.social.graphgen_cli``.

    python -m sbr_tpu_torch.social.graphgen_cli --selfcheck [--n 600]
        [--deg 6.0] [--seed 3] [--device cpu] [--obs-dir DIR]

It lives outside `graphgen` itself, which the package imports: ``python
-m`` on an imported module runs a second ``__main__`` copy of it, with
duplicate spec classes that break ``isinstance`` dispatch. It runs on the
CUDA card unless ``--device`` names another, through
`obs.audit.run_legacy_cli` (probe ``graphgen.layout``): a failed check
is a drift verdict and exit 1.
"""

from __future__ import annotations


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m sbr_tpu_torch.social.graphgen_cli",
        description="Device graph generation self-check (bitwise parity "
        "against the host canonical layout, fused against unfused steps)",
    )
    parser.add_argument("--selfcheck", action="store_true")
    parser.add_argument("--n", type=int, default=600)
    parser.add_argument("--deg", type=float, default=6.0)
    parser.add_argument("--seed", type=int, default=3)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    parser.add_argument("--obs-dir", default=None,
                        help="record the verdict as an audit probe event "
                        "under this obs run root")
    args = parser.parse_args(argv)
    if not args.selfcheck:
        parser.print_help()
        return 2
    from sbr_tpu_torch.obs import audit
    from sbr_tpu_torch.social.graphgen import _selfcheck

    # the audit protocol: a nonzero return is a drift verdict and exit 1;
    # the output is the self-check's
    return audit.run_legacy_cli(
        "graphgen.layout",
        lambda: _selfcheck(args.n, args.deg, args.seed, device=args.device),
        obs_dir=args.obs_dir,
    )


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
