"""The replication runner: the port of ``sbr_tpu.figures.master`` (the
reference's ``MASTER.jl`` as a CLI).

Runs the four workload sections (baseline, heterogeneity, interest rates,
social learning) on the CUDA card, or on the CPU with ``--device cpu``, and
writes the 13 figure PDFs, the agent-closure figure, the combined document
``replication_figures.pdf`` (full runs only) and ``replication_figures.tex``
under the output directory, printing the reference's manifest. The exit
code is 1 when an expected figure is missing (a no-run outcome skips its
figure and is not missing). ``--paper`` adds the paper-resolution heatmap
through the tiled, checkpointed sweep (resumable); ``--obs`` records a run
directory (``events.jsonl`` + ``manifest.json``) under ``OUTPUT/obs/``.

The figures, file names and tex are the reference's; the default output
is ``output_torch/``, so the reference's committed ``output/`` is never
overwritten. ``--f32`` runs every solve in ``torch.float32`` (the paper
heatmap is float32 either way).

Usage:
    python -m sbr_tpu_torch.figures.master [--output DIR] [--sections 1,2,3,4]
                                           [--fast] [--f32] [--obs] [--paper]
                                           [--device {cuda,cpu}]
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time
from pathlib import Path

import torch

from sbr_tpu_torch.figures import backend

# The document title's name of this package (the reference's says
# "sbr_tpu TPU-native framework").
TITLE = "sbr_tpu_torch PyTorch/CUDA port"
TITLE_TEX = r"sbr\_tpu\_torch PyTorch/CUDA port"

# Paper-resolution extras, generated only with --paper (the reference ships
# this as the "couple hours" 5000×5000 grid, `1_baseline.jl:209-210`).
PAPER_HEATMAP = "baseline/comp_stat_cross_heatmap_AW_large.pdf"

# Framework extra (beyond the reference's 13 figures): the explicit-agent
# population run with the withdrawal window derived from the solved social
# fixed point, validating the equilibrium→agent loop (social/closure.py).
CLOSURE_FIG = "social_learning/agent_vs_fixed_point.pdf"

# Extra figures folded into a section's tex when present on disk.
_EXTRAS = {1: [PAPER_HEATMAP], 4: [CLOSURE_FIG]}

# The 13 reference figures (`MASTER.jl:31-88`), keyed by section.
MANIFEST = {
    1: [
        "baseline/learning_dynamics.pdf",
        "baseline/hazard_rate.pdf",
        "baseline/equilibrium_dynamics_main.pdf",
        "baseline/equilibrium_dynamics_fast.pdf",
        "baseline/equilibrium_dynamics_low_u.pdf",
        "baseline/comp_stat_u_panel_a.pdf",
        "baseline/comp_stat_u_panel_b.pdf",
        "baseline/comp_stat_cross_heatmap_AW.pdf",
    ],
    2: ["heterogeneity/aggregate_withdrawals_hetero.pdf"],
    3: ["interest_rates/value_function.pdf", "interest_rates/hazard_decomposition.pdf"],
    4: [
        "social_learning/social_learning_equilibrium.pdf",
        "social_learning/baseline_equilibrium.pdf",
    ],
}


# Live PdfPages collector for the combined figure document (the reference
# ships a LaTeX-compiled output/replication_figures.pdf; the document here
# is composed directly from the live figures at generation time). Set
# per-run by main(); None disables collection.
# _PDF_PENDING_HEADER holds a section header emitted lazily before the
# section's FIRST figure, so all-skipped sections leave no empty header.
_PDF_DOC = None
_PDF_PENDING_HEADER = None


def _save(fig, path: Path) -> None:
    global _PDF_PENDING_HEADER
    path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(path, bbox_inches="tight")
    if _PDF_DOC is not None:
        if _PDF_PENDING_HEADER is not None:
            _pdf_text_page(_PDF_DOC, [_PDF_PENDING_HEADER], size=18)
            _PDF_PENDING_HEADER = None
        _PDF_DOC.savefig(fig, bbox_inches="tight")
    backend.pyplot().close(fig)
    print(f"  ✓ saved {path}")


def _pdf_text_page(doc, lines, size=20) -> None:
    """A text-only page (title / section header) in the combined document."""
    plt = backend.pyplot()
    fig = plt.figure(figsize=(8.27, 11.69))  # A4 portrait
    fig.text(
        0.5, 0.6, "\n\n".join(lines), ha="center", va="center",
        fontsize=size, wrap=True,
    )
    doc.savefig(fig)
    plt.close(fig)


def _device(device):
    from sbr_tpu_torch.social.agents import default_device

    return torch.device(device) if device is not None else default_device()


def run_baseline(figdir: Path, fast: bool, device=None, dtype=None) -> None:
    """Section 1: Figures 1-5 (`scripts/1_baseline.jl`)."""
    import numpy as np

    from sbr_tpu_torch.baseline.learning import solve_learning
    from sbr_tpu_torch.baseline.solver import solve_equilibrium_baseline
    from sbr_tpu_torch.figures.plotting import (
        plot_comp_stat_withdrawals_and_collapse,
        plot_equilibrium,
        plot_hazard_rate_decomposition,
        plot_heatmap_aw,
        plot_learning_distribution,
    )
    from sbr_tpu_torch.models.params import LearningParams, make_model_params, with_overrides
    from sbr_tpu_torch.sweeps.baseline_sweeps import beta_u_grid, u_sweep
    from sbr_tpu_torch.utils.status import status_summary

    device = _device(device)
    m_base = make_model_params(beta=1.0, eta_bar=15.0, u=0.1, p=0.5, kappa=0.6, lam=0.01)
    lr_base = solve_learning(m_base.learning, dtype=dtype, device=device)

    # Figure 1: learning CDFs for β ∈ {0.5, 1, 2} on (0, 20)
    # (`1_baseline.jl:60-74`).
    print("Figure 1: learning dynamics")
    beta_values = [0.5, 1.0, 2.0]
    curves = [
        solve_learning(LearningParams(beta=b, tspan=(0.0, 20.0), x0=1e-4), dtype=dtype,
                       device=device)
        for b in beta_values
    ]
    _save(
        plot_learning_distribution(curves, (0.0, 20.0), beta_values),
        figdir / "baseline/learning_dynamics.pdf",
    )

    # Figures 2-3: main equilibrium (`1_baseline.jl:82-97`).
    print("Figures 2-3: main equilibrium")
    result = solve_equilibrium_baseline(lr_base, m_base.economic)
    print(f"  ξ* = {float(result.xi):.2f}, bankrun = {bool(result.bankrun)}")
    _save(
        plot_equilibrium(result, lr_base, m_base.economic, x_range=(0, 15)),
        figdir / "baseline/equilibrium_dynamics_main.pdf",
    )
    _save(
        plot_hazard_rate_decomposition(result, lr_base, m_base.economic),
        figdir / "baseline/hazard_rate.pdf",
    )

    # Figures 3bis/3ter: fast communication and low u (`1_baseline.jl:106-126`).
    print("Figures 3bis/3ter: fast β and low u")
    for name, overrides in (("fast", dict(beta=3.0)), ("low_u", dict(u=0.01))):
        m_alt = with_overrides(m_base, **overrides)
        lr_alt = solve_learning(m_alt.learning, dtype=dtype, device=device)
        res_alt = solve_equilibrium_baseline(lr_alt, m_alt.economic)
        print(f"  {name}: ξ* = {float(res_alt.xi):.2f}, bankrun = {bool(res_alt.bankrun)}")
        _save(
            plot_equilibrium(res_alt, lr_alt, m_alt.economic, x_range=(0, 15)),
            figdir / f"baseline/equilibrium_dynamics_{name}.pdf",
        )

    # Figure 4: u-sweep, paper resolution 5000 points over [0.001, 0.2]
    # (`1_baseline.jl:137-200`), one batched solve with Stage 1 shared.
    n_u = 500 if fast else 5000
    print(f"Figure 4: u-sweep ({n_u} points)")
    sweep = u_sweep(lr_base, np.linspace(0.001, 0.2, n_u), m_base.economic)
    print(f"  {status_summary(sweep.status)} (no-run region recovered from status grid)")
    fig_a, fig_b = plot_comp_stat_withdrawals_and_collapse(
        sweep.u_values,
        sweep.max_withdrawals,
        sweep.collapse_times,
        m_base.economic.kappa,
        return_times=sweep.return_times,
    )
    _save(fig_a, figdir / "baseline/comp_stat_u_panel_a.pdf")
    _save(fig_b, figdir / "baseline/comp_stat_u_panel_b.pdf")

    # Figure 5: β×u heatmap, replication resolution 500×500
    # (`1_baseline.jl:210-284`); x-axis is average meeting time = 1/β.
    n_grid = 100 if fast else 500
    print(f"Figure 5: β×u heatmap ({n_grid}×{n_grid})")
    amt = np.linspace(1e-4, 1.0, n_grid)
    u_vals = np.linspace(0.001, 1.0, n_grid)
    grid = beta_u_grid(1.0 / amt, u_vals, m_base, dtype=dtype, device=device)
    print(f"  {status_summary(grid.status)}")
    # Reference stores (U, B) (`1_baseline.jl:213`); ours is (B, U).
    _save(
        plot_heatmap_aw(amt, u_vals, grid.max_aw.cpu().numpy().T),
        figdir / "baseline/comp_stat_cross_heatmap_AW.pdf",
    )


def run_paper_heatmap(figdir: Path, ckpt_dir: Path, res: int, tile: int, device=None) -> None:
    """Paper-resolution Figure-5 heatmap through the tiled checkpoint/resume
    machinery (`utils.checkpoint.run_tiled_grid`), in float32 as in the
    reference.

    The reference generates this 5000×5000 grid in "a couple hours" with no
    resume (`1_baseline.jl:209-210`). Here finished tiles persist under
    ``ckpt_dir``: re-running after an interrupt recomputes only missing
    tiles. The directory carries the port's backend tag, so a directory
    the reference wrote is refused rather than adopted."""
    import numpy as np

    from sbr_tpu_torch.figures.plotting import plot_heatmap_aw
    from sbr_tpu_torch.models.params import make_model_params
    from sbr_tpu_torch.utils.checkpoint import run_tiled_grid
    from sbr_tpu_torch.utils.status import status_summary

    m_base = make_model_params(beta=1.0, eta_bar=15.0, u=0.1, p=0.5, kappa=0.6, lam=0.01)
    amt = np.linspace(1e-4, 1.0, res)
    u_vals = np.linspace(0.001, 1.0, res)
    print(f"Paper heatmap: {res}×{res} grid, {tile}×{tile} tiles, resume dir {ckpt_dir}")
    grid = run_tiled_grid(
        1.0 / amt,
        u_vals,
        m_base,
        tile_shape=(tile, tile),
        checkpoint_dir=str(ckpt_dir),
        dtype=torch.float32,
        verbose=True,
        device=_device(device),
    )
    print(f"  {status_summary(grid.status)}")
    _save(
        plot_heatmap_aw(amt, u_vals, grid.max_aw.numpy().T),
        figdir / PAPER_HEATMAP,
    )


def run_heterogeneity(figdir: Path, fast: bool, device=None, dtype=None) -> None:
    """Section 2: two-group model figure (`scripts/2_heterogeneity.jl`)."""
    from sbr_tpu_torch.figures.plotting import plot_aw_hetero
    from sbr_tpu_torch.hetero.learning import solve_learning_hetero
    from sbr_tpu_torch.hetero.solver import get_aw_hetero, solve_equilibrium_hetero
    from sbr_tpu_torch.models.params import make_hetero_params

    # `2_heterogeneity.jl:38-49`: slow/fast learners.
    m = make_hetero_params(
        betas=[0.125, 12.5], dist=[0.9, 0.1], eta_bar=30.0, u=0.1, p=0.9, kappa=0.3, lam=0.1
    )
    lsh = solve_learning_hetero(m.learning, dtype=dtype, device=_device(device))
    result = solve_equilibrium_hetero(lsh, m.economic)
    print(f"  hetero: ξ* = {float(result.xi):.2f}, bankrun = {bool(result.bankrun)}")
    aw = get_aw_hetero(result, lsh)
    print(f"  max AW = {float(aw.aw_max):.3f}")
    _save(
        plot_aw_hetero(result, aw, m.economic, m.learning.betas),
        figdir / "heterogeneity/aggregate_withdrawals_hetero.pdf",
    )


def run_interest(figdir: Path, fast: bool, device=None, dtype=None) -> None:
    """Section 3: value function + hazard decomposition with the rV
    threshold (`scripts/3_interest_rates.jl`)."""
    from sbr_tpu_torch.baseline.learning import solve_learning
    from sbr_tpu_torch.figures.plotting import plot_hazard_rate_decomposition, plot_value_function
    from sbr_tpu_torch.interest.solver import solve_equilibrium_interest
    from sbr_tpu_torch.models.params import make_interest_params

    # `3_interest_rates.jl:37-46`.
    m = make_interest_params(
        beta=1.0, eta_bar=15.0, u=0.0, p=0.5, kappa=0.6, lam=0.01, r=0.06, delta=0.1
    )
    ls = solve_learning(m.learning, dtype=dtype, device=_device(device))
    result = solve_equilibrium_interest(ls, m.economic)
    print(f"  interest: ξ* = {float(result.base.xi):.2f}, bankrun = {bool(result.base.bankrun)}")
    _save(plot_value_function(result, m.economic), figdir / "interest_rates/value_function.pdf")
    # Threshold curve u + rV(τ̄) on the hazard grid (`3_interest_rates.jl:141-146`).
    threshold = m.economic.u + m.economic.r * result.v.cpu().numpy()
    _save(
        plot_hazard_rate_decomposition(
            result.base, ls, m.economic, threshold_curve=threshold, threshold_label=r"$rV(\tau)$"
        ),
        figdir / "interest_rates/hazard_decomposition.pdf",
    )


def run_social(figdir: Path, fast: bool, device=None, dtype=None) -> set:
    """Section 4: social-learning fixed point vs word-of-mouth baseline
    (`scripts/4_social_learning.jl`), then the equilibrium→agent closure,
    whose every simulated step ends in the infection kernel on the card."""
    from sbr_tpu_torch.baseline.learning import solve_learning
    from sbr_tpu_torch.baseline.solver import solve_equilibrium_baseline
    from sbr_tpu_torch.figures.plotting import plot_equilibrium
    from sbr_tpu_torch.models.params import make_model_params
    from sbr_tpu_torch.social.solver import solve_equilibrium_social

    device = _device(device)
    # `4_social_learning.jl:36-43`.
    m = make_model_params(beta=0.9, eta_bar=30.0, u=0.5, p=0.99, kappa=0.25, lam=0.25)
    social = solve_equilibrium_social(m, tol=1e-4, max_iter=500, dtype=dtype, device=device)
    lr_wom = solve_learning(m.learning, dtype=dtype, device=device)
    baseline = solve_equilibrium_baseline(lr_wom, m.economic)

    # Cross-model comparison the reference prints (`4_social_learning.jl:65-81`).
    xi_s, xi_b = float(social.equilibrium.xi), float(baseline.xi)
    print(f"  social: ξ* = {xi_s:.2f} ({int(social.iterations)} iterations, "
          f"converged = {bool(social.converged)})")
    print(f"  baseline (WOM): ξ* = {xi_b:.2f}")
    if social.equilibrium.bankrun and baseline.bankrun:
        timing = "later" if xi_s > xi_b else "earlier"
        print(f"  Δξ* = {xi_s - xi_b:.3f} ({timing} with social learning)")

    # A no-run outcome legitimately skips its figure
    # (`4_social_learning.jl:104-118`); report the skip so the manifest
    # check can distinguish it from a failure.
    skipped = set()
    if bool(social.equilibrium.bankrun):
        _save(
            plot_equilibrium(social.equilibrium, social.learning, m.economic),
            figdir / "social_learning/social_learning_equilibrium.pdf",
        )
    else:
        print("  ! no social-learning equilibrium to plot (no bank run)")
        skipped.add("social_learning/social_learning_equilibrium.pdf")
    if bool(baseline.bankrun):
        _save(
            plot_equilibrium(baseline, lr_wom, m.economic),
            figdir / "social_learning/baseline_equilibrium.pdf",
        )
    else:
        print("  ! no baseline equilibrium to plot (no bank run)")
        skipped.add("social_learning/baseline_equilibrium.pdf")

    # Equilibrium→agent loop closure: feed the solved fixed point's
    # withdrawal window into the explicit-agent simulation and plot both
    # against the fixed point's own curves.
    if bool(social.equilibrium.bankrun):
        from sbr_tpu_torch.figures.plotting import plot_agent_closure
        from sbr_tpu_torch.social.closure import close_loop

        n, deg, dt = (20_000, 15.0, 0.1) if fast else (200_000, 60.0, 0.05)
        comp = close_loop(model=m, n_agents=n, avg_degree=deg, dt=dt, t_max=16.0, fp=social,
                          device=device)
        print(
            f"  closure: {n:,} agents, window [{comp.exit_delay:.2f}, "
            f"{comp.reentry_delay:.2f}), AW sup-error {comp.err_aw_sup:.3f}"
        )
        _save(plot_agent_closure(comp), figdir / CLOSURE_FIG)
    return skipped


def write_tex(outdir: Path, sections: list, skip=()) -> Path:
    """Generate `replication_figures.tex` with the same section/figure
    structure as the reference (`output/replication_figures.tex:23-127`).
    Figures in ``skip`` (intentionally not generated, e.g. no-run outcomes)
    are omitted so the document always compiles."""
    titles = {
        1: "Baseline Model",
        2: "Heterogeneity Extension",
        3: "Interest Rates Extension",
        4: "Social Learning Extension",
    }
    captions = {
        PAPER_HEATMAP: r"Peak withdrawals over the $\beta \times u$ grid (paper resolution)",
        CLOSURE_FIG: "Explicit-agent population under the equilibrium withdrawal window vs the social-learning fixed point",
        "baseline/learning_dynamics.pdf": r"Learning dynamics for different communication speeds $\beta$",
        "baseline/hazard_rate.pdf": "Hazard rate decomposition: total hazard, belief fragility, and conditional hazard",
        "baseline/equilibrium_dynamics_main.pdf": "Equilibrium dynamics: aggregate withdrawals (main calibration)",
        "baseline/equilibrium_dynamics_fast.pdf": r"Equilibrium dynamics with fast communication ($\beta = 3$)",
        "baseline/equilibrium_dynamics_low_u.pdf": "Equilibrium dynamics with low deposit utility ($u = 0.01$)",
        "baseline/comp_stat_u_panel_a.pdf": "Comparative statics in $u$: peak withdrawals",
        "baseline/comp_stat_u_panel_b.pdf": "Comparative statics in $u$: collapse and return times",
        "baseline/comp_stat_cross_heatmap_AW.pdf": r"Peak withdrawals over the $\beta \times u$ grid",
        "heterogeneity/aggregate_withdrawals_hetero.pdf": "Aggregate withdrawals with heterogeneous learning speeds",
        "interest_rates/value_function.pdf": "Depositor value function with positive interest",
        "interest_rates/hazard_decomposition.pdf": "Hazard decomposition with the $rV$ threshold",
        "social_learning/social_learning_equilibrium.pdf": "Equilibrium under social learning from withdrawals",
        "social_learning/baseline_equilibrium.pdf": "Baseline (word-of-mouth) equilibrium at the same parameters",
    }
    lines = [
        r"\documentclass[12pt]{article}",
        r"\usepackage{graphicx}",
        r"\usepackage{float}",
        r"\usepackage[margin=1in]{geometry}",
        r"\title{Replication Figures\\The Social Determinants of Bank Runs\\"
        rf"({TITLE_TEX})}}",
        r"\date{\today}",
        r"\begin{document}",
        r"\maketitle",
        r"\section*{Note}",
        "This document collects all figures generated by the sbr\\_tpu",
        "replication run, organized as in the reference package: the baseline",
        "model and its three extensions.",
    ]
    figdir = outdir / "figures"
    outdir.mkdir(parents=True, exist_ok=True)  # nothing else creates it when
    # no section ran (e.g. --sections "" smoke/paper-only invocations)
    for sec in sections:
        lines.append(rf"\section{{{titles[sec]}}}")
        # Extra figures join their section when present on disk.
        extras = [f for f in _EXTRAS.get(sec, []) if (figdir / f).exists()]
        for fig in MANIFEST[sec] + extras:
            if fig in skip:
                continue
            lines += [
                r"\begin{figure}[H]",
                r"    \centering",
                rf"    \includegraphics[width=0.7\textwidth]{{figures/{fig}}}",
                rf"    \caption{{{captions[fig]}}}",
                r"\end{figure}",
            ]
    lines.append(r"\end{document}")
    tex_path = outdir / "replication_figures.tex"
    tex_path.write_text("\n".join(lines) + "\n")
    return tex_path


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Generate all replication figures (MASTER.jl equivalent) with sbr_tpu_torch")
    parser.add_argument("--output", default="output_torch",
                        help="output directory (default: output_torch/)")
    parser.add_argument("--sections", default="1,2,3,4", help="comma-separated sections to run")
    parser.add_argument("--fast", action="store_true", help="reduced sweep resolutions for smoke runs")
    parser.add_argument("--f32", action="store_true",
                        help="run every solve in float32 (default float64 parity mode)")
    parser.add_argument(
        "--obs",
        action="store_true",
        help="write run telemetry (events.jsonl + manifest.json) under OUTPUT/obs/ "
        "(SBR_OBS=1 in the environment enables the same thing)",
    )
    parser.add_argument(
        "--paper",
        action="store_true",
        help="also generate the paper-resolution heatmap via tiled checkpoint/resume "
        "(the reference's 'couple hours' 5000x5000 grid; interruptible + resumable)",
    )
    parser.add_argument(
        "--device",
        choices=("cuda", "cpu"),
        default="cuda",
        help="where every solve runs: the CUDA card (default; exits non-zero without "
        "one) or the CPU",
    )
    parser.add_argument("--paper-res", type=int, default=5000, help="paper heatmap resolution")
    parser.add_argument("--paper-tile", type=int, default=500, help="paper heatmap tile size")
    parser.add_argument(
        "--checkpoint-dir",
        default=None,
        help="tile checkpoint dir for --paper (default: OUTPUT/checkpoints/heatmap_large)",
    )
    args = parser.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda but no CUDA device is available "
              "(pass --device cpu to run on the CPU)", file=sys.stderr)
        return 2
    device = torch.device(args.device)
    dtype = torch.float32 if args.f32 else torch.float64

    # Headless backend for the CLI only — library imports leave the
    # user's matplotlib backend alone (plotting docstring).
    backend.use_headless()
    print(f"Figures drawn with {backend.name()}")

    outdir = Path(args.output)
    figdir = outdir / "figures"
    sections = sorted({int(s) for s in args.sections.split(",") if s.strip()})
    runners = {1: run_baseline, 2: run_heterogeneity, 3: run_interest, 4: run_social}
    names = {1: "Baseline", 2: "Heterogeneity", 3: "Interest Rates", 4: "Social Learning"}
    slugs = {1: "baseline", 2: "heterogeneity", 3: "interest_rates", 4: "social_learning"}

    from sbr_tpu_torch import obs

    obs_ctx = (
        obs.run_context(label="figures", root=str(outdir / "obs"))
        if args.obs
        else contextlib.nullcontext()
    )

    t_start = time.time()
    skipped = set()
    # Combined figure document, composed from the live figures as they are
    # generated (the reference's output/replication_figures.pdf is the same
    # document compiled via LaTeX).
    global _PDF_DOC, _PDF_PENDING_HEADER
    # reset collector state at entry: a prior partial --sections run in the
    # same process leaves a stale pending header otherwise
    _PDF_DOC = None
    _PDF_PENDING_HEADER = None
    doc_path = outdir / "replication_figures.pdf"
    doc_tmp = outdir / "replication_figures.pdf.tmp"
    doc = None
    # The combined document is only assembled on FULL-replication runs:
    # PdfPages cannot extend an existing file, so a partial --sections run
    # would otherwise replace a complete document with just its own slice
    # (the .tex document, which CAN reflect everything on disk, remains the
    # partial-run view).
    if set(sections) == set(MANIFEST):
        outdir.mkdir(parents=True, exist_ok=True)
        # write to a temp path and rename on clean completion, so a crash
        # never destroys a previously complete document
        doc = backend.pdf_pages(doc_tmp)
        _pdf_text_page(
            doc,
            ["Replication Figures", "The Social Determinants of Bank Runs", f"({TITLE})"],
            size=22,
        )
        _PDF_DOC = doc
    ok_run = False
    obs_run = None
    try:
        with obs_ctx as obs_run:
            for sec in sections:
                print("=" * 70)
                print(f"SECTION {sec}/4: {names[sec]}")
                print("=" * 70)
                _PDF_PENDING_HEADER = names[sec]
                t0 = time.time()
                with obs.span(f"figures.{slugs[sec]}", fast=args.fast):
                    skipped |= runners[sec](figdir, args.fast, device=device, dtype=dtype) or set()
                print(f"  section time: {time.time() - t0:.1f}s")

            if args.paper:
                print("=" * 70)
                print("PAPER-RESOLUTION HEATMAP (tiled, resumable)")
                print("=" * 70)
                _PDF_PENDING_HEADER = "Paper-resolution heatmap"
                t0 = time.time()
                ckpt = (Path(args.checkpoint_dir) if args.checkpoint_dir
                        else outdir / "checkpoints/heatmap_large")
                with obs.span("figures.paper_heatmap", res=args.paper_res, tile=args.paper_tile):
                    run_paper_heatmap(figdir, ckpt, args.paper_res, args.paper_tile,
                                      device=device)
                print(f"  paper heatmap time: {time.time() - t0:.1f}s")
        ok_run = True
    finally:
        if doc is not None:
            _PDF_DOC = None
            _PDF_PENDING_HEADER = None
            doc.close()
            if ok_run:
                import os as _os

                _os.replace(doc_tmp, doc_path)
            else:
                doc_tmp.unlink(missing_ok=True)

    # The tex document reflects everything present on disk (not just the
    # sections run now), so partial --sections runs extend rather than
    # clobber a previously generated full document.
    not_on_disk = {
        f for sec in MANIFEST for f in MANIFEST[sec] if not (figdir / f).exists()
    }
    tex_sections = [
        s
        for s in MANIFEST
        if set(MANIFEST[s]) - not_on_disk
        or any((figdir / f).exists() for f in _EXTRAS.get(s, []))
    ]
    tex_path = write_tex(outdir, tex_sections, skip=not_on_disk)
    total = time.time() - t_start

    print("=" * 70)
    print("REPLICATION COMPLETE")
    print(f"Total execution time: {total:.1f} seconds")
    expected = [f for sec in sections for f in MANIFEST[sec]]
    if args.paper:
        expected.append(PAPER_HEATMAP)
    print(f"Figures ({len(expected)} expected):")
    missing = []
    for fig in expected:
        if fig in skipped:
            print(f"  - {figdir / fig} (skipped: no-run outcome)")
            continue
        ok = (figdir / fig).exists()
        print(f"  {'✓' if ok else '✗'} {figdir / fig}")
        if not ok:
            missing.append(fig)
    if doc is not None and doc_path.exists():
        print(f"  ✓ {doc_path} (combined figure document)")
    print(f"  ✓ {tex_path}")
    if obs_run is not None:
        print(f"  ✓ {obs_run.run_dir} (run telemetry)")
    return 1 if missing else 0


if __name__ == "__main__":
    sys.exit(main())
