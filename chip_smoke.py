#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``sbr_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``sbr_tpu_torch/csrc``, holds each against its
plain PyTorch version on the card, drives the explicit-agent simulation at
full width (10^6 agents on a ~10^7-edge Erdős–Rényi graph, 200 steps) with
both engines, checks the card against the CPU end to end and the
dense-graph limit against the logistic, and prints one JSON line per phase.
The last line is ``{"ok": true, "device": {...}}``. Any failed check raises
and the script exits non-zero; without a CUDA device it exits non-zero
before printing any result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# Published peaks of one H100 SXM: HBM rate, and the float32 rate outside
# the tensor cores, which stands in for the kernel's integer operations.
HBM_BYTES_PER_S = 3.35e12
VECTOR_OPS_PER_S = 67e12
# Threefry-2x32 (20 rounds × 3 operations + key schedule) plus the hazard
# and the update: an estimate of the operations per agent.
OPS_PER_AGENT = 120

N_FULL = 1_000_000
STEPS_FULL = 200


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(fn, reps: int = 100) -> float:
    """Device time of one call of ``fn``: ``reps`` calls captured into one
    CUDA graph, replayed between two CUDA events after a warm-up, so the
    host's launch overhead does not enter the number."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / reps
    del graph
    torch.cuda.empty_cache()
    return ms


def bound_ms(n: int, dtype: torch.dtype):
    """Least time for the infection step on n agents: the larger of its bytes
    (informed 1 B, t_inf, counts 4 B, beta, deg read; informed' 1 B and
    t_inf' written) over the memory rate and its operations over the
    vector rate."""
    size = torch.finfo(dtype).bits // 8
    bytes_ms = n * (1 + size + 4 + size + size + 1 + size) / HBM_BYTES_PER_S * 1e3
    ops_ms = n * OPS_PER_AGENT / VECTOR_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    info = {
        "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }
    emit("device", **info)
    return info


def phase_build() -> None:
    from sbr_tpu_torch import _build

    t0 = time.perf_counter()
    paths = _build.build_all()
    seconds = time.perf_counter() - t0
    ptxas = {
        name: [ln.strip() for ln in path.with_suffix(".log").read_text().splitlines()
               if "registers" in ln or "spill" in ln]
        for name, path in paths.items()
        if path.with_suffix(".log").exists()
    }
    emit("build", seconds=seconds, kernels=sorted(paths), ptxas=ptxas)


def _kernel_inputs(n: int, np_dtype, seed: int = 0):
    rng = np.random.default_rng(seed)
    informed = rng.random(n) < 0.3
    t_inf = np.where(informed, rng.uniform(-1.0, 5.0, n), np.inf).astype(np_dtype)
    counts = rng.integers(0, 21, n).astype(np.int32)
    deg = rng.integers(0, 21, n)
    counts = np.minimum(counts, deg).astype(np.int32)
    safe_deg = np.maximum(deg, 1).astype(np_dtype)
    betas = rng.lognormal(0.0, 0.5, n).astype(np_dtype)
    dev = torch.device("cuda")
    return tuple(
        torch.from_numpy(a).to(dev) for a in (informed, t_inf, counts, betas, safe_deg)
    )


def phase_kernel_vs_plain() -> list:
    from sbr_tpu_torch.social import fused, rng

    k0, k1 = rng.fold_in(rng.prng_key(0), 17)
    rows = []
    for n in (1_000_003, 10_000_019):
        for np_dtype, dtype in ((np.float32, torch.float32), (np.float64, torch.float64)):
            informed, t_inf, counts, betas, safe_deg = _kernel_inputs(n, np_dtype)
            dt = 0.1
            t_next = float(np_dtype(18) * np_dtype(dt))
            args = (informed, t_inf, counts, betas, safe_deg, 0, k0, k1, t_next, dt)
            got_i, got_t = fused._update_cuda(*args)
            want_i, got_p = fused._update_plain(*args)
            torch.cuda.synchronize()
            mism = int(((got_i != want_i) | (got_t != got_p)).sum())
            both = torch.isfinite(got_t) & torch.isfinite(got_p)
            err_t = float((got_t - got_p)[both].abs().max()) if bool(both.any()) else 0.0
            err_i = float((got_i.to(torch.int32) - want_i.to(torch.int32)).abs().max())
            # lanes whose decision an exp one ulp off could have flipped
            ids = torch.arange(n, dtype=torch.int64, device="cuda")
            x0, x1 = rng._threefry2x32(k0, k1, ids, torch.zeros_like(ids))
            u = rng._uniform_from_bits(x0, x1, dtype)
            p = 1.0 - torch.exp((-betas) * (counts.to(dtype) / safe_deg) * dt)
            ulp = torch.nextafter(p, torch.full_like(p, float("inf"))) - p
            near = int(((u - p).abs() <= 4 * ulp).sum())
            del x0, x1, u, p, ulp, ids
            kernel_ms = time_ms(lambda: fused._update_cuda(*args))
            plain_ms = time_ms(lambda: fused._update_plain(*args))
            b_ms, b_by = bound_ms(n, dtype)
            row = {
                "n": n, "dtype": str(dtype).removeprefix("torch."),
                "mismatches": mism, "max_abs_err": max(err_t, err_i),
                "near_boundary_lanes": near,
                "ms": kernel_ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                "memory": "L2-resident (working set under 50 MB)" if n < 2_000_000
                else "DRAM (working set over 50 MB)",
            }
            emit("kernel_vs_plain", **row)
            if mism:
                raise AssertionError(f"kernel and plain version disagree on {mism} lanes: {row}")
            rows.append(row)
            del informed, t_inf, counts, betas, safe_deg, got_i, got_t, want_i, got_p
            torch.cuda.empty_cache()
    return rows


def _same(a, b) -> bool:
    return bool(torch.equal(a.informed.cpu(), b.informed.cpu())
                and torch.equal(a.t_inf.cpu(), b.t_inf.cpu())
                and torch.equal(a.informed_frac.cpu(), b.informed_frac.cpu())
                and torch.equal(a.withdrawn_frac.cpu(), b.withdrawn_frac.cpu()))


def phase_main_path() -> int:
    import sbr_tpu_torch as st
    from sbr_tpu_torch import _build
    from sbr_tpu_torch.social.fused import KERNEL

    t0 = time.perf_counter()
    src, dst = st.erdos_renyi_edges(N_FULL, 10.0, seed=0)
    graph_s = time.perf_counter() - t0
    cfg = st.AgentSimConfig(n_steps=STEPS_FULL, dt=0.1)
    results = {}
    main_launches = None
    for engine in ("auto", "gather"):
        # the counts are set to 0 just before the main path runs and read
        # just after it: prepare, then one simulation
        _build.reset_launches()
        t0 = time.perf_counter()
        pg = st.prepare_agent_graph(1.0, src, dst, N_FULL, config=cfg, engine=engine,
                                    dtype=np.float32)
        torch.cuda.synchronize()
        prepare_s = time.perf_counter() - t0
        first = st.simulate_agents(prepared=pg, x0=1e-4, config=cfg, seed=0)
        torch.cuda.synchronize()
        launches = _build.LAUNCHES[KERNEL]
        if launches != STEPS_FULL:
            raise AssertionError(f"{engine}: {launches} kernel launches, want {STEPS_FULL}")
        if engine == "auto":
            main_launches = launches
        _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = st.simulate_agents(prepared=pg, x0=1e-4, config=cfg, seed=0)
        torch.cuda.synchronize()
        steady_s = time.perf_counter() - t0
        if _build.LAUNCHES[KERNEL] != STEPS_FULL:
            raise AssertionError(f"{engine}: second run launched {_build.LAUNCHES[KERNEL]}")
        if not _same(first, res):
            raise AssertionError(f"{engine}: two runs of one seed differ")
        g = res.informed_frac.cpu().numpy()
        if not (np.all(np.diff(g) >= 0) and g[-1] > 0.99):
            raise AssertionError(f"{engine}: informed_frac not rising to > 0.99: {g[-5:]}")
        if not (res.informed.shape == (N_FULL,) and bool(torch.isfinite(res.t_inf[res.informed]).all())):
            raise AssertionError(f"{engine}: bad final state")
        results[engine] = res
        emit(
            "main_path", engine_requested=engine, engine=pg.engine, n=N_FULL,
            edges=pg.n_edges, steps=STEPS_FULL, dtype="float32",
            recount_steps=int(res.full_recount_steps.sum()), kernel_launches=launches,
            graph_gen_s=graph_s, prepare_s=prepare_s, simulate_s=steady_s,
            agent_steps_per_s=N_FULL * STEPS_FULL / steady_s,
            final_informed_frac=float(g[-1]),
        )
        del pg
    if not _same(results["auto"], results["gather"]):
        raise AssertionError("auto and gather engines differ at full width")
    emit("main_path_engines_identical", ok=True)
    return main_launches


def phase_profile() -> None:
    """Where the main path's time goes: one steady full-width run of each
    engine under torch.profiler. Device time is the sum of the kernels'
    self times (one stream, so they do not overlap); the profiler's own
    cost inflates the wall time it is compared with."""
    import sbr_tpu_torch as st
    from torch.profiler import ProfilerActivity, profile

    src, dst = st.erdos_renyi_edges(N_FULL, 10.0, seed=0)
    cfg = st.AgentSimConfig(n_steps=STEPS_FULL, dt=0.1)
    for engine in ("incremental", "gather"):
        pg = st.prepare_agent_graph(1.0, src, dst, N_FULL, config=cfg, engine=engine,
                                    dtype=np.float32)
        st.simulate_agents(prepared=pg, x0=1e-4, config=cfg, seed=0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            st.simulate_agents(prepared=pg, x0=1e-4, config=cfg, seed=0)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        # device-side events only: an operator's row repeats its kernels' time
        rows = [
            (e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
        ]
        device_s = sum(r[1] for r in rows) / 1e6
        if device_s <= 0:
            raise AssertionError("the profiler saw no device time")
        rows.sort(key=lambda r: -r[1])
        ours = [r for r in rows if "infection_update_kernel" in r[0]]
        emit(
            "profile", engine=engine, n=N_FULL, steps=STEPS_FULL, wall_s=wall_s,
            device_s=device_s, device_busy_share=device_s / wall_s,
            infection_kernel_ms=sum(r[1] for r in ours) / 1e3,
            infection_kernel_calls=sum(r[2] for r in ours),
            top=[{"kernel": k[:90], "ms": us / 1e3, "calls": c} for k, us, c in rows[:8]],
        )
        del pg


def phase_cpu_vs_card() -> None:
    import sbr_tpu_torch as st

    n = 20_000
    src, dst = st.erdos_renyi_edges(n, 8.0, seed=5)
    cfg = st.AgentSimConfig(n_steps=60, dt=0.1, exit_delay=0.5, reentry_delay=3.0)
    for engine in ("gather", "incremental"):
        for dtype in (np.float64, np.float32):
            out = {}
            for device in ("cpu", "cuda"):
                out[device] = st.simulate_agents(
                    1.0, src, dst, n, x0=0.01, config=cfg, seed=2, engine=engine,
                    dtype=dtype, device=device,
                )
            a, b = out["cpu"], out["cuda"]
            diff = int(((a.informed != b.informed.cpu())
                        | (a.t_inf != b.t_inf.cpu())).sum())
            emit("cpu_vs_card", engine=engine, dtype=np.dtype(dtype).name,
                 differing_agents=diff,
                 final_informed_frac=float(b.informed_frac[-1]))
            if dtype == np.float64 and not _same(a, b):
                raise AssertionError(f"{engine}: float64 CPU and card runs differ")


def phase_physics() -> None:
    import sbr_tpu_torch as st

    n, beta, x0 = 20_000, 1.0, 1e-2
    src, dst = st.erdos_renyi_edges(n, 120.0, seed=3)
    cfg = st.AgentSimConfig(n_steps=300, dt=0.05)
    res = st.simulate_agents(beta, src, dst, n, x0=x0, config=cfg, seed=0,
                             exact_seeds=True, dtype=np.float64)
    t = res.t_grid.cpu().numpy()
    got = res.informed_frac.cpu().numpy()
    x0_eff = got[0]
    want = x0_eff / (x0_eff + (1.0 - x0_eff) * np.exp(-beta * t))
    active = want > 0.01
    rel = float((np.abs(got[active] - want[active]) / want[active]).max())
    final = float(abs(got[-1] - want[-1]))
    emit("physics", max_rel=rel, final_abs=final, limit_rel=0.25, limit_final=0.02)
    if not (rel < 0.25 and final < 0.02):
        raise AssertionError("dense-graph limit misses the logistic")


PHASES = ("kernel", "main", "cpu", "physics")


def main(argv) -> int:
    """Runs every phase of PHASES; ``argv`` may name a subset of them, or
    "profile", to run after the device and build phases (a partial run
    prints no result line)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import sbr_tpu_torch  # noqa: F401  (fails outside the repository)

    wanted = set(argv) or set(PHASES)
    known = set(PHASES) | {"profile"}
    if wanted - known:
        raise SystemExit(f"unknown phases {sorted(wanted - known)}; known: {sorted(known)}")
    info = phase_device()
    phase_build()
    rows = phase_kernel_vs_plain() if "kernel" in wanted else []
    launches = phase_main_path() if "main" in wanted else None
    if "cpu" in wanted:
        phase_cpu_vs_card()
    if "physics" in wanted:
        phase_physics()
    if "profile" in wanted:
        phase_profile()
    if wanted != set(PHASES):
        return 0
    main_row = next(r for r in rows if r["n"] == 1_000_003 and r["dtype"] == "float32")
    kernels = [{
        "name": "infection_update",
        "route": "cuda",
        "source": "sbr_tpu_torch/csrc/infection_update.cu",
        "replaces": "sbr_tpu/social/fused.py:114",
        "replaces_function": "sbr_tpu/social/fused.py::_pallas_update",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "mismatches": sum(r["mismatches"] for r in rows),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,
        "shapes": rows,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["name"], "count": info["count"],
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
