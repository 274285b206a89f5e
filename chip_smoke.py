#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``sbr_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``sbr_tpu_torch/csrc``, holds each against its
plain PyTorch version on the card, and drives both ported paths at full
width: the explicit-agent simulation (10^6 agents on a ~10^7-edge
Erdős–Rényi graph, 200 steps, both engines) and the Bayesian-observer
channel of the information models (2×10^6 agents on a ~2×10^7-edge graph
generated on the card, 100 steps). It checks the card against the CPU end
to end for both paths and for the graph generator, and the dense-graph
limit against the logistic. It then drives the flagship equilibrium solve,
which runs no kernel of its own: the golden scalars of Figure 3, the
Figure-4 u-sweep, the 500×500 Figure-5 heatmap and the 640×640 grid of the
repo's benchmark, in both numerics modes, and a Figure-5 subgrid on the
card against the CPU. Last, the social-learning extension: the Figure-12
fixed point on the card (held to the numpy oracle of tests/oracle.py), and
`close_loop` at the sizes its users run, which feeds the solved withdrawal
window into the agents and so drives both kernels: the Figure-13 closure on
a 200,000-agent host graph, a 10^6-agent graph generated on the card shared
by four members, and the bayes closure on 10^6 agents; then the fixed point
and a closure on the card against the CPU. Then the serving engine, which
runs no kernel of its own either: each bucket's solve captured into a CUDA
graph and held bit for bit to the eager solve (capture, replay and eager
times, kernels a dispatch, busy share, peak memory), the repo benchmark's
serving shape, a cold stream of 4,096 distinct queries, the HTTP endpoint,
and a pool served on the card against the CPU. Then slice 6: the recount
gather kernel against its plain version bit for bit (10^6 and 2×10^6 + 3
agents, 10,092,544 edges, packed, packed with 2-D ids and unpacked; every
branch of its size rule, and both sides of the rule at bit tables up to
8 MB), beside the library gather and torch's copy of the ids, and the
port's ablation script end to end; the heterogeneous-learning model of
Section 2, the interest-rate model of
Section 3 and the (β, u, r) policy sweep at the stretch shape on the card
in both numerics modes (held to the scipy oracle of tests/oracle.py), and
each of them on the card against the CPU. Then slice 8, at bench.py's
shapes: composed scenarios, which run no kernel (the 256×256 grid through
`scenario_grid` with the reducible spec, bit for bit against
`beta_u_grid`, with the policy and the interest modifiers; the 64-bank
contagion ring; one `solve` of each composition family), population
what-ifs, whose members end every step in the infection or belief kernel
(bayes and gossip on 20,000 agents with 16 members, `vary="graph"`, gossip
on 10^6 agents; each query's launches must be members × steps), a
scenario and a population query through the engine and the HTTP
endpoint, and a scenario subgrid, the ring and a population query on the
card against the CPU. Then slice 9: panic rewiring at the bayes path's
shape in both channels (4 epochs of ~2×10^7 regenerated edges; exactly
one launch a step of the channel's kernel; ms an epoch by layer; XLA's
blocked prefix sum timed beside ``torch.cumsum``), a rewire population
query a channel, the tilt tables, tilted sources and rewire runs on the
card against the CPU bit for bit; and the gradient layer at bench.py's
shapes (the 96×96 sensitivity surface, 120 calibration steps, a served
grads stream from captured grads programs) with a sensitivity subgrid on
the card against the CPU. Then slice 10, the tiled, checkpointed sweep,
which launches no kernel: the paper-resolution Figure-5 heatmap (5000×5000
f32 in 500×500 tiles) cold and resumed, with four tiles and a 1000×1000
sub-sweep bit for bit against `beta_u_grid`; a seeded fault drill on its
first four tiles (a retried transient, a NaN result the degrade ladder
repairs, a torn save quarantined on the resume, a port process on the
card preempted by SIGTERM), byte-identical to the fault-free grid;
bench.py's `bench_sweep` shape elastic with the tile cache (cold, warm
with 0 tiles computed, two processes on the card sharing a directory);
the serving engine answering an outage from the tile cache; the tiled
scenario sweep; and a ragged tiled grid on the card against the CPU. It
prints one JSON line per phase, and beside the serving, scenario,
population, rewire, grad and tiled numbers the card's name and power
limit.
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

# The belief step: ~10 floating-point operations an agent (a division, two
# fused multiply-adds, three products and sums, a comparison), against the
# float32 vector rate and the published float64 rate outside the tensor
# cores (34 TFLOP/s).
BELIEF_OPS_PER_AGENT = 10
F64_OPS_PER_S = 34e12

# The bayes channel at the repo's accelerator shape for it (bench.py's
# infomodel bench): 2×10^6 agents, Erdős–Rényi mean degree 10, 100 steps
# of dt 0.05, reentry 3.0, x0 0.01, seed 1, float32.
N_BAYES = 2_000_000
STEPS_BAYES = 100


T_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    elapsed = time.perf_counter() - T_START
    print(json.dumps({"phase": phase, **fields, "elapsed_s": elapsed}), flush=True)


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


def belief_bound_ms(n: int, dtype: torch.dtype):
    """Least time for the belief step on n agents: the larger of its bytes
    (informed 1 B, t_inf, belief, counts 4 B, awareness, deg, θ read;
    informed' 1 B, t_inf', belief' written: 34 B in f32, 62 B in f64) over
    the memory rate and its operations over the rate of its type."""
    size = torch.finfo(dtype).bits // 8
    bytes_ms = n * (6 + 7 * size) / HBM_BYTES_PER_S * 1e3
    rate = VECTOR_OPS_PER_S if dtype == torch.float32 else F64_OPS_PER_S
    ops_ms = n * BELIEF_OPS_PER_AGENT / rate * 1e3
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


def _profiled(run, kernel: str = "") -> dict:
    """One steady call of ``run`` under torch.profiler, after a warm-up
    call. Device time is the sum of the kernels' self times (one stream,
    so they do not overlap); the profiler's own cost inflates the wall time
    it is compared with. ``kernel`` names the kernel whose share is
    reported apart (empty: none)."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
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
    ours = [r for r in rows if kernel and kernel in r[0]]
    return dict(
        wall_s=wall_s, device_s=device_s, device_busy_share=device_s / wall_s,
        device_kernels=sum(r[2] for r in rows),
        kernel=kernel, kernel_ms=sum(r[1] for r in ours) / 1e3,
        kernel_calls=sum(r[2] for r in ours),
        top=[{"kernel": k[:90], "ms": us / 1e3, "calls": c} for k, us, c in rows[:8]],
    )


def phase_profile() -> None:
    """Where each main path's time goes: one steady full-width run of each
    agent engine, and of the bayes channel on a prepared graph."""
    import sbr_tpu_torch as st

    src, dst = st.erdos_renyi_edges(N_FULL, 10.0, seed=0)
    cfg = st.AgentSimConfig(n_steps=STEPS_FULL, dt=0.1)
    for engine in ("incremental", "gather"):
        pg = st.prepare_agent_graph(1.0, src, dst, N_FULL, config=cfg, engine=engine,
                                    dtype=np.float32)
        prof = _profiled(lambda: st.simulate_agents(prepared=pg, x0=1e-4, config=cfg, seed=0),
                         "infection_update_kernel")
        emit("profile", path="agents", engine=engine, n=N_FULL, steps=STEPS_FULL, **prof)
        del pg
    spec = st.InfoModelSpec(channel="bayes")
    graph = st.ErdosRenyiSpec(N_BAYES, 10.0)
    cfg = _bayes_config()
    pg = st.prepare_generated_graph(graph, seed=1, config=cfg, engine="gather")
    prof = _profiled(lambda: st.simulate_info(spec, graph, x0=0.01, config=cfg, seed=1,
                                              prepared=pg), "belief_update_kernel")
    emit("profile", path="bayes", engine="gather", n=N_BAYES, steps=STEPS_BAYES, **prof)
    del pg
    phase_sweeps_profile()


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


def _belief_inputs(n: int, np_dtype, seed: int = 0):
    rng = np.random.default_rng(seed)
    informed = rng.random(n) < 0.1
    t_inf = np.where(informed, rng.uniform(-1.0, 5.0, n), np.inf).astype(np_dtype)
    deg = rng.integers(0, 21, n)
    counts = np.minimum(rng.integers(0, 21, n), deg).astype(np.int32)
    arrays = (informed, t_inf, rng.normal(0.5, 2.0, n).astype(np_dtype), counts,
              rng.uniform(0.5, 3.0, n).astype(np_dtype), np.maximum(deg, 1).astype(np_dtype),
              rng.logistic(3.0, 1.5, n).astype(np_dtype))
    return tuple(torch.from_numpy(a).to("cuda") for a in arrays)


def phase_belief_kernel_vs_plain() -> list:
    import sbr_tpu_torch as st
    from sbr_tpu_torch.social import fused

    rows = []
    for n in (2_000_003, 10_000_019):
        for np_dtype, dtype in ((np.float32, torch.float32), (np.float64, torch.float64)):
            ins = _belief_inputs(n, np_dtype)
            llr0, llr1 = (float(np_dtype(v)) for v in st.InfoModelSpec(channel="bayes").llr)
            args = (*ins, float(np_dtype(18) * np_dtype(0.05)), 0.05, llr0, llr1)
            got = fused._belief_cuda(*args)
            want = fused._belief_plain(*args)
            torch.cuda.synchronize()
            mism = {name: int((g != w).sum()) for name, g, w in
                    zip(("informed", "t_inf", "belief"), got, want)}
            both = torch.isfinite(got[1]) & torch.isfinite(want[1])
            err = max(float((got[2] - want[2]).abs().max()),
                      float((got[1] - want[1])[both].abs().max()) if bool(both.any()) else 0.0)
            crossed = int((got[0] & ~ins[0]).sum())
            del got, want
            kernel_ms = time_ms(lambda: fused._belief_cuda(*args))
            plain_ms = time_ms(lambda: fused._belief_plain(*args))
            b_ms, b_by = belief_bound_ms(n, dtype)
            row = {
                "n": n, "dtype": str(dtype).removeprefix("torch."),
                "mismatches": sum(mism.values()), "mismatches_by_output": mism,
                "max_abs_err": err, "newly_crossed": crossed,
                "ms": kernel_ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                "memory": "DRAM (working set over 50 MB)",
            }
            emit("belief_kernel_vs_plain", **row)
            if row["mismatches"]:
                raise AssertionError(f"belief kernel and plain version disagree: {row}")
            rows.append(row)
            del ins, args
            torch.cuda.empty_cache()
    return rows


def _bayes_config():
    import sbr_tpu_torch as st

    return st.AgentSimConfig(n_steps=STEPS_BAYES, dt=0.05, reentry_delay=3.0)


def phase_bayes_main_path() -> int:
    import sbr_tpu_torch as st
    from sbr_tpu_torch import _build
    from sbr_tpu_torch.social.fused import BELIEF_KERNEL

    spec = st.InfoModelSpec(channel="bayes")
    graph = st.ErdosRenyiSpec(N_BAYES, 10.0)
    cfg = _bayes_config()
    runs, launches = [], []
    for call in range(2):
        # the counts are set to 0 just before the main path runs and read
        # just after it: one simulate_info call, graph generation included
        _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = st.simulate_info(spec, graph, x0=0.01, config=cfg, seed=1)
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
        launches.append(_build.LAUNCHES[BELIEF_KERNEL])
        if launches[-1] != STEPS_BAYES:
            raise AssertionError(f"call {call}: {launches[-1]} belief launches, want {STEPS_BAYES}")
        runs.append((res, call_s))
    (first, first_s), (res, call_s) = runs
    for f in ("informed", "t_inf", "belief", "informed_frac", "withdrawn_frac"):
        if not torch.equal(getattr(first, f), getattr(res, f)):
            raise AssertionError(f"two bayes calls of one seed differ in {f}")
    # the layers apart: the graph build on the card, then the step loop alone
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pg = st.prepare_generated_graph(graph, seed=1, config=cfg, engine="gather")
    torch.cuda.synchronize()
    graph_build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    alone = st.simulate_info(spec, graph, x0=0.01, config=cfg, seed=1, prepared=pg)
    torch.cuda.synchronize()
    simulate_s = time.perf_counter() - t0
    if not torch.equal(alone.belief, res.belief):
        raise AssertionError("the run on a prepared graph differs from the full call")
    g = res.informed_frac.cpu().numpy()
    informed0 = int(round(float(g[0]) * N_BAYES))
    crossed = int(res.informed.sum()) - informed0
    if not (np.all(np.diff(g) >= 0) and crossed > 0):
        raise AssertionError(f"bayes run: informed_frac {g[:3]}..{g[-3:]}, crossed {crossed}")
    if not (res.informed.shape == (N_BAYES,) and bool(torch.isfinite(res.belief).all())
            and bool(torch.isfinite(res.t_inf[res.informed]).all())):
        raise AssertionError("bayes run: bad final state")
    emit(
        "bayes_main_path", n=N_BAYES, edges=pg.n_edges, steps=STEPS_BAYES,
        dtype="float32", kernel_launches=launches, graph_build_s=graph_build_s,
        first_call_s=first_s, call_s=call_s, simulate_s=simulate_s,
        belief_updates_per_s=N_BAYES * STEPS_BAYES / simulate_s,
        belief_updates_per_s_with_build=N_BAYES * STEPS_BAYES / call_s,
        crossed=crossed, final_informed_frac=float(g[-1]),
        final_withdrawn_frac=float(res.withdrawn_frac[-1]),
    )
    return launches[0]


def phase_bayes_cpu_vs_card() -> None:
    import sbr_tpu_torch as st
    from sbr_tpu_torch.infomodels import engine

    n = 20_000
    spec = st.InfoModelSpec(channel="bayes", groups=((0.3, 2.0, 1.0), (0.7, 3.5, 3.0)))
    graph = st.ErdosRenyiSpec(n, 8.0)
    cfg = st.AgentSimConfig(n_steps=60, dt=0.05, reentry_delay=1.0)
    for np_dtype in (np.float32, np.float64):
        cpu_f = [f.numpy() for f in engine._agent_fields(spec, n, 2, 0.9, np_dtype, "cpu")]
        card_f = [f.cpu().numpy() for f in engine._agent_fields(spec, n, 2, 0.9, np_dtype, "cuda")]
        kw = dict(x0=0.01, config=cfg, seed=2, dtype=np_dtype)
        out = {
            dev: st.simulate_info(spec, graph, device=dev,
                                  fields=engine.agent_fields_from_numpy(*cpu_f, dev), **kw)
            for dev in ("cpu", "cuda")
        }
        a, b = out["cpu"], out["cuda"]
        same = {f: bool(torch.equal(getattr(a, f), getattr(b, f).cpu())) for f in
                ("informed", "t_inf", "belief", "informed_frac", "withdrawn_frac")}
        thr_gap = np.abs(cpu_f[1].astype(np.float64) - card_f[1])
        emit("bayes_cpu_vs_card", n=n, steps=cfg.n_steps, dtype=np.dtype(np_dtype).name,
             bitwise=same, crossed=int(b.informed.sum()),
             fields_betas_equal=bool(np.array_equal(cpu_f[0], card_f[0])),
             fields_awareness_equal=bool(np.array_equal(cpu_f[2], card_f[2])),
             fields_thresholds_differing=int((thr_gap > 0).sum()),
             fields_thresholds_max_abs_diff=float(thr_gap.max()))
        if not all(same.values()):
            raise AssertionError(f"{np.dtype(np_dtype).name}: bayes CPU and card runs differ: {same}")


def phase_graphgen_cpu_vs_card() -> None:
    import sbr_tpu_torch as st

    n = 100_000
    for spec in (st.ErdosRenyiSpec(n, 10.0), st.ScaleFreeSpec(n, 10.0),
                 st.StochasticBlockSpec(n, 10.0)):
        out = {dev: st.prepare_generated_graph(spec, seed=5, engine="incremental", device=dev)
               for dev in ("cpu", "cuda")}
        a, b = out["cpu"], out["cuda"]
        names = ("src", "row_ptr", "indeg", "dst2", "out_ptr", "outdeg")
        same = {k: bool(torch.equal(x, y.cpu())) for k, x, y in
                zip(names, (a.src, a.row_ptr, a.indeg, *a.inc), (b.src, b.row_ptr, b.indeg, *b.inc))}
        emit("graphgen_cpu_vs_card", spec=type(spec).__name__, n=n, edges=b.n_edges,
             bitwise=same)
        if not all(same.values()):
            raise AssertionError(f"{type(spec).__name__}: CPU and card graphs differ: {same}")


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


# The flagship equilibrium solve. Its stages are plain PyTorch operations,
# batched over every cell; no kernel of the port runs on this path. The
# golden scalars come from the high-precision oracle (tests/oracle.py).
GOLDEN = {"xi": 10.215436, "tau_bar_in_unc": 7.327538, "tau_bar_out_unc": 10.446095,
          "aw_max": 0.618231}
GOLDEN_BETA3_XI = 3.256394
# The port's float tolerances against the reference (tests/test_torch_*.py),
# to which the card is held against the CPU.
SWEEP_TOL = {torch.float64: 1e-12, torch.float32: 2e-5}
# Back-to-back calls of the sustained measurement (bench.py's protocol).
SUSTAINED_REPS = 8


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _figure5_axes(n: int):
    """The Figure-5 domain: β = 1/amt with amt = linspace(1e-4, 1, n),
    u = linspace(0.001, 1, n) (figures/master.py, bench.py)."""
    return 1.0 / np.linspace(1e-4, 1.0, n), np.linspace(0.001, 1.0, n)


def phase_equilibrium() -> None:
    """The golden scalars on the card at SolverConfig() (n_grid 4096, 90
    iterations, refinement on, float64), in both numerics modes, beside the
    same solves on the CPU."""
    from sbr_tpu_torch.baseline.learning import solve_learning
    from sbr_tpu_torch.baseline.solver import solve_equilibrium_baseline
    from sbr_tpu_torch.models.params import SolverConfig, make_model_params, with_overrides

    for numerics in ("adaptive", "fixed"):
        cfg = SolverConfig(numerics=numerics)
        out = {}
        for name, kw in (("figure3", {}), ("beta3", {"beta": 3.0}), ("u5", {"u": 5.0})):
            m = with_overrides(make_model_params(), **kw)
            out[name] = {}
            for dev in ("cuda", "cpu"):
                ls = solve_learning(m.learning, cfg, device=dev)
                out[name][dev] = solve_equilibrium_baseline(ls, m.economic, cfg)
        r = out["figure3"]["cuda"]
        got = {k: float(getattr(r, k)) for k in GOLDEN}
        err = max(abs(got[k] - v) for k, v in GOLDEN.items())
        beta3_err = abs(float(out["beta3"]["cuda"].xi) - GOLDEN_BETA3_XI)
        u5 = out["u5"]["cuda"]
        gap = max(
            abs(float(getattr(out[n]["cuda"], k)) - float(getattr(out[n]["cpu"], k)))
            for n in ("figure3", "beta3") for k in GOLDEN
        )
        same_status = all(int(out[n]["cuda"].status) == int(out[n]["cpu"].status) for n in out)
        emit("equilibrium", numerics=numerics, n_grid=cfg.n_grid, bisect_iters=cfg.bisect_iters,
             refine_crossings=cfg.refine_crossings, dtype="float64", device=str(r.xi.device),
             **got, max_err_vs_golden=err, beta3_xi=float(out["beta3"]["cuda"].xi),
             beta3_err=beta3_err, u5_status=int(u5.status), u5_xi=float(u5.xi),
             card_vs_cpu_max_abs=gap, card_vs_cpu_status_equal=same_status,
             solve_time_s=r.solve_time, iterations=int(r.health.iterations),
             flags=int(r.health.flags))
        if not (err < 1e-6 and beta3_err < 1e-6 and int(u5.status) == 1
                and np.isnan(float(u5.xi)) and same_status and gap <= SWEEP_TOL[torch.float64]):
            raise AssertionError(f"{numerics}: golden scalars on the card are off")


def _sweep_outputs(res):
    """(status, xi, AW_max, health) of a grid or u-sweep result."""
    if hasattr(res, "collapse_times"):  # u-sweep
        return res.status, res.collapse_times, res.max_withdrawals, res.health
    if hasattr(res, "max_aw"):  # β×u grid
        return res.status, res.xi, res.max_aw, res.health
    return res.status, res.xi, res.aw_max, res.health  # one equilibrium


def _timed(run, cells: int) -> dict:
    """One call of ``run(rep)`` cold, one fenced steady call, then
    SUSTAINED_REPS back-to-back calls whose device-side reductions are
    summed on the card and read once (bench.py's sustained protocol); the
    allocator's peak over all of them."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run(0)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = run(0)
    torch.cuda.synchronize()
    fenced_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fences = []
    for rep in range(1, SUSTAINED_REPS + 1):
        status, xi, aw, _ = _sweep_outputs(run(rep))
        fences.append(status.sum() + torch.nansum(xi) + torch.nansum(aw))
    total = float(torch.stack(fences).sum())
    sustained_s = (time.perf_counter() - t0) / SUSTAINED_REPS
    if not np.isfinite(total):
        raise AssertionError(f"sustained fence reduced to {total}")
    return res, dict(
        cells=cells, cold_s=cold_s, fenced_s=fenced_s, cells_per_s=cells / fenced_s,
        sustained_s=sustained_s, cells_per_s_sustained=cells / sustained_s,
        sustained_reps=SUSTAINED_REPS, peak_bytes=torch.cuda.max_memory_allocated(),
    )


def _sweep_shapes():
    """The four shapes of the flagship path, each at the size its users
    run: (name, dtype, cells, make_run(numerics) -> run(rep))."""
    from sbr_tpu_torch.baseline.learning import solve_learning
    from sbr_tpu_torch.baseline.solver import solve_equilibrium_baseline
    from sbr_tpu_torch.models.params import SolverConfig, make_model_params, with_overrides
    from sbr_tpu_torch.sweeps.baseline_sweeps import beta_u_grid, u_sweep

    base = make_model_params()

    def figure3(numerics):
        cfg = SolverConfig(numerics=numerics)

        def run(rep):
            m = with_overrides(base, u=0.1 + rep * 1e-6)
            return solve_equilibrium_baseline(solve_learning(m.learning, cfg), m.economic, cfg)
        return run

    def figure4(numerics):
        cfg = SolverConfig(numerics=numerics)
        ls = solve_learning(base.learning, cfg)
        return lambda rep: u_sweep(ls, np.linspace(0.001, 0.2, 5000) + rep * 1e-6,
                                   base.economic, cfg)

    def grid(n, dtype, **kw):
        betas, us = _figure5_axes(n)

        def make(numerics):
            cfg = SolverConfig(refine_crossings=False, numerics=numerics, **kw)
            return lambda rep: beta_u_grid(betas, us + rep * 1e-6, base, cfg, dtype=dtype)
        return make

    return [
        ("figure3_scalar", torch.float64, 1, figure3),
        ("figure4_u_sweep", torch.float64, 5000, figure4),
        ("figure5_grid", torch.float32, 500 * 500, grid(500, torch.float32)),
        ("figure5_grid", torch.float64, 500 * 500, grid(500, torch.float64)),
        ("bench_grid", torch.float32, 640 * 640,
         grid(640, torch.float32, n_grid=1024, bisect_iters=60)),
    ]


def phase_sweeps_main_path() -> None:
    """Each shape of the flagship path in both numerics modes: cells/s of
    one fenced call and sustained, status counts, fixed against adaptive,
    mean adaptive iterations, peak memory. The path launches no kernel of
    the port; the counts, set to 0 before it and read after, say so."""
    from sbr_tpu_torch import _build
    from sbr_tpu_torch.social.fused import BELIEF_KERNEL, KERNEL
    from sbr_tpu_torch.utils.status import status_counts

    _build.reset_launches()
    for name, dtype, cells, make_run in _sweep_shapes():
        out = {}
        for numerics in ("adaptive", "fixed"):
            res, timing = _timed(make_run(numerics), cells)
            out[numerics] = res
            status, xi, aw, health = _sweep_outputs(res)
            emit("sweeps_main_path", shape=name, dtype=_dtype_name(dtype), numerics=numerics,
                 **timing, status_counts=status_counts(status),
                 mean_iterations=float(health.iterations.double().mean()),
                 max_iterations=int(health.iterations.max()),
                 finite_xi=int(torch.isfinite(xi).sum()))
            run_cells = status == 0
            finite_on_run = bool(torch.isfinite(xi[run_cells]).all()) and bool(
                torch.isfinite(aw[run_cells]).all())
            if not finite_on_run or bool(torch.isfinite(xi[~run_cells]).any()):
                raise AssertionError(f"{name}: ξ/AW_max finite exactly on RUN cells fails")
        sa, sf = out["adaptive"].status, out["fixed"].status
        differ = torch.nonzero(sa != sf)
        xa, xf = _sweep_outputs(out["adaptive"])[1], _sweep_outputs(out["fixed"])[1]
        both = torch.isfinite(xa) & torch.isfinite(xf)
        xi_gap = float((xa - xf)[both].abs().max()) if bool(both.any()) else 0.0
        # each differing cell with both statuses and residuals |AW−κ|, which
        # says how near the root tolerance the deciding quantity lies
        listed = [
            {"cell": c, "adaptive": int(sa[tuple(c)]), "fixed": int(sf[tuple(c)]),
             "residual_adaptive": float(out["adaptive"].health.residual[tuple(c)]),
             "residual_fixed": float(out["fixed"].health.residual[tuple(c)])}
            for c in differ[:20].tolist()
        ]
        emit("sweeps_fixed_vs_adaptive", shape=name, dtype=_dtype_name(dtype),
             status_equal=not len(differ), differing_cells=len(differ), differing=listed,
             xi_max_abs=xi_gap)
        if dtype == torch.float64 and len(differ):
            raise AssertionError(f"{name}: fixed and adaptive statuses differ on {len(differ)} cells")
    launches = {k: _build.LAUNCHES[k] for k in (KERNEL, BELIEF_KERNEL)}
    emit("sweeps_kernel_launches", launches=launches)
    if any(launches.values()):
        raise AssertionError(f"the flagship path launched a kernel: {launches}")


def phase_sweeps_cpu_vs_card() -> None:
    """A 64×64 subgrid of Figure 5 at n_grid 1024 on the card and on the
    CPU, float64 and float32, both numerics modes. float64: statuses and
    flags equal, floats within the port's tolerance. float32: differing
    statuses are counted and listed with their residuals |AW−κ|; more than
    0.1% of the cells fails."""
    from sbr_tpu_torch.models.params import SolverConfig, make_model_params
    from sbr_tpu_torch.sweeps.baseline_sweeps import beta_u_grid

    betas, us = _figure5_axes(500)
    idx = np.linspace(0, 499, 64).astype(int)
    betas, us = betas[idx], us[idx]
    for dtype in (torch.float64, torch.float32):
        for numerics in ("adaptive", "fixed"):
            cfg = SolverConfig(n_grid=1024, refine_crossings=False, numerics=numerics)
            res = {dev: beta_u_grid(betas, us, make_model_params(), cfg, dtype=dtype, device=dev)
                   for dev in ("cpu", "cuda")}
            a, b = res["cpu"], res["cuda"]
            bs = b.status.cpu()
            differ = torch.nonzero(a.status != bs).tolist()
            flags_differ = int((a.health.flags != b.health.flags.cpu()).sum())
            gaps = {}
            for f in ("xi", "max_aw"):
                x, y = getattr(a, f), getattr(b, f).cpu()
                both = torch.isfinite(x) & torch.isfinite(y)
                gaps[f] = float((x - y)[both].abs().max()) if bool(both.any()) else 0.0
            listed = [
                {"cell": c, "beta": float(betas[c[0]]), "u": float(us[c[1]]),
                 "cpu": int(a.status[c[0], c[1]]), "card": int(bs[c[0], c[1]]),
                 "residual_cpu": float(a.health.residual[c[0], c[1]]),
                 "residual_card": float(b.health.residual[c[0], c[1]])}
                for c in differ[:20]
            ]
            tol = SWEEP_TOL[dtype]
            emit("sweeps_cpu_vs_card", shape="figure5_subgrid_64x64", n_grid=1024,
                 dtype=_dtype_name(dtype), numerics=numerics, differing_status=len(differ),
                 differing=listed, differing_flags=flags_differ, max_abs=gaps, tolerance=tol,
                 iterations_equal_share=float((a.health.iterations == b.health.iterations.cpu())
                                              .double().mean()))
            if dtype == torch.float64 and (differ or flags_differ):
                raise AssertionError(f"float64 {numerics}: CPU and card statuses differ")
            if len(differ) > 0.001 * a.status.numel() or max(gaps.values()) > tol:
                raise AssertionError(f"{_dtype_name(dtype)} {numerics}: CPU and card disagree: {gaps}")


def _stage_split(betas, us, cfg, dtype) -> dict:
    """Device-timeline milliseconds of each stage of one β×u grid, between
    CUDA events: Stage 1 + hazard per β, buffer crossings, ξ root-find,
    classification with AW_max. The stages are `solve_equilibrium_core`'s,
    called one by one."""
    from sbr_tpu_torch.baseline import solver as S
    from sbr_tpu_torch.baseline.learning import solve_learning
    from sbr_tpu_torch.models.params import make_model_params
    from sbr_tpu_torch.sweeps.baseline_sweeps import _RowLearning

    base = make_model_params()
    e = base.economic
    dev = torch.device("cuda")
    b = torch.as_tensor(betas, dtype=dtype, device=dev).unsqueeze(-1)
    u = torch.as_tensor(us, dtype=dtype, device=dev)
    t0, t1, x0 = (torch.tensor(v, dtype=dtype, device=dev)
                  for v in (*base.learning.tspan, base.learning.x0))
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    torch.cuda.synchronize()
    ev[0].record()
    ls = solve_learning(_RowLearning(b, (t0, t1), x0), cfg, dtype=dtype, device=dev)
    tau_grid, hr, _, _ = S._hazard_parts(e.p, e.lam, ls, e.eta, cfg)
    ev[1].record()
    t_in, t_out, _ = S.optimal_buffer(u, tau_grid, hr, t1, with_health=True, adaptive=cfg.adaptive)
    ev[2].record()
    xi_c, err, root_ok, inc, _ = S.compute_xi(t_in, t_out, ls, e.kappa, cfg, with_health=True)
    ev[3].record()
    run, _, _, _ = S.classify_cell(t_in == t_out, root_ok, inc, err, dtype)
    xi = torch.where(run, xi_c, float("nan"))
    S._aw_max_exact(xi, t_in, t_out, torch.tensor(e.eta, dtype=dtype, device=dev), ls)
    ev[4].record()
    torch.cuda.synchronize()
    names = ("stage1_and_hazard_ms", "buffer_crossings_ms", "xi_rootfind_ms", "classification_ms")
    return {k: ev[i].elapsed_time(ev[i + 1]) for i, k in enumerate(names)}


def phase_sweeps_profile() -> None:
    """Where the flagship grid's time goes: the stage split and a profiler
    trace of one steady call, at the Figure-5 tile and at the benchmark's
    shape, both numerics modes."""
    from sbr_tpu_torch.core import rootfind
    from sbr_tpu_torch.models.params import SolverConfig, make_model_params
    from sbr_tpu_torch.sweeps.baseline_sweeps import beta_u_grid

    # the host checks of Chandrupatla's loop: the adaptive Figure-5 tile with
    # a check every iteration, every 4th and never, in turns (the results
    # are the same, tests/test_torch_core.py)
    betas, us = _figure5_axes(500)
    cfg = SolverConfig(refine_crossings=False, numerics="adaptive")
    chosen = rootfind.CHECK_EVERY
    costs = {}
    try:
        for every in (1, 4, 10**6, 4, 1):
            rootfind.CHECK_EVERY = every
            _, timing = _timed(lambda rep: beta_u_grid(betas, us + rep * 1e-6, make_model_params(),
                                                       cfg, dtype=torch.float32), 500 * 500)
            costs.setdefault(str(every), []).append(timing["fenced_s"])
    finally:
        rootfind.CHECK_EVERY = chosen
    emit("profile", path="chandrupatla_host_checks", n=500, dtype="float32",
         check_every_chosen=chosen, fenced_s_by_check_every=costs)

    for n, dtype, kw in ((500, torch.float32, {}), (500, torch.float64, {}),
                         (640, torch.float32, {"n_grid": 1024, "bisect_iters": 60})):
        betas, us = _figure5_axes(n)
        for numerics in ("adaptive", "fixed"):
            cfg = SolverConfig(refine_crossings=False, numerics=numerics, **kw)
            _stage_split(betas, us, cfg, dtype)  # warm-up
            split = _stage_split(betas, us, cfg, dtype)
            prof = _profiled(lambda: beta_u_grid(betas, us, make_model_params(), cfg, dtype=dtype))
            emit("profile", path="beta_u_grid", n=n, n_grid=cfg.n_grid, dtype=_dtype_name(dtype),
                 numerics=numerics, **split, **prof)


# The social-learning extension (slice 4): the Figure-12 fixed point and the
# Figure-13 closure at the paper's calibration (scripts/4_social_learning.jl
# :36-56, figures/master.py:275-331). The fixed point runs no kernel; the
# closures end every step in the infection kernel (gossip) or the belief
# kernel (bayes).
FIG12 = dict(beta=0.9, eta_bar=30.0, u=0.5, p=0.99, kappa=0.25, lam=0.25)
FIG12_GRID = 4096
PROFILE_ITERS = 10
# test_social's envelope against the oracle, and its closure bounds
ORACLE_XI_SHARE, ORACLE_AW_SUP = 2e-3, 5e-3
FIG13 = dict(n_agents=200_000, avg_degree=60.0, dt=0.05, t_max=16.0, g0=0.02)
FIG13_BOUNDS = {"err_aw_rms": 0.03, "err_g_rms": 0.03, "err_aw_sup": 0.06}
GEN_LOOP = dict(n_agents=1_000_000, avg_degree=20.0, dt=0.05, t_max=16.0, g0=0.02)
GEN_SEEDS = (0, 1, 2, 3)
BAYES_LOOP = dict(n_agents=1_000_000, avg_degree=15.0, dt=0.05, t_max=8.0, g0=0.2)
BAYES_LOOP_G_RMS = 0.06
# the port's float tolerance of the fixed point against the reference
# (tests/test_torch_social.py), to which the card is held against the CPU
FP_TOL = 1e-10


def _social_oracle():
    """tests/oracle.py's numpy/scipy mirror of the damped fixed point."""
    sys.path.insert(0, (__file__.rpartition("/")[0] or ".") + "/tests")
    from oracle import solve_social_oracle

    return solve_social_oracle


class _CallTimes:
    """Seconds spent in each (module, name) function while the block runs,
    fenced on the card before and after each call: ``with _CallTimes(...)
    as spent`` gives {name: [s, ...]}."""

    def __init__(self, *targets):
        self.saved = [(mod, name, getattr(mod, name)) for mod, name in targets]
        self.spent = {name: [] for _, name in targets}

    def _timed(self, fn, name):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.spent[name].append(time.perf_counter() - t0)
            return out
        return wrapper

    def __enter__(self) -> dict:
        for mod, name, fn in self.saved:
            setattr(mod, name, self._timed(fn, name))
        return self.spent

    def __exit__(self, *exc) -> None:
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def phase_social() -> dict:
    """The Figure-12 fixed point on the card in float64 and float32, both
    numerics: ξ, iterations, the cold and one fenced call, ms per outer
    iteration, and the launches and busy share of its first PROFILE_ITERS
    iterations, profiled; ξ and AW held to the oracle. Then the no-run march (u 50). Returns the
    float64 fixed-numerics fixed point for the closures."""
    import sbr_tpu_torch as st
    from sbr_tpu_torch import _build
    from sbr_tpu_torch.social.fused import BELIEF_KERNEL, KERNEL

    m = st.make_model_params(**FIG12)
    eta = m.economic.eta
    ora = _social_oracle()(beta=0.9, x0=1e-4, u=0.5, p=0.99, kappa=0.25, lam=0.25, eta=eta,
                           tol=1e-4, max_iter=500)
    if not (ora.bankrun and ora.converged):
        raise AssertionError("the social oracle found no converged run")
    out = {}
    _build.reset_launches()
    for dtype in (torch.float64, torch.float32):
        for numerics in ("fixed", "adaptive"):
            cfg = st.SolverConfig(n_grid=FIG12_GRID, numerics=numerics)

            def run():
                return st.solve_equilibrium_social(m, cfg, tol=1e-4, max_iter=500, dtype=dtype)

            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            cold_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            fp = run()
            fenced_s = time.perf_counter() - t0
            it = int(fp.iterations)
            # The profiler's own analysis costs ~70 µs an event (~40 s for
            # the 5×10^5 events of one whole call), so each dtype profiles
            # its first PROFILE_ITERS iterations.
            prof = _profiled(lambda: st.solve_equilibrium_social(
                m, cfg, tol=1e-4, max_iter=PROFILE_ITERS, dtype=dtype))
            per_it = prof["device_kernels"] / PROFILE_ITERS
            launches = {"launches_per_iteration": per_it,
                        "launches_per_call_scaled": per_it * it,
                        "profiled_iterations": PROFILE_ITERS}
            xi_err = abs(float(fp.xi) - ora.xi)
            aw = np.interp(ora.grid, fp.grid.double().cpu().numpy(), fp.aw.double().cpu().numpy())
            aw_sup = float(np.max(np.abs(aw - ora.aw)))
            emit("social", dtype=_dtype_name(dtype), numerics=numerics, n_grid=FIG12_GRID,
                 xi=float(fp.xi), oracle_xi=ora.xi, xi_err=xi_err, xi_limit=ORACLE_XI_SHARE * eta,
                 aw_sup_vs_oracle=aw_sup, aw_limit=ORACLE_AW_SUP, iterations=it,
                 converged=bool(fp.converged), aborted=bool(fp.aborted), error=float(fp.error),
                 flags=int(fp.health.flags), cold_s=cold_s, fenced_ms=fenced_s * 1e3,
                 solve_time_s=fp.solve_time, ms_per_iteration=fenced_s * 1e3 / it, **launches,
                 profiled_wall_s=prof["wall_s"], device_s=prof["device_s"],
                 device_busy_share=prof["device_busy_share"], top=prof["top"][:4])
            if not (bool(fp.converged) and bool(fp.equilibrium.bankrun)
                    and xi_err < ORACLE_XI_SHARE * eta and aw_sup < ORACLE_AW_SUP):
                raise AssertionError(f"{_dtype_name(dtype)} {numerics}: the fixed point misses "
                                     f"the oracle: ξ {float(fp.xi)} vs {ora.xi}, AW sup {aw_sup}")
            out[(_dtype_name(dtype), numerics)] = fp
    no_run = st.with_overrides(m, u=50.0)
    fp = st.solve_equilibrium_social(no_run, st.SolverConfig(n_grid=1024), max_iter=600)
    march = int(fp.iterations) * eta / 500.0
    emit("social_no_run", n_grid=1024, xi=float(fp.xi), iterations=int(fp.iterations),
         march_xi=march, converged=bool(fp.converged), bankrun=bool(fp.equilibrium.bankrun),
         aw_spread=float(fp.aw.max() - fp.aw.min()), flags=int(fp.health.flags),
         solve_time_s=fp.solve_time)
    if not (bool(fp.converged) and not bool(fp.equilibrium.bankrun)
            and abs(float(fp.xi) - march) <= 1e-9 * march):
        raise AssertionError("the no-run march did not converge flat at iterations·η/500")
    launches = {k: _build.LAUNCHES[k] for k in (KERNEL, BELIEF_KERNEL)}
    if any(launches.values()):
        raise AssertionError(f"the fixed point launched a kernel: {launches}")
    return out[("float64", "fixed")]


def _loop_row(comp, members: int, kernel: str, launches: int, prepare_s: float,
              simulate_s: float, **extra) -> dict:
    """The closure's JSON row: the window, the errors, the kernel's launches
    against steps × members, and the step loop's time apart from the graph's
    preparation."""
    steps = len(comp.t)
    return dict(
        n=comp.n_agents, members=members, steps=steps, exit_delay=comp.exit_delay,
        reentry_delay=comp.reentry_delay, err_aw_sup=comp.err_aw_sup, err_aw_rms=comp.err_aw_rms,
        err_g_rms=comp.err_g_rms, kernel=kernel, kernel_launches=launches,
        expected_launches=steps * members, prepare_s=prepare_s, simulate_s=simulate_s,
        agent_steps_per_s=comp.n_agents * steps * members / simulate_s,
        final_g=float(comp.g_sim[-1]), max_aw=float(comp.aw_sim.max()), **extra,
    )


def _check_loop(name: str, row: dict, bounds: dict) -> None:
    emit("closure", path=name, **row)
    if row["kernel_launches"] != row["expected_launches"]:
        raise AssertionError(f"{name}: {row['kernel_launches']} launches, want "
                             f"{row['expected_launches']} (steps × members)")
    for k, limit in bounds.items():
        if not row[k] < limit:
            raise AssertionError(f"{name}: {k} = {row[k]} not under {limit}")


def phase_closure(fp=None) -> dict:
    """`close_loop` at its users' sizes from the Figure-12 fixed point:
    the Figure-13 closure (host graph), a graph generated on the card and
    shared by four members, and the bayes closure from its own mean-field
    fixed point. Each kernel's launches, set to 0 before a closure and
    read after it, must equal its steps × members. Returns the launches by
    kernel."""
    import sbr_tpu_torch as st
    from sbr_tpu_torch import _build
    from sbr_tpu_torch.infomodels import engine
    from sbr_tpu_torch.social import agents, closure, graphgen
    from sbr_tpu_torch.social.fused import BELIEF_KERNEL, KERNEL

    m = st.make_model_params(**FIG12)
    if fp is None:
        fp = st.solve_equilibrium_social(m, st.SolverConfig(n_grid=FIG12_GRID), max_iter=500)
    totals = {KERNEL: 0, BELIEF_KERNEL: 0}

    # Figure 13 as the paper draws it: host Erdős–Rényi, one member; the
    # host-graph simulate_agents prepares its graph inside
    _build.reset_launches()
    with _CallTimes((closure, "erdos_renyi_edges"), (closure, "simulate_agents"),
                     (agents, "prepare_agent_graph")) as spent:
        t0 = time.perf_counter()
        comp = st.close_loop(m, fp=fp, **FIG13)
        call_s = time.perf_counter() - t0
    launches = _build.LAUNCHES[KERNEL]
    totals[KERNEL] += launches
    prepare_s = sum(spent["prepare_agent_graph"])
    _check_loop("figure13", _loop_row(
        comp, 1, KERNEL, launches, prepare_s, sum(spent["simulate_agents"]) - prepare_s,
        graph="host Erdos-Renyi", avg_degree=FIG13["avg_degree"],
        graph_gen_s=sum(spent["erdos_renyi_edges"]), call_s=call_s,
    ), FIG13_BOUNDS)

    # the graph generated on the card once, shared by four members
    _build.reset_launches()
    graph = st.ErdosRenyiSpec(GEN_LOOP["n_agents"], GEN_LOOP["avg_degree"])
    with _CallTimes((graphgen, "prepare_generated_graph"), (closure, "simulate_agents")) as spent:
        t0 = time.perf_counter()
        comp = st.close_loop(m, fp=fp, graph=graph, seeds=list(GEN_SEEDS), **GEN_LOOP)
        call_s = time.perf_counter() - t0
    launches = _build.LAUNCHES[KERNEL]
    totals[KERNEL] += launches
    builds = len(spent["prepare_generated_graph"])
    _check_loop("generated_graph_seeds", _loop_row(
        comp, len(GEN_SEEDS), KERNEL, launches, sum(spent["prepare_generated_graph"]),
        sum(spent["simulate_agents"]), graph="ErdosRenyiSpec on the card",
        avg_degree=GEN_LOOP["avg_degree"], graph_builds=builds, call_s=call_s,
        member_aw_spread=float(np.ptp(comp.aw_seeds, axis=0).max()),
    ), {})
    if builds != 1:
        raise AssertionError(f"seeds=: the graph was built {builds} times, want 1")

    # the bayes closure against its own mean-field fixed point
    spec = st.InfoModelSpec(channel="bayes")
    t0 = time.perf_counter()
    bfp = st.solve_fixed_point_info(spec, m, max_iter=500)
    fp_s = time.perf_counter() - t0
    _build.reset_launches()
    with _CallTimes((engine, "prepare_generated_graph"), (engine, "simulate_info")) as spent:
        t0 = time.perf_counter()
        comp = st.close_loop(m, fp=bfp, infomodel=spec, **BAYES_LOOP)
        call_s = time.perf_counter() - t0
    launches = _build.LAUNCHES[BELIEF_KERNEL]
    totals[BELIEF_KERNEL] += launches
    prepare_s = sum(spent["prepare_generated_graph"])
    _check_loop("bayes", _loop_row(
        comp, 1, BELIEF_KERNEL, launches, prepare_s, sum(spent["simulate_info"]) - prepare_s,
        graph="ErdosRenyiSpec on the card", avg_degree=BAYES_LOOP["avg_degree"], call_s=call_s,
        fixed_point_s=fp_s, fixed_point_iterations=int(bfp.iterations),
        fixed_point_xi=float(bfp.xi),
    ), {"err_g_rms": BAYES_LOOP_G_RMS})
    return totals


def phase_social_cpu_vs_card() -> None:
    """The fixed point at n_grid 1024 in float64 on the card and the CPU,
    both numerics: iterations, flags and statuses equal, floats within the
    port's tolerance. Then a 20,000-agent gossip closure from one fixed
    point on both: the window equal; its float32 curves compared."""
    import sbr_tpu_torch as st

    m = st.make_model_params(**FIG12)
    fps = {}
    for numerics in ("fixed", "adaptive"):
        cfg = st.SolverConfig(n_grid=1024, numerics=numerics)
        out = {dev: st.solve_equilibrium_social(m, cfg, max_iter=500, device=dev)
               for dev in ("cpu", "cuda")}
        a, b = out["cpu"], out["cuda"]
        ints = {k: [int(x), int(y.cpu())] for k, x, y in (
            ("iterations", a.iterations, b.iterations), ("converged", a.converged, b.converged),
            ("aborted", a.aborted, b.aborted), ("status", a.equilibrium.status, b.equilibrium.status),
            ("flags", a.health.flags, b.health.flags),
            ("health_iterations", a.health.iterations, b.health.iterations))}
        gaps = {k: float((x - y.cpu()).abs().max()) for k, x, y in (
            ("xi", a.xi, b.xi), ("aw", a.aw, b.aw), ("g", a.learning.cdf, b.learning.cdf))}
        emit("social_cpu_vs_card", numerics=numerics, n_grid=1024, dtype="float64",
             discrete=ints, max_abs=gaps, tolerance=FP_TOL)
        differ = [k for k, (x, y) in ints.items()
                  if x != y and not (k == "health_iterations" and numerics == "adaptive")]
        if differ or max(gaps.values()) > FP_TOL:
            raise AssertionError(f"{numerics}: the fixed point on the card and the CPU differ: "
                                 f"{ints} {gaps}")
        fps[numerics] = a
    kw = dict(fp=fps["fixed"], n_agents=20_000, avg_degree=15.0, dt=0.1, t_max=12.0, n_reps=2)
    out = {dev: st.close_loop(m, device=dev, **kw) for dev in ("cpu", "cuda")}
    a, b = out["cpu"], out["cuda"]
    emit("social_cpu_vs_card", path="close_loop", n=20_000, members=2, steps=len(a.t),
         dtype="float32", window_equal=(a.exit_delay, a.reentry_delay) == (b.exit_delay, b.reentry_delay),
         aw_sim_identical=bool(np.array_equal(a.aw_sim, b.aw_sim)),
         g_sim_identical=bool(np.array_equal(a.g_sim, b.g_sim)),
         aw_sim_max_abs=float(np.abs(a.aw_sim - b.aw_sim).max()),
         g_sim_max_abs=float(np.abs(a.g_sim - b.g_sim).max()),
         err_aw_rms=[a.err_aw_rms, b.err_aw_rms])
    if (a.exit_delay, a.reentry_delay) != (b.exit_delay, b.reentry_delay):
        raise AssertionError("one fixed point gave two windows")

# ---------------------------------------------------------------------------
# Slice 5: the serving engine
# ---------------------------------------------------------------------------

SERVE_BUCKETS = (1, 8, 64, 512)
SERVE_REPLAYS = 20
SERVE_EAGER_REPS = 5


def _serve_cols(seed: int, n: int, np_dtype):
    from sbr_tpu_torch.serve.engine import _query_columns
    from sbr_tpu_torch.serve.loadgen import build_pool

    pool = build_pool(seed, n)
    return pool, _query_columns(pool, np_dtype)


def _eager_outputs(cols, cfg, dtype) -> torch.Tensor:
    """The port's own `solve_param_cell` on the card, eagerly (with its
    host checks), stacked as the served program stacks its six outputs."""
    from sbr_tpu_torch.sweeps.baseline_sweeps import solve_param_cell

    xi, tau_in, aw_max, status, health = solve_param_cell(
        *torch.from_numpy(cols).to("cuda"), cfg, dtype, "cuda")
    return torch.stack([xi, tau_in, aw_max, status.to(dtype), health.flags.to(dtype),
                        health.residual])


def _bits_equal(a, b) -> bool:
    """Equal bit for bit, NaNs by position (a NaN's payload may change
    between a device and a Python float)."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    nan = np.isnan(a)
    return bool(np.array_equal(nan, np.isnan(b)) and a[~nan].tobytes() == b[~nan].tobytes())


def _kernel_profile(run) -> dict:
    """Kernels and device time of one call of ``run`` (after a warm-up)
    from torch.profiler: the count of device kernels, their summed time
    and its share of the call's wall time."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    device_s = sum(e.self_device_time_total for e in rows) / 1e6
    return {"kernels": sum(e.count for e in rows), "device_ms": device_s * 1e3,
            "wall_ms": wall_s * 1e3, "busy_share": device_s / wall_s}


def _serve_bucket_rows(card: str) -> list:
    """Per-bucket dispatch at the engine default (n_grid 4096, 90
    iterations, refinement off) in f64/f32 × fixed/adaptive: the capture,
    20 dispatches (median), the same bucket run eagerly, kernels a
    dispatch, the device-busy share, peak memory; every replay bitwise
    equal to the eager `solve_param_cell`."""
    from sbr_tpu_torch.models.params import SolverConfig
    from sbr_tpu_torch.serve import Engine, ServeConfig

    rows = []
    for numerics in ("fixed", "adaptive"):
        for dtype in (torch.float64, torch.float32):
            cfg = SolverConfig(refine_crossings=False, numerics=numerics)
            np_dtype = np.dtype(_dtype_name(dtype))
            engine = Engine(config=cfg, dtype=dtype, serve=ServeConfig(buckets=SERVE_BUCKETS),
                            device="cuda")
            try:
                for bucket in SERVE_BUCKETS:
                    pool, cols = _serve_cols(bucket, bucket, np_dtype)
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    t0 = time.perf_counter()
                    program = engine._program(bucket, cols)
                    capture_s = time.perf_counter() - t0
                    replay_s, replay_dev_ms = [], []
                    out = None
                    for _ in range(SERVE_REPLAYS):
                        t0 = time.perf_counter()
                        out = engine._dispatch(pool)
                        replay_s.append(time.perf_counter() - t0)
                    # the replay alone, between CUDA events
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    for _ in range(5):
                        start.record()
                        program.graph.replay()
                        end.record()
                        end.synchronize()
                        replay_dev_ms.append(start.elapsed_time(end))
                    served = program(cols)
                    peak = torch.cuda.max_memory_allocated()
                    eager_s = []
                    for _ in range(SERVE_EAGER_REPS):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        eager = _eager_outputs(cols, cfg, dtype).cpu().numpy()
                        eager_s.append(time.perf_counter() - t0)
                    if not _bits_equal(served, eager):
                        raise AssertionError(
                            f"serve {numerics} {dtype} bucket {bucket}: replay differs from "
                            "the eager solve_param_cell")
                    if [r["status"] for r in out] != [int(v) for v in eager[3]]:
                        raise AssertionError("served records differ from the eager statuses")
                    eager_prof = _kernel_profile(lambda: _eager_outputs(cols, cfg, dtype).cpu())
                    replay_prof = _kernel_profile(lambda: program(cols))
                    dispatch_ms = float(np.median(replay_s)) * 1e3
                    dev_ms = float(np.median(replay_dev_ms))
                    row = dict(
                        numerics=numerics, dtype=_dtype_name(dtype), bucket=bucket,
                        n_grid=cfg.n_grid, bisect_iters=cfg.bisect_iters,
                        capture_s=capture_s, dispatch_ms_median=dispatch_ms,
                        dispatch_ms_min=min(replay_s) * 1e3, replay_device_ms=dev_ms,
                        replay_busy_share=dev_ms / dispatch_ms,
                        eager_ms_median=float(np.median(eager_s)) * 1e3,
                        eager_over_replay=float(np.median(eager_s)) * 1e3 / dispatch_ms,
                        eager_kernels=eager_prof["kernels"],
                        eager_busy_share=eager_prof["busy_share"],
                        replay_profiled_kernels=replay_prof["kernels"],
                        replay_profiled_busy_share=replay_prof["busy_share"],
                        peak_bytes=peak, bitwise_equal_to_eager=True,
                        statuses=np.bincount(eager[3].astype(int), minlength=4).tolist(),
                        card=card,
                    )
                    emit("serve_bucket", **row)
                    rows.append(row)
                counters = engine.graphs.snapshot()
                if counters["captures"] != len(SERVE_BUCKETS) or counters["eager_runs"]:
                    raise AssertionError(f"graph counters off: {counters}")
            finally:
                engine.close()
            torch.cuda.empty_cache()
    return rows


def _serve_bench_shape(card: str) -> dict:
    """bench.py's serving shape on the card (bench.py:1137-1147, GPU
    branch): pool 64, 2,048 mix queries in groups of 16, buckets 1/8/64,
    n_grid 1024, 60 iterations, the engine started."""
    from sbr_tpu_torch.models.params import SolverConfig
    from sbr_tpu_torch.serve import Engine, ServeConfig
    from sbr_tpu_torch.serve.loadgen import build_pool, query_mix

    config = SolverConfig(n_grid=1024, bisect_iters=60, refine_crossings=False)
    pool = build_pool(0, 64)
    mix = query_mix(0, 64, 2048)
    engine = Engine(config=config, serve=ServeConfig(buckets=(1, 8, 64)), device="cuda")
    engine.start()
    try:
        t0 = time.perf_counter()
        for i in range(0, len(pool), 16):
            engine.query_many(pool[i : i + 16], scenario="warmup", timeout=600)
        warmup_s = time.perf_counter() - t0
        warm = engine.live.snapshot()
        hist_before = engine.live.total_hist.copy()
        t0 = time.perf_counter()
        for i in range(0, len(mix), 16):
            engine.query_many([pool[j] for j in mix[i : i + 16]], scenario="mix", timeout=600)
        measured_s = time.perf_counter() - t0
        snap = engine.live.snapshot()
        diff = engine.live.total_hist.delta(hist_before)
    finally:
        engine.close()
    totals, wt = snap["totals"], warm["totals"]
    measured_q = totals["queries"] - wt["queries"]
    hit_rate = (totals["cache_hits"] - wt["cache_hits"]) / measured_q
    new_captures = snap["graphs"]["captures"] - warm["graphs"]["captures"]
    row = dict(
        pool=64, queries=measured_q, group=16, buckets=[1, 8, 64], n_grid=1024,
        bisect_iters=60, numerics=config.numerics, dtype="float64",
        p50_ms=diff.quantile(0.5), p99_ms=diff.quantile(0.99), cache_hit_rate=hit_rate,
        qps=measured_q / measured_s, warmup_s=warmup_s, graphs=snap["graphs"],
        post_warmup_graph_captures=new_captures, card=card,
    )
    emit("serve_bench_shape", **row)
    if measured_q != 2048 or hit_rate < 0.5 or new_captures != 0:
        raise AssertionError(f"bench serving shape: {row}")
    if snap["graphs"]["eager_runs"] or snap["graphs"]["replays"] != totals["batches"]:
        raise AssertionError("a dispatch did not replay a captured graph")
    return row


def _serve_cold_stream(card: str) -> dict:
    """4,096 distinct queries in groups of 512 through the started engine
    at its default (n_grid 4096, 90 iterations, buckets 1/8/64/512, f64),
    every query a miss; answers held bitwise to the eager solve."""
    from sbr_tpu_torch.models.params import SolverConfig
    from sbr_tpu_torch.serve import Engine, ServeConfig
    from sbr_tpu_torch.serve.engine import _query_columns
    from sbr_tpu_torch.serve.loadgen import build_pool

    config = SolverConfig(refine_crossings=False)
    pool = build_pool(1, 4096)
    engine = Engine(config=config, serve=ServeConfig(buckets=SERVE_BUCKETS), device="cuda")
    engine.start()
    try:
        t0 = time.perf_counter()
        for n in SERVE_BUCKETS:  # captures the buckets before the timed stream
            engine.query_many(build_pool(100 + n, n), timeout=600)
        capture_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        results = []
        for i in range(0, len(pool), 512):
            results += engine.query_many(pool[i : i + 512], scenario="cold", timeout=600)
        cold_s = time.perf_counter() - t0
        graphs = engine.graphs.snapshot()
    finally:
        engine.close()
    if any(r.source != "computed" for r in results):
        raise AssertionError("cold stream: a query did not miss")
    eager = _eager_outputs(_query_columns(pool, np.float64), config, torch.float64).cpu().numpy()
    served = np.array([[r.xi, r.tau_bar_in, r.aw_max, r.status, r.flags, r.residual]
                       for r in results]).T
    if not _bits_equal(served, eager):
        raise AssertionError("cold stream: served answers differ from the eager solve")
    row = dict(queries=len(pool), group=512, n_grid=config.n_grid,
               bisect_iters=config.bisect_iters, numerics=config.numerics, dtype="float64",
               warm_up_with_captures_s=capture_s, cold_s=cold_s,
               equilibria_per_s=len(pool) / cold_s, graphs=graphs,
               statuses=np.bincount(eager[3].astype(int), minlength=4).tolist(),
               bitwise_equal_to_eager=True, card=card)
    emit("serve_cold_stream", **row)
    return row


def _serve_endpoint(card: str) -> dict:
    """Three POST /query requests and the /metrics, /healthz and /statz
    scrapes over 127.0.0.1, against the started engine on the card."""
    from sbr_tpu_torch.models.params import SolverConfig
    from sbr_tpu_torch.serve import Engine, ServeConfig, ServeEndpoint
    from sbr_tpu_torch.serve.loadgen import build_pool, http_request, params_doc

    config = SolverConfig(n_grid=1024, bisect_iters=60, refine_crossings=False)
    pool = build_pool(5, 3)
    engine = Engine(config=config, serve=ServeConfig(buckets=(1, 8)), device="cuda").start()
    endpoint = ServeEndpoint(engine).start()
    try:
        latencies, answers = [], []
        for p in pool:
            t0 = time.perf_counter()
            code, body, _ = http_request(endpoint.port, "/query", params_doc(p))
            latencies.append((time.perf_counter() - t0) * 1e3)
            if code != 200:
                raise AssertionError(f"/query answered {code}: {body}")
            answers.append(json.loads(body))
        shed, _, hdrs = http_request(endpoint.port, "/query", params_doc(pool[0]),
                              {"X-SBR-Deadline-Ms": "-1"})
        m_code, metrics, _ = http_request(endpoint.port, "/metrics")
        h_code, health, _ = http_request(endpoint.port, "/healthz")
        s_code, statz, _ = http_request(endpoint.port, "/statz")
        direct = [engine.query(p) for p in pool]
    finally:
        endpoint.close()
        engine.close()
    same = all(a["status"] == d.status and a["flags"] == d.flags and (
        a["xi"] == d.xi or (a["xi"] is None and np.isnan(d.xi))) for a, d in zip(answers, direct))
    row = dict(post_ms=latencies, sources=[a["source"] for a in answers], shed_code=shed,
               retry_after=hdrs.get("Retry-After"), metrics_code=m_code, healthz_code=h_code,
               healthz=json.loads(health), statz_code=s_code,
               statz_graphs=json.loads(statz)["graphs"],
               captures_line=[ln for ln in metrics.splitlines()
                              if ln.startswith("sbr_serve_graph_captures_total")],
               answers_equal_direct=same, card=card)
    emit("serve_endpoint", **row)
    if not (same and shed == 429 and m_code == 200 and s_code == 200 and h_code == 200):
        raise AssertionError(f"endpoint: {row}")
    return row


def _serve_prefix_sums(card: str) -> dict:
    """Why the card's cumulative integrals use the doubling prefix sum:
    whether a row's bits under torch.cumsum, and under `prefix_sum`, stay
    those of one 2,048-row call when fewer rows share the call."""
    from sbr_tpu_torch.core.integrate import prefix_sum

    g = torch.Generator(device="cuda").manual_seed(0)
    row = {"card": card}
    for dtype in (torch.float64, torch.float32):
        x = torch.rand(2048, 4095, dtype=dtype, device="cuda", generator=g)
        for name, fn in (("cumsum", lambda v: torch.cumsum(v, -1)), ("prefix_sum", prefix_sum)):
            full = fn(x)
            row[f"{name}_{_dtype_name(dtype)}_rows_bitwise_equal"] = {
                rows: bool(torch.equal(fn(x[:rows].contiguous()), full[:rows]))
                for rows in (1, 8, 64, 512, 1024)
            }
    emit("serve_prefix_sum", **row)
    if not all(all(v.values()) for k, v in row.items() if k.startswith("prefix_sum")):
        raise AssertionError("the doubling prefix sum depends on the row count")
    return row


def phase_serve(card: str) -> dict:
    """The serving engine on the card: the per-bucket programs, bench.py's
    serving shape, a cold stream and the HTTP endpoint. The serving path
    launches neither kernel of the port; the counts, set to 0 before it
    and read after, say so."""
    from sbr_tpu_torch import _build

    _build.reset_launches()
    out = {
        "prefix_sum": _serve_prefix_sums(card),
        "buckets": _serve_bucket_rows(card),
        "bench": _serve_bench_shape(card),
        "cold": _serve_cold_stream(card),
        "endpoint": _serve_endpoint(card),
    }
    launches = dict(_build.LAUNCHES)
    emit("serve", kernel_launches=launches, card=card)
    if any(launches.values()):
        raise AssertionError(f"the serving path launched a kernel: {launches}")
    return out


def phase_serve_cpu_vs_card() -> None:
    """A pool of 16 served on the card and on the CPU at the engine
    default, f64/f32 × fixed/adaptive: statuses and flags equal; ξ, τ̄_IN,
    AW_max, and the residual of every lane whose root-find converged,
    within 1e-12 (f64) and 2e-5 (f32). A NO_ROOT lane's residual is where
    a search that cannot converge stopped (adaptive: after 90 steps that
    follow the last bits of f), so it is reported, not held."""
    from sbr_tpu_torch.models.params import SolverConfig
    from sbr_tpu_torch.models.results import Status
    from sbr_tpu_torch.serve import Engine, ServeConfig
    from sbr_tpu_torch.serve.loadgen import build_pool

    pool = build_pool(7, 16)
    for numerics in ("fixed", "adaptive"):
        for dtype in (torch.float64, torch.float32):
            cfg = SolverConfig(refine_crossings=False, numerics=numerics)
            out = {}
            for dev in ("cuda", "cpu"):
                with Engine(config=cfg, dtype=dtype, serve=ServeConfig(buckets=SERVE_BUCKETS),
                            device=dev) as engine:
                    out[dev] = engine.query_many(pool, timeout=600)
            card, cpu = out["cuda"], out["cpu"]
            ints_equal = all(a.status == b.status and a.flags == b.flags
                             for a, b in zip(card, cpu))
            no_root = np.array([r.status == int(Status.NO_ROOT) for r in cpu])
            gaps = {}
            for f in ("xi", "tau_bar_in", "aw_max", "residual"):
                a = np.array([getattr(r, f) for r in card])
                b = np.array([getattr(r, f) for r in cpu])
                if not np.array_equal(np.isnan(a), np.isnan(b)):
                    raise AssertionError(f"serve_cpu: NaN pattern of {f} differs")
                d = np.where(np.isnan(a), 0.0, np.abs(a - b))
                if f == "residual":
                    gaps["residual_no_root"] = float(d[no_root].max(initial=0.0))
                    d = d[~no_root]
                gaps[f] = float(d.max(initial=0.0))
            held = max(v for k, v in gaps.items() if k != "residual_no_root")
            emit("serve_cpu_vs_card", numerics=numerics, dtype=_dtype_name(dtype),
                 queries=len(pool), no_root_lanes=int(no_root.sum()),
                 statuses_flags_equal=ints_equal, max_abs=held, max_abs_by_field=gaps,
                 tol=SWEEP_TOL[dtype])
            if not ints_equal or held > SWEEP_TOL[dtype]:
                raise AssertionError(f"serve_cpu {numerics} {dtype}: card and CPU differ")


# ---------------------------------------------------------------------------
# Slice 6: the recount gather, and the heterogeneity, interest-rate and
# policy-sweep extensions
# ---------------------------------------------------------------------------

# The ablation script's shape (benchmarks/ablate_pallas_recount.py:114-125):
# 10^6 agents and 10^7 edges, padded to 10,092,544; and 2×10^6 + 3 agents,
# whose 250,001-byte packed mask exceeds a block's shared memory.
RECOUNT_AGENTS = (1_000_000, 2_000_003)
# Bit tables on both sides of the size rule's threshold
# (recount.SHARED_MAX_BYTES, 524,288 bytes: 4,194,304 agents) and far
# beyond it, where both sides of the rule are timed to place it: the same
# 10^7 edges.
RECOUNT_RULE_AGENTS = (2_500_000, 4_000_000, 8_000_000, 16_000_000, 64_000_000)
RECOUNT_EDGES = 10_000_000
# an edge's integer operations: the shift and mask of its id, the range
# check, the bit's shift and mask
RECOUNT_OPS_PER_EDGE = 6


def recount_bound_ms(mask_bytes: int, n_edges: int):
    """Least time for the gather: its bytes (each 4-byte id read, each
    4-byte result written, the mask read once) over the memory rate, or its
    integer operations over the vector rate, whichever is larger."""
    bytes_ms = (8 * n_edges + mask_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = n_edges * RECOUNT_OPS_PER_EDGE / VECTOR_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def _recount_rows(n: int, t: dict, ids_key: str, n_ids: int, shape: str,
                  other: bool = False) -> list:
    """The recount kernel on the first ``n_ids`` rows of ``t[ids_key]``:
    for each mask layout, the plan's own choice through the entry points
    (`bit_gather`, `bool_gather`) and, with ``other``, the plan on the other
    side of the size rule's threshold (shared or split against global),
    through `recount.launch`. Each is held bit for bit to its plain version
    and to the library gather, and timed beside the plain version, the
    library gather (one ``torch.index_select`` on the mask as int32),
    torch's copy of the ids into an int32 output (``copy_ms``, 8 bytes an
    edge like the kernel) and the bound."""
    from sbr_tpu_torch.social import recount

    src = t[ids_key][:n_ids]
    flat = src.reshape(-1)
    want = torch.index_select(t["wd_i32"], 0, flat)
    library_ms = time_ms(lambda: torch.index_select(t["wd_i32"], 0, flat))
    copied = torch.empty(flat.shape, dtype=torch.int32, device=flat.device)
    copy_ms = time_ms(lambda: copied.copy_(flat))
    rows = []
    layouts = (("packed", t["packed"], recount.bit_gather, recount.bit_gather_plain),
               ("unpacked", t["wd_u8"], recount.bool_gather, recount.bool_gather_plain))
    for layout, mask, entry, plain in layouts:
        if ids_key == "src_2d" and layout == "unpacked":
            continue
        packed = layout == "packed"
        plan = recount.plan_for(mask, src, packed=packed)
        plain_ms = time_ms(lambda: plain(mask, src))
        ref = plain(mask, src)
        runs = [(plan, lambda: entry(mask, src))]
        if other:
            alt = recount.plan_for(mask, src, packed=packed,
                                   shared_max=0 if plan.branch == "shared" else 1 << 40)
            runs.append((alt, lambda: recount.launch(mask, src, alt, packed=packed)))
        for want_plan, run in runs:
            got = run()
            ran = recount.LAST_PLAN[layout]
            torch.cuda.synchronize()
            mism = int((got != ref).sum()) + int((got.reshape(-1) != want).sum())
            max_abs = int((got - ref).abs().max())
            kernel_ms = time_ms(run)
            b_ms, b_by = recount_bound_ms(mask.numel(), src.numel())
            row = {
                "n_agents": n, "n_edges": src.numel(), "shape": shape,
                "variant": layout + ("_2d" if ids_key == "src_2d" else ""),
                "mask_bytes": mask.numel(), "branch": ran.name, "cluster": ran.cluster,
                "held": ran.held, "planned": want_plan is plan, "grid": ran.grid,
                "threads": ran.threads, "smem": ran.smem, "mismatches": mism,
                "max_abs_err": max_abs, "ms": kernel_ms, "plain_ms": plain_ms,
                "library_ms": library_ms, "copy_ms": copy_ms, "bound_ms": b_ms,
                "bound_by": b_by, "share_of_bound": b_ms / kernel_ms,
                "edges_per_s": src.numel() / (kernel_ms * 1e-3),
            }
            emit("recount_kernel_vs_plain", **row)
            if mism:
                raise AssertionError(f"recount kernel and plain version disagree: {row}")
            if ran != want_plan:
                raise AssertionError(f"launched {ran}, the plan is {want_plan}")
            rows.append(row)
    return rows


def phase_recount() -> dict:
    """The recount gather kernel against its plain version, bit for bit: at
    both ablation shapes, the plan's own branch for the packed mask, the
    packed mask with 2-D ids and the unpacked mask, and the branch on the
    other side of the size rule for each mask; the staging's fixed cost at
    one edge block (131,072 edges); both sides of the rule at the bit tables
    of RECOUNT_RULE_AGENTS; then the port's ablation script end to end,
    with the counts set to 0 just before it."""
    from sbr_tpu_torch import _build
    from sbr_tpu_torch.benchmarks import ablate_pallas_recount as abl
    from sbr_tpu_torch.social import recount

    rows = []
    for n in RECOUNT_AGENTS + RECOUNT_RULE_AGENTS:
        _, _, t = abl.make_inputs(n, RECOUNT_EDGES, "cuda")
        e = t["src"].numel()
        if n in RECOUNT_AGENTS:
            rows += _recount_rows(n, t, "src", e, "full", other=True)
            rows += _recount_rows(n, t, "src_2d", e // 128, "full")
            rows += _recount_rows(n, t, "src", abl.EDGE_BLOCK, "prologue")
        else:
            rows += _recount_rows(n, t, "src", e, "rule", other=True)
        del t
        torch.cuda.empty_cache()
    # every branch the plan chooses at these shapes ran (and was the one
    # launched: _recount_rows checks it)
    planned = {r["branch"] for r in rows if r["planned"]}
    if planned != {"shared", "split", "global"}:
        raise AssertionError(f"the plan chose {sorted(planned)}, not every branch")
    _build.reset_launches()
    record = abl.run()
    launches = _build.LAUNCHES[recount.KERNEL]
    emit("recount_main_path", launches=launches, **record)
    if launches == 0:
        raise AssertionError("the ablation script launched no recount kernel")
    return {"rows": rows, "launches": launches}


# Section 2 of the paper's figures (sbr_tpu/figures/master.py:233-235) and
# Section 3 (master.py:258-260); the policy sweep at the stretch shape
# (benchmarks/stretch.py:122-140): 10 β in [0.5, 3], 10 u in [0, 0.45],
# 10 r in [0, 0.09], refinement off.
SECTION2 = dict(betas=(0.125, 12.5), dist=(0.9, 0.1), eta_bar=30.0, u=0.1, p=0.9, kappa=0.3,
                lam=0.1)
SECTION3 = dict(beta=1.0, eta_bar=15.0, u=0.0, p=0.5, kappa=0.6, lam=0.01, r=0.06, delta=0.1)
STRETCH = (np.linspace(0.5, 3.0, 10), np.linspace(0.0, 0.45, 10), np.linspace(0.0, 0.09, 10))
# tests/test_hetero.py's and tests/test_interest.py's bounds against the oracle
EXT_ORACLE_XI = 1e-5
# the interest scan is profiled at this n_grid: the profiler's analysis
# costs ~0.2 ms a kernel, and the full-width scan runs ~10^6 kernels
EXT_PROFILE_GRID = 256
# values that pass through bs32: its own rtol bounds what a step decision
# that rounds the other way can move (tests/test_torch_ode.py)
BS32_TOL = 1e-6


def _ext_case(name: str, numerics: str, device: str, dtype=torch.float64, axes=STRETCH,
              n_grid: int = 4096) -> dict:
    """One extension solve through its entry points: its outputs as a dict
    of tensors (status, flags, the scalars)."""
    import sbr_tpu_torch as st
    from sbr_tpu_torch.hetero import get_aw_hetero, solve_equilibrium_hetero, solve_learning_hetero
    from sbr_tpu_torch.interest import solve_equilibrium_interest
    from sbr_tpu_torch.models import make_hetero_params, make_interest_params
    from sbr_tpu_torch.sweeps.policy_sweeps import policy_sweep_interest

    if name == "section2":
        cfg = st.SolverConfig(numerics=numerics, n_grid=n_grid)
        m = make_hetero_params(**SECTION2)
        lsh = solve_learning_hetero(m.learning, cfg, dtype=dtype, device=device)
        r = solve_equilibrium_hetero(lsh, m.economic, cfg)
        return dict(status=r.status, flags=r.health.flags, xi=r.xi, tau_in=r.tau_bar_in_uncs,
                    tau_out=r.tau_bar_out_uncs, aw_max=get_aw_hetero(r, lsh).aw_max, hrs=r.hrs)
    if name == "section3":
        cfg = st.SolverConfig(numerics=numerics, n_grid=n_grid)
        m = make_interest_params(**SECTION3)
        ls = st.solve_learning(m.learning, cfg, dtype=dtype, device=device)
        r = solve_equilibrium_interest(ls, m.economic, cfg)
        b = r.base
        return dict(status=b.status, flags=b.health.flags, xi=b.xi, tau_in=b.tau_bar_in_unc,
                    tau_out=b.tau_bar_out_unc, aw_max=b.aw_max, v=r.v)
    cfg = st.SolverConfig(numerics=numerics, n_grid=n_grid, refine_crossings=False)
    base = make_interest_params(u=0.0, delta=0.1)
    r = policy_sweep_interest(*axes, base, cfg, dtype=dtype, device=device)
    return dict(status=r.status, flags=r.health.flags, xi=r.xi, aw_max=r.aw_max)


def _ext_oracles() -> dict:
    """tests/oracle.py's scipy solves of Sections 2 and 3."""
    sys.path.insert(0, (__file__.rpartition("/")[0] or ".") + "/tests")
    from oracle import solve_hetero_oracle, solve_interest_oracle

    return {"section2": solve_hetero_oracle([0.125, 12.5], [0.9, 0.1], n_scan=400).xi,
            "section3": solve_interest_oracle(n_scan=400).xi}


def phase_extensions() -> dict:
    """Sections 2 and 3 and the stretch-shape policy sweep on the card at
    full width (n_grid 4096), in both numerics modes (the sweep in float32
    and float64): one cold call, then one fenced call (ms, equilibria/s,
    peak memory); ξ held to the oracle, ξ and AW_max finite exactly on RUN
    cells, fixed and adaptive statuses equal in float64. Then the interest
    scan's kernels and device time from the profiler at n_grid
    EXT_PROFILE_GRID, in both numerics, and the device's share of the
    same call's wall time unprofiled. The path launches no kernel of the port; the
    counts, set to 0 before it and read after, say so."""
    from sbr_tpu_torch import _build
    from sbr_tpu_torch.diag.health import flag_names, or_reduce_flags
    from sbr_tpu_torch.utils.status import status_counts

    oracle = _ext_oracles()
    _build.reset_launches()
    out = {}
    cases = [("section2", torch.float64, 1), ("section3", torch.float64, 1),
             ("policy", torch.float32, 1000), ("policy", torch.float64, 1000)]
    for name, dtype, cells in cases:
        for numerics in ("fixed", "adaptive"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _ext_case(name, numerics, "cuda", dtype)
            torch.cuda.synchronize()
            cold_s = time.perf_counter() - t0
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = _ext_case(name, numerics, "cuda", dtype)
            torch.cuda.synchronize()
            fenced_s = time.perf_counter() - t0
            status, xi = res["status"], res["xi"]
            run = status == 0
            row = dict(case=name, dtype=_dtype_name(dtype), numerics=numerics, cells=cells,
                       cold_s=cold_s, fenced_ms=fenced_s * 1e3, equilibria_per_s=cells / fenced_s,
                       peak_bytes=torch.cuda.max_memory_allocated(),
                       status_counts=status_counts(status),
                       flags=flag_names(int(or_reduce_flags(res["flags"]))))
            if name in oracle:
                row.update(xi=float(xi), oracle_xi=oracle[name],
                           xi_err=abs(float(xi) - oracle[name]))
                if not row["xi_err"] <= EXT_ORACLE_XI:
                    raise AssertionError(f"{name} {numerics}: ξ is off the oracle: {row}")
            emit("extensions", **row)
            finite = bool(torch.isfinite(xi[run]).all()) and bool(torch.isfinite(res["aw_max"][run]).all())
            if not finite or bool(torch.isfinite(xi[~run]).any()):
                raise AssertionError(f"{name} {numerics}: ξ/AW_max finite exactly on RUN cells fails")
            out[(name, _dtype_name(dtype), numerics)] = res
        if dtype == torch.float64:
            sf, sa = out[(name, "float64", "fixed")]["status"], out[(name, "float64", "adaptive")]["status"]
            if not torch.equal(sf, sa):
                raise AssertionError(f"{name}: fixed and adaptive statuses differ")
    for numerics in ("fixed", "adaptive"):
        def run(numerics=numerics):
            return _ext_case("section3", numerics, "cuda", n_grid=EXT_PROFILE_GRID)

        prof = _kernel_profile(run)
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        emit("extensions_interest_profile", numerics=numerics, n_grid=EXT_PROFILE_GRID, **prof,
             kernels_per_interval=prof["kernels"] / (EXT_PROFILE_GRID - 1),
             wall_ms_unprofiled=wall_ms, busy_share_unprofiled=prof["device_ms"] / wall_ms)
    launches = dict(_build.LAUNCHES)
    emit("extensions_kernel_launches", launches=launches)
    if any(launches.values()):
        raise AssertionError(f"the extensions launched a kernel: {launches}")
    return out


def phase_extensions_cpu_vs_card() -> None:
    """The port on the card against the port on the CPU: Sections 2 and 3
    at n_grid 4096 in both numerics, and a 4×4×4 sub-grid of the stretch
    policy sweep at n_grid 1024 in float32 and float64, both numerics.
    Statuses and flags equal; floats within 1e-12 (f64) and 2e-5 (f32),
    and values that pass through bs32 (adaptive Section 3 and adaptive
    sweeps) within BS32_TOL."""
    sub = tuple(a[np.linspace(0, 9, 4).astype(int)] for a in STRETCH)
    cases = [("section2", torch.float64, 4096), ("section3", torch.float64, 4096),
             ("policy", torch.float64, 1024), ("policy", torch.float32, 1024)]
    for name, dtype, n_grid in cases:
        for numerics in ("fixed", "adaptive"):
            a, b = (_ext_case(name, numerics, dev, dtype, axes=sub, n_grid=n_grid)
                    for dev in ("cpu", "cuda"))
            ints_equal = all(torch.equal(a[k], b[k].cpu()) for k in ("status", "flags"))
            gaps = {}
            for k in a:
                if k in ("status", "flags"):
                    continue
                x, y = a[k].double(), b[k].cpu().double()
                nan_equal = torch.equal(torch.isnan(x), torch.isnan(y))
                ok = ~torch.isnan(x)
                gaps[k] = float((x[ok] - y[ok]).abs().max()) if nan_equal and bool(ok.any()) else (
                    0.0 if nan_equal else float("inf"))
            tol = SWEEP_TOL[dtype]
            if numerics == "adaptive" and name != "section2" and dtype == torch.float64:
                tol = BS32_TOL
            held = max(gaps.values())
            emit("extensions_cpu_vs_card", case=name, dtype=_dtype_name(dtype), numerics=numerics,
                 n_grid=n_grid, statuses_flags_equal=ints_equal, max_abs_by_field=gaps,
                 max_abs=held, tol=tol, within_1e12=held <= 1e-12)
            if not ints_equal or held > tol:
                raise AssertionError(f"extensions_cpu {name} {numerics} {dtype}: card and CPU differ")


# ---------------------------------------------------------------------------
# Slice 8: composed scenarios and population what-ifs
# ---------------------------------------------------------------------------

# bench.py's scenario workload at its accelerator shape (bench.py:1432-1446):
# a 256×256 β×u grid at n_grid 1024 and 60 root-find iterations, float32,
# and a 64-bank directed ring of exposures
SCEN_N = 256
SCEN_CFG = dict(n_grid=1024, bisect_iters=60, refine_crossings=False)
SCEN_REPS = 3
SCEN_BANKS = 64
# the composed social × hetero × interest × policy case's budget at the
# default n_grid, past which it runs at n_grid 1024
SCEN_SOCIAL_BUDGET_S = 60.0
# bench.py's population workload at its serving shape (bench.py:1564-1582)
POP_N, POP_DEG, POP_SEEDS, POP_QUERIES = 20_000, 10.0, 16, 3
POP_GRID = 256
POP_GRAPH_SEEDS = 4
POP_BIG_N, POP_BIG_SEEDS = 1_000_000, 4


def _fenced(fn):
    """(seconds, result) of one call of ``fn`` between two synchronizes."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def _scenario_grid_rows(card: str) -> None:
    """bench_scenario's grid through `scenario_grid`: the reducible spec
    bit for bit against `beta_u_grid` with the composed/plain time ratio
    (calls in turns, the least of SCEN_REPS each), then the policy
    modifiers, then the interest modifier on interest params."""
    import sbr_tpu_torch as st
    from sbr_tpu_torch.utils.status import status_counts

    cfg = st.SolverConfig(**SCEN_CFG)
    betas = np.linspace(0.25, 3.0, SCEN_N)

    def us(rep):
        return np.linspace(0.01, 0.99, SCEN_N) + rep * 1e-6

    cases = (
        ("reducible", st.ScenarioSpec(), st.make_model_params()),
        ("policy", st.ScenarioSpec(modifiers=("insurance_cap", "suspension", "lolr")),
         st.make_model_params(insurance_cap=0.2, suspension_t=8.0, lolr_rate=0.1)),
        ("interest", st.ScenarioSpec(modifiers=("interest",)),
         st.make_interest_params(r=0.02, delta=0.1)),
    )
    for name, spec, base in cases:
        def composed(rep, spec=spec, base=base):
            return st.scenario_grid(spec, betas, us(rep), base, config=cfg, dtype=torch.float32)

        def plain(rep, base=base):
            return st.beta_u_grid(betas, us(rep), base, config=cfg, dtype=torch.float32)

        cold_s, res = _fenced(lambda: composed(0))
        times = {"composed": [], "plain": []}
        for rep in range(1, SCEN_REPS + 1):
            times["composed"].append(_fenced(lambda: composed(rep))[0])
            if name == "reducible":
                times["plain"].append(_fenced(lambda: plain(rep))[0])
        steady_s = min(times["composed"])
        row = dict(case=name, spec=spec.to_doc(), cells=SCEN_N * SCEN_N, dtype="float32",
                   numerics=cfg.numerics, n_grid=cfg.n_grid, bisect_iters=cfg.bisect_iters,
                   cold_s=cold_s, steady_ms=steady_s * 1e3, cells_per_s=SCEN_N ** 2 / steady_s,
                   status_counts=status_counts(res.status),
                   finite_xi=int(torch.isfinite(res.xi).sum()), card=card)
        run = res.status == 0
        if not (bool(torch.isfinite(res.xi[run]).all())
                and not bool(torch.isfinite(res.xi[~run]).any())):
            raise AssertionError(f"scenario grid {name}: ξ finite exactly on RUN cells fails")
        if name == "reducible":
            want = plain(0)
            same = {f: _bits_equal(getattr(res, f).cpu().numpy(), getattr(want, f).cpu().numpy())
                    for f in ("xi", "max_aw", "status")}
            same.update({f"health_{f}": _bits_equal(getattr(res.health, f).cpu().numpy(),
                                                    getattr(want.health, f).cpu().numpy())
                         for f in ("residual", "bracket_width", "iterations", "flags")})
            plain_s = min(times["plain"])
            row.update(bitwise_vs_beta_u_grid=same, plain_ms=plain_s * 1e3,
                       composed_over_plain=steady_s / plain_s)
            if not all(same.values()):
                raise AssertionError(f"the reducible scenario grid is not beta_u_grid: {same}")
        emit("scenario", **row)


def _scenario_multibank_rows(card: str) -> None:
    """bench_scenario's contagion solve: the 64-bank ring (weight 0.6),
    every bank fragile enough that spillovers move κ, in float32 (the
    bench's) and float64: one warm-up, then one fenced solve."""
    import sbr_tpu_torch as st

    cfg = st.SolverConfig(**SCEN_CFG)
    ring = tuple((i, (i + 1) % SCEN_BANKS, 0.6) for i in range(SCEN_BANKS))
    spec = st.ScenarioSpec(banks=SCEN_BANKS, exposure=ring, contagion_max_iter=12,
                           contagion_tol=1e-5)
    plist = [st.make_model_params(beta=1.0 + 0.5 * (i / (SCEN_BANKS - 1)), u=0.05)
             for i in range(SCEN_BANKS)]
    for dtype in (torch.float32, torch.float64):
        cold_s, _ = _fenced(lambda: st.solve_multibank(spec, plist, config=cfg, dtype=dtype))
        s, mb = _fenced(lambda: st.solve_multibank(spec, plist, config=cfg, dtype=dtype))
        emit("scenario", case="multibank_ring", banks=SCEN_BANKS, dtype=_dtype_name(dtype),
             numerics=cfg.numerics, n_grid=cfg.n_grid, iterations=mb.iterations,
             converged=mb.converged, runs=int((mb.status == 0).sum()),
             kappa_eff_min=float(mb.kappa_eff.min()), spillover_max=float(mb.spillover.max()),
             cold_s=cold_s, fenced_s=s, bank_cells_per_s=mb.iterations * SCEN_BANKS / s,
             ms_per_round=s * 1e3 / mb.iterations, card=card)


def _hetero_interest_params(st, **econ_kw):
    """K = 2 groups (β 0.8, 1.6, equal weights) with interest-typed
    economics: the composition cases of tests/test_scenario.py."""
    from sbr_tpu_torch.models.params import EconomicParamsInterest, ModelParamsHetero

    hp = st.make_hetero_params(betas=(0.8, 1.6), dist=(0.5, 0.5), u=0.05)
    e = hp.economic
    econ = EconomicParamsInterest(u=e.u, p=e.p, kappa=e.kappa, lam=e.lam, eta_bar=e.eta_bar,
                                  eta=e.eta, **econ_kw)
    return ModelParamsHetero(learning=hp.learning, economic=econ)


def _scenario_family_rows(card: str) -> None:
    """`scenario.solve` once for each composition family at SolverConfig()
    defaults (n_grid 4096, 90 iterations, refinement on, float64): each
    reduction, the policy modifiers, interest, hetero and social
    compositions, social × hetero × interest × policy, and a multi-bank
    spec. One cold and one fenced call (the fenced one skipped past 20 s)."""
    import sbr_tpu_torch as st
    from sbr_tpu_torch import scenario

    fig12 = st.make_model_params(**FIG12)
    interest = st.make_interest_params(beta=1.0, u=0.05, r=0.02, delta=0.1, insurance_cap=0.1,
                                       lolr_rate=0.05)
    families = (
        ("baseline", dict(), st.make_model_params(beta=1.2, u=0.08)),
        ("interest", dict(modifiers=("interest",)), interest),
        ("hetero", dict(learning="hetero"), _hetero_interest_params(st)),
        ("social", dict(learning="social", social_max_iter=500), fig12),
        ("policy", dict(modifiers=("insurance_cap", "suspension", "lolr")),
         st.make_model_params(u=0.08, insurance_cap=0.1, suspension_t=8.0, lolr_rate=0.05)),
        ("interest_policy", dict(modifiers=("interest", "insurance_cap", "lolr")), interest),
        ("hetero_policy", dict(learning="hetero", modifiers=("insurance_cap", "lolr")),
         _hetero_interest_params(st, insurance_cap=0.1, lolr_rate=0.05)),
        ("hetero_interest", dict(learning="hetero", modifiers=("interest",)),
         _hetero_interest_params(st, r=0.02, delta=0.1)),
        ("social_policy", dict(learning="social", modifiers=("insurance_cap", "lolr"),
                               social_max_iter=500),
         st.with_overrides(fig12, insurance_cap=0.05, lolr_rate=0.05)),
        ("social_hetero", dict(learning="social", social_max_iter=150),
         _hetero_interest_params(st)),
        ("social_hetero_interest_policy",
         dict(learning="social", modifiers=("interest", "insurance_cap", "lolr"),
              social_max_iter=150),
         _hetero_interest_params(st, r=0.01, delta=0.1, insurance_cap=0.1, lolr_rate=0.05)),
        ("multibank", dict(banks=3, exposure=((0, 1, 1.0), (0, 2, 1.0), (1, 2, 0.5)), lgd=0.9),
         [st.make_model_params(beta=1.0, u=0.05),
          st.make_model_params(beta=1.0, u=0.05, kappa=0.93),
          st.make_model_params(beta=1.0, u=0.05, kappa=0.93)]),
    )
    hetero_interest_s = None
    for name, spec_kw, params in families:
        spec = st.ScenarioSpec(**spec_kw)
        cfg = st.SolverConfig() if spec.banks == 1 else None
        note = None
        if name == "social_hetero_interest_policy":
            # each outer iteration solves the hetero × interest pipeline: at
            # ~45 iterations (the CPU test's 44) its estimated time decides
            # the grid
            estimate_s = 45 * hetero_interest_s
            if estimate_s > SCEN_SOCIAL_BUDGET_S:
                cfg = st.SolverConfig(n_grid=1024)
                note = (f"n_grid 1024: at the default 4096 the estimate is {estimate_s:.0f} s "
                        f"(45 iterations × {hetero_interest_s:.2f} s), past "
                        f"{SCEN_SOCIAL_BUDGET_S:.0f} s")
        cold_s, res = _fenced(lambda: scenario.solve(spec, params, config=cfg))
        fenced_s = _fenced(lambda: scenario.solve(spec, params, config=cfg))[0] \
            if cold_s < 20.0 else None
        if name == "hetero_interest":
            hetero_interest_s = fenced_s or cold_s
        status, xi = res.status.cpu(), res.xi.cpu()
        run = status == 0
        row = dict(case="family", family=name, spec=spec.to_doc(),
                   n_grid=(cfg or st.SolverConfig(refine_crossings=False)).n_grid,
                   numerics=(cfg or st.SolverConfig()).numerics, dtype="float64",
                   status=status.tolist(), xi=[None if not np.isfinite(v) else v
                                               for v in xi.double().reshape(-1).tolist()],
                   flags=res.health.flags.cpu().reshape(-1).tolist(), cold_s=cold_s,
                   fenced_s=fenced_s, fingerprint=res.fingerprint[:16], note=note, card=card)
        if isinstance(res, scenario.ScenarioResult) and spec.learning == "social":
            d = res.detail
            its = d["iterations"] if isinstance(d, dict) else d.iterations
            conv = d["converged"] if isinstance(d, dict) else d.converged
            row.update(iterations=int(its), converged=bool(conv))
        if spec.banks > 1:
            row.update(iterations=res.iterations, converged=res.converged)
        emit("scenario", **row)
        if not (bool(torch.isfinite(xi[run]).all()) and not bool(torch.isfinite(xi[~run]).any())):
            raise AssertionError(f"scenario {name}: ξ finite exactly on RUN fails")


def phase_scenario(card: str) -> None:
    """Composed scenarios on the card (they run no kernel of the port: the
    counts, set to 0 before and read after, say so): bench_scenario's grid
    and contagion shapes, then one solve of each composition family."""
    from sbr_tpu_torch import _build

    _build.reset_launches()
    _scenario_grid_rows(card)
    _scenario_multibank_rows(card)
    _scenario_family_rows(card)
    launches = dict(_build.LAUNCHES)
    emit("scenario_kernel_launches", launches=launches)
    if any(launches.values()):
        raise AssertionError(f"the scenario path launched a kernel: {launches}")


def _busy_profile(run) -> dict:
    """Busy share and kernels of one profiled call (`_profiled`)."""
    prof = _profiled(run)
    return {"busy_share": prof["device_busy_share"], "kernels": prof["device_kernels"],
            "wall_s": prof["wall_s"]}


def _population_row(card: str, name: str, spec, n: int, seeds: int, vary: str, queries: int,
                    warm: bool, fixed_points: dict) -> int:
    """One population what-if shape through `population_query` (from
    scratch, ``g0=None``, as bench.py's): a warm-up query (when ``warm``),
    then ``queries`` queries on distinct seeds,
    each with its kernel counts set to 0 before and read after (they must
    equal members × steps, the other kernel 0), giving queries/s and the
    time in the mean-field fixed point. The device busy share is the
    time-weighted one of the fixed point's first PROFILE_ITERS iterations
    and of one member run from the solved fixed point, each profiled; the
    fixed point and its profile are kept by channel in ``fixed_points``
    (the model and grid are the same on every line). Returns the kernel's
    launches in the timed queries."""
    import sbr_tpu_torch as st
    from sbr_tpu_torch import _build
    from sbr_tpu_torch.infomodels import meanfield, population_query
    from sbr_tpu_torch.social.fused import BELIEF_KERNEL, KERNEL

    m = st.make_model_params(**FIG12)
    cfg = st.SolverConfig(n_grid=POP_GRID)
    graph = st.ErdosRenyiSpec(n, POP_DEG)
    kernel, other = (BELIEF_KERNEL, KERNEL) if spec.channel == "bayes" else (KERNEL, BELIEF_KERNEL)
    steps = max(int(round(float(m.economic.eta) / 0.1)), 2)
    kw = dict(seeds=seeds, vary=vary, config=cfg, g0=None)
    cold_s = None
    if warm:
        cold_s = _fenced(lambda: population_query(spec, graph, m, seed=0, **kw))[0]
    launches, records = [], []
    with _CallTimes((meanfield, "solve_fixed_point_info")) as spent:
        t0 = time.perf_counter()
        for q in range(queries):
            _build.reset_launches()
            records.append(population_query(spec, graph, m, seed=10_000 + q, **kw))
            torch.cuda.synchronize()
            launches.append((_build.LAUNCHES[kernel], _build.LAUNCHES[other]))
        total_s = time.perf_counter() - t0
    fp_s = sum(spent["solve_fixed_point_info"])
    if spec.channel not in fixed_points:
        fixed_points[spec.channel] = (
            meanfield.solve_fixed_point_info(spec, m, config=cfg, max_iter=500),
            _busy_profile(lambda: meanfield.solve_fixed_point_info(
                spec, m, config=cfg, max_iter=PROFILE_ITERS)),
        )
    fp, fp_prof = fixed_points[spec.channel]
    member_prof = _busy_profile(lambda: population_query(
        spec, graph, m, seed=10_000, fp=fp, **{**kw, "seeds": 1, "vary": "sim"}))
    members_s = total_s - fp_s
    busy = (fp_prof["busy_share"] * fp_s + member_prof["busy_share"] * members_s) / total_s
    expected = seeds * steps
    rec = records[-1]
    emit("population", path=name, channel=spec.channel, vary=vary, n_agents=n,
         avg_degree=POP_DEG, members=seeds, steps=steps, n_grid=POP_GRID, queries=queries,
         cold_s=cold_s, total_s=total_s, queries_per_s=queries / total_s,
         fixed_point_s=fp_s, members_s=members_s,
         agent_steps_per_s=n * steps * seeds * queries / members_s,
         kernel=kernel, kernel_launches=[a for a, _ in launches], expected_launches=expected,
         other_kernel_launches=[b for _, b in launches],
         busy_share=busy, busy_share_fixed_point=fp_prof["busy_share"],
         busy_share_members=member_prof["busy_share"],
         fixed_point_kernels_per_iteration=fp_prof["kernels"] / PROFILE_ITERS,
         member_kernels_per_step=member_prof["kernels"] / steps,
         run_probability=rec["run_probability"], crossing_quantiles=rec["crossing_quantiles"],
         xi_meanfield=rec["xi_meanfield"], err_aw_sup=rec["err_aw_sup"], card=card)
    if any(a != expected or b for a, b in launches):
        raise AssertionError(f"population {name}: launches {launches}, want ({expected}, 0) "
                             f"a query (members × steps)")
    for r in records:
        t = [v for v in r["crossing_times"] if v is not None]
        if len(r["crossing_times"]) != seeds or not all(0.0 <= v <= float(m.economic.eta)
                                                        for v in t):
            raise AssertionError(f"population {name}: bad record {r}")
    return sum(a for a, _ in launches)


def _served_scenario_population(card: str) -> dict:
    """One scenario query and one population query through `Engine` and
    through the HTTP endpoint on the card: asked a second time, each comes
    back from the LRU. The population query's kernel launches, set to 0
    before it and read after, must be members × steps."""
    import sbr_tpu_torch as st
    from sbr_tpu_torch import _build
    from sbr_tpu_torch.serve import Engine, ServeConfig, ServeEndpoint
    from sbr_tpu_torch.serve.loadgen import http_request
    from sbr_tpu_torch.social.fused import BELIEF_KERNEL

    fig12_doc = {"beta": 0.9, "eta_bar": 30.0, "u": 0.5, "p": 0.99, "kappa": 0.25, "lam": 0.25}
    pop = {"graph": {"model": "erdos_renyi", "n": POP_N, "avg_degree": POP_DEG},
           "infomodel": {"channel": "bayes"}, "seeds": POP_SEEDS, "vary": "sim", "g0": None}
    scen = {"modifiers": ["insurance_cap", "lolr"]}
    m = st.make_model_params(**FIG12)
    engine = Engine(config=st.SolverConfig(n_grid=POP_GRID), serve=ServeConfig(buckets=(1,)),
                    device="cuda").start()
    endpoint = ServeEndpoint(engine).start()
    rows = {}
    try:
        def post(doc):
            t0 = time.perf_counter()
            code, body, _ = http_request(endpoint.port, "/query", doc)
            if code != 200:
                raise AssertionError(f"/query answered {code}: {body}")
            return json.loads(body), (time.perf_counter() - t0) * 1e3

        spec = st.ScenarioSpec(modifiers=("insurance_cap", "lolr"))
        p = st.with_overrides(m, insurance_cap=0.05, lolr_rate=0.05)
        first = engine.query_scenario(p, spec)
        http, http_ms = post({**fig12_doc, "insurance_cap": 0.05, "lolr_rate": 0.05,
                              "scenario": scen})
        other, other_ms = post({**fig12_doc, "insurance_cap": 0.1, "lolr_rate": 0.05,
                                "scenario": scen})
        again = engine.query_scenario(st.with_overrides(m, insurance_cap=0.1, lolr_rate=0.05),
                                      spec)
        rows["scenario"] = dict(sources=[first["source"], http["source"], other["source"],
                                         again["source"]],
                                latency_ms=[first["latency_ms"], http_ms, other_ms,
                                            again["latency_ms"]],
                                status=[first["status"], other["status"]],
                                same_answer=http["xi"] == first["xi"])
        _build.reset_launches()
        p_first = engine.query_population(m, pop)
        torch.cuda.synchronize()
        launches = _build.LAUNCHES[BELIEF_KERNEL]
        p_http, p_http_ms = post({**fig12_doc, "population": pop})
        rows["population"] = dict(sources=[p_first["source"], p_http["source"]],
                                  latency_ms=[p_first["latency_ms"], p_http_ms],
                                  belief_launches=launches,
                                  same_answer=p_http["crossing_times"] == p_first["crossing_times"],
                                  run_probability=p_first["run_probability"])
    finally:
        endpoint.close()
        engine.close()
    steps = max(int(round(float(m.economic.eta) / 0.1)), 2)
    emit("population_served", **rows, expected_launches=POP_SEEDS * steps, card=card)
    if not (rows["scenario"]["sources"] == ["computed", "lru", "computed", "lru"]
            and rows["population"]["sources"] == ["computed", "lru"]
            and rows["scenario"]["same_answer"] and rows["population"]["same_answer"]
            and launches == POP_SEEDS * steps):
        raise AssertionError(f"served scenario/population: {rows}")
    return {"belief": launches}


def phase_population(card: str) -> dict:
    """Population what-ifs on the card at bench_infomodels' serving shape
    (bayes, 20,000 agents, 16 members, n_grid 256: a warm-up and 3 queries
    on distinct seeds), the same in the gossip channel, ``vary="graph"``
    with 4 members, one gossip query at 10^6 agents and 4 members, and the
    served routes. Every query launches its channel's kernel members ×
    steps times. Returns the launches by kernel."""
    import sbr_tpu_torch as st
    from sbr_tpu_torch.social.fused import BELIEF_KERNEL, KERNEL

    bayes, gossip = st.InfoModelSpec(channel="bayes"), st.InfoModelSpec()
    totals = {KERNEL: 0, BELIEF_KERNEL: 0}
    fps = {}
    totals[BELIEF_KERNEL] += _population_row(card, "bench_bayes", bayes, POP_N, POP_SEEDS, "sim",
                                             POP_QUERIES, True, fps)
    totals[KERNEL] += _population_row(card, "bench_gossip", gossip, POP_N, POP_SEEDS, "sim",
                                      POP_QUERIES, True, fps)
    totals[BELIEF_KERNEL] += _population_row(card, "vary_graph", bayes, POP_N, POP_GRAPH_SEEDS,
                                             "graph", 1, False, fps)
    totals[KERNEL] += _population_row(card, "gossip_1e6", gossip, POP_BIG_N, POP_BIG_SEEDS,
                                      "sim", 1, False, fps)
    totals[BELIEF_KERNEL] += _served_scenario_population(card)["belief"]
    return totals


def phase_scenario_cpu_vs_card() -> None:
    """The card against the CPU, float64: a 24×24 scenario subgrid at
    n_grid 1024 (the policy modifiers in both numerics, the interest
    modifier under fixed numerics), the 64-bank ring, and a bayes
    population query from one fixed point with the CPU's per-agent fields
    on both devices. Statuses, flags, iterations and crossing times
    exactly; floats within 1e-12."""
    import sbr_tpu_torch as st
    from sbr_tpu_torch.infomodels import engine, population_query

    betas, us = np.linspace(0.25, 3.0, 24), np.linspace(0.01, 0.99, 24)
    for name, spec, base, numerics in (
        ("policy", st.ScenarioSpec(modifiers=("insurance_cap", "suspension", "lolr")),
         st.make_model_params(insurance_cap=0.2, suspension_t=8.0, lolr_rate=0.1), "fixed"),
        ("policy", st.ScenarioSpec(modifiers=("insurance_cap", "suspension", "lolr")),
         st.make_model_params(insurance_cap=0.2, suspension_t=8.0, lolr_rate=0.1), "adaptive"),
        ("interest", st.ScenarioSpec(modifiers=("interest",)),
         st.make_interest_params(r=0.02, delta=0.1), "fixed"),
    ):
        cfg = st.SolverConfig(numerics=numerics, **SCEN_CFG)
        out = {dev: st.scenario_grid(spec, betas, us, base, config=cfg, device=dev)
               for dev in ("cpu", "cuda")}
        a, b = out["cpu"], out["cuda"]
        ints = {f: bool(torch.equal(x, y.cpu())) for f, x, y in (
            ("status", a.status, b.status), ("flags", a.health.flags, b.health.flags))}
        if numerics == "fixed":
            ints["iterations"] = bool(torch.equal(a.health.iterations, b.health.iterations.cpu()))
        gap = max(_nan_gap(x, y.cpu()) for x, y in ((a.xi, b.xi), (a.max_aw, b.max_aw)))
        emit("scenario_cpu_vs_card", case="grid", spec=spec.to_doc(), numerics=numerics,
             cells=24 * 24, n_grid=cfg.n_grid, equal=ints, max_abs=gap, tol=1e-12,
             runs=int((b.status == 0).sum()))
        if not all(ints.values()) or gap > 1e-12:
            raise AssertionError(f"scenario grid {name} {numerics}: card and CPU differ")
    cfg = st.SolverConfig(**SCEN_CFG)
    ring = tuple((i, (i + 1) % SCEN_BANKS, 0.6) for i in range(SCEN_BANKS))
    spec = st.ScenarioSpec(banks=SCEN_BANKS, exposure=ring, contagion_max_iter=12,
                           contagion_tol=1e-5)
    plist = [st.make_model_params(beta=1.0 + 0.5 * (i / (SCEN_BANKS - 1)), u=0.05)
             for i in range(SCEN_BANKS)]
    out = {dev: st.solve_multibank(spec, plist, config=cfg, device=dev) for dev in ("cpu", "cuda")}
    a, b = out["cpu"], out["cuda"]
    same = (a.iterations, a.converged) == (b.iterations, b.converged) and bool(
        torch.equal(a.status, b.status.cpu())) and bool(torch.equal(a.health.flags,
                                                                    b.health.flags.cpu()))
    gap = max(_nan_gap(getattr(a, f), getattr(b, f).cpu())
              for f in ("xi", "aw_max", "kappa_eff", "spillover"))
    emit("scenario_cpu_vs_card", case="multibank_ring", banks=SCEN_BANKS,
         iterations=[a.iterations, b.iterations], converged=[a.converged, b.converged],
         discrete_equal=same, max_abs=gap, tol=1e-12)
    if not same or gap > 1e-12:
        raise AssertionError("multibank: card and CPU differ")

    m = st.make_model_params(**FIG12)
    spec = st.InfoModelSpec(channel="bayes")
    fp = st.solve_fixed_point_info(spec, m, config=st.SolverConfig(n_grid=POP_GRID),
                                   max_iter=500, device="cpu")
    draw = engine._agent_fields

    def cpu_fields(spec_, n, seed, beta, dtype, device):
        return tuple(f.to(device) for f in draw(spec_, n, seed, beta, dtype, "cpu"))

    engine._agent_fields = cpu_fields
    try:
        kw = dict(seeds=4, vary="sim", seed=7, g0=None, fp=fp)
        graph = st.ErdosRenyiSpec(POP_N, POP_DEG)
        recs = {dev: population_query(spec, graph, m, device=dev, **kw) for dev in ("cpu", "cuda")}
    finally:
        engine._agent_fields = draw
    emit("scenario_cpu_vs_card", case="population", channel="bayes", n_agents=POP_N, members=4,
         equal=recs["cpu"] == recs["cuda"], crossing_times=recs["cuda"]["crossing_times"])
    if recs["cpu"] != recs["cuda"]:
        raise AssertionError(f"population: card and CPU records differ: {recs}")


# Panic rewiring at the bayes main path's shape (bench.py:1540-1553): 2×10^6
# agents, Erdős–Rényi mean degree 10, 100 steps of dt 0.05, reentry 3.0,
# x0 0.01, seed 1, float32; InfoModelSpec(dynamics="rewire") at its
# defaults (epochs of 25 steps, bias 4.0), in both channels.
REWIRE_N_CPU = 100_000


def _rewire_run(spec, graph, cfg):
    import sbr_tpu_torch as st

    return st.simulate_info(spec, graph, x0=0.01, config=cfg, seed=1)


def phase_rewire(card: str) -> dict:
    """The rewire main path in each channel at full width: a cold call,
    then a call with the kernel counts set to 0 before and read after (the
    channel's kernel exactly n_steps times, the other never), a second
    call held equal to it, one call with each layer fenced and timed (the
    tilt table, the tilted sources, the host in-degree draw, the
    simulation), and one profiled for the busy share. Then one rewire
    population query a channel at bench_infomodels' shape (20,000 agents,
    16 members, n_grid 256), its launches members × steps. Returns the
    launches by kernel."""
    import sbr_tpu_torch as st
    from sbr_tpu_torch import _build
    from sbr_tpu_torch.infomodels import engine, population_query
    from sbr_tpu_torch.social import agents, graphgen
    from sbr_tpu_torch.social.fused import BELIEF_KERNEL, KERNEL

    from sbr_tpu_torch.core.integrate import xla_cumsum

    graph = st.ErdosRenyiSpec(N_BAYES, 10.0)
    cfg = _bayes_config()
    totals = {KERNEL: 0, BELIEF_KERNEL: 0}
    # the tilt table's prefix sum in XLA's order against torch's own, on
    # the epoch table's shape (one float32 row of N_BAYES weights)
    w = torch.rand(N_BAYES, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    emit("rewire_prefix_sum", n=N_BAYES, dtype="float32",
         xla_cumsum_ms=time_ms(lambda: xla_cumsum(w), reps=20),
         torch_cumsum_ms=time_ms(lambda: torch.cumsum(w, 0), reps=20), card=card)
    for channel in ("gossip", "bayes"):
        spec = st.InfoModelSpec(channel=channel, dynamics="rewire")
        kernel, other = (BELIEF_KERNEL, KERNEL) if channel == "bayes" else (KERNEL, BELIEF_KERNEL)
        cold_s = _fenced(lambda: _rewire_run(spec, graph, cfg))[0]
        _build.reset_launches()
        call_s, res = _fenced(lambda: _rewire_run(spec, graph, cfg))
        launches = (_build.LAUNCHES[kernel], _build.LAUNCHES[other])
        again = _rewire_run(spec, graph, cfg)
        fields = ("informed", "t_inf", "informed_frac", "withdrawn_frac") + (
            ("belief",) if channel == "bayes" else ())
        same = all(torch.equal(getattr(res, f), getattr(again, f)) for f in fields)
        sim = (engine, "_bayes_sim") if channel == "bayes" else (agents, "simulate_agents")
        with _CallTimes((graphgen, "tilt_threshold_table"), (graphgen, "generate_tilted_sources"),
                        (graphgen, "epoch_indegrees"), sim) as spent:
            split_s = _fenced(lambda: _rewire_run(spec, graph, cfg))[0]
        prof = _profiled(lambda: _rewire_run(spec, graph, cfg), kernel)
        epochs = res.epochs
        per_epoch = {name: 1e3 * sum(v) / epochs for name, v in spent.items()}
        g = res.informed_frac.cpu().numpy()
        rate_key = "belief_updates_per_s" if channel == "bayes" else "agent_steps_per_s"
        emit("rewire", channel=channel, n=N_BAYES, steps=cfg.n_steps, dt=cfg.dt,
             epoch_steps=spec.epoch_steps, rewire_bias=spec.rewire_bias, epochs=epochs,
             edges_per_epoch=graph.edge_count(1), dtype="float32", cold_s=cold_s, call_s=call_s,
             **{rate_key: N_BAYES * cfg.n_steps / call_s},
             ms_per_epoch=1e3 * split_s / epochs,
             ms_per_epoch_table=per_epoch["tilt_threshold_table"],
             ms_per_epoch_sources=per_epoch["generate_tilted_sources"],
             ms_per_epoch_indegrees_host=per_epoch["epoch_indegrees"],
             ms_per_epoch_simulation=per_epoch[sim[1]],
             busy_share=prof["device_busy_share"], device_kernels=prof["device_kernels"],
             kernel=kernel, kernel_launches=launches[0], other_kernel_launches=launches[1],
             kernel_ms_profiled=prof["kernel_ms"], top=prof["top"][:5],
             two_calls_equal=same, final_informed_frac=float(g[-1]),
             final_withdrawn_frac=float(res.withdrawn_frac[-1]), card=card)
        if launches != (cfg.n_steps, 0) or not same or epochs != 4:
            raise AssertionError(f"rewire {channel}: launches {launches}, equal {same}, "
                                 f"epochs {epochs}")
        if not (np.all(np.diff(g) >= 0) and bool(torch.isfinite(res.informed_frac).all())):
            raise AssertionError(f"rewire {channel}: bad trajectory {g[:3]}..{g[-3:]}")
        totals[kernel] += launches[0]

    m = st.make_model_params(**FIG12)
    steps = max(int(round(float(m.economic.eta) / 0.1)), 2)
    for channel in ("bayes", "gossip"):
        spec = st.InfoModelSpec(channel=channel, dynamics="rewire")
        kernel, other = (BELIEF_KERNEL, KERNEL) if channel == "bayes" else (KERNEL, BELIEF_KERNEL)
        _build.reset_launches()
        query_s, rec = _fenced(lambda: population_query(
            spec, st.ErdosRenyiSpec(POP_N, POP_DEG), m, seeds=POP_SEEDS, vary="sim", seed=3,
            config=st.SolverConfig(n_grid=POP_GRID), g0=None))
        launches = (_build.LAUNCHES[kernel], _build.LAUNCHES[other])
        emit("rewire_population", channel=channel, n_agents=POP_N, members=POP_SEEDS,
             steps=steps, n_grid=POP_GRID, query_s=query_s, kernel=kernel,
             kernel_launches=launches[0], other_kernel_launches=launches[1],
             expected_launches=POP_SEEDS * steps, run_probability=rec["run_probability"],
             xi_meanfield=rec["xi_meanfield"], dynamics=rec["dynamics"], card=card)
        if launches != (POP_SEEDS * steps, 0) or rec["dynamics"] != "rewire":
            raise AssertionError(f"rewire population {channel}: launches {launches}")
        totals[kernel] += launches[0]
    return totals


def phase_rewire_cpu_vs_card() -> None:
    """The card against the CPU, bit for bit: the tilt table and the tilted
    sources of Erdős–Rényi and scale-free bases at 10^5 agents (a random
    withdrawn mask, bias 4), and whole rewire runs on 2×10^4 agents (4
    epochs of 10 steps): gossip on both bases, bayes with the CPU's fields
    on both devices, float32 and float64."""
    import sbr_tpu_torch as st
    from sbr_tpu_torch.infomodels import engine
    from sbr_tpu_torch.social import graphgen

    n = REWIRE_N_CPU
    wd = torch.from_numpy(np.random.default_rng(4).random(n) < 0.2)
    for spec in (st.ErdosRenyiSpec(n, 10.0), st.ScaleFreeSpec(n, 10.0)):
        out = {}
        for dev in ("cpu", "cuda"):
            thr = graphgen.tilt_threshold_table(engine._base_source_weights(spec, dev),
                                                wd.to(dev), 4.0)
            src = graphgen.generate_tilted_sources(n, spec.edge_count(5),
                                                   graphgen.epoch_key_words(5, 1), thr)
            out[dev] = (thr.cpu(), src.cpu())
        same = {"table": bool(torch.equal(out["cpu"][0], out["cuda"][0])),
                "sources": bool(torch.equal(out["cpu"][1], out["cuda"][1]))}
        emit("rewire_cpu_vs_card", case="table_sources", spec=type(spec).__name__, n=n,
             edges=spec.edge_count(5), bitwise=same,
             saturated_tail=int((out["cuda"][0] == 2**32 - 1).sum()))
        if not all(same.values()):
            raise AssertionError(f"{type(spec).__name__}: tilt table or sources differ: {same}")
    n = 20_000
    cfg = st.AgentSimConfig(n_steps=40, dt=0.05, reentry_delay=1.0)
    for channel, graph, np_dtype in (
        ("gossip", st.ErdosRenyiSpec(n, 8.0), np.float32),
        ("gossip", st.ScaleFreeSpec(n, 8.0), np.float64),
        ("bayes", st.ErdosRenyiSpec(n, 8.0), np.float32),
        ("bayes", st.ErdosRenyiSpec(n, 8.0), np.float64),
    ):
        spec = st.InfoModelSpec(channel=channel, dynamics="rewire", epoch_steps=10)
        cpu_f = [f.numpy() for f in engine._agent_fields(spec, n, 2, 1.5, np_dtype, "cpu")]
        kw = dict(beta=1.5, x0=0.01, config=cfg, seed=2, dtype=np_dtype)
        out = {dev: st.simulate_info(spec, graph, device=dev,
                                     fields=engine.agent_fields_from_numpy(*cpu_f, dev), **kw)
               for dev in ("cpu", "cuda")}
        a, b = out["cpu"], out["cuda"]
        names = ("informed", "t_inf", "informed_frac", "withdrawn_frac") + (
            ("belief",) if channel == "bayes" else ())
        same = {f: bool(torch.equal(getattr(a, f), getattr(b, f).cpu())) for f in names}
        emit("rewire_cpu_vs_card", case="simulation", channel=channel,
             spec=type(graph).__name__, n=n, steps=cfg.n_steps, epochs=b.epochs,
             dtype=np.dtype(np_dtype).name, bitwise=same, informed=int(b.informed.sum()))
        if not all(same.values()) or a.epochs != b.epochs:
            raise AssertionError(f"rewire {channel}: CPU and card runs differ: {same}")


# The gradient layer at bench_grad's accelerator shape (bench.py:1336-1390).
GRAD_N = 96
GRAD_CFG = dict(n_grid=1024, bisect_iters=60, refine_crossings=False)
GRAD_CALIB_STEPS = 120
GRAD_STREAM = 256  # distinct served grads queries
GRAD_CPU_N = 16
GRAD_CPU_RTOL = 1e-10


def _grad_surface_rows(card: str) -> None:
    """`sensitivity_surface` over 96×96 (β in [0.5, 2.5], u in [0.03, 0.3])
    wrt (β, u, κ) on make_model_params(): a cold call, then 3 calls on
    shifted u axes (bench.py's), the fastest giving partials/s; its ξ grid
    against `beta_u_grid` on the same axes, bit for bit; a profiled call's
    busy share; the peak memory."""
    import sbr_tpu_torch as st
    from sbr_tpu_torch import grad

    cfg = st.SolverConfig(**GRAD_CFG)
    base = st.make_model_params()
    betas = np.linspace(0.5, 2.5, GRAD_N)

    def dispatch(rep):
        us = np.linspace(0.03, 0.3, GRAD_N) + rep * 1e-7
        return grad.sensitivity_surface(betas, us, base, config=cfg)

    torch.cuda.reset_peak_memory_stats()
    cold_s, surf = _fenced(lambda: dispatch(0))
    times = [_fenced(lambda r=rep: dispatch(r))[0] for rep in range(1, 4)]
    peak = torch.cuda.max_memory_allocated()
    grid = st.beta_u_grid(betas, np.linspace(0.03, 0.3, GRAD_N), base, config=cfg)
    same = bool(torch.equal(torch.isnan(grid.xi), torch.isnan(surf.xi))) and bool(
        torch.equal(torch.nan_to_num(grid.xi), torch.nan_to_num(surf.xi))) and bool(
        torch.equal(grid.status, surf.status))
    grid_s = _fenced(lambda: st.beta_u_grid(betas, np.linspace(0.03, 0.3, GRAD_N), base,
                                            config=cfg))[0]
    prof = _profiled(lambda: dispatch(5))
    census = grad.flag_census(surf.status, surf.flags)
    cells = GRAD_N * GRAD_N
    emit("grad_surface", cells=cells, wrt=["beta", "u", "kappa"], numerics=cfg.numerics,
         dtype="float64", cold_s=cold_s, call_s=min(times), calls_s=times,
         partials_per_s=3 * cells / min(times), cells_per_s=cells / min(times),
         beta_u_grid_s=grid_s, xi_equal_beta_u_grid=same, peak_bytes=peak,
         busy_share=prof["device_busy_share"], device_kernels=prof["device_kernels"],
         census=census, card=card)
    finite = all(bool(torch.isfinite(g[(surf.flags == 0)]).all()) for g in surf.grads.values())
    if not same or census["nonfinite_run"] or not finite or census["run_cells"] == 0:
        raise AssertionError(f"sensitivity surface: xi equal {same}, census {census}")


def _grad_calibration_rows(card: str) -> None:
    """`fit_withdrawals` on the `synth_withdrawals` fixture (θ* β 1.4, u
    0.12, κ 0.55; n_obs 48): bench.py's start (β 1.1, u 0.15, κ 0.62) for
    120 steps at loss_tol 0 after one untimed step, giving steps/s (the
    reference's own fit stalls from that start in a no-run region, and so
    does the port's, test_torch_grad); then the start of the reference
    tests' second fixture (1.2, 0.14, 0.6), which must converge to θ*."""
    import sbr_tpu_torch as st
    from sbr_tpu_torch import grad

    cfg = st.SolverConfig(**GRAD_CFG)
    truth = st.make_model_params(beta=1.4, u=0.12, kappa=0.55)
    t_obs, aw_obs, xi_obs = grad.synth_withdrawals(truth, n_obs=48, config=cfg)
    for name, start, steps, tol in (("bench", dict(beta=1.1, u=0.15, kappa=0.62),
                                     GRAD_CALIB_STEPS, 0.0),
                                    ("recovery", dict(beta=1.2, u=0.14, kappa=0.6), 400, 1e-12)):
        init = st.with_overrides(truth, **start)
        grad.fit_withdrawals(t_obs, aw_obs, init, xi_obs=xi_obs, steps=1, config=cfg)
        fit_s, fit = _fenced(lambda: grad.fit_withdrawals(
            t_obs, aw_obs, init, xi_obs=xi_obs, steps=steps, loss_tol=tol, config=cfg))
        err = {k: abs(fit.params[k] - v) / v for k, v in (("beta", 1.4), ("u", 0.12),
                                                           ("kappa", 0.55))}
        emit("grad_calibration", fixture=name, start=start, n_obs=48, steps_budget=steps,
             steps=fit.steps, seconds=fit_s, calib_steps_per_s=fit.steps / fit_s,
             converged=fit.converged, loss=fit.loss, params=fit.params, rel_err=err,
             numerics=cfg.numerics, card=card)
        if name == "recovery" and not (fit.converged and max(err.values()) < 1e-3):
            raise AssertionError(f"calibration did not recover θ*: {fit.params}")


def _grad_served_stream(card: str) -> None:
    """A stream of 256 distinct grads queries in groups of 16 through the
    started engine at bench.py's serving config (n_grid 1024, 60
    iterations, buckets 1/8/64; each bucket's grads program captured before
    the stream), p50/p99 from the engine's latency histogram; then the
    answers held bit for bit to `cell_value_and_grads` run eagerly on the
    card, and ξ to the plain served answers."""
    from sbr_tpu_torch.grad.api import WRT_DEFAULT, cell_value_and_grads
    from sbr_tpu_torch.grad.cell import BASE_KEYS
    from sbr_tpu_torch.models.params import SolverConfig
    from sbr_tpu_torch.serve import Engine, ServeConfig
    from sbr_tpu_torch.serve.engine import _query_columns
    from sbr_tpu_torch.serve.loadgen import build_pool

    config = SolverConfig(**GRAD_CFG)
    pool = build_pool(7, GRAD_STREAM)
    engine = Engine(config=config, serve=ServeConfig(buckets=(1, 8, 64)), device="cuda")
    engine.start()
    try:
        t0 = time.perf_counter()
        for n in (1, 8, 64):
            engine.query_many(build_pool(300 + n, n), grads=True, timeout=600)
        capture_s = time.perf_counter() - t0
        warm = engine.live.snapshot()
        hist_before = engine.live.total_hist.copy()
        t0 = time.perf_counter()
        results = []
        for i in range(0, len(pool), 16):
            results += engine.query_many(pool[i : i + 16], grads=True, scenario="grads",
                                         timeout=600)
        stream_s = time.perf_counter() - t0
        snap = engine.live.snapshot()
        diff = engine.live.total_hist.delta(hist_before)
        plain = engine.query_many(pool, timeout=600)
    finally:
        engine.close()
    cols = torch.tensor(_query_columns(pool, np.float64), device="cuda")
    _, _, grads, _, _, gflags = cell_value_and_grads(dict(zip(BASE_KEYS, cols)), WRT_DEFAULT,
                                                     config, torch.float64)
    eager = torch.stack([grads[k] for k in WRT_DEFAULT]).cpu().numpy()
    served = np.array([[r.grads[k] for k in WRT_DEFAULT] for r in results]).T
    same = _bits_equal(served, eager) and [r.grad_flags for r in results] == [
        int(f) for f in gflags.cpu()]
    xi_same = _bits_equal(np.array([r.xi for r in results]), np.array([r.xi for r in plain]))
    new_captures = snap["graphs"]["captures"] - warm["graphs"]["captures"]
    row = dict(queries=len(results), group=16, buckets=[1, 8, 64], n_grid=config.n_grid,
               bisect_iters=config.bisect_iters, numerics=config.numerics, dtype="float64",
               capture_s=capture_s, stream_s=stream_s, qps=len(results) / stream_s,
               p50_ms=diff.quantile(0.5), p99_ms=diff.quantile(0.99), graphs=snap["graphs"],
               post_warmup_graph_captures=new_captures, grads_equal_eager=same,
               xi_equal_plain=xi_same, untrusted=sum(bool(r.grad_flags) for r in results),
               card=card)
    emit("grad_served_stream", **row)
    if not (same and xi_same and new_captures == 0 and snap["graphs"]["eager_runs"] == 0
            and all(r.source == "computed" for r in results)):
        raise AssertionError(f"served grads: {row}")


def phase_grad(card: str) -> None:
    """The gradient layer on the card (it runs no kernel of the port): the
    sensitivity surface, the calibration and a served grads stream."""
    _grad_surface_rows(card)
    _grad_calibration_rows(card)
    _grad_served_stream(card)


def phase_grad_cpu_vs_card() -> None:
    """A 16×16 sensitivity subgrid of the surface's axes at its config on
    the card and on the CPU: statuses and flags exactly, ξ within 1e-12,
    the partials of trusted cells within GRAD_CPU_RTOL relative."""
    import sbr_tpu_torch as st
    from sbr_tpu_torch import grad

    cfg = st.SolverConfig(**GRAD_CFG)
    betas = np.linspace(0.5, 2.5, GRAD_CPU_N)
    us = np.linspace(0.03, 0.3, GRAD_CPU_N)
    out = {dev: grad.sensitivity_surface(betas, us, st.make_model_params(), config=cfg,
                                         device=dev) for dev in ("cpu", "cuda")}
    a, b = out["cpu"], out["cuda"]
    ints = {"status": bool(torch.equal(a.status, b.status.cpu())),
            "flags": bool(torch.equal(a.flags, b.flags.cpu()))}
    trusted = (a.flags == 0) & (a.status == 0)
    rel = max(float(((x - y.cpu()).abs() / x.abs())[trusted].max())
              for x, y in ((a.grads[k], b.grads[k]) for k in a.grads))
    gap = _nan_gap(a.xi, b.xi.cpu())
    emit("grad_cpu_vs_card", cells=GRAD_CPU_N ** 2, trusted=int(trusted.sum()), equal=ints,
         xi_max_abs=gap, grads_max_rel=rel, tol_xi=1e-12, tol_grads_rel=GRAD_CPU_RTOL)
    if not all(ints.values()) or gap > 1e-12 or rel > GRAD_CPU_RTOL:
        raise AssertionError(f"grads: card and CPU differ ({ints}, {gap}, {rel})")


def _nan_gap(a, b) -> float:
    """Max |a − b| over the finite entries; raises if the NaNs differ."""
    a, b = a.double(), b.double()
    if not torch.equal(torch.isnan(a), torch.isnan(b)):
        raise AssertionError("NaN positions differ")
    ok = ~torch.isnan(a)
    return float((a[ok] - b[ok]).abs().max()) if bool(ok.any()) else 0.0


# Slice 10: the tiled, checkpointed sweep. The paper-resolution Figure-5
# heatmap (figures/master.py:186-218: 5000×5000 in 500×500 tiles, f32,
# config=None), bench.py's bench_sweep accelerator shape (:1260-1296) and
# bench_scenario's grid in 128×128 tiles.
PAPER_RES, PAPER_TILE = 5000, 500
PAPER_PARAMS = dict(beta=1.0, eta_bar=15.0, u=0.1, p=0.5, kappa=0.6, lam=0.01)
SUB_RES = 2 * PAPER_TILE  # the sub-sweep and the fault drill: the first 4 tiles
BENCH_SWEEP_N, BENCH_SWEEP_TILE = 128, 64
BENCH_SWEEP_CFG = dict(n_grid=1024, bisect_iters=60, refine_crossings=False)
SERVED_POINTS = 64
SCEN_TILE = 128
TILED_CPU_SHAPE, TILED_CPU_TILE = (24, 20), (7, 6)
TILED_CPU_TOL = {torch.float64: 1e-12, torch.float32: 2e-5}
TILED_DEVICE = "cuda"

_REPO_ROOT = __import__("pathlib").Path(__file__).resolve().parent

# A port process on the card for the drills: runs one sweep through
# run_tiled_grid_multihost (elastic) from a JSON job on argv and prints its
# report; with "ready" set it waits for its peer before claiming.
_SWEEP_WORKER = r"""
import json, os, sys, time
import numpy as np
import torch
import sbr_tpu_torch as st
from sbr_tpu_torch.parallel import run_tiled_grid_multihost

job = json.loads(sys.argv[1])
torch.zeros(1, device=job["device"])
if job.get("ready"):
    open(job["ready"][0], "w").close()
    deadline = time.monotonic() + 120.0
    while not all(os.path.exists(p) for p in job["ready"]):
        if time.monotonic() > deadline:
            sys.exit("the peer never started")
        time.sleep(0.01)
cfg = st.SolverConfig(**job["config"]) if job["config"] else None
dtype = getattr(torch, job["dtype"]) if job["dtype"] else None
report = {}
grid = run_tiled_grid_multihost(
    np.asarray(job["betas"]), np.asarray(job["us"]), st.make_model_params(**job["params"]),
    job["ckpt"], config=cfg, tile_shape=tuple(job["tile"]), dtype=dtype, poll_s=0.05,
    timeout_s=600.0, device=job["device"], report=report)
if job.get("out"):
    np.savez(job["out"], **{f: getattr(grid, f).numpy() for f in ("max_aw", "xi", "status")})
print("REPORT " + json.dumps(report), flush=True)
"""


def _sweep_workers(jobs, timeout_s: float = 300.0, env_extra=None) -> list:
    """Run one port process on the card a job, all at once; returns
    (returncode, output) a job. Every process is killed if it outlives
    ``timeout_s``."""
    import os

    env = {**os.environ, "PYTHONPATH": str(_REPO_ROOT), **(env_extra or {})}
    env.pop("SBR_TILE_CACHE_DIR", None)
    procs = [subprocess.Popen([sys.executable, "-c", _SWEEP_WORKER, json.dumps(job)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env, cwd=str(_REPO_ROOT)) for job in jobs]
    out = []
    try:
        for proc in procs:
            text, _ = proc.communicate(timeout=timeout_s)
            out.append((proc.returncode, text))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    return out


def _worker_report(text: str) -> dict:
    line = next(ln for ln in text.splitlines() if ln.startswith("REPORT "))
    return json.loads(line[len("REPORT "):])


def _grid_bytes(grid) -> dict:
    return {f: getattr(grid, f).cpu().numpy().tobytes() for f in ("max_aw", "xi", "status")}


def _same_bytes(a, b) -> bool:
    a = a if isinstance(a, dict) else _grid_bytes(a)
    b = b if isinstance(b, dict) else _grid_bytes(b)
    return a == b


def _launches() -> dict:
    from sbr_tpu_torch import _build
    from sbr_tpu_torch.social.fused import BELIEF_KERNEL, KERNEL
    from sbr_tpu_torch.social.recount import KERNEL as RECOUNT_KERNEL

    return {k: _build.LAUNCHES[k] for k in (KERNEL, BELIEF_KERNEL, RECOUNT_KERNEL)}


def _tiled_paper(card: str, scratch) -> dict:
    """The paper heatmap cold (save and sidecar timed a tile), the resume
    with every tile local, four tiles and a 1000×1000 sub-sweep bit for bit
    against `beta_u_grid`. Returns the sub-sweep's bytes."""
    import sbr_tpu_torch as st
    from sbr_tpu_torch.resilience import heal
    from sbr_tpu_torch.utils import checkpoint as ckpt
    from sbr_tpu_torch.utils.status import status_counts

    betas, us = _figure5_axes(PAPER_RES)
    base = st.make_model_params(**PAPER_PARAMS)
    tile = (PAPER_TILE, PAPER_TILE)
    n_tiles = (PAPER_RES // PAPER_TILE) ** 2
    kw = dict(tile_shape=tile, checkpoint_dir=str(scratch / "paper"), dtype=torch.float32)
    report = {}
    with _CallTimes((ckpt, "_save_atomic"), (heal, "write_sidecar"),
                    (ckpt, "to_host")) as spent:
        cold_s, grid = _fenced(lambda: ckpt.run_tiled_grid(betas, us, base, report=report, **kw))
    tile_bytes = sum((scratch / "paper" / f"tile_b{bi:05d}_u{ui:05d}.npz").stat().st_size
                     for bi, ui in ckpt.tile_origins(PAPER_RES, PAPER_RES, tile)) / n_tiles
    resume_report = {}
    resume_s, again = _fenced(lambda: ckpt.run_tiled_grid(betas, us, base,
                                                          report=resume_report, **kw))
    # two corners, an interior tile and the tile nearest β = 10^4 (β[0])
    last, mid = PAPER_RES - PAPER_TILE, PAPER_TILE * (PAPER_RES // PAPER_TILE // 2)
    checks = {}
    for bi, ui in ((0, last), (last, 0), (mid, mid), (0, 0)):
        mono = st.beta_u_grid(betas[bi:bi + PAPER_TILE], us[ui:ui + PAPER_TILE], base,
                              dtype=torch.float32)
        checks[f"b{bi}_u{ui}"] = all(
            getattr(grid, f)[bi:bi + PAPER_TILE, ui:ui + PAPER_TILE].numpy().tobytes()
            == getattr(mono, f).cpu().numpy().tobytes() for f in ("max_aw", "xi", "status"))
    sub_b, sub_u = betas[:SUB_RES], us[:SUB_RES]
    sub_tiled_s, sub = _fenced(lambda: ckpt.run_tiled_grid(
        sub_b, sub_u, base, tile_shape=tile, checkpoint_dir=str(scratch / "sub"),
        dtype=torch.float32))
    sub_mono_s, sub_mono = _fenced(lambda: st.beta_u_grid(sub_b, sub_u, base,
                                                           dtype=torch.float32))
    sub_same = _same_bytes(sub, sub_mono)
    status = grid.status
    emit("tiled_paper_heatmap", cells=PAPER_RES ** 2, tile=list(tile), tiles=n_tiles,
         dtype="float32", numerics=st.SolverConfig().numerics, cold_s=cold_s,
         cold_cells_per_s=PAPER_RES ** 2 / cold_s, counts=report["counts"],
         save_ms_per_tile=1e3 * sum(spent["_save_atomic"]) / n_tiles,
         sidecar_ms_per_tile=1e3 * sum(spent["write_sidecar"]) / n_tiles,
         host_copy_ms_per_tile=1e3 * sum(spent["to_host"]) / len(spent["to_host"]),
         tile_bytes=tile_bytes, resume_s=resume_s, resume_counts=resume_report["counts"],
         resume_equal=_same_bytes(grid, again), status_counts=status_counts(status),
         finite_xi=int(torch.isfinite(grid.xi).sum()), tiles_vs_beta_u_grid=checks,
         sub_cells=SUB_RES ** 2, sub_tiled_s=sub_tiled_s, sub_mono_s=sub_mono_s,
         sub_bitwise=sub_same, card=card)
    run = status == 0
    if not (report["counts"]["computed"] == n_tiles and resume_report["counts"]["local"] == n_tiles
            and _same_bytes(grid, again) and all(checks.values()) and sub_same):
        raise AssertionError(f"paper heatmap: counts {report['counts']} / "
                             f"{resume_report['counts']}, tiles {checks}, sub {sub_same}")
    if not (bool(torch.isfinite(grid.xi[run]).all()) and bool(run.any())
            and not bool(torch.isfinite(grid.xi[~run]).any())):
        raise AssertionError("paper heatmap: ξ finite exactly on RUN cells fails")
    return _grid_bytes(sub)


def _tiled_drill(card: str, scratch, clean: dict) -> None:
    """The paper shape's first 4 tiles under a seeded fault plan (a
    transient compute, a NaN result, a torn save), resumed; then a port
    subprocess on the card preempted by SIGTERM between two tiles, and
    resumed. Both end byte-identical to the fault-free sub-sweep."""
    import sbr_tpu_torch as st
    from sbr_tpu_torch.resilience import FaultPlan, faults, heal
    from sbr_tpu_torch.utils import checkpoint as ckpt

    betas, us = _figure5_axes(PAPER_RES)
    sub_b, sub_u = betas[:SUB_RES], us[:SUB_RES]
    base = st.make_model_params(**PAPER_PARAMS)
    kw = dict(tile_shape=(PAPER_TILE, PAPER_TILE), dtype=torch.float32)
    drill = scratch / "drill"
    faults.install(FaultPlan({"seed": 10, "rules": [
        {"point": "tile.compute", "kind": "transient", "at_hits": [1]},
        {"point": "tile.result", "kind": "nan", "at_hits": [2], "cells": 2},
        {"point": "checkpoint.save", "kind": "corrupt", "at_hits": [3]},
    ]}))
    import os
    os.environ["SBR_RETRY_BASE_DELAY_S"] = "0.01"
    try:
        report = {}
        faulted_s, faulted = _fenced(lambda: ckpt.run_tiled_grid(
            sub_b, sub_u, base, checkpoint_dir=str(drill), report=report, **kw))
        firings = [f["kind"] for f in faults.plan().firings]
    finally:
        faults.install(None)
        os.environ.pop("SBR_RETRY_BASE_DELAY_S", None)
    repairs = report["repairs"]
    resume_report = {}
    resumed = ckpt.run_tiled_grid(sub_b, sub_u, base, checkpoint_dir=str(drill),
                                  report=resume_report, **kw)
    quarantined = sorted(p.name for p in (drill / "quarantine").glob("*.npz"))

    # ms a rung: the ladder on two poisoned cells of the first tile
    first = {f: np.frombuffer(clean[f], dtype=np.float32 if f != "status" else np.int32)
             .reshape(SUB_RES, SUB_RES)[:PAPER_TILE, :PAPER_TILE].copy()
             for f in ("max_aw", "xi", "status")}
    flags = np.zeros((PAPER_TILE, PAPER_TILE), np.int32)
    for k in range(2):
        first["xi"][0, k] = first["max_aw"][0, k] = np.nan
        flags[0, k] = 1 << 7
    ladder_s, ladder = _fenced(lambda: heal.repair_divergent(
        sub_b[:PAPER_TILE], sub_u[:PAPER_TILE], base, st.SolverConfig(refine_crossings=False),
        torch.float32, first, flags, device=TILED_DEVICE))
    rungs = sum(r["rung"] + 1 for r in ladder if r["repaired"])

    # SIGTERM to a port process on the card before its third tile
    sig_dir = scratch / "sigterm"
    plan = {"seed": 0, "rules": [{"point": "tile.compute", "kind": "preempt", "at_hits": [3]}]}
    job = dict(betas=sub_b.tolist(), us=sub_u.tolist(), params=PAPER_PARAMS, config=None,
               dtype="float32", tile=[PAPER_TILE, PAPER_TILE], ckpt=str(sig_dir),
               device=TILED_DEVICE)
    t0 = time.perf_counter()
    (rc, out), = _sweep_workers([job], env_extra={"SBR_FAULT_PLAN": json.dumps(plan)})
    sig_s = time.perf_counter() - t0
    left = {pat: sorted(p.name for p in sig_dir.glob(pat))
            for pat in ("*.tmp", "*.lease", "host_*.hb")}
    landed = len(list(sig_dir.glob("tile_*.npz")))
    sig_report = {}
    sig_resumed = ckpt.run_tiled_grid(sub_b, sub_u, base, checkpoint_dir=str(sig_dir),
                                      report=sig_report, **kw)
    same = {"faulted": _same_bytes(faulted, clean), "resumed": _same_bytes(resumed, clean),
            "sigterm_resumed": _same_bytes(sig_resumed, clean)}
    emit("tiled_fault_drill", cells=SUB_RES ** 2, tiles=4, firings=firings,
         faulted_s=faulted_s, repairs=repairs, resume_counts=resume_report["counts"],
         quarantined=quarantined, ladder_cells=len(ladder), ladder_rungs=rungs,
         ladder_s=ladder_s, ms_per_rung=1e3 * ladder_s / max(rungs, 1),
         sigterm_exit=rc, sigterm_process_s=sig_s, sigterm_tiles_landed=landed,
         sigterm_left=left, sigterm_resume_counts=sig_report["counts"], byte_identical=same,
         card=card)
    if not (firings == ["transient", "nan", "corrupt"] and len(repairs) == 2
            and all(r["repaired"] for r in repairs) and len(quarantined) == 1
            and resume_report["counts"] == {"local": 3, "cache": 0, "computed": 1}
            and all(r["repaired"] for r in ladder) and len(ladder) == 2):
        raise AssertionError(f"fault drill: {firings}, {repairs}, {quarantined}, "
                             f"{resume_report['counts']}, {ladder}")
    if rc != 143 or any(left.values()) or landed != 2 or sig_report["counts"]["computed"] != 2:
        raise AssertionError(f"SIGTERM drill: exit {rc}, left {left}, landed {landed}\n{out}")
    if not all(same.values()):
        raise AssertionError(f"fault drill: not byte-identical to the fault-free grid: {same}")


def _tiled_bench_sweep(card: str, scratch) -> tuple:
    """bench_sweep's accelerator shape, elastic with a tile cache: cold, warm
    into a fresh checkpoint directory (0 tiles computed), and two port
    processes on the card sharing one directory. Returns (grid, cache)."""
    import sbr_tpu_torch as st
    from sbr_tpu_torch.parallel import run_tiled_grid_multihost

    betas = np.linspace(0.5, 2.0, BENCH_SWEEP_N)
    us = np.linspace(0.02, 0.5, BENCH_SWEEP_N)
    cfg = st.SolverConfig(**BENCH_SWEEP_CFG)
    base = st.make_model_params()
    cache = scratch / "tile_cache"
    tile = (BENCH_SWEEP_TILE, BENCH_SWEEP_TILE)
    cells = BENCH_SWEEP_N ** 2

    def run(name, report):
        return run_tiled_grid_multihost(betas, us, base, str(scratch / name), config=cfg,
                                        tile_shape=tile, poll_s=0.1, timeout_s=600.0,
                                        elastic=True, tile_cache_dir=str(cache), report=report)

    cold_report, warm_report = {}, {}
    cold_s, cold = _fenced(lambda: run("ck_cold", cold_report))
    warm_s, warm = _fenced(lambda: run("ck_warm", warm_report))
    two = scratch / "ck_two"
    ready = [str(scratch / "ready_0"), str(scratch / "ready_1")]
    jobs = [dict(betas=betas.tolist(), us=us.tolist(), params={}, config=BENCH_SWEEP_CFG,
                 dtype=None, tile=list(tile), ckpt=str(two), ready=ready[i:] + ready[:i],
                 out=str(scratch / f"two_{i}.npz"), device=TILED_DEVICE) for i in range(2)]
    t0 = time.perf_counter()
    results = _sweep_workers(jobs)
    two_s = time.perf_counter() - t0
    claimed, two_same = [], []
    for i, (rc, out) in enumerate(results):
        if rc != 0:
            raise AssertionError(f"two-process sweep: worker {i} exited {rc}\n{out}")
        rep = _worker_report(out)
        claimed.append({"host": rep["host"], "claimed": rep["claimed"], "counts": rep["counts"]})
        with np.load(scratch / f"two_{i}.npz") as data:
            two_same.append(_same_bytes({f: data[f].tobytes() for f in data.files}, cold))
    emit("tiled_bench_sweep", cells=cells, tile=list(tile), tiles=4, config=BENCH_SWEEP_CFG,
         dtype="float64", cold_s=cold_s, cold_cells_per_s=cells / cold_s,
         cold_counts=cold_report["counts"], warm_s=warm_s, warm_cells_per_s=cells / warm_s,
         warm_counts=warm_report["counts"], warm_byte_identical=_same_bytes(warm, cold),
         two_process_s=two_s, two_process_claims=claimed, two_process_byte_identical=two_same,
         card=card)
    n_claimed = sum(len(c["claimed"]) for c in claimed)
    if not (cold_report["counts"]["computed"] == 4 and warm_report["counts"]["computed"] == 0
            and warm_report["counts"]["cache"] == 4 and _same_bytes(warm, cold)
            and all(two_same) and n_claimed >= 4):
        raise AssertionError(f"bench_sweep: {cold_report['counts']}, {warm_report['counts']}, "
                             f"{claimed}, {two_same}")
    return cold, cache, betas, us, cfg, base


def _tiled_served(card: str, swept) -> None:
    """The serving ladder's tile-cache rung over the warm cache:
    ``serve.dispatch`` fails at p = 1, 64 grid points answer degraded bit
    for bit the sweep's cells, a point off the grid fails and counts
    ``ladder_exhausted``."""
    import os

    import sbr_tpu_torch as st
    from sbr_tpu_torch.resilience import FaultPlan, faults
    from sbr_tpu_torch.serve import Engine, ServeConfig

    grid, cache, betas, us, cfg, base = swept
    pick = np.random.default_rng(10).choice(BENCH_SWEEP_N ** 2, SERVED_POINTS, replace=False)
    cells = [divmod(int(k), BENCH_SWEEP_N) for k in pick]
    queries = [st.make_model_params(beta=float(betas[i]), u=float(us[j]),
                                    eta=base.economic.eta, tspan=base.learning.tspan,
                                    x0=base.learning.x0) for i, j in cells]
    os.environ["SBR_TILE_CACHE_DIR"] = str(cache)
    os.environ["SBR_SERVE_RETRY_BASE_DELAY_S"] = "0"
    faults.install(FaultPlan({"seed": 0, "rules": [
        {"point": "serve.dispatch", "kind": "transient", "p": 1.0}]}))
    try:
        engine = Engine(config=cfg, serve=ServeConfig(buckets=(1, 8, 64)), device=TILED_DEVICE)
        try:
            call_s, res = _fenced(lambda: engine.query_many(queries, timeout=300))
            again_s, again = _fenced(lambda: engine.query_many(queries, timeout=300))
            off_error = None
            try:
                engine.query(st.make_model_params(beta=1.2345, u=0.3333), timeout=300)
            except RuntimeError as err:
                off_error = type(err).__name__
            health = engine.healthz()
            ladder = engine.statz()["ladder"]
        finally:
            engine.close()
    finally:
        faults.install(None)
        os.environ.pop("SBR_TILE_CACHE_DIR", None)
        os.environ.pop("SBR_SERVE_RETRY_BASE_DELAY_S", None)
    xi, aw, st_ = (getattr(grid, f).numpy() for f in ("xi", "max_aw", "status"))
    exact = all(r.degraded and r.source == "tilecache"
                and _bits_equal(np.float64(r.xi), np.float64(xi[i, j]))
                and _bits_equal(np.float64(r.aw_max), np.float64(aw[i, j]))
                and r.status == int(st_[i, j]) for r, (i, j) in zip(res, cells))
    lat_ms = sorted(1e3 * r.latency_s for r in again)
    emit("tiled_served_rung", queries=SERVED_POINTS, degraded=sum(r.degraded for r in res),
         bitwise=exact, first_call_s=call_s, call_s=again_s,
         latency_p50_ms=lat_ms[len(lat_ms) // 2], latency_max_ms=lat_ms[-1],
         off_grid_error=off_error, ladder=ladder, healthz=health, card=card)
    if not (exact and off_error is not None and ladder["ladder_exhausted"] == 1
            and ladder["degraded"] == 2 * SERVED_POINTS and health["status"] == "degraded"):
        raise AssertionError(f"served rung: exact {exact}, off {off_error}, {ladder}, {health}")


def _tiled_scenarios(card: str, scratch) -> None:
    """bench_scenario's 256×256 grid in 128×128 tiles through
    `run_tiled_scenario_grid`: the reducible spec and the policy spec, each
    bit for bit `scenario_grid` on the same axes."""
    import sbr_tpu_torch as st

    cfg = st.SolverConfig(**SCEN_CFG)
    betas, us = np.linspace(0.25, 3.0, SCEN_N), np.linspace(0.01, 0.99, SCEN_N)
    cases = (
        ("reducible", st.ScenarioSpec(), st.make_model_params()),
        ("policy", st.ScenarioSpec(modifiers=("insurance_cap", "suspension", "lolr")),
         st.make_model_params(insurance_cap=0.2, suspension_t=8.0, lolr_rate=0.1)),
    )
    for name, spec, base in cases:
        report = {}
        tiled_s, tiled = _fenced(lambda: st.run_tiled_scenario_grid(
            spec, betas, us, base, checkpoint_dir=str(scratch / f"scen_{name}"), config=cfg,
            dtype=torch.float32, tile_shape=(SCEN_TILE, SCEN_TILE), report=report))
        grid_s, grid = _fenced(lambda: st.scenario_grid(spec, betas, us, base, config=cfg,
                                                         dtype=torch.float32))
        same = _same_bytes(tiled, grid)
        emit("tiled_scenario", case=name, cells=SCEN_N ** 2, tile=[SCEN_TILE, SCEN_TILE],
             dtype="float32", tiled_s=tiled_s, scenario_grid_s=grid_s, counts=report["counts"],
             bitwise_vs_scenario_grid=same, card=card)
        if not same or report["counts"]["computed"] != 4:
            raise AssertionError(f"tiled scenario {name}: bitwise {same}, {report['counts']}")


def phase_tiled(card: str) -> dict:
    """Slice 10 on the card: the paper heatmap, the fault drill, bench_sweep's
    elastic shape with the tile cache, the served tile-cache rung and the
    tiled scenario sweep. The kernel counts are set to 0 before and read
    after: this path launches none of the three kernels. Returns them."""
    import shutil
    import tempfile
    from pathlib import Path

    from sbr_tpu_torch import _build

    scratch = Path(tempfile.mkdtemp(prefix="sbr_tiled_"))
    _build.reset_launches()
    try:
        clean = _tiled_paper(card, scratch)
        _tiled_drill(card, scratch, clean)
        swept = _tiled_bench_sweep(card, scratch)
        _tiled_served(card, swept)
        _tiled_scenarios(card, scratch)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    launches = _launches()
    emit("tiled", kernel_launches=launches)
    if any(launches.values()):
        raise AssertionError(f"the tiled path launched kernels: {launches}")
    return launches


def phase_tiled_cpu_vs_card() -> None:
    """A 24×20 grid in ragged 7×6 tiles on the card and on the CPU, f64 and
    f32, both numerics: statuses equal, floats within 1e-12 / 2e-5, the
    monolithic grid's flags equal; then one faulted-and-resumed run on the
    card against the CPU's fault-free grid."""
    import shutil
    import tempfile
    from pathlib import Path

    import sbr_tpu_torch as st
    from sbr_tpu_torch.resilience import FaultPlan, faults
    from sbr_tpu_torch.utils.checkpoint import run_tiled_grid

    betas = np.linspace(0.3, 3.0, TILED_CPU_SHAPE[0])
    us = np.linspace(0.01, 0.95, TILED_CPU_SHAPE[1])
    base = st.make_model_params()
    rows = []
    for numerics in ("fixed", "adaptive"):
        cfg = st.SolverConfig(numerics=numerics, **BENCH_SWEEP_CFG)
        for dtype in (torch.float64, torch.float32):
            out = {dev: run_tiled_grid(betas, us, base, config=cfg, tile_shape=TILED_CPU_TILE,
                                       dtype=dtype, device=dev) for dev in ("cpu", TILED_DEVICE)}
            flags = {dev: st.beta_u_grid(betas, us, base, config=cfg, dtype=dtype,
                                         device=dev).health.flags.cpu()
                     for dev in ("cpu", TILED_DEVICE)}
            card = out[TILED_DEVICE]
            gaps = {f: _nan_gap(getattr(out["cpu"], f), getattr(card, f))
                    for f in ("xi", "max_aw")}
            row = dict(numerics=numerics, dtype=_dtype_name(dtype),
                       status_equal=bool(torch.equal(out["cpu"].status, card.status)),
                       flags_equal=bool(torch.equal(flags["cpu"], flags[TILED_DEVICE])),
                       **{f"{f}_max_abs": g for f, g in gaps.items()},
                       tol=TILED_CPU_TOL[dtype])
            rows.append(row)
            if not (row["status_equal"] and row["flags_equal"]
                    and max(gaps.values()) <= TILED_CPU_TOL[dtype]):
                raise AssertionError(f"tiled card vs CPU: {row}")
    cfg = st.SolverConfig(numerics="adaptive", **BENCH_SWEEP_CFG)
    scratch = Path(tempfile.mkdtemp(prefix="sbr_tiled_cpu_"))
    try:
        faults.install(FaultPlan({"seed": 3, "rules": [
            {"point": "tile.result", "kind": "nan", "at_hits": [2], "cells": 3},
            {"point": "checkpoint.save", "kind": "corrupt", "at_hits": [5]},
        ]}))
        try:
            run_tiled_grid(betas, us, base, config=cfg, tile_shape=TILED_CPU_TILE,
                           checkpoint_dir=str(scratch), device=TILED_DEVICE)
        finally:
            faults.install(None)
        resumed = run_tiled_grid(betas, us, base, config=cfg, tile_shape=TILED_CPU_TILE,
                                 checkpoint_dir=str(scratch), device=TILED_DEVICE)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    cpu = run_tiled_grid(betas, us, base, config=cfg, tile_shape=TILED_CPU_TILE, device="cpu")
    resumed_gap = max(_nan_gap(getattr(cpu, f), getattr(resumed, f)) for f in ("xi", "max_aw"))
    resumed_status = bool(torch.equal(cpu.status, resumed.status))
    emit("tiled_cpu_vs_card", shape=list(TILED_CPU_SHAPE), tile=list(TILED_CPU_TILE),
         rows=rows, faulted_resumed_status_equal=resumed_status,
         faulted_resumed_max_abs=resumed_gap)
    if not resumed_status or resumed_gap > TILED_CPU_TOL[torch.float64]:
        raise AssertionError(f"tiled faulted run on the card vs CPU: {resumed_gap}")


PHASES = ("kernel", "main", "cpu", "physics", "belief", "bayes", "bayes_cpu", "graphgen",
          "equilibrium", "sweeps", "sweeps_cpu", "social", "closure", "social_cpu", "serve",
          "serve_cpu", "recount", "extensions", "extensions_cpu", "scenario", "population",
          "scenario_cpu", "rewire", "rewire_cpu", "grad", "grad_cpu", "tiled", "tiled_cpu")


def _recount_kernel_entry(recount: dict, tiled_launches: dict) -> dict:
    """The recount kernel's entry of the kernels line, its numbers from the
    production shape's packed row (10^6 agents, 10,092,544 edges)."""
    from sbr_tpu_torch.social.recount import KERNEL as RECOUNT_KERNEL

    rows = recount["rows"]
    main_row = next(r for r in rows if r["n_agents"] == 1_000_000 and r["variant"] == "packed"
                    and r["shape"] == "full" and r["planned"])
    return {
        "name": "recount_gather",
        "route": "cuda",
        "source": "sbr_tpu_torch/csrc/recount_gather.cu",
        "replaces": "benchmarks/ablate_pallas_recount.py:55",
        "replaces_function": "benchmarks/ablate_pallas_recount.py::_build_pallas_gather",
        "launches": recount["launches"],
        "launches_by_path": {"ablation": recount["launches"],
                             "tiled": tiled_launches[RECOUNT_KERNEL]},
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "mismatches": sum(r["mismatches"] for r in rows),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shapes": rows,
    }


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
    belief_rows = phase_belief_kernel_vs_plain() if "belief" in wanted else []
    belief_launches = phase_bayes_main_path() if "bayes" in wanted else None
    if "bayes_cpu" in wanted:
        phase_bayes_cpu_vs_card()
    if "graphgen" in wanted:
        phase_graphgen_cpu_vs_card()
    if "equilibrium" in wanted:
        phase_equilibrium()
    if "sweeps" in wanted:
        phase_sweeps_main_path()
    if "sweeps_cpu" in wanted:
        phase_sweeps_cpu_vs_card()
    fp = phase_social() if "social" in wanted else None
    loop_launches = phase_closure(fp) if "closure" in wanted else {}
    if "social_cpu" in wanted:
        phase_social_cpu_vs_card()
    if "serve" in wanted:
        phase_serve(info["nvidia_smi"])
    if "serve_cpu" in wanted:
        phase_serve_cpu_vs_card()
    recount = phase_recount() if "recount" in wanted else None
    if "extensions" in wanted:
        phase_extensions()
    if "extensions_cpu" in wanted:
        phase_extensions_cpu_vs_card()
    if "scenario" in wanted:
        phase_scenario(info["nvidia_smi"])
    pop_launches = phase_population(info["nvidia_smi"]) if "population" in wanted else {}
    if "scenario_cpu" in wanted:
        phase_scenario_cpu_vs_card()
    rewire_launches = phase_rewire(info["nvidia_smi"]) if "rewire" in wanted else {}
    if "rewire_cpu" in wanted:
        phase_rewire_cpu_vs_card()
    if "grad" in wanted:
        phase_grad(info["nvidia_smi"])
    if "grad_cpu" in wanted:
        phase_grad_cpu_vs_card()
    tiled_launches = phase_tiled(info["nvidia_smi"]) if "tiled" in wanted else {}
    if "tiled_cpu" in wanted:
        phase_tiled_cpu_vs_card()
    if "profile" in wanted:
        phase_profile()
    if wanted != set(PHASES):
        return 0
    from sbr_tpu_torch.social.fused import BELIEF_KERNEL, KERNEL

    main_row = next(r for r in rows if r["n"] == 1_000_003 and r["dtype"] == "float32")
    belief_row = next(r for r in belief_rows if r["n"] == 2_000_003 and r["dtype"] == "float32")
    # each path's launches: the agents' and the bayes main paths, and the
    # closures that end every step in the same kernels
    kernels = [{
        "name": "infection_update",
        "route": "cuda",
        "source": "sbr_tpu_torch/csrc/infection_update.cu",
        "replaces": "sbr_tpu/social/fused.py:114",
        "replaces_function": "sbr_tpu/social/fused.py::_pallas_update",
        "launches": (launches + loop_launches[KERNEL] + pop_launches[KERNEL]
                     + rewire_launches[KERNEL]),
        "launches_by_path": {"agents": launches, "closures": loop_launches[KERNEL],
                             "population": pop_launches[KERNEL],
                             "rewire": rewire_launches[KERNEL], "tiled": tiled_launches[KERNEL]},
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "mismatches": sum(r["mismatches"] for r in rows),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,
        "shapes": rows,
    }, {
        "name": "belief_update",
        "route": "cuda",
        "source": "sbr_tpu_torch/csrc/belief_update.cu",
        "replaces": "sbr_tpu/social/fused.py:231",
        "replaces_function": "sbr_tpu/social/fused.py::_pallas_belief",
        "launches": (belief_launches + loop_launches[BELIEF_KERNEL]
                     + pop_launches[BELIEF_KERNEL] + rewire_launches[BELIEF_KERNEL]),
        "launches_by_path": {"bayes": belief_launches, "closures": loop_launches[BELIEF_KERNEL],
                             "population": pop_launches[BELIEF_KERNEL],
                             "rewire": rewire_launches[BELIEF_KERNEL],
                             "tiled": tiled_launches[BELIEF_KERNEL]},
        "max_abs_err": max(r["max_abs_err"] for r in belief_rows),
        "mismatches": sum(r["mismatches"] for r in belief_rows),
        "ms": belief_row["ms"],
        "plain_ms": belief_row["plain_ms"],
        "bound_ms": belief_row["bound_ms"],
        "bound_by": belief_row["bound_by"],
        "library_ms": None,
        "shapes": belief_rows,
    }, _recount_kernel_entry(recount, tiled_launches)]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["name"], "count": info["count"],
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
