#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``sbr_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``sbr_tpu_torch/csrc`` and the host library
from ``sbr_tpu_torch/native`` (with ``g++``), holds each kernel against its
plain PyTorch version on the card (the infection kernel also at an empty and
a full frontier, each row with its bound from its frontier and the SASS
counts of the kernel's one-agent loop, read from the built library), and
drives both ported paths at full width: the explicit-agent simulation (10^6
agents on a ~10^7-edge Erdős–Rényi graph from the native sampler, 200 steps,
both engines, and the infection kernel's device time summed over one run's
200 launches beside their bound), then the host graph on both routes (the
native library and ``SBR_NATIVE=0``'s numpy: generation and preparation
times at 10^6 and 10^7 agents, the native sort held to the plain sort on
the main path's edges, the native stream to its numpy version), and the
Bayesian-observer
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
repairs, a torn save quarantined on the resume), byte-identical to the
fault-free grid;
bench.py's `bench_sweep` shape elastic with the tile cache (cold, warm
with 0 tiles computed, two processes on the card sharing a directory);
the serving engine answering an outage from the tile cache; the tiled
scenario sweep; and a ragged tiled grid on the card against the CPU. Then
slice 11's replication run (`figures.master`), and slice 12, the run log's
wiring and its reader: every instrumented path under a run directory at
bench.py's shapes (the served mix, populations, a grads stream and a
breaker drill over the tile cache in a served run directory; the faulted
tiled sweep; the elastic sweep cold and warm; a converged calibration; the
scenario, policy and graph runs; a sweep and a calibration built to
breach), once without run directories for the run log's cost,
with every report subcommand as ``python -m sbr_tpu_torch.obs.report``
exiting 0 on the clean runs and 1 on the breaching ones;
and the same drive small on the card against the CPU. Then slice 13,
request tracing, the flight recorder and the demand observatory: the
served mix and a cold stream with every switch off and each alone
(answers bit-identical, p50/p99 of each), ``report util`` beside the
profiler's busy share, traced population queries over HTTP (each
launching its kernel members × steps times), loadgen's ``--trace-out``
rows replayed into the engine's demand surface, the faulted tiled sweep
with the recorder (tiles byte-equal), every report's exit code on clean
and breaching runs and gc's keep flags; and the same drive small on the
card against the CPU. Then slice 14, the numerics audit: the battery's
CLI records goldens, classifies (every probe a pass) and classifies under
a seeded corrupt plan (one probe in drift), ``report audit`` gates both
runs, the four parity CLIs run as processes with ``--obs-dir`` (and once
in process, where the infomodels battery holds the infection kernel to
the plain step and runs the belief kernel), ``bench.py``'s served mix
runs with the audit scheduler off and on (answers bit-identical, the
overhead ratio, a corrupt plan latching ``/healthz``), gc prunes the
audit artifacts, and the battery runs on the card against the CPU. The
profiles read the profiler's raw device events (`_device_rows`), held
once to ``key_averages``. Then slice 16, the sharded paths: the
north-star graph's agent matrix (gather with the "scatter" and
"allgather_psum" comms, incremental) on an agent mesh at world size 1
(NCCL, in this process) and 2 (gloo ranks, two child processes of this
script sharing the card), every rank bit for bit the single-device run,
both kernels against their plain versions on the sharded shapes, the
world-1 run profiled (collectives against kernels, launches from the raw
device events), the sharded graph build byte-identical to the host
prepare, the 500×500 float32 Figure-5 grid on a (1, 2) mesh and the
K=1000 hetero solve on a 2-rank "k" mesh against one device; and the
matrix on CPU and card meshes of one gloo group, bit for bit
(``sharded_cpu``). Then slice 17: both agent kernels in float16 and
bfloat16 (bit for bit their plain versions, with their bounds), the
foldin stream and the half types run on the card against the CPU, the
policy sweep's measured OOM preflight, and the five recovery drills of
``python -m sbr_tpu_torch.resilience.chaos`` on the card (``chaos``: four
of them beside ``fleet_cpu``, which times nothing, then the fleet drill,
whose trace coverage is a check of the router's host time, alone). Then
the ξ stage's kernel (``xi``): a 500×500 Figure-5 tile in float32 and
float64, bit for bit the eager route, its time beside its SASS-counted
bound and the eager route's device time, and the tile's host time on both
routes. The phases up to the ξ kernel's, which time the kernels, run alone;
after them two more processes of this script run the extensions,
scenario, population, rewire and grad phases, and the tiled, figures and
obs phases (LANES), beside the telemetry, audit and fleet phases and the
sharded ranks, and all of these end before the fleet drill starts. It
prints one JSON line per phase, and beside
the serving, scenario, population, rewire, grad, tiled, telemetry and
audit numbers the card's name and power limit.
The last line is ``{"ok": true, "device": {...}}``. Any failed check raises
and the script exits non-zero; without a CUDA device it exits non-zero
before printing any result.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import torch

# Published peaks of one H100 SXM: HBM rate, and the float32 rate outside
# the tensor cores (a fused multiply-add counted as two operations), which
# the belief and recount bounds use.
HBM_BYTES_PER_S = 3.35e12
VECTOR_OPS_PER_S = 67e12

# The infection kernel's operations bound: the instructions it issues for
# one frontier agent (not informed, counts != 0; every other agent keeps its
# state without a draw), read from the SASS of this run's build by
# `sbr_tpu_torch.benchmarks.sass_count` (the innermost loop that holds the
# exponential), on the busiest of the SM's pipes, at that pipe's lanes a
# clock (INT32 ALU 64, FP32 128, IMAD 64, FP64 64, MUFU and conversions 16,
# every instruction's issue slot 128) on every SM at `clocks.max.sm`.
# `phase_sass` fills INFECTION_SASS (type: counts by pipe) from the build;
# `bound_ms` reads nothing else, so the bound follows the kernel's source.
#
# What it read for csrc/infection_update.cu's one-agent loop in PR 18 (nvcc
# of CUDA 12.8 for sm_90a), by pipe; every type's busiest is the issue slot:
#   float32  115 instructions: 57 ALU (19 SHF, 21 LOP3, 9 IADD3...), 25
#            IMAD (17 IMAD.IADD of the Threefry adds), 15 FP32, 2 MUFU
#            (RCP, EX2), 7 shared-memory, 9 branch and move
#   float64  174: 64 ALU, 36 IMAD, 32 FP64 (21 DFMA), 2 MUFU/conversion,
#            7 shared-memory, 32 other (22 UMOV)
#   float16  129: 64 ALU, 24 IMAD, 22 FP32 (7 HADD2.F32), 3 MUFU/F2F, 7
#            shared-memory, 9 other
#   bfloat16 129: 58 ALU, 31 IMAD, 15 FP32, 9 MUFU/F2F (7 F2F.BF16), 7
#            shared-memory, 9 other
INFECTION_SASS: dict = {}
# the card's, read by phase_device
SM_CLOCK_HZ = 1.98e9
N_SMS = 132

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


# a child of `_lane_start` counts its phases' elapsed seconds from the
# parent's start (the monotonic clock is the system's)
T_START = float(os.environ.get("CHIP_SMOKE_T0") or time.perf_counter())


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


def bound_ms(n: int, dtype: torch.dtype, frontier: int, uninformed: int,
             pipes: dict | None = None) -> dict:
    """Least time for the infection step on n agents, ``uninformed`` of them
    not informed and ``frontier`` of those with a nonzero count: the larger
    of the bytes these inputs need over the memory rate (informed 1 B and
    t_inf read, informed' 1 B and t_inf' written for every agent; counts 4
    B for an agent not informed, whose output is decided by its count;
    beta and deg for frontier agents only) and the frontier agents'
    instructions on the busiest pipe (``pipes``, by default this run's SASS
    reading in INFECTION_SASS)."""
    from sbr_tpu_torch.benchmarks.sass_count import busiest

    size = torch.finfo(dtype).bits // 8
    name = str(dtype).removeprefix("torch.")
    if pipes is None:
        if name not in INFECTION_SASS:
            raise AssertionError(f"no SASS reading of the {name} kernel: phase_sass runs first")
        pipes = INFECTION_SASS[name]
    nbytes = n * (1 + size + 1 + size) + uninformed * 4 + frontier * 2 * size
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    pipe, per_sm = busiest(pipes)
    ops_ms = frontier * per_sm / (N_SMS * SM_CLOCK_HZ) * 1e3
    return {"frontier_share": frontier / n, "uninformed_share": uninformed / n,
            "bytes_ms": bytes_ms, "ops_ms": ops_ms, "ops_pipe": pipe,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def frontier_of(informed, counts) -> tuple:
    """(frontier, uninformed): the agents whose state the infection step
    can change (not informed, with a nonzero count), and those not
    informed, whose count it reads."""
    return int(((~informed) & (counts != 0)).sum()), int((~informed).sum())


def belief_bound_ms(n: int, dtype: torch.dtype):
    """Least time for the belief step on n agents: the larger of its bytes
    (informed 1 B, t_inf, belief, counts 4 B, awareness, deg, θ read;
    informed' 1 B, t_inf', belief' written: 34 B in f32, 62 B in f64, 20 B
    in the half types) over the memory rate and its operations over the
    rate of the type they run in."""
    size = torch.finfo(dtype).bits // 8
    bytes_ms = n * (6 + 7 * size) / HBM_BYTES_PER_S * 1e3
    ops_ms = n * BELIEF_OPS_PER_AGENT / _dtype_ops_per_s(dtype) * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    global SM_CLOCK_HZ, N_SMS
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    SM_CLOCK_HZ = float(clock) * 1e6
    N_SMS = torch.cuda.get_device_properties(0).multi_processor_count
    info = {
        "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "clocks_max_sm_mhz": float(clock),
        "sms": N_SMS,
    }
    emit("device", **info)
    return info


def phase_build() -> None:
    from sbr_tpu_torch import _build

    t0 = time.perf_counter()
    paths = _build.build_all()
    seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = _build.build_host("graphgen")
    host_seconds = time.perf_counter() - t0
    ptxas = {
        name: [ln.strip() for ln in path.with_suffix(".log").read_text().splitlines()
               if "registers" in ln or "spill" in ln]
        for name, path in paths.items()
        if path.with_suffix(".log").exists()
    }
    emit("build", seconds=seconds, kernels=sorted(paths), ptxas=ptxas,
         host_library=host.name, host_seconds=host_seconds, host_cxx=_build.HOST_CXX,
         host_flags=list(_build.HOST_FLAGS))
    phase_sass()


def phase_sass() -> None:
    """The infection kernel's instructions per frontier agent, by pipe,
    from this run's SASS, into INFECTION_SASS, which `bound_ms` reads."""
    from sbr_tpu_torch.benchmarks import sass_count

    funcs = sass_count.kernel_counts("infection_update")
    names = {"f": "float32", "d": "float64", "6__half": "float16",
             "13__nv_bfloat16": "bfloat16"}
    for fn, c in funcs.items():
        if c is None:
            continue
        # the template argument's mangled name ends the symbol: ...IfEEvPKh...
        dtype = next((d for k, d in names.items() if f"I{k}E" in fn), None)
        if dtype is None:
            continue
        INFECTION_SASS[dtype] = c["pipes"]
        emit("sass", kernel="infection_update", dtype=dtype, function=fn, span=c["span"],
             pipes=c["pipes"], busiest=c["busiest"],
             clocks_per_agent_sm=c["clocks_per_agent_sm"], opcodes=c["opcodes"])
    missing = sorted(set(names.values()) - set(INFECTION_SASS))
    if missing:
        raise AssertionError(f"no one-agent loop found in the SASS of the {missing} kernels")


# The four types of both agent kernels, as (numpy type the inputs are drawn
# in, torch type they run in): the half types are drawn in float32 and
# rounded on the card, which needs no numpy bfloat16.
KERNEL_DTYPES = ((np.float32, torch.float32), (np.float64, torch.float64),
                 (np.float32, torch.float16), (np.float32, torch.bfloat16))


def _dtype_ops_per_s(dtype: torch.dtype) -> float:
    """The rate of a kernel's arithmetic: float64 at its own rate, every
    other type in float32 (the half kernels compute in float32)."""
    return F64_OPS_PER_S if dtype == torch.float64 else VECTOR_OPS_PER_S


def _kernel_inputs(n: int, np_dtype, seed: int = 0, dtype=None, frontier: str = "mixed"):
    """The infection step's inputs: 30% informed, counts the least of two
    uniforms on 0..20 (a frontier of ~63%); ``frontier="none"`` informs
    every agent, ``"all"`` none, with every count at least 1."""
    rng = np.random.default_rng(seed)
    informed = rng.random(n) < 0.3
    t_inf = np.where(informed, rng.uniform(-1.0, 5.0, n), np.inf).astype(np_dtype)
    counts = rng.integers(0, 21, n).astype(np.int32)
    deg = rng.integers(0, 21, n)
    counts = np.minimum(counts, deg).astype(np.int32)
    if frontier == "none":
        informed[:] = True
        t_inf = rng.uniform(-1.0, 5.0, n).astype(np_dtype)
    elif frontier == "all":
        informed[:] = False
        counts = np.maximum(counts, 1)
        deg = np.maximum(deg, counts)
    safe_deg = np.maximum(deg, 1).astype(np_dtype)
    betas = rng.lognormal(0.0, 0.5, n).astype(np_dtype)
    dev = torch.device("cuda")
    out = [torch.from_numpy(a).to(dev) for a in (informed, t_inf, counts, betas, safe_deg)]
    if dtype is not None:
        out = [t.to(dtype) if t.is_floating_point() else t for t in out]
    return tuple(out)


# The rows of the infection kernel's phase: (agents, frontier) in every
# type, then the two frontier extremes at 10^7 in float32 and float16 (the
# stream alone, and a draw for every agent).
KERNEL_ROWS = tuple((n, "mixed", np_dtype, dtype) for n in (1_000_003, 10_000_019)
                    for np_dtype, dtype in KERNEL_DTYPES) + tuple(
    (10_000_019, frontier, np.float32, dtype) for dtype in (torch.float32, torch.float16)
    for frontier in ("none", "all"))


def phase_kernel_vs_plain() -> list:
    from sbr_tpu_torch.social import fused, rng

    k0, k1 = rng.fold_in(rng.prng_key(0), 17)
    rows = []
    for n, frontier, np_dtype, dtype in KERNEL_ROWS:
        informed, t_inf, counts, betas, safe_deg = _kernel_inputs(n, np_dtype, dtype=dtype,
                                                                  frontier=frontier)
        dt = 0.1
        t_next = fused.host_round(18 * fused.host_round(dt, dtype), dtype)
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
        u = rng._uniform_from_bits(x0, x1, dtype).double()
        p = (1.0 - torch.exp((-betas) * (counts.to(dtype) / safe_deg)
                             * fused.host_round(dt, dtype))).double()
        ulp = torch.finfo(dtype).eps * p.abs()
        near = int(((u - p).abs() <= 4 * ulp).sum())
        del x0, x1, u, p, ulp, ids
        kernel_ms = time_ms(lambda: fused._update_cuda(*args))
        plain_ms = time_ms(lambda: fused._update_plain(*args))
        row = {
            "n": n, "dtype": str(dtype).removeprefix("torch."), "frontier": frontier,
            "mismatches": mism, "max_abs_err": max(err_t, err_i),
            "near_boundary_lanes": near,
            "newly": int((got_i & ~informed).sum()),
            "ms": kernel_ms, "plain_ms": plain_ms,
            **bound_ms(n, dtype, *frontier_of(informed, counts)), "library_ms": None,
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


def phase_main_path() -> tuple:
    import sbr_tpu_torch as st
    from sbr_tpu_torch import _build, native
    from sbr_tpu_torch.social.fused import KERNEL

    if not native.native_available():
        raise AssertionError("the main path must run on the native host graph (SBR_NATIVE=0?)")
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
            edges=pg.n_edges, steps=STEPS_FULL, dtype="float32", graph_route="native",
            recount_steps=int(res.full_recount_steps.sum()), kernel_launches=launches,
            graph_gen_s=graph_s, prepare_s=prepare_s, simulate_s=steady_s,
            agent_steps_per_s=N_FULL * STEPS_FULL / steady_s,
            final_informed_frac=float(g[-1]),
        )
        del pg
    if not _same(results["auto"], results["gather"]):
        raise AssertionError("auto and gather engines differ at full width")
    emit("main_path_engines_identical", ok=True)
    return main_launches, main_sequence(src, dst, cfg, results["gather"])


def main_sequence(src, dst, cfg, want) -> dict:
    """The infection kernel on the main path's own sequence: its device ms
    summed over the launches of one steady float32 gather run at 10^6
    agents (from the profiler's raw device events), and the bound of each
    launch from its frontier, read in a second run whose kernel wrapper
    counts each launch's frontier first. Both runs equal the main path's."""
    import sbr_tpu_torch as st
    from sbr_tpu_torch.social import fused

    pg = st.prepare_agent_graph(1.0, src, dst, N_FULL, config=cfg, engine="gather",
                                dtype=np.float32)
    run = lambda: st.simulate_agents(prepared=pg, x0=1e-4, config=cfg, seed=0)  # noqa: E731
    prof = _profiled(run, "infection_update_kernel")
    frontiers = []
    launch = fused._update_cuda

    def counted(informed, t_inf, counts, *rest):
        frontiers.append(frontier_of(informed, counts))
        return launch(informed, t_inf, counts, *rest)

    fused._update_cuda = counted
    try:
        res = run()
    finally:
        fused._update_cuda = launch
    if not _same(res, want):
        raise AssertionError("the counted run differs from the main path's")
    fr = np.array([f for f, _ in frontiers])
    if len(fr) != STEPS_FULL:
        raise AssertionError(f"{len(fr)} counted launches, want {STEPS_FULL}")
    per = [bound_ms(N_FULL, torch.float32, f, u) for f, u in frontiers]
    row = dict(
        n=N_FULL, steps=STEPS_FULL, engine="gather", dtype="float32",
        launches=prof["kernel_calls"], kernel_ms=prof["kernel_ms"],
        ms_per_launch=prof["kernel_ms"] / prof["kernel_calls"],
        frontier_share=float(fr.mean() / N_FULL),
        frontier_share_max=float(fr.max() / N_FULL),
        uninformed_share=float(np.mean([u for _, u in frontiers]) / N_FULL),
        bytes_ms=sum(b["bytes_ms"] for b in per), ops_ms=sum(b["ops_ms"] for b in per),
        bound_ms=sum(b["bound_ms"] for b in per),
        launches_bound_by_operations=sum(b["bound_by"] == "operations" for b in per),
        run_device_ms=prof["device_s"] * 1e3,
    )
    row["bound_by"] = "bytes" if row["bytes_ms"] >= row["ops_ms"] else "operations"
    emit("main_path_sequence", **row)
    del pg
    return row


# The host layer under the main path (sbr_tpu_torch/native): the
# Erdős–Rényi sampler and the counting sort, timed on both routes in this
# process, one after the other: the native library (the default) and the
# numpy routes (SBR_NATIVE=0). At the main path's 10^6 agents and at 10^7
# agents (~10^8 edges: the graph, its host preparation and its upload, no
# simulation), each with engine="auto" as the main path prepares.
HOST_AGENTS = (N_FULL, 10_000_000)
# the native stream against its numpy version on a graph of this size
HOST_STREAM_AGENTS = 100_000


@contextlib.contextmanager
def _graph_route(route: str):
    """``SBR_NATIVE`` for one route ("native": unset; "numpy": "0"),
    restored after."""
    old = os.environ.pop("SBR_NATIVE", None)
    if route == "numpy":
        os.environ["SBR_NATIVE"] = "0"
    try:
        yield
    finally:
        os.environ.pop("SBR_NATIVE", None)
        if old is not None:
            os.environ["SBR_NATIVE"] = old


def _host_stream_check() -> None:
    """The native pair stream equals its numpy version, `_er_edges_plain`,
    on a 10^5-agent graph, and fewer edges of one seed are its prefix."""
    import sbr_tpu_torch as st
    from sbr_tpu_torch import native

    n = HOST_STREAM_AGENTS
    e = len(st.erdos_renyi_edges(n, 10.0, seed=0)[0])
    got = native.er_edges_native(n, e, 0)
    plain_equal = all(np.array_equal(a, b) for a, b in zip(native._er_edges_plain(n, e, 0), got))
    prefix_equal = all(np.array_equal(a[:e // 2], b)
                       for a, b in zip(got, native.er_edges_native(n, e // 2, 0)))
    emit("host_er_stream", n=n, edges=e, seed=0, plain_equal=plain_equal,
         prefix_equal=prefix_equal)
    if not (plain_equal and prefix_equal):
        raise AssertionError("the native Erdős–Rényi stream differs from its numpy version")


def phase_host_graph(card: str) -> None:
    """The host graph of the main path on both routes: ``graph_gen_s``
    (`erdos_renyi_edges`) and ``prepare_s`` (`prepare_agent_graph`, engine
    "auto", to the card) at 10^6 and 10^7 agents, and at 10^6 the sort
    alone (``sort_s``), where the native sort's four outputs are held to
    the plain sort's on the main path's edges."""
    import sbr_tpu_torch as st
    from sbr_tpu_torch import native

    _host_stream_check()
    cfg = st.AgentSimConfig(n_steps=STEPS_FULL, dt=0.1)
    for n in HOST_AGENTS:
        for route in ("native", "numpy"):
            with _graph_route(route):
                t0 = time.perf_counter()
                src, dst = st.erdos_renyi_edges(n, 10.0, seed=0)
                graph_s = time.perf_counter() - t0
                row = {}
                if n == N_FULL:
                    t0 = time.perf_counter()
                    out = native.sort_edges_by_dst(src, dst, n)
                    row["sort_s"] = time.perf_counter() - t0
                    if route == "native":
                        plain = native._sort_edges_by_dst_plain(src, dst, n)
                        same = [bool(np.array_equal(a, b) and a.dtype == b.dtype)
                                for a, b in zip(out, plain)]
                        emit("host_sort_vs_plain", n=n, edges=len(src),
                             outputs=["src", "dst", "indeg", "row_ptr"], equal=same)
                        if not all(same):
                            raise AssertionError(f"the native sort differs from the plain: {same}")
                        del plain
                    del out
                t0 = time.perf_counter()
                pg = st.prepare_agent_graph(1.0, src, dst, n, config=cfg, engine="auto",
                                            dtype=np.float32)
                torch.cuda.synchronize()
                prepare_s = time.perf_counter() - t0
                emit("host_graph", route=route, n=n, edges=len(src), engine=pg.engine,
                     graph_gen_s=graph_s, prepare_s=prepare_s, **row, card=card)
                del pg, src, dst
        torch.cuda.empty_cache()


def _device_rows(prof) -> dict:
    """{kernel name: [device µs, launches]} of a finished torch.profiler
    capture, read from its raw trace events (kernels, copies and sets on
    the device). Building the profiler's function-event tree
    (``key_averages``) costs ~70 µs an event; reading the raw events costs
    ~3 µs. `phase_extensions` holds the two readings equal."""
    rows = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA and e.duration_ns() > 0:
            row = rows.setdefault(e.name(), [0.0, 0])
            row[0] += e.duration_ns() / 1e3
            row[1] += 1
    return rows


def _key_average_rows(prof) -> dict:
    """The same rows as `_device_rows` through ``key_averages``."""
    return {e.key: [e.self_device_time_total, e.count] for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0}


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
    rows = [(k, us, c) for k, (us, c) in _device_rows(prof).items()]
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
    _foldin_and_half_cpu_vs_card(src, dst, n, cfg)


def _foldin_and_half_cpu_vs_card(src, dst, n: int, cfg) -> None:
    """The foldin stream (unfused in every mode: no kernel launch) and the
    half types (the kernel on the card) against the CPU's plain runs. The
    float64 foldin run is held bit for bit; float32 and the half types
    count the agents whose decision an exp one ulp apart flipped."""
    import sbr_tpu_torch as st
    from sbr_tpu_torch import _build
    from sbr_tpu_torch.social.agents import _TORCH_DTYPE
    from sbr_tpu_torch.social.fused import KERNEL

    half = [k for k, v in _TORCH_DTYPE.items() if v in (torch.float16, torch.bfloat16)]
    runs = [("foldin", np.dtype(np.float64)), ("foldin", np.dtype(np.float32))]
    runs += [("counter", d) for d in half]
    for stream, dtype in runs:
        c = st.AgentSimConfig(n_steps=cfg.n_steps, dt=cfg.dt, exit_delay=cfg.exit_delay,
                              reentry_delay=cfg.reentry_delay, rng_stream=stream)
        out, launches = {}, {}
        for device in ("cpu", "cuda"):
            before = _build.LAUNCHES[KERNEL]
            out[device] = st.simulate_agents(1.0, src, dst, n, x0=0.01, config=c, seed=2,
                                             engine="gather", dtype=dtype, device=device)
            launches[device] = _build.LAUNCHES[KERNEL] - before
        a, b = out["cpu"], out["cuda"]
        diff = int(((a.informed != b.informed.cpu()) | (a.t_inf != b.t_inf.cpu())).sum())
        emit("cpu_vs_card", engine="gather", dtype=dtype.name, rng_stream=stream,
             differing_agents=diff, kernel_launches_on_card=launches["cuda"],
             final_informed_frac=float(b.informed_frac[-1]))
        want_launches = 0 if stream == "foldin" else c.n_steps
        if launches["cuda"] != want_launches:
            raise AssertionError(f"{stream}/{dtype.name}: {launches['cuda']} kernel launches "
                                 f"on the card, not {want_launches}")
        if dtype == np.float64 and not _same(a, b):
            raise AssertionError("foldin: float64 CPU and card runs differ")


def _belief_inputs(n: int, np_dtype, seed: int = 0, dtype=None):
    rng = np.random.default_rng(seed)
    informed = rng.random(n) < 0.1
    t_inf = np.where(informed, rng.uniform(-1.0, 5.0, n), np.inf).astype(np_dtype)
    deg = rng.integers(0, 21, n)
    counts = np.minimum(rng.integers(0, 21, n), deg).astype(np.int32)
    arrays = (informed, t_inf, rng.normal(0.5, 2.0, n).astype(np_dtype), counts,
              rng.uniform(0.5, 3.0, n).astype(np_dtype), np.maximum(deg, 1).astype(np_dtype),
              rng.logistic(3.0, 1.5, n).astype(np_dtype))
    out = [torch.from_numpy(a).to("cuda") for a in arrays]
    if dtype is not None:
        out = [t.to(dtype) if t.is_floating_point() else t for t in out]
    return tuple(out)


def phase_belief_kernel_vs_plain() -> list:
    import sbr_tpu_torch as st
    from sbr_tpu_torch.social import fused

    rows = []
    for n in (2_000_003, 10_000_019):
        for np_dtype, dtype in KERNEL_DTYPES:
            ins = _belief_inputs(n, np_dtype, dtype=dtype)
            llr0, llr1 = (fused.host_round(v, dtype)
                          for v in st.InfoModelSpec(channel="bayes").llr)
            t_next = fused.host_round(18 * fused.host_round(0.05, dtype), dtype)
            args = (*ins, t_next, 0.05, llr0, llr1)
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


def phase_sweeps_main_path() -> int:
    """Each shape of the flagship path in both numerics modes: cells/s of
    one fenced call and sustained, status counts, fixed against adaptive,
    mean adaptive iterations, peak memory. The path launches neither agent
    kernel; the counts, set to 0 before it and read after, say so. Each
    fixed call launches the ξ kernel once and each adaptive call never,
    read around each shape's calls; returns the ξ kernel's launches."""
    from sbr_tpu_torch import _build
    from sbr_tpu_torch.baseline.xi_kernel import KERNEL as XI_KERNEL
    from sbr_tpu_torch.social.fused import BELIEF_KERNEL, KERNEL
    from sbr_tpu_torch.utils.status import status_counts

    _build.reset_launches()
    for name, dtype, cells, make_run in _sweep_shapes():
        out = {}
        for numerics in ("adaptive", "fixed"):
            before = _build.LAUNCHES[XI_KERNEL]
            res, timing = _timed(make_run(numerics), cells)
            xi_launches = _build.LAUNCHES[XI_KERNEL] - before
            # `_timed` calls the run 2 + SUSTAINED_REPS times
            want = 2 + SUSTAINED_REPS if numerics == "fixed" else 0
            out[numerics] = res
            status, xi, aw, health = _sweep_outputs(res)
            emit("sweeps_main_path", shape=name, dtype=_dtype_name(dtype), numerics=numerics,
                 **timing, xi_launches=xi_launches, status_counts=status_counts(status),
                 mean_iterations=float(health.iterations.double().mean()),
                 max_iterations=int(health.iterations.max()),
                 finite_xi=int(torch.isfinite(xi).sum()))
            run_cells = status == 0
            finite_on_run = bool(torch.isfinite(xi[run_cells]).all()) and bool(
                torch.isfinite(aw[run_cells]).all())
            if not finite_on_run or bool(torch.isfinite(xi[~run_cells]).any()):
                raise AssertionError(f"{name}: ξ/AW_max finite exactly on RUN cells fails")
            if xi_launches != want:
                raise AssertionError(f"{name} {numerics}: {xi_launches} xi kernel launches, "
                                     f"not {want}")
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
    emit("sweeps_kernel_launches", launches=launches, xi_launches=_build.LAUNCHES[XI_KERNEL])
    if any(launches.values()):
        raise AssertionError(f"the flagship path launched a kernel: {launches}")
    return _build.LAUNCHES[XI_KERNEL]


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


# The ξ stage's kernel (csrc/xi_bisect.cu) on one 500×500 tile of the
# paper's 5000×5000 Figure-5 grid (portbench's paper_grid: n_grid 4096, 90
# steps, crossing refinement off), the tile of rows 500-999 and columns
# 4500-4999, where roots, cells without one and cells without a crossing
# mix. Its bytes a cell: τ̄_IN and τ̄_OUT read; ξ, err, residual and width
# written in the type, root_ok and increasing 1 B each, iterations and flags
# 4 B each (β, x0 and κ are a row's or the tile's).
XI_TILE = (slice(500, 1000), slice(4500, 5000))
XI_BYTES_PER_CELL = {torch.float32: 34, torch.float64: 58}
XI_TILE_REPS = 20


def _xi_inputs(dtype):
    """(ls, τ̄_IN, τ̄_OUT, κ, config) of XI_TILE on the card, as
    `solve_param_cell` builds them (β a column against the u row)."""
    from sbr_tpu_torch.baseline.learning import solve_learning
    from sbr_tpu_torch.baseline.solver import solve_equilibrium_core
    from sbr_tpu_torch.models.params import SolverConfig, make_model_params
    from sbr_tpu_torch.sweeps.baseline_sweeps import _RowLearning

    betas, us = _figure5_axes(5000)
    dev = torch.device("cuda")
    cfg = SolverConfig(n_grid=4096, bisect_iters=90, refine_crossings=False, numerics="fixed")
    m = make_model_params()
    e = m.economic
    t0, t1, x0, p, kappa, lam, eta = (
        torch.tensor(v, dtype=dtype, device=dev)
        for v in (*m.learning.tspan, m.learning.x0, e.p, e.kappa, e.lam, e.eta))
    b = torch.as_tensor(betas[XI_TILE[0]], dtype=dtype, device=dev).unsqueeze(-1)
    ls = solve_learning(_RowLearning(b, (t0, t1), x0), cfg, dtype=dtype, device=dev)
    u = torch.as_tensor(us[XI_TILE[1]], dtype=dtype, device=dev)
    r = solve_equilibrium_core(ls, u, p, kappa, lam, eta, t1, cfg, curves=False)
    return ls, r.tau_bar_in_unc, r.tau_bar_out_unc, kappa, cfg


def _xi_tile_ms(dtype) -> dict:
    """Host ms of the whole tile through `beta_u_grid` (the benchmark's
    call, outputs copied to the host), the kernel route against the eager
    route (`xi_kernel.takes` made to refuse), in turns; medians of
    XI_TILE_REPS each. The ξ kernel's launches on each route, read around
    each tile: one a tile on the kernel route, none on the eager route."""
    from sbr_tpu_torch import _build
    from sbr_tpu_torch.baseline import xi_kernel
    from sbr_tpu_torch.models.params import SolverConfig, make_model_params
    from sbr_tpu_torch.sweeps.baseline_sweeps import beta_u_grid

    betas, us = _figure5_axes(5000)
    cfg = SolverConfig(n_grid=4096, bisect_iters=90, refine_crossings=False, numerics="fixed")
    base = make_model_params()
    takes = xi_kernel.takes

    def tile():
        g = beta_u_grid(betas[XI_TILE[0]], us[XI_TILE[1]], base, cfg, dtype=dtype)
        return g.status.cpu(), g.xi.cpu(), g.max_aw.cpu()

    times = {"kernel": [], "eager": []}
    launches = {"kernel": [], "eager": []}
    outs = {}
    try:
        for rep in range(XI_TILE_REPS + 1):
            for route in ("kernel", "eager", "eager", "kernel")[rep % 2 * 2:][:2]:
                xi_kernel.takes = takes if route == "kernel" else (lambda *a: False)
                before = _build.LAUNCHES[xi_kernel.KERNEL]
                t0 = time.perf_counter()
                outs[route] = tile()
                if rep:  # the first turn warms both routes
                    times[route].append((time.perf_counter() - t0) * 1e3)
                launches[route].append(_build.LAUNCHES[xi_kernel.KERNEL] - before)
    finally:
        xi_kernel.takes = takes
    same = all(_bits_equal(a.numpy(), b.numpy()) for a, b in zip(outs["kernel"], outs["eager"]))
    return {"tile_ms_kernel": float(np.median(times["kernel"])),
            "tile_ms_eager": float(np.median(times["eager"])), "tile_outputs_equal": same,
            "tiles": XI_TILE_REPS + 1, "tile_launches_kernel": sum(launches["kernel"]),
            "tile_launches_eager": sum(launches["eager"]),
            "one_launch_a_tile": (set(launches["kernel"]) == {1}
                                  and set(launches["eager"]) == {0})}


def phase_xi(card: str) -> list:
    """The ξ stage's kernel on XI_TILE in float32 and float64: every output
    bit for bit the eager route's (`compute_xi` with an explicit bracket
    equal to the default one), one launch a call; kernel ms and the eager
    route's device ms (`time_ms`, the eager route 5 calls a graph); the
    bound, the larger of the bytes over the memory rate and the bisection
    loop's instructions (its SASS, one step a trip) times the steps on the
    busiest pipe; and the whole tile's host ms through `beta_u_grid` on
    both routes, whose ξ launches, read around each tile, are one a tile
    on the kernel route and none on the eager route."""
    from sbr_tpu_torch import _build
    from sbr_tpu_torch.baseline import xi_kernel
    from sbr_tpu_torch.baseline.solver import compute_xi
    from sbr_tpu_torch.benchmarks import sass_count

    loops = {}
    for fn, c in sass_count.kernel_counts(xi_kernel.KERNEL).items():
        dtype = next((d for k, d in (("f", "float32"), ("d", "float64")) if f"I{k}E" in fn), None)
        if c is None or dtype is None:
            continue
        loops[dtype] = c
        emit("sass", kernel=xi_kernel.KERNEL, dtype=dtype, function=fn, span=c["span"],
             pipes=c["pipes"], busiest=c["busiest"], clocks_per_step_sm=c["clocks_per_agent_sm"],
             opcodes=c["opcodes"])
    if set(loops) != {"float32", "float64"}:
        raise AssertionError(f"no bisection loop found in the SASS of {sorted(loops)} missing")
    rows = []
    for dtype in (torch.float32, torch.float64):
        name = _dtype_name(dtype)
        ls, ti, to, kappa, cfg = _xi_inputs(dtype)
        n = ti.numel()
        before = _build.LAUNCHES[xi_kernel.KERNEL]
        got = compute_xi(ti, to, ls, kappa, cfg, with_health=True)
        launches = _build.LAUNCHES[xi_kernel.KERNEL] - before
        want = compute_xi(ti, to, ls, kappa, cfg, lo=ti, hi=to, with_health=True)
        fields = ("xi", "err", "root_ok", "increasing", "residual", "bracket_width",
                  "iterations", "flags")

        def flat(out):
            h = out[4]
            return [*out[:4], h.residual, h.bracket_width, h.iterations, h.flags]

        equal = {f: _bits_equal(a.cpu().numpy(), b.cpu().numpy())
                 for f, a, b in zip(fields, flat(got), flat(want))}
        kernel_ms = time_ms(lambda: compute_xi(ti, to, ls, kappa, cfg, with_health=True))
        plain_ms = time_ms(lambda: compute_xi(ti, to, ls, kappa, cfg, lo=ti, hi=to,
                                              with_health=True), reps=5)
        pipe, per_sm = sass_count.busiest(loops[name]["pipes"])
        ops_ms = n * cfg.bisect_iters * per_sm / (N_SMS * SM_CLOCK_HZ) * 1e3
        bytes_ms = n * XI_BYTES_PER_CELL[dtype] / HBM_BYTES_PER_S * 1e3
        bound = max(ops_ms, bytes_ms)
        row = dict(kernel=xi_kernel.KERNEL, dtype=name, cells=n, steps=cfg.bisect_iters,
                   check_launches=launches, equal=equal, root_ok_share=float(got[2].float().mean()),
                   kernel_ms=kernel_ms, plain_ms=plain_ms, ops_ms=ops_ms, ops_pipe=pipe,
                   bytes_ms=bytes_ms, bound_ms=bound,
                   bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                   share_of_bound=bound / kernel_ms, **_xi_tile_ms(dtype), card=card)
        emit("xi_kernel", **row)
        rows.append(row)
        if launches != 1 or not all(equal.values()) or not row["tile_outputs_equal"]:
            raise AssertionError(f"the {name} xi kernel differs from the eager route: {row}")
        if not row["one_launch_a_tile"]:
            raise AssertionError(f"beta_u_grid's {name} tile did not launch the xi kernel "
                                 f"once on the kernel route and never on the eager route: {row}")
    return rows


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
# the fixed point's first PROFILE_ITERS outer iterations are profiled (its
# launches and busy share an iteration; ~4×10^3 kernels an iteration)
PROFILE_ITERS = 3
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
            # One whole call is ~2×10^5 device events; each dtype profiles
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
SERVE_REPLAYS = 10
SERVE_EAGER_REPS = 2


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


def _kernel_profile(run, cross_check: bool = False) -> dict:
    """Kernels and device time of one call of ``run`` (after a warm-up)
    from torch.profiler: the count of device kernels, their summed time
    and its share of the call's wall time. ``cross_check`` also reads the
    capture through ``key_averages`` and fails unless the two agree."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    rows = _device_rows(prof)
    device_s = sum(us for us, _ in rows.values()) / 1e6
    out = {"kernels": sum(c for _, c in rows.values()), "device_ms": device_s * 1e3,
           "wall_ms": wall_s * 1e3, "busy_share": device_s / wall_s}
    if cross_check:
        t0 = time.perf_counter()
        ka = _key_average_rows(prof)
        ka_kernels, ka_us = sum(c for _, c in ka.values()), sum(us for us, _ in ka.values())
        out.update(kernels_key_averages=ka_kernels, device_ms_key_averages=ka_us / 1e3,
                   key_averages_s=time.perf_counter() - t0)
        if ka_kernels != out["kernels"] or abs(ka_us / 1e3 - out["device_ms"]) > 1e-6 * ka_us:
            raise AssertionError(f"raw device events and key_averages differ: {out}")
    return out


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


def phase_serve(card: str) -> int:
    """The serving engine on the card: the per-bucket programs, bench.py's
    serving shape, a cold stream and the HTTP endpoint. The serving path
    launches no agent kernel; the counts, set to 0 before it and read
    after, say so. Returns the ξ kernel's launches (one a captured bucket
    or an eager solve of fixed numerics; a replay launches through the
    graph and counts none)."""
    from sbr_tpu_torch import _build
    from sbr_tpu_torch.baseline.xi_kernel import KERNEL as XI_KERNEL

    _build.reset_launches()
    _serve_prefix_sums(card)
    _serve_bucket_rows(card)
    _serve_bench_shape(card)
    _serve_cold_stream(card)
    _serve_endpoint(card)
    launches = dict(_build.LAUNCHES)
    xi_launches = launches.pop(XI_KERNEL, 0)
    emit("serve", kernel_launches=launches, xi_launches=xi_launches, card=card)
    if any(launches.values()):
        raise AssertionError(f"the serving path launched an agent kernel: {launches}")
    return xi_launches


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
# the interest scan is profiled at this n_grid (its kernels an interval):
# the full-width scan runs ~10^6 kernels; the adaptive scan's count barely
# shrinks with the grid (~3.8×10^5 at n_grid 64 against 5.4×10^5 at 256),
# and a kernel an interval is read the same at any grid
EXT_PROFILE_GRID = 64
# card against CPU: Sections 2 and 3 at this n_grid, and the stretch
# sweep's sub-grid of EXT_CPU_SUB points an axis at n_grid 1024
EXT_CPU_GRID = 1024
EXT_CPU_SUB = 3
# a case whose cold call takes longer is not called a second time
EXT_REPEAT_MAX_S = 5.0
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


@contextlib.contextmanager
def _preflight_records():
    """The OOM preflight records made in the block, in order."""
    from sbr_tpu_torch.obs import mem

    records, real = [], mem.preflight

    def spy(*args, **kwargs):
        records.append(real(*args, **kwargs))
        return records[-1]

    mem.preflight = spy
    try:
        yield records
    finally:
        mem.preflight = real


def _policy_preflight_row() -> None:
    """The policy sweep's measured preflight on the card: the stretch grid
    (float64, fixed numerics) gets an "ok" verdict from the two probe
    grids' measured footprints, and a grid 10^4 times larger fails closed
    before it runs."""
    from sbr_tpu_torch.obs import mem
    from sbr_tpu_torch.sweeps import policy_sweeps

    with _preflight_records() as records:
        _ext_case("policy", "fixed", "cuda", torch.float64)
    rec = records[-1]
    cfg = __import__("sbr_tpu_torch").SolverConfig(numerics="fixed", n_grid=4096,
                                                   refine_crossings=False)
    big = policy_sweeps._preflight_footprint(1000, 1000, 10, cfg, torch.float64,
                                             torch.device("cuda"))
    refused = mem.preflight("policy[1000x1000x10]", big)
    try:
        mem.check_preflight(refused)
        failed_closed = False
    except mem.MemoryPreflightError:
        failed_closed = True
    probes = {str(k[0]): v["total_bytes"] for k, v in policy_sweeps._FOOTPRINT_CACHE.items()
              if k[1] == cfg and k[2] == torch.float64}
    emit("policy_preflight", label=rec["label"], verdict=rec["verdict"],
         footprint_bytes=rec.get("footprint_bytes"), budget_bytes=rec.get("budget_bytes"),
         capacity_bytes=rec.get("capacity_bytes"), probe_total_bytes=probes,
         oversized_verdict=refused["verdict"], oversized_bytes=refused.get("footprint_bytes"),
         oversized_failed_closed=failed_closed)
    if rec["verdict"] != "ok" or not failed_closed or len(probes) != 2:
        raise AssertionError(f"policy preflight: {rec}, oversized {refused}, probes {probes}")


def phase_extensions() -> int:
    """Sections 2 and 3 and the stretch-shape policy sweep on the card at
    full width (n_grid 4096), in both numerics modes (the sweep in float32
    and float64): one cold call, then one fenced call (ms, equilibria/s,
    peak memory); ξ held to the oracle, ξ and AW_max finite exactly on RUN
    cells, fixed and adaptive statuses equal in float64. Then the interest
    scan's kernels and device time from the profiler at n_grid
    EXT_PROFILE_GRID, in both numerics, and the device's share of the
    same call's wall time unprofiled. The path launches no agent kernel;
    the counts, set to 0 before it and read after, say so. Returns the ξ
    kernel's launches (the fixed calls of the interest solver)."""
    from sbr_tpu_torch import _build
    from sbr_tpu_torch.baseline.xi_kernel import KERNEL as XI_KERNEL
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
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = _ext_case(name, numerics, "cuda", dtype)
            torch.cuda.synchronize()
            cold_s = time.perf_counter() - t0
            cold_peak = torch.cuda.max_memory_allocated()
            fenced_s = peak = None
            if cold_s < EXT_REPEAT_MAX_S:
                # a case slower than that is timed once, cold: its warm
                # columns (fenced_ms, equilibria_per_s, peak_bytes) are null
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                res = _ext_case(name, numerics, "cuda", dtype)
                torch.cuda.synchronize()
                fenced_s = time.perf_counter() - t0
                peak = torch.cuda.max_memory_allocated()
            status, xi = res["status"], res["xi"]
            run = status == 0
            row = dict(case=name, dtype=_dtype_name(dtype), numerics=numerics, cells=cells,
                       cold_s=cold_s, fenced_ms=None if fenced_s is None else fenced_s * 1e3,
                       equilibria_per_s=None if fenced_s is None else cells / fenced_s,
                       cold_equilibria_per_s=cells / cold_s, peak_bytes=peak,
                       cold_peak_bytes=cold_peak,
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
    _policy_preflight_row()
    for numerics in ("fixed", "adaptive"):
        def run(numerics=numerics):
            return _ext_case("section3", numerics, "cuda", n_grid=EXT_PROFILE_GRID)

        prof = _kernel_profile(run, cross_check=numerics == "fixed")
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        emit("extensions_interest_profile", numerics=numerics, n_grid=EXT_PROFILE_GRID, **prof,
             kernels_per_interval=prof["kernels"] / (EXT_PROFILE_GRID - 1),
             wall_ms_unprofiled=wall_ms, busy_share_unprofiled=prof["device_ms"] / wall_ms)
    launches = dict(_build.LAUNCHES)
    xi_launches = launches.pop(XI_KERNEL, 0)
    emit("extensions_kernel_launches", launches=launches, xi_launches=xi_launches)
    if any(launches.values()):
        raise AssertionError(f"the extensions launched an agent kernel: {launches}")
    return xi_launches


def phase_extensions_cpu_vs_card() -> None:
    """The port on the card against the port on the CPU: Sections 2 and 3
    at n_grid EXT_CPU_GRID in both numerics, and an EXT_CPU_SUB³ sub-grid
    of the stretch policy sweep at n_grid 1024 in float32 and float64, both
    numerics.
    Statuses and flags equal; floats within 1e-12 (f64) and 2e-5 (f32),
    and values that pass through bs32 (adaptive Section 3 and adaptive
    sweeps) within BS32_TOL."""
    sub = tuple(a[np.linspace(0, 9, EXT_CPU_SUB).astype(int)] for a in STRETCH)
    cases = [("section2", torch.float64, EXT_CPU_GRID), ("section3", torch.float64, EXT_CPU_GRID),
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
SCEN_REPS = 1
SCEN_BANKS = 64
# the composed social × hetero × interest × policy case's budget at the
# default n_grid, past which it runs at SCEN_SOCIAL_GRID
SCEN_SOCIAL_BUDGET_S = 60.0
# the grid of social × hetero × interest × policy when its estimate passes
# that budget (~45 outer iterations of the adaptive HJB pipeline), and the
# cold time past which a family is not solved a second time
SCEN_SOCIAL_GRID = 256
SCEN_FENCED_MAX_S = 2.0
# bench.py's population workload at its serving shape (bench.py:1564-1582)
POP_N, POP_DEG, POP_SEEDS, POP_QUERIES = 20_000, 10.0, 16, 1
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
                cfg = st.SolverConfig(n_grid=SCEN_SOCIAL_GRID)
                note = (f"n_grid {SCEN_SOCIAL_GRID}: at the default 4096 the estimate is "
                        f"{estimate_s:.0f} s "
                        f"(45 iterations × {hetero_interest_s:.2f} s), past "
                        f"{SCEN_SOCIAL_BUDGET_S:.0f} s")
        cold_s, res = _fenced(lambda: scenario.solve(spec, params, config=cfg))
        fenced_s = _fenced(lambda: scenario.solve(spec, params, config=cfg))[0] \
            if cold_s < SCEN_FENCED_MAX_S else None
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


def phase_scenario(card: str) -> int:
    """Composed scenarios on the card (they run no agent kernel: the
    counts, set to 0 before and read after, say so): bench_scenario's grid
    and contagion shapes, then one solve of each composition family.
    Returns the ξ kernel's launches."""
    from sbr_tpu_torch import _build
    from sbr_tpu_torch.baseline.xi_kernel import KERNEL as XI_KERNEL

    _build.reset_launches()
    _scenario_grid_rows(card)
    _scenario_multibank_rows(card)
    _scenario_family_rows(card)
    launches = dict(_build.LAUNCHES)
    xi_launches = launches.pop(XI_KERNEL, 0)
    emit("scenario_kernel_launches", launches=launches, xi_launches=xi_launches)
    if any(launches.values()):
        raise AssertionError(f"the scenario path launched an agent kernel: {launches}")
    return xi_launches


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
    (bayes, 20,000 agents, 16 members, n_grid 256: a warm-up and POP_QUERIES queries
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
PAPER_STATUS_COUNTS: dict = {}  # the tiled phase's paper heatmap, for the figures phase
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
    PAPER_STATUS_COUNTS.update(status_counts(status))
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
    transient compute, a NaN result, a torn save), resumed, byte-identical
    to the fault-free sub-sweep (the SIGTERM of a port process is the chaos
    phase's)."""
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

    # the SIGTERM run of a port process gave way to the chaos phase's base
    # and churn drills (`phase_chaos`), which hold its assertions: exit
    # 143, two tiles landed, no lease, heartbeat or temp file left, the
    # rest computed on the resume, byte-identical
    same = {"faulted": _same_bytes(faulted, clean), "resumed": _same_bytes(resumed, clean)}
    emit("tiled_fault_drill", cells=SUB_RES ** 2, tiles=4, firings=firings,
         faulted_s=faulted_s, repairs=repairs, resume_counts=resume_report["counts"],
         quarantined=quarantined, ladder_cells=len(ladder), ladder_rungs=rungs,
         ladder_s=ladder_s, ms_per_rung=1e3 * ladder_s / max(rungs, 1), byte_identical=same,
         card=card)
    if not (firings == ["transient", "nan", "corrupt"] and len(repairs) == 2
            and all(r["repaired"] for r in repairs) and len(quarantined) == 1
            and resume_report["counts"] == {"local": 3, "cache": 0, "computed": 1}
            and all(r["repaired"] for r in ladder) and len(ladder) == 2):
        raise AssertionError(f"fault drill: {firings}, {repairs}, {quarantined}, "
                             f"{resume_report['counts']}, {ladder}")
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
    after: this path launches none of the three agent kernels. Returns
    them and the ξ kernel's."""
    import shutil
    import tempfile
    from pathlib import Path

    from sbr_tpu_torch import _build
    from sbr_tpu_torch.baseline.xi_kernel import KERNEL as XI_KERNEL

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
    emit("tiled", kernel_launches=launches, xi_launches=_build.LAUNCHES[XI_KERNEL])
    if any(launches.values()):
        raise AssertionError(f"the tiled path launched kernels: {launches}")
    return {**launches, XI_KERNEL: _build.LAUNCHES[XI_KERNEL]}


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


# ---------------------------------------------------------------------------
# Slice 11: the replication run (figures/ and the run log of obs/)
# ---------------------------------------------------------------------------

# The golden figure scalars (.claude/skills/verify/SKILL.md and
# tests/test_golden_figures.py): (ξ*, τ̄_IN, τ̄_OUT, AW_max) of Figure 3,
# (ξ*, AW_max) of β = 3 and u = 0.01, the hetero ξ* and AW_max, and the
# social Δξ against word of mouth, each with its tolerance.
GOLDEN_MAIN = dict(xi=10.215436, tau_bar_in_unc=7.327538, tau_bar_out_unc=10.446095,
                   aw_max=0.618231)
GOLDEN_ALT = {"fast": dict(xi=3.256394431, aw_max=0.744437002),
              "low_u": dict(xi=9.660277550, aw_max=0.847096205)}
GOLDEN_HETERO = dict(xi=16.875766906, aw_max=0.319828704)
GOLDEN_SOCIAL = dict(xi=8.925581642, wom_xi=9.189793981, dxi=-0.264212339)
FIGURES_CPU_TOL = 1e-12  # f64, the card-against-CPU contract of slices 3-6


class _Recorded:
    """Replaces functions of modules with recording wrappers for the block;
    ``calls[name]`` lists (args, kwargs, result) of each call."""

    def __init__(self, *targets):
        self.targets = targets
        self.calls = {name: [] for _, name in targets}
        self.saved = []

    def __enter__(self):
        for module, name in self.targets:
            fn = getattr(module, name)
            self.saved.append((module, name, fn))

            def wrapped(*args, _fn=fn, _name=name, **kwargs):
                out = _fn(*args, **kwargs)
                self.calls[_name].append((args, kwargs, out))
                return out

            setattr(module, name, wrapped)
        return self

    def __exit__(self, *exc):
        for module, name, fn in reversed(self.saved):
            setattr(module, name, fn)


def _figure_data(fig) -> list:
    """A figure's data: per axes, the lines' xy and the meshes' values."""
    return [[np.asarray(ln.get_xydata(), np.float64) for ln in ax.get_lines()]
            + [np.asarray(c.get_array(), np.float64) for c in ax.collections
               if hasattr(c, "get_coordinates")]
            for ax in fig.axes]


def _run_master(argv, capture_figures: bool = False):
    """``figures.master.main(argv)`` with its printout captured: (exit code,
    printed lines, {figure: data} when ``capture_figures``)."""
    import contextlib
    import io
    from pathlib import Path

    from sbr_tpu_torch.figures import master

    figs = {}
    save = master._save

    def recording(fig, path):
        parts = Path(path).parts
        figs["/".join(parts[parts.index("figures") + 1:])] = _figure_data(fig)
        save(fig, path)

    buf = io.StringIO()
    if capture_figures:
        master._save = recording
    try:
        with contextlib.redirect_stdout(buf):
            rc = master.main(argv)
    finally:
        master._save = save
    return rc, buf.getvalue().splitlines(), figs


def _check_golden(name: str, got: dict, want: dict, tol: float) -> dict:
    gaps = {k: abs(float(got[k]) - v) for k, v in want.items()}
    if max(gaps.values()) > tol:
        raise AssertionError(f"figures golden {name}: {got} against {want} (tol {tol})")
    return gaps


def phase_figures(card: str, tiled_paper_counts) -> dict:
    """The replication run on the card at full size, uncut: the four
    sections in float64 (Figure 4 at 5000 u, Figure 5 at 500×500, the
    Figure-13 closure on 200,000 agents), the paper heatmap at 5000×5000 in
    500×500 tiles (float32, in its own checkpoint directory: computed cold,
    not resumed from the tiled phase's), and ``--obs`` into a temporary
    directory. Checks every artifact, the golden scalars from the run's
    own solves, the paper heatmap's status counts against the tiled
    phase's, the run log's spans and censuses, and the kernel counts: the
    infection kernel once a simulated closure step, the other two never.
    Returns the launches, the ξ kernel's among them."""
    import shutil
    import tempfile
    from pathlib import Path

    from sbr_tpu_torch import _build
    from sbr_tpu_torch.baseline import solver as bsolver
    from sbr_tpu_torch.baseline.xi_kernel import KERNEL as XI_KERNEL
    from sbr_tpu_torch.figures import master
    from sbr_tpu_torch.hetero import solver as hsolver
    from sbr_tpu_torch.social import closure
    from sbr_tpu_torch.social import solver as ssolver
    from sbr_tpu_torch.utils import checkpoint as ckpt
    from sbr_tpu_torch.utils.status import status_counts

    scratch = Path(tempfile.mkdtemp(prefix="sbr_figures_"))
    out = scratch / "out"
    recorded = _Recorded((bsolver, "solve_equilibrium_baseline"),
                         (hsolver, "solve_equilibrium_hetero"), (hsolver, "get_aw_hetero"),
                         (ssolver, "solve_equilibrium_social"), (closure, "close_loop"),
                         (closure, "simulate_agents"), (ckpt, "run_tiled_grid"))
    try:
        _build.reset_launches()
        t0 = time.perf_counter()
        with recorded:
            rc, lines, _ = _run_master(["--output", str(out), "--paper", "--obs",
                                        "--device", "cuda"])
        wall_s = time.perf_counter() - t0
        launches = {**_launches(), XI_KERNEL: _build.LAUNCHES[XI_KERNEL]}
        calls = recorded.calls
        figdir = out / "figures"
        expected = [f for sec in master.MANIFEST for f in master.MANIFEST[sec]]
        expected += [master.PAPER_HEATMAP, master.CLOSURE_FIG]
        missing = [f for f in expected if not (figdir / f).exists()]
        for f in ("replication_figures.pdf", "replication_figures.tex"):
            if not (out / f).exists():
                missing.append(f)
        (run_dir,) = list((out / "obs").iterdir())
        events = [json.loads(ln) for ln in (run_dir / "events.jsonl").read_text().splitlines()]
        manifest = json.loads((run_dir / "manifest.json").read_text())
        tex = (out / "replication_figures.tex").read_text()
        # the run log's cost: the sections again at --fast depth (a depth
        # cut), warm, without and then with --obs (one pair, host clock
        # around the whole call)
        walls = {}
        for mode, extra in (("off", []), ("on", ["--obs"])):
            t1 = time.perf_counter()
            _run_master(["--output", str(scratch / mode), "--device", "cuda", "--fast"] + extra)
            walls[mode] = time.perf_counter() - t1
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    emit("figures_obs_cost", sections_wall_s=walls,
         overhead=walls["on"] / walls["off"] - 1.0, card=card)

    # the section seconds, from the run log's own spans
    sections = {e["stage"]: e["dur_s"] for e in events
                if e["kind"] == "stage_end" and e["stage"].startswith("figures.")}
    emit("figures_sections", seconds=sections, wall_s=wall_s, card=card)

    res = [c[2] for c in calls["solve_equilibrium_baseline"]]
    main_eq, fast_eq, low_u_eq, wom_eq = res[0], res[1], res[2], res[3]
    golden = {"main": _check_golden("main", {k: getattr(main_eq, k) for k in GOLDEN_MAIN},
                                    GOLDEN_MAIN, 1e-5)}
    for name, eq in (("fast", fast_eq), ("low_u", low_u_eq)):
        golden[name] = _check_golden(name, {k: getattr(eq, k) for k in GOLDEN_ALT[name]},
                                     GOLDEN_ALT[name], 1e-5)
    het = calls["solve_equilibrium_hetero"][0][2]
    het_aw = calls["get_aw_hetero"][0][2]
    golden["hetero"] = _check_golden("hetero", {"xi": het.xi, "aw_max": het_aw.aw_max},
                                     GOLDEN_HETERO, 1e-4)
    social = calls["solve_equilibrium_social"][0][2]
    dxi = float(social.xi) - float(wom_eq.xi)
    golden["social"] = _check_golden("social", {"xi": social.xi}, {"xi": GOLDEN_SOCIAL["xi"]},
                                     1e-3)
    golden["wom"] = _check_golden("wom", {"xi": wom_eq.xi}, {"xi": GOLDEN_SOCIAL["wom_xi"]},
                                  1e-5)
    golden["dxi"] = _check_golden("dxi", {"dxi": dxi}, {"dxi": GOLDEN_SOCIAL["dxi"]}, 2e-3)

    paper = calls["run_tiled_grid"][0][2]
    paper_counts = status_counts(paper.status)
    steps = sum(c[2].t_grid.shape[-1] for c in calls["simulate_agents"])
    comp = calls["close_loop"][0][2]
    want_spans = {"figures.baseline", "figures.heterogeneity", "figures.interest_rates",
                  "figures.social_learning", "figures.paper_heatmap", "baseline.learning",
                  "baseline.equilibrium", "sweeps.u_sweep", "sweeps.beta_u_grid",
                  "hetero.hazards", "hetero.buffers", "hetero.xi", "interest.equilibrium",
                  "interest.hazard", "interest.value_function", "interest.buffers",
                  "interest.xi", "social.fixed_point"}
    spans = {e["stage"] for e in events if e["kind"] == "stage_end"}
    status_stages = {e["stage"] for e in events if e["kind"] == "status"}
    health_stages = {e["stage"] for e in events if e["kind"] == "health"}
    tile_mem = sum(1 for e in events if e["kind"] == "mem" and e.get("tile"))
    preflights = [e["verdict"] for e in events if e["kind"] == "preflight"]
    emit("figures", rc=rc, missing=missing, golden_gaps=golden, social_iterations=int(
        social.iterations), dxi=dxi, paper_status_counts=paper_counts,
        tiled_phase_status_counts=tiled_paper_counts, closure_steps=steps,
        closure_window=[comp.exit_delay, comp.reentry_delay], closure_err_aw_sup=comp.err_aw_sup,
        kernel_launches=launches, n_events=len(events), spans_missing=sorted(want_spans - spans),
        status_stages=sorted(status_stages), health_stages=sorted(health_stages),
        tile_mem_events=tile_mem, preflight=preflights, device=manifest["device"],
        memory_peak_bytes=manifest["memory"]["peak_bytes"],
        paper_heatmap_in_tex=master.PAPER_HEATMAP in tex, card=card)
    from sbr_tpu_torch.social.fused import BELIEF_KERNEL, KERNEL
    from sbr_tpu_torch.social.recount import KERNEL as RECOUNT_KERNEL

    problems = []
    if rc != 0 or missing:
        problems.append(f"exit {rc}, missing {missing}")
    if tiled_paper_counts is not None and paper_counts != tiled_paper_counts:
        problems.append(f"paper counts {paper_counts} != tiled {tiled_paper_counts}")
    if want_spans - spans:
        problems.append(f"spans missing {sorted(want_spans - spans)}")
    if not {"sweeps.u_sweep", "sweeps.beta_u_grid", "social.fixed_point"} <= status_stages:
        problems.append(f"status events {sorted(status_stages)}")
    if not {"baseline.equilibrium", "sweeps.u_sweep", "sweeps.beta_u_grid",
            "hetero.equilibrium", "interest.equilibrium", "social.fixed_point"} <= health_stages:
        problems.append(f"health events {sorted(health_stages)}")
    if tile_mem != (PAPER_RES // PAPER_TILE) ** 2 or preflights != ["ok"]:
        problems.append(f"tile mem events {tile_mem}, preflight {preflights}")
    if manifest["device"]["platform"] != "cuda" or manifest["status"] != "complete":
        problems.append(f"manifest {manifest['device']} {manifest['status']}")
    if not (launches[KERNEL] == steps > 0 and launches[BELIEF_KERNEL] == 0
            and launches[RECOUNT_KERNEL] == 0):
        problems.append(f"launches {launches} against {steps} closure steps")
    if problems:
        raise AssertionError("figures: " + "; ".join(problems))
    return launches


def phase_figures_cpu_vs_card() -> None:
    """``master --fast`` on the card and on the CPU: the printed manifests
    (statuses, fixed-point iterations, ξ) equal line for line, every
    figure's data within FIGURES_CPU_TOL (float64; measured per section and
    printed), the closure's agent curves bit for bit when the two windows
    are equal."""
    import shutil
    import tempfile
    from pathlib import Path

    from sbr_tpu_torch.figures import master
    from sbr_tpu_torch.social import closure

    scratch = Path(tempfile.mkdtemp(prefix="sbr_figures_cpu_"))
    runs = {}
    try:
        for dev in ("cuda", "cpu"):
            out = scratch / dev
            with _Recorded((closure, "close_loop")) as rec:
                rc, lines, figs = _run_master(["--fast", "--output", str(out),
                                               "--device", dev], capture_figures=True)
            lines = [ln.replace(str(out), "OUT") for ln in lines if "time" not in ln]
            runs[dev] = (rc, lines, figs, rec.calls["close_loop"][0][2])
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    (rc_card, lines_card, figs_card, comp_card) = runs["cuda"]
    (rc_cpu, lines_cpu, figs_cpu, comp_cpu) = runs["cpu"]
    section_of = {f: sec for sec, fs in master.MANIFEST.items() for f in fs}
    section_of[master.CLOSURE_FIG] = 4
    gaps = {}
    for name, cpu_axes in figs_cpu.items():
        worst = 0.0
        for ax_card, ax_cpu in zip(figs_card[name], cpu_axes):
            for a, b in zip(ax_card, ax_cpu):
                if a.shape != b.shape or not np.array_equal(np.isfinite(a), np.isfinite(b)):
                    raise AssertionError(f"figures card vs CPU: {name} shapes or NaNs differ")
                ok = np.isfinite(b)
                worst = max(worst, float(np.abs(a[ok] - b[ok]).max(initial=0.0)))
        if name != master.CLOSURE_FIG:
            sec = f"section_{section_of[name]}"
            gaps[sec] = max(gaps.get(sec, 0.0), worst)
    same_window = (comp_card.exit_delay, comp_card.reentry_delay) == (comp_cpu.exit_delay,
                                                                      comp_cpu.reentry_delay)
    agents_bitwise = bool(np.array_equal(comp_card.aw_sim, comp_cpu.aw_sim)
                          and np.array_equal(comp_card.g_sim, comp_cpu.g_sim))
    emit("figures_cpu_vs_card", rc=[rc_card, rc_cpu], manifest_equal=lines_card == lines_cpu,
         max_abs_by_section=gaps, tol=FIGURES_CPU_TOL, same_window=same_window,
         closure_agents_bitwise=agents_bitwise, figures=len(figs_cpu))
    if not (rc_card == rc_cpu == 0 and lines_card == lines_cpu
            and max(gaps.values()) <= FIGURES_CPU_TOL and set(figs_card) == set(figs_cpu)
            and (agents_bitwise or not same_window)):
        raise AssertionError(f"figures card vs CPU: {gaps}, manifest "
                             f"{lines_card == lines_cpu}, agents {agents_bitwise}")


# ---------------------------------------------------------------------------
# Slice 12: the run log's wiring and its reader
# ---------------------------------------------------------------------------

# The obs drive's sizes. "full": bench.py's shapes on the card (the serving
# mix of bench_serve, bench_infomodels' population shape, bench_sweep's tiled
# shape, bench_grad's calibration fixture, the 256×256 scenario grid, the
# stretch policy sweep, a 10^6-agent generated graph). "small": the same
# drive at sizes the CPU runs in seconds, for the card-against-CPU phase.
# members of the obs and telemetry paths' population queries: half of
# bench.py's 16 (POP_SEEDS, which the population phase keeps), a depth cut
# that made room for the sharded phases
OBS_POP_SEEDS = 8
OBS_SIZES = {
    "full": dict(pool=64, queries=2048, group=16, buckets=(1, 8, 64), grads=64,
                 cfg=BENCH_SWEEP_CFG, pop_n=POP_N, pop_seeds=OBS_POP_SEEDS,
                 sweep_n=BENCH_SWEEP_N, tile=BENCH_SWEEP_TILE, calib_obs=48, scen_n=SCEN_N,
                 policy=(10, 10, 10), graph_n=1_000_000),
    "small": dict(pool=8, queries=48, group=8, buckets=(1, 8), grads=8,
                  cfg=dict(n_grid=96, bisect_iters=40, refine_crossings=False), pop_n=2_000,
                  pop_seeds=2, sweep_n=16, tile=8, calib_obs=16, scen_n=8,
                  policy=(2, 2, 2), graph_n=10_000),
}
OBS_POP_GRID = POP_GRID
OBS_CALIB_TRUTH = dict(beta=1.4, u=0.12, kappa=0.55)
OBS_CALIB_START = dict(beta=1.2, u=0.14, kappa=0.6)  # the recovery fixture's start
# the recovery fixture's budget, which the fit needs about 210 steps of to
# converge; the breaching calibration stops long before that
OBS_CALIB_STEPS = 400
OBS_CALIB_BREACH_STEPS = 12
# the seeded plan of the faulted tiled run: a retried transient and a NaN
# result that the degrade ladder repairs
OBS_FAULTS = [{"point": "tile.compute", "kind": "transient", "at_hits": [1]},
              {"point": "tile.result", "kind": "nan", "at_hits": [2], "cells": 2}]
OBS_CPU_TOL = 3.6e-15  # f64, the card-against-CPU class of slices 3-5
OBS_F32_MEAN_RTOL = 1e-6  # a float32 mean of 2,000 beliefs, summed in another order
# The report subcommands the phase runs as subprocesses, each on one run of
# the drive: (subcommand, run, expected exit): 0 on the clean runs, 1 on the
# runs built to breach (a tiled sweep that gives up, an unconverged fit).
OBS_REPORTS = (("render", "serve", 0), ("serve", "serve", 0), ("infomodel", "serve", 0),
               ("resilience", "tiled", 0), ("memory", "tiled", 0),
               ("elastic", "elastic_cold", 0), ("elastic", "elastic_warm", 0),
               ("grad", "grad", 0), ("health", "sweeps", 0),
               ("resilience", "breach", 1), ("grad", "grad_breach", 1))

def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _obs_timed(device, fn):
    """(seconds, result) of one call of ``fn``, fenced on a card."""
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return time.perf_counter() - t0, out


def _obs_events(run_dir) -> list:
    return [json.loads(line) for line in (run_dir / "events.jsonl").read_text().splitlines()]


def _obs_labels(run_dir) -> list:
    """The run's (kind, action or stage or name) sequence, without the
    device and memory snapshots, whose count depends on the device."""
    skip = {"device", "mem"}
    return [(e["kind"], e.get("action") or e.get("stage") or e.get("name"))
            for e in _obs_events(run_dir) if e["kind"] not in skip]


def _obs_pop_doc(size: dict, channel: str) -> dict:
    return {"graph": {"model": "erdos_renyi", "n": size["pop_n"], "avg_degree": POP_DEG},
            "infomodel": {"channel": channel}, "seeds": size["pop_seeds"], "vary": "sim",
            "g0": None}


def _obs_serve(device, size, run_dir, cache, drill: bool) -> dict:
    """The served run: bench_serve's mix through a started engine, a grads
    stream, a bayes and a gossip population query (each query's kernel
    launches read before and after it), and with ``drill`` the breaker
    forced open over the tile cache (every dispatch faulted): grid points
    answer degraded, a point off the grid exhausts the ladder."""
    import os

    import sbr_tpu_torch as st
    from sbr_tpu_torch.resilience import FaultPlan, faults
    from sbr_tpu_torch.serve import Engine, ServeConfig, SolverUnavailable
    from sbr_tpu_torch.serve.loadgen import build_pool, query_mix
    from sbr_tpu_torch.social.fused import BELIEF_KERNEL, KERNEL

    cfg = st.SolverConfig(**size["cfg"])
    pool = build_pool(0, size["pool"])
    mix = query_mix(0, size["pool"], size["queries"])
    saved = os.environ.get("SBR_TILE_CACHE_DIR")
    if cache is not None:
        os.environ["SBR_TILE_CACHE_DIR"] = str(cache)
    try:
        engine = Engine(config=cfg, serve=ServeConfig(buckets=size["buckets"]), device=device,
                        run_dir=None if run_dir is None else str(run_dir)).start()
    finally:
        if saved is None:
            os.environ.pop("SBR_TILE_CACHE_DIR", None)
        else:
            os.environ["SBR_TILE_CACHE_DIR"] = saved
    out = {}
    try:
        g = size["group"]
        t_serve = t0 = time.perf_counter()
        for i in range(0, len(pool), g):
            engine.query_many(pool[i : i + g], scenario="warmup", timeout=600)
        out["warmup_s"] = time.perf_counter() - t0
        hist = engine.live.total_hist.copy()
        t0 = time.perf_counter()
        for i in range(0, len(mix), g):
            engine.query_many([pool[j] for j in mix[i : i + g]], scenario="mix", timeout=600)
        out["mix_s"] = time.perf_counter() - t0
        lat = engine.live.total_hist.delta(hist)
        # the answers as bits: ξ is NaN on a no-run lane
        out.update(p50_ms=lat.quantile(0.5), p99_ms=lat.quantile(0.99),
                   answers=[(r.status, r.flags, np.float64(r.xi).tobytes())
                            for r in engine.query_many(pool)])
        grads_pool = build_pool(1, size["grads"])
        t0 = time.perf_counter()
        for i in range(0, len(grads_pool), g):
            res = engine.query_many(grads_pool[i : i + g], grads=True, timeout=600)
        out["grads_s"] = time.perf_counter() - t0
        out["grads_last"] = (res[-1].status, res[-1].grad_flags, res[-1].grads)
        m = st.make_model_params(**FIG12)
        steps = max(int(round(float(m.economic.eta) / 0.1)), 2)
        out["population"] = {}
        for channel, kernel, other in (("bayes", BELIEF_KERNEL, KERNEL),
                                       ("gossip", KERNEL, BELIEF_KERNEL)):
            before = _launches()
            secs, rec = _obs_timed(device, lambda: engine.query_population(
                m, _obs_pop_doc(size, channel)))
            after = _launches()
            out["population"][channel] = dict(
                seconds=secs, record=rec, launches=after[kernel] - before[kernel],
                other_launches=after[other] - before[other],
                expected_launches=size["pop_seeds"] * steps)
        if drill:
            faults.install(FaultPlan({"seed": 0, "rules": [
                {"point": "serve.dispatch", "kind": "transient"}]}))
            try:
                betas = np.linspace(0.5, 2.0, size["sweep_n"])
                us = np.linspace(0.02, 0.5, size["sweep_n"])
                base = st.make_model_params()
                points = [st.with_overrides(base, beta=float(betas[i]), u=float(us[j]))
                          for i, j in ((0, 0), (1, 3), (5, 2), (7, 7))]
                sources = [engine.query(p, timeout=600).source for p in points]
                try:
                    engine.query(st.with_overrides(base, beta=3.0, u=0.7), timeout=600)
                    sources.append("answered")
                except SolverUnavailable as err:  # off the grid: the ladder is exhausted
                    sources.append(type(err).__name__)
            finally:
                faults.install(None)
            out["drill_sources"] = sources
        out["statz"] = engine.statz()
    finally:
        engine.close()
    out["seconds"] = time.perf_counter() - t_serve
    return out


def _obs_drive(device, size_name: str, root, run: bool = True) -> dict:
    """Every instrumented path once on ``device``, each under its own run
    directory below ``root`` (without a run directory when not ``run``):
    the faulted tiled sweep, the elastic sweep cold and warm over one tile
    cache, the served run, a calibration, a scenario grid with a policy
    sweep and a generated graph, and a resilience run built to breach
    (every tile attempt faulted) with a calibration whose budget ends
    before it converges. Returns the outputs, seconds a run and
    the run directories."""
    import contextlib

    import sbr_tpu_torch as st
    from sbr_tpu_torch import grad, obs
    from sbr_tpu_torch.resilience import FaultPlan, elastic, faults

    size = OBS_SIZES[size_name]
    cfg = st.SolverConfig(**size["cfg"])
    base = st.make_model_params()
    betas = np.linspace(0.5, 2.0, size["sweep_n"])
    us = np.linspace(0.02, 0.5, size["sweep_n"])
    tile = (size["tile"], size["tile"])
    dirs = {name: root / name for name in ("tiled", "elastic_cold", "elastic_warm", "serve",
                                           "grad", "grad_breach", "sweeps", "breach")}
    out = {"dirs": dirs, "seconds": {}}

    def logged(name):
        if not run:
            return contextlib.nullcontext()
        return obs.run_context(label=name, run_dir=str(dirs[name]))

    import os
    os.environ["SBR_RETRY_BASE_DELAY_S"] = "0.01"
    try:
        faults.install(FaultPlan({"seed": 3, "rules": OBS_FAULTS}))
        try:
            with logged("tiled"):
                rep = {}
                out["seconds"]["tiled"], grid = _obs_timed(device, lambda: st.run_tiled_grid(
                    betas, us, base, config=cfg, tile_shape=tile,
                    checkpoint_dir=str(root / "ck_tiled"), device=device, report=rep))
        finally:
            faults.install(None)
        out["tiled"] = dict(report=rep, xi=grid.xi.numpy(), max_aw=grid.max_aw.numpy(),
                            status=grid.status.numpy())
        cache = root / "tile_cache"
        for name in ("elastic_cold", "elastic_warm"):
            rep = {}
            with logged(name):
                out["seconds"][name], grid = _obs_timed(device, lambda: elastic.run_elastic_grid(
                    betas, us, base, str(root / f"ck_{name}"), config=cfg, tile_shape=tile,
                    poll_s=0.05, timeout_s=600.0, tile_cache_dir=str(cache), device=device,
                    report=rep))
            out[name] = dict(report=rep, xi=grid.xi.numpy(), status=grid.status.numpy())
        out["serve"] = _obs_serve(device, size, dirs["serve"] if run else None, cache,
                                  drill=True)
        out["seconds"]["serve"] = out["serve"]["seconds"]
        truth = st.make_model_params(**OBS_CALIB_TRUTH)
        gcfg = st.SolverConfig(**GRAD_CFG)
        with logged("grad"):
            t_obs, aw_obs, xi_obs = grad.synth_withdrawals(truth, n_obs=size["calib_obs"],
                                                           config=gcfg, device=device)
            out["seconds"]["grad"], fit = _obs_timed(device, lambda: grad.fit_withdrawals(
                t_obs, aw_obs, st.with_overrides(truth, **OBS_CALIB_START), xi_obs=xi_obs,
                steps=OBS_CALIB_STEPS, config=gcfg, device=device))
        out["grad"] = dict(steps=fit.steps, converged=fit.converged, loss=fit.loss,
                           params=fit.params)
        with logged("grad_breach"):  # built to breach: the budget ends unconverged
            fit = grad.fit_withdrawals(t_obs, aw_obs, st.with_overrides(truth, **OBS_CALIB_START),
                                       xi_obs=xi_obs, steps=OBS_CALIB_BREACH_STEPS, config=gcfg,
                                       device=device)
        out["grad_breach"] = dict(steps=fit.steps, converged=fit.converged, loss=fit.loss)
        n, (pb, pu, pr) = size["scen_n"], size["policy"]
        with logged("sweeps"):
            t0 = time.perf_counter()
            scen = st.scenario_grid(st.ScenarioSpec(modifiers=("insurance_cap", "lolr")),
                                    np.linspace(0.25, 3.0, n), np.linspace(0.01, 0.99, n),
                                    st.make_model_params(insurance_cap=0.2, lolr_rate=0.1),
                                    config=cfg, device=device)
            pol = st.policy_sweep_interest(
                np.linspace(0.5, 3.0, pb), np.linspace(0.0, 0.45, pu), np.linspace(0.0, 0.09, pr),
                st.make_interest_params(u=0.0, delta=0.1), config=cfg, device=device)
            pg = st.prepare_generated_graph(st.ErdosRenyiSpec(size["graph_n"], 10.0), seed=1,
                                            device=device)
            _sync(device)
            out["seconds"]["sweeps"] = time.perf_counter() - t0
        out["sweeps"] = dict(
            scen_xi=scen.xi.cpu().numpy(), scen_status=scen.status.cpu().numpy(),
            pol_xi=pol.xi.cpu().numpy(), pol_status=pol.status.cpu().numpy(),
            graph_edges=int(pg.n_edges), graph_row_ptr=pg.row_ptr.cpu().numpy())
        faults.install(FaultPlan({"seed": 0, "rules": [
            {"point": "tile.compute", "kind": "transient"}]}))
        try:
            with logged("breach"):
                try:
                    st.run_tiled_grid(betas[:8], us[:8], base, config=cfg, tile_shape=(8, 8),
                                      device=device, max_retries=1)
                    out["breach"] = "completed"
                except RuntimeError as err:  # built to give up: the gate must read it
                    if not isinstance(err.__cause__, faults.InjectedFault):
                        raise
                    out["breach"] = "gave_up"
        finally:
            faults.install(None)
    finally:
        os.environ.pop("SBR_RETRY_BASE_DELAY_S", None)
    return out


def _obs_report_codes(drive: dict) -> dict:
    """Each report of OBS_REPORTS in this process: {(sub, run): (exit, doc)}."""
    import contextlib
    import io

    from sbr_tpu_torch.obs import report

    out = {}
    for sub, run, _ in OBS_REPORTS:
        argv = ([] if sub == "render" else [sub]) + [str(drive["dirs"][run]), "--json"]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            code = report.main(argv)
        out[(sub, run)] = (code, json.loads(buf.getvalue()))
    return out


def _obs_checks(drive: dict, codes: dict) -> dict:
    """Folded counts against the events, the engine's statz and the sweeps'
    ``report=`` counts, and every report's exit code against its expected
    one. Returns the numbers it compared; raises on a mismatch."""
    for sub, run, want in OBS_REPORTS:
        if codes[(sub, run)][0] != want:
            raise AssertionError(f"report {sub} on {run}: exit {codes[(sub, run)][0]}, "
                                 f"want {want}")
    serve_events = _obs_events(drive["dirs"]["serve"])
    ladder_events = {a: sum(1 for e in serve_events
                            if e["kind"] == "fleet" and e.get("action") == a)
                     for a in ("degraded", "ladder_exhausted")}
    statz_ladder = {a: drive["serve"]["statz"]["ladder"][a] for a in ladder_events}
    tiled_rep = drive["tiled"]["report"]
    res_doc = codes[("resilience", "tiled")][1]
    cold, warm = (codes[("elastic", f"elastic_{w}")][1] for w in ("cold", "warm"))
    warm_hits = sum(1 for e in _obs_events(drive["dirs"]["elastic_warm"])
                    if e["kind"] == "cache" and e.get("action") == "hit")
    counts = dict(
        ladder_events=ladder_events, statz_ladder=statz_ladder,
        drill_sources=drive["serve"]["drill_sources"],
        repairs_folded=res_doc["repairs"].get("degrade_ladder", {}).get("count", 0),
        repairs_reported=len(tiled_rep["repairs"]),
        retries_folded={k: v["recovered"] for k, v in res_doc["retries"].items()},
        tiled_counts=tiled_rep["counts"],
        elastic_cold=[cold["tiles_computed"], cold["tiles_from_cache"]],
        elastic_cold_report=drive["elastic_cold"]["report"]["counts"],
        elastic_warm=[warm["tiles_computed"], warm["tiles_from_cache"]],
        elastic_warm_report=drive["elastic_warm"]["report"]["counts"],
        warm_cache_hit_events=warm_hits,
        breach=drive["breach"], breach_unrecovered=codes[("resilience", "breach")][1][
            "unrecovered"],
    )
    cr, wr = counts["elastic_cold_report"], counts["elastic_warm_report"]
    ok = (ladder_events == statz_ladder and ladder_events["degraded"] == 4
          and ladder_events["ladder_exhausted"] >= 1
          and counts["repairs_folded"] == counts["repairs_reported"] == 2
          and sum(counts["retries_folded"].values()) == 1
          and counts["elastic_cold"] == [cr["computed"], cr["cache"] + cr["local"]]
          and counts["elastic_warm"] == [wr["computed"], wr["cache"] + wr["local"]]
          and wr["computed"] == 0 and warm_hits == wr["cache"] > 0
          and drive["breach"] == "gave_up" and counts["breach_unrecovered"] >= 1)
    if not ok:
        raise AssertionError(f"obs: folded counts disagree: {counts}")
    return counts


def _obs_cli(drive: dict) -> list:
    """Each report of OBS_REPORTS as ``python -m sbr_tpu_torch.obs.report``,
    a subprocess with a timeout: its exit code and wall time."""
    import os

    env = {**os.environ, "PYTHONPATH": str(_REPO_ROOT)}
    rows = []
    for sub, run, want in OBS_REPORTS:
        argv = ([] if sub == "render" else [sub]) + [str(drive["dirs"][run]), "--json"]
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "sbr_tpu_torch.obs.report", *argv],
                              capture_output=True, text=True, timeout=120, env=env,
                              cwd=str(_REPO_ROOT))
        rows.append(dict(report=sub, run=run, exit=proc.returncode, want=want,
                         wall_s=time.perf_counter() - t0))
        if proc.returncode != want:
            raise AssertionError(f"python -m sbr_tpu_torch.obs.report {sub} {run}: exit "
                                 f"{proc.returncode}, want {want}\n{proc.stderr}")
    return rows


def phase_obs(card: str) -> dict:
    """The run log's wiring and its reader on the card at bench.py's shapes
    (module docstring): the drive (`_obs_drive`) once without run
    directories and once with them, which gives each run's cost and the
    served p50/p99 with and without ``run_dir``; every report subcommand
    in process and as a subprocess, with its expected exit code; the folded
    counts against the events, ``statz()`` and the sweeps' ``report=``;
    ``trend --check`` over three appended records. The
    served population queries launch the infection and belief kernels
    members × steps times each. Returns the launches by kernel of the drive
    with run directories, counted from 0 just before it."""
    import contextlib
    import io
    import tempfile
    from pathlib import Path

    import sbr_tpu_torch as st
    from sbr_tpu_torch import _build
    from sbr_tpu_torch.obs import history, report
    from sbr_tpu_torch.social.fused import BELIEF_KERNEL, KERNEL

    device, size_name = "cuda", "full"
    size = OBS_SIZES[size_name]
    with tempfile.TemporaryDirectory(prefix="sbr_obs_") as tmp:
        root = Path(tmp)
        # one untimed tiled sweep first: the first solve on the card pays
        # the process's warm-up, which would land in the first timed run
        st.run_tiled_grid(np.linspace(0.5, 2.0, size["sweep_n"]),
                          np.linspace(0.02, 0.5, size["sweep_n"]), st.make_model_params(),
                          config=st.SolverConfig(**size["cfg"]),
                          tile_shape=(size["tile"], size["tile"]), device=device)
        _build.reset_launches()
        bare = _obs_drive(device, size_name, root / "bare", run=False)
        launches_without_run = _launches()
        _build.reset_launches()
        drive = _obs_drive(device, size_name, root / "run")
        launches = _launches()
        served, bare_served = drive["serve"], bare["serve"]
        for channel, kernel in (("bayes", BELIEF_KERNEL), ("gossip", KERNEL)):
            p, q = served["population"][channel], bare_served["population"][channel]
            emit("obs_population", channel=channel, n_agents=size["pop_n"],
                 members=size["pop_seeds"], seconds_with_run=p["seconds"],
                 seconds_without_run=q["seconds"], kernel=kernel, launches=p["launches"],
                 other_launches=p["other_launches"], expected_launches=p["expected_launches"],
                 launches_without_run=q["launches"],
                 run_probability=p["record"]["run_probability"],
                 same_record=p["record"]["crossing_times"] == q["record"]["crossing_times"],
                 card=card)
            if not (p["launches"] == p["expected_launches"] == q["launches"]
                    and p["other_launches"] == q["other_launches"] == 0):
                raise AssertionError(f"obs population {channel}: launches {p}, without run {q}")
        emit("obs_serve", queries=size["queries"], pool=size["pool"],
             buckets=list(size["buckets"]), p50_ms_without_run=bare_served["p50_ms"],
             p99_ms_without_run=bare_served["p99_ms"], p50_ms_with_run=served["p50_ms"],
             p99_ms_with_run=served["p99_ms"], mix_s=[bare_served["mix_s"], served["mix_s"]],
             warmup_s=[bare_served["warmup_s"], served["warmup_s"]],
             grads_s=[bare_served["grads_s"], served["grads_s"]], drill=served["drill_sources"],
             ladder=served["statz"]["ladder"], graphs=served["statz"]["graphs"],
             answers_equal=bare_served["answers"] == served["answers"], card=card)
        if bare_served["answers"] != served["answers"]:
            raise AssertionError("obs: the served answers changed with a run directory")
        codes = _obs_report_codes(drive)
        counts = _obs_checks(drive, codes)
        cli = _obs_cli(drive)
        events = {name: len(_obs_events(d)) for name, d in drive["dirs"].items()}
        emit("obs_runs", seconds_with_run=drive["seconds"], seconds_without_run=bare["seconds"],
             events=events, counts=counts, reports=cli, grad=drive["grad"],
             grad_breach=drive["grad_breach"], breach=drive["breach"],
             launches_with_run=launches, launches_without_run=launches_without_run, card=card)
        if launches != launches_without_run:
            raise AssertionError(f"obs: launches {launches} with run directories, "
                                 f"{launches_without_run} without")
        hist = root / "history.jsonl"
        for srv in (bare_served, served, served):
            history.append({"serve_p50_ms": srv["p50_ms"], "serve_p99_ms": srv["p99_ms"]},
                           label="obs_phase", platform="gpu", path=hist)
        # three records of one process gate nothing real: a wide tolerance
        # keeps one card's noise from failing this check of the CLI
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            trend = report.main(["trend", str(hist), "--check", "--tolerance", "10", "--json"])
        # the SIGTERM drill under a run gave way to the chaos phase's base
        # drill: exit 143 and an "interrupted" manifest (`phase_chaos`)
        emit("obs_trend_and_drill", trend_exit=trend, trend=json.loads(buf.getvalue()),
             card=card)
        if trend != 0:
            raise AssertionError(f"trend --check exited {trend}")
    return launches


def _obs_gap(a, b) -> float:
    return _nan_gap(torch.as_tensor(np.asarray(a)), torch.as_tensor(np.asarray(b)))


def _obs_compare(card: dict, cpu: dict, codes_card: dict, codes_cpu: dict) -> dict:
    """The small drive on the card against the CPU: event sequences,
    statuses and counts equal, exit codes with OBS_REPORTS' expected one
    beside them; grid floats within OBS_CPU_TOL."""
    labels = {name: _obs_labels(d) == _obs_labels(cpu["dirs"][name])
              for name, d in card["dirs"].items()}
    exits = {f"{s}:{r}": [codes_card[(s, r)][0], codes_cpu[(s, r)][0], want]
             for s, r, want in OBS_REPORTS}
    ints = {
        "tiled_status": np.array_equal(card["tiled"]["status"], cpu["tiled"]["status"]),
        "tiled_counts": card["tiled"]["report"]["counts"] == cpu["tiled"]["report"]["counts"],
        "repairs": card["tiled"]["report"]["repairs"] == cpu["tiled"]["report"]["repairs"],
        "elastic": [card[k]["report"]["counts"] for k in ("elastic_cold", "elastic_warm")]
        == [cpu[k]["report"]["counts"] for k in ("elastic_cold", "elastic_warm")],
        "scen_status": np.array_equal(card["sweeps"]["scen_status"], cpu["sweeps"]["scen_status"]),
        "pol_status": np.array_equal(card["sweeps"]["pol_status"], cpu["sweeps"]["pol_status"]),
        "graph": card["sweeps"]["graph_edges"] == cpu["sweeps"]["graph_edges"]
        and np.array_equal(card["sweeps"]["graph_row_ptr"], cpu["sweeps"]["graph_row_ptr"]),
        "served_status": [a[:2] for a in card["serve"]["answers"]]
        == [a[:2] for a in cpu["serve"]["answers"]],
        "drill": card["serve"]["drill_sources"] == cpu["serve"]["drill_sources"],
        "ladder": card["serve"]["statz"]["ladder"] == cpu["serve"]["statz"]["ladder"],
        "grad": [(card[k]["steps"], card[k]["converged"]) for k in ("grad", "grad_breach")]
        == [(cpu[k]["steps"], cpu[k]["converged"]) for k in ("grad", "grad_breach")],
        "breach": card["breach"] == cpu["breach"],
    }
    gaps = {
        "tiled_xi": _obs_gap(card["tiled"]["xi"], cpu["tiled"]["xi"]),
        "tiled_max_aw": _obs_gap(card["tiled"]["max_aw"], cpu["tiled"]["max_aw"]),
        "elastic_xi": _obs_gap(card["elastic_warm"]["xi"], cpu["elastic_warm"]["xi"]),
        "scen_xi": _obs_gap(card["sweeps"]["scen_xi"], cpu["sweeps"]["scen_xi"]),
        "pol_xi": _obs_gap(card["sweeps"]["pol_xi"], cpu["sweeps"]["pol_xi"]),
        "served_xi": _obs_gap(np.array([np.frombuffer(a[2])[0] for a in card["serve"]["answers"]]),
                              np.array([np.frombuffer(a[2])[0] for a in cpu["serve"]["answers"]])),
    }
    # the calibration's loss runs through Adam steps that amplify the
    # forward's last bits: held to the CPU tests' 1e-8 relative
    loss_rel = abs(card["grad"]["loss"] - cpu["grad"]["loss"]) / abs(cpu["grad"]["loss"])
    return dict(labels=labels, exits=exits, ints=ints, gaps=gaps, calib_loss_rel=loss_rel)


def phase_obs_cpu_vs_card() -> None:
    """The obs drive at small sizes on the CPU and on the card: every run's
    event sequence, statuses and counts equal, each report's exit code the
    expected one on both devices, the grid and served floats within
    OBS_CPU_TOL (f64); then a bayes and a gossip
    population query under a run from one fixed point with the CPU's
    per-agent fields on both devices: records and infomodel events equal."""
    import tempfile
    from pathlib import Path

    import sbr_tpu_torch as st
    from sbr_tpu_torch import obs
    from sbr_tpu_torch.infomodels import engine, population_query

    with tempfile.TemporaryDirectory(prefix="sbr_obs_cpu_") as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        drives = {dev: _obs_drive(d, "small", root / dev)
                  for dev, d in (("card", "cuda"), ("cpu", "cpu"))}
        drive_s = time.perf_counter() - t0
        codes = {dev: _obs_report_codes(d) for dev, d in drives.items()}
        cmp = _obs_compare(drives["card"], drives["cpu"], codes["card"], codes["cpu"])
        m = st.make_model_params(**FIG12)
        recs, labels = {}, {}
        draw = engine._agent_fields

        def cpu_fields(spec_, n, seed, beta, dtype, device):
            return tuple(f.to(device) for f in draw(spec_, n, seed, beta, dtype, "cpu"))

        engine._agent_fields = cpu_fields
        try:
            for channel in ("bayes", "gossip"):
                spec = st.InfoModelSpec(channel=channel)
                fp = st.solve_fixed_point_info(spec, m, config=st.SolverConfig(n_grid=POP_GRID),
                                               max_iter=500, device="cpu")
                for dev, device in (("cpu", "cpu"), ("card", "cuda")):
                    d = root / f"pop_{channel}_{dev}"
                    with obs.run_context(label="pop", run_dir=str(d)):
                        recs[(channel, dev)] = population_query(
                            spec, st.ErdosRenyiSpec(OBS_SIZES["small"]["pop_n"], POP_DEG), m,
                            seeds=OBS_SIZES["small"]["pop_seeds"], vary="sim", seed=7, g0=None,
                            fp=fp, device=device)
                    labels[(channel, dev)] = [
                        {k: v for k, v in e.items() if k not in ("mono", "ts")}
                        for e in _obs_events(d) if e["kind"] == "infomodel"]
        finally:
            engine._agent_fields = draw
    pops, mean_rel = {}, 0.0
    for ch in ("bayes", "gossip"):
        a, b = labels[(ch, "cpu")], labels[(ch, "card")]
        # the belief census's mean is a float32 sum, which the card and
        # the CPU associate apart: held within OBS_F32_MEAN_RTOL, every
        # other field exactly
        for x, y in zip(a, b):
            if "mean_belief" in x and "mean_belief" in y:
                mean_rel = max(mean_rel, abs(x["mean_belief"] - y["mean_belief"])
                               / max(abs(x["mean_belief"]), 1e-30))
        strip = [[{k: v for k, v in e.items() if k != "mean_belief"} for e in ev]
                 for ev in (a, b)]
        pops[ch] = dict(records=recs[(ch, "cpu")] == recs[(ch, "card")],
                        events=strip[0] == strip[1] and len(a) == len(b))
    emit("obs_cpu_vs_card", runs_equal=cmp["labels"], report_exits=cmp["exits"],
         discrete_equal=cmp["ints"], max_abs=cmp["gaps"], tol=OBS_CPU_TOL,
         calib_loss_rel=cmp["calib_loss_rel"], population_equal=pops,
         census_mean_belief_rel=mean_rel, census_tol=OBS_F32_MEAN_RTOL, seconds=drive_s)
    exits_equal = all(a == b == want for a, b, want in cmp["exits"].values())
    if not (all(cmp["labels"].values()) and exits_equal and all(cmp["ints"].values())
            and max(cmp["gaps"].values()) <= OBS_CPU_TOL and cmp["calib_loss_rel"] <= 1e-8
            and all(all(v.values()) for v in pops.values()) and mean_rel <= OBS_F32_MEAN_RTOL):
        raise AssertionError(f"obs card vs CPU: {cmp}, populations {pops}")


# ---------------------------------------------------------------------------
# Slice 13: request tracing, the flight recorder and the demand observatory
# ---------------------------------------------------------------------------

# The telemetry drive's sizes. "full": bench.py's serving mix (pool 64,
# 2,048 queries, buckets 1/8/64, n_grid 1024) with a cold stream of 4,096
# distinct queries after it (64 dispatches of 64, so that no single host
# stall decides the flight recorder's busy fraction), bench_infomodels' population shape (20,000
# agents, 16 members, 333 steps) over HTTP, loadgen, and the obs phase's
# faulted tiled sweep (128×128 in 64×64 tiles). "small": the same drive at
# sizes the CPU runs in seconds, for the card-against-CPU phase.
TELEM_SIZES = {
    "full": dict(pool=64, queries=2048, group=16, buckets=(1, 8, 64), cold=4096, cold_group=64,
                 profiled_cold=1024,
                 cfg=BENCH_SWEEP_CFG, pop_n=POP_N, pop_seeds=OBS_POP_SEEDS,
                 sweep_n=BENCH_SWEEP_N, tile=BENCH_SWEEP_TILE, loadgen_queries=512,
                 breach_rounds=6, rounds=2),
    "small": dict(pool=8, queries=48, group=8, buckets=(1, 8), cold=32, cold_group=8,
                  cfg=dict(n_grid=96, bisect_iters=40, refine_crossings=False), pop_n=2_000,
                  pop_seeds=2, sweep_n=16, tile=8, loadgen_queries=48, breach_rounds=6,
                  rounds=1),
}
# The served runs of a round: every switch off, then each alone. A round
# repeats in "full" (the spread of one call), after an untimed first run
# that pays the first engine's costs.
# The flight run's ring holds every record of the mix and of the cold
# stream (~5 records a query), so its folds drop nothing.
TELEM_FLIGHT_CAP = 1 << 16
TELEM_RUNS = (("off", {}), ("trace", {"SBR_TRACE_SAMPLE": "1"}),
              ("flight", {"SBR_FLIGHT": "1", "SBR_FLIGHT_CAP": str(TELEM_FLIGHT_CAP)}),
              ("demand", {"SBR_DEMAND": "1"}))
TELEM_ALL = {"SBR_TRACE_SAMPLE": "1", "SBR_FLIGHT": "1", "SBR_DEMAND": "1"}
# Every knob the drive sets; each starts unset and is restored after.
TELEM_KNOBS = ("SBR_TRACE_SAMPLE", "SBR_FLIGHT", "SBR_DEMAND", "SBR_FLIGHT_CAP",
               "SBR_SERVE_SLO_MS", "SBR_TRACE_MAX_MB", "SBR_FLIGHT_ROTATE_S",
               "SBR_DEMAND_ROTATE_S", "SBR_FLIGHT_UTIL_FLOOR", "SBR_DEMAND_COVERAGE_FLOOR",
               "SBR_FLIGHT_MIN_DISPATCHES", "SBR_DEMAND_BINS", "SBR_DEMAND_TOPK",
               "SBR_TILE_CACHE_DIR", "SBR_SERVE_DEADLINE_MS")
# The breach run: an SLO no query meets, and rotation knobs that leave
# rotated span, demand and flight files for gc's keep flags (the span
# file's floor is 64 KiB).
TELEM_BREACH_ENV = {"SBR_SERVE_SLO_MS": "0.000001", "SBR_TRACE_MAX_MB": "0",
                    "SBR_FLIGHT_ROTATE_S": "0.2", "SBR_DEMAND_ROTATE_S": "0.2"}
TELEM_BREACH_QUERIES = 512
# The report knobs that make the breach run's util and demand gates fail
# (its one or two dispatches arm the floor at 1).
TELEM_REPORT_BREACH_ENV = {"SBR_FLIGHT_UTIL_FLOOR": "0.999", "SBR_FLIGHT_MIN_DISPATCHES": "1",
                           "SBR_DEMAND_COVERAGE_FLOOR": "0.999"}
# (report, run, knobs, expected exit): 0 on the clean runs, 1 on the breach
TELEM_REPORTS = (("trace", "trace", {}, 0), ("slo", "trace", {}, 0),
                 ("util", "flight", {}, 0), ("demand", "demand", {}, 0),
                 ("trace", "population", {}, 0), ("trace", "loadgen", {}, 0),
                 ("demand", "loadgen", {}, 0), ("util", "tiled", {}, 0),
                 ("trace", "breach", {}, 1), ("slo", "breach", {}, 1),
                 ("util", "breach", TELEM_REPORT_BREACH_ENV, 1),
                 ("demand", "breach", TELEM_REPORT_BREACH_ENV, 1))
TELEM_GC_KEEP = 1


@contextlib.contextmanager
def _env(changes: dict):
    """``with _env({...}):`` os.environ changed for the block (a None value
    unsets), then restored."""
    import os

    saved = {k: os.environ.get(k) for k in changes}
    try:
        for k, v in changes.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _telem_report(sub: str, run_dir, knobs: dict, *extra) -> tuple:
    """``report SUB RUN_DIR --json`` in this process under ``knobs``:
    (exit, document)."""
    import io

    from sbr_tpu_torch.obs import report

    buf = io.StringIO()
    with _env(knobs), contextlib.redirect_stdout(buf):
        code = report.main([sub, str(run_dir), *extra, "--json"])
    return code, json.loads(buf.getvalue())


def _telem_trace_spans(run_dir, ids) -> list:
    """The committed spans of each trace id of ``ids``, in that order."""
    from sbr_tpu_torch.obs import trace

    spans, bad = trace.load_spans(run_dir)
    if bad:
        raise AssertionError(f"{bad} torn span line(s) in {run_dir}")
    by = {}
    for s in spans:
        by.setdefault(s["trace"], []).append(s)
    return [by.get(t, []) for t in ids]


def _telem_shape(spans: list) -> list:
    """A trace's spans as (name, parent's name): ids and times dropped."""
    names = {s["span"]: s["name"] for s in spans}
    return [(s["name"], names.get(s.get("parent"), "remote" if s.get("parent") else None))
            for s in spans]


def _telem_kinds(records) -> dict:
    """Flight records counted by "stream/kind/tag" (begins and points)."""
    out = {}
    for r in records:
        if r[5] in ("b", "p"):
            key = f"{r[1]}/{r[2]}/{r[3]}"
            out[key] = out.get(key, 0) + 1
    return dict(sorted(out.items()))


def _telem_served(device, size: dict, name: str, env: dict, root, started: bool) -> dict:
    """One served run under ``env``, its engine owning ``root / name``
    (started, or inline when not ``started``): every pool member once (the
    warm-up), the seeded mix, then a cold stream of distinct queries. With
    tracing on, each measured query carries a minted trace committed with
    its ``loadgen.query`` root, as loadgen does. The pool's answers are read
    (all hits) after the mix; the flight recorder is folded and reset after
    the warm-up and after that read (the metrics are read then too), and
    folded again after the cold stream; the engine closes straight after
    it, so ``flight.json`` covers the cold stream alone. Returns the
    answers as bits, p50/p99 and seconds of the mix and of the cold stream
    (exact percentiles of the engine's per-query latencies, and the live
    histogram's quantiles as earlier phases read them), the flight folds
    of the mix and of the cold stream, and what the recorders hold."""
    import sbr_tpu_torch as st
    from sbr_tpu_torch.obs import trace as qtrace
    from sbr_tpu_torch.serve import Engine, ServeConfig
    from sbr_tpu_torch.serve.loadgen import build_pool, query_mix

    pool = build_pool(0, size["pool"])
    mix = query_mix(0, size["pool"], size["queries"])
    cold = build_pool(7, size["cold"])
    out = {"name": name, "spans": [], "kinds_mix": {}}
    with _env(env):
        if "SBR_FLIGHT" in env:
            from sbr_tpu_torch.obs import flight

            flight.reset_shared()
        engine = Engine(config=st.SolverConfig(**size["cfg"]),
                        serve=ServeConfig(buckets=size["buckets"]), device=device,
                        run_dir=str(root / name))
        if started:
            engine.start()
        tracing = qtrace.sample_rate() > 0
        writer = engine.trace_writer()

        def serve(params, group, scenario):
            answers = []
            for i in range(0, len(params), group):
                chunk = params[i : i + group]
                ctxs = None
                if tracing:
                    ctxs = [qtrace.mint("loadgen") for _ in chunk]
                    for c in ctxs:
                        c.parent_id = c.alloc_id()
                t0w, t0m = time.time(), time.monotonic()
                res = engine.query_many(chunk, scenario=scenario, timeout=600, traces=ctxs)
                dur = time.monotonic() - t0m
                for c, r in zip(ctxs or (), res):
                    c.add("loadgen.query", t0w, dur, parent=c.remote_parent, span_id=c.parent_id,
                          source=r.source)
                    writer.commit(c)
                    out["spans"].append(c.spans)
                answers += res
            return answers

        try:
            g = size["group"]
            t0 = time.perf_counter()
            for i in range(0, len(pool), g):
                engine.query_many(pool[i : i + g], scenario="warmup", timeout=600)
            out["warmup_s"] = time.perf_counter() - t0
            if engine.flight is not None:
                engine.flight.reset()
            hist = engine.live.total_hist.copy()
            t0 = time.perf_counter()
            mix_res = serve([pool[j] for j in mix], g, "mix")
            out["mix_s"] = time.perf_counter() - t0
            lat = engine.live.total_hist.delta(hist)
            ms = np.array([r.latency_s for r in mix_res]) * 1e3
            out.update(p50_ms=float(np.percentile(ms, 50)), p99_ms=float(np.percentile(ms, 99)),
                       p50_hist_ms=lat.quantile(0.5), p99_hist_ms=lat.quantile(0.99))
            if engine.flight is not None:
                from sbr_tpu_torch.obs import flight

                snap = engine.flight.snapshot()
                out["util_mix"] = flight.derive_utilization(snap)
                out["kinds_mix"] = _telem_kinds(snap["records"])
            pool_res = engine.query_many(pool, timeout=600)
            text = engine.prometheus()
            out["metrics_words"] = [w for w in ("sbr_flight", "sbr_demand", "sbr_trace_span_ms")
                                    if w in text]
            out["statz_blocks"] = [k for k in ("flight", "demand") if k in engine.statz()]
            if engine.flight is not None:
                engine.flight.reset()
            t0 = time.perf_counter()
            cold_res = serve(cold, size["cold_group"], "cold")
            out["cold_s"] = time.perf_counter() - t0
            if engine.flight is not None:
                out["util_cold"] = flight.derive_utilization(engine.flight.snapshot())
        finally:
            engine.close()
    ms = np.array([r.latency_s for r in cold_res]) * 1e3
    out.update(cold_p50_ms=float(np.percentile(ms, 50)), cold_p99_ms=float(np.percentile(ms, 99)),
               cold_eq_per_s=len(cold) / out["cold_s"])
    out["bits"] = [(r.status, r.flags, np.float64(r.xi).tobytes(), np.float64(r.aw_max).tobytes())
                   for r in pool_res + cold_res]
    d = root / name
    if (d / "flight.json").exists():
        out["kinds_cold"] = _telem_kinds(json.loads((d / "flight.json").read_text())["records"])
    if (d / "demand.json").exists():
        out["demand_totals"] = json.loads((d / "demand.json").read_text())["totals"]
        out["plan_bytes"] = (d / "advisor_plan.json").read_bytes()
    return out


def _telem_profiled_cold(device, size: dict, root) -> dict:
    """The first ``profiled_cold`` queries of the off run's cold stream
    again, on a fresh engine, under torch.profiler: their kernels' summed
    device time over their wall time (the serve phase's busy share), and
    the same for the (all-hit) mix before them. The stream runs ~10^5
    kernels a 1,000 queries; only device activity is traced, over a
    quarter of the stream."""
    from torch.profiler import ProfilerActivity, profile

    import sbr_tpu_torch as st
    from sbr_tpu_torch.serve import Engine, ServeConfig
    from sbr_tpu_torch.serve.loadgen import build_pool, query_mix

    pool = build_pool(0, size["pool"])
    mix = query_mix(0, size["pool"], size["queries"])
    cold = build_pool(7, size["cold"])[: size["profiled_cold"]]
    engine = Engine(config=st.SolverConfig(**size["cfg"]), serve=ServeConfig(
        buckets=size["buckets"]), device=device).start()
    out = {}
    try:
        g = size["group"]
        for i in range(0, len(pool), g):
            engine.query_many(pool[i : i + g], timeout=600)
        for name, params, group in (("mix", [pool[j] for j in mix], g),
                                    ("cold", cold, size["cold_group"])):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for i in range(0, len(params), group):
                    engine.query_many(params[i : i + group], timeout=600)
                torch.cuda.synchronize()
                wall_s = time.perf_counter() - t0
            rows = _device_rows(prof)
            device_s = sum(us for us, _ in rows.values()) / 1e6
            out[name] = dict(wall_s=wall_s, device_s=device_s, busy_share=device_s / wall_s,
                             kernels=sum(c for _, c in rows.values()))
    finally:
        engine.close()
    if out["cold"]["device_s"] <= 0:
        raise AssertionError("the profiler saw no device time in the cold stream")
    return out


def _telem_breach(device, size: dict, root) -> dict:
    """The run built to breach: a started engine with every switch on, an
    SLO no query meets and the rotation knobs; rounds of pool queries, half
    of whose traces are committed without their root (so the join has
    orphans), the other half with it (so the SLO has roots to judge), and
    a pause after each round that lets the batcher's live writes rotate
    ``flight.json`` and ``demand.json``."""
    import sbr_tpu_torch as st
    from sbr_tpu_torch.obs import flight
    from sbr_tpu_torch.obs import trace as qtrace
    from sbr_tpu_torch.serve import Engine, ServeConfig
    from sbr_tpu_torch.serve.loadgen import build_pool

    pool = build_pool(0, size["pool"])
    per_round = TELEM_BREACH_QUERIES // size["breach_rounds"]
    with _env({**TELEM_ALL, **TELEM_BREACH_ENV}):
        flight.reset_shared()
        engine = Engine(config=st.SolverConfig(**size["cfg"]),
                        serve=ServeConfig(buckets=size["buckets"]), device=device,
                        run_dir=str(root / "breach")).start()
        writer = engine.trace_writer()
        try:
            for _ in range(size["breach_rounds"]):
                params = [pool[i % len(pool)] for i in range(per_round)]
                ctxs = [qtrace.mint("loadgen") for _ in params]
                for c in ctxs:
                    c.parent_id = c.alloc_id()
                t0w, t0m = time.time(), time.monotonic()
                engine.query_many(params, timeout=600, traces=ctxs)
                for k, c in enumerate(ctxs):
                    if k % 2 == 0:  # the odd ones keep a root that is never added
                        c.add("loadgen.query", t0w, time.monotonic() - t0m,
                              parent=c.remote_parent, span_id=c.parent_id)
                    writer.commit(c)
                time.sleep(0.6)
        finally:
            engine.close()
    d = root / "breach"
    return {"rotated": {k: len(list(d.glob(p))) for k, p in (
        ("trace", "trace.*.jsonl"), ("demand", "demand.*.json"), ("flight", "flight.*.json"))}}


def _telem_population(device, size: dict, root) -> dict:
    """Traced population queries over HTTP with every switch on: one a
    channel through `ServeEndpoint` → `Engine.query_population`, each
    query's kernel launches read before and after it. Returns the launches,
    seconds, echoed and body trace ids, the joined spans and the demand
    surface's kinds."""
    import sbr_tpu_torch as st
    from sbr_tpu_torch import _build
    from sbr_tpu_torch.obs import flight
    from sbr_tpu_torch.obs import trace as qtrace
    from sbr_tpu_torch.serve import Engine, ServeConfig, ServeEndpoint
    from sbr_tpu_torch.serve.loadgen import http_request
    from sbr_tpu_torch.social.fused import BELIEF_KERNEL, KERNEL

    m = st.make_model_params(**FIG12)
    steps = max(int(round(float(m.economic.eta) / 0.1)), 2)
    # the CPU runs each kernel's plain version: no launch
    expected = size["pop_seeds"] * steps if torch.device(device).type == "cuda" else 0
    rows = {}
    with _env(TELEM_ALL):
        flight.reset_shared()
        engine = Engine(config=st.SolverConfig(n_grid=POP_GRID), serve=ServeConfig(buckets=(1,)),
                        device=device, run_dir=str(root / "population")).start()
        endpoint = None
        try:
            endpoint = ServeEndpoint(engine).start()
            _build.reset_launches()
            for channel, kernel, other in (("bayes", BELIEF_KERNEL, KERNEL),
                                           ("gossip", KERNEL, BELIEF_KERNEL)):
                before = _launches()
                t0 = time.perf_counter()
                code, body, hdrs = http_request(endpoint.port, "/query", {
                    **FIG12, "population": _obs_pop_doc(size, channel)}, timeout=600)
                _sync(device)
                secs = time.perf_counter() - t0
                after = _launches()
                if code != 200:
                    raise AssertionError(f"population {channel}: /query answered {code}: {body}")
                rec = json.loads(body)
                rows[channel] = dict(
                    seconds=secs, launches=after[kernel] - before[kernel],
                    other_launches=after[other] - before[other],
                    expected_launches=expected,
                    echoed=hdrs.get(qtrace.TRACE_HEADER), trace_id=rec.get("trace_id"),
                    source=rec["source"], run_probability=rec["run_probability"])
            launches = _launches()
            # each handler commits its trace after its response has gone out
            deadline = time.monotonic() + 60
            while engine.trace_writer().counters["traces"] < len(rows):
                if time.monotonic() > deadline:
                    raise AssertionError(f"traces committed: {engine.trace_writer().counters}")
                time.sleep(0.01)
        finally:
            if endpoint is not None:
                endpoint.close()
            engine.close()
    d = root / "population"
    ids = [rows[c]["trace_id"] for c in ("bayes", "gossip")]
    spans = _telem_trace_spans(d, ids)
    code, doc = _telem_report("trace", d, {}, "--max-waterfalls", "10")
    roots = {w["trace"]: w["rows"][0]["name"] for w in doc.get("waterfalls", [])}
    kinds = sorted({(p or {}).get("kind") for _, _, p in json.loads(
        (d / "demand.json").read_text())["totals"]["sketch"]["items"]})
    return dict(rows=rows, launches=launches, shapes=[_telem_shape(s) for s in spans],
                waterfall_roots=[roots.get(t) for t in ids], demand_kinds=kinds, trace_exit=code)


def _telem_loadgen(device, size: dict, root) -> dict:
    """loadgen with ``--trace-out`` and ``--run-dir`` (tracing and demand on),
    then ``python -m sbr_tpu_torch.obs.demand replay`` over its rows as a
    subprocess: the replayed surface must be the engine's, bin for bin,
    once the warm-up (every pool member once, each computed) is taken out."""
    import io
    import os

    from sbr_tpu_torch.obs import demand
    from sbr_tpu_torch.serve import loadgen
    from sbr_tpu_torch.serve.loadgen import build_pool

    d = root / "loadgen"
    rows = root / "loadgen_rows.jsonl"
    cfg = size["cfg"]
    argv = ["--queries", str(size["loadgen_queries"]), "--pool", str(size["pool"]),
            "--group", str(size["group"]), "--n-grid", str(cfg["n_grid"]),
            "--bisect-iters", str(cfg["bisect_iters"]),
            "--buckets", ",".join(str(b) for b in size["buckets"]), "--run-dir", str(d),
            "--trace-out", str(rows)] + (["--device", "cpu"] if device == "cpu" else [])
    buf = io.StringIO()
    with _env({"SBR_TRACE_SAMPLE": "1", "SBR_DEMAND": "1"}), contextlib.redirect_stdout(buf):
        rc = loadgen.main(argv)
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    if rc != 0:
        raise AssertionError(f"loadgen exited {rc}: {summary}")
    surf, plan = root / "replayed.json", root / "replayed_plan.json"
    env = {k: v for k, v in os.environ.items() if k not in TELEM_KNOBS}
    proc = subprocess.run([sys.executable, "-m", "sbr_tpu_torch.obs.demand", "replay", str(rows),
                           "--out", str(surf), "--plan-out", str(plan), "--json"],
                          capture_output=True, text=True, timeout=120, cwd=str(_REPO_ROOT),
                          env={**env, "PYTHONPATH": str(_REPO_ROOT)})
    if proc.returncode != 0:
        raise AssertionError(f"demand replay exited {proc.returncode}: {proc.stderr}")
    replayed = json.loads(surf.read_text())
    engine_surface = json.loads((d / "demand.json").read_text())["totals"]
    warm = {}
    for p in build_pool(0, size["pool"]):
        i, j = demand.bin_of(p.learning.beta, p.economic.u, engine_surface["bins"])
        warm[f"{i},{j}"] = warm.get(f"{i},{j}", 0) + 1
    rebuilt = {}
    for key, cell in engine_surface["cells"].items():
        srcs = dict(cell["sources"])
        srcs["computed"] = srcs.get("computed", 0) - warm.get(key, 0)
        n = cell["count"] - warm.get(key, 0)
        if n:
            rebuilt[key] = {"count": n, "sources": {s: v for s, v in sorted(srcs.items()) if v}}
    ids = [json.loads(line)["trace_id"] for line in rows.read_text().splitlines()]
    shapes = [_telem_shape(s) for s in _telem_trace_spans(d, ids)]
    return dict(summary=summary, replay=json.loads(proc.stdout),
                same_bins=rebuilt == replayed["cells"], bins=len(replayed["cells"]),
                engine_cells=engine_surface["cells"], plan_bytes=plan.read_bytes(),
                shapes=shapes)


def _telem_tiled(device, size: dict, root) -> dict:
    """The obs phase's faulted tiled sweep twice, the flight recorder off
    then on (the same seeded faults: a retried transient and a repaired
    NaN): tile files byte-equal, and every tile with its ``compute`` and
    ``ckpt_save`` records."""
    import sbr_tpu_torch as st
    from sbr_tpu_torch.resilience import FaultPlan, faults

    betas = np.linspace(0.5, 2.0, size["sweep_n"])
    us = np.linspace(0.02, 0.5, size["sweep_n"])
    cfg = st.SolverConfig(**size["cfg"])
    secs = {}
    for name, env in (("off", {}), ("on", {"SBR_FLIGHT": "1"})):
        with _env({**env, "SBR_RETRY_BASE_DELAY_S": "0.01"}):
            if env:
                from sbr_tpu_torch.obs import flight

                flight.reset_shared()
            faults.install(FaultPlan({"seed": 3, "rules": OBS_FAULTS}))
            try:
                rep = {}
                secs[name], _ = _obs_timed(device, lambda: st.run_tiled_grid(
                    betas, us, st.make_model_params(), config=cfg,
                    tile_shape=(size["tile"], size["tile"]),
                    checkpoint_dir=str(root / f"tiled_{name}"), device=device, report=rep))
            finally:
                faults.install(None)
    from sbr_tpu_torch.obs import flight

    snap = flight.shared().snapshot()
    (root / "tiled").mkdir()
    (root / "tiled" / "flight.json").write_text(json.dumps(snap))
    tiles = sorted(p.name for p in (root / "tiled_off").glob("tile_*.npz"))
    same = tiles == sorted(p.name for p in (root / "tiled_on").glob("tile_*.npz")) and all(
        (root / "tiled_off" / t).read_bytes() == (root / "tiled_on" / t).read_bytes()
        for t in tiles)
    per_tile = {}
    for r in snap["records"]:
        if r[1] == "sweeps" and r[5] == "b":
            per_tile.setdefault(r[3], []).append(r[2])
    return dict(tiles=len(tiles), bytes_equal=same, seconds=secs, repairs=len(rep["repairs"]),
                per_tile={t: sorted(k) for t, k in sorted(per_tile.items())},
                kinds=_telem_kinds(snap["records"]))


def _telem_gc(root) -> dict:
    """``report gc`` over the drive's run directories with the three keep
    flags: the removed files must be exactly the rotated ones past the
    newest ``TELEM_GC_KEEP`` of each kind in each run (spans by mtime,
    demand, advisor-plan and flight snapshots by name), and every active
    file stays."""
    import io

    from sbr_tpu_torch.obs import report

    runs = root
    want = set()
    for d in (p for p in runs.iterdir() if p.is_dir() and (p / "manifest.json").exists()):
        rotated = sorted(d.glob("trace.*.jsonl"), key=lambda p: p.stat().st_mtime)
        want |= {str(p) for p in rotated[: max(len(rotated) - TELEM_GC_KEEP, 0)]}
        for pattern in ("demand.*.json", "advisor_plan.*.json", "flight.*.json"):
            rotated = sorted(d.glob(pattern))
            want |= {str(p) for p in rotated[: max(len(rotated) - TELEM_GC_KEEP, 0)]}
    active = {str(p) for p in runs.glob("*/*") if p.name in (
        "trace.jsonl", "demand.json", "advisor_plan.json", "flight.json")}
    before = {str(p) for p in runs.rglob("*") if p.is_file()}
    buf = io.StringIO()
    keep = str(TELEM_GC_KEEP)
    with contextlib.redirect_stdout(buf):
        code = report.main(["gc", str(runs), "--keep", "1000", "--trace-keep", keep,
                            "--demand-keep", keep, "--flight-keep", keep])
    after = {str(p) for p in runs.rglob("*") if p.is_file()}
    removed = before - after
    return dict(exit=code, removed=len(removed), expected=len(want),
                same=removed == want and active <= after)


def _telem_drive(device, size_name: str, root, started: bool) -> dict:
    """The slice's paths once on ``device`` below ``root``: the four served
    runs, the breach run, the traced population queries, loadgen with its
    replay, the faulted tiled sweep off and on, every report of
    TELEM_REPORTS and gc's keep flags. Returns everything the phases
    compare, with the population queries' launches counted from 0 just
    before them."""
    size = TELEM_SIZES[size_name]
    runs = root / "runs"
    out = {"warm": _telem_served(device, size, "warm", {}, runs, started), "rounds": []}
    for r in range(size["rounds"]):
        out["rounds"].append({name: _telem_served(device, size, f"{name}.{r}" if r else name,
                                                  env, runs, started)
                              for name, env in TELEM_RUNS})
    out["served"] = out["rounds"][0]
    out["breach"] = _telem_breach(device, size, runs)
    out["population"] = _telem_population(device, size, runs)
    out["loadgen"] = _telem_loadgen(device, size, runs)
    out["tiled"] = _telem_tiled(device, size, runs)
    out["reports"] = {f"{sub}:{run}": (_telem_report(sub, runs / run, knobs), want)
                      for sub, run, knobs, want in TELEM_REPORTS}
    out["gc"] = _telem_gc(runs)
    return out


def _telem_checks(drive: dict, size_name: str) -> dict:
    """The drive's own checks (either device): answers the same bits in
    the four runs, the metrics of each switch only while it is on, report
    exit codes, no flight record dropped, the population queries' launches and joins, the replay,
    the tiles, gc. Returns the verdicts; raises on a failed one."""
    served = drive["served"]
    base = drive["warm"]["bits"]
    every = [r[n] for r in drive["rounds"] for n, _ in TELEM_RUNS]
    verdicts = {
        "answers_bitwise": all(run["bits"] == base for run in every),
        "metrics": {run["name"]: run["metrics_words"] for run in every},
        "statz": {run["name"]: run["statz_blocks"] for run in every},
        "exits": {k: [code, want] for k, ((code, _), want) in drive["reports"].items()},
    }
    pop = drive["population"]
    lg = drive["loadgen"]
    tiled = drive["tiled"]
    size = TELEM_SIZES[size_name]
    ok = (verdicts["answers_bitwise"]
          and all({"sbr_flight", "sbr_demand"} & set(r[n]["metrics_words"]) == want
                  and r[n]["statz_blocks"] == sorted(w.removeprefix("sbr_") for w in want)
                  for r in drive["rounds"] for n, want in (
                      ("off", set()), ("trace", set()), ("flight", {"sbr_flight"}),
                      ("demand", {"sbr_demand"})))
          and all(code == want for code, want in verdicts["exits"].values())
          and all(r["flight"][k]["dropped_records"] == 0
                  for r in drive["rounds"] for k in ("util_mix", "util_cold"))
          and drive["reports"]["util:flight"][0][1]["util"]["dropped_records"] == 0
          and len(served["trace"]["spans"]) == size["queries"] + size["cold"]
          and all(r["launches"] == r["expected_launches"] and r["other_launches"] == 0
                  and r["echoed"] == r["trace_id"] and r["trace_id"]
                  for r in pop["rows"].values())
          and pop["waterfall_roots"] == ["worker.request"] * 2
          and pop["shapes"] == [[("worker.request", None)]] * 2
          and pop["demand_kinds"] == ["population"]
          and lg["same_bins"] and lg["summary"]["traced_queries"] == size["loadgen_queries"]
          and lg["replay"]["stats"]["replayed"] == size["loadgen_queries"]
          and tiled["bytes_equal"] and tiled["tiles"] == (size["sweep_n"] // size["tile"]) ** 2
          and len(tiled["per_tile"]) == tiled["tiles"]
          and all("compute" in k and "ckpt_save" in k for k in tiled["per_tile"].values())
          and drive["gc"]["exit"] == 0 and drive["gc"]["same"]
          and drive["gc"]["removed"] > 0
          and all(v >= 2 for v in drive["breach"]["rotated"].values()))
    if not ok:
        raise AssertionError(f"telemetry checks failed: {verdicts}, population {pop['rows']}, "
                             f"{pop['waterfall_roots']}, {pop['demand_kinds']}, loadgen "
                             f"{lg['same_bins']} {lg['summary'].get('traced_queries')}, tiled "
                             f"{tiled['bytes_equal']} {tiled['per_tile']}, gc {drive['gc']}, "
                             f"breach {drive['breach']}")
    return verdicts


def phase_telemetry(card: str) -> dict:
    """Slice 13 on the card at bench.py's shapes (module docstring): the
    served mix and a cold stream once untimed (every switch off, paying
    the first engine's costs), then the four TELEM_RUNS (every switch off,
    then tracing, the flight recorder and the demand observatory each
    alone) in each of ``rounds`` rounds, answers bit-identical and p50/p99
    of each; the flight recorder's device-busy and host-gap fractions,
    queue depth and occupancy from ``report util`` (the first round's cold
    stream) and the cold stream's fold in every round, beside the
    profiler's busy share of the same stream on a fresh engine;
    traced population queries over HTTP in both channels, each launching
    its kernel members × steps times; loadgen's rows replayed into the
    engine's surface; the faulted tiled sweep with the recorder, its tiles
    byte-equal; every report's exit code; gc's keep flags. Returns the
    launches by kernel of the traced population queries, counted from 0
    just before them."""
    import tempfile
    from pathlib import Path

    with tempfile.TemporaryDirectory(prefix="sbr_telem_") as tmp, \
            _env({k: None for k in TELEM_KNOBS}):
        root = Path(tmp)
        t0 = time.perf_counter()
        drive = _telem_drive("cuda", "full", root, started=True)
        drive_s = time.perf_counter() - t0
        prof = _telem_profiled_cold("cuda", TELEM_SIZES["full"], root)
        verdicts = _telem_checks(drive, "full")
        served = drive["served"]
        for name, _ in TELEM_RUNS:
            runs = [r[name] for r in drive["rounds"]]

            def each(key, runs=runs):
                return [r[key] for r in runs]

            emit("telemetry_served", run=name, rounds=len(runs),
                 p50_ms=each("p50_ms"), p99_ms=each("p99_ms"),
                 p50_ms_median=float(np.median(each("p50_ms"))),
                 p99_ms_median=float(np.median(each("p99_ms"))),
                 p50_hist_ms=each("p50_hist_ms"), p99_hist_ms=each("p99_hist_ms"),
                 mix_s=each("mix_s"), cold_p50_ms=each("cold_p50_ms"),
                 cold_p99_ms=each("cold_p99_ms"), cold_s=each("cold_s"),
                 cold_eq_per_s=each("cold_eq_per_s"), warmup_s=each("warmup_s"),
                 metrics=runs[0]["metrics_words"], card=card)
        util_doc = drive["reports"]["util:flight"][0][1]["util"]
        mix_util = served["flight"]["util_mix"]
        colds = [r["flight"]["util_cold"] for r in drive["rounds"]]
        emit("telemetry_util", window="cold stream", flight=dict(
                 device_busy_frac=util_doc["device_busy_frac"],
                 host_gap_frac=util_doc["host_gap_frac"], gap_causes=util_doc["gap_causes"],
                 dispatches=util_doc["dispatches"], queue_depth=util_doc.get("queue_depth"),
                 dropped_records=util_doc["dropped_records"],
                 occupancy=util_doc.get("occupancy"), window_s=util_doc["window_s"]),
             flight_cold_rounds={k: [u[k] for u in colds] for k in (
                 "device_busy_frac", "host_gap_frac", "dispatches", "window_s",
                 "dropped_records")},
             flight_mix=dict(device_busy_frac=mix_util["device_busy_frac"],
                             dispatches=mix_util["dispatches"],
                             queue_depth=mix_util.get("queue_depth"),
                             gap_causes=mix_util["gap_causes"]),
             profiler=prof, card=card)
        pop = drive["population"]
        for channel, row in pop["rows"].items():
            emit("telemetry_population", channel=channel, n_agents=POP_N, members=POP_SEEDS,
                 **row, waterfall=pop["waterfall_roots"], demand_kinds=pop["demand_kinds"],
                 card=card)
        lg = drive["loadgen"]
        emit("telemetry_loadgen", traced_queries=lg["summary"]["traced_queries"],
             p50_ms=lg["summary"]["p50_ms"], p99_ms=lg["summary"]["p99_ms"],
             replay=lg["replay"], same_bins=lg["same_bins"], bins=lg["bins"], card=card)
        tiled = drive["tiled"]
        emit("telemetry_tiled", tiles=tiled["tiles"], bytes_equal=tiled["bytes_equal"],
             seconds=tiled["seconds"], repairs=tiled["repairs"], kinds=tiled["kinds"], card=card)
        emit("telemetry_reports", exits=verdicts["exits"], gc=drive["gc"],
             rotated=drive["breach"]["rotated"], answers_bitwise=verdicts["answers_bitwise"],
             statz=verdicts["statz"], seconds=drive_s)
    return pop["launches"]


def phase_telemetry_cpu_vs_card() -> None:
    """The telemetry drive small on the card and on the CPU, the served runs
    inline (the thread-free path, so batches do not depend on timing):
    span-name and parent sequences, flight record kinds and counts, demand
    surfaces and advisor-plan bytes, and every report exit code equal."""
    import tempfile
    from pathlib import Path

    with tempfile.TemporaryDirectory(prefix="sbr_telem_cpu_") as tmp, \
            _env({k: None for k in TELEM_KNOBS}):
        root = Path(tmp)
        t0 = time.perf_counter()
        drives = {dev: _telem_drive(d, "small", root / dev, started=False)
                  for dev, d in (("card", "cuda"), ("cpu", "cpu"))}
        secs = time.perf_counter() - t0
        for drive in drives.values():
            _telem_checks(drive, "small")
    a, b = drives["card"], drives["cpu"]
    eq = {
        "served_spans": [_telem_shape(s) for s in a["served"]["trace"]["spans"]]
        == [_telem_shape(s) for s in b["served"]["trace"]["spans"]],
        "population_spans": a["population"]["shapes"] == b["population"]["shapes"],
        "loadgen_spans": a["loadgen"]["shapes"] == b["loadgen"]["shapes"],
        "flight_kinds": [a["served"]["flight"][k] for k in ("kinds_mix", "kinds_cold")]
        == [b["served"]["flight"][k] for k in ("kinds_mix", "kinds_cold")],
        "tiled_kinds": a["tiled"]["kinds"] == b["tiled"]["kinds"],
        "demand_surface": a["served"]["demand"]["demand_totals"]
        == b["served"]["demand"]["demand_totals"],
        "plan_bytes": a["served"]["demand"]["plan_bytes"] == b["served"]["demand"]["plan_bytes"],
        "loadgen_surface": a["loadgen"]["engine_cells"] == b["loadgen"]["engine_cells"],
        "replay_plan_bytes": a["loadgen"]["plan_bytes"] == b["loadgen"]["plan_bytes"],
        "population_demand": a["population"]["demand_kinds"] == b["population"]["demand_kinds"],
        "exits": {k: v[0][0] for k, v in a["reports"].items()}
        == {k: v[0][0] for k, v in b["reports"].items()},
        "gc": [a["gc"]["exit"], a["gc"]["same"]] == [b["gc"]["exit"], b["gc"]["same"]],
    }
    emit("telemetry_cpu_vs_card", equal=eq,
         exits={k: [a["reports"][k][0][0], b["reports"][k][0][0], a["reports"][k][1]]
                for k in a["reports"]},
         flight_kinds_cold=a["served"]["flight"]["kinds_cold"],
         population_launches={c: r["launches"] for c, r in a["population"]["rows"].items()},
         seconds=secs)
    if not all(eq.values()):
        raise AssertionError(f"telemetry card vs CPU: {eq}")


# ---------------------------------------------------------------------------
# Slice 14: the numerics audit
# ---------------------------------------------------------------------------

# bench.py's bench_audit subset (its probes/s), and the probe the seeded
# corrupt plan matches
AUDIT_BENCH_PROBES = ("graphgen.layout", "scenario.composed", "infomodel.gossip")
AUDIT_CORRUPT_PROBE = "scenario.composed"
AUDIT_CORRUPT_PLAN = {"seed": 7, "rules": [{"point": "audit.canary", "kind": "corrupt",
                                             "match": AUDIT_CORRUPT_PROBE}]}
# the four parity CLIs at their defaults: (probe, module, arguments)
AUDIT_CLIS = (("grad.ift_fd", "sbr_tpu_torch.grad.parity", []),
              ("scenario.composed", "sbr_tpu_torch.scenario.parity", []),
              ("infomodel.gossip", "sbr_tpu_torch.infomodels.parity", []),
              ("graphgen.layout", "sbr_tpu_torch.social.graphgen_cli", ["--selfcheck"]))
# the served mix of bench.py (TELEM_SIZES["full"]: pool 64, 2,048 queries
# in groups of 16, buckets 1/8/64, n_grid 1024), AUDIT_SERVE_ROUNDS times,
# with the scheduler off and on, its canaries due every
# AUDIT_SERVE_INTERVAL_S, so that cycles run in the mix's idle gaps
AUDIT_SERVE_INTERVAL_S = "0.1"
AUDIT_SERVE_ROUNDS = 4
AUDIT_KNOBS = ("SBR_AUDIT", "SBR_AUDIT_INTERVAL_S", "SBR_AUDIT_PROBES", "SBR_AUDIT_REGISTRY_DIR",
               "SBR_FAULT_PLAN", "SBR_OBS")
# card against CPU: the float values of a probe (f64); the counts exactly
AUDIT_CPU_TOL = 1e-12
AUDIT_EXACT = ("status", "iterations", "converged", "n_checked", "n_edges", "run_cells")


def _audit_start(argvs, env_extra=None) -> tuple:
    """Each argv as ``python -m ...``, all started at once: (processes,
    start time), for `_audit_wait`."""
    import os

    env = {**os.environ, "PYTHONPATH": str(_REPO_ROOT), **(env_extra or {})}
    procs = [subprocess.Popen([sys.executable, "-m", *argv], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env, cwd=str(_REPO_ROOT))
             for argv in argvs]
    return procs, time.perf_counter()


def _audit_wait(started, timeout_s: float = 600.0) -> list:
    """(exit, stdout, stderr, wall s) a process of `_audit_start`; every
    process is killed if it outlives ``timeout_s``."""
    procs, t0 = started
    out = []
    try:
        for proc in procs:
            stdout, stderr = proc.communicate(timeout=timeout_s)
            out.append((proc.returncode, stdout, stderr, time.perf_counter() - t0))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    return out


def _audit_procs(argvs, env_extra=None) -> list:
    return _audit_wait(_audit_start(argvs, env_extra))


def _audit_events(run_dir) -> list:
    from pathlib import Path

    lines = (Path(run_dir) / "events.jsonl").read_text().splitlines()
    return [e for e in map(json.loads, lines) if e.get("kind") == "audit"]


def _audit_cli_rows(root, procs) -> list:
    """The four CLIs' subprocess results checked: exit 0, the ``obs run
    dir:`` line, exactly one ``audit`` probe event, a pass."""
    rows = []
    for (probe, mod, _), (code, out, err, wall) in zip(AUDIT_CLIS, procs):
        run_dir = root / f"cli_{probe}"
        evs = _audit_events(run_dir) if (run_dir / "events.jsonl").exists() else []
        row = dict(cli=mod, probe=probe, exit=code, wall_s=wall,
                   obs_line=f"obs run dir: {run_dir}" in out,
                   audit_events=[(e["action"], e["probe"], e["tier"], e["verdict"]) for e in evs],
                   tail=out.strip().splitlines()[-1:] if out.strip() else [])
        rows.append(row)
        if not (code == 0 and row["obs_line"]
                and row["audit_events"] == [("probe", probe, "legacy", "pass")]):
            raise AssertionError(f"python -m {mod}: {row}\n{err[-2000:]}")
    return rows


def _audit_cli_launches() -> list:
    """Each CLI's battery once in this process, its output discarded: the
    launches of each kernel it made, counted from 0 just before it."""
    import io

    from sbr_tpu_torch import _build
    from sbr_tpu_torch.grad import parity as grad_parity
    from sbr_tpu_torch.infomodels import parity as infomodels_parity
    from sbr_tpu_torch.scenario import parity as scenario_parity
    from sbr_tpu_torch.social import graphgen_cli

    mains = {"grad.ift_fd": grad_parity.main, "scenario.composed": scenario_parity.main,
             "infomodel.gossip": infomodels_parity.main, "graphgen.layout": graphgen_cli.main}
    rows = []
    for probe, mod, argv in AUDIT_CLIS:
        _build.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            code = mains[probe](argv)
        torch.cuda.synchronize()
        rows.append(dict(cli=mod, probe=probe, exit=code, seconds=time.perf_counter() - t0,
                         **_launches()))
        if code != 0:
            raise AssertionError(f"{mod} in process: exit {code}")
    return rows


def _audit_served(registry, root) -> dict:
    """bench.py's served mix, AUDIT_SERVE_ROUNDS times, through an engine
    with the scheduler off and on (the bench subset due every
    AUDIT_SERVE_INTERVAL_S, run in idle gaps), twice in turns: the
    answers as bits, p50/p99 of the mix, its seconds, and the canary
    cycles completed during the mix and in all (at least one, waited for
    after the mix). Then the corrupt plan is installed in this process
    and, at the next cycle, must latch /healthz degraded with the
    ``audit_drift`` reason."""
    import sbr_tpu_torch as st
    from sbr_tpu_torch.resilience import faults
    from sbr_tpu_torch.serve import Engine, ServeConfig
    from sbr_tpu_torch.serve.loadgen import build_pool, query_mix

    size = TELEM_SIZES["full"]
    pool = build_pool(0, size["pool"])
    mix = [pool[j] for j in query_mix(0, size["pool"], size["queries"])]
    g = size["group"]
    out = {}
    for name in ("off", "on", "off_again", "on_again"):
        on = name.startswith("on")
        env = {"SBR_AUDIT": "1" if on else None, "SBR_AUDIT_INTERVAL_S": AUDIT_SERVE_INTERVAL_S,
               "SBR_AUDIT_PROBES": ",".join(AUDIT_BENCH_PROBES),
               "SBR_AUDIT_REGISTRY_DIR": str(registry)}
        with _env(env):
            engine = Engine(config=st.SolverConfig(**size["cfg"]),
                            serve=ServeConfig(buckets=size["buckets"]), device="cuda",
                            run_dir=str(root / f"served_{name}"))
            engine.start()
            try:
                for i in range(0, len(pool), g):
                    engine.query_many(pool[i : i + g], scenario="warmup", timeout=600)
                cycles0 = engine.audit.snapshot()["cycles"] if on else 0
                t0 = time.perf_counter()
                res = []
                for _ in range(AUDIT_SERVE_ROUNDS):
                    for i in range(0, len(mix), g):
                        res += engine.query_many(mix[i : i + g], scenario="mix", timeout=600)
                mix_s = time.perf_counter() - t0
                ms = np.array([r.latency_s for r in res]) * 1e3
                row = dict(mix_s=mix_s, p50_ms=float(np.percentile(ms, 50)),
                           p99_ms=float(np.percentile(ms, 99)),
                           cycles_in_mix=(engine.audit.snapshot()["cycles"] - cycles0
                                          if on else 0))
                answers = engine.query_many(pool, timeout=600)
                row["bits"] = [(r.status, r.flags, np.float64(r.xi).tobytes(),
                                np.float64(r.aw_max).tobytes()) for r in answers]
                row["metrics"] = "sbr_audit" in engine.prometheus()
                if on:
                    deadline = time.monotonic() + 120
                    while engine.audit.snapshot()["cycles"] < 1 and time.monotonic() < deadline:
                        time.sleep(0.05)
                    snap = engine.audit.snapshot()
                    row.update(cycles=snap["cycles"], status=snap["status"],
                               probe_ms={k: v.get("p50") for k, v in snap["probe_ms"].items()},
                               statz=engine.statz()["audit"]["status"])
                    if name == "on_again":
                        cycles = snap["cycles"]
                        faults.install(faults.FaultPlan(AUDIT_CORRUPT_PLAN))
                        try:
                            deadline = time.monotonic() + 120
                            while (engine.audit.snapshot()["cycles"] <= cycles
                                   and time.monotonic() < deadline):
                                time.sleep(0.05)
                        finally:
                            faults.reset()
                        row["healthz_after_corrupt"] = engine.healthz()
                        row["metrics_after_corrupt"] = [
                            ln for ln in engine.prometheus().splitlines()
                            if ln.startswith("sbr_audit_status")]
            finally:
                engine.close()
        out[name] = row
    return out


def phase_audit(card: str) -> dict:
    """Slice 14 on the card (module docstring): the battery's CLI records
    goldens into a temporary registry, then classifies (every probe a
    pass; each probe's ms) and classifies again under the seeded corrupt
    plan (exactly AUDIT_CORRUPT_PROBE in drift), each as a subprocess
    with a run directory; ``report audit`` exits 0 and 1 on the two; the
    bench subset's probes/s in this process; the four parity CLIs as
    subprocesses with ``--obs-dir`` (exit 0, one audit event each), and
    each battery once in this process for its launches; bench.py's served
    mix with the scheduler off and on (answers bit-identical, p50/p99, the
    overhead ratio, cycles), the corrupt plan latching /healthz; and gc's
    ``--audit-keep``. Returns the launches by kernel of the whole phase
    in this process, counted from 0 just before it."""
    import io
    import shutil
    import tempfile
    from pathlib import Path

    from sbr_tpu_torch import _build
    from sbr_tpu_torch.obs import audit, report

    from sbr_tpu_torch.social.fused import BELIEF_KERNEL, KERNEL

    with tempfile.TemporaryDirectory(prefix="sbr_audit_") as tmp, \
            _env({k: None for k in AUDIT_KNOBS}):
        root = Path(tmp)
        runs, reg = root / "runs", root / "reg"
        cli = ["sbr_tpu_torch.obs.audit", "--registry", str(reg), "--json"]
        # the goldens and the four CLIs as processes, all at once, while
        # this process runs each CLI's battery for its launches; then the
        # two classifying runs
        t0 = time.perf_counter()
        started = _audit_start([cli + ["--update"]] + [
            [mod, *argv, "--obs-dir", str(runs / f"cli_{probe}")] for probe, mod, argv in AUDIT_CLIS])
        cli_launches = _audit_cli_launches()
        first = _audit_wait(started)
        batch_s = time.perf_counter() - t0
        code, out, err, update_s = first[0]
        if code != 0:
            raise AssertionError(f"audit --update: exit {code}\n{err[-2000:]}")
        cli_rows = _audit_cli_rows(runs, first[1:])
        # the clean and the corrupt runs together, each in its own process
        procs, t0 = _audit_start([cli + ["--obs-dir", str(runs / "clean")]])
        try:
            procs += _audit_start([cli + ["--obs-dir", str(runs / "corrupt")]], env_extra={
                "SBR_FAULT_PLAN": json.dumps(AUDIT_CORRUPT_PLAN)})[0]
        except BaseException:
            procs[0].kill()
            procs[0].wait(timeout=30)
            raise
        clean, corrupt = _audit_wait((procs, t0))
        reps = {}
        for name, (code, out, err, wall) in (("clean", clean), ("corrupt", corrupt)):
            rep = json.loads(out.strip().splitlines()[-1])
            reps[name] = dict(exit=code, wall_s=wall, drift=rep["drift"], missing=rep["missing"],
                              verdicts={n: p["verdict"] for n, p in rep["probes"].items()},
                              probe_ms={n: p["duration_ms"] for n, p in rep["probes"].items()},
                              duration_s=rep["duration_s"], key=rep["key"])
        c, k = reps["clean"], reps["corrupt"]
        if not (c["exit"] == 0 and set(c["verdicts"].values()) == {"pass"}
                and len(c["verdicts"]) == len(audit.probes())):
            raise AssertionError(f"the clean battery: {c}")
        if not (k["exit"] == 1 and k["drift"] == [AUDIT_CORRUPT_PROBE]
                and all(v == "pass" for n, v in k["verdicts"].items() if n != AUDIT_CORRUPT_PROBE)):
            raise AssertionError(f"the corrupt battery: {k}")
        report_exits = {name: _telem_report("audit", runs / name, {})[0]
                        for name in ("clean", "corrupt")}
        if report_exits != {"clean": 0, "corrupt": 1}:
            raise AssertionError(f"report audit: {report_exits}")

        _build.reset_launches()
        bench_s = []
        for _ in range(2):
            t0 = time.perf_counter()
            rep = audit.run_battery(probe_names=AUDIT_BENCH_PROBES, reg_dir=reg, emit=False,
                                    device="cuda")
            torch.cuda.synchronize()
            bench_s.append(time.perf_counter() - t0)
            if not rep["ok"]:
                raise AssertionError(f"the bench subset in process: {rep['drift']}")
        bench_launches = _launches()
        emit("audit_battery", key=c["key"], probe_ms=c["probe_ms"], battery_s=c["duration_s"],
             clean_verdicts=c["verdicts"], corrupt_drift=k["drift"],
             corrupt_verdicts=k["verdicts"], report_exits=report_exits,
             cli_wall_s={"update": update_s, "clean": c["wall_s"], "corrupt": k["wall_s"]},
             bench_probes=list(AUDIT_BENCH_PROBES), bench_battery_s=bench_s,
             audit_probes_per_sec=len(AUDIT_BENCH_PROBES) / min(bench_s),
             bench_launches_per_battery={n: v // 2 for n, v in bench_launches.items()}, card=card)
        if bench_launches[KERNEL] != 2 * 20:
            raise AssertionError(f"the gossip probe launched {bench_launches}, want 20 a battery")

        emit("audit_clis", rows=cli_rows, launches=cli_launches, batch_wall_s=batch_s, card=card)
        # the gossip reduction: the kernel lowering's 4 configurations × 2
        # runs × 25 steps; the self-check: its default and "pallas" runs of
        # 25 steps; the grad and scenario batteries launch nothing
        by = {r["probe"]: r for r in cli_launches}
        if not (by["infomodel.gossip"][KERNEL] == 4 * 2 * 25
                and by["infomodel.gossip"][BELIEF_KERNEL] > 0
                and by["graphgen.layout"][KERNEL] == 2 * 25
                and not any(by[p][n] for p in ("grad.ift_fd", "scenario.composed")
                            for n in (KERNEL, BELIEF_KERNEL))):
            raise AssertionError(f"the CLIs' launches: {cli_launches}")

        _build.reset_launches()
        served = _audit_served(reg, runs)
        served_launches = _launches()
        on, off = served["on"], served["off"]
        bits = {n: r.pop("bits") for n, r in served.items()}
        ratio = [served[a]["mix_s"] / served[b]["mix_s"]
                 for a, b in (("on", "off"), ("on_again", "off_again"))]
        emit("audit_served", runs={n: {k: v for k, v in r.items() if k != "healthz_after_corrupt"}
                                   for n, r in served.items()},
             audit_overhead_ratio=ratio, p50_ratio=on["p50_ms"] / off["p50_ms"],
             p99_ratio=on["p99_ms"] / off["p99_ms"],
             answers_bitwise=len(set(map(tuple, bits.values()))) == 1,
             healthz_after_corrupt=served["on_again"]["healthz_after_corrupt"],
             launches=served_launches, card=card)
        hz = served["on_again"]["healthz_after_corrupt"]
        if not (len(set(map(tuple, bits.values()))) == 1
                and all(served[n]["cycles"] >= 1 and served[n]["status"] == "pass"
                        and served[n]["metrics"] for n in ("on", "on_again"))
                and not off["metrics"] and not served["off_again"]["metrics"]
                and hz["status"] == "degraded"
                and f"audit_drift: {AUDIT_CORRUPT_PROBE}" in hz["reasons"]):
            raise AssertionError(f"the served audit: {served}")

        # gc --audit-keep 1: every finished run's battery artifacts but its
        # newest, and all archived goldens of the key but the newest, go;
        # the active golden stays
        golden = next(reg.glob("goldens_*.json"))
        for i in range(3):
            shutil.copy(golden, golden.with_suffix(f".{i:03d}.json"))

        def files():
            return set(runs.rglob("battery_*.json")) | set(reg.glob("goldens_*.json"))

        want = {p for d in runs.iterdir() if (d / "audit").is_dir()
                for p in sorted((d / "audit").glob("battery_*.json"))[:-1]}
        want |= {golden.with_suffix(f".{i:03d}.json") for i in range(2)}
        before = files()
        with _env({"SBR_AUDIT_REGISTRY_DIR": str(reg)}), \
                contextlib.redirect_stdout(io.StringIO()):
            code = report.main(["gc", str(runs), "--keep", "100", "--audit-keep", "1"])
        gone = before - files()
        emit("audit_gc", exit=code, removed=len(gone), expected=len(want),
             batteries_before=len([p for p in before if p.name.startswith("battery_")]),
             golden_kept=golden.is_file())
        if not (code == 0 and gone == want and golden.is_file()):
            raise AssertionError(f"gc --audit-keep: removed {sorted(map(str, gone))}, "
                                 f"want {sorted(map(str, want))}")
    return {k: bench_launches[k] + served_launches[k] + sum(r[k] for r in cli_launches)
            for k in bench_launches}


def phase_audit_cpu_vs_card() -> None:
    """The whole battery on the CPU and on the card in this process:
    verdicts, statuses, flags, iteration counts and counts equal, the
    float values within AUDIT_CPU_TOL (``grad.ift_fd``'s worst relative
    error under its tolerance on both), and the fingerprints of
    ``infomodel.gossip`` (the kernel on the card, the plain step on the
    CPU) and ``graphgen.layout`` equal."""
    import tempfile

    from sbr_tpu_torch.obs import audit

    with tempfile.TemporaryDirectory(prefix="sbr_audit_cpu_") as tmp, \
            _env({k: None for k in AUDIT_KNOBS}):
        t0 = time.perf_counter()
        reps = {dev: audit.run_battery(reg_dir=tmp, update=True, emit=False, device=dev)
                for dev in ("cpu", "cuda")}
        secs = time.perf_counter() - t0
    a, b = reps["cpu"]["probes"], reps["cuda"]["probes"]
    gaps, differ = {}, []
    for name in a:
        va, vb = a[name]["values"], b[name]["values"]
        if a[name]["verdict"] != b[name]["verdict"] or set(va) != set(vb):
            differ.append(name)
            continue
        for key in va:
            if key in AUDIT_EXACT:
                if va[key] != vb[key]:
                    differ.append(f"{name}.{key}")
            elif name == "grad.ift_fd":
                if not (va[key] <= 1e-5 and vb[key] <= 1e-5):
                    differ.append(f"{name}.{key}")
            else:
                gaps[f"{name}.{key}"] = abs(va[key] - vb[key])
    same_fp = {n: a[n]["fingerprint"] == b[n]["fingerprint"] for n in a}
    emit("audit_cpu_vs_card", max_abs=gaps, tolerance=AUDIT_CPU_TOL, differ=differ,
         fingerprints_equal=same_fp, cpu_ms={n: p["duration_ms"] for n, p in a.items()},
         card_ms={n: p["duration_ms"] for n, p in b.items()}, seconds=secs)
    if differ or max(gaps.values()) > AUDIT_CPU_TOL or not (
            same_fp["infomodel.gossip"] and same_fp["graphgen.layout"]):
        raise AssertionError(f"the battery on the card and the CPU differ: {differ} {gaps} "
                             f"{same_fp}")


# ---------------------------------------------------------------------------
# Slice 15: the serving fleet
# ---------------------------------------------------------------------------

# bench.py's bench_fleet on an accelerator: 3 workers, 1,024 queries over a
# pool of 32, 8 at a time, n_grid 512, 60 bisections, buckets 1,8,64 (the
# kill and audit drills run in the chaos phase).
FLEET = dict(fleet=3, queries=1024, pool=32, group=8, n_grid=512, bisect_iters=60,
             buckets="1,8,64", seed=0)
# bench.py's bench_prewarm: a pool of 12, 4 plan tiles, n_grid 128, 40
# bisections, 8 warm outage passes
PREWARM = dict(pool=12, tiles=4, n_grid=128, bisect_iters=40, reps=8)
# fleet_cpu: the same drive small
FLEET_SMALL = dict(fleet=2, queries=48, pool=6, group=4, n_grid=96, bisect_iters=30,
                   buckets="1,8", seed=0)
FLEET_POP_SMALL, FLEET_POP_SMALL_SEEDS = 2_000, 4
# members of the routed population queries: half of bench.py's 16, the
# obs and telemetry paths' depth cut (OBS_POP_SEEDS), made to give the
# chaos phase room
FLEET_POP_SEEDS = 8
# the answer fields held bit for bit (the reference's chaos drill's)
_ANSWER_FIELDS = ("xi", "tau_bar_in", "aw_max", "status", "flags", "residual")
# the per-query fields of a served record that are not the answer
_VOLATILE = ("latency_ms", "source", "trace_id", "degraded")


def _fleet_args(root, name: str, shape: dict, **kw):
    """run_fleet's arguments (loadgen's CLI namespace): the router's run
    directory and the answers file under ``root``."""
    base = dict(run_dir=str(root / name), cache_dir=None, fleet_dir=None, device=None,
                fleet_kill_after=None, answers_out=str(root / f"{name}_answers.json"),
                trace_out=None, audit_fault=None, audit_wait=0, audit_wait_s=120.0)
    return types.SimpleNamespace(**{**shape, **base, **kw})


def _fleet_run(root, name: str, shape: dict, **kw) -> tuple:
    """One `loadgen.run_fleet`: (summary, answers); fails on a lost query."""
    from sbr_tpu_torch.serve.loadgen import run_fleet

    root.mkdir(parents=True, exist_ok=True)
    args = _fleet_args(root, name, shape, **kw)
    t0 = time.perf_counter()
    summary = run_fleet(args)
    summary["wall_s"] = time.perf_counter() - t0
    answers = json.loads(open(args.answers_out).read())
    if summary["failures"] or summary["fleet_lost"]:
        raise AssertionError(f"fleet {name}: {summary['failures']}, lost "
                             f"{summary['fleet_lost']}")
    return summary, answers


def _answers_identical(a: list, b: list) -> bool:
    """Byte identity of two answer lists (JSON floats round-trip the
    shortest repr exactly, None encodes NaN on both sides)."""
    return len(a) == len(b) and all(
        isinstance(x, dict) and isinstance(y, dict) and not x.get("degraded")
        and not y.get("degraded") and "shed" not in x and "shed" not in y
        and all(x.get(f) == y.get(f) for f in _ANSWER_FIELDS) for x, y in zip(a, b))


def _wire(v):
    """A float as the endpoint writes it (non-finite as None)."""
    v = float(v)
    return v if np.isfinite(v) else None


def _engine_answers(shape: dict, device, dtype=None) -> list:
    """The seeded mix's answers from one in-process engine, in the wire
    form of a routed answer."""
    from sbr_tpu_torch.models.params import SolverConfig
    from sbr_tpu_torch.serve import Engine, ServeConfig
    from sbr_tpu_torch.serve.endpoint import query_result_doc
    from sbr_tpu_torch.serve.loadgen import build_pool, query_mix

    pool = build_pool(shape["seed"], shape["pool"])
    mix = query_mix(shape["seed"], shape["pool"], shape["queries"])
    cfg = SolverConfig(n_grid=shape["n_grid"], bisect_iters=shape["bisect_iters"],
                       refine_crossings=False)
    buckets = tuple(int(b) for b in shape["buckets"].split(","))
    engine = Engine(config=cfg, dtype=dtype, serve=ServeConfig(buckets=buckets), device=device)
    try:
        res = engine.query_many(pool, timeout=600)
    finally:
        engine.close()
    by_pool = [query_result_doc(r) for r in res]
    return [by_pool[i] for i in mix]


def _fleet_report(sub: str, run_dir, *extra) -> tuple:
    """``python -m sbr_tpu_torch.obs.report SUB RUN_DIR --json``, as a
    process: (exit, document)."""
    proc = subprocess.run([sys.executable, "-m", "sbr_tpu_torch.obs.report", sub, str(run_dir),
                           *extra, "--json"], capture_output=True, text=True, timeout=300,
                          cwd=str(_REPO_ROOT))
    return proc.returncode, json.loads(proc.stdout)


def _pop_doc(channel: str, n: int, seeds: int = POP_SEEDS) -> dict:
    """A Figure-12 population query's /query body (bench_infomodels'
    serving shape at ``n`` agents and ``seeds`` members)."""
    fig12 = {"beta": 0.9, "eta_bar": 30.0, "u": 0.5, "p": 0.99, "kappa": 0.25, "lam": 0.25}
    return {**fig12, "population": {
        "graph": {"model": "erdos_renyi", "n": n, "avg_degree": POP_DEG},
        "infomodel": {"channel": channel}, "seeds": seeds, "vary": "sim", "g0": None}}


def _post(router, doc: dict) -> dict:
    from sbr_tpu_torch.serve.loadgen import http_request

    code, body, _ = http_request(router.port, "/query", doc, timeout=900)
    if code != 200:
        raise AssertionError(f"routed /query answered {code}: {body}")
    return json.loads(body)


def _record(doc: dict) -> dict:
    return {k: v for k, v in doc.items() if k not in _VOLATILE}


@contextlib.contextmanager
def _inproc_worker(fleet_dir, device, n_grid: int, bisect_iters: int, buckets=(1,)):
    """The three pieces `serve.fleet.main` assembles, in this process (so
    `_build.LAUNCHES` counts what the worker launches): an `Engine`, its
    `ServeEndpoint` and a `WorkerAnnouncer` in ``fleet_dir``, beaten once."""
    from sbr_tpu_torch.models.params import SolverConfig
    from sbr_tpu_torch.serve import Engine, ServeConfig, ServeEndpoint
    from sbr_tpu_torch.serve.fleet import WorkerAnnouncer, _worker_stats

    engine = Engine(config=SolverConfig(n_grid=n_grid, bisect_iters=bisect_iters,
                                        refine_crossings=False),
                    serve=ServeConfig(buckets=tuple(buckets)), device=device).start()
    endpoint = ServeEndpoint(engine).start()
    ann = WorkerAnnouncer(fleet_dir, f"http://127.0.0.1:{endpoint.port}", ttl_s=600)
    try:
        ann.beat(**_worker_stats(engine))
        yield engine
    finally:
        endpoint.close()
        engine.close()
        ann.withdraw()


def _fleet_hops(card: str, root) -> None:
    """Where a routed answer's time goes: one warm query's latency over 50
    sequential POSTs straight to a worker's endpoint in this process, and
    the same through the router (one hop more), an LRU hit each time."""
    from sbr_tpu_torch.serve.loadgen import build_pool, http_request, params_doc
    from sbr_tpu_torch.serve.router import Router

    doc = params_doc(build_pool(FLEET["seed"], 1)[0])
    with _inproc_worker(root / "hops", "cuda", FLEET["n_grid"], FLEET["bisect_iters"]) as eng:
        router = Router(root / "hops", poll_s=0.05).start()
        try:
            port = int(next(iter(router.statz()["workers"].values()))["url"].rsplit(":", 1)[1])
            ms = {}
            for name, target in (("direct", port), ("routed", router.port)):
                http_request(target, "/query", doc)  # the miss, then hits
                lat = []
                for _ in range(50):
                    t0 = time.perf_counter()
                    code, _, _ = http_request(target, "/query", doc)
                    lat.append((time.perf_counter() - t0) * 1e3)
                    if code != 200:
                        raise AssertionError(f"{name} query answered {code}")
                lat.sort()
                ms[name] = {"p50": lat[25], "p90": lat[45], "min": lat[0]}
        finally:
            router.close()
        engine_ms = eng.live.snapshot()["totals"]["latency_ms"]
    emit("fleet_hops", ms=ms, engine_latency_ms=engine_ms, card=card)


def _fleet_population(card: str, root) -> dict:
    """A gossip and a bayes population query (bench_infomodels' shape,
    20,000 agents and 333 steps, with FLEET_POP_SEEDS members) routed to a
    worker in this process, each query's launches counted (set to 0 just before it, read
    just after: members × steps of its channel's kernel, 0 of the other
    and of the recount); then the same queries routed to a worker process
    on the card, whose records must equal the in-process worker's bit for
    bit."""
    from sbr_tpu_torch import _build
    from sbr_tpu_torch.serve.loadgen import spawn_worker, stop_workers
    from sbr_tpu_torch.serve.router import Router
    from sbr_tpu_torch.social.fused import BELIEF_KERNEL, KERNEL
    from sbr_tpu_torch.social.recount import KERNEL as RECOUNT_KERNEL

    steps = max(int(round(float(30.0 / 0.9) / 0.1)), 2)
    expected = FLEET_POP_SEEDS * steps
    launches = {KERNEL: 0, BELIEF_KERNEL: 0, RECOUNT_KERNEL: 0}
    rows, recs = [], {}
    with _inproc_worker(root / "pop_inproc", "cuda", POP_GRID, 60) as engine:
        router = Router(root / "pop_inproc", poll_s=0.05).start()
        try:
            for channel, kernel, other in (("gossip", KERNEL, BELIEF_KERNEL),
                                           ("bayes", BELIEF_KERNEL, KERNEL)):
                _build.reset_launches()
                t0 = time.perf_counter()
                doc = _post(router, _pop_doc(channel, POP_N, FLEET_POP_SEEDS))
                torch.cuda.synchronize()
                wall_s = time.perf_counter() - t0
                got = (_build.LAUNCHES[kernel], _build.LAUNCHES[other],
                       _build.LAUNCHES[RECOUNT_KERNEL])
                launches[kernel] += got[0]
                launches[RECOUNT_KERNEL] += got[2]
                recs[channel] = _record(doc)
                rows.append(dict(channel=channel, worker="in_process", wall_s=wall_s,
                                 launches=got[0], other_launches=got[1],
                                 recount_launches=got[2], expected=expected,
                                 source=doc["source"], run_probability=doc["run_probability"]))
                if got != (expected, 0, 0):
                    raise AssertionError(f"routed {channel} population: launches {got}, want "
                                         f"({expected}, 0, 0)")
            counters = dict(router.counters)
        finally:
            router.close()
        if engine.live.snapshot()["totals"]["queries"] != 2:
            raise AssertionError("the in-process worker did not serve both queries")
    t0 = time.perf_counter()
    w = spawn_worker(str(root / "pop_proc"), POP_GRID, 60, "1", heartbeat_ttl=600)
    ready_s = time.perf_counter() - t0
    try:
        router = Router(root / "pop_proc", poll_s=0.05).start()
        try:
            for channel in ("gossip", "bayes"):
                t0 = time.perf_counter()
                doc = _post(router, _pop_doc(channel, POP_N, FLEET_POP_SEEDS))
                same = _record(doc) == recs[channel]
                rows.append(dict(channel=channel, worker="process", wall_s=time.perf_counter() - t0,
                                 ready_s=ready_s, device=w["device"], equal_in_process=same))
                if not same:
                    raise AssertionError(f"{channel} population: the worker process and the "
                                         "in-process worker differ")
        finally:
            router.close()
    finally:
        stop_workers([w])
    for r in rows:
        emit("fleet_population", **r, n_agents=POP_N, members=FLEET_POP_SEEDS, steps=steps,
             card=card)
    emit("fleet_population_router", counters=counters)
    return launches


def _prewarm_plan(pool) -> dict:
    """bench_prewarm's hand-ranked plan: a tile per pool chunk, its β and u
    axes crossing the chunk's points."""
    from sbr_tpu_torch.utils.checkpoint import params_fingerprint

    chunk = max(PREWARM["pool"] // PREWARM["tiles"], 1)
    tiles = []
    for i in range(PREWARM["tiles"]):
        pts = pool[i * chunk:(i + 1) * chunk] or pool[-chunk:]
        tiles.append({"bin": f"{i},0", "betas": sorted({float(p.learning.beta) for p in pts}),
                      "us": sorted({float(p.economic.u) for p in pts}), "rank": i + 1})
    plan = {"schema": "sbr-demand-advisor/1", "tiles": tiles}
    plan["plan_fingerprint"] = params_fingerprint(json.dumps(plan, sort_keys=True))[:16]
    return plan


def _prewarm_drive(card: str, root, device: str, reps: int) -> dict:
    """bench_prewarm's three phases on ``device``: a cold outage (every
    dispatch fails, an empty tile cache: every query 503s), the plan
    drained by a standalone controller under a run directory (tiles/s),
    and ``reps`` warm outage passes answered from the tile cache (hit
    rate, p99 of the degraded answers); then a plan whose budget runs out
    (``report prewarm`` exit 1)."""
    from sbr_tpu_torch.models.params import SolverConfig
    from sbr_tpu_torch import obs
    from sbr_tpu_torch.resilience import faults
    from sbr_tpu_torch.serve import Engine, ServeConfig
    from sbr_tpu_torch.serve.loadgen import build_pool
    from sbr_tpu_torch.serve.prewarm import PrewarmController

    root.mkdir(parents=True, exist_ok=True)
    cfg = SolverConfig(n_grid=PREWARM["n_grid"], bisect_iters=PREWARM["bisect_iters"],
                       refine_crossings=False)
    pool = build_pool(0, PREWARM["pool"])
    plan = _prewarm_plan(pool)
    cache = root / "tilecache"
    plan_path = root / "advisor_plan.json"
    plan_path.write_text(json.dumps(plan))
    outage = {"rules": [{"point": "serve.dispatch", "kind": "transient", "p": 1.0}]}

    def outage_pass(label):
        hits, lat, answers = 0, [], []
        engine = Engine(config=cfg, serve=ServeConfig(buckets=(1,)), device=device)
        try:
            for p in pool:
                try:
                    r = engine.query(p, scenario=label)
                except Exception:
                    answers.append(None)
                    continue  # the ladder exhausted: the 503 path
                answers.append((r.status, _wire(r.xi), _wire(r.aw_max)))
                if r.source == "tilecache":
                    hits += 1
                    lat.append(r.latency_s * 1e3)
        finally:
            engine.close()
        return hits, lat, answers

    out = {}
    with _env({"SBR_TILE_CACHE_DIR": str(cache), "SBR_RETRY_BASE_DELAY_S": "0.01",
               "SBR_RETRY_MAX_DELAY_S": "0.05"}):
        faults.install(faults.FaultPlan(outage))
        try:
            cold_hits, _, cold_answers = outage_pass("prewarm-cold")
        finally:
            faults.reset()
        run = obs.start_run(label="prewarm", run_dir=str(root / "prewarm_run"))
        try:
            ctl = PrewarmController(engine=None, plan_file=plan_path,
                                    state_root=root / "_prewarm", config=cfg,
                                    cache_dir=str(cache), device=device)
            t0 = time.perf_counter()
            snap = ctl.drain(timeout_s=600.0)
            drain_s = time.perf_counter() - t0
            ctl.close()
        finally:
            obs.end_run()
        faults.install(faults.FaultPlan(outage))
        try:
            warm = [outage_pass("prewarm-warm") for _ in range(reps)]
        finally:
            faults.reset()
        run_b = obs.start_run(label="prewarm_budget", run_dir=str(root / "prewarm_budget"))
        try:
            (root / "plan_b.json").write_text(json.dumps({**plan, "plan_fingerprint": "b" * 16}))
            ctl = PrewarmController(engine=None, plan_file=root / "plan_b.json",
                                    state_root=root / "_prewarm_b", config=cfg,
                                    cache_dir=str(root / "cache_b"), device=device,
                                    max_tiles=1)
            snap_b = ctl.drain(timeout_s=600.0)
            ctl.close()
        finally:
            obs.end_run()
    lat = sorted(v for _, l, _ in warm for v in l)
    out.update(
        cold_hits=cold_hits, cold_answered=sum(a is not None for a in cold_answers),
        snapshot=snap, drain_s=drain_s, tiles_per_s=snap["counts"]["tiles_done"] / drain_s,
        warm_hit_rate=sum(h for h, _, _ in warm) / (reps * len(pool)),
        warm_outage_p50_ms=lat[len(lat) // 2] if lat else None,
        warm_outage_p99_ms=lat[min(int(len(lat) * 0.99), len(lat) - 1)] if lat else None,
        warm_answers=warm[0][2], budget_snapshot=snap_b,
        run_dir=run.run_dir, budget_run_dir=run_b.run_dir, cache=cache, pool=pool, cfg=cfg,
        plan=plan)
    return out


# the embedded controller's traffic: a round a bucket, first use each
# (a capture), then each again (a replay); the second round waits for a
# drained tile, so the later captures and the replays fall inside the sweep
PREWARM_EMBEDDED_ROUNDS = (1, 8, 64, 1, 8, 64)


def _prewarm_embedded(card: str, root, device: str = "cuda") -> None:
    """``SBR_PREWARM=1`` inside an engine on ``device``: its controller's
    daemon thread drains bench_prewarm's plan, each tile under the
    engine's dispatch lock, in the idle windows between rounds of queries
    that capture buckets 1, 8 and 64 and replay them. The answers must
    equal an ``SBR_PREWARM=0`` engine's bit for bit, and the tiles
    `beta_u_grid`'s on the same device."""
    from sbr_tpu_torch.models.params import SolverConfig
    from sbr_tpu_torch.serve import Engine, ServeConfig
    from sbr_tpu_torch.serve.endpoint import query_result_doc
    from sbr_tpu_torch.serve.loadgen import build_pool

    root.mkdir(parents=True, exist_ok=True)
    cfg = SolverConfig(n_grid=PREWARM["n_grid"], bisect_iters=PREWARM["bisect_iters"],
                       refine_crossings=False)
    plan = _prewarm_plan(build_pool(0, PREWARM["pool"]))
    plan_path, cache = root / "advisor_plan.json", root / "tilecache"
    plan_path.write_text(json.dumps(plan))
    traffic = build_pool(1, sum(PREWARM_EMBEDDED_ROUNDS))
    answers, rows = {}, {}
    for switch in ("1", "0"):
        env = {"SBR_PREWARM": switch, "SBR_PREWARM_PLAN": str(plan_path),
               "SBR_TILE_CACHE_DIR": str(cache), "SBR_PREWARM_POLL_S": "0.1",
               "SBR_SERVE_SLO_MS": None}
        with _env(env):
            engine = Engine(config=cfg, serve=ServeConfig(buckets=(1, 8, 64)),
                            device=device).start()
            ctl = engine.prewarm
            try:
                got, at_round, i = [], [], 0
                t0 = time.perf_counter()
                for r, n in enumerate(PREWARM_EMBEDDED_ROUNDS):
                    if ctl is not None and r == 1:
                        deadline = time.monotonic() + 300
                        while (ctl.snapshot()["tiles_done"] == 0 and ctl.status == "sweeping"
                               and time.monotonic() < deadline):
                            time.sleep(0.05)
                    at_round.append(None if ctl is None else ctl.snapshot()["tiles_done"])
                    got += [query_result_doc(x) for x in
                            engine.query_many(traffic[i:i + n], timeout=600)]
                    i += n
                    time.sleep(0.3)  # an idle window
                if ctl is not None:
                    deadline = time.monotonic() + 300
                    while ctl.status == "sweeping" and time.monotonic() < deadline:
                        time.sleep(0.05)
                drive_s = time.perf_counter() - t0
                snap = None if ctl is None else ctl.snapshot()
                graphs = {"captured": dict(engine.graphs.captured),
                          "replays": engine.graphs.replays}
                metrics = engine.prometheus()
            finally:
                engine.close()
        answers[switch] = [{f: a[f] for f in _ANSWER_FIELDS} for a in got]
        rows[switch] = dict(tiles_done_at_round=at_round, snapshot=snap, graphs=graphs,
                            drive_s=drive_s, prewarm_metrics="sbr_prewarm" in metrics)
    on, off = rows["1"], rows["0"]
    tiles = _prewarm_tiles_equal_grid({"cache": cache, "plan": plan, "cfg": cfg}, device)
    same = answers["1"] == answers["0"]
    emit("fleet_prewarm_embedded", rounds=list(PREWARM_EMBEDDED_ROUNDS),
         tiles_done_at_round=on["tiles_done_at_round"], status=on["snapshot"]["status"],
         tiles_total=on["snapshot"]["tiles_total"], warm=on["snapshot"]["warm"],
         graphs=on["graphs"], graphs_off=off["graphs"], drive_s=on["drive_s"],
         answers_equal_prewarm_off=same, tiles_vs_beta_u_grid=tiles,
         metrics_on=on["prewarm_metrics"], metrics_off=off["prewarm_metrics"], card=card)
    if not (same and tiles["equal"] and on["snapshot"]["status"] == "done"
            and on["snapshot"]["warm"] == on["snapshot"]["tiles_total"]
            and on["tiles_done_at_round"][1] >= 1
            and on["graphs"]["captured"] == ({1: 1, 8: 1, 64: 1} if device == "cuda" else {})
            and on["prewarm_metrics"] and not off["prewarm_metrics"]):
        raise AssertionError(f"embedded prewarm: {on}, answers equal {same}, tiles {tiles}")


def _prewarm_tiles_equal_grid(drive: dict, device: str) -> dict:
    """Every drained tile against `beta_u_grid` of its axes on the same
    device: {"equal": bit for bit on every cell, "flagged": the cells with
    a health bit set, which the tile runner's degrade ladder looked at}."""
    from sbr_tpu_torch.models.params import make_model_params
    from sbr_tpu_torch.resilience.elastic import TileCache
    from sbr_tpu_torch.serve import prewarm
    from sbr_tpu_torch.sweeps.baseline_sweeps import beta_u_grid
    from sbr_tpu_torch.utils import checkpoint as ckpt

    cache = TileCache(drive["cache"])
    flagged, equal = 0, True
    for t in prewarm._plan_tiles(drive["plan"]):
        base = make_model_params(beta=t["betas"][0])
        key = cache.key(base, drive["cfg"], None, t["betas"], t["us"])
        got = cache.load(key, tile="check")
        want = beta_u_grid(np.array(t["betas"]), np.array(t["us"]), base, config=drive["cfg"],
                           device=device)
        flags = (want.health.flags if want.health is not None
                 else torch.zeros_like(want.status, dtype=torch.int32))
        host = ckpt.to_host(want.xi, want.max_aw, want.status, flags)
        flagged += int((host[3] != 0).sum())
        if got is None or not all(np.array_equal(got[f], h, equal_nan=f != "status")
                                  and got[f].dtype == h.dtype
                                  for f, h in zip(("xi", "max_aw", "status"), host[:3])):
            equal = False
    return {"equal": equal, "flagged": flagged}


def phase_fleet(card: str) -> dict:
    """The serving fleet on the card at bench.py's shapes: the seeded mix
    through the router to three worker processes (p50, p99, qps,
    failovers, sheds, 0 lost), its answers bit for bit an in-process
    engine's; the routed populations (`_fleet_population`, whose launches
    are returned); bench_prewarm's three phases, the drained tiles bit for
    bit `beta_u_grid`'s (the ξ kernel's launches in them returned beside the
    populations'); and ``report fleet``, ``prewarm`` and ``summary`` on the
    clean and the breached runs. The kill and audit drills are the chaos
    phase's."""
    import tempfile
    from pathlib import Path

    from sbr_tpu_torch import _build
    from sbr_tpu_torch.baseline.xi_kernel import KERNEL as XI_KERNEL

    _build.build_all()  # published once, before any worker process starts
    with tempfile.TemporaryDirectory(prefix="sbr_fleet_") as tmp, \
            _env({"PYTHONPATH": str(_REPO_ROOT), "SBR_OBS_HISTORY": f"{tmp}/history.jsonl"}):
        root = Path(tmp)
        clean, clean_ans = _fleet_run(root, "clean", FLEET)
        want = _engine_answers(FLEET, "cuda")
        same_engine = all(all(a.get(f) == w[f] for f in _ANSWER_FIELDS)
                          for a, w in zip(clean_ans, want)) and len(clean_ans) == len(want)
        emit("fleet_mix", workers=FLEET["fleet"], queries=FLEET["queries"], pool=FLEET["pool"],
             group=FLEET["group"], n_grid=FLEET["n_grid"], bisect_iters=FLEET["bisect_iters"],
             buckets=FLEET["buckets"], p50_ms=clean["fleet_p50_ms"],
             p99_ms=clean["fleet_p99_ms"], qps=clean["fleet_qps"],
             failovers=clean["fleet_failover_count"], shed_rate=clean["fleet_shed_rate"],
             lost=clean["fleet_lost"], workers_ready_s=clean["workers_ready_s"],
             wall_s=clean["wall_s"], router_counters=clean["router_counters"],
             answers_equal_in_process_engine=same_engine, card=card)
        if not same_engine:
            raise AssertionError("routed answers differ from an in-process engine's")

        # the kill and audit drills at this shape gave way to the chaos
        # drills --fleet and --audit (`phase_chaos_fleet`, `phase_chaos`),
        # a cut of their size: the drills' fleets serve 36 queries of a
        # pool of 6 at n_grid 96, where these served 1,024 of 32 at n_grid
        # 512. Their assertions are held there: the kill's answers equal in
        # all six fields (residual included), 0 lost, the killed worker,
        # report fleet 0 (1 with a stuck breaker) and the summary; the
        # audit's one drifted worker quarantined, its quarantine event,
        # report audit 1 on worker 0, answers equal in all six fields

        _fleet_hops(card, root)
        pop_launches = _fleet_population(card, root)

        xi_before = _build.LAUNCHES[XI_KERNEL]
        pw = _prewarm_drive(card, root / "prewarm", "cuda", PREWARM["reps"])
        tiles = _prewarm_tiles_equal_grid(pw, "cuda")
        _prewarm_embedded(card, root / "prewarm_embedded")
        xi_launches = _build.LAUNCHES[XI_KERNEL] - xi_before
        emit("fleet_prewarm", pool=PREWARM["pool"], plan_tiles=PREWARM["tiles"],
             n_grid=PREWARM["n_grid"], reps=PREWARM["reps"], xi_launches=xi_launches,
             cold_hits=pw["cold_hits"],
             cold_answered=pw["cold_answered"], status=pw["snapshot"]["status"],
             tiles_total=pw["snapshot"]["tiles_total"], tiles_done=pw["snapshot"]["tiles_done"],
             warm=pw["snapshot"]["warm"], drain_s=pw["drain_s"], tiles_per_s=pw["tiles_per_s"],
             warm_hit_rate=pw["warm_hit_rate"], warm_outage_p50_ms=pw["warm_outage_p50_ms"],
             warm_outage_p99_ms=pw["warm_outage_p99_ms"], tiles_vs_beta_u_grid=tiles,
             budget_status=pw["budget_snapshot"]["status"], card=card)
        if not (pw["cold_hits"] == 0 and pw["cold_answered"] == 0
                and pw["snapshot"]["status"] == "done"
                and pw["snapshot"]["warm"] == pw["snapshot"]["tiles_total"]
                and pw["warm_hit_rate"] == 1.0 and tiles["equal"]
                and pw["budget_snapshot"]["status"] == "budget_exhausted"):
            raise AssertionError(f"prewarm: {pw['snapshot']}, hit rate {pw['warm_hit_rate']}, "
                                 f"tiles {tiles}")

        codes = {
            "fleet:clean": _fleet_report("fleet", root / "clean")[0],
            "prewarm:drained": _fleet_report("prewarm", pw["run_dir"])[0],
            "prewarm:budget": _fleet_report("prewarm", pw["budget_run_dir"])[0],
        }
        summaries = {}
        for name, d in (("clean", root / "clean"), ("drained", pw["run_dir"]),
                        ("budget", pw["budget_run_dir"])):
            code, doc = _fleet_report("summary", d)
            summaries[name] = {"exit": code, **{g: v["exit"] for g, v in doc["gates"].items()}}
        emit("fleet_reports", codes=codes, summaries=summaries,
             want={"fleet:clean": 0, "prewarm:drained": 0, "prewarm:budget": 1})
        ok = (codes == {"fleet:clean": 0, "prewarm:drained": 0, "prewarm:budget": 1}
              and summaries["clean"]["fleet"] == 0
              and summaries["drained"]["prewarm"] == 0 and summaries["budget"]["prewarm"] == 1
              and summaries["budget"]["exit"] >= 1
              and all(s["exit"] == max(v for k, v in s.items() if k != "exit")
                      for s in summaries.values()))
        if not ok:
            raise AssertionError(f"fleet reports: {codes}, summaries {summaries}")
        # the fleet keys of history schema 7, in the port's own history
        # file, by loadgen's ``--history`` writer
        from sbr_tpu_torch.obs import history
        from sbr_tpu_torch.serve.loadgen import _append_history

        path = _append_history(None, {**clean, "prewarm_tiles_per_sec": pw["tiles_per_s"],
                                      "prewarm_warm_hit_rate": pw["warm_hit_rate"],
                                      "prewarm_outage_p99_ms": pw["warm_outage_p99_ms"]},
                               "chip_smoke_fleet", "gpu")
        emit("fleet_history", metrics=history.load(path)[-1]["metrics"])
    return {**pop_launches, XI_KERNEL: xi_launches}


def phase_fleet_cpu_vs_card() -> None:
    """The fleet drive small on the card against the CPU: the routed mix
    (statuses and flags equal, floats within 1e-12 f64, and an in-process
    float32 engine's within 2e-5), a gossip and a bayes population query
    routed to an in-process worker on each device from one fixed point
    with the CPU's per-agent fields (records equal), prewarm's drive
    (tiles equal `beta_u_grid` on their own device bit for bit; statuses
    and the reports' exit codes equal), and the fleet reports' exit codes
    and counts."""
    import tempfile
    from pathlib import Path

    import sbr_tpu_torch as st
    from sbr_tpu_torch.infomodels import engine as info_engine
    from sbr_tpu_torch.infomodels import meanfield
    from sbr_tpu_torch.serve.router import Router

    with tempfile.TemporaryDirectory(prefix="sbr_fleet_cpu_") as tmp, \
            _env({"PYTHONPATH": str(_REPO_ROOT), "OMP_NUM_THREADS": "2"}):
        root = Path(tmp)
        runs = {dev: _fleet_run(root / dev, "mix", FLEET_SMALL, device=d)
                for dev, d in (("card", None), ("cpu", "cpu"))}
        (card, card_ans), (cpu, cpu_ans) = runs["card"], runs["cpu"]
        ints = all((a["status"], a["flags"]) == (b["status"], b["flags"])
                   for a, b in zip(card_ans, cpu_ans))
        gap = max((abs(a[f] - b[f]) for a, b in zip(card_ans, cpu_ans)
                   for f in ("xi", "tau_bar_in", "aw_max")
                   if a[f] is not None and b[f] is not None), default=0.0)
        nulls = all((a[f] is None) == (b[f] is None) for a, b in zip(card_ans, cpu_ans)
                    for f in ("xi", "tau_bar_in", "aw_max"))
        f32 = {dev: _engine_answers(FLEET_SMALL, dev, torch.float32) for dev in ("cuda", "cpu")}
        f32_ints = all((a["status"], a["flags"]) == (b["status"], b["flags"])
                       for a, b in zip(f32["cuda"], f32["cpu"]))
        f32_gap = max((abs(a[f] - b[f]) for a, b in zip(f32["cuda"], f32["cpu"])
                       for f in ("xi", "aw_max") if a[f] is not None and b[f] is not None),
                      default=0.0)
        reports = {dev: (_fleet_report("fleet", root / dev / "mix")[1], run[0])
                   for dev, run in runs.items()}
        rep_equal = all(reports["card"][0][k] == reports["cpu"][0][k]
                        for k in ("exit", "lost", "failover_count", "shed", "degraded"))
        counters_equal = card["router_counters"] == cpu["router_counters"]
        emit("fleet_cpu_vs_card", case="mix", queries=FLEET_SMALL["queries"], ints_equal=ints,
             nan_equal=nulls, max_abs=gap, tol=1e-12, f32_ints_equal=f32_ints, f32_max_abs=f32_gap,
             f32_tol=2e-5, report_fleet_equal=rep_equal, counters_equal=counters_equal,
             qps=[card["fleet_qps"], cpu["fleet_qps"]])
        if not (ints and nulls and gap <= 1e-12 and f32_ints and f32_gap <= 2e-5 and rep_equal
                and counters_equal):
            raise AssertionError("fleet mix: card and CPU differ")

        m = st.make_model_params(**FIG12)
        cfg = st.SolverConfig(n_grid=POP_GRID, bisect_iters=60, refine_crossings=False)
        fps = {ch: meanfield.solve_fixed_point_info(st.InfoModelSpec(channel=ch), m, config=cfg,
                                                    max_iter=500, device="cpu")
               for ch in ("gossip", "bayes")}
        solve, draw = meanfield.solve_fixed_point_info, info_engine._agent_fields

        def carried(spec, model, *a, **kw):
            return fps[spec.channel]

        def cpu_fields(spec_, n, seed, beta, dtype, device):
            return tuple(f.to(device) for f in draw(spec_, n, seed, beta, dtype, "cpu"))

        meanfield.solve_fixed_point_info, info_engine._agent_fields = carried, cpu_fields
        recs = {}
        try:
            for dev in ("cuda", "cpu"):
                with _inproc_worker(root / f"pop_{dev}", dev, POP_GRID, 60):
                    router = Router(root / f"pop_{dev}", poll_s=0.05).start()
                    try:
                        for ch in ("gossip", "bayes"):
                            recs[(ch, dev)] = _record(_post(router, _pop_doc(
                                ch, FLEET_POP_SMALL, FLEET_POP_SMALL_SEEDS)))
                    finally:
                        router.close()
        finally:
            meanfield.solve_fixed_point_info, info_engine._agent_fields = solve, draw
        pops = {ch: recs[(ch, "cuda")] == recs[(ch, "cpu")] for ch in ("gossip", "bayes")}
        emit("fleet_cpu_vs_card", case="population", n_agents=FLEET_POP_SMALL,
             members=FLEET_POP_SMALL_SEEDS, equal=pops)
        if not all(pops.values()):
            raise AssertionError(f"routed populations: card and CPU differ: {pops}")

        drives = {dev: _prewarm_drive("", root / f"prewarm_{dev}", dev, 1)
                  for dev in ("cuda", "cpu")}
        tiles = {dev: _prewarm_tiles_equal_grid(d, dev) for dev, d in drives.items()}
        a, b = drives["cuda"], drives["cpu"]
        same = ([w and w[0] for w in a["warm_answers"]] == [w and w[0] for w in b["warm_answers"]]
                and a["snapshot"]["counts"] == b["snapshot"]["counts"]
                and a["warm_hit_rate"] == b["warm_hit_rate"])
        pgap = max((abs(x - y) for wa, wb in zip(a["warm_answers"], b["warm_answers"])
                    if wa and wb for x, y in zip(wa[1:], wb[1:])
                    if x is not None and y is not None), default=0.0)
        codes = {dev: [_fleet_report("prewarm", d["run_dir"])[0],
                       _fleet_report("prewarm", d["budget_run_dir"])[0]]
                 for dev, d in drives.items()}
        emit("fleet_cpu_vs_card", case="prewarm", tiles_equal_own_grid=tiles, discrete_equal=same,
             max_abs=pgap, tol=1e-12, report_codes=codes)
        if not (all(t["equal"] for t in tiles.values()) and same and pgap <= 1e-12
                and codes["cuda"] == codes["cpu"] == [0, 1]):
            raise AssertionError("prewarm: card and CPU differ")


# ---------------------------------------------------------------------------
# Slice 16: the sharded paths (mesh=)
# ---------------------------------------------------------------------------

# The north-star graph (Erdős–Rényi, 10^6 agents, mean degree 10, seed 0)
# and the agents' main-path config, sharded over 1 rank (NCCL, this
# process) and 2 ranks (gloo, two child processes sharing the card).
SHARD_WORLD = 2
SHARD_TIMEOUT_S = 900
# the comm × engine matrix: the incremental engine ignores comm
SHARD_RUNS = (("gather", "scatter"), ("gather", "allgather_psum"), ("incremental", "scatter"))
# sharded_cpu: the same matrix at this size on CPU and card meshes
SHARD_CPU_N, SHARD_CPU_STEPS = 100_000, 60
# tests/test_hetero.py's K-sharded case, at SolverConfig()
SHARD_HETERO_K = 1000
SHARD_HETERO_TOL = 1e-9


def _shard_graph(n: int = N_FULL, seed: int = 0):
    """(src, dst, canonical): the host graph once canonicalized, shared by
    every prepare of the phase (`prepare_agent_graph`'s ``_canonical``)."""
    import sbr_tpu_torch as st
    from sbr_tpu_torch.social import agents as A

    src, dst = st.erdos_renyi_edges(n, 10.0, seed=seed)
    return src, dst, A._canonicalize_graph(1.0, src, dst, n, np.float32)


@contextlib.contextmanager
def _collective_clock():
    """Host seconds spent inside the collectives the sharded engines call
    (`parallel.collectives` through `social.agents`'s module alias). On a
    gloo group on the card each call copies through the host, so its host
    time is its whole cost; on NCCL it is the enqueue only (the device
    side is read from the profiler)."""
    from sbr_tpu_torch.parallel import collectives as C

    clock = types.SimpleNamespace(seconds=0.0, calls=0)
    names = ("all_gather", "psum", "psum_scatter")
    saved = {k: getattr(C, k) for k in names}

    def timed(fn):
        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                clock.seconds += time.perf_counter() - t0
                clock.calls += 1
        return wrapper

    for k in names:
        setattr(C, k, timed(saved[k]))
    try:
        yield clock
    finally:
        for k, fn in saved.items():
            setattr(C, k, fn)


def _shard_sims(mesh, src, dst, canonical, n: int, steps: int, device: str, save=None) -> list:
    """Each run of SHARD_RUNS on ``mesh``, after a 2-step warm-up on the
    same prepared graph (the recount's launch plan and the allocator's
    first blocks): its launches (set to 0 just before the run, read just
    after), seconds, collective seconds; with ``save`` the state is
    written to ``save(engine, comm)`` (an npz path)."""
    import sbr_tpu_torch as st
    from sbr_tpu_torch import _build
    from sbr_tpu_torch.social.fused import KERNEL
    from sbr_tpu_torch.social.recount import KERNEL as RECOUNT

    cfg = st.AgentSimConfig(n_steps=steps, dt=0.1)
    rows, results = [], {}
    for engine, comm in SHARD_RUNS:
        t0 = time.perf_counter()
        pg = st.prepare_agent_graph(1.0, src, dst, n, config=cfg, mesh=mesh, engine=engine,
                                    comm=comm, _canonical=canonical)
        prepare_s = time.perf_counter() - t0
        st.simulate_agents(prepared=pg, x0=1e-4, seed=0,
                           config=st.AgentSimConfig(n_steps=2, dt=0.1))
        _build.reset_launches()
        with _collective_clock() as clock:
            t0 = time.perf_counter()
            res = st.simulate_agents(prepared=pg, x0=1e-4, config=cfg, seed=0)
            if device == "cuda":
                torch.cuda.synchronize()
            sim_s = time.perf_counter() - t0
        recounts = int(res.full_recount_steps.sum())
        launches = {"infection_update": _build.LAUNCHES[KERNEL],
                    "recount_gather": _build.LAUNCHES[RECOUNT]}
        if device == "cuda":
            want = {"infection_update": steps,
                    "recount_gather": steps if (engine, comm) == ("gather", "scatter")
                    else (recounts if engine == "incremental" else 0)}
            if launches != want:
                raise AssertionError(f"{engine}/{comm}: launches {launches}, want {want}")
        rows.append(dict(engine=engine, comm=comm, n=n, steps=steps, n_gl=pg.n_gl,
                         local_edges=int(pg.src.shape[0]), prepare_s=prepare_s, simulate_s=sim_s,
                         step_ms=sim_s / steps * 1e3, collective_host_s=clock.seconds,
                         collective_calls=clock.calls, recount_steps=recounts,
                         launches=launches, agent_steps_per_s=n * steps / sim_s,
                         final_informed_frac=float(res.informed_frac[-1])))
        if save is not None:
            np.savez(save(engine, comm), **{
                f: getattr(res, f).cpu().numpy()
                for f in ("informed", "t_inf", "informed_frac", "withdrawn_frac")})
        results[(engine, comm)] = res
        del pg
    return rows, results


def _sharded_kernel_rows(canonical) -> tuple:
    """Both kernels against their plain versions on the sharded shapes,
    bit for bit, timed: the infection step on a rank's block (10^6 agents
    at world 1; 500,000 at world 2, rank 1's with the global id0 500,000,
    so a wrong offset would show as a different draw), and the recount
    gather of the all-gathered packed mask (10^6 agents) over a rank's
    edge chunk (all of it at world 1, rank 1's at world 2)."""
    from sbr_tpu_torch.social import fused, recount
    from sbr_tpu_torch.social import rng as R

    k0, k1 = R.fold_in(R.prng_key(0), 17)
    dt = 0.1
    t_next = float(np.float32(18) * np.float32(dt))
    inf_rows, rec_rows = [], []
    for world, rank in ((1, 0), (SHARD_WORLD, SHARD_WORLD - 1)):
        nb = N_FULL // world
        id0 = rank * nb
        informed, t_inf, counts, betas, safe_deg = _kernel_inputs(nb, np.float32, seed=world)
        args = (informed, t_inf, counts, betas, safe_deg, id0, k0, k1, t_next, dt)
        got_i, got_t = fused._update_cuda(*args)
        want_i, want_t = fused._update_plain(*args)
        torch.cuda.synchronize()
        mism = int(((got_i != want_i) | (got_t != want_t)).sum())
        # the draw of id0 + i differs from that of i: the offset is live
        off_i, _ = fused._update_plain(informed, t_inf, counts, betas, safe_deg, 0, k0, k1,
                                       t_next, dt)
        offset_live = id0 == 0 or bool((off_i != want_i).any())
        row = dict(world=world, rank=rank, n=nb, id0=id0, dtype="float32", mismatches=mism,
                   max_abs_err=0.0 if mism == 0 else float("nan"), offset_live=offset_live,
                   ms=time_ms(lambda: fused._update_cuda(*args)),
                   plain_ms=time_ms(lambda: fused._update_plain(*args)),
                   **bound_ms(nb, torch.float32, *frontier_of(informed, counts)),
                   library_ms=None)
        emit("sharded_kernel_vs_plain", kernel="infection_update", **row)
        if mism or not offset_live:
            raise AssertionError(f"infection kernel on the sharded shape: {row}")
        inf_rows.append(row)
        del informed, t_inf, counts, betas, safe_deg, got_i, got_t, want_i, want_t, off_i

        src_all = canonical[1]
        e_pad = (-len(src_all)) % world
        src_p = np.concatenate([src_all, np.zeros(e_pad, np.int32)])
        e_local = len(src_p) // world
        src = torch.from_numpy(np.ascontiguousarray(src_p[rank * e_local:(rank + 1) * e_local]))
        src = src.to("cuda")
        wd = torch.from_numpy(np.random.default_rng(world).random(N_FULL) < 0.3).to("cuda")
        packed = recount.pack_mask(wd)
        got = recount.bit_gather(packed, src)
        ref = recount.bit_gather_plain(packed, src)
        torch.cuda.synchronize()
        mism = int((got != ref).sum())
        wd_i32 = wd.to(torch.int32)
        b_ms, b_by = recount_bound_ms(packed.numel(), src.numel())
        row = dict(world=world, rank=rank, n_agents=N_FULL, n_edges=src.numel(),
                   mask_bytes=packed.numel(), branch=recount.LAST_BRANCH["packed"],
                   mismatches=mism, max_abs_err=int((got - ref).abs().max()),
                   ms=time_ms(lambda: recount.bit_gather(packed, src)),
                   plain_ms=time_ms(lambda: recount.bit_gather_plain(packed, src)),
                   library_ms=time_ms(lambda: torch.index_select(wd_i32, 0, src)),
                   bound_ms=b_ms, bound_by=b_by)
        emit("sharded_kernel_vs_plain", kernel="recount_gather", **row)
        if mism:
            raise AssertionError(f"recount kernel on the sharded shape: {row}")
        rec_rows.append(row)
        del src, wd, packed, got, ref, wd_i32
        torch.cuda.empty_cache()
    return inf_rows, rec_rows


def _device_split(prof) -> tuple:
    """Device ms of a profiled run by kind (NCCL's collectives, the two
    kernels of the port, copies and sets, the rest), the largest rows,
    the device's busy ms as the union of its events' intervals (streams
    may overlap), and the two kernels' launches from the raw events."""
    split = {"collectives_ms": 0.0, "infection_ms": 0.0, "recount_ms": 0.0, "copies_ms": 0.0,
             "other_ms": 0.0}
    counts = {"infection_update": 0, "recount_gather": 0}
    rows, spans = {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA or e.duration_ns() <= 0:
            continue
        # the schedule's ProfilerStep range is mirrored on the device as a
        # user annotation spanning the step: not a kernel
        if e.name().startswith("ProfilerStep") or e.is_user_annotation():
            continue
        name, ms = e.name(), e.duration_ns() / 1e6
        spans.append((e.start_ns(), e.start_ns() + e.duration_ns()))
        row = rows.setdefault(name, [0.0, 0])
        row[0] += ms
        row[1] += 1
        low = name.lower()
        if "nccl" in low:
            split["collectives_ms"] += ms
        elif "infection_update_kernel" in name:
            split["infection_ms"] += ms
            counts["infection_update"] += 1
        elif "recount_gather_kernel" in name:
            split["recount_ms"] += ms
            counts["recount_gather"] += 1
        elif "memcpy" in low or "memset" in low:
            split["copies_ms"] += ms
        else:
            split["other_ms"] += ms
    busy_ns, end = 0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy_ns += b - a
            end = b
        elif b > end:
            busy_ns += b - end
            end = b
    top = sorted(rows.items(), key=lambda kv: -kv[1][0])[:8]
    split["busy_ms"] = busy_ns / 1e6
    split["top"] = [{"kernel": k[:90], "ms": v[0], "calls": v[1]} for k, v in top]
    return split, counts


def _profile_sharded(mesh, src, dst, canonical, cfg) -> dict:
    """One steady sharded gather/scatter run unprofiled (its wall time),
    then one under torch.profiler as the active step of a schedule whose
    warm-up step is one more run (the first kernels after the tracer
    starts can go unrecorded): the device time split by kind, the busy
    share against the unprofiled wall, and the two kernels' launch counts
    read from the raw device events, held to the counters."""
    import sbr_tpu_torch as st
    from sbr_tpu_torch import _build
    from sbr_tpu_torch.social.fused import KERNEL
    from sbr_tpu_torch.social.recount import KERNEL as RECOUNT
    from torch.profiler import ProfilerActivity, profile, schedule

    pg = st.prepare_agent_graph(1.0, src, dst, N_FULL, config=cfg, mesh=mesh, engine="gather",
                                comm="scatter", _canonical=canonical)

    def run():
        st.simulate_agents(prepared=pg, x0=1e-4, config=cfg, seed=0)
        torch.cuda.synchronize()

    run()
    with _collective_clock() as clock:
        t0 = time.perf_counter()
        run()
        steady_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        run()
        prof.step()
        _build.reset_launches()
        t0 = time.perf_counter()
        run()
        wall_s = time.perf_counter() - t0
        counters = {"infection_update": _build.LAUNCHES[KERNEL],
                    "recount_gather": _build.LAUNCHES[RECOUNT]}
        prof.step()
    split, counts = _device_split(prof)
    if counts != counters:
        raise AssertionError(f"profiler launches {counts} against the counters {counters}")
    # busy: the union of the device's intervals in the profiled run, over
    # that run's wall time
    return dict(wall_ms_profiled=wall_s * 1e3, wall_ms=steady_s * 1e3,
                collective_host_ms=clock.seconds * 1e3,
                device_busy_share=split["busy_ms"] / (wall_s * 1e3), profiler_launches=counts,
                step_wall_ms=steady_s * 1e3 / cfg.n_steps,
                step_busy_ms=split["busy_ms"] / cfg.n_steps, **split)


def _same_state(a: dict, b) -> bool:
    return all(np.array_equal(a[f], getattr(b, f).cpu().numpy())
               for f in ("informed", "t_inf", "informed_frac", "withdrawn_frac"))


def _world2_start(parts: tuple) -> dict:
    """Start SHARD_WORLD child processes of this script, each a gloo rank
    on the card (NCCL takes no two ranks on one device), to run ``parts``
    ("card", "cpu"); their handles for `_world2_join`."""
    import tempfile

    tmp = tempfile.mkdtemp(prefix="sbr_sharded_")
    store = f"{tmp}/store"
    started = {"dir": tmp, "procs": [], "logs": [], "t0": time.perf_counter()}
    try:
        for r in range(SHARD_WORLD):
            log = open(f"{tmp}/rank{r}.log", "w")
            started["logs"].append(log)
            started["procs"].append(subprocess.Popen(
                [sys.executable, __file__, "_rank", str(r), str(SHARD_WORLD), store, tmp,
                 ",".join(parts)], stdout=log, stderr=subprocess.STDOUT,
            ))
    except BaseException:
        _world2_stop(started)
        raise
    return started


def _world2_stop(started: dict) -> None:
    """Kill every rank still running and close the logs."""
    for p in started["procs"]:
        if p.poll() is None:
            p.kill()
            p.wait(timeout=60)
    for log in started["logs"]:
        log.close()


def _world2_join(started: dict) -> dict:
    """Wait for the ranks of `_world2_start` (SHARD_TIMEOUT_S from their
    start; killed in a ``finally``). Returns each rank's rows and the
    directory of its saved states."""
    tmp = started["dir"]
    try:
        for p in started["procs"]:
            p.wait(timeout=max(1.0, SHARD_TIMEOUT_S - (time.perf_counter() - started["t0"])))
    finally:
        _world2_stop(started)
    for r, p in enumerate(started["procs"]):
        if p.returncode != 0:
            tail = open(f"{tmp}/rank{r}.log").read()[-4000:]
            raise AssertionError(f"sharded rank {r} exited {p.returncode}:\n{tail}")
    ranks = [json.load(open(f"{tmp}/rank{r}.json")) for r in range(SHARD_WORLD)]
    # the ranks' own seconds: the join may come long after they ended
    return {"dir": tmp, "ranks": ranks, "seconds": max(r["seconds"] for r in ranks)}


def _rank_main(argv) -> int:
    """A child rank of `_world2_start`: the group, then its parts; its rows go to
    ``<dir>/rank<r>.json``, its states to npz files beside them."""
    rank, world, store, tmp, parts = int(argv[0]), int(argv[1]), argv[2], argv[3], argv[4]
    torch.cuda.set_device(0)
    import torch.distributed as dist

    from sbr_tpu_torch.parallel import initialize_distributed

    t0 = time.perf_counter()
    initialize_distributed(f"file://{store}", world, rank, backend="gloo", device="cuda",
                           timeout_s=SHARD_TIMEOUT_S)
    out = {"rank": rank, "ready_s": time.perf_counter() - T_START}
    try:
        if "card" in parts.split(","):
            out.update(_rank_card(rank, tmp))
        if "cpu" in parts.split(","):
            out["cpu"] = _rank_cpu()
    finally:
        dist.destroy_process_group()
    out["seconds"] = time.perf_counter() - t0
    with open(f"{tmp}/rank{rank}.json", "w") as f:
        json.dump(out, f)
    return 0


def _rank_card(rank: int, tmp: str) -> dict:
    """A rank's card work: the agent matrix at full width, the sharded
    build against the host prepare, the Figure-5 grid on a (1, 2) mesh and
    the K=1000 hetero solve on a "k" mesh, each against the single-device
    port on the card."""
    import sbr_tpu_torch as st
    from sbr_tpu_torch.hetero import (get_aw_hetero, solve_equilibrium_hetero,
                                      solve_hetero_sharded, solve_learning_hetero)
    from sbr_tpu_torch.models.params import SolverConfig, make_hetero_params, make_model_params
    from sbr_tpu_torch.parallel import make_agent_mesh, make_grid_mesh
    from sbr_tpu_torch.social import graphgen as G
    from sbr_tpu_torch.sweeps.baseline_sweeps import beta_u_grid

    out = {}
    src, dst, canonical = _shard_graph()
    mesh = make_agent_mesh(device="cuda")
    out["agents"], _ = _shard_sims(mesh, src, dst, canonical, N_FULL, STEPS_FULL, "cuda",
                                   save=lambda e, c: f"{tmp}/rank{rank}_{e}_{c}.npz")
    out["profile"] = _profile_sharded(mesh, src, dst, canonical,
                                      st.AgentSimConfig(n_steps=STEPS_FULL, dt=0.1))
    del src, dst, canonical

    # the sharded build of the same graph law against the host prepare
    spec = G.ErdosRenyiSpec(N_FULL, 10.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pg_d = G.prepare_generated_graph(spec, seed=0, mesh=mesh, engine="incremental")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    gs, gd = G.generate_edges(spec, seed=0, device="cuda")
    pg_h = st.prepare_agent_graph(1.0, gs, gd, N_FULL, mesh=mesh, engine="incremental")
    pairs = {"src": (pg_d.src, pg_h.src), "row_ptr": (pg_d.row_ptr, pg_h.row_ptr),
             "indeg": (pg_d.indeg, pg_h.indeg), "betas": (pg_d.betas, pg_h.betas),
             **{k: (a, b) for k, a, b in zip(("dst2", "lstart", "ldeg"), pg_d.inc, pg_h.inc)}}
    differ = [k for k, (a, b) in pairs.items() if not torch.equal(a.cpu(), b.cpu())]
    out["build"] = dict(n=N_FULL, edges=pg_d.n_edges, local_edges=int(pg_d.src.shape[0]),
                        build_s=build_s, differing=differ)
    del pg_d, pg_h, gs, gd

    # the 500×500 float32 Figure-5 grid on a (1, 2) mesh
    betas, us = _figure5_axes(500)
    cfg = SolverConfig(refine_crossings=False)
    gmesh = make_grid_mesh(shape=(1, SHARD_WORLD), device="cuda")
    secs = []
    for _ in range(2):  # cold, then steady
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sh = beta_u_grid(betas, us, make_model_params(), cfg, mesh=gmesh, dtype=torch.float32)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    one = beta_u_grid(betas, us, make_model_params(), cfg, dtype=torch.float32, device="cuda")
    fields = ("xi", "max_aw", "status")
    out["grid"] = dict(cells=500 * 500, cold_s=secs[0], seconds=secs[1],
                       equilibria_per_s=500 * 500 / secs[1],
                       differing=[f for f in fields if not _bits_equal(getattr(sh, f).cpu(),
                                                                        getattr(one, f).cpu())]
                       + ([] if torch.equal(sh.health.flags, one.health.flags) else ["flags"]))

    # the K=1000 hetero solve on a "k" mesh, at SolverConfig()
    rng = np.random.default_rng(0)
    hb = np.exp(rng.uniform(np.log(0.2), np.log(5.0), SHARD_HETERO_K))
    hd = rng.dirichlet(np.ones(SHARD_HETERO_K))
    m = make_hetero_params(betas=hb, dist=hd / hd.sum(), eta_bar=15.0, u=0.1, p=0.5, kappa=0.6,
                           lam=0.01)
    hcfg = SolverConfig()
    kmesh = make_agent_mesh(axis_name="k", device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, res, aw = solve_hetero_sharded(m, kmesh, hcfg)
    torch.cuda.synchronize()
    hetero_s = time.perf_counter() - t0
    lsh1 = solve_learning_hetero(m.learning, hcfg, device="cuda")
    res1 = solve_equilibrium_hetero(lsh1, m.economic, hcfg)
    aw1 = get_aw_hetero(res1, lsh1)
    out["hetero"] = dict(k=SHARD_HETERO_K, seconds=hetero_s, xi=float(res.xi),
                         xi_single=float(res1.xi), xi_err=abs(float(res.xi) - float(res1.xi)),
                         aw_cum_err=float((aw.aw_cum - aw1.aw_cum).abs().max()),
                         status_equal=bool(torch.equal(res.status, res1.status)),
                         flags_equal=bool(torch.equal(res.health.flags, res1.health.flags)))
    return out


def _rank_cpu() -> list:
    """sharded_cpu on a rank: the agent matrix at SHARD_CPU_N on a CPU
    mesh and on a card mesh of the same gloo group, compared bit for bit."""
    from sbr_tpu_torch.parallel import make_agent_mesh

    src, dst, canonical = _shard_graph(SHARD_CPU_N, seed=3)
    rows = []
    _, on_cpu = _shard_sims(make_agent_mesh(device="cpu"), src, dst, canonical, SHARD_CPU_N,
                            SHARD_CPU_STEPS, "cpu")
    _, on_card = _shard_sims(make_agent_mesh(device="cuda"), src, dst, canonical, SHARD_CPU_N,
                             SHARD_CPU_STEPS, "cuda")
    for key, a in on_cpu.items():
        b = on_card[key]
        same = all(torch.equal(getattr(a, f), getattr(b, f).cpu())
                   for f in ("informed", "t_inf", "informed_frac", "withdrawn_frac",
                             "full_recount_steps"))
        rows.append(dict(engine=key[0], comm=key[1], n=SHARD_CPU_N, steps=SHARD_CPU_STEPS,
                         equal=same, final_informed_frac=float(b.informed_frac[-1])))
    return rows


def phase_sharded(card: str, w2: dict) -> dict:
    """The sharded paths on the card at full width: the agent matrix
    (gather × {scatter, allgather_psum}, incremental) on the north-star
    graph at world size 1 (NCCL, this process) and 2 (gloo ranks sharing
    the card, `_world2_start`), each rank's result bit for bit the single-device
    port's; both kernels against their plain versions on the sharded
    shapes; the world-1 run profiled (device time by kind, busy share,
    launches from the raw device events held to the counters); the
    sharded build, the Figure-5 grid on a (1, 2) mesh and the K=1000
    hetero solve on a 2-rank "k" mesh from the ranks. Returns each
    kernel's launches on the path and its sharded-shape rows."""
    import sbr_tpu_torch as st
    import torch.distributed as dist

    from sbr_tpu_torch.parallel import make_agent_mesh

    src, dst, canonical = _shard_graph()
    cfg = st.AgentSimConfig(n_steps=STEPS_FULL, dt=0.1)
    single = st.simulate_agents(
        prepared=st.prepare_agent_graph(1.0, src, dst, N_FULL, config=cfg, engine="gather",
                                        _canonical=canonical, device="cuda"),
        x0=1e-4, config=cfg, seed=0)
    launches = {"infection_update": 0, "recount_gather": 0}
    try:
        mesh = make_agent_mesh(device="cuda")
        backend = dist.get_backend()
        rows, results = _shard_sims(mesh, src, dst, canonical, N_FULL, STEPS_FULL, "cuda")
        for row in rows:
            res = results[(row["engine"], row["comm"])]
            same = _same(single, res)
            emit("sharded_agents", card=card, world=1, backend=backend, equal_single=same, **row)
            if not same:
                raise AssertionError(f"world 1 {row['engine']}/{row['comm']} differs from one device")
            for k in launches:
                launches[k] += row["launches"][k]
        prof = _profile_sharded(mesh, src, dst, canonical, cfg)
        emit("sharded_profile", card=card, world=1, backend=backend, engine="gather",
             comm="scatter", n=N_FULL, steps=STEPS_FULL, **prof)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    inf_rows, rec_rows = _sharded_kernel_rows(canonical)
    del src, dst, canonical

    single_np = {f: getattr(single, f).cpu().numpy()
                 for f in ("informed", "t_inf", "informed_frac", "withdrawn_frac")}
    for r, out in enumerate(w2["ranks"]):
        for row in out["agents"]:
            with np.load(f"{w2['dir']}/rank{r}_{row['engine']}_{row['comm']}.npz") as z:
                same = all(np.array_equal(z[f], v) for f, v in single_np.items())
            emit("sharded_agents", card=card, world=SHARD_WORLD, backend="gloo", rank=r,
                 equal_single=same, ready_s=out["ready_s"], **row)
            if not same:
                raise AssertionError(f"rank {r} {row['engine']}/{row['comm']} differs from one device")
            if r == 0:
                for k in launches:
                    launches[k] += row["launches"][k]
        emit("sharded_profile", card=card, world=SHARD_WORLD, backend="gloo", rank=r,
             engine="gather", comm="scatter", n=N_FULL, steps=STEPS_FULL, **out["profile"])
        emit("sharded_build", card=card, world=SHARD_WORLD, rank=r, **out["build"])
        emit("sharded_grid", card=card, world=SHARD_WORLD, rank=r, mesh=[1, SHARD_WORLD],
             dtype="float32", **out["grid"])
        emit("sharded_hetero", card=card, world=SHARD_WORLD, rank=r, tol=SHARD_HETERO_TOL,
             **out["hetero"])
        h = out["hetero"]
        if out["build"]["differing"] or out["grid"]["differing"]:
            raise AssertionError(f"rank {r}: sharded build or grid differs: {out}")
        if not (h["xi_err"] <= SHARD_HETERO_TOL and h["aw_cum_err"] <= SHARD_HETERO_TOL
                and h["status_equal"] and h["flags_equal"]):
            raise AssertionError(f"rank {r}: sharded hetero off the single-device solve: {h}")
    emit("sharded_kernel_launches", launches=launches, world2_s=w2["seconds"])
    for k, v in launches.items():
        if not v:
            raise AssertionError(f"the sharded path launched {k} no time")
    return {"launches": launches, "infection_rows": inf_rows, "recount_rows": rec_rows}


def phase_sharded_cpu(w2: dict) -> None:
    """The sharded agent matrix on a CPU mesh against a card mesh of the
    same 2-rank gloo group (`_rank_cpu`), bit for bit on every rank."""
    for r, out in enumerate(w2["ranks"]):
        for row in out["cpu"]:
            emit("sharded_cpu_vs_card", world=SHARD_WORLD, rank=r, **row)
            if not row["equal"]:
                raise AssertionError(f"rank {r}: sharded CPU and card runs differ: {row}")


# ---------------------------------------------------------------------------
# Slice 17: the recovery drills
# ---------------------------------------------------------------------------

CHAOS_DRILLS = {"base": None, "churn": "--churn", "fleet": "--fleet", "audit": "--audit",
                "prewarm": "--prewarm"}
# the fleet drill holds its traced waterfalls to 95% of the routed time, a
# check of the router's host time: it runs with no other drill and no
# other phase beside it
CHAOS_ALONE = ("fleet",)
CHAOS_TIMEOUT_S = 600


def _chaos_start(names) -> dict:
    """Start the named recovery drills of ``python -m
    sbr_tpu_torch.resilience.chaos`` on the card, each a process of its own
    (at a raised priority where the system allows it), all together; their
    handles for `_chaos_collect`."""
    import os
    import tempfile
    from pathlib import Path

    from sbr_tpu_torch import _build

    _build.build_all()  # published once, before any worker process starts
    env = {**os.environ, "PYTHONPATH": str(_REPO_ROOT)}
    tmp = tempfile.TemporaryDirectory(prefix="sbr_chaos_")
    root = Path(tmp.name)
    started = {"tmp": tmp, "root": root, "t0": time.perf_counter(), "procs": {}, "errs": []}
    try:
        for name in names:
            flag = CHAOS_DRILLS[name]
            argv = [sys.executable, "-m", "sbr_tpu_torch.resilience.chaos", "--json",
                    "--out", str(root / name), *([flag] if flag else [])]
            started["errs"].append(open(root / f"{name}.err", "w"))
            proc = subprocess.Popen(argv, env=env, cwd=str(_REPO_ROOT), stdout=subprocess.PIPE,
                                    stderr=started["errs"][-1], text=True)
            started["procs"][name] = proc
            try:  # before the drill starts a child, which inherits it
                os.setpriority(os.PRIO_PROCESS, proc.pid, -10)
            except OSError:
                pass
    except BaseException:
        _chaos_stop(started)
        raise
    return started


def _chaos_stop(started: dict) -> None:
    """Kill every drill still running, close the logs, drop the scratch."""
    for proc in started["procs"].values():
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    for fh in started["errs"]:
        fh.close()
    started["tmp"].cleanup()


def _chaos_collect(card: str, started: dict, check: bool = True) -> dict:
    """Wait for the drills of `_chaos_start`: one line a drill with its
    wall time (from their common start) and its checks; with ``check``,
    any drill not ok fails (`_chaos_check`)."""
    root, t0, rows = started["root"], started["t0"], {}
    for name, proc in started["procs"].items():
        out, _ = proc.communicate(timeout=max(1.0, CHAOS_TIMEOUT_S
                                              - (time.perf_counter() - t0)))
        wall = time.perf_counter() - t0
        try:
            doc = json.loads(out.strip().splitlines()[-1])
        except (ValueError, IndexError):
            doc = {}
        rows[name] = {"rc": proc.returncode, "ok": doc.get("ok") is True, "wall_s": wall,
                      "together_with": sorted(started["procs"]), "checks": doc.get("checks", {})}
        emit("chaos_drill", drill=name, **rows[name], card=card)
    if check:
        _chaos_check(root, rows)
    return rows


def _chaos_check(root, rows: dict) -> None:
    """Fail on any drill not ok, with the end of its log."""
    failed = sorted(n for n, r in rows.items() if not (r["ok"] and r["rc"] == 0))
    if failed:
        for name in failed:
            print((root / f"{name}.err").read_text()[-3000:], file=sys.stderr)
        raise AssertionError(f"chaos drills not ok: {failed}")


def _trace_gaps(run_dirs) -> dict:
    """Where the traced queries' root spans are not covered by their
    children, summed over the traces of ``run_dirs``' ``trace.jsonl``:
    milliseconds by gap, a gap named by the spans around it ("start" and
    "end" for the root's own edges), with the root spans' total."""
    spans = {}
    for d in run_dirs:
        path = d / "trace.jsonl"
        if path.exists():
            for line in path.read_text().splitlines():
                try:
                    sp = json.loads(line)
                except ValueError:
                    continue  # a torn last line of a killed worker
                spans.setdefault(sp["trace"], []).append(sp)
    gaps, total = {}, 0.0
    for trace in spans.values():
        roots = [x for x in trace if not x.get("parent")]
        if not roots:
            continue
        root = min(roots, key=lambda x: x["ts"])
        r0, r1 = root["ts"], root["ts"] + root["dur_ms"] / 1e3
        total += root["dur_ms"]
        ivals = sorted((max(x["ts"], r0), min(x["ts"] + x["dur_ms"] / 1e3, r1), x["name"])
                       for x in trace if x is not root)
        at, prev = r0, "start"
        for a, b, name in ivals:
            if b <= a:
                continue
            if a > at:
                key = f"{prev}->{name}"
                gaps[key] = gaps.get(key, 0.0) + (a - at) * 1e3
            if b > at:
                at, prev = b, name
        if r1 > at:
            gaps[f"{prev}->end"] = gaps.get(f"{prev}->end", 0.0) + (r1 - at) * 1e3
    return {"root_ms": total,
            "uncovered_ms": dict(sorted(gaps.items(), key=lambda kv: -kv[1])[:8])}


def _chaos_answers(root, pairs) -> dict:
    """The drills' served answers held to this script's six-field byte
    identity (`_answers_identical`, ``residual`` included, which the
    drills' own comparison leaves out): (reference run, compared run)
    answer files under ``root``."""
    out = {}
    for ref, other in pairs:
        a, b = (json.loads((root / f"{n}_answers.json").read_text()) for n in (ref, other))
        out[other] = {"vs": ref, "answers": len(b), "identical": _answers_identical(a, b)}
    return out


def phase_chaos(card: str, started: dict) -> dict:
    """The drills that run together (`_chaos_start`): the faulted and
    resumed tiled sweep, the elastic churn, the audit's corrupted canary and
    the prefetch controller's lease adoption and outage, at the reference
    drills' own shapes (the audit drill's fleets: 36 queries of a pool of 6
    at n_grid 96). Beyond the drills' checks: the preempted runs left no
    partial file, and the audit drill's clean and faulted runs' answers
    equal its audit-off control's in all six fields."""
    try:
        rows = _chaos_collect(card, started)
        root = started["root"]
        # the preempted runs left no partial file behind (the tiled SIGTERM
        # run's check, which the base and churn drills took over)
        left = sorted(str(p.relative_to(root)) for d in ("base/ckpt_chaos", "churn/ckpt_churn")
                      for p in (root / d).glob("*.tmp"))
        emit("chaos_preempted_left", tmp_files=left)
        if left:
            raise AssertionError(f"a preempted run left partial files: {left}")
        same = _chaos_answers(root / "audit", (("audit_off", "audit_clean"),
                                               ("audit_off", "audit_fault")))
        emit("chaos_audit_answers", fields=list(_ANSWER_FIELDS), runs=same, card=card)
        if not all(r["identical"] for r in same.values()):
            raise AssertionError(f"the audit drill's answers differ: {same}")
    finally:
        _chaos_stop(started)
    return rows


def phase_chaos_fleet(card: str) -> dict:
    """The fleet drill (`CHAOS_ALONE`) with nothing else running: three
    workers, one SIGKILLed after 8 of 36 queries (pool 6, n_grid 96: the
    reference drill's shape), tracing on. Beyond the drill's checks: its
    answers equal the single-worker run's in all six fields; the traced
    waterfalls' coverage (what the drill holds to 0.95 weighted, 0.70 the
    least); and the gates that `phase_fleet`'s kill run held on the killed
    run's directory: ``report fleet`` 0, 1 with a breaker stuck for over a
    millisecond, and ``report summary``'s exit the worst of its gates."""
    started = _chaos_start(CHAOS_ALONE)
    try:
        rows = _chaos_collect(card, started, check=False)
        root = started["root"] / "fleet"
        killed = root / "obs_fleet_churn"
        workers = sorted((root / "obs_fleet_churn_workers").glob("w*"))
        code, doc = _fleet_report("trace", killed, *workers)
        low = sorted((t for t in doc.get("trace_table", []) if t.get("coverage") is not None),
                     key=lambda t: t["coverage"])[:5]
        emit("chaos_fleet_trace", exit=code, traces=doc.get("traces"), joined=doc.get("joined"),
             failover_traces=doc.get("failover_traces"),
             coverage_weighted=doc.get("coverage_weighted"),
             coverage_mean=doc.get("coverage_mean"), coverage_min=doc.get("coverage_min"),
             lowest=[{"dur_ms": t["dur_ms"], "coverage": t["coverage"], "spans": t["spans"]}
                     for t in low], gaps=_trace_gaps([killed]), card=card)
        _chaos_check(started["root"], rows)
        same = _chaos_answers(root, (("fleet_solo", "fleet_churn"),))
        emit("chaos_fleet_answers", fields=list(_ANSWER_FIELDS), runs=same, card=card)
        if not same["fleet_churn"]["identical"]:
            raise AssertionError(f"the kill drill's answers differ: {same}")
        codes = {"fleet": _fleet_report("fleet", killed)[0],
                 "fleet_stuck": _fleet_report("fleet", killed, "--stuck-after-s", "0.001")[0]}
        code, doc = _fleet_report("summary", killed)
        gates = {g: v["exit"] for g, v in doc["gates"].items()}
        emit("chaos_fleet_reports", codes=codes, summary_exit=code, summary_gates=gates,
             want={"fleet": 0, "fleet_stuck": 1})
        if not (codes == {"fleet": 0, "fleet_stuck": 1} and gates.get("fleet") == 0
                and code == max(gates.values())):
            raise AssertionError(f"the kill drill's reports: {codes}, summary {code} {gates}")
    finally:
        _chaos_stop(started)
    return rows


# ---------------------------------------------------------------------------
# The lanes: phases run by child processes of this script
# ---------------------------------------------------------------------------

# Phases that hold no time to a bound and share no state with the phases
# beside them: once the kernels' timed phases are done, each lane is one
# child process of this script (`_lane_start`) that runs its phases in
# order, beside the other lane, the telemetry, audit and fleet phases of
# this process and the sharded ranks.
LANES = (("extensions", "extensions_cpu", "scenario", "population", "scenario_cpu", "rewire",
          "rewire_cpu", "grad", "grad_cpu"),
         ("tiled", "tiled_cpu", "figures", "figures_cpu", "obs", "obs_cpu"))
LANE_TIMEOUT_S = 900
_LANE_RESULT = '{"lane": '


def _lane_phases(card: str, wanted) -> dict:
    """The phases of LANES in ``wanted``, each lane's in its order; returns
    the launches by kernel of the population, rewire, tiled, figures and
    obs phases that ran, and the ξ kernel's of the extensions and scenario
    phases."""
    from sbr_tpu_torch.baseline.xi_kernel import KERNEL as XI_KERNEL

    out = {}
    if "extensions" in wanted:
        out["extensions"] = {XI_KERNEL: phase_extensions()}
    if "extensions_cpu" in wanted:
        phase_extensions_cpu_vs_card()
    if "scenario" in wanted:
        out["scenario"] = {XI_KERNEL: phase_scenario(card)}
    if "population" in wanted:
        out["population"] = phase_population(card)
    if "scenario_cpu" in wanted:
        phase_scenario_cpu_vs_card()
    if "rewire" in wanted:
        out["rewire"] = phase_rewire(card)
    if "rewire_cpu" in wanted:
        phase_rewire_cpu_vs_card()
    if "grad" in wanted:
        phase_grad(card)
    if "grad_cpu" in wanted:
        phase_grad_cpu_vs_card()
    if "tiled" in wanted:
        out["tiled"] = phase_tiled(card)
    if "tiled_cpu" in wanted:
        phase_tiled_cpu_vs_card()
    if "figures" in wanted:
        # the paper heatmap's counts when the tiled phase ran before it
        out["figures"] = phase_figures(card, PAPER_STATUS_COUNTS or None)
    if "figures_cpu" in wanted:
        phase_figures_cpu_vs_card()
    if "obs" in wanted:
        out["obs"] = phase_obs(card)
    if "obs_cpu" in wanted:
        phase_obs_cpu_vs_card()
    return out


def _lane_main(argv) -> int:
    """The child of `_lane_start`: the card's name, then the phases; prints
    their lines, then `_lane_phases`' result as ``{"lane": {...}}``."""
    import sbr_tpu_torch  # noqa: F401  (fails outside the repository)

    out = _lane_phases(argv[0], set(argv[1:]))
    print(json.dumps({"lane": out}), flush=True)
    return 0


def _lane_start(card: str, names) -> dict | None:
    """Start the lane (`_lane_main`) on ``names``, its standard output
    into a file; its handle for `_lane_join` (None with no phase)."""
    import tempfile
    from pathlib import Path

    if not names:
        return None
    tmp = tempfile.TemporaryDirectory(prefix="sbr_lane_")
    out = open(Path(tmp.name) / "lane.out", "w")
    env = {**os.environ, "CHIP_SMOKE_T0": repr(T_START)}
    try:
        proc = subprocess.Popen([sys.executable, __file__, "_lane", card, *names], stdout=out,
                                env=env, cwd=str(_REPO_ROOT))
    except BaseException:
        out.close()
        tmp.cleanup()
        raise
    return {"tmp": tmp, "out": out, "proc": proc, "t0": time.perf_counter(), "text": None}


def _lane_stop(lane) -> None:
    """Kill the lane if it still runs, print the phase lines it printed
    (their ``elapsed_s`` counted from this process's start) and drop its
    scratch; its output stays in ``lane["text"]``."""
    if lane is None or lane["text"] is not None:
        return
    proc = lane["proc"]
    if proc.poll() is None:
        proc.kill()
        proc.wait(timeout=30)
    lane["out"].close()
    with open(os.path.join(lane["tmp"].name, "lane.out")) as f:
        lane["text"] = f.read()
    lane["tmp"].cleanup()
    for line in lane["text"].splitlines():
        if not line.startswith(_LANE_RESULT):
            print(line, flush=True)


def _lane_join(lane) -> dict:
    """Wait for the lane (LANE_TIMEOUT_S from its start; killed in a
    ``finally``), print its lines; fails if any of its phases failed.
    Returns `_lane_phases`' result."""
    if lane is None:
        return {}
    try:
        lane["proc"].wait(timeout=max(1.0, LANE_TIMEOUT_S - (time.perf_counter() - lane["t0"])))
    finally:
        _lane_stop(lane)
    results = [ln for ln in lane["text"].splitlines() if ln.startswith(_LANE_RESULT)]
    if lane["proc"].returncode != 0 or not results:
        raise AssertionError(f"the lane's phases failed: exit {lane['proc'].returncode}")
    return json.loads(results[-1])["lane"]


PHASES = ("kernel", "main", "host", "cpu", "physics", "belief", "bayes", "bayes_cpu",
          "graphgen", "equilibrium", "sweeps", "sweeps_cpu", "social", "closure", "social_cpu",
          "serve", "serve_cpu", "recount", "extensions", "extensions_cpu", "scenario", "population",
          "scenario_cpu", "rewire", "rewire_cpu", "grad", "grad_cpu", "tiled", "tiled_cpu",
          "figures", "figures_cpu", "obs", "obs_cpu", "telemetry", "telemetry_cpu", "audit",
          "audit_cpu", "fleet", "fleet_cpu", "sharded", "sharded_cpu", "chaos", "xi")


def _recount_kernel_entry(recount: dict, tiled_launches: dict, fig_launches: dict,
                          obs_launches: dict, telem_launches: dict, audit_launches: dict,
                          fleet_launches: dict, sharded: dict) -> dict:
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
        "launches": recount["launches"] + sharded["launches"]["recount_gather"],
        "launches_by_path": {"ablation": recount["launches"],
                             "sharded": sharded["launches"]["recount_gather"],
                             "tiled": tiled_launches[RECOUNT_KERNEL],
                             "figures": fig_launches[RECOUNT_KERNEL],
                             "obs": obs_launches[RECOUNT_KERNEL],
                             "telemetry": telem_launches[RECOUNT_KERNEL],
                             "audit": audit_launches[RECOUNT_KERNEL],
                             "fleet": fleet_launches[RECOUNT_KERNEL]},
        "max_abs_err": max(r["max_abs_err"] for r in rows + sharded["recount_rows"]),
        "mismatches": sum(r["mismatches"] for r in rows + sharded["recount_rows"]),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shapes": rows,
        "sharded_shapes": sharded["recount_rows"],
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
    launches, sequence = phase_main_path() if "main" in wanted else (None, None)
    if "host" in wanted:
        phase_host_graph(info["nvidia_smi"])
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
    grid_xi = phase_sweeps_main_path() if "sweeps" in wanted else None
    if "sweeps_cpu" in wanted:
        phase_sweeps_cpu_vs_card()
    fp = phase_social() if "social" in wanted else None
    loop_launches = phase_closure(fp) if "closure" in wanted else {}
    if "social_cpu" in wanted:
        phase_social_cpu_vs_card()
    served_xi = phase_serve(info["nvidia_smi"]) if "serve" in wanted else None
    if "serve_cpu" in wanted:
        phase_serve_cpu_vs_card()
    recount = phase_recount() if "recount" in wanted else None
    xi_rows = phase_xi(info["nvidia_smi"]) if "xi" in wanted else []
    # the kernels' timed phases above ran alone; the rest run in the two
    # lanes and here, beside the sharded ranks, and the fleet drill (whose
    # trace coverage is a check of the router's host time) after all of
    # them have ended
    lanes, out = [], {"population": {}, "rewire": {}, "tiled": {}, "figures": {}, "obs": {},
                      "extensions": {}, "scenario": {}}
    parts = tuple(p for p, ph in (("card", "sharded"), ("cpu", "sharded_cpu")) if ph in wanted)
    ranks = chaos = None
    try:
        for names in LANES:
            lanes.append(_lane_start(info["nvidia_smi"], [p for p in names if p in wanted]))
        # one pair of child ranks serves both sharded phases
        ranks = _world2_start(parts) if parts else None
        telem_launches = phase_telemetry(info["nvidia_smi"]) if "telemetry" in wanted else {}
        if "telemetry_cpu" in wanted:
            phase_telemetry_cpu_vs_card()
        audit_launches = phase_audit(info["nvidia_smi"]) if "audit" in wanted else {}
        if "audit_cpu" in wanted:
            phase_audit_cpu_vs_card()
        fleet_launches = phase_fleet(info["nvidia_smi"]) if "fleet" in wanted else {}
        # all drills but the fleet's run beside the fleet's card-against-CPU
        # phase, which times nothing
        chaos = (_chaos_start([d for d in CHAOS_DRILLS if d not in CHAOS_ALONE])
                 if "chaos" in wanted else None)
        if "fleet_cpu" in wanted:
            phase_fleet_cpu_vs_card()
        if chaos is not None:
            phase_chaos(info["nvidia_smi"], chaos)
        for lane in lanes:
            out.update(_lane_join(lane))
        w2 = _world2_join(ranks) if ranks is not None else None
        if "chaos" in wanted:
            phase_chaos_fleet(info["nvidia_smi"])
    finally:
        if chaos is not None:
            _chaos_stop(chaos)
        for lane in lanes:
            _lane_stop(lane)
        if ranks is not None:
            _world2_stop(ranks)
    pop_launches, rewire_launches = out["population"], out["rewire"]
    tiled_launches, fig_launches, obs_launches = out["tiled"], out["figures"], out["obs"]
    sharded = phase_sharded(info["nvidia_smi"], w2) if "sharded" in wanted else None
    if "sharded_cpu" in wanted:
        phase_sharded_cpu(w2)
    if "profile" in wanted:
        phase_profile()
    if wanted != set(PHASES):
        return 0
    from sbr_tpu_torch.baseline.xi_kernel import KERNEL as XI_KERNEL
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
                     + rewire_launches[KERNEL] + fig_launches[KERNEL] + obs_launches[KERNEL]
                     + telem_launches[KERNEL] + audit_launches[KERNEL] + fleet_launches[KERNEL]
                     + sharded["launches"]["infection_update"]),
        "launches_by_path": {"agents": launches, "closures": loop_launches[KERNEL],
                             "population": pop_launches[KERNEL],
                             "rewire": rewire_launches[KERNEL], "tiled": tiled_launches[KERNEL],
                             "figures": fig_launches[KERNEL], "obs": obs_launches[KERNEL],
                             "telemetry": telem_launches[KERNEL],
                             "audit": audit_launches[KERNEL], "fleet": fleet_launches[KERNEL],
                             "sharded": sharded["launches"]["infection_update"]},
        "max_abs_err": max(r["max_abs_err"] for r in rows + sharded["infection_rows"]),
        "mismatches": sum(r["mismatches"] for r in rows + sharded["infection_rows"]),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "frontier_share": main_row["frontier_share"],
        "uninformed_share": main_row["uninformed_share"],
        "bytes_ms": main_row["bytes_ms"],
        "ops_ms": main_row["ops_ms"],
        "library_ms": None,
        "shapes": rows,
        "sharded_shapes": sharded["infection_rows"],
        "main_path_sequence": sequence,
    }, {
        "name": "belief_update",
        "route": "cuda",
        "source": "sbr_tpu_torch/csrc/belief_update.cu",
        "replaces": "sbr_tpu/social/fused.py:231",
        "replaces_function": "sbr_tpu/social/fused.py::_pallas_belief",
        "launches": (belief_launches + loop_launches[BELIEF_KERNEL]
                     + pop_launches[BELIEF_KERNEL] + rewire_launches[BELIEF_KERNEL]
                     + obs_launches[BELIEF_KERNEL] + telem_launches[BELIEF_KERNEL]
                     + audit_launches[BELIEF_KERNEL] + fleet_launches[BELIEF_KERNEL]),
        "launches_by_path": {"bayes": belief_launches, "closures": loop_launches[BELIEF_KERNEL],
                             "population": pop_launches[BELIEF_KERNEL],
                             "rewire": rewire_launches[BELIEF_KERNEL],
                             "tiled": tiled_launches[BELIEF_KERNEL],
                             "figures": fig_launches[BELIEF_KERNEL],
                             "obs": obs_launches[BELIEF_KERNEL],
                             "telemetry": telem_launches[BELIEF_KERNEL],
                             "audit": audit_launches[BELIEF_KERNEL],
                             "fleet": fleet_launches[BELIEF_KERNEL]},
        "max_abs_err": max(r["max_abs_err"] for r in belief_rows),
        "mismatches": sum(r["mismatches"] for r in belief_rows),
        "ms": belief_row["ms"],
        "plain_ms": belief_row["plain_ms"],
        "bound_ms": belief_row["bound_ms"],
        "bound_by": belief_row["bound_by"],
        "library_ms": None,
        "shapes": belief_rows,
    }, _recount_kernel_entry(recount, tiled_launches, fig_launches, obs_launches,
                             telem_launches, audit_launches, fleet_launches, sharded)]
    # the ξ kernel's launches on the paths that reach `compute_xi`: the
    # benchmark's `beta_u_grid` tile (`phase_xi`, one a tile), the flagship
    # shapes' fixed calls, and the paths read around their phases
    xi_row = xi_rows[0]
    xi_by_path = {"tile": sum(r["tile_launches_kernel"] for r in xi_rows), "grid": grid_xi,
                  "extensions": out["extensions"][XI_KERNEL],
                  "scenario": out["scenario"][XI_KERNEL], "tiled": tiled_launches[XI_KERNEL],
                  "figures": fig_launches[XI_KERNEL], "prewarm": fleet_launches[XI_KERNEL],
                  "served": served_xi}
    kernels.append({
        "name": "xi_bisect", "route": "cuda", "source": "sbr_tpu_torch/csrc/xi_bisect.cu",
        "replaces": None, "replaces_function": None, "launches": sum(xi_by_path.values()),
        "launches_by_path": xi_by_path,
        "mismatches": sum(not all(r["equal"].values()) for r in xi_rows),
        "ms": xi_row["kernel_ms"], "plain_ms": xi_row["plain_ms"], "bound_ms": xi_row["bound_ms"],
        "bound_by": xi_row["bound_by"], "library_ms": None, "shapes": xi_rows,
    })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["name"], "count": info["count"],
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["_rank"]:  # a child rank of the sharded phases
        sys.exit(_rank_main(sys.argv[2:]))
    if sys.argv[1:2] == ["_lane"]:  # a lane of LANES
        sys.exit(_lane_main(sys.argv[2:]))
    sys.exit(main(sys.argv[1:]))
