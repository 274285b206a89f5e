"""Plain reference of the `er_bayes_rewire` configuration: a Bayesian
observer simulation under panic rewiring, written from its definitions in
plain PyTorch and numpy. It imports nothing of the program.

A simulation of seed σ on n agents with average degree k and the spec's
fields (q_run, q_calm, threshold θ, threshold_scale s, awareness a,
epoch_steps L, rewire_bias b):

- Edge count: E ~ Binomial(n(n−1), k/(n−1)) from numpy's generator of σ,
  the same in every epoch.
- Agent fields: one Threefry-2x32 block of counter (i, 0) an agent under
  the key words of SeedSequence((σ, 31)); its second word's top 23 bits
  are the mantissa of u in [1, 2), less 1, clipped to [2^-23, 1 − 2^-23];
  the threshold is θ + s·log(u/(1−u)), the log-odds taken in float32;
  every awareness is a.
- Initial state: an agent starts informed at time 0 where numpy's
  generator of σ draws a uniform below x0 (one agent at least), with
  belief 0.
- Epochs: epoch j starts at step jL, at time t = dtype(jL·dt) rounded from
  the float64 product. Its graph: the in-degree of every agent a bincount
  of E uniform agent ids from numpy's generator of SeedSequence((σ, 1, j)),
  2^24 at a time; edges laid out by destination (row pointers the prefix
  of the in-degrees); the source of edge position p is the entry of the
  tilt table that the first Threefry word of counter (p, 0), under the key
  words of SeedSequence((σ, 23, j)), falls in (the first entry greater than
  it, at most n − 1). The tilt table quantises the source marginal
  w_i = 1·(1 + b·wd_i), wd the withdrawn mask at the epoch's start, in
  float32, one rounded operation at a time: its prefix in XLA's blocked
  order of base 16, divided by the last entry, times 2^32, at most
  4294967295.0 (which rounds to 2^32), converted to an integer and held
  in [0, 2^32 − 1] (the conversion saturates).
- Steps: at global step k, t_k = dtype(k)·dtype(dt); agent i has
  withdrawn when informed with t_inf_i + exit_delay ≤ t_k < t_inf_i +
  reentry_delay; c_i counts its withdrawn in-neighbours; with
  w = c_i / max(d_i, 1), the belief becomes
  fma(dt, fma(w, llr1, (1 − w)·llr0), belief), each multiply-add rounded
  once, llr1 = log(q_run/q_calm), llr0 = log((1−q_run)/(1−q_calm)); an
  agent not informed becomes informed, at t_{k+1} = dtype(k+1)·dtype(dt),
  when a·belief ≥ its threshold.

Every floating-point operation of the simulation runs in ``dtype``, but
for the tilt table, the uniform and its log-odds, which are float32 in
every dtype: float32 is the configuration's, and bfloat16 gives the
control that the comparison has to fail (there each multiply-add is
rounded twice).
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
SCAN_BASE = 16


def threefry(k0, k1, c0, c1):
    """One Threefry-2x32 block (20 rounds) of key (k0, k1) on counter
    (c0, c1): Python ints or int64 tensors of 32-bit words."""

    def rotl(v, r):
        return ((v << r) | (v >> (32 - r))) & MASK

    ks = (k0, k1, 0x1BD11BDA ^ k0 ^ k1)
    x0, x1 = (c0 + ks[0]) & MASK, (c1 + ks[1]) & MASK
    for block in range(5):
        for r in ROTATIONS[block % 2]:
            x0 = (x0 + x1) & MASK
            x1 = rotl(x1, r) ^ x0
        x0 = (x0 + ks[(block + 1) % 3]) & MASK
        x1 = (x1 + ks[(block + 2) % 3] + block + 1) & MASK
    return x0, x1


def key_words(entropy):
    k0, k1 = np.random.SeedSequence(entropy).generate_state(2, np.uint32)
    return int(k0), int(k1)


def edge_count(n: int, avg_degree: float, seed: int) -> int:
    p = min(avg_degree / (n - 1), 1.0)
    return int(np.random.default_rng(seed).binomial(n * (n - 1), p))


def in_degrees(n: int, e: int, seed: int, epoch: int) -> np.ndarray:
    rng = np.random.default_rng(np.random.SeedSequence((seed, 1, epoch)))
    deg = np.zeros(n, np.int64)
    for done in range(0, e, 1 << 24):
        deg += np.bincount(rng.integers(0, n, size=min(1 << 24, e - done)), minlength=n)
    return deg


def blocked_prefix(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum in XLA's order: pad to rows of 16, a running
    sum along each row, the rows' totals summed the same way, and each
    row's carry (the total of the rows before it) added to the row."""
    n = x.shape[0]
    rows = -(-n // SCAN_BASE)
    block = torch.zeros(rows * SCAN_BASE, dtype=x.dtype, device=x.device)
    block[:n] = x
    block = block.reshape(rows, SCAN_BASE)
    sums = [block[:, 0]]
    for j in range(1, SCAN_BASE):
        sums.append(sums[-1] + block[:, j])
    run = torch.stack(sums, dim=1)
    if rows > 1:
        totals = blocked_prefix(run[:, -1])
        carry = torch.zeros_like(totals)
        carry[1:] = totals[:-1]
        run = run + carry[:, None]
    return run.reshape(-1)[:n]


def tilt_table(withdrawn: torch.Tensor, bias: float) -> torch.Tensor:
    """The quantised inverse CDF of the tilted source marginal (int64)."""
    f32 = torch.float32
    dev = withdrawn.device
    weight = torch.ones(withdrawn.shape[0], dtype=f32, device=dev)
    weight = weight * (1.0 + torch.tensor(bias, dtype=f32, device=dev) * withdrawn.to(f32))
    cdf = blocked_prefix(weight)
    cdf = cdf / cdf[-1]
    words = torch.clamp(cdf * 4294967296.0, max=4294967295.0).to(torch.int64)
    return torch.clamp(words, 0, MASK)


def sources(n: int, e: int, key, table: torch.Tensor, chunk: int = 1 << 24) -> torch.Tensor:
    """The source of every edge position (int64), by destination order."""
    src = torch.empty(e, dtype=torch.int64, device=table.device)
    for c0 in range(0, e, chunk):
        ids = torch.arange(c0, min(c0 + chunk, e), dtype=torch.int64, device=table.device)
        w, _ = threefry(key[0], key[1], ids, torch.zeros_like(ids))
        src[c0:c0 + ids.shape[0]] = torch.clamp(
            torch.searchsorted(table, w, right=True), max=n - 1)
    return src


def thresholds(n: int, seed: int, info: dict, dtype, device) -> torch.Tensor:
    k0, k1 = key_words((seed, 31))
    ids = torch.arange(n, dtype=torch.int64, device=device)
    _, w1 = threefry(k0, k1, ids, torch.zeros_like(ids))
    u = ((w1 >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    u = torch.clamp(u, 2.0**-23, 1.0 - 2.0**-23)
    log_odds = torch.log(u / (1.0 - u)).to(dtype)
    base = torch.full((n,), info["threshold"], dtype=dtype, device=device)
    return base + torch.tensor(info["threshold_scale"], dtype=dtype, device=device) * log_odds


def initial_informed(n: int, x0: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    informed = rng.random(n) < x0
    if x0 > 0 and not informed.any():
        informed[rng.integers(0, n)] = True
    return informed


def _round_once(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a·b + c for float32 operands, rounded once to float32: the product
    is exact in float64; the float64 sum, with its error from Knuth's
    TwoSum, is rounded to odd, and then to nearest in float32, which is the
    single rounding since 53 ≥ 24 + 2 (Boldo and Melquiond, 2008)."""
    p, c = a.double() * b.double(), c.double()
    s = p + c
    back = s - p
    err = (p - (s - back)) + (c - back)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, math.inf, -math.inf).to(torch.float64)
    return torch.where((err != 0) & even, torch.nextafter(s, toward), s).float()


def _multiply_add(a, b, c, dtype):
    if dtype == torch.float32:
        return _round_once(a, b, c)
    return a * b + c  # the control: the product and the sum each rounded


def segment_counts(active: torch.Tensor, row_ptr: torch.Tensor) -> torch.Tensor:
    """Per destination, the active edges of its range of positions."""
    prefix = torch.zeros(active.shape[0] + 1, dtype=torch.int64, device=active.device)
    prefix[1:] = torch.cumsum(active.to(torch.int64), 0)
    return prefix[row_ptr[1:]] - prefix[row_ptr[:-1]]


def simulate(config: dict, seed: int, device, dtype=torch.float32) -> dict:
    """One simulation of ``seed`` under ``config`` (the configuration's
    file: n_agents, avg_degree, info, sim). Returns per step the informed
    and withdrawn counts (at the step's start), the final informed mask,
    informed times and beliefs (float64), and the number of epochs."""
    n, info, sim = int(config["n_agents"]), config["info"], config["sim"]
    one = lambda v: torch.tensor(float(v), dtype=dtype, device=device)  # noqa: E731
    dt = one(sim["dt"])
    exit_delay, reentry_delay = one(sim["exit_delay"]), one(sim["reentry_delay"])
    llr1 = one(math.log(info["q_run"] / info["q_calm"]))
    llr0 = one(math.log((1.0 - info["q_run"]) / (1.0 - info["q_calm"])))
    awareness = one(info["awareness"])
    e = edge_count(n, float(config["avg_degree"]), seed)
    thr = thresholds(n, seed, info, dtype, device)
    informed = torch.as_tensor(initial_informed(n, float(sim["x0"]), seed), device=device)
    t_inf = torch.where(informed, one(0.0), one(math.inf))
    belief = torch.zeros(n, dtype=dtype, device=device)

    def withdrawn(t):
        return informed & (t >= t_inf + exit_delay) & (t < t_inf + reentry_delay)

    rows = {"informed": [], "withdrawn": []}
    n_steps, length = int(sim["n_steps"]), int(info["epoch_steps"])
    done = epoch = 0
    while done < n_steps:
        table = tilt_table(withdrawn(one(done * float(sim["dt"]))), float(info["rewire_bias"]))
        src = sources(n, e, key_words((seed, 23, epoch)), table)
        indeg = torch.from_numpy(in_degrees(n, e, seed, epoch)).to(device)
        row_ptr = torch.zeros(n + 1, dtype=torch.int64, device=device)
        row_ptr[1:] = torch.cumsum(indeg, 0)
        degree = torch.clamp(indeg.to(dtype), min=1.0)
        for k in range(done, min(done + length, n_steps)):
            wd = withdrawn(one(k) * dt)
            counts = segment_counts(wd[src], row_ptr)
            rows["informed"].append(informed.sum())
            rows["withdrawn"].append(wd.sum())
            w = counts.to(dtype) / degree
            belief = _multiply_add(dt, _multiply_add(w, llr1, (1.0 - w) * llr0, dtype),
                                   belief, dtype)
            newly = ~informed & (awareness * belief >= thr)
            informed = informed | newly
            t_inf = torch.where(newly, one(k + 1) * dt, t_inf)
        done = min(done + length, n_steps)
        epoch += 1
        del src, table
    out = {k: torch.stack(v).cpu().numpy() for k, v in rows.items()}
    out["informed_final"] = informed.cpu().numpy()
    out["t_inf"] = t_inf.to(torch.float64).cpu().numpy()
    out["belief"] = belief.to(torch.float64).cpu().numpy()
    out["epochs"] = epoch
    return out
