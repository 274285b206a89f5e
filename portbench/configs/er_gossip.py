"""Plain reference of the `er_gossip` configuration: the Erdős–Rényi graph
of a seed and the gossip simulation on it, written from their definitions
in plain PyTorch and numpy. It imports nothing of the program.

The graph of seed s on n agents with average degree k: E ~ Binomial(n(n−1),
k/(n−1)) from numpy's generator of s; the in-degree of every agent a
bincount of E uniform agent ids drawn from numpy's generator of
SeedSequence((s, 1)), 2^24 at a time; the edges laid out by destination,
the one at position e pointing at the agent whose range of positions holds
e, its source ⌊w·n / 2^32⌋ with w the first word of the Threefry-2x32
block of counter (e, 0) under the key words SeedSequence(s) gives.

A simulation of seed σ: an agent starts informed at time 0 where numpy's
generator of σ draws a uniform below x0 (one agent at least). At step k,
t_k = k·dt; agent i has withdrawn when informed with
t_inf_i + exit_delay ≤ t_k < t_inf_i + reentry_delay; c_i counts its
withdrawn in-neighbours, and an agent not yet informed becomes informed,
at t_{k+1}, when its uniform draw lies below 1 − exp(−β·(c_i / max(d_i, 1))·dt).
The draw is the Threefry-2x32 block of counter (i, 0) under the key words
of step k, which are the block of counter (0, k) under the simulation key
(σ's high and low 32 bits); its first word's top 23 bits are the mantissa
of a number in [1, 2), less 1.

Every floating-point operation of the simulation runs in ``dtype``:
float32 is the configuration's, and bfloat16 gives the control that the
comparison has to fail.
"""

from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


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


def graph_key(seed: int):
    k0, k1 = np.random.SeedSequence(seed).generate_state(2, np.uint32)
    return int(k0), int(k1)


def edge_count(n: int, avg_degree: float, seed: int) -> int:
    p = min(avg_degree / (n - 1), 1.0)
    return int(np.random.default_rng(seed).binomial(n * (n - 1), p))


def in_degrees(n: int, e: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(np.random.SeedSequence((seed, 1)))
    deg = np.zeros(n, np.int64)
    for done in range(0, e, 1 << 24):
        deg += np.bincount(rng.integers(0, n, size=min(1 << 24, e - done)), minlength=n)
    return deg


def build_graph(n: int, avg_degree: float, seed: int, device, chunk: int = 1 << 24) -> dict:
    """The graph of ``seed``: per edge its source and destination (int64
    tensors on ``device``), and every agent's in-degree."""
    e = edge_count(n, avg_degree, seed)
    indeg = torch.from_numpy(in_degrees(n, e, seed)).to(device)
    k0, k1 = graph_key(seed)
    src = torch.empty(e, dtype=torch.int64, device=device)
    for c0 in range(0, e, chunk):
        ids = torch.arange(c0, min(c0 + chunk, e), dtype=torch.int64, device=device)
        w, _ = threefry(k0, k1, ids, torch.zeros_like(ids))
        src[c0:c0 + ids.shape[0]] = (w * n) >> 32
    dst = torch.repeat_interleave(torch.arange(n, device=device), indeg)
    return {"n": n, "src": src, "dst": dst, "indeg": indeg}


def initial_informed(n: int, x0: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    informed = rng.random(n) < x0
    if x0 > 0 and not informed.any():
        informed[rng.integers(0, n)] = True
    return informed


def step_key(seed: int, k: int):
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return threefry((s >> 32) & MASK, s & MASK, 0, k)


def uniforms(key, n: int, dtype, device) -> torch.Tensor:
    ids = torch.arange(n, dtype=torch.int64, device=device)
    w, _ = threefry(key[0], key[1], ids, torch.zeros_like(ids))
    u = ((w >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    if dtype == torch.float32:
        return u
    # a narrower type rounds the draw and keeps it below 1
    return torch.clamp(u.to(dtype), max=1.0 - torch.finfo(dtype).eps / 2)


def simulate(graph: dict, sim: dict, seed: int, dtype=torch.float32, chunk: int = 1 << 24,
             informed0=None) -> dict:
    """One simulation of ``seed`` on ``graph``. ``sim`` holds x0, dt,
    n_steps, beta, exit_delay and reentry_delay. Returns per step the
    informed and withdrawn counts, the agents not informed and the
    frontier (not informed, with a withdrawn in-neighbour), and the final
    informed mask and informed times."""
    n, src, dst = graph["n"], graph["src"], graph["dst"]
    device = src.device
    one = lambda v: torch.tensor(float(v), dtype=dtype, device=device)  # noqa: E731
    dt, beta = one(sim["dt"]), one(sim["beta"])
    exit_delay, reentry_delay = one(sim["exit_delay"]), one(sim["reentry_delay"])
    if informed0 is None:
        informed0 = initial_informed(n, float(sim["x0"]), seed)
    informed = torch.as_tensor(informed0, device=device).clone()
    t_inf = torch.where(informed, one(0.0), one(float("inf")))
    degree = torch.clamp(graph["indeg"], min=1).to(dtype)
    rows = {k: [] for k in ("informed", "withdrawn", "not_informed", "frontier")}
    for k in range(int(sim["n_steps"])):
        t = one(k) * dt
        withdrawn = informed & (t >= t_inf + exit_delay) & (t < t_inf + reentry_delay)
        counts = torch.zeros(n, dtype=torch.int64, device=device)
        for c0 in range(0, src.shape[0], chunk):
            c1 = c0 + chunk
            counts.index_add_(0, dst[c0:c1], withdrawn[src[c0:c1]].to(torch.int64))
        rows["informed"].append(informed.sum())
        rows["withdrawn"].append(withdrawn.sum())
        rows["not_informed"].append((~informed).sum())
        rows["frontier"].append((~informed & (counts > 0)).sum())
        p = 1.0 - torch.exp(-beta * (counts.to(dtype) / degree) * dt)
        newly = ~informed & (uniforms(step_key(seed, k), n, dtype, device) < p)
        informed = informed | newly
        t_inf = torch.where(newly, one(k + 1) * dt, t_inf)
    out = {k: torch.stack(v).cpu().numpy() for k, v in rows.items()}
    out["informed_final"] = informed.cpu().numpy()
    out["t_inf"] = t_inf.to(torch.float64).cpu().numpy()
    return out
