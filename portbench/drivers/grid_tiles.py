"""Traffic of tiled β×u equilibrium sweeps: one researcher's closed loop.

The configuration's grid is cut into tiles; the tiles, in a permutation
drawn from the seed, are solved back to back through the program's
``beta_u_grid`` (host arrays in, each tile's status, ξ and AW_max copied
back to the host), cycling while the window lasts. Every seed solves the
same tiles in another order. A tile is timed from its call to its outputs
on the host; the tiles of a traced stretch, slowed by the profiler, are
left out of the tile times that the per-layer tail reads.

Every tile's first answer in the window, and the window's last answer,
are compared with the plain reference once the window has closed. The
workload file gives the numerics, the tiles warmed up in set-up, and how
many tiles a traced run profiles, from a position drawn from the seed.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from harness import trace as tracing
from harness.yardstick import rate

def axes(config: dict):
    """The β and u axes of the configuration as float64 host arrays: β is
    the reciprocal of an evenly spaced awareness axis."""
    b, u = config["beta_axis"], config["u_axis"]
    amt = np.linspace(b["amt_start"], b["amt_stop"], int(b["points"]))
    return 1.0 / amt, np.linspace(u["start"], u["stop"], int(u["points"]))


def reference_inputs(config: dict) -> dict:
    """The model's scalars as the configuration's float type holds them,
    with the derived η = η̄/β and t1 = 2η, for the plain reference."""
    m, s = config["model"], config["solver"]
    np_dtype = np.dtype(config["dtype"])
    eta = m["eta_bar"] / m["beta"]

    def held(v):
        return float(np_dtype.type(v))

    return {"p": held(m["p"]), "lam": held(m["lam"]), "kappa": held(m["kappa"]),
            "x0": held(m["x0"]), "eta": held(eta), "t1": held(2.0 * eta),
            "n_grid": s["n_grid"], "grid_warp": s["grid_warp"], "quad_order": s["quad_order"],
            "root_tol": config["root_tol"]}


def widest(gaps: np.ndarray) -> float:
    """The largest gap, infinite where any is NaN."""
    return float("inf") if np.isnan(gaps).any() else float(gaps.max())


class Driver:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, int(seed), device
        self.config, self.workload = cell.config, cell.workload
        self.dtype = getattr(torch, self.config["dtype"])
        self.attempted = self.failed = 0
        self.capture = None
        self.timers, self.counters = {}, {}
        self.units = []  # (call, done) of every tile of the window
        self.traced = range(0)  # indices in ``units`` of the traced stretch
        self.kept = {}  # tile -> its first host outputs in the window

    def setup(self) -> None:
        from sbr_tpu_torch.models.params import SolverConfig, make_model_params
        from sbr_tpu_torch.sweeps.baseline_sweeps import beta_u_grid

        self._grid = beta_u_grid
        self.betas, self.us = axes(self.config)
        m, s = self.config["model"], self.config["solver"]
        self.base = make_model_params(beta=m["beta"], eta_bar=m["eta_bar"], u=m["u"], p=m["p"],
                                      kappa=m["kappa"], lam=m["lam"], x0=m["x0"])
        self.solver = SolverConfig(n_grid=s["n_grid"], bisect_iters=s["bisect_iters"],
                                   quad_order=s["quad_order"], grid_warp=s["grid_warp"],
                                   refine_crossings=s["refine_crossings"],
                                   numerics=self.workload["numerics"])
        self.tb, self.tu = self.config["tile"]
        self.tiles = [(i, j) for i in range(len(self.betas) // self.tb)
                      for j in range(len(self.us) // self.tu)]
        rng = np.random.default_rng(self.seed)
        self.order = rng.permutation(len(self.tiles))
        self.trace_at = int(rng.integers(0, self.workload["trace_from_below"]))
        for tile in self.workload["warm_tiles"]:
            self._solve(tuple(tile))

    def _solve(self, tile):
        i, j = tile
        g = self._grid(self.betas[i * self.tb:(i + 1) * self.tb],
                       self.us[j * self.tu:(j + 1) * self.tu], self.base, config=self.solver,
                       dtype=self.dtype, device=self.device)
        return {"status": g.status.cpu().numpy(), "xi": g.xi.cpu().numpy(),
                "aw_max": g.max_aw.cpu().numpy()}

    def _unit(self, k: int) -> bool:
        """Solve the window's tile ``k``; False once a tile has failed."""
        tile = self.tiles[self.order[k % len(self.tiles)]]
        self.attempted += 1
        t = time.perf_counter()
        try:
            out = self._solve(tile)
        except Exception as exc:  # a failed tile is counted and ends the window
            print(f"tile {tile} failed: {exc!r}", flush=True)
            self.failed += 1
            return False
        self.units.append((t, time.perf_counter()))
        self.last = (tile, out)
        self.kept.setdefault(tile, out)
        return True

    def window(self, seconds: float, trace: bool) -> None:
        n_traced = int(self.workload["trace_tiles"]) if trace else 0
        need = self.trace_at + n_traced if trace else 1
        self.t0 = time.perf_counter()
        end = self.t0 + seconds
        k = 0
        while k < need or time.perf_counter() < end:
            if trace and k == self.trace_at:
                ok = []

                def stretch(k0=k):
                    ok.extend(self._unit(j) for j in range(k0, k0 + n_traced))

                first = len(self.units)
                self.capture = tracing.capture(stretch, self.device)
                self.traced = range(first, len(self.units))
                self.counters["tiles_traced"] = n_traced
                k += n_traced
                if not all(ok):
                    break
                continue
            if not self._unit(k):
                break
            k += 1
        self.timers["tile_s"] = self.tile_times()

    def tile_times(self) -> list:
        """Seconds of every tile of the window outside the traced stretch."""
        return [d - c for k, (c, d) in enumerate(self.units) if k not in self.traced]

    def end_to_end(self) -> dict:
        cells = self.tb * self.tu * len(self.units)
        return {"equilibria_per_s": rate(cells, self.t0, self.units[-1][1])}

    def release(self) -> None:
        self._grid = None

    def compare(self, control=None) -> tuple:
        """The numbers compared on every tile's first answer and on the
        last answer: the share of cells whose status differs from the
        reference's, and over the cells that run on both sides the widest
        relative gap of ξ and absolute gap of AW_max. ``control`` (a lower
        float type) puts the reference computed in it in the program's
        place."""
        ref = self.cell.reference()
        inputs = reference_inputs(self.config)
        np_dtype = np.dtype(self.config["dtype"])
        rows = 64 if self.device.type == "cuda" else 4
        mismatch = cells = 0
        xi_gap = aw_gap = 0.0
        answers = list(self.kept.items())
        if self.units:
            answers.append(self.last)
        for tile, out in answers:
            i, j = tile
            b = self.betas[i * self.tb:(i + 1) * self.tb].astype(np_dtype).astype(np.float64)
            u = self.us[j * self.tu:(j + 1) * self.tu].astype(np_dtype).astype(np.float64)
            want = ref.solve_cells(b, u, inputs, dtype=torch.float64, device=self.device, rows=rows)
            if control is not None:
                out = ref.solve_cells(b, u, inputs, dtype=control, device=self.device, rows=rows)
            mismatch += int((out["status"] != want["status"]).sum())
            cells += want["status"].size
            both = (out["status"] == 0) & (want["status"] == 0)
            if both.any():
                xw, aw = want["xi"][both], want["aw_max"][both]
                xi_gap = max(xi_gap, widest(
                    np.abs(out["xi"][both].astype(np.float64) - xw) / np.abs(xw)))
                aw_gap = max(aw_gap, widest(np.abs(out["aw_max"][both].astype(np.float64) - aw)))
        numbers = {"status_mismatch": mismatch / cells, "xi_gap": xi_gap, "aw_gap": aw_gap}
        return numbers, {"tiles_compared": len(answers)}
