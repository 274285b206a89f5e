"""Traffic of explicit-agent simulations on one graph: one analyst's closed
loop.

Set-up builds the configuration's graph on the device from the seed
(``prepare_generated_graph``, the engine the workload file pins) and runs
one simulation to warm up. The window then runs simulations back to back
on that graph through ``simulate_agents``: simulation i draws its informed
agents and its infection key from (seed, i), and ends when its per-step
informed and withdrawn fractions are on the host.

The workload file gives the engine, where the compared and traced
simulation is drawn, and the limits of the comparison.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from harness import trace as tracing
from harness.yardstick import rate


def sim_seed(seed: int, i: int) -> int:
    """The seed of the window's simulation ``i`` (``i = -1``: the warm-up),
    a 63-bit number drawn from (seed, i)."""
    words = np.random.SeedSequence([int(seed), 1 + (i >= 0), max(i, 0)]).generate_state(
        2, np.uint32)
    return (int(words[0]) << 31) | (int(words[1]) >> 1)


def sim_params(config: dict) -> dict:
    s = config["sim"]
    return {"x0": s["x0"], "dt": s["dt"], "n_steps": s["n_steps"], "beta": s["beta"],
            "exit_delay": float(s["exit_delay"]), "reentry_delay": float(s["reentry_delay"])}


class Driver:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, int(seed), device
        self.config, self.workload = cell.config, cell.workload
        self.np_dtype = np.dtype(self.config["dtype"])
        self.dtype = getattr(torch, self.config["dtype"])
        self.sim = sim_params(self.config)
        self.n = int(self.config["n_agents"])
        self.attempted = self.failed = 0
        self.capture = None
        self.timers, self.counters = {}, {}
        self.units = []  # (call, done) of every simulation of the window
        self.kept = {}  # window position -> (seed, fractions, informed, t_inf)

    def setup(self) -> None:
        from sbr_tpu_torch.social.agents import AgentSimConfig, simulate_agents
        from sbr_tpu_torch.social.graphgen import ErdosRenyiSpec, prepare_generated_graph

        self._simulate = simulate_agents
        s = self.sim
        self.sim_config = AgentSimConfig(n_steps=s["n_steps"], dt=s["dt"],
                                         exit_delay=s["exit_delay"],
                                         reentry_delay=s["reentry_delay"])
        spec = ErdosRenyiSpec(n=self.n, avg_degree=float(self.config["avg_degree"]))
        t = time.perf_counter()
        self.graph = prepare_generated_graph(
            spec, seed=self.seed, betas=s["beta"], config=self.sim_config,
            engine=self.workload["engine"], dtype=self.np_dtype, device=self.device)
        self._sync()
        self.timers["graph_build_s"] = time.perf_counter() - t
        rng = np.random.default_rng(self.seed)
        self.sample_at = int(rng.integers(0, self.workload["sample_first_below"]))
        self._run(sim_seed(self.seed, -1))
        self._sync()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run(self, seed: int):
        r = self._simulate(prepared=self.graph, x0=self.sim["x0"], config=self.sim_config,
                           seed=seed)
        fractions = (r.informed_frac.cpu().numpy(), r.withdrawn_frac.cpu().numpy())
        return fractions, r.informed, r.t_inf

    def _unit(self, k: int) -> bool:
        """Run the window's simulation ``k``; False once one has failed."""
        seed = sim_seed(self.seed, k)
        self.attempted += 1
        t = time.perf_counter()
        try:
            out = self._run(seed)
        except Exception as exc:  # a failed simulation is counted and ends the window
            print(f"simulation {k} failed: {exc!r}", flush=True)
            self.failed += 1
            return False
        self.units.append((t, time.perf_counter()))
        self.last = (k, seed, *out)
        if k == self.sample_at:
            self.kept[k] = (seed, *out)
        return True

    def window(self, seconds: float, trace: bool) -> None:
        self.t0 = time.perf_counter()
        end = self.t0 + seconds
        k = 0
        while k <= self.sample_at or time.perf_counter() < end:
            if trace and k == self.sample_at:
                ok = []

                def stretch(k0=k):
                    ok.append(self._unit(k0))

                self.capture = tracing.capture(stretch, self.device)
                self.counters["steps_traced"] = self.sim["n_steps"]
                if not ok[0]:
                    break
            elif not self._unit(k):
                break
            k += 1
        if self.units:
            self.kept[self.last[0]] = self.last[1:]

    def end_to_end(self) -> dict:
        work = self.n * self.sim["n_steps"] * len(self.units)
        return {"agent_steps_per_s": rate(work, self.t0, self.units[-1][1])}

    def release(self) -> None:
        self.graph = None
        self._simulate = None

    def compare(self, control=None) -> tuple:
        """The numbers compared on the kept simulations: the widest gap of
        a per-step informed or withdrawn fraction, and the agents whose
        final informed flag or informed time differs from the reference's.
        ``control`` (a lower float type) puts the reference computed in it
        in the program's place."""
        ref = self.cell.reference()
        graph = ref.build_graph(self.n, float(self.config["avg_degree"]), self.seed,
                                self.device)
        frac_gap, mismatched, info = 0.0, 0, {}
        for k, (seed, fractions, informed, t_inf) in sorted(self.kept.items()):
            want = ref.simulate(graph, self.sim, seed, dtype=self.dtype)
            if control is not None:
                got = ref.simulate(graph, self.sim, seed, dtype=control)
                fractions = (got["informed"] / self.n, got["withdrawn"] / self.n)
                informed, t_inf = got["informed_final"], got["t_inf"]
            else:
                informed = informed.cpu().numpy()
                t_inf = t_inf.to(torch.float64).cpu().numpy()
            for series, key in zip(fractions, ("informed", "withdrawn")):
                gaps = np.abs(np.asarray(series, np.float64) - want[key] / self.n)
                frac_gap = max(frac_gap, float("inf") if np.isnan(gaps).any() else gaps.max())
            mismatched += int(((informed != want["informed_final"])
                               | (t_inf != want["t_inf"])).sum())
            if k == self.sample_at:
                info = {"frontier": want["frontier"], "not_informed": want["not_informed"],
                        "n": self.n, "float_bytes": self.np_dtype.itemsize}
        return {"frac_gap": frac_gap, "state_mismatch": float(mismatched)}, info
