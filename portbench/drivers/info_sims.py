"""Traffic of information-model simulations: one analyst's closed loop of
rewired Bayesian observer runs.

Each simulation is one call of ``simulate_info`` with the configuration's
`InfoModelSpec` on its Erdős–Rényi spec: the program draws the agents'
fields and initial state and, every epoch, the whole graph on the device
from the simulation's seed, so nothing is kept between simulations. Set-up
runs one simulation to warm up. The window then runs simulations back to
back: simulation i is seeded from (seed, i), and ends when its per-step
informed and withdrawn fractions are on the host.

The workload file gives where the compared and traced simulation is
drawn, and the limits of the comparison.
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


class Driver:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, int(seed), device
        self.config, self.workload = cell.config, cell.workload
        self.np_dtype = np.dtype(self.config["dtype"])
        self.dtype = getattr(torch, self.config["dtype"])
        self.sim = self.config["sim"]
        self.n = int(self.config["n_agents"])
        self.attempted = self.failed = 0
        self.capture = None
        self.timers, self.counters = {}, {}
        self.units = []  # (call, done) of every simulation of the window
        self.kept = {}  # window position -> (seed, fractions, informed, t_inf, belief)
        self.last = None  # (window position, seed, fractions) of the latest simulation

    def setup(self) -> None:
        from sbr_tpu_torch.infomodels import InfoModelSpec, simulate_info
        from sbr_tpu_torch.social.agents import AgentSimConfig
        from sbr_tpu_torch.social.graphgen import ErdosRenyiSpec

        self._simulate = simulate_info
        s = self.sim
        self.spec = InfoModelSpec(**self.config["info"])
        self.graph = ErdosRenyiSpec(n=self.n, avg_degree=float(self.config["avg_degree"]))
        self.sim_config = AgentSimConfig(n_steps=s["n_steps"], dt=s["dt"],
                                         exit_delay=float(s["exit_delay"]),
                                         reentry_delay=float(s["reentry_delay"]))
        rng = np.random.default_rng(self.seed)
        self.sample_at = int(rng.integers(0, self.workload["sample_first_below"]))
        out, _ = self._run(sim_seed(self.seed, -1))
        # host copies of a final state, pinned on a card: the sampled
        # simulation's and the latest one's
        pin = self.device.type == "cuda"
        self.host = {slot: tuple(torch.empty(x.shape, dtype=x.dtype, pin_memory=pin)
                                 for x in out[1:]) for slot in ("sample", "last")}
        self._sync()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run(self, seed: int):
        r = self._simulate(self.spec, self.graph, x0=self.sim["x0"], config=self.sim_config,
                           seed=seed, dtype=self.np_dtype, device=self.device)
        fractions = (r.informed_frac.cpu().numpy(), r.withdrawn_frac.cpu().numpy())
        return (fractions, r.informed, r.t_inf, r.belief), r.epochs

    def _unit(self, k: int) -> bool:
        """Run the window's simulation ``k``; False once one has failed."""
        seed = sim_seed(self.seed, k)
        self.attempted += 1
        t = time.perf_counter()
        try:
            out, epochs = self._run(seed)
        except Exception as exc:  # a failed simulation is counted and ends the window
            print(f"simulation {k} failed: {exc!r}", flush=True)
            self.failed += 1
            return False
        self.units.append((t, time.perf_counter()))
        # the final state's copy is queued behind the unit, so the host does
        # not wait on it and the card holds no state between units (its peak
        # does not depend on the simulations a window runs)
        self.epochs = epochs
        self.last = (k, seed, out[0])
        slots = ("last", "sample") if k == self.sample_at else ("last",)
        for slot in slots:
            for host, x in zip(self.host[slot], out[1:]):
                host.copy_(x, non_blocking=True)
        if k == self.sample_at:
            self.kept[k] = (seed, out[0], *self.host["sample"])
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
                if not ok[0]:
                    break
                self.counters["steps_traced"] = self.sim["n_steps"]
                self.counters["epochs_traced"] = self.epochs
            elif not self._unit(k):
                break
            k += 1
        self._sync()
        if self.units:
            k, seed, fractions = self.last
            self.kept[k] = (seed, fractions, *self.host["last"])

    def end_to_end(self) -> dict:
        work = self.n * self.sim["n_steps"] * len(self.units)
        return {"agent_steps_per_s": rate(work, self.t0, self.units[-1][1])}

    def release(self) -> None:
        self._simulate = None

    def compare(self, control=None) -> tuple:
        """The numbers compared on the kept simulations: the widest gap of
        a per-step informed or withdrawn fraction, the agents whose final
        informed flag or informed time differs from the reference's, and
        the widest gap of a final belief over the reference's widest
        belief. ``control`` (a lower float type) puts the reference
        computed in it in the program's place."""
        ref = self.cell.reference()
        frac_gap = belief_gap = 0.0
        mismatched, info = 0, {}
        for k, (seed, fractions, informed, t_inf, belief) in sorted(self.kept.items()):
            want = ref.simulate(self.config, seed, self.device, dtype=self.dtype)
            if control is not None:
                got = ref.simulate(self.config, seed, self.device, dtype=control)
                fractions = (got["informed"] / self.n, got["withdrawn"] / self.n)
                informed, t_inf, belief = got["informed_final"], got["t_inf"], got["belief"]
            else:
                informed = informed.numpy()
                t_inf = t_inf.to(torch.float64).numpy()
                belief = belief.to(torch.float64).numpy()
            for series, key in zip(fractions, ("informed", "withdrawn")):
                gaps = np.abs(np.asarray(series, np.float64) - want[key] / self.n)
                frac_gap = max(frac_gap, _widest(gaps))
            mismatched += int(((informed != want["informed_final"])
                               | (t_inf != want["t_inf"])).sum())
            scale = float(np.abs(want["belief"]).max()) or 1.0
            belief_gap = max(belief_gap, _widest(np.abs(belief - want["belief"])) / scale)
            if k == self.sample_at:
                counts = np.append(want["informed"], want["informed_final"].sum())
                info = {"not_informed": self.n - counts[:-1], "newly": np.diff(counts),
                        "n": self.n, "float_bytes": self.np_dtype.itemsize,
                        "epochs": want["epochs"]}
        return {"frac_gap": frac_gap, "state_mismatch": float(mismatched),
                "belief_gap": belief_gap}, info


def _widest(gaps: np.ndarray) -> float:
    return float("inf") if np.isnan(gaps).any() else float(gaps.max())
