"""Reading a torch.profiler capture of a stretch of the timed path.

`capture` runs a function under the profiler and reduces the raw trace
events to what the per-layer readers need: every device event (kernels,
copies and sets) with its interval, the host's runtime calls that launched
them, and the host operations around those calls. The raw events are read
directly (`kineto_results.events()`): building the profiler's
function-event tree costs tens of microseconds an event.
"""

from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Callable, List, Optional, Tuple

import torch

# device events that are not kernel launches
_NOT_KERNELS = ("Memcpy", "Memset")
# host events of the CUDA runtime and driver APIs
_RUNTIME = ("cuda", "cu")


@dataclasses.dataclass
class Capture:
    """One traced stretch: ``window_s`` on the host clock from its start
    to the device's last completion, and the device events in it."""

    window_s: float
    device: List[Tuple[int, int, str, int]]  # (start ns, end ns, name, correlation id)
    launches: dict  # correlation id -> start ns of the host runtime call
    ops: List[Tuple[int, int, str]]  # host operations (start ns, end ns, name)

    def kernels(self) -> List[Tuple[int, int, str, int]]:
        return [e for e in self.device if not e[2].startswith(_NOT_KERNELS)]

    def busy_s(self) -> float:
        """Seconds in which at least one device event ran: the length of
        the union of their intervals."""
        total, end = 0, None
        for s, e, _, _ in sorted(self.device):
            if end is None or s > end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total / 1e9

    def idle_share(self) -> Optional[float]:
        if self.window_s <= 0 or not self.device:
            return None
        return max(0.0, 1.0 - self.busy_s() / self.window_s)

    def top_ops(self, k: int = 10) -> list:
        """The ``k`` device operations that took most time: [name, s]."""
        rows: dict = {}
        for s, e, name, _ in self.device:
            rows[name] = rows.get(name, 0) + (e - s)
        return [[name[:120], ns / 1e9] for name, ns in
                sorted(rows.items(), key=lambda r: -r[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list:
        """Device idle time between events, by what the host was doing:
        each gap is charged to the innermost host operation around the
        runtime call that launched the event ending it ("unattributed"
        where the trace does not link them). The ``k`` largest sums: [name, s]."""
        events = sorted(self.device)
        starts = [o[0] for o in self.ops]
        rows: dict = {}
        end = None
        for s, e, _, corr in events:
            if end is not None and s > end:
                label = self._host_op(self.launches.get(corr), starts)
                rows[label] = rows.get(label, 0) + (s - end)
            end = e if end is None else max(end, e)
        return [[name[:120], ns / 1e9] for name, ns in
                sorted(rows.items(), key=lambda r: -r[1])[:k]]

    def _host_op(self, t_ns, starts) -> str:
        if t_ns is None:
            return "unattributed"
        best = None
        i = bisect.bisect_right(starts, t_ns)
        # the innermost enclosing operation starts last among those that
        # enclose the call; look back over a bounded stretch
        for j in range(i - 1, max(-1, i - 400), -1):
            s, e, name = self.ops[j]
            if e >= t_ns:
                best = name
                break
        return best or "unattributed"


def capture(fn: Callable[[], None], device) -> Capture:
    """Run ``fn`` under the profiler, synchronised at both ends, and read
    the trace."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
    dev, launches, ops = [], {}, []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if e.duration_ns() > 0:
                dev.append((e.start_ns(), e.end_ns(), name, e.correlation_id()))
        elif name.startswith(_RUNTIME):
            # the runtime or driver call that enqueued a device event
            launches[e.correlation_id()] = e.start_ns()
        else:
            ops.append((e.start_ns(), e.end_ns(), name))
    ops.sort()
    if not dev:
        raise RuntimeError("the profiler saw no device event in the traced stretch")
    return Capture(window_s=window_s, device=dev, launches=launches, ops=ops)
