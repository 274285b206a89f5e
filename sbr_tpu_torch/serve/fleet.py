"""Dispatch circuit breaking and the per-query deadline default: the
port of `CircuitBreaker`, `default_deadline_ms` and `_env_float` from
``sbr_tpu.serve.fleet``.

`CircuitBreaker` is the closed → open → half-open state machine the
engine holds over its own device dispatch: ``threshold`` consecutive
failures open it, ``cooldown_s`` later exactly one half-open probe is let
through, and a success closes it. Injectable clock, no threads: the state
advances lazily on `allow()` reads.

Fleet membership (`WorkerAnnouncer`, `live_workers`), the tile-cache
bridge of the degradation ladder (`TileCacheBridge`) and the worker
process entry wait for the elastic tile cache and the fleet (ROADMAP
items E.19 and E.21).
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional


def default_deadline_ms() -> Optional[float]:
    """Fleet-wide default per-query deadline (``SBR_SERVE_DEADLINE_MS``);
    None when unset (queries without an explicit deadline never shed)."""
    raw = os.environ.get("SBR_SERVE_DEADLINE_MS", "").strip()
    return float(raw) if raw else None


def _env_float(name: str, default):
    """Float env override with a passthrough default (None allowed)."""
    raw = os.environ.get(name, "").strip()
    return float(raw) if raw else default


class CircuitBreaker:
    """Consecutive-failure breaker: closed → open → half-open → closed.

    ``allow()`` is the single gate: True while closed; False while open
    until ``cooldown_s`` has elapsed, then exactly ONE True (the half-open
    probe) until its outcome lands — a success closes the breaker, a
    failure re-opens it (and restarts the cooldown). Lazy state (no timer
    thread), injectable ``clock`` so tests drive transitions
    deterministically. ``on_transition(old, new)`` observes state changes.
    """

    def __init__(self, threshold: Optional[int] = None,
                 cooldown_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 on_transition: Optional[Callable] = None) -> None:
        self.threshold = int(threshold if threshold is not None
                             else _env_float("SBR_BREAKER_THRESHOLD", 3))
        self.cooldown_s = float(cooldown_s if cooldown_s is not None
                                else _env_float("SBR_BREAKER_COOLDOWN_S", 5.0))
        self._clock = clock
        self._on_transition = on_transition
        self.state = "closed"
        self.consecutive_failures = 0
        self._opened_at: Optional[float] = None
        self._probe_inflight = False
        # Monotonic time of the last state change (None = never changed),
        # to tell a breaker legitimately open from one stuck open.
        self.last_transition_at: Optional[float] = None

    def age_s(self) -> Optional[float]:
        """Seconds since the last state transition (None = never moved)."""
        if self.last_transition_at is None:
            return None
        return self._clock() - self.last_transition_at

    def _transition(self, new: str) -> None:
        old = self.state
        if old == new:
            return
        self.state = new
        self.last_transition_at = self._clock()
        if self._on_transition is not None:
            try:
                self._on_transition(old, new)
            except Exception:
                pass  # observation must never sink the breaker

    def admissible(self) -> bool:
        """Side-effect-free view of `allow()`: would a request be admitted
        right now? Candidate *selection* must use this — `allow()` grants
        the single half-open probe, and granting it to a worker that is
        merely being RANKED (not forwarded to) would strand the breaker in
        half_open forever, since no outcome ever lands for that probe."""
        if self.state == "closed":
            return True
        if self.state == "open":
            return self._clock() - (self._opened_at or 0.0) >= self.cooldown_s
        return not self._probe_inflight

    def allow(self) -> bool:
        """Whether one request may proceed right now (see class docstring).
        Call this only when the request will actually be SENT — a True in
        half-open state grants the single probe, and the caller then owes
        the breaker a `record_success`/`record_failure` outcome."""
        if self.state == "closed":
            return True
        if self.state == "open":
            if self._clock() - (self._opened_at or 0.0) >= self.cooldown_s:
                self._transition("half_open")
                self._probe_inflight = True
                return True
            return False
        # half_open: one probe at a time — concurrent traffic keeps waiting
        if not self._probe_inflight:
            self._probe_inflight = True
            return True
        return False

    def record_success(self) -> None:
        self.consecutive_failures = 0
        self._probe_inflight = False
        self._transition("closed")

    def record_abandoned(self) -> None:
        """The request ended with no verdict on the PEER (e.g. the query's
        own deadline expired in flight): release a held half-open probe
        without moving the state machine in either direction."""
        self._probe_inflight = False

    def record_failure(self) -> None:
        self.consecutive_failures += 1
        self._probe_inflight = False
        if self.state == "half_open" or (
            self.state == "closed" and self.consecutive_failures >= self.threshold
        ):
            self._opened_at = self._clock()
            self._transition("open")
