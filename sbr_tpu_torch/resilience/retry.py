"""Unified retry policy: exponential backoff with jitter, error
classification and shared retry budgets — the port of
``sbr_tpu.resilience.retry``, the whole module.

- **Classification.** Deterministic errors (``ValueError``/``TypeError``
  by default) are re-raised at once: retrying the identical call only
  burns attempts. Everything else is treated as transient.
- **Backoff.** ``delay = min(max_delay_s, base_delay_s * multiplier**(k-1))``
  after failed attempt k, widened by up to ``jitter`` of itself (drawn
  from a caller-supplied ``random.Random``, so tests stay deterministic).
- **Budgets.** A `RetryBudget` caps the extra attempts spent across every
  scope that shares it, with an optional time-based refill for
  long-lived processes (the serving engine).
- **Observers.** Every attempt outcome goes to an ``observer`` callable:
  ``retrying``, ``recovered``, ``gave_up``, ``deterministic`` and
  ``budget_exhausted``. The default observer logs each as an obs ``retry``
  event (`obs.log_retry`, imported when first needed; a no-op without a
  run).

Standard library only.
"""

from __future__ import annotations

import dataclasses
import os
import random
import time
from typing import Callable, Optional, Tuple

DETERMINISTIC_DEFAULT: Tuple[type, ...] = (ValueError, TypeError)


class RetryError(RuntimeError):
    """All attempts failed. ``__cause__`` is the last underlying error."""

    def __init__(self, scope: str, attempts: int, reason: str = "") -> None:
        msg = f"{scope} failed after {attempts} attempt{'s' if attempts != 1 else ''}"
        if reason:
            msg += f" ({reason})"
        super().__init__(msg)
        self.scope = scope
        self.attempts = attempts


class RetryBudget:
    """Shared pool of extra attempts across scopes (see module docstring).

    With ``refill_s`` the pool refreshes on a wall-clock cadence: a
    LONG-LIVED process (the serving engine, an elastic sweep host that
    outlives many tile batches) must not let a handful of recovered
    hiccups spread over days permanently latch the budget empty, while a
    genuinely dead backend still fail-fasts (many failures inside one
    refill window). Refill is applied lazily on `take`/`remaining` reads —
    no timer thread — against an injectable ``clock`` so tests drive it
    deterministically. ``refill_s=None`` (the default) keeps the historic
    one-shot semantics sweeps rely on."""

    def __init__(self, total: int, refill_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.total = int(total)
        self.used = 0
        self.refill_s = refill_s
        self._clock = clock
        self._epoch = clock()

    def maybe_refill(self) -> bool:
        """Reset the pool when the refill period has fully lapsed (>=, so a
        read exactly at the boundary refills). Returns True on a refill."""
        if not self.refill_s or self.refill_s <= 0:
            return False
        now = self._clock()
        if now - self._epoch >= self.refill_s:
            self._epoch = now
            self.used = 0
            return True
        return False

    def take(self) -> bool:
        """Consume one retry if any remain; False means the pool is dry."""
        self.maybe_refill()
        if self.used >= self.total:
            return False
        self.used += 1
        return True

    @property
    def remaining(self) -> int:
        self.maybe_refill()
        return max(self.total - self.used, 0)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Immutable retry configuration; `call` runs a function under it."""

    max_attempts: int = 3
    base_delay_s: float = 1.0
    multiplier: float = 2.0
    max_delay_s: float = 60.0
    jitter: float = 0.0  # widen each delay by up to this fraction
    deterministic: Tuple[type, ...] = DETERMINISTIC_DEFAULT

    def delay_s(self, attempt: int, rng: Optional[random.Random] = None) -> float:
        """Backoff after failed attempt ``attempt`` (1-based), widened by up
        to ``jitter`` fraction (from ``rng`` when given — chaos tests pass a
        seeded one — else the module RNG, so the knob works out of the box)."""
        d = min(self.max_delay_s, self.base_delay_s * self.multiplier ** (attempt - 1))
        if self.jitter:
            d *= 1.0 + self.jitter * (rng.random() if rng is not None else random.random())
        return d

    def call(
        self,
        fn: Callable,
        *args,
        scope: str = "call",
        budget: Optional[RetryBudget] = None,
        observer: Optional[Callable] = None,
        sleep: Callable = time.sleep,
        rng: Optional[random.Random] = None,
        **kwargs,
    ):
        """Run ``fn(*args, **kwargs)``, retrying transient failures.

        Raises deterministic errors unchanged on the first occurrence and
        :class:`RetryError` (chained to the last error) when attempts or
        the shared ``budget`` run out.
        """
        if observer is None:
            observer = _default_observer
        last_err = None
        for attempt in range(1, self.max_attempts + 1):
            try:
                out = fn(*args, **kwargs)
            except self.deterministic as err:
                observer(
                    scope=scope, outcome="deterministic", attempt=attempt,
                    max_attempts=self.max_attempts, error=repr(err),
                )
                raise
            except Exception as err:
                last_err = err
                if attempt >= self.max_attempts:
                    break
                if budget is not None and not budget.take():
                    observer(
                        scope=scope, outcome="budget_exhausted", attempt=attempt,
                        max_attempts=self.max_attempts, error=repr(err),
                    )
                    raise RetryError(scope, attempt, "shared retry budget exhausted") from err
                backoff = self.delay_s(attempt, rng)
                observer(
                    scope=scope, outcome="retrying", attempt=attempt,
                    max_attempts=self.max_attempts, error=repr(err),
                    backoff_s=round(backoff, 3),
                )
                if backoff > 0.0:
                    sleep(backoff)
            else:
                if attempt > 1:
                    observer(
                        scope=scope, outcome="recovered", attempt=attempt,
                        max_attempts=self.max_attempts,
                    )
                return out
        observer(
            scope=scope, outcome="gave_up", attempt=self.max_attempts,
            max_attempts=self.max_attempts, error=repr(last_err),
        )
        raise RetryError(scope, self.max_attempts) from last_err


def policy_from_env(prefix: str = "SBR_RETRY", **defaults) -> RetryPolicy:
    """Build a policy from ``{prefix}_MAX_ATTEMPTS`` / ``_BASE_DELAY_S`` /
    ``_MULTIPLIER`` / ``_MAX_DELAY_S`` / ``_JITTER`` env overrides layered
    over ``defaults`` (which themselves override the dataclass defaults).

    Each subsystem gets its own tunable scope this way: the serving
    engine reads ``SBR_SERVE_RETRY_*`` (``_ATTEMPTS`` is accepted as the
    reference's alias of ``_MAX_ATTEMPTS``).
    """
    fields = {
        "max_attempts": (int, ("MAX_ATTEMPTS", "ATTEMPTS")),
        "base_delay_s": (float, ("BASE_DELAY_S",)),
        "multiplier": (float, ("MULTIPLIER",)),
        "max_delay_s": (float, ("MAX_DELAY_S",)),
        "jitter": (float, ("JITTER",)),
    }
    kw = dict(defaults)
    for name, (cast, suffixes) in fields.items():
        for suffix in suffixes:
            raw = os.environ.get(f"{prefix}_{suffix}", "").strip()
            if raw:
                kw[name] = cast(raw)
                break
    return RetryPolicy(**kw)


def _default_observer(**record) -> None:
    """Report one attempt outcome as an obs ``retry`` event and manifest
    roll-up (a no-op without a run)."""
    try:
        from sbr_tpu_torch.obs import runlog

        runlog.log_retry(**record)
    except Exception:
        pass  # telemetry must never sink the retried call
