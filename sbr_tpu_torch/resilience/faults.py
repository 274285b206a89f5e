"""Deterministic fault injection: seeded fault plans fired at named points,
the port of ``sbr_tpu.resilience.faults``.

A `FaultPlan` is a seeded list of rules, each bound to a named **fault
point** planted where the port's execution can really fail:

=====================  ====================================================
point                  planted in
=====================  ====================================================
``sweep.dispatch``     `sweeps.baseline_sweeps.beta_u_grid` / `u_sweep` and
                       `sweeps.policy_sweeps.policy_sweep_interest`, just
                       before the batched solve is queued on the device
``tile.compute``       `utils.checkpoint.TileRunner`, per tile attempt
``tile.result``        same, after a tile computes (site poisons results)
``checkpoint.save``    after a tile's atomic save (site corrupts the file)
``checkpoint.load``    before a checkpointed tile is read back
``tilecache.load``     `resilience.elastic.TileCache`, before a cross-run
                       cache entry is read (verify/quarantine path)
``barrier.poll``       `parallel.distributed`'s filesystem barrier and the
                       elastic scheduler's claim loop, per poll
``serve.dispatch``     `serve.engine.Engine._dispatch`, inside the retried
                       scope of every micro-batch dispatch (drives the
                       breaker and the degradation ladder)
=====================  ====================================================

Fault kinds:

- ``transient``: raise `InjectedFault` (a ``RuntimeError``); the retry
  policy must absorb it.
- ``hang``: sleep ``duration_s`` (default 30), then continue.
- ``preempt``: send this process ``signal`` (default ``TERM``; ``KILL``
  for a death no handler sees). The graceful shutdown (SIGTERM) or the
  resume from disk (SIGKILL) must recover.
- ``nan``: returned to the call site, which poisons ``cells`` result cells
  with NaN and marks their health flags divergent; the degrade ladder
  (`resilience.heal`) must repair them.
- ``corrupt``: returned to the call site, which truncates the file just
  written; the sha256 check on load must quarantine it.

Determinism: a plan with the same ``seed`` replayed against the same
sequence of fault-point invocations fires the same faults (per-rule
counters and a per-rule ``random.Random`` stream seeded exactly as the
reference's, so both packages fire the same sequence from one spec).

``SBR_FAULT_PLAN`` holds inline JSON or a path to a JSON file::

    {"seed": 0, "rules": [
      {"point": "tile.compute", "kind": "transient", "at_hits": [1]},
      {"point": "checkpoint.save", "kind": "corrupt", "match": "b00000",
       "max_fires": 1},
      {"point": "tile.result", "kind": "nan", "p": 0.5, "cells": 2}
    ]}

A rule fires on a matching invocation when its hit index is in
``at_hits``, or (without ``at_hits``) when its seeded stream draws below
``p`` (default 1.0); ``max_fires`` caps its firings and ``match`` keeps it
to targets holding that substring. Every firing is appended to the plan's
``firings`` list and logged as an obs ``fault`` event when a run is
active (``python -m sbr_tpu_torch.obs.report resilience`` folds them).

Standard library only (the obs run log, imported when a fault fires, loads
no torch either).
"""

from __future__ import annotations

import json
import os
import random
import signal as _signal
import time
from typing import Optional

KINDS = ("transient", "hang", "preempt", "nan", "corrupt")


class InjectedFault(RuntimeError):
    """A deliberately injected transient error (retryable by design)."""


class Rule:
    """One fault rule plus its mutable firing state (see module docstring)."""

    __slots__ = (
        "index", "point", "kind", "p", "max_fires", "at_hits", "match",
        "duration_s", "signal", "cells", "hits", "fires", "_rng",
    )

    def __init__(self, index: int, seed: int, spec: dict) -> None:
        point = spec.get("point")
        kind = spec.get("kind")
        if not point or kind not in KINDS:
            raise ValueError(
                f"fault rule #{index} needs a 'point' and a 'kind' in {KINDS}: {spec!r}"
            )
        self.index = index
        self.point = point
        self.kind = kind
        self.p = float(spec.get("p", 1.0))
        self.max_fires = spec.get("max_fires")
        self.at_hits = [int(h) for h in spec["at_hits"]] if "at_hits" in spec else None
        self.match = spec.get("match", "")
        self.duration_s = float(spec.get("duration_s", 30.0))
        self.signal = str(spec.get("signal", "TERM")).upper()
        self.cells = int(spec.get("cells", 1))
        self.hits = 0
        self.fires = 0
        # One stream per rule: decisions depend only on (seed, rule
        # identity, hit order), never on other rules' draws or the clock.
        self._rng = random.Random(f"{seed}|{index}|{point}|{kind}")

    def should_fire(self, target: str, consume: bool = True) -> bool:
        """Advance this rule's hit counter and stream for one matching
        invocation and decide whether it fires. With ``consume=False`` (the
        invocation went to an earlier rule) the decision is made the same
        way but the rule's ``max_fires`` budget is not charged."""
        if self.match and self.match not in target:
            return False
        self.hits += 1
        if self.at_hits is not None:
            fire = self.hits in self.at_hits
        else:
            # draw even past max_fires, so the stream stays aligned with a
            # replay under any other interleaving of rules
            fire = self._rng.random() < self.p
        if self.max_fires is not None and self.fires >= int(self.max_fires):
            fire = False
        if fire and consume:
            self.fires += 1
        return fire


class FaultPlan:
    """A seeded set of fault rules; `fire` is the single injection gate."""

    def __init__(self, spec: dict) -> None:
        self.seed = int(spec.get("seed", 0))
        self.rules = [Rule(i, self.seed, r) for i, r in enumerate(spec.get("rules", []))]
        self.firings: list = []  # (point, kind, target, rule, hit, fire) records, in order

    @classmethod
    def parse(cls, text: str) -> "FaultPlan":
        """Parse inline JSON, or read a path to a JSON file."""
        text = text.strip()
        if not text.startswith("{"):
            with open(text) as fh:
                text = fh.read()
        return cls(json.loads(text))

    def fire(self, point: str, target: str = "") -> Optional[Rule]:
        """Evaluate every rule bound to ``point`` against one invocation.

        ``transient`` raises, ``hang`` sleeps and ``preempt`` signals this
        process here; ``nan`` and ``corrupt`` are returned for the site to
        apply. At most one rule acts an invocation (the first that fires,
        in plan order); the later ones still count the hit."""
        acted = None
        for rule in self.rules:
            if rule.point != point:
                continue
            if acted is not None:
                rule.should_fire(target, consume=False)
                continue
            if rule.should_fire(target):
                acted = rule
        if acted is None:
            return None
        record = {
            "point": point,
            "kind": acted.kind,
            "target": target,
            "rule": acted.index,
            "hit": acted.hits,
            "fire": acted.fires,
        }
        self.firings.append(record)
        _emit(**record)
        if acted.kind == "transient":
            raise InjectedFault(
                f"injected transient fault at {point} (rule {acted.index}, target {target!r})"
            )
        if acted.kind == "hang":
            time.sleep(acted.duration_s)
            return None
        if acted.kind == "preempt":
            os.kill(os.getpid(), getattr(_signal, f"SIG{acted.signal}"))
            # delivery is asynchronous: let the handler run before the site
            # goes on
            time.sleep(0.5)
            return None
        return acted  # nan / corrupt: the site applies the damage


def _emit(**fields) -> None:
    """Log one firing as an obs ``fault`` event (a no-op without a run)."""
    try:
        from sbr_tpu_torch.obs import runlog

        runlog.log_fault(**fields)
    except Exception:
        pass  # telemetry must never sink an injection (or its test)


# The process-wide plan, parsed from SBR_FAULT_PLAN on first use.
_PLAN: Optional[FaultPlan] = None
_PARSED = False


def plan() -> Optional[FaultPlan]:
    """The active plan (parsed from ``SBR_FAULT_PLAN`` on first use), or None."""
    global _PLAN, _PARSED
    if not _PARSED:
        _PARSED = True
        text = os.environ.get("SBR_FAULT_PLAN", "").strip()
        if text:
            _PLAN = FaultPlan.parse(text)
    return _PLAN


def install(p: Optional[FaultPlan]) -> None:
    """Install (or clear, with None) the active plan."""
    global _PLAN, _PARSED
    _PLAN = p
    _PARSED = True


def reset() -> None:
    """Forget the active plan so the next `fire` re-reads SBR_FAULT_PLAN."""
    global _PLAN, _PARSED
    _PLAN = None
    _PARSED = False


def fire(point: str, target: str = "") -> Optional[Rule]:
    """The module-level fault point: one check of a module global without
    a plan; with one, `FaultPlan.fire`."""
    p = _PLAN if _PARSED else plan()
    if p is None:
        return None
    return p.fire(point, target)


def corrupt_file(path, rule: Optional[Rule] = None) -> None:
    """Apply a ``corrupt`` injection: truncate ``path`` to half its size (a
    torn write)."""
    size = os.path.getsize(path)
    with open(path, "r+b") as fh:
        fh.truncate(max(size // 2, 1))
