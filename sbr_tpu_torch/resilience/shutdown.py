"""Graceful shutdown: SIGTERM/SIGINT during a sweep removes partially
written files and hands back held coordination files before exit; the
port of ``sbr_tpu.resilience.shutdown``.

Inside a `graceful_shutdown` block:

- SIGTERM / SIGINT raise `Interrupted` at the next bytecode, which unwinds
  the sweep loop (an atomic save's temp file is removed by its own
  ``except BaseException`` on the way out);
- any temp file still registered through `track_tmp` is removed;
- any held coordination file registered through `release_on_exit` (tile
  leases, the elastic scheduler's heartbeat) is removed, so peers reclaim
  the work at their next poll instead of waiting out its TTL;
- the process exits through ``SystemExit(128 + signum)`` for SIGTERM, or
  re-raises ``KeyboardInterrupt`` for SIGINT.

Handlers install only in the main thread and only over the default
dispositions (an embedder's own handlers are kept), are restored when the
block exits, and nest: the outermost block owns them, so `run_tiled_grid`
installs unconditionally even when called from the elastic scheduler or a
server.

The reference also finalizes every active obs run as ``"interrupted"``;
that waits for the port's run log (ROADMAP 1.A item 9).
"""

from __future__ import annotations

import contextlib
import os
import signal
import threading
from typing import Optional


class Interrupted(BaseException):
    """Raised by the signal handler. A BaseException, so ``except
    Exception`` recovery code (tile retry) cannot swallow a shutdown."""

    def __init__(self, signum: int) -> None:
        super().__init__(f"interrupted by signal {signum}")
        self.signum = signum


# Temp files being written by atomic-save helpers; a shutdown removes
# whatever is still registered (see utils.checkpoint._save_atomic).
_TMP_REGISTRY: set = set()
# Coordination files this process holds and hands back on shutdown: tile
# leases and the elastic scheduler's heartbeat.
_RELEASE_REGISTRY: set = set()
_DEPTH = 0  # only the outermost graceful_shutdown owns the handlers


@contextlib.contextmanager
def track_tmp(path):
    """Register ``path`` as an in-flight partial write for the duration."""
    _TMP_REGISTRY.add(str(path))
    try:
        yield
    finally:
        _TMP_REGISTRY.discard(str(path))


def release_on_exit(path) -> None:
    """Register a held coordination file (lease, heartbeat) for removal when
    a graceful shutdown unwinds this process."""
    _RELEASE_REGISTRY.add(str(path))


def unregister_release(path) -> None:
    """The file was handed back normally; shutdown no longer owns it."""
    _RELEASE_REGISTRY.discard(str(path))


def _remove_all(registry: set) -> list:
    removed = []
    for p in sorted(registry):
        try:
            os.remove(p)
            removed.append(p)
        except OSError:
            pass
    registry.clear()
    return removed


@contextlib.contextmanager
def graceful_shutdown(label: str = "run"):
    """Turn SIGTERM/SIGINT into a clean exit (see the module docstring).
    A plain pass-through off the main thread and when nested. ``label`` is
    the reference's obs label, unused until obs is ported."""
    global _DEPTH
    if threading.current_thread() is not threading.main_thread():
        yield  # CPython installs handlers in the main thread only
        return
    if _DEPTH > 0:
        _DEPTH += 1
        try:
            yield
        finally:
            _DEPTH -= 1
        return

    def handler(signum, frame):
        raise Interrupted(signum)

    previous = {}
    for sig, default in (
        (signal.SIGTERM, signal.SIG_DFL),
        (signal.SIGINT, signal.default_int_handler),
    ):
        if signal.getsignal(sig) == default:  # keep an embedder's handlers
            previous[sig] = default
            signal.signal(sig, handler)

    _DEPTH = 1
    try:
        yield
    except Interrupted as itr:
        _remove_all(_TMP_REGISTRY)
        _remove_all(_RELEASE_REGISTRY)
        if itr.signum == signal.SIGINT:
            raise KeyboardInterrupt from itr
        raise SystemExit(128 + itr.signum) from itr
    finally:
        _DEPTH -= 1
        for sig, prev in previous.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass


def interrupted_status() -> Optional[str]:
    """The registries' sizes and the nesting depth (a debugging aid)."""
    return (
        f"tracked_tmp={len(_TMP_REGISTRY)} "
        f"held_releases={len(_RELEASE_REGISTRY)} depth={_DEPTH}"
    )
