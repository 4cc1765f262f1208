"""Crash-surfacing background threads.

``spawn`` is the one way the port starts a background thread (the HTTP
servers, the file loop, the events logger, the metrics poller).  A bare
Python daemon thread dies silently and the control plane limps on without
it; ``spawn`` wraps the target so an escaping exception is logged with its
traceback and counted on /metrics (``thread_crashes_total``, through the
``CRASH_COUNTERS`` provider) before the thread exits.
"""
from __future__ import annotations

import logging
import threading
from typing import Callable, Dict, Optional

log = logging.getLogger("infw_torch.threads")

_crash_lock = threading.Lock()
_crash_total = 0


def _note_crash() -> None:
    global _crash_total
    with _crash_lock:
        _crash_total += 1


class _CrashCounters:
    """Counter provider for the metrics registry
    (obs.statistics.Registry.register_counters): background-thread crashes
    since process start, zero in a healthy control plane."""

    def counter_values(self) -> Dict[str, int]:
        with _crash_lock:
            return {"thread_crashes_total": _crash_total}


CRASH_COUNTERS = _CrashCounters()


def reset_crash_counters() -> None:
    """Zero the process-wide crash counters (tests)."""
    global _crash_total
    with _crash_lock:
        _crash_total = 0


def spawn(target: Callable, *, name: Optional[str] = None,
          args: tuple = (), kwargs: Optional[dict] = None,
          daemon: bool = True, start: bool = True) -> threading.Thread:
    """Start (or build, with ``start=False``) a crash-surfacing background
    thread.  An exception escaping ``target`` is logged with its traceback,
    counted, and re-raised so the interpreter's threading excepthook still
    fires."""
    kwargs = kwargs or {}
    tname = name or getattr(target, "__name__", "infw-thread")

    def _run() -> None:
        try:
            target(*args, **kwargs)
        except BaseException as e:  # noqa: BLE001 - surfacing, not hiding
            _note_crash()
            log.exception("background thread %r crashed: %s", tname, e)
            raise

    t = threading.Thread(target=_run, name=tname, daemon=daemon)
    if start:
        t.start()
    return t
