"""In-library observability: counters, spans, rate-limited warnings.

The port's own copy of ``refactored_orb_slam2_tpu/utils/telemetry.py`` (the
port imports nothing of the JAX package); it logs under the port's name.

The reference has no in-library metrics (SURVEY §5 — cout prints only, plus
the viewer's status text).  This module is the array-native build's
replacement: cheap host-side counters the orchestrator bumps at decision
points (capacity pressure, tracking losses, loop events, host reads of
device values), per-stage wall timers, and warn-once logging so silent
behaviors (map caps, dropped observations) become visible without flooding
stdout.

A ``timer`` is a span.  It always adds to a running aggregate per name
(count, total, max: ``snapshot``).  While ``tracing(True)`` is on, each
span also leaves a record (``spans``): its name, start and end in
``time.time_ns()`` (the clock ``torch.profiler`` stamps its host events
with, so that records and a profiler trace line up by time), the span open
on the same thread when it began (its parent), a key that the spans of one
request share (a frame id, a keyframe's frame id; a span with no key takes
its parent's), the thread's name, and the counters bumped while it was the
innermost open span on its thread.

No device interaction.  With tracing off a span costs one aggregate update.
"""

from __future__ import annotations

import collections
import itertools
import logging
import threading
import time

_log = logging.getLogger("refactored_orb_slam2_tpu_torch")

_lock = threading.Lock()
_counters: collections.Counter = collections.Counter()
_timers: dict[str, list] = {}        # name -> [count, total s, max s]
_warned: dict[str, int] = {}

#: re-emit a given warning key at most every N occurrences
WARN_EVERY = 100
#: span records kept while tracing (the oldest go first)
MAX_SPANS = 200_000

_tracing = False
_records: collections.deque = collections.deque(maxlen=MAX_SPANS)
_ids = itertools.count()
_open = threading.local()            # .stack: this thread's open traced spans


def _stack() -> list:
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    return stack


def inc(name: str, by: int = 1) -> None:
    with _lock:
        _counters[name] += by
    if _tracing:
        stack = _stack()
        if stack:
            counts = stack[-1].counts
            counts[name] = counts.get(name, 0) + by


def get(name: str) -> int:
    with _lock:
        return _counters.get(name, 0)


def warned_keys() -> list:
    """Keys that have warned at least once (capacity audits in benches)."""
    with _lock:
        return sorted(_warned)


def warn(key: str, message: str) -> None:
    """Log ``message`` on the first occurrence of ``key`` and then every
    WARN_EVERY-th occurrence (so per-frame cap hits don't flood)."""
    with _lock:
        n = _warned.get(key, 0)
        _warned[key] = n + 1
        _counters[f"warn.{key}"] += 1
    if n % WARN_EVERY == 0:
        suffix = f" (x{n + 1})" if n else ""
        _log.warning("%s%s", message, suffix)


def tracing(on: bool) -> None:
    """Keep a record of every span closed from now on (``spans``), or stop."""
    global _tracing
    _tracing = bool(on)


def spans() -> list:
    """The span records kept since the last call, oldest closed first, and
    forget them.  Each is a dict: ``id``, ``name``, ``start_ns``,
    ``end_ns``, ``parent`` (the id of the span open on the same thread when
    this one began, or None), ``key``, ``thread`` and ``counts`` (counter
    name -> amount)."""
    with _lock:
        out = list(_records)
        _records.clear()
    return out


class timer:
    """Context manager: a span named ``name`` (see the module's docstring);
    ``key`` defaults to the enclosing span's."""

    __slots__ = ("name", "key", "t0", "rec", "counts")

    def __init__(self, name: str, key=None):
        self.name = name
        self.key = key
        self.rec = None

    def __enter__(self):
        if _tracing:
            stack = _stack()
            parent = stack[-1] if stack else None
            if self.key is None and parent is not None:
                self.key = parent.key
            self.counts = {}
            self.rec = dict(id=next(_ids), name=self.name, start_ns=time.time_ns(),
                            end_ns=None, parent=None if parent is None else parent.rec["id"],
                            key=self.key, thread=threading.current_thread().name,
                            counts=self.counts)
            stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        rec = self.rec
        if rec is not None:
            rec["end_ns"] = time.time_ns()
            _stack().remove(self)
            self.rec = None
        with _lock:
            agg = _timers.get(self.name)
            if agg is None:
                _timers[self.name] = [1, dt, dt]
            else:
                agg[0] += 1
                agg[1] += dt
                if dt > agg[2]:
                    agg[2] = dt
            if rec is not None:
                _records.append(rec)
        return False


def snapshot() -> dict:
    """Copy of all counters and timer stats (count / total / mean / max s)."""
    with _lock:
        out = {"counters": dict(_counters), "timers": {}}
        for name, (count, total, peak) in _timers.items():
            out["timers"][name] = {
                "count": count,
                "total_s": total,
                "mean_s": total / count,
                "max_s": peak,
            }
    return out


def reset() -> None:
    with _lock:
        _counters.clear()
        _timers.clear()
        _warned.clear()
        _records.clear()
