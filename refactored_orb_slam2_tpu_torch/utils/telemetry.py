"""In-library observability: counters, per-stage timers, rate-limited warnings.

The port's own copy of ``refactored_orb_slam2_tpu/utils/telemetry.py`` (the
port imports nothing of the JAX package); it logs under the port's name.

The reference has no in-library metrics (SURVEY §5 — cout prints only, plus
the viewer's status text).  This module is the array-native build's
replacement: cheap host-side counters the orchestrator bumps at decision
points (capacity pressure, tracking losses, loop events), per-stage wall
timers, and warn-once logging so silent behaviors (map caps, dropped
observations) become visible without flooding stdout.

Zero overhead when unused; no device interaction.
"""

from __future__ import annotations

import collections
import logging
import threading
import time

_log = logging.getLogger("refactored_orb_slam2_tpu_torch")

_lock = threading.Lock()
_counters: collections.Counter = collections.Counter()
_timers: dict[str, list[float]] = collections.defaultdict(list)
_warned: dict[str, int] = {}

#: re-emit a given warning key at most every N occurrences
WARN_EVERY = 100


def inc(name: str, by: int = 1) -> None:
    with _lock:
        _counters[name] += by


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


class timer:
    """Context manager recording a wall-time sample under ``name``."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        with _lock:
            _timers[self.name].append(dt)
        return False


def snapshot() -> dict:
    """Copy of all counters and timer stats (count / total / mean / max s)."""
    with _lock:
        out = {"counters": dict(_counters), "timers": {}}
        for name, samples in _timers.items():
            if samples:
                out["timers"][name] = {
                    "count": len(samples),
                    "total_s": sum(samples),
                    "mean_s": sum(samples) / len(samples),
                    "max_s": max(samples),
                }
    return out


def reset() -> None:
    with _lock:
        _counters.clear()
        _timers.clear()
        _warned.clear()
