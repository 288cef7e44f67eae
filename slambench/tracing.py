"""Reading a ``torch.profiler`` slice of the window: the device's busy and
idle time, its kernels by name, the matchers' launches in order, and what
the host was doing while the device was idle.

The slice's frames run inside ``record_function(FRAME)`` spans, and the
harness's own spans (``slambench.*``) mark the port's layers around them;
the window is the first frame span's start to the last one's end, on the
profiler's clock, which the device events share.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

FRAME = "slambench.frame"
#: profiler names of the hand-written matchers' kernels
KERNELS = {"window_match": "window_match_kernel", "hamming_best2": "masked_best2_kernel"}
#: gaps longer than this many microseconds are named by what the host did
_NAMED_GAP_US = 20.0
_MAX_NAMED = 400


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def read_slice(prof) -> dict:
    """What the slice shows (seconds, counts); None where the profiler
    recorded no device event inside the window."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        rec = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
        if e.device_type() != DeviceType.CUDA:
            host.append(rec)
        elif not (e.is_user_annotation() or rec[0].startswith("slambench.")):
            dev.append(rec)             # a span's device-side copy is no work
    frames = [h for h in host if h[0] == FRAME]
    if not frames:
        return None
    t0, t1 = min(f[1] for f in frames), max(f[2] for f in frames)
    dev = sorted((d for d in dev if d[2] > t0 and d[1] < t1), key=lambda d: d[1])
    if not dev:
        return None

    # busy: the union of every kernel, copy and set, clipped to the window
    starts = np.clip(np.array([d[1] for d in dev], np.int64), t0, t1)
    ends = np.clip(np.array([d[2] for d in dev], np.int64), t0, t1)
    reach = np.maximum.accumulate(ends)
    gap_start = np.r_[t0, reach[:-1]]
    gaps = np.maximum(starts - gap_start, 0)
    tail = max(t1 - int(reach[-1]), 0)
    idle_ns = int(gaps.sum()) + tail
    busy_ns = (t1 - t0) - idle_ns

    by_name = defaultdict(float)
    launches = defaultdict(list)
    n_kernels = 0
    for name, s, e in dev:
        by_name[name[:120]] += (e - s) * 1e-9
        if not _is_copy(name):
            n_kernels += 1
        for key, needle in KERNELS.items():
            if needle in name:
                launches[key].append((e - s) * 1e-9)

    return dict(
        busy_s=busy_ns * 1e-9, window_s=(t1 - t0) * 1e-9, frames=len(frames),
        kernels=n_kernels, launches=dict(launches),
        device_ops=sorted(([k, v] for k, v in by_name.items()), key=lambda kv: -kv[1])[:10],
        idle_gaps=_name_gaps(host, gap_start, starts, gaps, t1, tail),
    )


def _name_gaps(host, gap_start, starts, gaps, t1, tail) -> list:
    """The longest idle gaps, summed by what the host was doing at each
    gap's middle: the innermost harness span and the innermost other host
    event there (an operator, a runtime call)."""
    spans = [(s, e, n) for n, s, e in host if n.startswith("slambench.") and n != FRAME]
    other = [(s, e, n) for n, s, e in host if not n.startswith("slambench.")]
    pairs = [(int(g), int(a), int(b)) for g, a, b in zip(gaps, gap_start, starts)]
    if tail:
        pairs.append((tail, t1 - tail, t1))
    pairs = sorted((p for p in pairs if p[0] > _NAMED_GAP_US * 1e3), reverse=True)[:_MAX_NAMED]
    arrays = {k: (np.array([x[0] for x in v] or [0], np.int64),
                  np.array([x[1] for x in v] or [-1], np.int64), v)
              for k, v in (("span", spans), ("op", other))}

    def innermost(kind, t):
        s, e, rows = arrays[kind]
        inside = np.flatnonzero((s <= t) & (e >= t))
        if not len(inside) or not rows:
            return None
        return rows[inside[np.argmax(s[inside])]][2]

    totals, counts = defaultdict(float), defaultdict(int)
    for g, a, b in pairs:
        mid = (a + b) // 2
        span = innermost("span", mid) or "between frames"
        op = innermost("op", mid) or "no host event"
        label = f"{span.removeprefix('slambench.')} > {op[:60]}"
        totals[label] += g * 1e-9
        counts[label] += 1
    named = sorted(totals.items(), key=lambda kv: -kv[1])[:10]
    return [[f"{label} ({counts[label]} gaps)", secs] for label, secs in named]
