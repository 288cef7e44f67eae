"""Host time of a keyframe's mapping (local mapping and loop detection,
the steps ``_pump_mapping`` runs), each step timed with the stream
synchronized before and after; the mean over the keyframes whose steps
all ran outside the profiled slice."""


def read(r):
    s = r.get("mapped_s") or []
    return sum(s) / len(s) * 1e3 if s else None
