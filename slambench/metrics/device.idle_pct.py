"""Share of the profiled slice in which no kernel, copy or set ran on the
device, in %."""


def read(r):
    s = r.get("slice")
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"]) if s else None
