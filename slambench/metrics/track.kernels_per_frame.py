"""Device kernels per frame in the profiled slice (copies and sets not
counted): the tracked frame's graph, and the mapping steps pumped in the
slice's frames."""


def read(r):
    s = r.get("slice")
    return s["kernels"] / s["frames"] if s else None
