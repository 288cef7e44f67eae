"""Two-view solves a monocular pass runs before its initializer accepts a
pair: the change of the port's ``init.attempts`` counter over the traced
window, over the change of ``init.accepted``."""


def read(r):
    counters = r.get("counters") or {}
    accepted = counters.get("init.accepted", 0)
    return counters.get("init.attempts", 0) / accepted if accepted else None
