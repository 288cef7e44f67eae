"""Host time of a monocular pass's initialization, in ms: the times of the
frames whose ``init`` span ran a two-view solve (the port's
``init.attempts`` counter, counted in that span), summed, over the passes
whose initializer accepted a pair in the window (the change of
``init.accepted``).  A frame's time runs from its call until it returns
with the caller's stream synchronized (``frame_stamps``), so the initial
BA's device time is inside; a pass's first frame, which only keeps the
reference frame and carries ``reset()``, is not."""


def read(r):
    accepted = (r.get("counters") or {}).get("init.accepted", 0)
    if not accepted:
        return None
    solved = {s["key"] for s in r.get("spans") or []
              if s["name"] == "init" and s["counts"].get("init.attempts")}
    ns = sum(t1 - t0 for frame, t0, t1 in r.get("frame_stamps") or [] if frame in solved)
    return ns / accepted * 1e-6
