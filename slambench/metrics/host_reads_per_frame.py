"""Host reads of device values per frame of the window: the change of the
port's ``host_reads`` counter over the traced window, over the frames fed
in it."""


def read(r):
    frames = len(r.get("frame_stamps") or [])
    counters = r.get("counters")
    if not frames or counters is None:
        return None
    return counters.get("host_reads", 0) / frames
