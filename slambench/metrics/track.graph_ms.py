"""Device time of the tracked frame's CUDA graph: CUDA events around each
``FusedGraph.run`` replay (its input copies, the replay, the output
clones) on the tracker's stream, the mean over the window's replays."""


def read(r):
    ms = r.get("graph_ms") or []
    return sum(ms) / len(ms) if ms else None
