"""Share of the local BA's LM chunks that ran as a CUDA graph replay: the
change of the port's ``mapping.ba_graph_replays`` counter over the traced
window, in percent of that and of ``mapping.ba_eager_chunks``."""


def read(r):
    counters = r.get("counters") or {}
    replays = counters.get("mapping.ba_graph_replays", 0)
    chunks = replays + counters.get("mapping.ba_eager_chunks", 0)
    return 100.0 * replays / chunks if chunks else None
