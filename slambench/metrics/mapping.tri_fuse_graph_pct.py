"""Share of local mapping's triangulated neighbours and fuse calls that ran
as CUDA graph replays: the change of the port's
``mapping.tri_fuse_graph_replays`` counter over the traced window, in
percent of that and of ``mapping.tri_fuse_eager_calls``."""


def read(r):
    counters = r.get("counters") or {}
    replays = counters.get("mapping.tri_fuse_graph_replays", 0)
    calls = replays + counters.get("mapping.tri_fuse_eager_calls", 0)
    return 100.0 * replays / calls if calls else None
