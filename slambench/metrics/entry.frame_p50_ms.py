"""The median frame time of the traced window, in ms: every frame's time
as an untraced run's ``frame_p50_ms`` takes it (``harness.window_metrics``),
the profiled slice's frames among them.  For a cell whose median on the
host clock spreads too widely between runs to hold an end-to-end bound."""

import numpy as np


def read(r):
    t = r.get("frame_s")
    return float(np.percentile(t, 50)) * 1e3 if t else None
