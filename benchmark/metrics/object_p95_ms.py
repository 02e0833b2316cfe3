"""object_p95_ms: 95th percentile of every object's latency in the window,
from the call to its return (host clock), numpy's linear interpolation."""

import numpy as np


def read(ctx):
    lat = ctx.get("latencies")
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat), 95)) * 1e3
