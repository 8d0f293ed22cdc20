"""95th percentile of Predict latency over every request of the traced
run's window (all samples together, by the client's clock; open loop: from
when the request was due). A per-layer reading: its run-to-run spread is too
wide for an end-to-end bound (PERF.md), and the profiled slice runs inside
this window."""

import numpy as np


def read(ctx):
    lat = ctx.load["latency_s"]
    return float(np.percentile(lat, 95) * 1e3) if len(lat) else None
