"""Median Predict latency over every request of the window, by the client's
clock (open loop: from when the request was due)."""

import numpy as np


def read(ctx):
    lat = ctx.load["latency_s"]
    return float(np.percentile(lat, 50) * 1e3) if len(lat) else None
