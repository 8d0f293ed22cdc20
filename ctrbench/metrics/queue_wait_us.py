"""Mean microseconds a request waited in the batcher, from its enqueue to
the start of its batch's device stage (the program's `batch.queue_wait`
interval), from the batcher's per-request timeline over the window."""

import numpy as np


def read(ctx):
    tl = ctx.timeline
    if not tl:
        return None
    t = np.asarray(tl, dtype=np.float64)
    return float(np.mean(t[:, 2] - t[:, 0]) * 1e6)
