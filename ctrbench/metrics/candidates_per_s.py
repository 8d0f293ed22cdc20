"""Candidates scored over the window: every candidate of each well-formed
answer that came back inside the window, over the window's seconds."""

import numpy as np


def read(ctx):
    n = ctx.load["n"][ctx.load["done_in_window"]]
    return float(np.sum(n) / ctx.seconds) if len(n) else None
