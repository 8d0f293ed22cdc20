"""The whole device step's share of the card's bfloat16 peak: the model's
operations for the useful rows scored in the profiled slice (BatcherStats
candidates over the slice times the model's operations per row, from
ctrbench/flops) over the summed span of every device step (a batch's first
kernel start to its last kernel end, from the device trace)."""

import importlib.util
import pathlib

_p = pathlib.Path(__file__).resolve().parents[1] / "harness" / "peaks.py"
_s = importlib.util.spec_from_file_location("ctrbench_peaks", _p)
peaks = importlib.util.module_from_spec(_s)
_s.loader.exec_module(peaks)


def read(ctx):
    tr = ctx.trace
    pk = peaks.peak(ctx.device_name)
    if tr is None or pk is None or not tr.steps or not tr.stats:
        return None
    span = sum(s.span_s for s in tr.steps)
    rows = tr.stats.get("candidates", 0)
    if span <= 0 or rows <= 0:
        return None
    ops = rows * ctx.flops().flops_per_row(ctx.model)
    return 100.0 * ops / span / pk["bfloat16_flops"]
