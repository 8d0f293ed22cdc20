"""The fused serve kernel's share of its roofline: for each call in the
profiled slice, the least time the card could take for the rows it was
given (the larger of its bytes / HBM bandwidth and its operations / the
bfloat16 peak, from ctrbench/flops), summed, over the kernel's summed time
by name in the device trace. A call's rows are its batch's bucket, read from
the batch's single host-to-device copy (bytes / wire bytes per row, which
must land on a bucket of the ladder)."""

import importlib.util
import pathlib

_p = pathlib.Path(__file__).resolve().parents[1] / "harness" / "peaks.py"
_s = importlib.util.spec_from_file_location("ctrbench_peaks", _p)
peaks = importlib.util.module_from_spec(_s)
_s.loader.exec_module(peaks)

KERNEL = "fused_serve_bf16_kernel"


def read(ctx):
    tr = ctx.trace
    pk = peaks.peak(ctx.device_name)
    fl = ctx.flops()
    if tr is None or pk is None or not hasattr(fl, "fused_serve_cost"):
        return None
    ladder = ctx.cell.config["server"]["buckets"]
    per_row = fl.wire_bytes_per_row(ctx.model)
    bound = spent = 0.0
    for step in tr.steps:
        calls = [t for name, t in step.kernels if KERNEL in name]
        if not calls:
            continue
        rows = step.h2d_bytes / per_row
        if rows not in ladder:
            return None  # the copy is not one bucket's batch: no reading
        ops, nbytes = fl.fused_serve_cost(ctx.model, int(rows))
        bound += max(nbytes / pk["hbm_bytes_per_s"], ops / pk["bfloat16_flops"]) * len(calls)
        spent += sum(calls)
    return 100.0 * bound / spent if spent > 0 else None
