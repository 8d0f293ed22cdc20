"""DLRM's interaction kernel's share of its roofline: for each call in the
profiled slice, the least time the card could take for the rows it was
given (the larger of its bytes / HBM bandwidth and its operations / the
bfloat16 peak, from ctrbench/flops/dlrm_interact.py), summed, over the
kernel's summed time by name in the device trace. A call's rows are its
batch's bucket, read from the batch's single host-to-device copy (bytes /
the int32-id wire's bytes per row, which must land on a bucket of the
ladder). The trace does not say which of a call's rows are padding, so
each call is taken to hold the slice's share of requests' rows
(candidates / padded candidates of the program's counters over the
slice); padding rows count no table bytes (flops/dlrm_interact.py). A
program without the kernel reports nothing."""

import importlib.util
import pathlib

_BENCH = pathlib.Path(__file__).resolve().parents[1]


def _load(path: pathlib.Path, name: str):
    s = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


peaks = _load(_BENCH / "harness" / "peaks.py", "ctrbench_peaks")
flops = _load(_BENCH / "flops" / "dlrm_interact.py", "ctrbench_flops_dlrm_interact")

KERNEL = "dlrm_interact_bf16_kernel"


def read(ctx):
    tr = ctx.trace
    pk = peaks.peak(ctx.device_name)
    if tr is None or pk is None:
        return None
    st = tr.stats or {}
    if not st.get("padded_candidates"):
        return None
    share = st.get("candidates", 0) / st["padded_candidates"]
    ladder = ctx.cell.config["server"]["buckets"]
    per_row = flops.wire_bytes_per_row(ctx.model)
    bound = spent = 0.0
    for step in tr.steps:
        calls = [t for name, t in step.kernels if KERNEL in name]
        if not calls:
            continue
        rows = step.h2d_bytes / per_row
        if rows not in ladder:
            return None  # the copy is not one bucket's batch: no reading
        ops, nbytes = flops.interact_cost(ctx.model, int(rows), real=rows * share)
        bound += max(nbytes / pk["hbm_bytes_per_s"], ops / pk["bfloat16_flops"]) * len(calls)
        spent += sum(calls)
    return 100.0 * bound / spent if spent > 0 else None
