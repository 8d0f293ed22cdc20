"""The program's per-request span plane over a traced run's profiled slice.

The plane (distributed_tf_serving_tpu_torch/utils/tracing.py) records, per
request, each phase's interval, the thread that ran it and that thread's CPU
seconds over it; the batcher's queue wait and its two parts (until the
batching thread collected the request, then until the device stage); and,
per thread role, the process's CPU seconds so far. This module turns it on
for the profiled slice and reads it:

- five readings of the slice (READINGS): decode's CPU time, the two queue
  waits, the dispatch thread's share of its stage spent off the CPU, and
  the cores' worth of Python that ran;
- the program's work spans (a thread and a CPU reading: not waits, not
  roots), placed on the device trace's clock through the program's
  `clock_anchor()` and the trace's `baseTimeNanoseconds`, join the host
  events only after the slice's bounds, device events and steps are fixed,
  so they change nothing but the idle gaps' labels;
- the clock's offset, from a `record_function` marker opened between two
  reads of the program's clock at each end of the slice.

`run.py` does not turn the plane on; `python3 ctrbench/spans.py --workload
<cell> --seed <n> --seconds <s>` runs run.py's run with it (main below).
Against a program whose spans carry no thread or CPU reading, or that has no
`thread_cpu()`, the readings are None and the labels are run.py's.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
import types

from . import devtrace, spec

CLOCK_MARK = "ctrbench.clock"
MARKS = 25  # clock markers at each end of the slice
BUFFER = 1 << 16  # roots the recorder keeps: every root of a slice or window


@dataclasses.dataclass
class Slice:
    spans: list  # every span of the roots that opened and closed inside, flattened
    clock: dict  # the program's clock_anchor() (perf_us, unix_us)
    thread_cpu: dict | None  # CPU seconds per thread role over the slice, and "process"
    seconds: float  # the slice's length on the host clock


def flatten(roots: list[dict]) -> list[dict]:
    """Span trees (Span.to_dict) as one list, without children; a root
    has `root` true."""
    out: list[dict] = []

    def walk(node: dict, root: bool) -> None:
        out.append({**{k: v for k, v in node.items() if k != "children"}, "root": root})
        for child in node.get("children", ()):
            walk(child, False)

    for r in roots:
        walk(r, True)
    return out


class Plane:
    """The program's span plane and thread CPU counter from start() to
    stop(); collect() after the slice's requests have finished."""

    def __init__(self, count_cpu: bool = True):
        from distributed_tf_serving_tpu_torch.utils import tracing

        self._tracing = tracing
        self._cpu = getattr(tracing, "thread_cpu", None) if count_cpu else None
        self._rec = None
        self._cpu0 = self._cpu1 = None
        self._t0 = self._t1 = 0.0

    def start(self) -> None:
        self._rec = self._tracing.enable(buffer_size=BUFFER, sample_rate=1.0, slowest_n=0)
        self._cpu0 = self._cpu() if self._cpu else None
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if not self._tracing.enabled():
            return
        self._t1 = time.perf_counter()
        self._cpu1 = self._cpu() if self._cpu else None
        self._tracing.disable()

    def collect(self) -> Slice:
        export = self._rec.export_since(0, limit=BUFFER)
        lo, hi = self._t0 * 1e6, self._t1 * 1e6
        roots = [r for r in export["spans"]
                 if lo <= r["start_us"] and r["start_us"] + r["duration_us"] <= hi]
        cpu = None
        if self._cpu0 is not None:
            cpu = {k: self._cpu1[k] - self._cpu0[k] for k in self._cpu1}
        return Slice(spans=flatten(roots), clock=export["clock"], thread_cpu=cpu,
                     seconds=self._t1 - self._t0)


def trace_shift_us(clock: dict, doc: dict) -> float:
    """What to add to a program time (perf_counter µs) to place it on a
    torch.profiler Chrome trace's clock."""
    base_ns = int(doc.get("baseTimeNanoseconds", 0)) if isinstance(doc, dict) else 0
    return clock["unix_us"] - clock["perf_us"] - base_ns / 1e3


def work_events(spans: list[dict], shift_us: float) -> list[dict]:
    """The program's work spans as Chrome `user_annotation` events on
    their own threads, each batch phase once however many members carry
    it."""
    seen = set()
    out = []
    for s in spans:
        if s["root"] or s.get("wait") or "cpu_us" not in s:
            continue
        key = (s.get("tid"), s["name"], s["start_us"])
        if key in seen:
            continue
        seen.add(key)
        out.append({"ph": "X", "cat": "user_annotation", "name": s["name"], "pid": "program",
                    "tid": s.get("tid"), "ts": s["start_us"] + shift_us,
                    "dur": s["duration_us"]})
    return out


def mark(n: int = 1) -> list[tuple[float, float]]:
    """`n` CLOCK_MARK markers, each between two reads of the program's
    clock. Several: under load another thread may take the GIL between
    the reads, and the narrowest interval bounds the offset best."""
    import torch

    out = []
    for _ in range(n):
        a = time.perf_counter()
        with torch.profiler.record_function(CLOCK_MARK):
            pass
        out.append((a, time.perf_counter()))
    return out


def clock_offsets_us(events: list[dict], marks: list[tuple[float, float]],
                     shift_us: float) -> list[tuple[float, float]]:
    """Per marker: (where the trace put it - where the program's clock
    mapped through shift_us puts it, ± half the interval it lies in), µs."""
    found = sorted((float(e["ts"]), float(e.get("dur", 0.0))) for e in events
                   if e.get("name") == CLOCK_MARK and e.get("ph") == "X")
    out = []
    for (ts, dur), (a, b) in zip(found, sorted(marks)):
        mid = (a + b) / 2 * 1e6 + shift_us
        out.append((ts + dur / 2 - mid, (b - a) / 2 * 1e6))
    return out


def tightest(offsets: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """The narrowest of each half of clock_offsets_us: the markers at the
    slice's start, then those at its end."""
    k = len(offsets) // 2
    return [min(half, key=lambda o: o[1]) for half in (offsets[:k], offsets[k:]) if half]


def profile_slice(length_s: float, snapshot, holder: dict):
    """devtrace.profile_slice with the plane on for the slice: the same
    (reduction, why not), its gaps labelled with the program's spans too;
    the plane's Slice and the clock offsets go into `holder` even where the
    trace has no device operation."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    plane = Plane()
    try:
        before = snapshot()
        cuda = torch.cuda.is_available()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA] if cuda
                     else [ProfilerActivity.CPU]) as prof:
            if cuda:
                torch.cuda.synchronize()
            plane.start()
            marks = mark(MARKS)
            mark0 = time.perf_counter()
            time.sleep(length_s)
            if cuda:
                torch.cuda.synchronize()
            mark1 = time.perf_counter()
            marks += mark(MARKS)
            plane.stop()
        after = snapshot()
        fd, path = tempfile.mkstemp(prefix="ctrbench-trace-", suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                doc = json.load(f)
        finally:
            os.unlink(path)
        events = doc.get("traceEvents", doc if isinstance(doc, list) else [])
        sl = plane.collect()
        shift = trace_shift_us(sl.clock, doc)
        holder["slice"] = sl
        holder["clock_offsets_us"] = tightest(clock_offsets_us(events, marks, shift))
        # The markers are this module's: run.py's trace has none.
        events = [e for e in events if e.get("name") != CLOCK_MARK]
        if not any(e.get("ph") == "X" and e.get("cat") in devtrace._DEVICE_CATS for e in events):
            return None, "the profiler recorded no device operation"
        # The slice, exactly as devtrace.profile_slice takes it.
        spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                 for e in events if e.get("ph") == "X" and "dur" in e]
        t0 = min(a for a, _ in spans)
        t1 = min(max(b for _, b in spans), t0 + (mark1 - mark0) * 1e6)
        reduced = devtrace.reduce_events(events, t0, t1)
        work = work_events(sl.spans, shift)
        reduced.gaps = devtrace.reduce_events(events + work, t0, t1).gaps
        holder["idle_split_s"] = idle_split(events, work, t0, t1)
        reduced.stats = {k: v - before.get(k, 0) for k, v in after.items()
                         if isinstance(v, (int, float))}
        return reduced, None
    except Exception as exc:  # noqa: BLE001 — reported; the run then has no trace metrics
        return None, f"{type(exc).__name__}: {exc}"
    finally:
        plane.stop()


def idle_split(events: list[dict], work: list[dict], t0: float, t1: float) -> dict:
    """Seconds of every idle gap between device operations in [t0, t1],
    by the shortest program work span over the gap's middle (as the gap
    labels take it), or "none"."""
    dev = sorted((max(float(e["ts"]), t0), min(float(e["ts"]) + float(e["dur"]), t1))
                 for e in events if e.get("ph") == "X" and "dur" in e
                 and e.get("cat") in devtrace._DEVICE_CATS
                 and float(e["ts"]) + float(e["dur"]) >= t0 and float(e["ts"]) <= t1)
    spans = [(w["ts"], w["ts"] + w["dur"], w["name"]) for w in work]
    out: dict[str, float] = {}
    reach = t0
    for a, b in dev:
        if a > reach:
            mid = (reach + a) / 2
            over = [sp for sp in spans if sp[0] <= mid <= sp[1]]
            name = min(over, key=lambda sp: sp[1] - sp[0])[2] if over else "none"
            out[name] = out.get(name, 0.0) + (a - reach) / 1e6
        reach = max(reach, b)
    return out


# ---------------------------------------------------------------- readings


def _named(sl: Slice, name: str) -> list[dict]:
    return [s for s in sl.spans if s["name"] == name]


def _mean(xs: list) -> float | None:
    return sum(xs) / len(xs) if xs else None


def decode_cpu_us(sl: Slice) -> float | None:
    """Mean thread CPU µs of the slice's `predict.decode` spans."""
    return _mean([s["cpu_us"] for s in _named(sl, "predict.decode") if "cpu_us" in s])


def collect_wait_us(sl: Slice) -> float | None:
    """Mean µs from a request's enqueue until the batching thread
    collected it (`batch.collect_wait`)."""
    return _mean([s["duration_us"] for s in _named(sl, "batch.collect_wait")])


def stage_wait_us(sl: Slice) -> float | None:
    """Mean µs from collection until the batch's device stage started
    (`batch.stage_wait`): behind pipeline_depth and the in-flight window."""
    return _mean([s["duration_us"] for s in _named(sl, "batch.stage_wait")])


def dispatch_offcpu_frac(sl: Slice) -> float | None:
    """1 - Σ CPU / Σ wall of the slice's `batch.dispatch` spans, each batch
    once: the dispatch thread's share of its stage spent off the CPU."""
    by_batch = {s["attrs"]["batch"]: s for s in _named(sl, "batch.dispatch")
                if "cpu_us" in s and "batch" in s["attrs"]}
    wall = sum(s["duration_us"] for s in by_batch.values())
    return 1.0 - sum(s["cpu_us"] for s in by_batch.values()) / wall if wall > 0 else None


def py_cpu_cores(sl: Slice) -> float | None:
    """CPU seconds of the Python thread roles over the slice per second of
    it: near 1.0, one core's worth of Python, which the GIL caps."""
    cpu = sl.thread_cpu
    if not cpu or sl.seconds <= 0:
        return None
    return sum(v for k, v in cpu.items() if k != "process") / sl.seconds


READINGS = {
    "decode_cpu_us": ("us", decode_cpu_us),
    "collect_wait_us": ("us", collect_wait_us),
    "stage_wait_us": ("us", stage_wait_us),
    "dispatch_offcpu_frac": ("ratio", dispatch_offcpu_frac),
    "py_cpu_cores": ("cores", py_cpu_cores),
}


# ---------------------------------------------------------------- the run


class _Bench(spec.Bench):
    """BENCHMARK.json's metrics of the run and the READINGS after them,
    read from the Slice that `get_slice()` gives (None: no reading)."""

    def __init__(self, get_slice, root, bench_dir):
        super().__init__(root=root, bench_dir=bench_dir)
        self._get_slice = get_slice

    def metrics(self, cell: str, per_layer: bool) -> list:
        extra = []
        for name, (unit, fn) in READINGS.items():
            def read(ctx, fn=fn):
                sl = self._get_slice()
                return fn(sl) if sl is not None else None
            extra.append(spec.Metric(name=name, unit=unit, workloads=None,
                                     reader=types.SimpleNamespace(read=read)))
        return super().metrics(cell, per_layer) + extra


def _report(holder: dict) -> None:
    sl = holder.get("slice")
    if sl is None:
        return
    if sl.thread_cpu:
        per_s = {k: round(v / sl.seconds, 4) for k, v in sl.thread_cpu.items()}
        print(f"ctrbench spans: CPU seconds per second by thread role: {json.dumps(per_s)}",
              file=sys.stderr)
    decode = _named(sl, "predict.decode")
    print(f"ctrbench spans: {len([s for s in sl.spans if s['root']])} roots over "
          f"{sl.seconds:.3f} s; predict.decode wall mean us "
          f"{_mean([s['duration_us'] for s in decode])}; queue_wait mean us "
          f"{_mean([s['duration_us'] for s in _named(sl, 'batch.queue_wait')])}",
          file=sys.stderr)
    work = [s for s in sl.spans if not s["root"] and not s.get("wait") and "cpu_us" in s]
    roots = len([s for s in sl.spans if s["root"]])
    if roots:
        print(f"ctrbench spans: work spans per root {len(work) / roots:.2f}", file=sys.stderr)
    if holder.get("idle_split_s") is not None:
        split = sorted(holder["idle_split_s"].items(), key=lambda kv: -kv[1])
        print(f"ctrbench spans: device idle seconds by the program span over each gap's "
              f"middle: {json.dumps(dict(split))}", file=sys.stderr)
    if holder.get("clock_offsets_us") is not None:
        print(f"ctrbench spans: clock offset us at the slice's start and end (trace - "
              f"program, +- half the narrowest of {MARKS} markers' intervals): "
              f"{holder['clock_offsets_us']}", file=sys.stderr)


def run(argv, device_override=None, bench: spec.Bench | None = None) -> int:
    """run.py's run (`argv` without --trace) with the plane on: `--plane
    slice` (default) over the profiled slice of a traced run, `--plane
    window` over the whole of an untraced run (its cost; no thread CPU,
    which ends with the replica's threads before the readings are read).
    `device_override` and `bench` as in runner.run (tests only)."""
    from . import runner

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--plane", choices=("slice", "window"), default="slice")
    args, rest = p.parse_known_args(argv)
    bench = bench or spec.Bench()
    holder: dict = {}
    original = devtrace.profile_slice
    plane = None
    if args.plane == "slice":
        devtrace.profile_slice = (lambda length_s, snapshot:
                                  profile_slice(length_s, snapshot, holder))
    else:
        plane = Plane(count_cpu=False)
        plane.start()

    def get_slice():
        if plane is not None and "slice" not in holder:
            plane.stop()  # after the window: the first reading is read then
            holder["slice"] = plane.collect()
        return holder.get("slice")

    try:
        rc = runner.run(rest + ["--trace", "1" if plane is None else "0"],
                        device_override=device_override,
                        bench=_Bench(get_slice, bench.root, bench.bench_dir))
        _report(holder)
        return rc
    finally:
        devtrace.profile_slice = original
        if plane is not None:
            plane.stop()


def main(argv=None) -> int:
    from .runner import RunError

    try:
        return run(sys.argv[1:] if argv is None else argv)
    except RunError as exc:
        print(f"ctrbench: {exc}", file=sys.stderr)
        return 3
