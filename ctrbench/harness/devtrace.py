"""The device trace of a steady slice of the window: torch.profiler (CUPTI)
around the serving process for a few seconds, exported as a Chrome trace
into TMPDIR, read back and reduced here, then deleted.

Reductions: the union of device operations (busy seconds) against the slice
(window seconds); device time by operation name; the idle gaps between
device operations, each labelled with the host operation that spanned its
middle; and the device steps: the batch's single host-to-device copy opens a
step, and its kernels, first start to last end, are its span.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class Step:
    h2d_bytes: int
    span_s: float
    kernels: list  # (name, seconds)


@dataclasses.dataclass
class Reduced:
    window_s: float
    busy_s: float
    by_name: dict  # device op name -> seconds
    gaps: list  # (seconds, label), longest first
    steps: list  # Step
    stats: dict | None = None  # BatcherStats difference over the slice


def _merge(intervals: list[tuple[float, float]]) -> float:
    total = 0.0
    end = None
    start = None
    for a, b in sorted(intervals):
        if end is None or a > end:
            if end is not None:
                total += end - start
            start, end = a, b
        else:
            end = max(end, b)
    if end is not None:
        total += end - start
    return total


def reduce_events(events: list[dict], t0_us: float, t1_us: float) -> Reduced:
    """Reduce Chrome-trace events ("ph": "X", ts / dur in microseconds)
    inside [t0_us, t1_us]."""
    dev = []
    host = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        if b < t0_us or a > t1_us:
            continue
        cat = e.get("cat", "")
        if cat in _DEVICE_CATS:
            dev.append((max(a, t0_us), min(b, t1_us), cat, e.get("name", ""), e.get("args", {})))
        elif cat in ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation"):
            host.append((a, b, e.get("name", "")))
    dev.sort()
    window_s = (t1_us - t0_us) / 1e6
    busy_s = _merge([(a, b) for a, b, *_ in dev]) / 1e6
    by_name: dict[str, float] = {}
    for a, b, _, name, _ in dev:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
    gaps = []
    reach = t0_us
    prev = "slice start"
    for a, b, _, name, _ in dev:
        if a > reach:
            gaps.append((a - reach, reach, a, prev, name))
        if b > reach:
            reach = b
            prev = name
    gaps.sort(key=lambda g: -g[0])
    labelled = []
    for length, a, b, before, after in gaps[:10]:
        mid = (a + b) / 2
        over = [h for h in host if h[0] <= mid <= h[1]]
        doing = min(over, key=lambda h: h[1] - h[0])[2] if over else "no traced host op"
        labelled.append((length / 1e6, f"host: {doing}; after {before[:60]}; before {after[:60]}"))
    gaps = labelled + [(g[0] / 1e6, "") for g in gaps[10:]]
    steps: list[Step] = []
    cur = None
    for a, b, cat, name, args in dev:
        if cat == "gpu_memcpy" and "HtoD" in name:
            cur = Step(h2d_bytes=int(args.get("bytes", 0) or 0), span_s=0.0, kernels=[])
            cur._first = cur._last = None  # type: ignore[attr-defined]
            steps.append(cur)
            continue
        if cat == "kernel" and cur is not None:
            cur.kernels.append((name, (b - a) / 1e6))
            cur._first = a if cur._first is None else cur._first
            cur._last = b if cur._last is None else max(cur._last, b)
    for s in steps:
        if s._first is not None:
            s.span_s = (s._last - s._first) / 1e6
    return Reduced(window_s=window_s, busy_s=busy_s, by_name=by_name, gaps=gaps,
                   steps=[s for s in steps if s.kernels])


def merge(parts: list[Reduced]) -> Reduced:
    """One reduction over several cards: busy and window seconds averaged
    over them, everything else pooled."""
    n = len(parts)
    by_name: dict[str, float] = {}
    for r in parts:
        for k, v in r.by_name.items():
            by_name[k] = by_name.get(k, 0.0) + v
    stats: dict = {}
    for r in parts:
        for k, v in (r.stats or {}).items():
            stats[k] = stats.get(k, 0) + v
    return Reduced(window_s=sum(r.window_s for r in parts) / n,
                   busy_s=sum(r.busy_s for r in parts) / n, by_name=by_name,
                   gaps=sorted((g for r in parts for g in r.gaps), key=lambda g: -g[0]),
                   steps=[s for r in parts for s in r.steps], stats=stats)


def prime() -> None:
    """Start and stop the profiler once, in set-up, before the load
    generator's process exists: a process whose first profile starts after
    that records no device operation (seen on the H100 machines with
    torch 2.11), one that profiled once before records them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts):
        time.sleep(0.05)


def profile_slice(length_s: float, snapshot) -> tuple[Reduced | None, str | None]:
    """Profile the next `length_s` seconds of this process: (the reduction,
    None) or (None, why not). Call it on the thread that first used the
    profiler (the process's main thread): CUPTI's callbacks are registered
    there, and a profile started on another thread records no device
    operation."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    try:
        before = snapshot()
        cuda = torch.cuda.is_available()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA] if cuda
                     else [ProfilerActivity.CPU]) as prof:
            if cuda:
                torch.cuda.synchronize()
            mark0 = time.perf_counter()
            time.sleep(length_s)
            if cuda:
                torch.cuda.synchronize()
            mark1 = time.perf_counter()
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
        if not any(e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS for e in events):
            cats: dict[str, int] = {}
            for e in events:
                cats[str(e.get("cat"))] = cats.get(str(e.get("cat")), 0) + 1
            return None, f"the profiler recorded no device operation (events by category: {cats})"
        # The slice in trace time: from the first recorded event, no longer
        # than the slept interval.
        spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                 for e in events if e.get("ph") == "X" and "dur" in e]
        t0 = min(a for a, _ in spans)
        t1 = min(max(b for _, b in spans), t0 + (mark1 - mark0) * 1e6)
        reduced = reduce_events(events, t0, t1)
        reduced.stats = {k: v - before.get(k, 0) for k, v in after.items()
                         if isinstance(v, (int, float))}
        return reduced, None
    except Exception as exc:  # noqa: BLE001 — reported; the run then has no trace metrics
        return None, f"{type(exc).__name__}: {exc}"
