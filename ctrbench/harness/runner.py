"""One run of one cell: `run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`.

The program's replica serves in this process on a free 127.0.0.1 port; the
load generator runs in one spawned child process. After the window the
program's state is freed, the reference checks the answers, and one JSON
line is printed as the last line of standard output. With --trace 0 it holds
the cell's end-to-end metrics, with --trace 1 its per-layer metrics (from
the program's spans and counters and a profiled slice of the window).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np

from . import child, imports, loadgen
from . import spec as spec_mod
from .traffic import Traffic

# The profiled slice: starts this share of the way into the window and
# lasts this share of it, at most TRACE_MAX_S.
TRACE_AT = 0.35
TRACE_SHARE = 0.3
TRACE_MAX_S = 4.0
READY_TIMEOUT_S = 300.0


class RunError(RuntimeError):
    """The run cannot give a result (no card, a forbidden import, a failed
    set-up); it prints no result line and exits with a nonzero code."""


@dataclasses.dataclass
class Context:
    """What a metric's reader reads."""

    cell: spec_mod.Cell
    seconds: float
    setup_s: float
    load: dict  # the load generator's result
    window: dict | None = None  # replica.delta over the window
    timeline: list | None = None  # the batcher's per-request times
    trace: object | None = None  # devtrace.Reduced of the profiled slice
    device_name: str = ""

    @property
    def model(self) -> dict:
        return self.cell.config["model"]

    def flops(self):
        return spec_mod.flops(self.cell.config["kind"])


def process_start_wall() -> float:
    """Wall-clock time this process started (from /proc; the time of the
    first import of this module where /proc is not there)."""
    import os

    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return _IMPORTED_AT


_IMPORTED_AT = time.time()


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def require_cards(chips: int) -> str:
    import torch

    if not torch.cuda.is_available():
        raise RunError("torch.cuda.is_available() is false: this benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise RunError(f"the cell needs {chips} card(s), torch sees {torch.cuda.device_count()}")
    return torch.cuda.get_device_name(0)


def start_loadgen(job: loadgen.Job):
    """The load generator's process and the connection to it."""
    return child.start("ctrbench.harness.loadgen", "main", (job,), "ctrbench-loadgen")


def _job(cell: spec_mod.Cell, traffic: Traffic, seed: int, seconds: float, addresses: list[str],
         fanout: bool = False) -> loadgen.Job:
    model = cell.config["model"]
    return loadgen.Job(addresses=addresses, model_name=model["name"], traffic=traffic.spec,
                       traffic_name=traffic.name, num_fields=model["num_fields"],
                       num_dense=model.get("num_dense_features", 0)
                       if cell.config["kind"] == "dlrm" else 0,
                       seed=seed, seconds=seconds, fanout=fanout)


def _recv(conn, proc, timeout: float, what: str):
    if not conn.poll(timeout):
        raise RunError(f"the load generator sent no {what} within {timeout:.0f} s "
                       f"(alive: {proc.is_alive()}, exit code {proc.exitcode})")
    try:
        return conn.recv()
    except EOFError as exc:
        raise RunError(f"the load generator ended before {what} "
                       f"(exit code {proc.exitcode})") from exc


def drive_window(rep, cell: spec_mod.Cell, traffic: Traffic, seed: int, seconds: float,
                 trace: bool, t_start_wall: float) -> Context:
    """Load generator up and warmed against a serving replica, then the
    window; its context (setup_s counts from t_start_wall to the window)."""
    from . import devtrace, replica

    if trace:
        devtrace.prime()
    proc, conn = start_loadgen(_job(cell, traffic, seed, seconds, [rep.address]))
    try:
        msg = _recv(conn, proc, READY_TIMEOUT_S, "ready")
        if msg[0] != "ready":
            raise RunError(f"unexpected message {msg[0]!r}")
        before = rep.snapshot()
        if trace:
            rep.batcher.timeline = []
        setup_s = time.time() - t_start_wall
        conn.send("go")
        reduced = None
        if trace:
            # On this (the main) thread, inside the window.
            time.sleep(seconds * TRACE_AT)
            reduced, why = devtrace.profile_slice(min(seconds * TRACE_SHARE, TRACE_MAX_S),
                                                  lambda: rep.snapshot()["stats"])
            if reduced is None:
                print(f"ctrbench: device trace unavailable: {why}", file=sys.stderr)
        _, load = _recv(conn, proc, seconds + loadgen.LATE_S + 120.0, "result")
        after = rep.snapshot()
        ctx = Context(cell=cell, seconds=seconds, setup_s=setup_s, load=load,
                      window=replica.delta(before, after), trace=reduced)
        if trace:
            ctx.timeline = rep.batcher.timeline
            rep.batcher.timeline = None
        proc.join(30.0)
        return ctx
    finally:
        if proc.is_alive():
            proc.terminate()
            proc.join(10.0)


def serve_window(cell: spec_mod.Cell, traffic: Traffic, seed: int, seconds: float, trace: bool,
                 device, t_start_wall: float, timings: dict | None = None):
    """Replica up, the window, the replica freed: (context,
    memory_peak_bytes), the peak read before the replica is freed."""
    import torch

    from . import replica

    rep = replica.Replica(cell.config, traffic, seed, device, timings)
    try:
        ctx = drive_window(rep, cell, traffic, seed, seconds, trace, t_start_wall)
        peak = int(torch.cuda.max_memory_allocated(rep.device)) if rep.device.type == "cuda" else 0
        return ctx, peak
    finally:
        rep.stop()


def fanout_window(cell: spec_mod.Cell, traffic: Traffic, seed: int, seconds: float,
                  trace: bool, device_override, t_start_wall: float):
    """One replica process per card, the fan-out load generator, the window,
    the replicas stopped: (context, memory_peak_bytes of the fullest
    card)."""
    from . import devtrace, replica, replicas

    rs = replicas.ReplicaSet(cell.chips, cell.config, traffic, seed, trace,
                             device=str(device_override) if device_override else None)
    proc = None
    try:
        proc, conn = start_loadgen(_job(cell, traffic, seed, seconds, rs.addresses, fanout=True))
        msg = _recv(conn, proc, READY_TIMEOUT_S, "ready")
        if msg[0] != "ready":
            raise RunError(f"unexpected message {msg[0]!r}")
        before = rs.ask("snapshot")
        setup_s = time.time() - t_start_wall
        conn.send("go")
        if trace:
            rs.tell(("trace", seconds * TRACE_AT, min(seconds * TRACE_SHARE, TRACE_MAX_S)))
        _, load = _recv(conn, proc, seconds + loadgen.LATE_S + 120.0, "result")
        after = rs.ask("snapshot")
        got = rs.ask("collect")
        ctx = Context(cell=cell, seconds=seconds, setup_s=setup_s, load=load,
                      window=replica.delta_sum(before, after))
        load["forbidden"] = sorted({f for g in got for f in g["forbidden"]}
                                   | set(load.get("forbidden", [])))
        if trace:
            parts = [g["trace"] for g in got]
            if all(p is not None for p in parts):
                ctx.trace = devtrace.merge(parts)
            else:
                print("ctrbench: device trace unavailable: "
                      f"{[g['trace_error'] for g in got]}", file=sys.stderr)
            ctx.timeline = [row for g in got for row in (g["timeline"] or [])]
        proc.join(30.0)
        return ctx, max(g["peak"] for g in got)
    finally:
        if proc is not None and proc.is_alive():
            proc.terminate()
            proc.join(10.0)
        rs.stop()


def _print_slices(load: dict, seconds: float, parts: int = 5) -> None:
    """Answers and median latency per fifth of the window, on standard error:
    whether a run drifted or stalled inside its window."""
    done = np.asarray(load.get("done_s", []))
    lat = np.asarray(load["latency_s"]) * 1e3
    cells = []
    for i in range(parts):
        lo, hi = seconds * i / parts, seconds * (i + 1) / parts
        sel = (done >= lo) & (done < hi)
        cells.append(f"{int(sel.sum())}@{np.median(lat[sel]):.1f}ms" if sel.any() else "0")
    print(f"ctrbench: answers@p50 per fifth of the window: {' '.join(cells)}", file=sys.stderr)


def run(argv, device_override=None, bench: spec_mod.Bench | None = None) -> int:
    """The whole run. `device_override` and `bench` (tests only) skip the
    look for a card and serve on that device, and read another benchmark
    directory."""
    t_start_wall = process_start_wall()
    args = parse(argv)
    bench = bench or spec_mod.Bench()
    cell = bench.cell(args.workload)
    traffic = Traffic(cell.traffic_name, cell.traffic)
    if device_override is None:
        device_name = require_cards(cell.chips)
        device = "cuda:0"
    else:
        device_name, device = str(device_override), device_override
    metrics = bench.metrics(cell.name, per_layer=bool(args.trace))
    timings: dict = {}
    if traffic.spec.get("fanout"):
        ctx, peak = fanout_window(cell, traffic, args.seed, args.seconds, bool(args.trace),
                                  device_override, t_start_wall)
    elif cell.chips == 1:
        ctx, peak = serve_window(cell, traffic, args.seed, args.seconds, bool(args.trace),
                                 device, t_start_wall, timings)
    else:
        raise RunError(f"a cell on {cell.chips} cards needs a fan-out traffic")
    ctx.device_name = device_name
    load = ctx.load
    if load.get("late_s") is not None and len(load["late_s"]):
        late = np.asarray(load["late_s"]) * 1e3
        print(f"ctrbench: open-loop sender lateness ms: p50 {np.percentile(late, 50):.4f} "
              f"p95 {np.percentile(late, 95):.4f} max {late.max():.4f} over {late.size}",
              file=sys.stderr)
    print(f"ctrbench: set-up {json.dumps({k: round(v, 4) for k, v in timings.items()})}",
          file=sys.stderr)
    _print_slices(load, args.seconds)
    from . import check

    verdict = check.compare(cell.config, traffic, args.seed, load, device)
    values = {}
    for m in metrics:
        v = m.reader.read(ctx)
        if v is not None:
            values[m.name] = {"value": float(v), "unit": m.unit}
    found = sorted(set(imports.forbidden_loaded()) | set(load.get("forbidden", [])))
    if found:
        raise RunError(f"forbidden modules loaded: {found}")
    for f in load.get("failures", []):
        print(f"ctrbench: failed request: {f}", file=sys.stderr)
    device_doc = {"platform": "gpu" if device_override is None else str(device_override),
                  "kind": device_name, "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": verdict["correct"], "attempted": int(load["attempted"]),
              "failed": int(load["failed"]), "metrics": values, "device": device_doc}
    if args.trace and ctx.trace is not None:
        device_doc["busy_s"] = ctx.trace.busy_s
        device_doc["window_s"] = ctx.trace.window_s
        top = sorted(ctx.trace.by_name.items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {"device_ops": [[k, v] for k, v in top],
                               "idle_gaps": [[label, s] for s, label in ctx.trace.gaps[:10]]}
    result["check"] = verdict["numbers"]
    for name, n in verdict["numbers"].items():
        print(f"check {name}: {n['value']} (limit {n['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


def main(argv=None) -> int:
    try:
        return run(sys.argv[1:] if argv is None else argv)
    except RunError as exc:
        print(f"ctrbench: {exc}", file=sys.stderr)
        return 3
