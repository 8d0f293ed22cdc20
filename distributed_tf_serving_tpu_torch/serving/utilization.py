"""Device-utilization attribution plane: occupancy ledger, gap waterfall,
on-demand deep capture.

The JAX package's plane (`serving/utilization.py` there), with the same
names, fields and bodies, on the card:

- **OccupancyLedger**: the busy/idle timeline of the batcher's device, fed
  ONE interval per completed batch (`note_batch`: stage start, readback
  issued, readback seen complete) plus cheap wait records the batcher
  leaves while it idles: `queue_empty` (no work arrived), `host_pack` (the
  host held a batch open to coalesce, or did per-batch work),
  `readback_wait` (dispatch held behind in-flight batches: the
  pipeline_depth backpressure and the in-flight window), `admission_shed`
  (traffic existed but admission refused it). An in-flight depth gauge
  rides the same hooks.

  On the card a batch's `done` time is when a completion worker saw its
  readback event complete, not when its kernel ended: the busy union is an
  upper bound on the card's kernel time over the same window.
- **Gap waterfall**: a windowed split of wall time into device /
  h2d_dispatch / d2h / idle-by-cause / other whose sum is the window's wall
  time by construction (the residual is reported as `other`), and the live
  `achieved_fraction_of_device_limit`: per-bucket device step x batches
  served over wall when a calibration table is loaded, the busy fraction
  (labelled so) without one. A table must be the card's own, measured on
  the card that serves (`load_calibration` reads `{bucket: us}`); none is
  loaded by default. Served as `GET /utilz`, the `utilization` block of
  `/monitoring`, the `dts_tpu_utilization_*` series and a per-device counter
  track in `/tracez?format=chrome`.
- **On-demand deep capture**: `POST /profilez/start?seconds=N` runs a
  `torch.profiler` capture (CPU and, on a card, CUDA activities; the Chrome
  trace lands in the artifact dir) and samples every host thread's Python
  stack over the same window (HostStackSampler, `host_stacks.json`).
  Concurrent captures are refused (409). A profiler that cannot start,
  another torch.profiler already recording in this process included, is
  recorded as `device_trace: false` with `device_trace_error`, and the host
  side still captures.

The ledger needs nothing but the standard library; only the capture
imports torch, when a capture starts.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from collections import deque

# Idle-gap blocking causes, in reporting order.
GAP_CAUSES = ("queue_empty", "host_pack", "readback_wait", "admission_shed")

# Gap-length histogram edges (milliseconds, cumulative-le semantics).
_GAP_LE_MS = (1.0, 10.0, 100.0, 1000.0)


def _clamp(t0: float, t1: float, w0: float, w1: float) -> float:
    """Length of (t0, t1) ∩ (w0, w1)."""
    return max(0.0, min(t1, w1) - max(t0, w0))


def _merge_intervals(spans: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """Sorted union of possibly-overlapping (t0, t1) spans."""
    if not spans:
        return []
    spans = sorted(spans)
    out = [spans[0]]
    for t0, t1 in spans[1:]:
        if t0 <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], t1))
        else:
            out.append((t0, t1))
    return out


def _overlap_with_union(union: list[tuple[float, float]], t0: float, t1: float) -> float:
    """Seconds of (t0, t1) covered by a sorted disjoint union."""
    total = 0.0
    for u0, u1 in union:
        if u0 >= t1:
            break
        total += _clamp(u0, u1, t0, t1)
    return total


def _normalize_step_table(table: dict | None) -> dict[int, float]:
    """The one normalization of a per-bucket device-step table: {bucket: us}
    or {bucket: [lo, hi]} (the midpoint); non-positive entries are skipped
    (a 0.0 step can only divide by zero downstream). Shared by
    load_calibration and set_calibration."""
    out: dict[int, float] = {}
    for bucket, val in (table or {}).items():
        if isinstance(val, (list, tuple)) and len(val) == 2:
            val = (float(val[0]) + float(val[1])) / 2.0
        if val and float(val) > 0:
            out[int(bucket)] = float(val)
    return out


def load_calibration(path: str) -> dict[int, float]:
    """Per-bucket device step (us) from a JSON file: `{bucket: us}` (or
    `{"device_step_us": {bucket: us | [lo, hi]}}`). An empty dict on any
    trouble: calibration enriches the estimate, it is never a dependency."""
    try:
        with open(path) as f:
            doc = json.load(f)
        table = doc.get("device_step_us", doc) if isinstance(doc, dict) else {}
        return _normalize_step_table(table)
    except Exception:  # noqa: BLE001 — absent/corrupt table = no calibration
        return {}


def _split_span(
    waits, open_waits, sheds, g0: float, g1: float,
    residual_to_host_pack: bool = True,
) -> dict[str, float]:
    """Per-cause seconds of the idle span (g0, g1): overlap with the
    recorded waits (open waits count their elapsed part), the residual to
    host_pack (optional: the startup span and in-flight tails leave it
    unattributed), and the queue_empty share moved to admission_shed when a
    shed fired inside the span. A pure function of the collections passed,
    so live rings (under the ledger lock) and snapshots serve alike."""
    split = {c: 0.0 for c in GAP_CAUSES}
    # Closed waits are append-ordered by end time: scan from the right and
    # stop once they end before the gap starts.
    for cause, w0, w1 in reversed(waits):
        if w1 <= g0:
            break
        split[cause] += _clamp(w0, w1, g0, g1)
    for cause, w0 in open_waits:
        split[cause] += _clamp(w0, g1, g0, g1)
    gap = g1 - g0
    explained = sum(split.values())
    if explained > gap > 0:
        # Concurrent waits can overlap: scale so the attribution never
        # exceeds the gap itself.
        scale = gap / explained
        split = {c: s * scale for c, s in split.items()}
        explained = gap
    if residual_to_host_pack:
        split["host_pack"] += max(0.0, gap - explained)
    if split["queue_empty"] > 0 and any(g0 <= t <= g1 for t in sheds):
        split["admission_shed"] += split["queue_empty"]
        split["queue_empty"] = 0.0
    return split


class OccupancyLedger:
    """Busy/idle timeline and idle-gap attribution for one device.

    Feeders (the batcher, while the plane is armed):
    - ``wait_begin(cause)`` / ``wait_end(token)`` around the batcher's idle
      waits: two clock reads per wait, paid while the device idles anyway;
    - ``note_shed()`` at every admission refusal (a point event);
    - ``depth_inc()`` / ``depth_dec()`` around each batch's device stage to
      readback life (the pipeline-depth gauge);
    - ``note_batch(stage_t0, issue_t0, done_t, bucket, candidates,
      d2h_wait_s)`` once per completed batch, from the completion worker.

    When a batch's busy interval opens a gap after the previous busy union,
    the gap's seconds are split across causes by overlap with the recorded
    waits; the unexplained residual is ``host_pack`` (the host was doing
    per-batch work whenever it was neither waiting nor dispatching). A gap
    holding a shed moves its queue_empty share to ``admission_shed``. Each
    gap lands in a per-cause histogram under its largest cause.

    Ring-bounded (``ring`` batches, gaps and waits) and clocked by an
    injectable ``clock`` (time.perf_counter, the batcher's clock)."""

    def __init__(
        self,
        device: str | None = None,
        ring: int = 4096,
        clock=time.perf_counter,
        calibration: dict[int, float] | None = None,
        window_s: float = 60.0,
    ):
        self.device = device or "device:0"
        # The per-device list when one ledger attributes several devices
        # that every batch occupies together (a mesh: build_stack labels it
        # with the mesh's devices); None for one device.
        self.devices: list[str] | None = None
        self.window_s = float(window_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._started_t = clock()
        # (stage_t0, issue_t0, done_t, bucket, candidates, d2h_wait_s)
        self._ring: deque[tuple] = deque(maxlen=ring)
        # (g0, g1, dominant cause, per-cause seconds aligned with GAP_CAUSES)
        self._gaps: deque[tuple] = deque(maxlen=ring)
        # (cause, w0, w1) closed waits, append-ordered by w1.
        self._waits: deque[tuple] = deque(maxlen=ring)
        self._open_waits: dict[int, tuple[str, float]] = {}
        self._wait_seq = 0
        self._sheds: deque[float] = deque(maxlen=ring)
        self._busy_until: float | None = None
        # Lifetime counters (ring-independent).
        self.batches = 0
        self.candidates = 0
        self.busy_s = 0.0
        self.gap_s = {c: 0.0 for c in GAP_CAUSES}
        self.gap_counts = {c: 0 for c in GAP_CAUSES}
        self._gap_hist = {c: [0] * (len(_GAP_LE_MS) + 1) for c in GAP_CAUSES}
        self.in_flight = 0
        self.max_in_flight = 0
        self.sheds = 0
        self._calibration = dict(calibration or {})

    # ------------------------------------------------------------- feeders

    def wait_begin(self, cause: str) -> int:
        now = self._clock()
        with self._lock:
            self._wait_seq += 1
            token = self._wait_seq
            self._open_waits[token] = (cause, now)
        return token

    def wait_end(self, token: int) -> None:
        now = self._clock()
        with self._lock:
            entry = self._open_waits.pop(token, None)
            if entry is not None:
                self._waits.append((entry[0], entry[1], now))

    def note_shed(self) -> None:
        now = self._clock()
        with self._lock:
            self.sheds += 1
            self._sheds.append(now)

    def depth_inc(self) -> None:
        with self._lock:
            self.in_flight += 1
            self.max_in_flight = max(self.max_in_flight, self.in_flight)

    def depth_dec(self) -> None:
        with self._lock:
            self.in_flight = max(0, self.in_flight - 1)

    def set_calibration(self, table: dict) -> None:
        """Install or refresh the per-bucket device-step table (us), with
        load_calibration's normalization."""
        clean = _normalize_step_table(table)
        with self._lock:
            self._calibration = clean

    def note_batch(
        self,
        stage_t0: float,
        issue_t0: float,
        done_t: float,
        bucket: int = 0,
        candidates: int = 0,
        d2h_wait_s: float = 0.0,
    ) -> None:
        """One interval per completed batch (from the completion worker):
        closes the idle gap since the previous busy union, extends the
        union, and records the batch for the windowed waterfall."""
        with self._lock:
            self.batches += 1
            self.candidates += int(candidates)
            first = self._busy_until is None
            prev_end = self._busy_until if not first else self._started_t
            if stage_t0 > prev_end:
                # The span before the first batch is startup: only its
                # wait-explained share is recorded (the waterfall's `other`
                # carries the rest); later gaps charge their residual to
                # host_pack.
                self._close_gap_locked(prev_end, stage_t0, residual_to_host_pack=not first)
            self.busy_s += max(0.0, done_t - max(stage_t0, prev_end))
            self._busy_until = max(prev_end, done_t)
            self._ring.append(
                (stage_t0, issue_t0, done_t, int(bucket), int(candidates),
                 max(0.0, float(d2h_wait_s)))
            )

    # ----------------------------------------------------- gap attribution

    def _close_gap_locked(self, g0: float, g1: float, residual_to_host_pack: bool = True) -> None:
        split = _split_span(
            self._waits, self._open_waits.values(), self._sheds, g0, g1, residual_to_host_pack,
        )
        attributed = sum(split.values())
        if attributed <= 0:
            return  # a wholly unattributed startup span: the waterfall's `other`
        dominant = max(GAP_CAUSES, key=lambda c: split[c])
        self.gap_s[dominant] += attributed
        self.gap_counts[dominant] += 1
        hist = self._gap_hist[dominant]
        gap_ms = attributed * 1e3
        for i, le in enumerate(_GAP_LE_MS):
            if gap_ms <= le:
                hist[i] += 1
                break
        else:
            hist[-1] += 1
        self._gaps.append((g0, g1, dominant, tuple(split[c] for c in GAP_CAUSES)))

    # ------------------------------------------------------------- readers

    def waterfall(self, window_s: float | None = None) -> dict:
        """Windowed wall-time split. Its components sum to the window's wall
        time by construction: busy (h2d_dispatch / device / d2h) + idle per
        cause + `other` (idle the ring no longer covers, time before the
        first batch, a batch still in flight), the residual reported, never
        folded into a real component."""
        now = self._clock()
        # Copy under the lock, compute outside it: the same lock serializes
        # the batcher's hooks, and a scrape must not stall serving.
        with self._lock:
            window = float(window_s if window_s is not None else self.window_s)
            ring = list(self._ring)
            gaps = list(self._gaps)
            waits = list(self._waits)
            open_waits = list(self._open_waits.values())
            sheds = list(self._sheds)
            busy_until = self._busy_until
            started_t = self._started_t
            calibration = self._calibration
            in_flight = self.in_flight
        w0 = max(now - window, started_t)
        wall = max(now - w0, 1e-9)
        batches = [b for b in ring if b[2] > w0]
        busy_union = _merge_intervals(
            [(max(b[0], w0), min(b[2], now)) for b in batches if min(b[2], now) > max(b[0], w0)]
        )
        busy = sum(t1 - t0 for t0, t1 in busy_union)
        # The busy split: host dispatch / H2D (stage start -> readback
        # issued) and the D2H wait (the completion worker's measured event
        # wait); device is the rest of the busy union.
        dispatch_raw = sum(_clamp(b[0], min(b[1], b[2]), w0, now) for b in batches)
        d2h_raw = sum(min(b[5], _clamp(b[0], b[2], w0, now)) for b in batches)
        sub = dispatch_raw + d2h_raw
        if sub > busy > 0:
            # Pipelined batches overlap: scale the per-batch parts into the
            # union.
            dispatch_raw *= busy / sub
            d2h_raw *= busy / sub
        device = max(0.0, busy - dispatch_raw - d2h_raw)
        idle = {c: 0.0 for c in GAP_CAUSES}
        for g0, g1, _dom, split in gaps:
            full = g1 - g0
            if g1 <= w0 or full <= 0:
                continue
            vis = _clamp(g0, g1, w0, now)
            # Out-of-order completions can cover a recorded gap later: only
            # the still-idle part counts.
            vis -= _overlap_with_union(busy_union, max(g0, w0), min(g1, now))
            if vis <= 0:
                continue
            frac = vis / full
            for c, s in zip(GAP_CAUSES, split):
                idle[c] += s * frac
        # The live tail since the last completed batch: its residual goes to
        # host_pack only after a batch completed and with none in flight (an
        # executing batch's span stays `other` until it completes).
        tail0 = max(busy_until if busy_until is not None else started_t, w0)
        if now > tail0:
            tail_split = _split_span(
                waits, open_waits, sheds, tail0, now,
                residual_to_host_pack=(busy_until is not None and in_flight == 0),
            )
            for c, s in tail_split.items():
                idle[c] += s
        other = max(0.0, wall - busy - sum(idle.values()))
        components = {
            "device": device,
            "h2d_dispatch": dispatch_raw,
            "d2h": d2h_raw,
            **{f"idle_{c}": idle[c] for c in GAP_CAUSES},
            "other": other,
        }
        total = sum(components.values())
        # Calibrated device-limit fraction: the per-bucket device step x the
        # batches served in the window, over wall.
        calibrated = None
        if calibration:
            est = sum(calibration.get(b[3], 0.0) for b in batches) / 1e6
            calibrated = est / wall
        busy_fraction = busy / wall
        return {
            "window_s": round(window, 3),
            "wall_s": round(wall, 6),
            "components_s": {k: round(v, 6) for k, v in components.items()},
            "sum_s": round(total, 6),
            "sum_over_wall": round(total / wall, 6),
            "busy_fraction": round(busy_fraction, 6),
            "batches": len(batches),
            "achieved_fraction_of_device_limit": round(
                calibrated if calibrated is not None else busy_fraction, 6
            ),
            "calibration": "device_step_table" if calibrated is not None else "busy_fraction",
        }

    def snapshot(self, window_s: float | None = None) -> dict:
        wf = self.waterfall(window_s)
        per_device = (
            {d: {"busy_fraction": wf["busy_fraction"]} for d in self.devices}
            if self.devices else None
        )
        with self._lock:
            gaps = {
                c: {
                    "count": self.gap_counts[c],
                    "total_s": round(self.gap_s[c], 6),
                    "le_ms": dict(
                        zip([str(le) for le in _GAP_LE_MS] + ["+Inf"], self._gap_hist[c])
                    ),
                }
                for c in GAP_CAUSES
            }
            out = {
                "enabled": True,
                "device": self.device,
                "in_flight": self.in_flight,
                "max_in_flight": self.max_in_flight,
                "batches": self.batches,
                "candidates": self.candidates,
                "busy_s": round(self.busy_s, 6),
                "sheds": self.sheds,
                "calibrated": bool(self._calibration),
                "idle_gaps": gaps,
                "waterfall": wf,
            }
        if per_device is not None:
            out["devices"] = list(self.devices)
            out["per_device"] = per_device
            out["occupancy_attribution"] = "spmd_uniform"
        return out

    def chrome_counter_events(self, t_base: float, pid: int) -> list[dict]:
        """The per-device counter track of the Chrome export: an `occupancy`
        counter stepping with the batches in the device pipeline, rebuilt
        from the interval ring, in non-decreasing ts order on one named
        track per device."""
        with self._lock:
            batches = list(self._ring)
        edges: list[tuple[float, int]] = []
        for b in batches:
            edges.append((b[0], +1))
            edges.append((b[2], -1))
        edges.sort()
        tracks = list(self.devices) if self.devices else [self.device]
        events: list[dict] = [
            {"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
             "args": {"name": "device-utilization"}},
        ]
        for tid, name in enumerate(tracks):
            events.append(
                {"ph": "M", "name": "thread_name", "pid": pid, "tid": tid, "args": {"name": name}}
            )
        depth = 0
        last_ts = 0
        for t, step in edges:
            depth += step
            ts = max(last_ts, max(0, int((t - t_base) * 1e6)))
            last_ts = ts
            for tid in range(len(tracks)):
                events.append({
                    "ph": "C", "name": "occupancy", "pid": pid, "tid": tid,
                    "ts": ts, "args": {"in_flight": depth},
                })
        return events


def device_label(device) -> str:
    """The ledger's device name: `cuda:N (<card name>)` for a CUDA device,
    else its torch name (`cpu`)."""
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        index = device.index if device.index is not None else torch.cuda.current_device()
        return f"cuda:{index} ({torch.cuda.get_device_name(index)})"
    return str(device)


# --------------------------------------------------------------------------
# On-demand deep capture: torch.profiler device trace + host stack sampling.


class HostStackSampler:
    """Periodic Python-stack sampler over every live thread. Aggregates
    collapsed stacks (``func (file:line);...``) per thread name; the report
    is a plain dict the REST surface serializes. Standard library only;
    the cost is bounded by interval_s and the stack depth."""

    def __init__(self, interval_s: float = 0.02, max_depth: int = 12):
        self.interval_s = max(float(interval_s), 0.001)
        self.max_depth = int(max_depth)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._counts: dict[tuple[str, str], int] = {}
        self.samples = 0

    def _collapse(self, frame) -> str:
        parts = []
        depth = 0
        while frame is not None and depth < self.max_depth:
            code = frame.f_code
            parts.append(f"{code.co_name} ({os.path.basename(code.co_filename)}:{frame.f_lineno})")
            frame = frame.f_back
            depth += 1
        return ";".join(parts)

    def _loop(self) -> None:
        me = threading.get_ident()
        while not self._stop.is_set():
            names = {t.ident: t.name for t in threading.enumerate()}
            for ident, frame in sys._current_frames().items():
                if ident == me:
                    continue
                key = (names.get(ident, f"thread-{ident}"), self._collapse(frame))
                self._counts[key] = self._counts.get(key, 0) + 1
            self.samples += 1
            self._stop.wait(self.interval_s)

    def start(self) -> "HostStackSampler":
        self._thread = threading.Thread(target=self._loop, name="host-stack-sampler", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> dict:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        threads: dict[str, list] = {}
        for (name, stack), count in sorted(self._counts.items(), key=lambda kv: -kv[1]):
            threads.setdefault(name, []).append({"stack": stack, "count": count})
        return {"samples": self.samples, "interval_s": self.interval_s, "threads": threads}


class CaptureInProgressError(RuntimeError):
    """A deep capture is already running; a concurrent one is refused (the
    profiler is process-global)."""


class _TorchTrace:
    """A torch.profiler capture of CPU and, on a card, CUDA activities,
    owned by one thread from start to export (the profiler's state is
    partly per thread, so one thread enables, steps and disables it).

    It runs one warmup step of `warmup_s` before recording: the tracer can
    drop a kernel's first launch in a window, and that launch then falls in
    the warmup step (whose events are discarded), not in the window.
    start() returns once the profiler records; stop() ends the window and
    writes the Chrome trace `trace_<pid>_<ns>.json` into `log_dir`.

    Starting while another torch.profiler records in this process raises:
    two profilers in one process corrupt each other."""

    def __init__(self, log_dir: str, warmup_s: float):
        self.log_dir = log_dir
        self.warmup_s = warmup_s
        self.path: str | None = None
        self._error: BaseException | None = None
        self._recording = threading.Event()
        self._stop = threading.Event()
        self._done = threading.Event()

    def start(self) -> "_TorchTrace":
        import torch.autograd.profiler as autograd_profiler

        if autograd_profiler._is_profiler_enabled:
            raise RuntimeError("another torch.profiler is recording in this process")
        threading.Thread(target=self._run, name="profilez-device", daemon=True).start()
        if not self._recording.wait(60):
            self._stop.set()
            raise TimeoutError("torch.profiler did not start within 60 s")
        if self._error is not None:
            raise self._error
        return self

    def _export(self, prof) -> None:
        path = os.path.join(self.log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        self.path = path

    def _run(self) -> None:
        prof = None
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile, schedule

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            prof = profile(activities=activities, schedule=schedule(wait=0, warmup=1, active=1),
                           on_trace_ready=self._export)
            prof.start()
            time.sleep(self.warmup_s)
            prof.step()  # warmup -> recording
        except BaseException as exc:  # noqa: BLE001 — reported by start()
            self._error = exc
            self._recording.set()
            self._done.set()
            return
        self._recording.set()
        try:
            self._stop.wait()
            prof.stop()  # recording -> the trace, exported by _export
        except BaseException as exc:  # noqa: BLE001 — reported by stop()
            self._error = exc
        finally:
            self._done.set()

    def stop(self) -> None:
        self._stop.set()
        if not self._done.wait(120):
            raise TimeoutError("torch.profiler did not stop within 120 s")
        if self._error is not None:
            raise self._error


class ProfilerCapture:
    """One-at-a-time deep capture: a torch.profiler trace of the device side
    and a HostStackSampler of the host side over the same window.
    `start(seconds)` returns the artifact paths once the profiler records; a
    daemon timer stops both and writes `host_stacks.json` (and the
    profiler's `trace_*.json`) into the artifact dir. A profiler that cannot
    start is recorded as `device_trace_error` and the host side still
    captures. Injectable device start/stop hooks keep tests
    deterministic."""

    MAX_SECONDS = 120.0
    # The profiler's warmup step before the window (_TorchTrace).
    WARMUP_S = 0.2

    def __init__(self, base_dir: str | None = None, device_start=None, device_stop=None):
        self.base_dir = base_dir
        self._device_start = device_start
        self._device_stop = device_stop
        self._lock = threading.Lock()
        self._active: dict | None = None
        self._trace: _TorchTrace | None = None

    def _torch_start(self, log_dir: str) -> None:
        self._trace = _TorchTrace(log_dir, self.WARMUP_S).start()

    def _torch_stop(self) -> None:
        trace, self._trace = self._trace, None
        if trace is not None:
            trace.stop()

    def status(self) -> dict:
        with self._lock:
            if self._active is None:
                return {"active": False}
            return {"active": True, **self._active}

    def start(self, seconds: float, host_interval_s: float = 0.02) -> dict:
        import tempfile

        seconds = min(max(float(seconds), 0.05), self.MAX_SECONDS)
        with self._lock:
            if self._active is not None:
                raise CaptureInProgressError(
                    "a profiler capture is already running "
                    f"({self._active.get('artifact_dir')})"
                )
            base = self.base_dir or os.path.join(tempfile.gettempdir(), "dts_tpu_profiles")
            os.makedirs(base, exist_ok=True)
            stamp = time.strftime("%Y%m%d-%H%M%S")
            artifact_dir = tempfile.mkdtemp(prefix=f"capture-{stamp}-", dir=base)
            info: dict = {
                "artifact_dir": artifact_dir,
                "seconds": seconds,
                "host_stacks": os.path.join(artifact_dir, "host_stacks.json"),
            }
            try:
                (self._device_start or self._torch_start)(artifact_dir)
                info["device_trace"] = True
            except Exception as exc:  # noqa: BLE001 — the host side still captures
                info["device_trace"] = False
                info["device_trace_error"] = f"{type(exc).__name__}: {exc}"[:300]
            sampler = HostStackSampler(interval_s=host_interval_s).start()
            self._active = dict(info)

        def finish():
            time.sleep(seconds)
            report = sampler.stop()
            if info.get("device_trace"):
                try:
                    (self._device_stop or self._torch_stop)()
                except Exception as exc:  # noqa: BLE001 — record, release the slot
                    info["device_trace_error"] = f"{type(exc).__name__}: {exc}"[:300]
            try:
                with open(info["host_stacks"], "w") as f:
                    json.dump(report, f, indent=1)
            except OSError:
                pass
            with self._lock:
                self._active = None

        threading.Thread(target=finish, name="profilez", daemon=True).start()
        return info


def prime_profiler() -> None:
    """Start and stop an empty CPU-activity torch.profiler on the calling
    thread. The profiler library finishes its process-wide setup on the
    first thread that starts it, and wants the thread that imported torch;
    a server calls this on its main thread before /profilez can start a
    capture from another."""
    import torch.autograd.profiler as autograd_profiler
    from torch.profiler import ProfilerActivity, profile

    if autograd_profiler._is_profiler_enabled:
        return
    with profile(activities=[ProfilerActivity.CPU]):
        pass


# The process-global capture slot (the profiler itself is process-global,
# so two REST gateways in one process share the refusal).
_CAPTURE = ProfilerCapture()


def profiler_capture() -> ProfilerCapture:
    return _CAPTURE
