"""Request-path tracing: aggregate phase timers and per-request span trees.

- **PhaseTrace / request_trace**: wall time per named phase, aggregated
  across requests (the /monitoring `phases` block). Always on: a lock and
  two clock reads per phase.
- **Span / start_span / start_root**: a span-tree recorder. A server opens
  a root span per RPC from the caller's W3C ``traceparent`` (so its tree
  shares the caller's trace id); the batcher's threads attach child
  intervals to an explicit handle instead of the contextvar.
- **TraceRecorder**: bounded in-memory retention with tail sampling —
  errors and annotated traces are always kept, the slowest-N are always
  kept, the rest are sampled. `/tracez` (serving/rest.py) serves it as
  JSON; `chrome_trace()` exports Chrome-trace-event JSON that Perfetto and
  chrome://tracing load.
- **collect_phases / replay_phases**: a thread-local sink that lets the
  batcher's request_trace call sites double as per-request span producers:
  one pair of clock reads feeds both the aggregate and the span tree.
- **annotate()**: attaches an annotation to the current span (or the
  active phase sink).
- **thread_cpu()**: CPU seconds so far per thread role (gRPC handlers,
  the batcher's three kinds of thread, other Python threads) and for the
  whole process, for a reader that differences two calls.

Per-request tracing is off by default and gated on one module bool: every
hook is a single global read while it is off. While it is on, a phase
timed in a block (`PhaseTrace.span`) also records the thread that ran it
and that thread's CPU seconds over the block, so work can be told apart
from waiting (for the GIL, a lock, the device). Span times are
perf_counter seconds; `clock_anchor()` pairs that clock with the wall
clock, which places them on another timeline (a torch.profiler trace:
ts_us = start_us - perf_us + unix_us - baseTimeNanoseconds / 1000). This
module's state is its own: the JAX package's tracing plane is a separate
module with separate state.
"""

from __future__ import annotations

import contextlib
import contextvars
import heapq
import itertools
import json
import os
import random
import threading
import time
import weakref
from collections import defaultdict, deque

# --------------------------------------------------------------------------
# Aggregate phase timing (the original plane).

_ENABLED = False  # per-request tracing; flipped by enable()/disable()


class PhaseTrace:
    """Accumulates wall time per named phase, aggregated across requests."""

    def __init__(self):
        self._totals: dict[str, float] = defaultdict(float)
        self._counts: dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, phase: str):
        """Time a block under `phase`; yields its start (perf_counter). One
        global read when per-request tracing is off; when it is on, the
        block's interval, thread and thread CPU seconds also become a child
        span of the active request context (_attach)."""
        traced = _ENABLED
        c0 = time.thread_time() if traced else 0.0
        t0 = time.perf_counter()
        try:
            yield t0
        finally:
            t1 = time.perf_counter()
            if traced:
                _attach(phase, t0, t1, time.thread_time() - c0)
            self._tally(phase, t1 - t0)

    def _tally(self, phase: str, seconds: float) -> None:
        with self._lock:
            self._totals[phase] += seconds
            self._counts[phase] += 1

    def snapshot(self) -> dict[str, dict]:
        with self._lock:
            return {
                phase: {
                    "total_ms": round(self._totals[phase] * 1e3, 3),
                    "count": self._counts[phase],
                    "mean_us": round(
                        self._totals[phase] / self._counts[phase] * 1e6, 1
                    ),
                }
                for phase in sorted(self._totals)
            }

    def reset(self) -> None:
        with self._lock:
            self._totals.clear()
            self._counts.clear()


def _attach(phase: str, t0: float, t1: float, cpu_s: float) -> None:
    """The per-request plane's half of a phase: the interval becomes a
    child span of whatever request context is active on this thread — the
    batcher's phase sink when one is installed (replayed onto every member
    of the batch), else the contextvar span (the service/REST handler
    threads) — with this thread's native id and name."""
    t = threading.current_thread()
    thread = (t.native_id, t.name)
    sink = getattr(_SINK, "phases", None)
    if sink is not None:
        sink.append((phase, t0, t1, thread, cpu_s))
    else:
        cur = _CURRENT.get()
        if cur is not None:
            cur.add_interval(phase, t0, t1, thread=thread, cpu_s=cpu_s)


# Process-wide default trace used by the serving path.
request_trace = PhaseTrace()


# --------------------------------------------------------------------------
# W3C trace context (the `traceparent` header, version 00).

_TRACEPARENT_VERSION = "00"


def make_traceparent(trace_id: str, span_id: str, sampled: bool = True) -> str:
    return f"{_TRACEPARENT_VERSION}-{trace_id}-{span_id}-{'01' if sampled else '00'}"


def parse_traceparent(header: str | None) -> tuple[str, str] | None:
    """(trace_id, parent_span_id) from a W3C traceparent, or None when the
    header is absent/malformed — a bad header must degrade to a fresh
    trace, never fail the request."""
    if not header:
        return None
    parts = header.strip().split("-")
    if len(parts) != 4:
        return None
    _version, trace_id, span_id, _flags = parts
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        if int(trace_id, 16) == 0 or int(span_id, 16) == 0:
            return None
    except ValueError:
        return None
    return trace_id.lower(), span_id.lower()


def _new_trace_id() -> str:
    return os.urandom(16).hex()


def _new_span_id() -> str:
    return os.urandom(8).hex()


def clock_anchor() -> dict:
    """Pair this process's span clock (perf_counter) with the wall clock,
    plus the pid, so an exported span tree can be placed on a shared
    fleet timeline: unix_us(span) = start_us - perf_us + unix_us. The two
    reads are not atomic; the fleet stitcher refines residual error from
    RPC send/recv pairs, so sub-millisecond anchor noise is acceptable."""
    return {
        "perf_us": int(time.perf_counter() * 1e6),
        "unix_us": time.time_ns() // 1000,
        "pid": os.getpid(),
    }


# --------------------------------------------------------------------------
# Spans.


class Span:
    """One timed operation in a request's tree.

    Timestamps are time.perf_counter() — monotonic, so exported Chrome
    events never go backwards even across NTP steps. Child mutation is
    list-append under the GIL plus an explicit lock for cross-thread
    attachment (the batcher's dispatch/completer threads attach to a span
    owned by an RPC handler).

    A phase span also knows the thread that ran it (`thread`: native id
    and name) and, when it was timed in a block, that thread's CPU
    seconds over it (`cpu_s`). An interval stitched from timestamps taken
    on other threads (a request's queue waits) is a `wait`: no thread, no
    CPU."""

    __slots__ = (
        "name", "trace_id", "span_id", "parent_id", "remote_parent",
        "start", "end", "status", "attrs", "annotations", "children",
        "thread", "cpu_s", "wait", "_lock",
    )

    def __init__(
        self,
        name: str,
        trace_id: str | None = None,
        parent_id: str | None = None,
        remote_parent: bool = False,
        attrs: dict | None = None,
    ):
        self.name = name
        self.trace_id = trace_id or _new_trace_id()
        self.span_id = _new_span_id()
        self.parent_id = parent_id
        self.remote_parent = remote_parent
        self.start = time.perf_counter()
        self.end: float | None = None
        self.status = "OK"
        self.attrs = dict(attrs) if attrs else {}
        self.annotations: list[dict] = []
        self.children: list[Span] = []
        self.thread: tuple[int, str] | None = None
        self.cpu_s: float | None = None
        self.wait = False
        self._lock = threading.Lock()

    # ------------------------------------------------------------- building

    def child(self, name: str, attrs: dict | None = None) -> "Span":
        """Open (started-now) child span; the caller ends it."""
        sp = Span(
            name, trace_id=self.trace_id, parent_id=self.span_id, attrs=attrs
        )
        with self._lock:
            self.children.append(sp)
        return sp

    def add_interval(
        self, name: str, start: float, end: float, attrs: dict | None = None,
        *, thread: tuple[int, str] | None = None, cpu_s: float | None = None,
        wait: bool = False,
    ) -> "Span":
        """Attach an already-timed child interval (the batcher's phase
        sink replay; safe from any thread): the thread that ran it and its
        CPU seconds where known, or `wait` for an interval between
        timestamps that other threads took."""
        sp = Span(
            name, trace_id=self.trace_id, parent_id=self.span_id, attrs=attrs
        )
        sp.start = start
        sp.end = end
        sp.thread = thread
        sp.cpu_s = cpu_s
        sp.wait = wait
        with self._lock:
            self.children.append(sp)
        return sp

    def annotate(self, message: str, **attrs) -> None:
        with self._lock:
            self.annotations.append(
                {"t": time.perf_counter(), "message": message, **attrs}
            )

    def set_error(self, exc: BaseException | None = None) -> None:
        self.status = "ERROR"
        if exc is not None:
            self.attrs.setdefault("error", f"{type(exc).__name__}: {exc}")

    def finish(self) -> None:
        if self.end is None:
            self.end = time.perf_counter()

    # -------------------------------------------------------------- reading

    @property
    def duration_s(self) -> float:
        return ((self.end if self.end is not None else time.perf_counter())
                - self.start)

    def has_error(self) -> bool:
        return self.status == "ERROR" or any(
            c.has_error() for c in self.children
        )

    def has_annotations(self) -> bool:
        return bool(self.annotations) or any(
            c.has_annotations() for c in self.children
        )

    def to_dict(self) -> dict:
        """The span tree as JSON; `tid` / `thread`, `cpu_us` and `wait`
        appear only on the spans that have them."""
        d = {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start_us": int(self.start * 1e6),
            "duration_us": int(self.duration_s * 1e6),
            "status": self.status,
            "attrs": self.attrs,
            "annotations": [
                {**a, "t": int(a["t"] * 1e6)} for a in self.annotations
            ],
            "children": [c.to_dict() for c in self.children],
        }
        if self.thread is not None:
            d["tid"], d["thread"] = self.thread
        if self.cpu_s is not None:
            d["cpu_us"] = int(self.cpu_s * 1e6)
        if self.wait:
            d["wait"] = True
        return d

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()


# Contextvar current span: propagates through asyncio tasks (context is
# captured at task creation) and stays per-thread in threaded servers.
_CURRENT: contextvars.ContextVar[Span | None] = contextvars.ContextVar(
    "dts_torch_current_span", default=None
)

# Thread-local phase sink for producers that run OUTSIDE the request's
# context (the batcher's dispatch/completer threads): a list of
# (phase, t0, t1, thread, cpu_s) tuples plus annotation dicts, replayed
# onto every co-batched request's span by the batcher.
_SINK = threading.local()


def current_span() -> Span | None:
    return _CURRENT.get()


def enabled() -> bool:
    return _ENABLED


class _NoopSpanCtx:
    """Returned by start_span/start_root when tracing is disabled: one
    shared instance, no allocation on the disabled hot path."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpanCtx()


class _SpanCtx:
    __slots__ = ("span", "_token", "_record")

    def __init__(self, span: Span, record: bool):
        self.span = span
        self._token = None
        self._record = record

    def __enter__(self) -> Span:
        self._token = _CURRENT.set(self.span)
        return self.span

    def __exit__(self, exc_type, exc, tb):
        _CURRENT.reset(self._token)
        if exc is not None:
            if isinstance(exc, Exception):
                self.span.set_error(exc)
            else:
                # BaseException-only exits (asyncio.CancelledError,
                # GeneratorExit, shutdown): not failures. Marking them
                # ERROR would roll up to the root, defeat tail sampling,
                # and report a cancelled request as an error in /tracez.
                self.span.status = "CANCELLED"
        self.span.finish()
        if self._record:
            _RECORDER.record(self.span)
        return False


def start_span(name: str, attrs: dict | None = None):
    """Child span of the current context span (a fresh local root when no
    context is set). Context manager yielding the Span; no-op when tracing
    is disabled."""
    if not _ENABLED:
        return _NOOP
    parent = _CURRENT.get()
    if parent is not None:
        sp = parent.child(name, attrs=attrs)
        return _SpanCtx(sp, record=False)
    return _SpanCtx(Span(name, attrs=attrs), record=True)


def start_root(name: str, traceparent: str | None = None, attrs: dict | None = None):
    """LOCAL-ROOT span: a fresh trace, or — when a valid W3C traceparent
    arrives — a remote-parented span in the caller's trace (the server
    side of a propagated request). Recorded into the global recorder on
    exit regardless of any ambient context."""
    if not _ENABLED:
        return _NOOP
    ctx = parse_traceparent(traceparent)
    if ctx is not None:
        sp = Span(
            name, trace_id=ctx[0], parent_id=ctx[1],
            remote_parent=True, attrs=attrs,
        )
    else:
        sp = Span(name, attrs=attrs)
    return _SpanCtx(sp, record=True)


def annotate(message: str, **attrs) -> None:
    """Attach an annotation to whatever request context is active: the
    thread's phase sink when installed (batcher threads — the batcher
    replays it onto every co-batched request), else the contextvar span.
    One global read when tracing is off."""
    if not _ENABLED:
        return
    sink = getattr(_SINK, "phases", None)
    if sink is not None:
        sink.append(
            {"t": time.perf_counter(), "message": message, **attrs}
        )
        return
    cur = _CURRENT.get()
    if cur is not None:
        cur.annotate(message, **attrs)


@contextlib.contextmanager
def collect_phases(sink: list):
    """Install `sink` as this thread's phase sink: request_trace phase
    timings (and annotate() calls) land in it as (phase, t0, t1, thread,
    cpu_s) tuples / annotation dicts until the block exits. The batcher
    uses one sink per batch and replays it onto every member request's
    span."""
    prev = getattr(_SINK, "phases", None)
    _SINK.phases = sink
    try:
        yield sink
    finally:
        _SINK.phases = prev


def replay_phases(span: Span, phases: list, attrs: dict | None = None) -> None:
    """Attach a collect_phases sink's contents to `span`: tuples become
    child intervals (each with `attrs`, the batcher's batch id, bucket and
    rows, so a reader counts a batch's work once however many members
    carry it), annotation dicts become annotations. A tuple may be a bare
    (phase, t0, t1)."""
    for entry in phases:
        if isinstance(entry, dict):
            span.annotations.append(dict(entry))
        else:
            name, t0, t1, *rest = entry
            thread, cpu_s = rest or (None, None)
            span.add_interval(name, t0, t1, attrs, thread=thread, cpu_s=cpu_s)


# --------------------------------------------------------------------------
# Counter-track sources for the Chrome export (a per-device occupancy
# track, for instance). Registered objects expose
# `chrome_counter_events(t_base, pid) -> list[dict]`; a WeakSet so a
# retired ledger (bench teardown, tests) drops out of every later export
# without an unregister call.

_COUNTER_SOURCES: "weakref.WeakSet" = weakref.WeakSet()


def register_counter_source(source) -> None:
    """Add a counter-track provider to every future chrome_trace()
    export. Weakly held: dropping the object deregisters it."""
    _COUNTER_SOURCES.add(source)


# --------------------------------------------------------------------------
# Recorder: bounded retention + tail sampling + exporters.


class TraceRecorder:
    """Bounded in-memory store of finished local-root spans.

    Tail sampling (decided at span END, when the outcome is known):

    - error spans (own or any descendant) and annotated spans (fault
      injections, degraded merges) are ALWAYS kept, in a dedicated ring;
    - the slowest `slowest_n` spans are ALWAYS kept (min-heap on
      duration), independent of the sample draw;
    - everything else enters the recent ring with probability
      `sample_rate` (1.0 and 0.0 never consult the RNG — deterministic
      for tests and for the keep-nothing-but-tails production setting).

    Rings are deques: retention is bounded regardless of traffic, and an
    idle server holds exactly what it last saw."""

    def __init__(
        self,
        buffer_size: int = 256,
        sample_rate: float = 1.0,
        slowest_n: int = 32,
        seed: int | None = None,
    ):
        self.buffer_size = max(1, int(buffer_size))
        self.sample_rate = float(sample_rate)
        self.slowest_n = max(0, int(slowest_n))
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._recent: deque[Span] = deque(maxlen=self.buffer_size)
        self._errors: deque[Span] = deque(maxlen=self.buffer_size)
        self._slow: list[tuple[float, int, Span]] = []  # min-heap
        self._seq = itertools.count()
        self.recorded = 0
        self.dropped = 0
        # Export ring (the fleet trace-export surface): every KEPT span
        # gets a monotonically increasing export sequence number, so a
        # remote collector can pull incrementally with a `since` cursor.
        # Bounded like the retention rings — a collector that falls more
        # than a ring behind misses spans, by design.
        self._export: deque[tuple[int, Span]] = deque(maxlen=self.buffer_size)
        self._export_seq = 0

    # ------------------------------------------------------------ ingestion

    def record(self, span: Span) -> None:
        keep_tail = span.has_error() or span.has_annotations()
        dur = span.duration_s
        with self._lock:
            self.recorded += 1
            kept = False
            if keep_tail:
                self._errors.append(span)
                kept = True
            evicted: Span | None = None
            if self.slowest_n:
                if len(self._slow) < self.slowest_n:
                    heapq.heappush(self._slow, (dur, next(self._seq), span))
                    kept = True
                elif dur > self._slow[0][0]:
                    evicted = heapq.heapreplace(
                        self._slow, (dur, next(self._seq), span)
                    )[2]
                    kept = True
            if self.sample_rate >= 1.0 or (
                0.0 < self.sample_rate and self._rng.random() < self.sample_rate
            ):
                self._recent.append(span)
                kept = True
            if kept:
                self._export_seq += 1
                self._export.append((self._export_seq, span))
            # dropped is APPROXIMATE: spans retained nowhere at record
            # time, plus heap evictions that had no tail claim when the
            # sampler was keeping less than everything. (An exact count
            # would need an O(buffer) ring-membership scan under this
            # lock on every heap replacement — a per-request critical
            # section not worth a diagnostics counter.)
            if not kept:
                self.dropped += 1
            if (
                evicted is not None
                and self.sample_rate < 1.0
                and not (evicted.has_error() or evicted.has_annotations())
            ):
                self.dropped += 1

    def clear(self) -> None:
        with self._lock:
            self._recent.clear()
            self._errors.clear()
            self._slow.clear()
            self._export.clear()
            self.recorded = 0
            self.dropped = 0

    # -------------------------------------------------------------- queries

    def _all_spans_locked(self) -> list[Span]:
        """Distinct retained roots, newest-first-stable (a span can sit in
        several rings; report it once)."""
        seen: set[int] = set()
        out: list[Span] = []
        for sp in itertools.chain(
            self._recent, self._errors, (s for _, _, s in self._slow)
        ):
            if id(sp) not in seen:
                seen.add(id(sp))
                out.append(sp)
        return out

    def spans(self) -> list[Span]:
        with self._lock:
            return self._all_spans_locked()

    def slowest(self, n: int | None = None) -> list[Span]:
        with self._lock:
            ordered = sorted(self._slow, key=lambda e: -e[0])
        return [s for _, _, s in ordered[: n or self.slowest_n]]

    def traces(self) -> list[dict]:
        """Retained local roots grouped by trace id — one entry per
        distributed trace, with every local root (client predict, each
        server RPC) as a tree under it."""
        return self._traces_from(self.spans())

    @staticmethod
    def _traces_from(roots: list[Span]) -> list[dict]:
        groups: dict[str, list[Span]] = {}
        for sp in roots:
            groups.setdefault(sp.trace_id, []).append(sp)
        out = []
        for trace_id, roots in groups.items():
            roots.sort(key=lambda s: s.start)
            out.append({
                "trace_id": trace_id,
                "duration_us": int(
                    (max(s.end or s.start for s in roots)
                     - min(s.start for s in roots)) * 1e6
                ),
                "status": (
                    "ERROR" if any(s.has_error() for s in roots) else "OK"
                ),
                "spans": [s.to_dict() for s in roots],
            })
        out.sort(key=lambda t: -t["duration_us"])
        return out

    def tracez(self, limit: int = 50) -> dict:
        """The /tracez JSON body: recorder config + counters, the
        slowest-N trees, and the most recent traces. ONE lock acquisition
        snapshots everything, so the counters and the serialized trace
        list cannot disagree within a response."""
        with self._lock:
            roots = self._all_spans_locked()
            slow_sorted = [
                s for _, _, s in sorted(self._slow, key=lambda e: -e[0])
            ]
            recorded, dropped = self.recorded, self.dropped
        return {
            "config": {
                "buffer_size": self.buffer_size,
                "sample_rate": self.sample_rate,
                "slowest_n": self.slowest_n,
            },
            "recorded": recorded,
            "dropped": dropped,
            "num_retained": len(roots),
            "slowest": [s.to_dict() for s in slow_sorted],
            "traces": self._traces_from(roots)[: max(1, int(limit))],
        }

    def export_since(self, since: int = 0, limit: int = 64) -> dict:
        """Incremental span-tree export for a remote TraceCollector
        (`GET /tracez/export?since=CURSOR`): every kept local root after
        `since`, as `Span.to_dict` trees, with this process's clock
        anchor so the collector can map perf_counter timestamps onto the
        shared wall-clock timeline. The returned `cursor` feeds the next
        call. A cursor AHEAD of the ring (this process restarted and the
        sequence reset) replays from the start instead of going silent."""
        since = max(0, int(since))
        with self._lock:
            if since > self._export_seq:
                since = 0
            pending = [(seq, sp) for seq, sp in self._export if seq > since]
        pending = pending[: max(1, int(limit))]
        return {
            "enabled": True,
            "clock": clock_anchor(),
            "cursor": pending[-1][0] if pending else since,
            "spans": [sp.to_dict() for _, sp in pending],
        }

    # ------------------------------------------------------------ exporters

    def chrome_trace(self) -> dict:
        """Chrome trace-event JSON (Perfetto / chrome://tracing loadable):
        one complete ("X") event per span with microsecond ts/dur, one
        instant ("i") event per annotation, grouped into one pid per trace
        with the span tree flattened onto tids by root. Monotonic by
        construction — ts derives from perf_counter."""
        events: list[dict] = []
        trace_pids: dict[str, int] = {}
        tid_counters: dict[int, int] = {}
        with self._lock:
            roots = self._all_spans_locked()
        # Stable base so every ts is a small non-negative number.
        t_base = min((s.start for s in roots), default=0.0)
        for root in sorted(roots, key=lambda s: s.start):
            pid = trace_pids.setdefault(root.trace_id, len(trace_pids))
            # One tid per local root inside its trace's pid (sibling RPC
            # attempts render as parallel tracks); O(1) per root — a full
            # export can hold hundreds of roots and runs on the event loop.
            tid = tid_counters.get(pid, 0)
            tid_counters[pid] = tid + 1
            events.append({
                "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": root.name},
            })
            for sp in root.walk():
                events.append({
                    "ph": "X",
                    "name": sp.name,
                    "cat": "span" if sp is root else "phase",
                    "pid": pid,
                    "tid": tid,
                    "ts": max(0, int((sp.start - t_base) * 1e6)),
                    "dur": max(0, int(sp.duration_s * 1e6)),
                    "args": {
                        "trace_id": sp.trace_id,
                        "span_id": sp.span_id,
                        "parent_id": sp.parent_id,
                        "status": sp.status,
                        **sp.attrs,
                    },
                })
                for a in sp.annotations:
                    events.append({
                        "ph": "i",
                        "name": a.get("message", "annotation"),
                        "cat": "annotation",
                        "pid": pid,
                        "tid": tid,
                        "ts": max(0, int((a["t"] - t_base) * 1e6)),
                        "s": "t",
                        "args": {
                            k: v for k, v in a.items()
                            if k not in ("t", "message")
                        },
                    })
        # Counter tracks (per-device occupancy from the utilization
        # ledger): appended on their own pids AFTER the span pids, sharing
        # t_base so the tracks align with the spans on the timeline.
        pid_next = len(trace_pids)
        for source in list(_COUNTER_SOURCES):
            try:
                events.extend(source.chrome_counter_events(t_base, pid_next))
                pid_next += 1
            except Exception:  # noqa: BLE001 — a sick source must not
                pass           # poison the whole export
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "recorded": self.recorded,
                "producer": "distributed_tf_serving_tpu_torch",
            },
        }

    def write_chrome_trace(self, path: str) -> int:
        """Serialize chrome_trace() to `path`; returns the event count."""
        doc = self.chrome_trace()
        with open(path, "w") as f:
            json.dump(doc, f)
        return len(doc["traceEvents"])


# Process-global recorder (the /tracez surface); enable() swaps config.
_RECORDER = TraceRecorder()


def recorder() -> TraceRecorder:
    return _RECORDER


def enable(
    buffer_size: int = 256,
    sample_rate: float = 1.0,
    slowest_n: int = 32,
    seed: int | None = None,
) -> TraceRecorder:
    """Turn the per-request plane on with a fresh recorder; returns it."""
    global _ENABLED, _RECORDER
    _RECORDER = TraceRecorder(
        buffer_size=buffer_size, sample_rate=sample_rate,
        slowest_n=slowest_n, seed=seed,
    )
    _ENABLED = True
    return _RECORDER


def disable() -> None:
    global _ENABLED
    _ENABLED = False


# --------------------------------------------------------------------------
# CPU seconds per thread role: with the GIL, how many cores' worth of
# Python runs, and which threads run it. Read only by a reader that
# differences two calls: nothing on the request path.

THREAD_ROLES = ("rpc", "batcher", "batch-dispatch", "batch-complete", "other")


def _thread_role(name: str) -> str:
    """A Python thread's role from the name the port gives it: the gRPC
    server's handler pool (`rpc_<n>`), the batching thread, the dispatch
    thread, the completion workers (`batch-complete_<n>`); else `other`."""
    if name == "batcher" or name == "batch-dispatch":
        return name
    if name.startswith("batch-complete"):
        return "batch-complete"
    if name.startswith("rpc_"):
        return "rpc"
    return "other"


def thread_cpu() -> dict[str, float]:
    """CPU seconds so far of this process's live Python threads, summed by
    role (THREAD_ROLES), and `process`: the whole process's CPU seconds
    (time.process_time, every thread, those that ended too). Native
    threads that never ran Python (gRPC core, CUDA) count only in
    `process`. Read through each thread's CPU clock
    (time.pthread_getcpuclockid); a thread that ends meanwhile is left
    out."""
    out = dict.fromkeys(THREAD_ROLES, 0.0)
    for t in threading.enumerate():
        if isinstance(t, threading._DummyThread) or t.ident is None:
            continue  # a foreign (native) thread that called into Python
        try:
            seconds = time.clock_gettime(time.pthread_getcpuclockid(t.ident))
        except (OSError, AttributeError):
            continue
        out[_thread_role(t.name)] += seconds
    out["process"] = time.process_time()
    return out
