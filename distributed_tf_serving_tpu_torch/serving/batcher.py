"""Dynamic batching engine (core): queue, coalescing, bucket padding, the
host pack into one pinned buffer, one upload, the device step, an async
readback and per-request completion.

- **Padded candidate buckets.** Work is padded up to a fixed bucket ladder,
  so the device step sees a handful of shapes, each warmed at load.
- **Request coalescing.** Concurrent requests for the same servable are
  concatenated along the candidate axis into one device call (up to the
  largest bucket, waiting at most `max_wait_us` after the first), then
  split back per request.
- **One combined buffer, one copy.** A batch's inputs are packed into ONE
  uint8 host buffer (ops/transfer.py combined layout: u24 ids, bf16 or f32
  weights, back to back), taken from a ring of pinned buffers, and uploaded
  with one non-blocking copy; the device unpacks it. For the bf16 layout
  ({feat_ids: u24, feat_wts: bf16}) the native `pack_batch_u24_bf16`
  (native/hostops.cc) folds, packs, casts and pads the whole coalesced
  batch in one pass straight into the pinned buffer; other layouts fold
  (exact int64 modulo) and pack through `pack_host_combined`. Inputs the
  combined layout cannot carry (8-byte dtypes) take the per-key path, one
  copy per input.
- **The device step.** For dcn_v2 on a CUDA device it is the fused serve
  kernel (ops/cross_kernel.py build_fused_serve), prepared once per
  servable. Other models, and the CPU, run `model.apply`. With the kernel
  plane armed (`kernels`, ops/autotune.py) the per-bucket decision picks
  the step instead: model.apply or the fused kernel, on the float or the
  int8 params, with model.apply on the float params as the baseline.
- **The pipeline.** The batching thread collects, coalesces and pads (or,
  for the native pack, only gathers the parts). One dispatch thread runs
  pack, upload, device step and readback issue: a non-blocking copy of the
  outputs into pinned host buffers followed by a CUDA event. Up to
  `pipeline_depth - 1` assembled groups wait staged between the two
  threads. A pool of `completion_workers` threads waits for each event,
  slices the outputs per request and completes the futures, so the
  dispatch thread goes on to the next batch while a readback is in flight.
  Upload, step and readback run in order on the dispatch thread's current
  stream, so the readback needs no cross-stream synchronization.
- **The readback wire.** Between the step and the readback issue the
  outputs are shaped on the device (ops/transfer.py): float32 outputs
  downcast to `output_wire_dtype` (bf16, f16, or int8 with its (scale,
  min) sidecars), or, for a single request that asked for exactly the
  score output, only its `output_top_k` best (score, index) pairs. The
  completion worker widens them back to float32 on the host; no sidecar
  reaches a result.
- **Graph-executor models** (interop/graph_exec.py): raw int64 ids (the
  model does not fold on the host) reach `model.apply` per padded bucket
  through the per-key path; a model that `needs_x64` keeps float64 inputs,
  sends no combined buffer and reads back full-precision outputs, with no
  top-k and no prune.
- **Solo items.** A streamed sub-batch (`submit(..., _solo=True)`) is its
  own batch: the coalescer neither adds it to a group nor adds to it.
- **The cascade's prune** (`submit(..., _prune_k=k)`, serving/cascade.py):
  a solo request that asked for the score output alone reads back its k
  best (score, index) pairs and its whole score vector
  (ops/transfer.py cascade_prune_device), skipping the row cache and
  dedup as top-k batches do; its score cache key is salted with the k.
- **Thread death.** An exception that escapes the batching thread, the
  dispatch thread or a completion worker is recorded as BatcherThreadDead:
  the batch that thread held, every queued item and every staged group
  fail with it at once, and every later submit raises it. With the
  recovery plane armed, the batch goes back to the queue's front instead
  and the death is handed to the plane, which revives the thread
  (`revive_batching_thread`) and replays the queue.
- **The recovery plane** (serving/recovery.py): with `recovery` set, a
  batch whose failure is device-fatal (the `device_lost` / `executor_abort`
  fault sites, a sticky CUDA error, an integrity verdict) is handed to
  the controller (`take_group`) instead of failing its requests; while it
  quarantines, `submit` refuses new work (DeviceQuarantinedError; warmup is
  exempt). Its surface here: `wedge_age` (the breaker's clock),
  `capture_for_recovery` (every accepted, unanswered item out of the
  queue, the staged groups, the device stage and the in-flight batches,
  with their counts and the wedge clock settled, and the row cache's
  flights failed), `requeue_for_replay` (back at the queue's front),
  `replace_workers_for_recovery` (a new dispatch thread under a new
  generation, whose predecessor's late bookkeeping is ignored, and a new
  completion pool) and `revive_batching_thread`. A captured batch's late
  result or failure is dropped (stats.recovery_dropped). The coalescer
  merges a bisection half only with its own half (`bisect_key`).
- **Phases and spans.** Each stage is timed into utils/tracing.py's
  `request_trace` (always on) under the JAX package's phase names:
  `batch.pad` (padding a group on the batching thread, when the native
  pack does not take it), `batch.dispatch` (the whole device stage),
  inside it `batch.fusedpack` (the native pack into the pinned ring) or
  `batch.hostpack` (`pack_host_combined`, the pack of every other layout,
  such as DLRM's three inputs; inside `batch.cache` on a cache miss),
  `batch.jitcall` (the upload, the unpack and the device step's launch,
  with DLRM's `batch.interact` kernel launch inside it)
  and `readback.issue` (the readback wire's transform and the D2H copies),
  and `readback.wait` (the event wait and the restore on a completion
  worker). With per-request tracing on, a submit carries the caller's
  span; each batch collects its phases in a sink, and they are replayed
  onto every member's span, with the member's own `batch.queue_wait`.
- **The wedge circuit breaker.** A batch stuck in the device stage or
  awaiting its readback for more than `breaker_timeout_s` opens the
  breaker: a new submit fails at once with DeviceWedgedError (UNAVAILABLE
  at the RPC layer) and sheds the backlog (queued items and staged groups)
  with it. It closes by itself once the stuck batch completes. An
  all-warmup group (`warmup_via_queue`) does not start the clock; the
  direct `_execute` of `warmup` and the autotune never enters it.
- **The in-flight window.** `inflight_window > 0` bounds the live batches
  executing or awaiting readback: at the bound the dispatch thread waits
  (5 ms polls, lifted by a wedge) before issuing the next batch.
- **The pad buffer ring.** With `buffer_ring`, the padded arrays of the
  `batch.pad` path are written into recycled host buffers, returned once
  the batch's readback event has completed (never while a copy may still
  read them), or on a failure before the device stage.
- **The device input cache** (`DeviceInputCache`, on by default): a batch
  whose host bytes repeat feeds the device buffer its first upload made to
  the step, with no pack and no copy (`batch.cache`, with a miss's pack and
  upload inside; `batch.fusedpack` while it is off or bypassed).
- **The cache plane** (cache/): with a `score_cache`, `submit` answers a
  repeated request from the store before admission (`cache.lookup`) and
  identical concurrent misses ride one computation, whose completion fills
  it (`cache.fill`); with a `row_cache`, each collected batch looks its rows
  up (`cache.row_lookup`), executes only the cold ones in their own bucket,
  fills them (`cache.row_fill`) and scatters executed, cached and other
  batches' rows back per request; with `dedup`, a batch's identical rows
  execute once (`batch.dedup`). A failure aborts the batch's row flights.
- **The overload plane** (serving/overload.py): with an `overload`
  controller, `submit` asks it for admission (criticality lane, adaptive
  limit, doomed-work refusal) in place of the static
  `queue_capacity_candidates` bound, and a refusal raises
  AdmissionRefusedError with a retry-after hint; each dispatch feeds it the
  group's queue waits and each completed batch its service time (stage
  start to the readback's event). Past NOMINAL, the score cache and the
  row cache answer entries up to its stale window past their TTL, marked
  degraded (serving/overload.py mark_degraded, or `dts_degraded` on the
  future) and never refilled.
- **The integrity plane** (serving/integrity.py): with `integrity` set, a
  sampled batch runs a second time through the same device stage (same
  servable, bucket and kernel variant) under `batch.shadow_dispatch`, into
  its own host buffers (its packs, copies and input-cache reads counted
  apart, in the shadow_* stats), and the completion worker compares the
  two raw readbacks bit for bit before anything is widened or scattered (a
  mismatch fails the batch with OutputCorruptError); then the readback
  screen fails a request whose score rows are NaN/Inf (IntegrityScreenError)
  while its batchmates deliver.
- **The utilization plane** (serving/utilization.py): with a
  `utilization` ledger, each completed batch records (stage start,
  readback issued, readback seen complete), each non-warmup batch raises
  the depth gauge from its stage start to its end on every path, each
  refusal at admission is a shed, and the idle waits are recorded by cause:
  `queue_empty` (_take), `host_pack` (the coalescing wait), `readback_wait`
  (the pipeline_depth backpressure and the in-flight window).
- **The quality plane** (serving/quality.py): with a `quality` monitor,
  the completion worker feeds each non-warmup request's delivered scores
  before its future completes, except for a batch with a screened row, a
  top-k or prune readback and a mixed row-cache assembly.
- **Fault sites** (faults.py): `batcher.dispatch` before a batch's device
  stage, then `device_lost` once per member (keyed by `poison_fault_key`,
  only while a rule names it), `readback` and `executor_abort` before a
  completion worker waits for its readback, `readback_bitflip` and
  `score_nan` on the raw readback (keyed the same way), `pressure` in the
  overload controller.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import itertools
import logging
import threading
import time
import weakref
from collections import OrderedDict, deque
from concurrent.futures import BrokenExecutor, Future, InvalidStateError, ThreadPoolExecutor

import numpy as np
import torch

from .. import faults, native
from ..cache import CoalescedLeaderCancelled, canonical_rows, collapse_rows
from ..models.base import resolve_device
from ..models.registry import Servable
from ..ops.transfer import (
    combined_layout,
    combined_nbytes,
    combined_supported,
    compact_outputs_device,
    is_wire_sidecar,
    pack_host,
    pack_host_combined,
    restore_outputs_host,
    to_device,
    cascade_prune_device,
    cascade_restore_host,
    topk_compact_device,
    topk_restore_host,
    transfer_spec,
    unpack_device,
    unpack_device_combined,
)
from ..ops.transfer import output_wire_dtype as wire_dtype_of
from ..utils import tracing
from ..utils.tracing import request_trace
from . import overload as overload_mod
from .integrity import IntegrityScreenError

log = logging.getLogger("dts_torch.batcher")

DEFAULT_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048, 4096)

# Bound on each of stop()'s waits (threads, readbacks in flight).
_STOP_TIMEOUT_S = 60.0

# DataType -> numpy dtype for synthesizing warmup batches (types.proto).
_WARMUP_DTYPES = {1: np.float32, 2: np.float64, 3: np.int32, 9: np.int64}


class BatchTooLargeError(ValueError):
    pass


class BatcherThreadDead(RuntimeError):
    """A batcher-owned thread (the batching loop, the dispatch thread or a
    completion worker) died from an exception that escaped its body. Every
    queued and staged waiter fails with it at once and every later submit
    raises it up front, so no caller waits out its deadline for a thread
    that no longer exists. UNAVAILABLE at the RPC layer (the RuntimeError
    mapping). With the recovery plane armed the death is handed to it
    instead: the thread is revived and the work it held is replayed."""


class QueueOverloadError(RuntimeError):
    """Queue admission refused: accepting more work would only build a
    backlog no deadline survives (RESOURCE_EXHAUSTED at the RPC layer)."""


class AdmissionRefusedError(QueueOverloadError):
    """The overload plane (serving/overload.py) refused this request:
    capacity or lane shedding (`reason` "shed") or doomed work ("doomed":
    the backlog's estimated wait already exceeds the request's remaining
    deadline). Carries the retry-after-ms hint the RPC layer forwards;
    RESOURCE_EXHAUSTED like its base class."""

    def __init__(self, message: str, reason: str = "shed", retry_after_ms: int | None = None):
        super().__init__(message)
        self.reason = reason
        self.retry_after_ms = retry_after_ms


class RequestDeadlineError(TimeoutError):
    """Queued work whose client deadline expired before dispatch: shed
    instead of executed (DEADLINE_EXCEEDED at the RPC layer)."""


class DeviceWedgedError(RuntimeError):
    """Circuit breaker open: a dispatched batch has been stuck past the
    wedge threshold, so the device is presumed hung. New work fails fast
    (UNAVAILABLE) instead of holding a caller for the full RPC deadline;
    the breaker closes by itself the moment the stuck batch completes."""


class DeviceQuarantinedError(DeviceWedgedError):
    """The recovery plane (serving/recovery.py) has quarantined this
    replica: the device executor is being rebuilt, or its CUDA context is
    lost, so new work fails fast (UNAVAILABLE: clients reroute) while the
    work already accepted rides the replay path. A DeviceWedgedError, so
    every mapping of that error holds."""


class PoisonedInputError(ValueError):
    """This request's input deterministically kills the device executor:
    the recovery plane's bisection replayed ever smaller sub-batches and
    isolated it. INVALID_ARGUMENT at the RPC layer (do not retry these
    bytes anywhere), while the batchmates it took down answer."""


def bucket_for(n: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise BatchTooLargeError(f"candidate count {n} exceeds largest bucket {buckets[-1]}")


def poison_fault_key(arrays: dict) -> str:
    """Content digest of one request's prepared input arrays (the bytes
    _WorkItem.arrays holds: after prepare_inputs, before the fold): the
    `key` the device_lost, readback_bitflip and score_nan fault sites fire
    with once per batch member. The JAX package's digest, byte for byte, so
    one DTS_TPU_FAULTS string keys the same payload on both servers."""
    h = hashlib.blake2b(digest_size=8)
    for name in sorted(arrays):
        arr = np.ascontiguousarray(arrays[name])
        h.update(name.encode())
        h.update(arr.view(np.uint8).data)
    return h.hexdigest()


def _inject_readback_corruption(raw: dict, group: list) -> dict:
    """The readback_bitflip and score_nan fault sites, fired once per member
    request with its poison_fault_key, on the raw readback (numpy views of
    the host buffers after the event wait, before the shadow compare, the
    widen and the screen), as the JAX package does: a rule that fires flips
    the lowest bit of the member's first score element, or sets its score
    rows to NaN (a float wire only; another dtype gets the flip). The error
    kind is a marker, caught here. Returns `raw` with the score array
    replaced by a corrupted copy when a rule fired."""
    fi = faults.get()
    score_key = group[0].servable.model.score_output
    scores = raw.get(score_key)
    if scores is None:
        return raw
    corrupted = None
    off = 0
    for it in group:
        sl = slice(off, off + it.n)
        off += it.n
        key = poison_fault_key(it.arrays)
        for site in ("readback_bitflip", "score_nan"):
            if not fi.has_site(site):
                continue
            try:
                fi.fire(site, key=key)
            except faults.InjectedFaultError:
                if corrupted is None:
                    corrupted = np.ascontiguousarray(scores).copy()
                if site == "score_nan" and corrupted.dtype.kind == "f":
                    corrupted[sl] = np.nan
                else:
                    flat = corrupted.reshape(-1).view(np.dtype(f"u{corrupted.dtype.itemsize}"))
                    stride = max(corrupted.size // max(len(scores), 1), 1)
                    flat[sl.start * stride] ^= 1
    if corrupted is not None:
        raw = dict(raw)
        raw[score_key] = corrupted
    return raw


def _raw_numpy(t: torch.Tensor) -> np.ndarray:
    """A host tensor's bytes as a numpy view (no copy); bf16, which numpy
    lacks, as uint16."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _raw_tensor(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """Inverse of _raw_numpy for a (corrupted) copy."""
    if like.dtype == torch.bfloat16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def fold_ids_host(ids: np.ndarray, vocab_size: int) -> np.ndarray:
    """Exact int64 modulo fold on the host, into [0, vocab) (the native
    one-pass fold when the library is loaded, numpy remainder otherwise;
    bit-identical); models re-fold idempotently."""
    return native.fold_ids(ids, vocab_size)


def _immutably_backed(arr: np.ndarray) -> bool:
    """True only when the array's ultimate buffer is a `bytes` object (the
    serving path's np.frombuffer views over protobuf bytes)."""
    a = arr
    while isinstance(a.base, np.ndarray):
        a = a.base
    b = a.base
    if isinstance(b, memoryview):
        b = b.obj
    return isinstance(b, bytes)


def prepare_inputs(arrays: dict[str, np.ndarray], needs_x64: bool = False) -> dict[str, np.ndarray]:
    """Host-side normalization at submit. Every output array is owned or
    immutable, so a caller mutating its array after submit() cannot race
    the batch that reads it. Ids stay unfolded here: the whole padded batch
    is folded at once when it is dispatched. float64 inputs are cast to
    float32 unless the model `needs_x64` (a graph executor with DT_DOUBLE
    inputs must see the doubles it was exported with)."""
    out = {}
    for key, arr in arrays.items():
        if arr.dtype == np.float64 and not needs_x64:
            out[key] = arr.astype(np.float32)
        elif _immutably_backed(arr):
            out[key] = arr
        else:
            out[key] = arr.copy()
    return out


@dataclasses.dataclass(eq=False)
class _WorkItem:
    servable: Servable
    arrays: dict[str, np.ndarray]
    n: int
    output_keys: tuple[str, ...] | None
    future: Future
    enqueue_t: float
    deadline_t: float | None = None
    solo: bool = False  # a streamed sub-batch: never coalesced
    warmup: bool = False  # warmup_via_queue's: exempt from the wedge clock and the window
    # The submitting RPC's span (utils/tracing.Span) while per-request
    # tracing is on: the batch's phases are replayed onto it. None =
    # untraced.
    span: object = None
    prune_k: int = 0  # > 0: the cascade's stage-1 prune (submit's _prune_k)
    criticality: str | None = None  # the x-dts-criticality lane (the quality plane's label)
    # The recovery plane: re-dispatches by the replay path, device
    # executors its batches killed, and during a bisection the half it
    # belongs to (the coalescer merges only equal keys).
    replays: int = 0
    device_kills: int = 0
    bisect_key: int | None = None


def _phase_sink(group: list[_WorkItem]) -> list | None:
    """A fresh phase sink for one batch, or None when no member is traced
    (then each phase feeds only the aggregate)."""
    if tracing.enabled() and any(it.span is not None for it in group):
        return []
    return None


def _sink_ctx(phases: list | None):
    return tracing.collect_phases(phases) if phases is not None else contextlib.nullcontext()


def _replay(group: list[_WorkItem], phases: list | None, batch: int, bucket: int,
            rows: int) -> None:
    """Attach a batch's phases to every traced member's span: the batch's
    work was each member's work. Each phase carries the batch's id, bucket
    and real row count, so a reader counts the batch once."""
    if phases:
        attrs = {"batch": batch, "bucket": bucket, "rows": rows}
        for it in group:
            if it.span is not None:
                tracing.replay_phases(it.span, phases, attrs)


@dataclasses.dataclass
class BatcherStats:
    batches: int = 0
    requests: int = 0
    candidates: int = 0
    padded_candidates: int = 0
    fused_batches: int = 0
    deadline_sheds: int = 0
    # Device stage (live batches and direct _execute calls alike): batches
    # packed by the native pack_batch_u24_bf16, and host-to-device copies
    # made (one per batch through the combined buffer, one per input on
    # the per-key path).
    native_packs: int = 0
    h2d_copies: int = 0
    # Readback overlap: per batch, `window` spans readback issue -> outputs
    # on the host, `blocked` how long the waiting thread stalled in it.
    readback_window_s: float = 0.0
    readback_blocked_s: float = 0.0
    # The readback wire (live batches): batches read back as top-k pairs,
    # the bytes the D2H copies moved, and what a float32 readback of every
    # output of the step would have moved (the compaction's baseline).
    topk_batches: int = 0
    bytes_downloaded: int = 0
    # The cascade's stage-1 prune: batches read back as survivor pairs and
    # the stage-1 vector, and prune submits whose prune could not arm (they
    # read back their plain outputs; the cascade prunes on the host).
    prune_batches: int = 0
    prune_fallback_batches: int = 0
    bytes_download_full_f32: int = 0
    # High-water marks: items waiting in the queue, and batches handed to
    # the completion workers at once.
    max_queue_depth: int = 0
    inflight_peak: int = 0
    # Episodes in which the dispatch thread waited for the in-flight window.
    inflight_window_waits: int = 0
    # The cache plane: batches whose rows held exact duplicates, and the
    # rows never executed because of it (dedup); batches that went through
    # the row cache, the rows they asked for against the rows dispatched,
    # and batches answered from the row cache alone (no device work).
    dedup_batches: int = 0
    dedup_rows_collapsed: int = 0
    row_batches: int = 0
    rows_requested: int = 0
    rows_executed: int = 0
    row_full_hit_batches: int = 0
    # The integrity plane: batches run a second time for the shadow
    # compare, and those whose second upload was a DeviceInputCache hit
    # (the compare then covers the kernel and the readback, not the copy).
    # The shadow's own device stage is counted here, not in the fields
    # above: its native packs (none: it packs the rebuilt padded arrays),
    # host-to-device copies and fused batches. Its upload reads the input
    # cache without filling it or moving its counts.
    shadow_batches: int = 0
    shadow_input_cache_hits: int = 0
    shadow_native_packs: int = 0
    shadow_h2d_copies: int = 0
    shadow_fused_batches: int = 0
    # The recovery plane: late results and failures of batches a capture
    # took (the replay answers them), dropped.
    recovery_dropped: int = 0

    @property
    def mean_occupancy(self) -> float:
        return self.candidates / self.padded_candidates if self.padded_candidates else 0.0

    @property
    def mean_requests_per_batch(self) -> float:
        return self.requests / self.batches if self.batches else 0.0

    @property
    def download_compaction_ratio(self) -> float:
        """A float32 readback of every output over the bytes read back (>= 1)."""
        if not self.bytes_downloaded:
            return 0.0
        return self.bytes_download_full_f32 / self.bytes_downloaded

    @property
    def readback_overlap_fraction(self) -> float:
        """Share of the readback window nobody blocked on: 1.0 means the
        copy was done before a completion worker came to wait for it."""
        if self.readback_window_s <= 0:
            return 0.0
        return max(0.0, 1.0 - self.readback_blocked_s / self.readback_window_s)


@dataclasses.dataclass
class _Entry:
    fn: object  # (params, batch) -> outputs
    spec: dict[str, str]
    fused: bool
    native_pack: bool  # bf16 layout packed by native.pack_batch_u24_bf16


@dataclasses.dataclass(eq=False)
class _FusedCtx:
    """A batch for the native pack: the requests' own arrays, unpadded."""

    layout: tuple
    vocab: int
    fields: int
    ids_parts: list
    wts_parts: list


@dataclasses.dataclass(eq=False)
class _Staged:
    """An assembled group waiting for the dispatch thread."""

    group: list
    total: int
    bucket: int
    src: object  # _FusedCtx or padded arrays
    keys: tuple[str, ...] | None
    collected_t: float
    topk: int = 0  # > 0: read back the top-k pairs of the one request
    prune: bool = False  # the top-k read back as a cascade prune (cascade_prune_device)
    phases: list | None = None  # the batch's phase sink (_phase_sink)
    batch_id: int = 0  # its id on the traced members' spans (0: untraced)
    pad_bufs: list = dataclasses.field(default_factory=list)  # from the pad ring
    seq: int | None = None  # its key in _inflight_since while a live readback is out
    # The utilization ledger whose depth gauge this batch raised (captured
    # per batch, so the plane may be detached while it is in flight), until
    # _util_done lowers it.
    util: object = None
    # Dedup: the executed (unique) row of each original row.
    scatter: np.ndarray | None = None
    row_ctx: _RowContext | None = None  # the row cache's plan for this batch
    # Taken by a recovery capture while in the device stage or in flight:
    # its late result or failure is dropped (the replay answers it) and
    # its counts were settled by the capture.
    captured: bool = False
    gen: int = 0  # the generation of the dispatch thread that runs it
    # (elastic run_fn, issue token) of its dispatch until closed
    # (_close_run_token).
    run_token: tuple | None = None


@dataclasses.dataclass(eq=False)
class _Readback:
    """One batch between readback issue and its host outputs."""

    out: dict  # key -> (ring buffer, host view of it)
    event: object  # torch.cuda.Event after the copies; None on the CPU
    issue_t: float
    stage_t: float = 0.0
    # When the completion worker saw the readback event complete (not when
    # the kernel ended), and how long it blocked on it.
    ready_t: float = 0.0
    wait_s: float = 0.0
    nbytes: int = 0  # bytes the copies move
    full_f32_bytes: int = 0  # a float32 readback of every output of the step
    topk: tuple | None = None  # (request rows, score key) of a top-k readback
    prune: bool = False  # that top-k readback is a cascade prune
    input_cache_hit: bool = False  # the upload was a DeviceInputCache hit
    variant: tuple = (False, False)  # (quantized, fused): the kernel the batch ran
    shadow: _Readback | None = None  # the integrity plane's second run of the batch
    full_precision: bool = False  # an x64 model's outputs: no wire downcast
    custom: bool = False  # a run_fn's outputs, on the run_fn's own wire


class _HostBufferRing:
    """Reusable host buffers of the device stage, by size: pinned on the
    card (so one non-blocking copy moves a batch), ordinary memory on the
    CPU. Allocating pinned memory costs far more than copying a batch, so
    the ring is what makes the single copy pay.

    A buffer goes back with the CUDA event recorded after the copy that
    reads or writes it, and `acquire` waits on that event before handing
    it out again, so a buffer is never rewritten while a copy may still
    read it. At most `per_size` free buffers are kept per size, and free
    buffers of at most `max_sizes` sizes (the least recently used size goes
    first: the cascade's prune reads back a new size for each survivor
    count); an acquire beyond them allocates, the surplus is dropped on
    release.

    `keep` (set by the recovery plane) drops nothing: torch aborts the
    process when a pinned buffer that a copy used is freed once a sticky
    CUDA error has killed the context (the free records an event on that
    copy's stream), so a replica that must outlive such an error keeps
    every buffer it allocated, and one whose event query fails goes back
    to the ring before the error is raised."""

    def __init__(self, pinned: bool):
        self.pinned = pinned
        self.per_size = 4
        self.max_sizes = 64
        self.keep = False
        self._free: OrderedDict[int, deque] = OrderedDict()
        self._lock = threading.Lock()
        self.reuses = 0
        self.allocs = 0
        self.waits = 0  # acquires that waited for a copy still in flight

    def acquire(self, nbytes: int) -> torch.Tensor:
        with self._lock:
            free = self._free.get(nbytes)
            entry = free.popleft() if free else None
            if entry is None:
                self.allocs += 1
            else:
                self.reuses += 1
                self._free.move_to_end(nbytes)
        if entry is None:
            return torch.empty(nbytes, dtype=torch.uint8, pin_memory=self.pinned)
        buf, event = entry
        if event is not None:
            try:
                if not event.query():
                    with self._lock:
                        self.waits += 1
                    event.synchronize()
            except RuntimeError:
                if self.keep:
                    with self._lock:
                        self._free.setdefault(nbytes, deque()).appendleft(entry)
                raise
        return buf

    def release(self, bufs, event=None) -> None:
        with self._lock:
            for b in bufs:
                free = self._free.get(b.numel())
                if free is None:
                    if len(self._free) >= self.max_sizes and not self.keep:
                        self._free.popitem(last=False)
                    free = self._free[b.numel()] = deque()
                if len(free) < self.per_size or self.keep:
                    free.append((b, event))

    def snapshot(self) -> dict:
        with self._lock:
            return {"reuses": self.reuses, "allocs": self.allocs, "waits": self.waits,
                    "free_buffers": sum(len(v) for v in self._free.values())}


class _PadBufferRing:
    """Recycled numpy buffers of the `batch.pad` path ([batching]
    buffer_ring), by (shape, dtype): a padded group is written into an
    acquired buffer (rows, then a zero tail) instead of a fresh
    np.concatenate. A buffer goes back only once its batch's readback event
    has completed (that event follows the upload on the same stream), or on
    a failure before the device stage, so no copy can still read it. At
    most `per_key` free buffers are kept per key; the surplus is dropped."""

    def __init__(self, per_key: int):
        self.per_key = per_key
        self._free: dict[tuple, list[np.ndarray]] = {}
        self._lock = threading.Lock()
        self.reuses = 0
        self.allocs = 0

    def acquire(self, shape: tuple, dtype) -> np.ndarray:
        key = (shape, np.dtype(dtype).str)
        with self._lock:
            free = self._free.get(key)
            if free:
                self.reuses += 1
                return free.pop()
            self.allocs += 1
        return np.empty(shape, dtype)

    def release(self, arrs) -> None:
        with self._lock:
            for a in arrs:
                free = self._free.setdefault((a.shape, a.dtype.str), [])
                if len(free) < self.per_key:
                    free.append(a)

    def snapshot(self) -> dict:
        with self._lock:
            return {"reuses": self.reuses, "allocs": self.allocs,
                    "free_buffers": sum(len(v) for v in self._free.values())}


class DeviceInputCache:
    """Content-addressed LRU of uploaded batch inputs: the device tensor
    a batch's one upload produced, keyed by a digest of the host bytes it
    was packed from. CTR traffic re-scores the same candidate sets (the
    reference client re-sends one payload for every request), so a batch
    whose bytes repeat skips the pack, the ring buffer and the upload: the
    device step reads the cached tensor, which it never writes.

    A miss costs one content digest (native.hash128 when the host ops are
    built, blake2b otherwise) beside the pack and upload it needed anyway;
    a hit costs the digest alone. What either costs on a card is measured
    by chip_smoke.py's `cache` phase. Capacity is bounded by entry count,
    with least-recently-used eviction.

    Traffic that never repeats would pay the digest for nothing, so the
    cache bypasses itself, and re-probes: the hit rate is tracked over a
    sliding window of `probe_window` lookups; a window below
    `min_hit_rate` stops the hashing and drops the entries, and after
    `reprobe_every` bypassed lookups the cache probes again, so traffic
    that turns repetitive re-engages it."""

    def __init__(self, max_entries: int = 64, probe_window: int = 64,
                 min_hit_rate: float = 0.02, reprobe_every: int = 512):
        self.max_entries = max_entries
        self.probe_window = probe_window
        self.min_hit_rate = min_hit_rate
        self.reprobe_every = reprobe_every
        self._lru: OrderedDict[tuple, torch.Tensor] = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.bytes_skipped = 0
        self.bypassed = False
        self.bypass_cycles = 0
        self._win_hits = 0
        self._win_lookups = 0
        self._bypassed_lookups = 0

    def rearm(self) -> None:
        """Leave the bypass now and restart the probe cycle, for a caller
        that knows the traffic changed (a phase of a benchmark, a cutover)."""
        with self._lock:
            self.bypassed = False
            self._bypassed_lookups = 0
            self._win_hits = 0
            self._win_lookups = 0

    def _note_bypassed(self) -> None:
        """Count a lookup made in bypass; probe again every reprobe_every."""
        with self._lock:
            self._bypassed_lookups += 1
            if self._bypassed_lookups >= self.reprobe_every:
                self._bypassed_lookups = 0
                self._win_hits = 0
                self._win_lookups = 0
                self.bypassed = False

    @staticmethod
    def _key(name: str, arr: np.ndarray) -> tuple:
        if native.available():
            digest = native.hash128(arr)
        else:
            # A uint8 view: the digest is over the raw bytes.
            digest = hashlib.blake2b(
                np.ascontiguousarray(arr).view(np.uint8).data, digest_size=16).digest()
        return (name, arr.shape, arr.dtype.str, digest)

    def get_or_put(self, name: str, arr: np.ndarray, build, pack_tag: str = "") -> torch.Tensor:
        """The device tensor of `arr`'s content; `build(keep)` packs and
        uploads it on a miss (keep: the cache will hold the result).
        `pack_tag` names the packing, so the same raw bytes packed two ways
        occupy two entries."""
        if self.bypassed:
            self._note_bypassed()
            return build(False)
        return self._lookup((pack_tag, *self._key(name, arr)), build)

    def get_or_put_group(self, arrays: dict[str, np.ndarray], build, tag: str) -> torch.Tensor:
        """The device buffer of a group of arrays (the combined buffer):
        keyed on every member's digest plus `tag` (the layout), so a hit
        skips the pack and the upload in one lookup."""
        if self.bypassed:
            self._note_bypassed()
            return build(False)
        return self._lookup(self.group_key(arrays, tag), build)

    def group_key(self, arrays: dict[str, np.ndarray], tag: str) -> tuple:
        return (tag,) + tuple(self._key(k, arrays[k]) for k in sorted(arrays))

    def peek(self, key: tuple) -> torch.Tensor | None:
        """The device buffer under `key`, or None: no fill, no count, no
        probe step, and the LRU order stays (the shadow's read)."""
        with self._lock:
            return self._lru.get(key)

    def _lookup(self, key: tuple, build) -> torch.Tensor:
        """The LRU's hit and miss, its accounting, eviction and probe."""
        with self._lock:
            cached = self._lru.get(key)
            if cached is not None:
                self._lru.move_to_end(key)
                self.hits += 1
                self._win_hits += 1
                self._close_window_locked()
                self.bytes_skipped += cached.nbytes  # the upload not made
                return cached
        dev = build(True)
        with self._lock:
            self._lru[key] = dev
            self.misses += 1
            self._close_window_locked()
            while len(self._lru) > self.max_entries:
                self._lru.popitem(last=False)
        return dev

    def _close_window_locked(self) -> None:
        """Advance the probe window; bypass after a cold one. Caller holds
        _lock."""
        self._win_lookups += 1
        if self._win_lookups < self.probe_window:
            return
        if self._win_hits < self._win_lookups * self.min_hit_rate:
            self.bypassed = True
            self.bypass_cycles += 1
            self._bypassed_lookups = 0
            self._lru.clear()
        self._win_hits = 0
        self._win_lookups = 0

    def clear(self) -> None:
        with self._lock:
            self._lru.clear()

    def nbytes(self) -> int:
        """Bytes the entries hold on the device."""
        with self._lock:
            return sum(t.nbytes for t in self._lru.values())


class _RowContext:
    """One batch's consultation of the row cache: the RowBatchPlan and the
    indices that put (cold rows executed here + cached hits + rows another
    batch is filling) back into every request's row order.

    - `inverse` maps each original row onto its planning slot (the
      identity when dedup found no duplicate); `lead_slots` are the slots
      this batch executes, in order, so cold row j of the device output is
      slot `lead_slots[j]`.
    - `passthrough`: every row cold, none duplicated, no foreign flight
      joined. Execution then covers the batch in its own order, the usual
      pack and delivery serve it, and only the fill rides along.

    Delivery touches host arrays only: it may run on another batch's
    completion worker or in a leader's done-callback."""

    __slots__ = ("cache", "plan", "n_slots", "inverse", "lead_slots", "n_cold",
                 "exec_arrays", "passthrough", "all_fresh", "overload")

    def fill_from_host(self, host: dict) -> None:
        """Close the plan's lead flights from the executed rows: fill the
        cache (same generation only) and resolve every foreign waiter on
        them. Each row is copied out of `host`, so no entry holds a view
        of a batch's output."""
        values = {}
        for j, slot in enumerate(self.plan.lead):
            values[slot] = {k: np.array(v[j], copy=True) for k, v in host.items()}
        self.cache.complete_rows(self.plan, values)

    def abort(self, exc: BaseException) -> None:
        self.cache.abort_rows(self.plan, exc)

    def assemble(self, host: dict | None):
        """The batch's outputs in original row order from the three
        sources (executed / cached / filled by another batch): (full,
        failed_rows, row_errors). failed_rows masks the original rows whose
        foreign fill failed (their requests get that error, never a score);
        row_errors maps failed slots to their exceptions. host None = a
        batch with no cold row."""
        plan = self.plan
        failed: dict[int, BaseException] = {}
        wvals: dict[int, dict] = {}
        for slot, fut in plan.waiters.items():
            if fut.cancelled():
                failed[slot] = CoalescedLeaderCancelled(
                    "row fill leader was cancelled before completing")
                continue
            exc = fut.exception()
            if exc is not None:
                failed[slot] = exc
            else:
                wvals[slot] = fut.result()
        if host is not None:
            sample = {k: v[0] for k, v in host.items()}
        elif plan.hits:
            sample = next(iter(plan.hits.values()))
        elif wvals:
            sample = next(iter(wvals.values()))
        else:
            raise next(iter(failed.values()))  # every slot's fill failed
        full = {}
        for k, v in sample.items():
            arr = np.asarray(v)
            # Zeros: a failed slot's rows are never delivered, and no
            # uninitialized memory is reachable.
            vals = np.zeros((self.n_slots,) + arr.shape, arr.dtype)
            if host is not None and self.n_cold:
                vals[self.lead_slots] = host[k][:self.n_cold]
            for slot, hv in plan.hits.items():
                vals[slot] = hv[k]
            for slot, wv in wvals.items():
                vals[slot] = wv[k]
            full[k] = vals[self.inverse]
        failed_rows = None
        if failed:
            failed_rows = np.isin(self.inverse, np.fromiter(failed.keys(), np.int64))
        return full, failed_rows, failed


class DynamicBatcher:
    """Queue + batching thread + dispatch thread + completion workers, and
    the per-servable device step."""

    _FUSED_SPEC = {"feat_ids": "u24", "feat_wts": "bf16"}

    def __init__(
        self,
        buckets: tuple[int, ...] = DEFAULT_BUCKETS,
        max_wait_us: int = 200,
        device: str | torch.device | None = None,
        queue_capacity_candidates: int | None = None,
        fused_kernel: bool = True,
        completion_workers: int = 4,
        pipeline_depth: int = 2,
        output_wire_dtype: str = "float32",
        output_top_k: int = 0,
        breaker_timeout_s: float | None = 90.0,
        inflight_window: int = 0,
        buffer_ring: bool = False,
        input_cache_entries: int = 64,
        score_cache=None,
        row_cache=None,
        dedup: bool = False,
        overload=None,
        utilization=None,
        quality=None,
        run_fn=None,
    ):
        """fused_kernel=False serves dcn_v2 through model.apply (the
        configuration where `use_pallas_cross` routes only the cross stack
        through its kernel) instead of the fused serve kernel.
        pipeline_depth: assembled groups staged for the device stage,
        counting the one it runs (1 = assembly and device stage in turn).
        output_wire_dtype ("float32", "bfloat16", "float16", "int8") and
        output_top_k (0 = off) set the readback wire. breaker_timeout_s
        (None = never) is the wedge threshold of the circuit breaker;
        inflight_window (0 = unbounded) bounds the live batches executing or
        awaiting readback; buffer_ring recycles the padded-group buffers.
        input_cache_entries (0 = off) bounds the DeviceInputCache.

        The cache plane (cache/): `score_cache` (a ScoreCache) answers a
        whole-request repeat at submit, before admission, and runs one
        computation for identical concurrent misses; `row_cache` (a
        RowScoreCache) looks every row of a collected batch up and executes
        only the cold ones, in their own bucket; `dedup` executes each
        distinct row of a batch once. None / False = off: one attribute
        read per submit or batch.

        `overload` (a serving/overload.py AdmissionController, bound here to
        the largest bucket and the static capacity) replaces the static
        admission bound and arms the stale-serve; `integrity` (attribute,
        an IntegrityPlane) arms the shadow compare and the readback screen.
        Both are read once per submit or batch, so either may be detached
        while serving.

        `utilization` (a serving/utilization.py OccupancyLedger) is fed one
        interval per completed batch, the depth gauge and the idle waits:
        `queue_empty` in _take, `host_pack` in the coalescing wait,
        `readback_wait` where dispatch waits behind in-flight batches (the
        pipeline_depth backpressure in _stage and the in-flight window).
        `quality` (a serving/quality.py QualityMonitor) is fed each request's
        freshly computed scores by the completion worker. Each costs one
        attribute read per hook when None, and may be detached while
        serving.

        `run_fn(servable, arrays[, out_keys=...]) -> outputs` replaces the
        device stage's pack, upload and step, so the parallel layer runs a
        batch over a mesh (parallel/executor.py) or a process group
        (parallel/multihost.py) under the same batching: it gets the padded,
        host-folded arrays and returns device tensors or host arrays, which
        read back as the step's outputs do. A run_fn with
        `supports_out_keys` gets the group's output-selection union and
        compacts its own wire; one with `elastic` (parallel/elastic.py) gets
        the issue-token protocol: the token its dispatch mints is taken
        right after it and closed once the batch leaves the completion
        worker, on every path. Under a run_fn the device input cache, the
        native pack, the kernel plane, top-k / prune and the integrity
        shadow are off (the run_fn owns its placement and outputs)."""
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # An indexed device, for the worker threads' set_device.
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.buckets = tuple(sorted(buckets))
        self.max_wait_s = max_wait_us / 1e6
        # Coalescing past the largest bucket would build a batch no bucket
        # can hold.
        self.max_batch_candidates = self.buckets[-1]
        self.queue_capacity_candidates = max(
            queue_capacity_candidates
            if queue_capacity_candidates is not None
            else 16 * self.buckets[-1],
            self.buckets[-1],
        )
        self.overload = overload
        if overload is not None:
            overload.bind(self.buckets[-1], self.queue_capacity_candidates)
        self.integrity = None
        # The recovery plane's RecoveryController (serving/recovery.py),
        # attached by the controller itself, or None: one attribute read
        # per hook.
        self.recovery = None
        self.utilization = utilization
        self.quality = quality
        self.fused_kernel = fused_kernel
        self.output_wire_dtype = output_wire_dtype
        self._wire_dt = wire_dtype_of(output_wire_dtype)  # an unknown name raises here
        self.output_top_k = max(int(output_top_k or 0), 0)
        self.completion_workers = max(int(completion_workers), 1)
        # Read at every hand-off, so it may be changed while serving.
        self.pipeline_depth = max(int(pipeline_depth), 1)
        # Above any healthy batch, below the service's 120 s RPC cap.
        self.breaker_timeout_s = breaker_timeout_s
        self.inflight_window = max(int(inflight_window or 0), 0)
        self.buffer_ring = (_PadBufferRing(per_key=max(self.inflight_window, 4) + 4)
                            if buffer_ring else None)
        # The kernel plane (ops/autotune.py KernelManager), or None when off:
        # one attribute read per dispatch.
        self.kernels = None
        # A run_fn places its own inputs: no device input cache.
        self._run_fn = run_fn
        self.input_cache = (DeviceInputCache(input_cache_entries)
                            if input_cache_entries and run_fn is None else None)
        self.score_cache = score_cache
        self.row_cache = row_cache
        self.dedup = bool(dedup)
        self.stats = BatcherStats()
        # A list to record one (enqueue, collected, stage start, readback
        # issued, readback done, completed) tuple of perf_counter times per
        # request, or None (off: one attribute read per batch).
        self.timeline: list | None = None
        self._batch_ids = itertools.count(1)  # drawn only for traced batches
        self.ring = _HostBufferRing(pinned=self.device.type == "cuda")
        self._items: deque[_WorkItem] = deque()
        self._queued_candidates = 0
        self._staged_candidates = 0  # in groups staged for the dispatch thread
        self._cv = threading.Condition()
        self._stats_lock = threading.Lock()
        self._entries: weakref.WeakKeyDictionary[Servable, _Entry] = weakref.WeakKeyDictionary()
        self._entry_lock = threading.Lock()
        self._staged: deque[_Staged] = deque()
        self._dispatch_pending = 0  # staged + running device stages
        self._inflight = 0  # readbacks handed to the completion workers
        self._inflight_buckets: dict[int, int] = {}  # bucket -> of those
        # The wedge clock: when the live group in the device stage entered
        # it, and when each live batch's readback was handed off (batch
        # number -> time); warmup groups are not on it. The window counts
        # the latter.
        self._dispatching_since: float | None = None
        self._inflight_since: dict[int, float] = {}
        self._inflight_seq = 0
        self._dispatching = False  # the dispatch thread runs a device stage
        # The recovery plane's view (kept only while it is armed): the
        # non-warmup batch in the device stage, and those in flight, by
        # their number; what a capture takes.
        self._dispatching_st: _Staged | None = None
        self._inflight_staged: dict[int, _Staged] = {}
        # The dispatch thread's generation: a replacement
        # (replace_workers_for_recovery) starts the next one, and a thread
        # of an older one leaves the counts and the wedge clock alone.
        self._dispatch_gen = 0
        self._dispatch_holding = False  # the current thread holds a popped group
        self._collecting = False  # the batching thread holds a group not yet staged
        self._collect_done = False
        self._thread = threading.Thread(target=self._loop, name="batcher", daemon=True)
        self._dispatch_thread = threading.Thread(
            target=self._dispatch_loop, args=(0,), name="batch-dispatch", daemon=True)
        # At least one completion worker per window slot: a window deeper
        # than the pool would queue issued readbacks behind the workers.
        self._completers = ThreadPoolExecutor(
            max_workers=max(self.completion_workers, self.inflight_window),
            thread_name_prefix="batch-complete", initializer=self._bind_device,
        )
        self._started = False
        self._stopping = False
        # The BatcherThreadDead of the first batcher-owned thread that died
        # (_note_thread_death), else None: submit raises it up front. With
        # the recovery plane: whether the plane took that death, and the
        # batching or dispatch thread that died (revive joins it).
        self._dead: BatcherThreadDead | None = None
        self._death_handled = False
        self._dying_thread: threading.Thread | None = None

    # ------------------------------------------------------------------ API

    def start(self) -> "DynamicBatcher":
        if not self._started:
            self._started = True
            self._thread.start()
            self._dispatch_thread.start()
        return self

    def drain(self, timeout_s: float) -> bool:
        """Wait until every accepted item is done — nothing queued, no group
        being collected, none staged, no device stage running and no
        readback with the completion workers — or `timeout_s` elapses.
        True = drained. The shutdown drain (serving/server.py
        GracefulShutdown) calls it once new admissions are refused, so the
        wait is bounded by the work already accepted. While the recovery
        plane holds captured work (a cycle, or a trigger not yet taken up)
        the wait goes on too, bounded all the same: GracefulShutdown aborts
        the cycle first (RecoveryController.shutdown_for_drain)."""
        deadline = time.perf_counter() + max(timeout_s, 0.0)
        rec = self.recovery
        with self._cv:
            while (self._items or self._collecting or self._dispatch_pending
                   or self._inflight or (rec is not None and rec.cycle_active())):
                if not self._thread.is_alive() or not self._dispatch_thread.is_alive():
                    return False  # nothing will ever finish this work
                left = deadline - time.perf_counter()
                if left <= 0:
                    return False
                self._cv.wait(min(left, 0.05))
        return True

    def stop(self) -> None:
        """Serve every accepted item, then end the batching and dispatch
        threads and the completion workers (each wait bounded by
        _STOP_TIMEOUT_S)."""
        if not self._started:
            return
        with self._cv:
            self._stopping = True
            self._cv.notify_all()
        self._thread.join(timeout=_STOP_TIMEOUT_S)
        self._dispatch_thread.join(timeout=_STOP_TIMEOUT_S)
        end = time.perf_counter() + _STOP_TIMEOUT_S
        with self._cv:
            while self._inflight and time.perf_counter() < end:
                self._cv.wait(end - time.perf_counter())
        self._completers.shutdown(wait=False)
        self._started = False

    def submit(
        self,
        servable: Servable,
        arrays: dict[str, np.ndarray],
        output_keys: tuple[str, ...] | None = None,
        deadline_s: float | None = None,
        span=None,
        criticality: str | None = None,
        _solo: bool = False,
        _warmup: bool = False,
        _prune_k: int = 0,
    ) -> Future:
        """Enqueue one request's arrays; returns a Future of output arrays
        sliced back to the request's own candidate count. output_keys limits
        which outputs are read back. deadline_s is the client's remaining
        budget: an item still queued when it expires is shed. span (the
        caller's utils/tracing.Span) gets the batch's phases while tracing
        is on. _solo (a streamed sub-batch) makes the item a batch of its
        own; _warmup (warmup_via_queue) keeps an all-warmup group off the
        wedge clock and out of the in-flight window. While the circuit
        breaker is open it raises DeviceWedgedError and sheds the backlog;
        while the recovery plane quarantines, DeviceQuarantinedError (not
        for _warmup).

        With a score cache, the lookup comes first, before admission and
        the breaker (cached scores answer while the device is wedged or the
        queue full): a hit returns a done future, an identical request in
        flight hands back its future, and a miss leads: its completion
        fills the cache and answers those that joined. Warmup skips it.

        With the overload plane, `criticality` (the x-dts-criticality lane;
        warmup takes the probe lane) is the request's lane at admission,
        and past NOMINAL an entry inside the stale window answers, marked
        degraded (overload.mark_degraded in the caller's context).

        _prune_k > 0 (the cascade's stage 1, serving/cascade.py) makes the
        submit a prune: the result carries the k best (score, index) pairs
        (`survivor_scores`, `survivor_indices`) and the request's stage-1
        score vector (`stage1_scores`) instead of its outputs, or, where the
        prune cannot arm (prune_fallback_batches), the plain outputs. It is
        solo (the indices address the request's own rows), and its score
        cache key is salted with b"prune:<k>", so a prune result never
        answers a full request for the same features, nor the reverse.

        Once a batcher thread has died (BatcherThreadDead) every submit
        raises that death at once."""
        if _prune_k:
            _solo = True  # the survivor indices address this request's own rows
        if self._stopping:
            raise RuntimeError("batcher is stopped")
        if self._dead is not None:
            raise self._dead
        ns = {k: v.shape[0] for k, v in arrays.items()}
        n = next(iter(ns.values()))
        if any(v != n for v in ns.values()):
            raise ValueError(f"inconsistent candidate counts across inputs: {ns}")
        bucket_for(n, self.buckets)  # raises when too big
        cache = self.score_cache
        handle = None
        if cache is not None and not _warmup:
            ov = self.overload
            # Brownout stale-serve: past NOMINAL an entry up to the stale
            # window past its TTL still answers, marked degraded and never
            # refilled.
            stale_s = ov.stale_window_s if ov is not None and ov.stale_serve_active() else 0.0
            with request_trace.span("cache.lookup"):
                handle = cache.begin(servable.name, servable.version, output_keys, arrays,
                                     stale_s=stale_s,
                                     salt=b"prune:%d" % _prune_k if _prune_k else b"")
            if handle.hit is not None:
                if handle.stale:
                    ov.note_brownout_serve()
                    overload_mod.mark_degraded("stale")
                    if span is not None:
                        span.attrs["brownout_stale"] = True
                        span.annotate("overload.stale_serve", stale_window_s=stale_s)
                elif span is not None:
                    span.attrs["cache_hit"] = True
                fut = Future()
                fut.set_result(handle.hit)
                return fut
            if handle.waiter is not None:
                if span is not None:
                    span.attrs["cache_coalesced"] = True
                return handle.waiter
        try:
            fut = self._submit_miss(servable, arrays, n, output_keys, deadline_s, span,
                                    _solo, _warmup, criticality, _prune_k)
        except BaseException as exc:
            if handle is not None and handle.leader:
                # Never enqueued (breaker, admission, prepare): those that
                # joined fail with the same error instead of hanging.
                cache.abort(handle, exc)
            raise
        if handle is not None and handle.leader:
            # `cache` is the store that minted the handle: a store detached
            # meanwhile still closes this flight.
            fut.add_done_callback(
                lambda f, h=handle, c=cache: self._cache_complete(
                    c, h, f, servable, arrays, output_keys, _prune_k))
        return fut

    def _submit_miss(self, servable: Servable, arrays: dict[str, np.ndarray], n: int,
                     output_keys, deadline_s, span, solo: bool, warmup: bool,
                     criticality: str | None = None, prune_k: int = 0) -> Future:
        """submit() past the score cache: the breaker, admission, prepare
        and enqueue. Admission comes before the copy: a shed request pays
        none of it."""
        ov = self.overload
        rec = self.recovery
        with self._cv:
            if rec is not None and not warmup and rec.refusing():
                # The quarantine gate: new work is refused fast while the
                # executor is rebuilt; accepted work rides the replay.
                # Warmup is exempt: REINIT re-warms through this queue.
                raise DeviceQuarantinedError(
                    "replica quarantined: device executor is being rebuilt "
                    f"(recovery state {rec.state()}); retry against another backend")
            stuck_s = self._wedged_for(time.perf_counter())
            if stuck_s:
                exc = DeviceWedgedError(
                    f"a dispatched batch has been stuck {stuck_s:.1f}s "
                    f"(> breaker {self.breaker_timeout_s:.0f}s); failing fast"
                )
                self._shed_queued(exc)
                raise exc
            if ov is not None:
                # Adaptive admission against what waits for the device:
                # queued and staged candidates.
                lane = (overload_mod.PROBE if warmup
                        else overload_mod.normalize_criticality(criticality))
                decision = ov.admit(n, self._queued_candidates + self._staged_candidates,
                                    lane=lane, deadline_s=deadline_s)
                if not decision.admitted:
                    if span is not None:
                        span.annotate("overload.shed", reason=decision.reason, lane=lane,
                                      retry_after_ms=decision.retry_after_ms)
                    if (util := self.utilization) is not None:
                        # An empty queue during a shed storm is refused
                        # traffic, not absent traffic (admission_shed).
                        util.note_shed()
                    raise AdmissionRefusedError(decision.message,
                                                reason=decision.reason or "shed",
                                                retry_after_ms=decision.retry_after_ms)
            elif self._queued_candidates + n > self.queue_capacity_candidates:
                if (util := self.utilization) is not None:
                    util.note_shed()
                raise QueueOverloadError(
                    f"queue full ({self._queued_candidates} candidates queued, "
                    f"capacity {self.queue_capacity_candidates})"
                )
            self._queued_candidates += n
        try:
            prepared = prepare_inputs(arrays, servable.model.needs_x64)
        except BaseException:
            with self._cv:
                self._queued_candidates -= n
            raise
        now = time.perf_counter()
        item = _WorkItem(
            servable=servable, arrays=prepared, n=n, output_keys=output_keys,
            future=Future(), enqueue_t=now,
            deadline_t=None if deadline_s is None else now + deadline_s, solo=solo,
            warmup=warmup, span=span if tracing.enabled() else None, prune_k=prune_k,
            criticality=criticality,
        )
        with self._cv:
            if self._dead is not None:
                # A thread died after the check in submit: its shed of the
                # queue has run, so this item would never be taken.
                self._queued_candidates -= n
                raise self._dead
            self._items.append(item)
            self.stats.max_queue_depth = max(self.stats.max_queue_depth, len(self._items))
            self._cv.notify_all()
        return item.future

    def _cache_complete(self, cache, handle, fut: Future, servable: Servable,
                        arrays: dict[str, np.ndarray], output_keys, prune_k: int = 0) -> None:
        """A single-flight leader's done-callback: a result fills the cache
        (under cache.fill) and answers those that joined; a failure reaches
        them too. A leader ended by its own deadline (cancelled, or shed
        while queued) does not end theirs: the computation is submitted
        once more on their behalf, through submit(), without a deadline. A
        result marked degraded answers them with the mark and never fills."""
        if fut.cancelled() or isinstance(fut.exception(), RequestDeadlineError):
            waiters = [w for w in cache.take_waiters(handle) if not w.cancelled()]
            if not waiters:
                return
            try:
                retry = self.submit(servable, arrays, output_keys=output_keys,
                                    _prune_k=prune_k)
            except BaseException as exc:  # stopped, wedged or full
                for w in waiters:
                    try:
                        w.set_exception(exc)
                    except InvalidStateError:
                        pass
                return

            def chain(rf: Future) -> None:
                for w in waiters:
                    if w.cancelled():
                        continue
                    try:
                        if rf.cancelled():
                            w.cancel()
                        elif rf.exception() is not None:
                            w.set_exception(rf.exception())
                        else:
                            w.set_result(rf.result())
                    except InvalidStateError:
                        pass

            retry.add_done_callback(chain)
            return
        degraded = getattr(fut, "dts_degraded", None)
        if degraded is not None:
            # Assembled with row entries past their TTL: a fresh entry would
            # go on serving them unmarked.
            waiters = cache.take_waiters(handle)
            if waiters:
                result = fut.result()
                for w in waiters:
                    if w.cancelled():
                        continue
                    w.dts_degraded = degraded
                    try:
                        w.set_result(result)
                    except InvalidStateError:
                        pass
            return
        with request_trace.span("cache.fill"):
            cache.complete(handle, fut)

    @staticmethod
    def warmup_arrays(servable: Servable, n: int) -> dict[str, np.ndarray]:
        """Zero batch matching the servable's default-signature inputs."""
        out = {}
        for spec in servable.signature("").inputs:
            if spec.shape is None or len(spec.shape) < 1:
                continue
            dims = (n,) + tuple(d or 1 for d in spec.shape[1:])
            out[spec.name] = np.zeros(dims, _WARMUP_DTYPES.get(spec.dtype, np.float32))
        return out

    def warmup(self, servable: Servable, buckets: tuple[int, ...] | None = None) -> None:
        """Run every bucket of the ladder through the device stage once, at
        load (the first call builds the kernels and the native host ops, and
        fills the buffer ring). Executes directly — only safe before the
        batcher serves traffic. The one exception is an elastic run_fn:
        its warmup_call runs each split's executor on the caller's thread
        and touches no state of this batcher, so warmup_via_queue and the
        recovery re-warm call it on a live batcher.

        A run_fn with supports_out_keys warms the two output selections
        live traffic hits (all outputs; the score alone), and an elastic one
        warms them on EVERY split (warmup_call), so a runtime switch never
        places params or builds a kernel on the dispatch path."""
        fn = self._run_fn
        variants: tuple = (None,)
        if fn is not None and getattr(fn, "supports_out_keys", False):
            variants = (None, (servable.model.score_output,))
        warm_all = fn.warmup_call if getattr(fn, "elastic", False) else None
        for b in buckets or self.buckets:
            arrays = self.warmup_arrays(servable, b)
            for keys in variants:
                if warm_all is not None:
                    warm_all(servable, self._folded(servable, arrays), out_keys=keys)
                else:
                    self._execute(servable, arrays, keys)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup_via_queue(self, servable: Servable,
                         buckets: tuple[int, ...] | None = None) -> None:
        """Warm a servable THROUGH the request queue, on the batching and
        dispatch threads exactly like live traffic, so hot-loading a new
        version never runs device work beside live batches from another
        thread."""
        futures = [self.submit(servable, self.warmup_arrays(servable, b), _warmup=True)
                   for b in buckets or self.buckets]
        for fut in futures:
            fut.result(timeout=600)
        if getattr(self._run_fn, "elastic", False):
            # The queue reached the CURRENT split only: warm the rest of the
            # ladder directly, so a hot-loaded version's first batch after
            # a switch does no load-time work on the dispatch path.
            self.warmup(servable, buckets)

    def step_for(self, servable: Servable) -> _Entry:
        """The device step this batcher serves `servable` with, prepared
        once per servable."""
        with self._entry_lock:
            entry = self._entries.get(servable)
            if entry is None:
                entry = self._build_entry(servable)
                self._entries[servable] = entry
        return entry

    @property
    def run_fn(self):
        """The run_fn the device stage goes through, or None."""
        return self._run_fn

    def queue_load(self) -> tuple[int, int]:
        """(queued + staged candidates, the queue's capacity): the elastic
        controller's queue-pressure signal (parallel/elastic.py). One lock
        hold, at most once per controller tick."""
        with self._cv:
            return (self._queued_candidates + self._staged_candidates,
                    self.queue_capacity_candidates)

    def pipeline_stats(self) -> dict:
        """The dispatch pipeline: configured depth, batches in flight (total
        and per bucket), whether a device stage runs, groups staged or
        running, the in-flight window, its high-water mark and waits, the
        readback overlap and, with buffer_ring, the pad ring's counters (the
        /monitoring `pipeline` block and the dts_tpu_pipeline_* series). The
        JAX package's keys."""
        with self._cv:
            per_bucket = {int(b): n for b, n in sorted(self._inflight_buckets.items()) if n}
            out = {
                "depth": self.pipeline_depth,
                "inflight_window": self.inflight_window,
                "in_flight": self._inflight,
                "dispatching": self._dispatching,
                "dispatch_pending": self._dispatch_pending,
                "per_bucket_in_flight": per_bucket,
                "inflight_peak": self.stats.inflight_peak,
                "inflight_window_waits": self.stats.inflight_window_waits,
            }
        with self._stats_lock:
            out["readback_overlap_fraction"] = round(self.stats.readback_overlap_fraction, 4)
        if self.buffer_ring is not None:
            out["buffer_ring"] = self.buffer_ring.snapshot()
        return out

    def device_scope(self):
        """The batcher's card as the current device of the calling thread
        (a null context on the CPU): threads that load or warm on its
        behalf enter it."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    # ------------------------------------------------ the recovery plane

    def wedge_age(self) -> float:
        """Seconds the oldest live batch has been in the device stage or
        awaiting its readback (0.0 when none): the breaker's clock, which
        the recovery watchdog escalates at its own, lower threshold."""
        with self._cv:
            return self._wedge_age_locked(time.perf_counter())

    def capture_for_recovery(self) -> tuple[list, list]:
        """The quarantine's capture: every accepted, unanswered item out of
        the batcher — queued, in staged groups, in the device stage, in
        flight — with the queue and pipeline counts and the wedge clock
        settled, so the rebuilt executor starts clean. Returns
        (queued_items, inflight_groups): the queued items were in no
        failing device call; the in-flight groups were (the wedge is their
        kill evidence). A captured batch still running drops its late
        result or failure (_Staged.captured); the row cache's flights fail
        with DeviceQuarantinedError, since a leader stranded in a wedged
        thread would hold its joiners to their deadlines."""
        with self._cv:
            queued: list[_WorkItem] = []
            while self._items:
                it = self._items.popleft()
                self._queued_candidates -= it.n
                if not it.future.done():
                    queued.append(it)
            while self._staged:
                st = self._staged.popleft()
                self._dispatch_pending -= 1
                self._staged_candidates -= st.total
                self._release_pad(st)  # never uploaded
                queued.extend(it for it in st.group if not it.future.done())
            inflight: list[list[_WorkItem]] = []
            running = [] if self._dispatching_st is None else [self._dispatching_st]
            self._dispatching_st = None
            for st in running + list(self._inflight_staged.values()):
                st.captured = True
                live = [it for it in st.group if not it.future.done()]
                if live:
                    inflight.append(live)
            for st in self._inflight_staged.values():
                self._inflight -= 1
                self._inflight_buckets[st.bucket] -= 1
            self._inflight_staged.clear()
            self._inflight_since.clear()
            self._dispatching_since = None
            self._cv.notify_all()
        rc = self.row_cache
        if rc is not None:
            rc.fail_flights(DeviceQuarantinedError(
                "replica quarantined: in-flight row fills abandoned "
                "(the replayed batches re-plan their rows)"))
        return queued, inflight

    def requeue_for_replay(self, items: list) -> None:
        """Put captured or failed items back at the FRONT of the queue, in
        order (they were accepted before anything queued now). Admission is
        bypassed (they were admitted once); enqueue_t restarts, and the
        client's deadline rides along: an expired one is shed as usual."""
        now = time.perf_counter()
        with self._cv:
            for it in reversed(items):
                it.enqueue_t = now
                self._items.appendleft(it)
                self._queued_candidates += it.n
            self._cv.notify_all()

    def replace_workers_for_recovery(self) -> None:
        """A new dispatch thread and a new completion pool (a thread stuck
        in a native call cannot be preempted; the workers around it can be
        replaced). The old dispatch thread's generation ends: whenever its
        stage returns, it leaves the counts and the wedge clock alone and
        exits (its captured batch's result is dropped). The stage it held
        leaves the pending count now; the old pool's idle threads exit."""
        with self._cv:
            self._dispatch_gen += 1
            if self._dispatch_holding:
                self._dispatch_pending = max(self._dispatch_pending - 1, 0)
                self._dispatch_holding = False
            self._dispatching = False
            self._dispatching_st = None
            self._dispatching_since = None
            old = self._completers
            self._completers = ThreadPoolExecutor(
                max_workers=max(self.completion_workers, self.inflight_window),
                thread_name_prefix="batch-complete", initializer=self._bind_device,
            )
            if self._started and not self._stopping:
                self._dispatch_thread = threading.Thread(
                    target=self._dispatch_loop, args=(self._dispatch_gen,),
                    name="batch-dispatch", daemon=True)
                self._dispatch_thread.start()
            self._cv.notify_all()
        old.shutdown(wait=False)

    def revive_batching_thread(self) -> bool:
        """Clear a thread-death verdict and restart the batching and the
        dispatch thread where either is gone (recovery REINIT). True when
        one was restarted. The thread that died reports its death before
        its last frames unwind, so a recorded one is joined first (briefly);
        with no death recorded nothing is joined."""
        with self._cv:
            dying, self._dying_thread = self._dying_thread, None
            self._dead = None
            self._death_handled = False
        if dying is not None and dying is not threading.current_thread():
            dying.join(timeout=2.0)
        revived = False
        with self._cv:
            if self._started and not self._stopping:
                if not self._thread.is_alive():
                    self._collect_done = self._collecting = False
                    self._thread = threading.Thread(target=self._loop, name="batcher",
                                                    daemon=True)
                    self._thread.start()
                    revived = True
                if not self._dispatch_thread.is_alive():
                    self._dispatch_gen += 1
                    self._dispatch_holding = False
                    self._dispatch_thread = threading.Thread(
                        target=self._dispatch_loop, args=(self._dispatch_gen,),
                        name="batch-dispatch", daemon=True)
                    self._dispatch_thread.start()
                    revived = True
            self._cv.notify_all()
        return revived

    def _fail_or_capture(self, group: list[_WorkItem], total: int, exc: BaseException,
                         row_ctx: _RowContext | None = None) -> None:
        """A batch failed: with the recovery plane armed and the failure
        device-fatal, the plane takes the group (its replay, or its poison
        or budget verdict, answers the requests); otherwise the group fails
        with `exc`. The row flights close first either way: batches that
        joined them must not wait for a replay."""
        rec = self.recovery
        if rec is not None:
            if row_ctx is not None:
                row_ctx.abort(exc)
                row_ctx = None
            if rec.take_group(group, exc):
                return
        self._fail(group, total, exc, row_ctx)

    def _dropped_captured(self, st: _Staged, what: str) -> bool:
        """True (and the batch's `what` is dropped) when a recovery capture
        took the batch: the replay answers its requests."""
        if not st.captured:
            return False
        with self._stats_lock:
            self.stats.recovery_dropped += 1
        log.info("dropped the late %s of a batch of %d requests that recovery captured",
                 what, len(st.group))
        return True

    # ------------------------------------------------------------ internals

    def _wedge_age_locked(self, now: float) -> float:
        worst = 0.0
        if self._dispatching_since is not None:
            worst = now - self._dispatching_since
        for t0 in self._inflight_since.values():
            worst = max(worst, now - t0)
        return worst

    def _wedged_for(self, now: float) -> float:
        """Seconds the oldest live batch has been in the device stage or
        awaiting its readback, when that is past the breaker threshold; 0.0
        when healthy. Caller holds _cv."""
        t = self.breaker_timeout_s
        if t is None:
            return 0.0
        worst = self._wedge_age_locked(now)
        return worst if worst > t else 0.0

    def _shed_queued(self, exc: Exception) -> None:
        """Fail every queued item and every staged group waiting behind the
        wedged device stage. Caller holds _cv."""
        while self._items:
            it = self._items.popleft()
            self._queued_candidates -= it.n
            if not it.future.done():
                try:
                    it.future.set_exception(exc)
                except InvalidStateError:
                    pass  # the waiter cancelled at the same instant
        while self._staged:
            st = self._staged.popleft()
            self._dispatch_pending -= 1
            self._staged_candidates -= st.total
            self._release_pad(st)
            if st.row_ctx is not None:
                # Batches waiting on this one's cold rows fail with it.
                st.row_ctx.abort(exc)
            for it in st.group:
                if not it.future.done():
                    try:
                        it.future.set_exception(exc)
                    except InvalidStateError:
                        pass
        self._cv.notify_all()

    def _release_pad(self, st: _Staged) -> None:
        if self.buffer_ring is not None and st.pad_bufs:
            self.buffer_ring.release(st.pad_bufs)
        st.pad_bufs = []

    def _bind_device(self) -> None:
        """Make the card the current device of a worker thread: the kernel
        wrappers launch on the current stream of their thread."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)

    def _build_entry(self, servable: Servable) -> _Entry:
        from ..ops.cross_kernel import build_fused_serve, serve_fits_smem, serve_params_supported

        model = servable.model
        spec = transfer_spec(model)
        cfg = model.config
        fused = (
            self.fused_kernel
            and self.device.type == "cuda"
            and model.kind == "dcn_v2"
            and serve_params_supported(servable.params)
        )
        if fused and not serve_fits_smem(cfg.num_fields * cfg.embed_dim, cfg.mlp_dims, cfg.cdtype):
            log.info(
                "fused serve kernel declined %s v%d (shared-memory limit); "
                "serving through model.apply", servable.name, servable.version,
            )
            fused = False
        if model.kind == "dlrm" and self.device.type == "cuda":
            # DLRM's interaction: its kernel in bf16 (raises here, at load,
            # for a model the kernel cannot take), the eager ops in f32.
            from ..ops.dlrm_kernel import serving_route

            route = serving_route(servable.params["embedding"], cfg.num_fields, cfg.cdtype)
            log.info("dlrm interaction of %s v%d: %s", servable.name, servable.version,
                     "kernel (csrc/dlrm_kernel.cu)" if route == "kernel"
                     else "eager torch ops (float32 compute)")
        # The native host ops build here, at load, never on the dispatch
        # thread. On the card a servable that folds ids on the host needs
        # them; on the CPU (an explicit choice) a missing compiler leaves
        # the numpy fold and pack_host_combined, which are bit-identical.
        native_pack = spec == self._FUSED_SPEC and model.folds_ids_on_host
        if model.folds_ids_on_host and not native.ensure():
            if self.device.type == "cuda":
                raise RuntimeError(
                    "the native host-ops library (native/hostops.cc) could not be built "
                    "with g++; the serving path on the card packs through it")
            log.warning("native host ops unavailable; packing %s v%d with numpy",
                        servable.name, servable.version)
            native_pack = False
        fn = build_fused_serve(servable.params, cfg) if fused else model.apply
        return _Entry(fn=fn, spec=spec, fused=fused, native_pack=native_pack)

    def _kernel_variant(self, kern, servable: Servable, entry: _Entry, rows: int,
                        override=None) -> tuple[bool, bool]:
        """(quantized, fused) for one batch of `rows`. With the plane off it
        is the fixed choice of `entry`; armed, the per-bucket decision, whose
        baseline is model.apply on the float params. `override` is the
        autotune's pin, so measurement runs through the same entry as live
        traffic."""
        if kern is None:
            return False, entry.fused
        dec = override if override is not None else kern.decision(servable, rows)
        return dec or (False, False)

    def _fused_ctx(self, servable: Servable, parts: list[dict[str, np.ndarray]]) -> _FusedCtx | None:
        """The batch as parts for the native pack, or None when it is not
        eligible (then the padded arrays go through pack_host_combined).
        Eligible: a servable with the {feat_ids: u24, feat_wts: bf16} layout
        and parts of [n, F] int64/int32 ids and float32 weights. The port's
        codec widens a compact bf16 wire to float32 (codec.py); the native
        cast back to bf16 is exact, so such weights reach the device with
        the bits they were sent with. Never under a run_fn, which takes the
        padded arrays."""
        if self._run_fn is not None:
            return None
        entry = self.step_for(servable)
        if not entry.native_pack:
            return None
        first = parts[0]
        if set(first) != {"feat_ids", "feat_wts"} or first["feat_ids"].ndim != 2:
            return None
        fields = first["feat_ids"].shape[1]
        for p in parts:
            ids, wts = p["feat_ids"], p["feat_wts"]
            if (ids.ndim != 2 or ids.shape[1] != fields or wts.shape != ids.shape
                    or ids.dtype not in (np.int64, np.int32) or wts.dtype != np.float32):
                return None
        return _FusedCtx(
            layout=combined_layout(first, entry.spec),
            vocab=servable.model.config.vocab_size,
            fields=fields,
            ids_parts=[p["feat_ids"] for p in parts],
            wts_parts=[p["feat_wts"] for p in parts],
        )

    def _folded(self, servable: Servable, arrays: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        ids = arrays.get("feat_ids")
        model = servable.model
        if ids is not None and ids.dtype == np.int64 and model.folds_ids_on_host:
            arrays = dict(arrays)
            arrays["feat_ids"] = fold_ids_host(ids, model.config.vocab_size)
        return arrays

    def _count(self, name: str, shadow: bool) -> None:
        """One more of a device-stage counter, the shadow's own when
        `shadow`."""
        name = f"shadow_{name}" if shadow else name
        with self._stats_lock:
            setattr(self.stats, name, getattr(self.stats, name) + 1)

    def _pack(self, entry: _Entry, src, rows: int, shadow: bool = False) -> tuple[torch.Tensor, tuple]:
        """Pack one batch (a _FusedCtx or folded padded arrays) into a ring
        buffer: (host uint8 tensor, layout)."""
        if isinstance(src, _FusedCtx):
            buf = self.ring.acquire(combined_nbytes(src.layout, rows))
            native.pack_batch_u24_bf16(src.ids_parts, src.wts_parts, src.fields, rows,
                                       src.vocab, out=buf.numpy())
            self._count("native_packs", shadow)
            return buf, src.layout
        layout = combined_layout(src, entry.spec)
        buf = self.ring.acquire(combined_nbytes(layout, rows))
        with request_trace.span("batch.hostpack"):
            pack_host_combined(src, entry.spec, out=buf.numpy())
        return buf, layout

    def _upload(self, buf: torch.Tensor) -> tuple[torch.Tensor, object]:
        """One non-blocking copy of the packed buffer (pinned on the card):
        (the device buffer, the event after the copy or None). The caller
        counts it."""
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            buf = buf.to(self.device, non_blocking=True)
            event.record(torch.cuda.current_stream(self.device))
        return buf, event

    def _upload_per_key(self, entry: _Entry, arrays: dict[str, np.ndarray],
                        shadow: bool = False) -> dict[str, torch.Tensor]:
        """The per-key path: pack each (folded) input, one pageable copy
        each; with the input cache, each input looked up on its own (a
        shadow uploads every input: the cache's keys are per input)."""
        def upload(key, arr, keep=False):
            packed = pack_host({key: arr}, entry.spec) if entry.spec else {key: arr}
            t = to_device(packed, self.device)[key]
            self._count("h2d_copies", shadow)
            # On the CPU the "upload" shares the host array's memory: the
            # cache keeps a copy of its own.
            return t.clone() if keep and self.device.type != "cuda" else t

        cache = None if shadow else self.input_cache
        if cache is None:
            return unpack_device({k: upload(k, v) for k, v in arrays.items()}, entry.spec)
        with request_trace.span("batch.cache"):
            uploaded = {k: cache.get_or_put(k, v, lambda keep, k=k, v=v: upload(k, v, keep),
                                            pack_tag=entry.spec.get(k, ""))
                        for k, v in arrays.items()}
        return unpack_device(uploaded, entry.spec)

    def _input_key(self, cache: DeviceInputCache, src: _FusedCtx, rows: int) -> tuple:
        """The input cache's key of a natively packed batch: the layout,
        the bucket and the vocab (the digests are over raw ids, and the
        packed buffer's fold depends on the vocab) and each part's digest."""
        return ((f"fused:{src.layout}:{rows}:{src.vocab}",)
                + tuple(cache._key("i", a) for a in src.ids_parts)
                + tuple(cache._key("w", a) for a in src.wts_parts))

    def _step(self, servable: Servable, entry: _Entry, rows: int, override):
        """(step, params, fused) for one batch of `rows`."""
        kern = self.kernels
        quantized, fused = self._kernel_variant(kern, servable, entry, rows, override)
        params = kern.params_for(servable, True) if quantized else servable.params
        if not fused:
            step = servable.model.apply
        elif not quantized and entry.fused:
            step = entry.fn  # the one float fused step of this servable
        else:
            step = kern.pallas_apply_for(servable, quantized)
        return step, params, fused

    def _issue_readback(self, out: dict[str, torch.Tensor]) -> _Readback:
        """Start copying the outputs into ring buffers on the host: a
        non-blocking copy per output and a CUDA event after them (the copy
        is done when the event is). On the CPU the copy is done on return."""
        host = {}
        nbytes = 0
        for k, v in out.items():
            size = v.numel() * v.element_size()
            nbytes += size
            buf = self.ring.acquire(size)
            view = buf.view(v.dtype).view(v.shape)
            view.copy_(v, non_blocking=self.device.type == "cuda")
            host[k] = (buf, view)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        return _Readback(out=host, event=event, issue_t=time.perf_counter(), nbytes=nbytes)

    def _shape_outputs(self, servable: Servable, out: dict[str, torch.Tensor],
                       output_keys: tuple[str, ...] | None, topk: int,
                       n_valid: int, prune: bool = False) -> dict[str, torch.Tensor]:
        """The readback wire on the device, between the step and the
        readback issue: the top-k pairs of the score output (with the
        whole score vector for a cascade prune), or the selected outputs at
        the wire dtype. Device tensors only: nothing here waits for the
        card. An x64 model's outputs keep their precision (a float64 output
        downcast would not be a transparent wire encoding)."""
        if topk:
            select = cascade_prune_device if prune else topk_compact_device
            return select(out[servable.model.score_output], n_valid, topk, self._wire_dt)
        if output_keys is not None:
            out = {k: v for k, v in out.items() if k in output_keys} or out
        return compact_outputs_device(out, None if servable.model.needs_x64 else self._wire_dt)

    def _restore(self, rb: _Readback, views: dict) -> dict[str, np.ndarray]:
        """A readback's host views (`views`, keyed as `rb.out`) as owned
        float32 outputs (the wire undone, sidecars dropped)."""
        if rb.topk is not None:
            n, key = rb.topk
            if rb.prune:
                # The cascade gathers and scatters on the host: the three
                # arrays widened, the stage-1 vector trimmed to the request.
                return cascade_restore_host(views, n)
            return topk_restore_host(views["topk_scores"], views["topk_indices"], n, key)
        if rb.custom or (self._wire_dt is not None and not rb.full_precision):
            return restore_outputs_host(views)
        return {k: v.numpy().copy() for k, v in views.items()}

    def _issue(self, servable: Servable, src, rows: int, output_keys: tuple[str, ...] | None,
               override=None, per_key: bool = False, topk: int = 0,
               n_valid: int = 0, shadow: bool = False, prune: bool = False) -> _Readback:
        """The device stage of one padded batch, up to the readback issue:
        pack into a ring buffer, one upload, the device step, the readback
        wire, the readback copies. `src` is a _FusedCtx or the padded
        arrays; per_key (or inputs the combined layout cannot carry)
        uploads one copy per input instead. topk > 0 reads back the top-k
        pairs of the first n_valid rows' scores (with `prune`, the cascade's
        prune: the pairs and the score vector). A `shadow` (the integrity
        plane's second run, `override` its batch's variant) reads the input
        cache without filling it and moves only the shadow_* counters.
        Under a run_fn the batch goes to it instead (_issue_run_fn)."""
        if self._run_fn is not None:
            return self._issue_run_fn(servable, src, output_keys)
        entry = self.step_for(servable)
        # The variant is decided once (the kernel plane counts it then) and
        # pinned for the step: a shadow passes its batch's.
        variant = self._kernel_variant(self.kernels, servable, entry, rows, override)
        step, params, fused = self._step(servable, entry, rows, variant)
        if not isinstance(src, _FusedCtx):
            src = self._folded(servable, src)
        # An x64 model's inputs take the per-key path, each with its dtype.
        per_key = per_key or servable.model.needs_x64 or not (
            isinstance(src, _FusedCtx) or combined_supported(src))
        cache = None if per_key else self.input_cache
        # (host buffer, event after the copy that reads it): back to the
        # ring once the step has been issued.
        spent: list = []
        built = []  # pack_upload ran: the input cache missed
        held = dbuf = None
        layout = None if per_key else (
            src.layout if isinstance(src, _FusedCtx) else combined_layout(src, entry.spec))

        def pack_upload(keep: bool) -> torch.Tensor:
            built.append(True)
            buf, _ = self._pack(entry, src, rows, shadow)
            # Back to the ring even if the upload fails.
            spent.append((buf, None))
            dev, event = self._upload(buf)
            self._count("h2d_copies", shadow)
            if dev is buf and keep:
                # On the CPU the upload is the ring buffer itself: one the
                # cache keeps never goes back to the ring.
                spent.pop()
            else:
                spent[-1] = (buf, event)
            return dev

        cache_hit = False
        try:
            if per_key:
                batch = self._upload_per_key(entry, src, shadow)
            elif cache is not None and not cache.bypassed:
                # A hit skips the pack, the ring and the upload; a miss packs
                # and uploads in this span.
                with request_trace.span("batch.cache"):
                    if shadow:
                        key = (self._input_key(cache, src, rows) if isinstance(src, _FusedCtx)
                               else cache.group_key(src, str(layout)))
                        dbuf = cache.peek(key)
                        if dbuf is None:
                            dbuf = pack_upload(False)
                    elif isinstance(src, _FusedCtx):
                        dbuf = cache._lookup(self._input_key(cache, src, rows), pack_upload)
                    else:
                        dbuf = cache.get_or_put_group(src, pack_upload, tag=str(layout))
                cache_hit = not built
            else:
                if cache is not None and not shadow:
                    cache._note_bypassed()
                if isinstance(src, _FusedCtx):
                    with request_trace.span("batch.fusedpack"):
                        held, _ = self._pack(entry, src, rows, shadow)
                else:
                    held, _ = self._pack(entry, src, rows, shadow)
                spent.append((held, None))
            with torch.inference_mode():
                with request_trace.span("batch.jitcall"):
                    if held is not None:
                        dbuf, event = self._upload(held)
                        self._count("h2d_copies", shadow)
                        spent[-1] = (held, event)
                    if not per_key:
                        batch = unpack_device_combined(dbuf, layout)
                    out = step(params, batch)
                full = sum(v.numel() * (4 if v.is_floating_point() else v.element_size())
                           for v in out.values())
                with request_trace.span("readback.issue"):
                    rb = self._issue_readback(
                        self._shape_outputs(servable, out, output_keys, topk, n_valid, prune))
            rb.full_f32_bytes = full
            rb.input_cache_hit = cache_hit
            rb.variant = variant
            rb.full_precision = servable.model.needs_x64
            if topk:
                rb.topk = (n_valid, servable.model.score_output)
                rb.prune = prune
        finally:
            for buf, event in spent:
                # Reusable once the copy that reads it is done (on the CPU
                # the step has already read it).
                self.ring.release([buf], event)
        if fused:
            self._count("fused_batches", shadow)
        return rb

    def _issue_run_fn(self, servable: Servable, arrays: dict[str, np.ndarray],
                      output_keys: tuple[str, ...] | None) -> _Readback:
        """The device stage under a run_fn: the padded, host-folded arrays
        go to it (with the output selection when it takes one), and its
        outputs (device tensors or host arrays) read back as the step's do.
        The selection keeps the int8 wire's sidecars, without which a
        quantized score cannot be decoded."""
        fn = self._run_fn
        arrays = self._folded(servable, arrays)
        with torch.inference_mode():
            with request_trace.span("batch.jitcall"):
                if getattr(fn, "supports_out_keys", False):
                    out = fn(servable, arrays, out_keys=output_keys)
                else:
                    out = fn(servable, arrays)
            out = {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
                   for k, v in out.items()
                   if output_keys is None or k in output_keys or is_wire_sidecar(k)}
            with request_trace.span("readback.issue"):
                rb = self._issue_readback(out)
        # What a float32 readback of the fetched outputs would move (the
        # run_fn's dropped outputs are unknowable here).
        rb.full_f32_bytes = sum(v.numel() * 4 for v in out.values())
        rb.custom = True
        return rb

    def _take_run_token(self, st: _Staged, fn) -> None:
        """Pop the issue token an elastic run_fn minted for this batch's
        dispatch (same thread, right after it) onto the batch."""
        if getattr(fn, "elastic", False):
            token = fn.take_issue_token()
            if token is not None:
                st.run_token = (fn, token)

    @staticmethod
    def _close_run_token(st: _Staged) -> None:
        """Close the batch's elastic in-flight registration, once: the
        drain barrier of a split switch opens when its old split's batches
        all closed, so every path that ends a batch closes it."""
        held, st.run_token = st.run_token, None
        if held is not None:
            fn, token = held
            try:
                fn.note_complete(token)
            except Exception:  # noqa: BLE001 — accounting, never fatal
                log.exception("elastic note_complete failed")

    def _wait(self, rb: _Readback, check=None) -> dict[str, np.ndarray]:
        """Wait for a batch's readback; its outputs as owned host arrays.
        `check(views)` sees the raw host views after the event wait, before
        they are widened, and returns the views to restore (the integrity
        plane's fault sites and shadow compare). The buffers of the batch
        and of its shadow go back to the ring only after it."""
        with request_trace.span("readback.wait") as t0:
            try:
                if rb.event is not None:
                    rb.event.synchronize()
                rb.ready_t = time.perf_counter()
                views = {k: view for k, (_, view) in rb.out.items()}
                if check is not None:
                    views = check(views)
                host = self._restore(rb, views)
            finally:
                self.ring.release([buf for buf, _ in rb.out.values()])
                if rb.shadow is not None:
                    self.ring.release([buf for buf, _ in rb.shadow.out.values()],
                                      rb.shadow.event)
        rb.wait_s = rb.ready_t - t0
        with self._stats_lock:
            self.stats.readback_window_s += max(rb.ready_t - rb.issue_t, 0.0)
            self.stats.readback_blocked_s += rb.ready_t - t0
        return host

    def _raw_check(self, st: _Staged, rb: _Readback, integ, views: dict) -> dict:
        """The integrity plane on a batch's raw readback: the
        readback_bitflip / score_nan fault sites (a corrupted copy replaces
        the score view), then the shadow's bit-for-bit compare (after its
        own event wait), which raises OutputCorruptError on a mismatch."""
        fi = faults.get()
        if faults.active() and (fi.has_site("readback_bitflip") or fi.has_site("score_nan")):
            raw = {k: _raw_numpy(v) for k, v in views.items()}
            bad = _inject_readback_corruption(raw, st.group)
            if bad is not raw:
                views = {k: v if bad[k] is raw[k] else _raw_tensor(bad[k], v)
                         for k, v in views.items()}
        srb = rb.shadow
        if srb is not None:
            if srb.event is not None:
                srb.event.synchronize()
            sviews = {k: view for k, (_, view) in srb.out.items()}
            integ.shadow_compare([_raw_numpy(views[k]) for k in sorted(views)],
                                 [_raw_numpy(sviews[k]) for k in sorted(sviews)])
        return views

    @staticmethod
    def _shadow_src(st: _Staged):
        """What the shadow runs: the batch's padded arrays, or for a
        natively packed batch the padded arrays rebuilt from the same parts
        (so the shadow's pack is pack_host_combined, the reference of the
        native pack), as the JAX package does."""
        src = st.src
        if not isinstance(src, _FusedCtx):
            return src
        out = {}
        for key, parts in (("feat_ids", src.ids_parts), ("feat_wts", src.wts_parts)):
            buf = np.empty((st.bucket,) + parts[0].shape[1:], np.result_type(*parts))
            off = 0
            for part in parts:
                buf[off:off + part.shape[0]] = part
                off += part.shape[0]
            buf[off:] = 0  # the padding rows
            out[key] = buf
        return out

    def _execute(self, servable: Servable, arrays: dict[str, np.ndarray],
                 output_keys: tuple[str, ...] | None,
                 _kernel_override: tuple[bool, bool] | None = None,
                 _per_key: bool = False) -> dict[str, np.ndarray]:
        """The device stage of one padded batch, synchronously, on the
        caller's thread: the same pack, upload, step and readback as live
        traffic (warmup and the autotune time and check this path).
        _per_key takes the per-key upload instead of the combined buffer."""
        rows = next(iter(arrays.values())).shape[0]
        src = arrays if _per_key else (self._fused_ctx(servable, [arrays]) or arrays)
        fn = self._run_fn
        if getattr(fn, "elastic", False):
            # Not in-flight work: a token the dispatch minted closes here.
            try:
                return self._wait(self._issue(servable, src, rows, output_keys))
            finally:
                token = fn.take_issue_token()
                if token is not None:
                    fn.note_complete(token)
        return self._wait(self._issue(servable, src, rows, output_keys, _kernel_override,
                                      per_key=_per_key))

    def _drop_stale_locked(self, it: _WorkItem) -> bool:
        """Cancelled waiter or expired deadline: skip the item. Caller
        holds _cv and has already adjusted _queued_candidates."""
        if it.future.cancelled():
            return True
        if it.deadline_t is None or time.perf_counter() < it.deadline_t:
            return False
        self.stats.deadline_sheds += 1
        try:
            it.future.set_exception(RequestDeadlineError(
                f"client deadline expired while queued "
                f"({time.perf_counter() - it.enqueue_t:.3f}s); shed before dispatch"
            ))
        except InvalidStateError:
            pass  # the waiter cancelled at the same instant
        return True

    def _take(self) -> _WorkItem | None:
        """Pop the next live item, blocking; None on shutdown once the
        queue is empty. Nothing is taken while a thread death is recorded:
        the queue is then shed, or the recovery cycle captures it."""
        with self._cv:
            while True:
                while self._items and self._dead is None:
                    it = self._items.popleft()
                    self._queued_candidates -= it.n
                    if not self._drop_stale_locked(it):
                        self._collecting = True
                        return it
                if self._stopping:
                    return None
                self._idle_wait("queue_empty", None)  # no work arrived

    def _coalesce_next(self, item: _WorkItem, total: int, deadline: float) -> _WorkItem | None:
        """The next same-servable item that fits, waiting until `deadline`;
        None when the window closes or the head item does not match (queue
        order is kept)."""
        with self._cv:
            while True:
                while not self._items:
                    now = time.perf_counter()
                    if self._stopping or now >= deadline:
                        return None
                    # The host holds the batch open to coalesce (where the
                    # pipeline keeps the device busy, the ledger clamps it
                    # out).
                    self._idle_wait("host_pack", deadline - now)
                nxt = self._items[0]
                if nxt.future.cancelled() or (
                    nxt.deadline_t is not None and time.perf_counter() >= nxt.deadline_t
                ):
                    self._items.popleft()
                    self._queued_candidates -= nxt.n
                    self._drop_stale_locked(nxt)
                    continue
                if (
                    nxt.servable is item.servable
                    and not nxt.solo
                    # A bisection half merges only with its own half, or the
                    # poison would never be isolated.
                    and nxt.bisect_key == item.bisect_key
                    and nxt.arrays.keys() == item.arrays.keys()
                    and total + nxt.n <= self.max_batch_candidates
                ):
                    self._items.popleft()
                    self._queued_candidates -= nxt.n
                    return nxt
                return None

    def _loop(self) -> None:
        """The batching thread: collect, coalesce, assemble, stage. An
        exception that escapes it ends the thread as a BatcherThreadDead
        (_note_thread_death): the group it held fails with it."""
        group = None
        try:
            while True:
                item = self._take()
                if item is None:
                    return
                group = [item]
                total = item.n
                deadline = item.enqueue_t + self.max_wait_s
                while total < self.max_batch_candidates and not item.solo:
                    nxt = self._coalesce_next(item, total, deadline)
                    if nxt is None:
                        break
                    group.append(nxt)
                    total += nxt.n
                staged = self._assemble(group, total)
                if staged is not None:
                    self._stage(staged)
                with self._cv:
                    self._collecting = False
                    self._cv.notify_all()
                # Drop the batch before waiting for the next one: this frame
                # must not keep a retired servable alive while idle.
                item = group = staged = None
        except BaseException as exc:
            self._note_thread_death("batching", exc, group)
            raise
        finally:
            with self._cv:
                self._collect_done = True
                self._cv.notify_all()

    def _assemble(self, group: list[_WorkItem], total: int) -> _Staged | None:
        """Pad the group to its bucket (or gather its parts for the native
        pack). With the row cache, only the batch's cold rows are executed,
        in their own bucket, and a batch with no cold row is delivered from
        the cache with no device work; with dedup, each distinct row once.
        Both skip top-k (and prune) and warmup groups. A failure fails the group's
        futures (and its row flights) and returns None."""
        phases = _phase_sink(group)
        batch_id = next(self._batch_ids) if phases is not None else 0
        ring = self.buffer_ring
        pad_bufs: list = []
        row_ctx = None
        try:
            bucket = bucket_for(total, self.buckets)
            first = group[0]
            servable = first.servable
            keys = None
            if all(it.output_keys is not None for it in group):
                keys = tuple(dict.fromkeys(k for it in group for k in it.output_keys))
            # Top-k compaction: one request (top-k over a coalesced group
            # would mix requests' candidates) that asked for exactly the
            # score output (warmup batches ask for every output).
            topk = 0
            # An x64 model reads back its full outputs, and a run_fn its
            # own: no top-k, no prune.
            x64 = servable.model.needs_x64 or self._run_fn is not None
            if (self.output_top_k and len(group) == 1 and 0 < self.output_top_k < total
                    and keys == (servable.model.score_output,) and not x64):
                topk = self.output_top_k
            # The cascade's stage-1 prune rides the same selection (a prune
            # item is solo); where it cannot arm, the batch reads back its
            # plain outputs and the cascade prunes on the host.
            prune = False
            if first.prune_k and not first.warmup:
                if (len(group) == 1 and 0 < first.prune_k < total
                        and keys == (servable.model.score_output,) and not x64):
                    topk, prune = first.prune_k, True
                else:
                    with self._stats_lock:
                        self.stats.prune_fallback_batches += 1
            warm = any(it.warmup for it in group)
            scatter = uniq = cats = None
            rc = self.row_cache
            if rc is not None and not topk and not warm:
                with _sink_ctx(phases), request_trace.span("cache.row_lookup"):
                    row_ctx = self._plan_rows(
                        rc, group, total, tuple(sorted(keys)) if keys is not None else None)
                with self._stats_lock:
                    self.stats.row_batches += 1
                    self.stats.rows_requested += total
                    self.stats.rows_executed += row_ctx.n_cold
                    self.stats.row_full_hit_batches += row_ctx.n_cold == 0
                if row_ctx.n_cold == 0:
                    # Every row cached or being filled by another batch:
                    # delivered on a completion worker, so this thread
                    # never waits for another batch's fill.
                    _replay(group, phases, batch_id, 0, total)
                    fut = self._completers.submit(self._finish_row_batch, group, row_ctx, None)
                    fut.add_done_callback(lambda f, g=group: self._guard_row_delivery(f, g))
                    return None
                cats = row_ctx.exec_arrays
                if not row_ctx.passthrough:
                    bucket = bucket_for(row_ctx.n_cold, self.buckets)
            elif self.dedup and not topk and total > 1 and not warm:
                with _sink_ctx(phases), request_trace.span("batch.dedup"):
                    uniq, scatter, cats = collapse_rows(
                        {k: [it.arrays[k] for it in group] for k in first.arrays})
                if scatter is not None:
                    n_unique = next(iter(uniq.values())).shape[0]
                    bucket = bucket_for(n_unique, self.buckets)
                    with self._stats_lock:
                        self.stats.dedup_batches += 1
                        self.stats.dedup_rows_collapsed += total - n_unique
            # A collapsed batch skips the native pack, which would read the
            # requests' own parts again; rows already concatenated go to it
            # as one part (its output is row-sequential, so the bytes are
            # those of the parts).
            src = None
            if scatter is None:
                parts = [cats] if cats is not None else [it.arrays for it in group]
                src = self._fused_ctx(servable, parts)
            if src is None:
                rows = uniq if scatter is not None else cats
                src = {}
                with _sink_ctx(phases), request_trace.span("batch.pad"):
                    for key in first.arrays:
                        # The result dtype promotes mixed dtypes (int32
                        # compact ids next to raw int64 ids) instead of
                        # truncating into the first's.
                        parts = ([rows[key]] if rows is not None
                                 else [it.arrays[key] for it in group])
                        n = sum(p.shape[0] for p in parts)
                        head = parts[0]
                        if ring is None:
                            parts.append(np.zeros((bucket - n,) + head.shape[1:], head.dtype))
                            src[key] = np.concatenate(parts)
                            continue
                        out = ring.acquire((bucket,) + head.shape[1:], np.result_type(*parts))
                        pad_bufs.append(out)
                        off = 0
                        for p in parts:
                            out[off:off + p.shape[0]] = p
                            off += p.shape[0]
                        out[off:] = 0  # the padding rows
                        src[key] = out
        except Exception as exc:  # noqa: BLE001 — delivered to the waiters
            if pad_bufs:
                ring.release(pad_bufs)
            _replay(group, phases, batch_id, 0, total)
            # Building the device step (step_for) is device work too.
            self._fail_or_capture(group, total, exc, row_ctx)
            return None
        return _Staged(group=group, total=total, bucket=bucket, src=src, keys=keys,
                       collected_t=time.perf_counter(), topk=topk, prune=prune, phases=phases,
                       batch_id=batch_id, pad_bufs=pad_bufs, scatter=scatter, row_ctx=row_ctx)

    def _plan_rows(self, rc, group: list[_WorkItem], total: int, keys) -> _RowContext:
        """The row cache's consultation for one collected batch: the
        concatenated rows, one blake2b digest per row (with dedup, rows of
        equal digest collapse first), and each slot a hit, a waiter on
        another batch's flight, or a cold row this batch leads. The context
        carries the cold rows to execute and the map back."""
        from ..cache.row_cache import digest_rows, row_structure_header

        first = group[0]
        # np.concatenate widens mixed dtypes as the pad does, so a row's
        # identity is over the bytes the device would see.
        cats = {k: (np.concatenate([it.arrays[k] for it in group]) if len(group) > 1
                    else first.arrays[k])
                for k in first.arrays}
        digests_all = digest_rows(canonical_rows(cats), row_structure_header(cats))
        uniq_rows = inverse = None
        if self.dedup and total > 1:
            # Collapse by digest, the key the cache stores rows under.
            darr = np.frombuffer(b"".join(digests_all), np.uint8).reshape(total, 16)
            _, first_idx, inv = np.unique(darr, axis=0, return_index=True,
                                          return_inverse=True)
            if first_idx.shape[0] < total:
                uniq_rows = first_idx
                inverse = inv.reshape(-1).astype(np.int64)
                with self._stats_lock:
                    self.stats.dedup_batches += 1
                    self.stats.dedup_rows_collapsed += total - first_idx.shape[0]
        if uniq_rows is None:
            uniq_rows = inverse = np.arange(total, dtype=np.int64)
        digests = (digests_all if uniq_rows.shape[0] == total
                   else [digests_all[i] for i in uniq_rows])
        servable = first.servable
        ov = self.overload
        # Brownout stale-serve at row granularity: past NOMINAL an expired
        # row inside the stale window still answers, marked degraded at
        # delivery and never refilled.
        stale_s = ov.stale_window_s if ov is not None and ov.stale_serve_active() else 0.0
        plan = rc.begin_rows(servable.name, servable.version, keys, digests, stale_s=stale_s)
        try:
            ctx = _RowContext()
            ctx.cache = rc
            ctx.plan = plan
            ctx.overload = ov
            ctx.n_slots = len(digests)
            ctx.inverse = inverse
            ctx.lead_slots = np.asarray(plan.lead, dtype=np.int64)
            ctx.n_cold = len(plan.lead)
            ctx.passthrough = ctx.n_cold == ctx.n_slots == total
            # Every slot executed by this batch (it only held duplicates):
            # delivered by a scatter through `inverse`.
            ctx.all_fresh = not plan.hits and not plan.waiters
            if ctx.passthrough:
                ctx.exec_arrays = cats
            elif ctx.n_cold:
                sel = uniq_rows[ctx.lead_slots]
                ctx.exec_arrays = {k: np.ascontiguousarray(v[sel]) for k, v in cats.items()}
            else:
                ctx.exec_arrays = None
            rc.note_rows(servable.name, total, ctx.n_cold)
        except BaseException as exc:
            # The flights begin_rows registered must not outlive the plan.
            rc.abort_rows(plan, exc)
            raise
        return ctx

    @staticmethod
    def _observe_quality(q, group: list[_WorkItem], host: dict) -> None:
        """One quality observation per non-warmup member: the score output
        sliced per item as delivery slices it (after the wire is undone and
        the dedup scatter), so the sketched scores are the scores callers
        receive. Without the score output there is nothing to sketch."""
        score_key = group[0].servable.model.score_output
        scores = host.get(score_key)
        if scores is None:
            return
        off = 0
        for it in group:
            s = scores[off:off + it.n]
            off += it.n
            if it.warmup:
                continue  # build traffic is not a prediction signal
            q.observe(it.servable.name, it.servable.version, s, lane=it.criticality,
                      span=it.span, arrays=it.arrays,
                      trace_id=it.span.trace_id if it.span is not None else None)

    def _finish_row_batch(self, group: list[_WorkItem], row_ctx: _RowContext,
                          host: dict | None) -> None:
        """Deliver a row-cache batch once every foreign fill it joined has
        resolved. It never blocks a thread: while such fills are pending,
        delivery runs from the last one's done-callback, on the thread that
        resolves it. Host arrays only: no CUDA work here."""
        pending = [f for f in row_ctx.plan.waiters.values() if not f.done()]
        if not pending:
            self._deliver_row_batch(group, row_ctx, host)
            return
        lock = threading.Lock()
        left = [len(pending)]

        def on_done(_f):
            with lock:
                left[0] -= 1
                if left[0]:
                    return
            try:
                self._deliver_row_batch(group, row_ctx, host)
            except Exception as exc:  # noqa: BLE001 — every waiter must resolve
                self._fail(group, len(row_ctx.inverse), exc)

        for f in pending:
            f.add_done_callback(on_done)

    def _deliver_row_batch(self, group: list[_WorkItem], row_ctx: _RowContext,
                           host: dict | None) -> None:
        """Put executed, cached and foreign-filled rows back into every
        request's slice and resolve the futures. A request with a row whose
        foreign fill failed gets that error (its batchmates still answer)."""
        try:
            full, failed_rows, row_errors = row_ctx.assemble(host)
        except Exception as exc:  # noqa: BLE001 — every waiter must resolve
            self._fail(group, len(row_ctx.inverse), exc)
            return
        stale = row_ctx.plan.stale_slots
        stale_rows = np.isin(row_ctx.inverse, np.fromiter(stale, np.int64)) if stale else None
        off = 0
        for it in group:
            sl = slice(off, off + it.n)
            off += it.n
            if failed_rows is not None and failed_rows[sl].any():
                bad = int(row_ctx.inverse[sl][failed_rows[sl]][0])
                exc = row_errors.get(bad) or next(iter(row_errors.values()))
                if not it.future.done():
                    try:
                        it.future.set_exception(exc)
                    except InvalidStateError:
                        pass
                continue
            if stale_rows is not None and stale_rows[sl].any():
                # The degraded mark rides the future: this thread is not
                # the RPC's, so the service forwards it (and a score-cache
                # leader's done-callback answers its joiners with it).
                it.future.dts_degraded = "stale"
                if row_ctx.overload is not None:
                    row_ctx.overload.note_brownout_serve()
                if it.span is not None:
                    it.span.attrs["brownout_stale_rows"] = True
                    it.span.annotate("overload.stale_serve", rows=int(stale_rows[sl].sum()))
            keys = it.output_keys or tuple(full)
            try:
                if not it.future.cancelled():
                    it.future.set_result({k: full[k][sl] for k in keys if k in full})
            except InvalidStateError:
                pass

    def _stage(self, staged: _Staged) -> None:
        """Hand a group to the dispatch thread; then wait while
        pipeline_depth groups are staged or running, so the batching thread
        runs at most pipeline_depth - 1 groups ahead of the device stage.
        The wait ends once the breaker opens: behind a wedged dispatch
        thread the next groups stage, where a submit sheds them."""
        with self._cv:
            dead = self._dead
            if dead is None:
                self._staged.append(staged)
                self._dispatch_pending += 1
                self._staged_candidates += staged.total
                self._cv.notify_all()
                while (self._dispatch_pending >= self.pipeline_depth
                       and self._dispatch_thread.is_alive() and self._dead is None
                       and not self._wedged_for(time.perf_counter())):
                    # Bounded: the wedge clock advances with wall time alone.
                    self._idle_wait("readback_wait", 0.05)
        if dead is not None:
            # No dispatch thread takes it after a death: fail it as the shed
            # did, or, where the recovery plane took the death, back to the
            # queue for its cycle.
            self._release_pad(staged)
            if self.recovery is not None and self._death_handled:
                if staged.row_ctx is not None:
                    staged.row_ctx.abort(dead)
                self.requeue_for_replay([it for it in staged.group if not it.future.done()])
            else:
                self._fail(staged.group, staged.total, dead, staged.row_ctx)

    def _dispatch_loop(self, gen: int) -> None:
        """The dispatch thread of generation `gen`: run each staged group's
        device stage. _run_stage fails a group on any Exception; anything
        that escapes it ends the thread as a BatcherThreadDead
        (_note_thread_death), which fails that group and everything queued
        and staged behind it. Once replaced (replace_workers_for_recovery)
        the thread takes no more groups and leaves the counts alone."""
        with self.device_scope():
            while True:
                with self._cv:
                    while not self._staged or gen != self._dispatch_gen:
                        if self._collect_done or gen != self._dispatch_gen:
                            return
                        self._cv.wait()
                    staged = self._staged.popleft()
                    self._staged_candidates -= staged.total
                    self._dispatch_holding = True
                staged.gen = gen
                try:
                    self._run_stage(staged)
                except BaseException as exc:
                    self._util_done(staged)
                    if gen == self._dispatch_gen:
                        self._note_thread_death("dispatch", exc, staged.group, staged.row_ctx)
                    raise
                finally:
                    staged = None  # as in _loop: hold no servable while idle
                    with self._cv:
                        if gen == self._dispatch_gen:
                            self._dispatch_pending -= 1
                            self._dispatch_holding = False
                        self._cv.notify_all()

    def _fail(self, group: list[_WorkItem], total: int, exc: BaseException,
              row_ctx: _RowContext | None = None) -> None:
        """Fail the group's futures, and the row flights the batch led (a
        batch that joined them would otherwise wait for a fill that never
        lands)."""
        log.error("batch of %d candidates failed", total, exc_info=exc)
        if row_ctx is not None:
            row_ctx.abort(exc)
        for it in group:
            if not it.future.done():
                try:
                    it.future.set_exception(exc)
                except InvalidStateError:
                    pass

    def _idle_wait(self, cause: str, timeout: float | None) -> None:
        """One wait on the condition (its lock held), recorded as a `cause`
        wait while the utilization plane is armed: two clock reads, on the
        idle path only. The port's readback_wait sites are where dispatch
        waits behind in-flight batches (the JAX package's free-ride wait has
        no counterpart here)."""
        util = self.utilization
        if util is None:
            self._cv.wait(timeout)
            return
        token = util.wait_begin(cause)
        try:
            self._cv.wait(timeout)
        finally:
            util.wait_end(token)

    @staticmethod
    def _util_done(st: _Staged) -> None:
        """Lower the depth gauge the batch raised, once, on whichever path
        ends it (completion, a failed stage, an abandoned hand-off)."""
        util, st.util = st.util, None
        if util is not None:
            util.depth_dec()

    def _wait_for_window(self) -> None:
        """At the in-flight window's bound, wait for a completion (5 ms
        polls: the wedge clock advances with wall time alone) until a slot
        opens, the batcher stops or the breaker opens. One count per
        episode in stats.inflight_window_waits."""
        waited = False
        with self._cv:
            while (len(self._inflight_since) >= self.inflight_window and not self._stopping
                   and not self._wedged_for(time.perf_counter())):
                if not waited:
                    self.stats.inflight_window_waits += 1
                    waited = True
                self._idle_wait("readback_wait", 0.005)

    def _run_stage(self, st: _Staged) -> None:
        """Device stage up to the readback issue, then hand the batch to a
        completion worker. A failure fails the group's futures (or goes to
        the recovery plane), never the thread. An all-warmup group skips
        the window and the wedge clock. A dispatch thread replaced since it
        took the group (st.gen) leaves the stage bookkeeping to its
        successor."""
        all_warm = all(it.warmup for it in st.group)
        if self.inflight_window and not all_warm:
            self._wait_for_window()
        stage_t = time.perf_counter()
        # The utilization ledger's depth gauge, captured per batch (warmup
        # batches build and compile: not occupancy).
        util = None if all_warm else self.utilization
        if util is not None:
            util.depth_inc()
            st.util = util
        if st.phases is not None:
            # Each member waited from its own enqueue: its own interval, and
            # its two parts: until the batching thread collected it, then
            # until the device stage (behind pipeline_depth and the window).
            attrs = {"batch": st.batch_id, "bucket": st.bucket, "rows": st.total}
            for it in st.group:
                if it.span is not None:
                    it.span.add_interval("batch.queue_wait", it.enqueue_t, stage_t, attrs,
                                         wait=True)
                    it.span.add_interval("batch.collect_wait", it.enqueue_t, st.collected_t,
                                         attrs, wait=True)
                    it.span.add_interval("batch.stage_wait", st.collected_t, stage_t, attrs,
                                         wait=True)
        ov = self.overload
        if ov is not None:
            # The controlled variable of adaptive admission (warmup waits
            # include builds: not fed).
            waits = [stage_t - it.enqueue_t for it in st.group if not it.warmup]
            if waits:
                ov.note_queue_waits(waits)
        track = self.recovery is not None and not all_warm
        with self._cv:
            if st.gen == self._dispatch_gen:
                self._dispatching = True
                self._dispatching_since = None if all_warm else stage_t
                if track:
                    self._dispatching_st = st  # what a wedge capture replays
        issued = False
        rb = None
        fn = self._run_fn  # captured: a run_fn detached mid-flight gets its token back
        try:
            with _sink_ctx(st.phases):
                # Inside the sink, so an injected fault annotates the spans.
                faults.fire("batcher.dispatch")
                if faults.active() and faults.get().has_site("device_lost"):
                    # Once per member, keyed by its content: a keyless rule
                    # kills any batch, a keyed one each batch that carries
                    # one payload (the poison a bisection isolates).
                    for it in st.group:
                        faults.fire("device_lost", key=poison_fault_key(it.arrays))
                issued = True
                servable = st.group[0].servable
                with request_trace.span("batch.dispatch"):
                    rb = self._issue(servable, st.src, st.bucket, st.keys,
                                     topk=st.topk, n_valid=st.total, prune=st.prune)
                self._take_run_token(st, fn)
                integ = self.integrity
                # A run_fn's batch has no shadow: its entries need not be
                # bit-stable, and the shadow is the single-device step.
                if (integ is not None and not all_warm and fn is None
                        and integ.want_shadow()):
                    # The same device stage again (same servable, bucket and
                    # kernel variant), into its own readback buffers: the
                    # completion worker compares the two bit for bit.
                    with request_trace.span("batch.shadow_dispatch"):
                        rb.shadow = self._issue(servable, self._shadow_src(st), st.bucket,
                                                st.keys, override=rb.variant, topk=st.topk,
                                                n_valid=st.total, shadow=True, prune=st.prune)
                    with self._stats_lock:
                        self.stats.shadow_batches += 1
                        self.stats.shadow_input_cache_hits += rb.shadow.input_cache_hit
            rb.stage_t = stage_t
        except Exception as exc:  # noqa: BLE001 — delivered to the waiters
            # A token minted by a dispatch that failed after it closes here.
            self._take_run_token(st, fn)
            self._close_run_token(st)
            if not issued:
                self._release_pad(st)  # nothing was uploaded from them
            if rb is not None:
                # The shadow failed after the batch was issued: its readback
                # buffers go back once their copies are done.
                self.ring.release([buf for buf, _ in rb.out.values()], rb.event)
            # The spans show the phases that led to the failure before the
            # waiters unblock and finish them.
            _replay(st.group, st.phases, st.batch_id, st.bucket, st.total)
            self._util_done(st)
            if not self._dropped_captured(st, "failure"):
                self._fail_or_capture(st.group, st.total, exc, st.row_ctx)
            return
        finally:
            with self._cv:
                if st.gen == self._dispatch_gen:
                    self._dispatching = False
                    self._dispatching_since = None
                    self._dispatching_st = None
        if self._dropped_captured(st, "result"):
            # The step was issued: its buffers go back once its copies are
            # done; the padded ones are dropped.
            self.ring.release([buf for buf, _ in rb.out.values()], rb.event)
            if rb.shadow is not None:
                self.ring.release([buf for buf, _ in rb.shadow.out.values()], rb.shadow.event)
            self._util_done(st)
            self._close_run_token(st)
            return
        _replay(st.group, st.phases, st.batch_id, st.bucket, st.total)
        with self._stats_lock:
            self.stats.batches += 1
            self.stats.requests += len(st.group)
            self.stats.candidates += st.total
            self.stats.padded_candidates += st.bucket
            self.stats.topk_batches += bool(st.topk) and not st.prune
            self.stats.prune_batches += st.prune
            self.stats.bytes_downloaded += rb.nbytes
            self.stats.bytes_download_full_f32 += rb.full_f32_bytes
        with self._cv:
            self._inflight += 1
            self._inflight_buckets[st.bucket] = self._inflight_buckets.get(st.bucket, 0) + 1
            if not all_warm:
                # On the wedge clock until _finish is done with it.
                self._inflight_seq += 1
                st.seq = self._inflight_seq
                self._inflight_since[st.seq] = time.perf_counter()
                if track:
                    self._inflight_staged[st.seq] = st
                self.stats.inflight_peak = max(self.stats.inflight_peak,
                                               len(self._inflight_since))
        try:
            fut = self._completers.submit(self._finish, st, rb)
        except RuntimeError as exc:  # the pool is shut down or broken
            self._abandon(st, exc)
            return
        fut.add_done_callback(lambda f, st=st: self._guard_completer(f, st))

    def _guard_completer(self, fut, st: _Staged) -> None:
        """A completion worker that never ran _finish (its thread failed to
        start) would leave the group's waiters hanging: fail them. _finish
        fails the group on any Exception, so anything else surfacing here
        escaped it: the worker's death (_note_thread_death)."""
        exc = fut.exception()
        if isinstance(exc, BrokenExecutor):
            self._abandon(st, exc)
        elif exc is not None:
            self._util_done(st)
            self._close_run_token(st)
            # The shed first: a window slot freed before it would let the
            # dispatch thread take a staged group the death should fail. A
            # captured batch's requests are the replay's already.
            self._note_thread_death("completer", exc, None if st.captured else st.group,
                                    st.row_ctx)
            with self._cv:
                self._done_inflight_locked(st)

    def _guard_row_delivery(self, fut, group: list) -> None:
        """The same guard on a row-cache delivery handed to the workers."""
        exc = fut.exception()
        if exc is not None:
            self._note_thread_death("completer", exc, group)

    def _note_thread_death(self, which: str, exc: BaseException, group=None,
                           row_ctx: _RowContext | None = None) -> None:
        """A batcher-owned thread died from an exception that escaped its
        body: record the death (submit raises it from now on), fail `group`
        (the batch it held) and everything queued and staged, and wake
        every waiter. The first death is the one recorded.

        With the recovery plane armed, `group` goes back to the queue's
        front and the first death is handed to the plane, which revives the
        thread and replays the queue; only if the plane refuses it (a drain
        has stopped it) does the shed run."""
        err = BatcherThreadDead(f"batcher {which} thread died: {type(exc).__name__}: {exc}")
        err.__cause__ = exc
        log.error("batcher %s thread died", which, exc_info=exc)
        rec = self.recovery
        with self._cv:
            first = self._dead is None
            if first:
                self._dead = err
                if which != "completer":
                    self._dying_thread = threading.current_thread()
        if rec is not None:
            if row_ctx is not None:
                row_ctx.abort(err)
            self.requeue_for_replay([it for it in group or () if not it.future.done()])
            if first:
                self._death_handled = rec.note_thread_death(err)
            if self._death_handled:
                return
        elif group:
            self._fail(group, sum(it.n for it in group), err, row_ctx)
        with self._cv:
            self._shed_queued(self._dead)

    def _done_inflight_locked(self, st: _Staged) -> None:
        """The batch left the completion workers: off the in-flight counts
        and the wedge clock (the breaker closes with it), and a window wait
        wakes. A captured batch's counts were settled by the capture."""
        if not st.captured:
            self._inflight -= 1
            self._inflight_buckets[st.bucket] -= 1
            if st.seq is not None:
                self._inflight_since.pop(st.seq, None)
                self._inflight_staged.pop(st.seq, None)
        self._cv.notify_all()

    def _abandon(self, st: _Staged, exc: BaseException) -> None:
        self._util_done(st)
        self._close_run_token(st)
        with self._cv:
            self._done_inflight_locked(st)
        self._fail(st.group, st.total, exc, st.row_ctx)

    @staticmethod
    def _copies_done(rb: _Readback) -> bool:
        """The batch's readback copies (and its shadow's) are done, so no
        copy reads its padded buffers any more. False after a failure
        before the wait, and when the context no longer answers (a sticky
        CUDA error raises from the query): the buffers are then dropped,
        never reused."""
        try:
            return ((rb.event is None or rb.event.query()) and
                    (rb.shadow is None or rb.shadow.event is None or rb.shadow.event.query()))
        except RuntimeError:
            return False

    def _finish(self, st: _Staged, rb: _Readback) -> None:
        """Completion worker: wait for the readback, complete every member.
        The readback's phases reach the members' spans before their futures
        complete, so a root span holds its whole tree when its RPC ends. A
        failure goes to the recovery plane or fails the group; a batch a
        recovery capture took drops its late result or failure."""
        phases = _phase_sink(st.group)
        try:
            try:
                with _sink_ctx(phases):
                    try:
                        faults.fire("readback")
                        faults.fire("executor_abort")
                    except BaseException:
                        # Reusable once the readback copies are done.
                        self.ring.release([buf for buf, _ in rb.out.values()], rb.event)
                        if rb.shadow is not None:
                            self.ring.release([buf for buf, _ in rb.shadow.out.values()],
                                              rb.shadow.event)
                        raise
                    integ = self.integrity
                    if integ is None:
                        host = self._wait(rb)
                    else:
                        host = self._wait(rb, lambda views: self._raw_check(st, rb, integ, views))
                    if self._dropped_captured(st, "result"):
                        return
                    ov = self.overload
                    if ov is not None and not any(it.warmup for it in st.group):
                        # Service time up to the readback's event (after the
                        # kernels ran, not at launch): prices the backlog.
                        ov.note_batch(st.total, rb.ready_t - rb.stage_t)
                    if st.util is not None:
                        # The ledger's one interval per batch: stage start,
                        # readback issued, and the readback seen complete by
                        # this worker (an upper bound on the kernel's end).
                        st.util.note_batch(rb.stage_t, rb.issue_t, rb.ready_t, bucket=st.bucket,
                                           candidates=st.total, d2h_wait_s=rb.wait_s)
                    if st.scatter is not None:
                        # Dedup: each original row takes its unique row's
                        # outputs.
                        host = {k: v[st.scatter] for k, v in host.items()}
                    if st.row_ctx is not None:
                        # Fill the cache from the executed rows and answer
                        # the batches that joined them.
                        with request_trace.span("cache.row_fill"):
                            st.row_ctx.fill_from_host(host)
            finally:
                _replay(st.group, phases, st.batch_id, st.bucket, st.total)
            self._complete(st, rb, host)
        except Exception as exc:  # noqa: BLE001 — delivered to the waiters
            if not self._dropped_captured(st, "failure"):
                self._fail_or_capture(st.group, st.total, exc, st.row_ctx)
        finally:
            self._util_done(st)
            # The elastic drain barrier's release point: readback done (or
            # failed), the batch is no longer in flight on its split.
            self._close_run_token(st)
            if self._copies_done(rb):
                # The readback event follows the upload on the same stream:
                # no copy reads the padded buffers any more.
                self._release_pad(st)
            with self._cv:
                self._done_inflight_locked(st)

    def _complete(self, st: _Staged, rb: _Readback, host: dict[str, np.ndarray]) -> None:
        row_ctx = st.row_ctx
        if row_ctx is not None and not row_ctx.passthrough:
            if not row_ctx.all_fresh:
                # Executed, cached and foreign-filled rows together.
                self._finish_row_batch(st.group, row_ctx, host)
                return
            # Every row executed here: the scatter back through `inverse`.
            host = {k: v[row_ctx.inverse] for k, v in host.items()}
        integ = self.integrity
        screened: dict[int, str] = {}
        if integ is not None and integ.config.screen:
            # The readback screen, per request, on the rows it is handed:
            # a failing request fails alone, its batchmates deliver.
            scores = host.get(st.group[0].servable.model.score_output)
            if scores is not None:
                off = 0
                for idx, it in enumerate(st.group):
                    row = scores[off:off + it.n]
                    off += it.n
                    if it.warmup:
                        continue
                    reason = integ.screen_reason(row)
                    if reason is not None:
                        screened[idx] = reason
                        integ.note_screen_trip(reason)
        q = self.quality
        if q is not None and not screened and not st.topk:
            # Before the waiters unblock, so a drift exemplar's
            # `quality.drift` annotation is on the span when its RPC ends.
            # Skipped: a batch with a screened row (its readback is
            # suspect), top-k and prune readbacks (not the model's score
            # vector over the request), and, upstream, mixed row-cache
            # assemblies; the shadow's readback never reaches here.
            try:
                self._observe_quality(q, st.group, host)
            except Exception:  # noqa: BLE001 — the observability plane
                pass           # never fails a batch
        timeline = self.timeline
        off = 0
        for idx, it in enumerate(st.group):
            sl = slice(off, off + it.n)
            off += it.n
            # A prune's result is its three arrays (solo: the one member).
            keys = tuple(host) if st.prune else (it.output_keys or tuple(host))
            result = {k: host[k][sl] for k in keys if k in host}
            if timeline is not None:
                timeline.append((it.enqueue_t, st.collected_t, rb.stage_t, rb.issue_t,
                                 rb.ready_t, time.perf_counter()))
            try:
                if idx in screened:
                    it.future.set_exception(IntegrityScreenError(
                        f"readback screen failed this request's rows: {screened[idx]}"))
                else:
                    it.future.set_result(result)
            except InvalidStateError:
                pass  # the waiter gave up (deadline) meanwhile
        if integ is not None:
            # After delivery: the tripped requests already failed; a burst
            # past the window's threshold marks the replica suspect and
            # starts a recovery cycle (trigger output_corrupt).
            integ.maybe_escalate_screen(self.recovery)
