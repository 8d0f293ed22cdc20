"""Dynamic batching engine (core): queue, coalescing, bucket padding, host
fold + pack, upload, the device step, readback and per-request slicing.

- **Padded candidate buckets.** Work is padded up to a fixed bucket ladder,
  so the device step sees a handful of shapes, each warmed at load.
- **Request coalescing.** Concurrent requests for the same servable are
  concatenated along the candidate axis into one device call (up to the
  largest bucket, waiting at most `max_wait_us` after the first), then
  split back per request.
- **Host-side id folding.** Wire ids are int64; they are folded into the
  vocab on the host (exact modulo) before transfer, then packed as u24 /
  bf16 per ops/transfer.py.
- **The device step.** For dcn_v2 on a CUDA device it is the fused serve
  kernel (ops/cross_kernel.py build_fused_serve), prepared once per
  servable. Other models, and the CPU, run `model.apply`. With the kernel
  plane armed (`kernels`, ops/autotune.py) the per-bucket decision picks
  the step instead: model.apply or the fused kernel, on the float or the
  int8 params, with model.apply on the float params as the baseline.

One batching thread collects, pads, dispatches and completes; readback is
synchronous (`.cpu()`), so a batch completes before the next is assembled.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
import weakref
from collections import deque
from concurrent.futures import Future, InvalidStateError

import numpy as np
import torch

from ..models.base import resolve_device
from ..models.registry import Servable
from ..ops.transfer import pack_host, to_device, transfer_spec, unpack_device

log = logging.getLogger("dts_torch.batcher")

DEFAULT_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048, 4096)

# DataType -> numpy dtype for synthesizing warmup batches (types.proto).
_WARMUP_DTYPES = {1: np.float32, 2: np.float64, 3: np.int32, 9: np.int64}


class BatchTooLargeError(ValueError):
    pass


class QueueOverloadError(RuntimeError):
    """Queue admission refused: accepting more work would only build a
    backlog no deadline survives (RESOURCE_EXHAUSTED at the RPC layer)."""


class RequestDeadlineError(TimeoutError):
    """Queued work whose client deadline expired before dispatch: shed
    instead of executed (DEADLINE_EXCEEDED at the RPC layer)."""


def bucket_for(n: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise BatchTooLargeError(f"candidate count {n} exceeds largest bucket {buckets[-1]}")


def fold_ids_host(ids: np.ndarray, vocab_size: int) -> np.ndarray:
    """Exact int64 modulo fold on the host (numpy remainder takes the
    divisor's sign); models re-fold idempotently."""
    return np.remainder(ids, np.int64(vocab_size)).astype(np.int32)


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


def prepare_inputs(arrays: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Host-side normalization at submit. Every output array is owned or
    immutable, so a caller mutating its array after submit() cannot race
    the batch that reads it. Ids stay unfolded here: the whole padded batch
    is folded at once when it is dispatched."""
    out = {}
    for key, arr in arrays.items():
        if arr.dtype == np.float64:
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


@dataclasses.dataclass
class BatcherStats:
    batches: int = 0
    requests: int = 0
    candidates: int = 0
    padded_candidates: int = 0
    fused_batches: int = 0
    deadline_sheds: int = 0


@dataclasses.dataclass
class _Entry:
    fn: object  # (params, batch) -> outputs
    spec: dict[str, str]
    fused: bool


class DynamicBatcher:
    """Queue + batching thread + per-servable device step."""

    def __init__(
        self,
        buckets: tuple[int, ...] = DEFAULT_BUCKETS,
        max_wait_us: int = 200,
        device: str | torch.device | None = None,
        queue_capacity_candidates: int | None = None,
        fused_kernel: bool = True,
    ):
        """fused_kernel=False serves dcn_v2 through model.apply (the
        configuration where `use_pallas_cross` routes only the cross stack
        through its kernel) instead of the fused serve kernel."""
        self.device = resolve_device(device)
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
        self.fused_kernel = fused_kernel
        # The kernel plane (ops/autotune.py KernelManager), or None when off:
        # one attribute read per dispatch.
        self.kernels = None
        self.stats = BatcherStats()
        self._items: deque[_WorkItem] = deque()
        self._queued_candidates = 0
        self._cv = threading.Condition()
        self._entries: weakref.WeakKeyDictionary[Servable, _Entry] = weakref.WeakKeyDictionary()
        self._entry_lock = threading.Lock()
        self._thread = threading.Thread(target=self._loop, name="batcher", daemon=True)
        self._started = False
        self._stopping = False

    # ------------------------------------------------------------------ API

    def start(self) -> "DynamicBatcher":
        if not self._started:
            self._started = True
            self._thread.start()
        return self

    def stop(self) -> None:
        """Serve every accepted item, then end the batching thread."""
        if self._started:
            with self._cv:
                self._stopping = True
                self._cv.notify_all()
            self._thread.join(timeout=30)
            self._started = False

    def submit(
        self,
        servable: Servable,
        arrays: dict[str, np.ndarray],
        output_keys: tuple[str, ...] | None = None,
        deadline_s: float | None = None,
    ) -> Future:
        """Enqueue one request's arrays; returns a Future of output arrays
        sliced back to the request's own candidate count. output_keys limits
        which outputs are read back. deadline_s is the client's remaining
        budget: an item still queued when it expires is shed."""
        if self._stopping:
            raise RuntimeError("batcher is stopped")
        ns = {k: v.shape[0] for k, v in arrays.items()}
        n = next(iter(ns.values()))
        if any(v != n for v in ns.values()):
            raise ValueError(f"inconsistent candidate counts across inputs: {ns}")
        bucket_for(n, self.buckets)  # raises when too big
        with self._cv:
            if self._queued_candidates + n > self.queue_capacity_candidates:
                raise QueueOverloadError(
                    f"queue full ({self._queued_candidates} candidates queued, "
                    f"capacity {self.queue_capacity_candidates})"
                )
            self._queued_candidates += n
        try:
            prepared = prepare_inputs(arrays)
        except BaseException:
            with self._cv:
                self._queued_candidates -= n
            raise
        now = time.perf_counter()
        item = _WorkItem(
            servable=servable, arrays=prepared, n=n, output_keys=output_keys,
            future=Future(), enqueue_t=now,
            deadline_t=None if deadline_s is None else now + deadline_s,
        )
        with self._cv:
            self._items.append(item)
            self._cv.notify_all()
        return item.future

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
        """Run every bucket of the ladder through the device step once, at
        load (the first call builds the kernels). Executes directly — only
        safe before the batcher serves traffic."""
        for b in buckets or self.buckets:
            self._execute(servable, self.warmup_arrays(servable, b), None)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step_for(self, servable: Servable) -> _Entry:
        """The device step this batcher serves `servable` with, prepared
        once per servable."""
        with self._entry_lock:
            entry = self._entries.get(servable)
            if entry is None:
                entry = self._build_entry(servable)
                self._entries[servable] = entry
        return entry

    # ------------------------------------------------------------ internals

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
        fn = build_fused_serve(servable.params, cfg) if fused else model.apply
        return _Entry(fn=fn, spec=spec, fused=fused)

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

    def _execute(self, servable: Servable, arrays: dict[str, np.ndarray],
                 output_keys: tuple[str, ...] | None,
                 _kernel_override: tuple[bool, bool] | None = None) -> dict[str, np.ndarray]:
        """Device stage for one padded batch: fold, pack, upload, device
        step, readback."""
        entry = self.step_for(servable)
        kern = self.kernels
        rows = next(iter(arrays.values())).shape[0]
        quantized, fused = self._kernel_variant(kern, servable, entry, rows, _kernel_override)
        params = kern.params_for(servable, True) if quantized else servable.params
        if not fused:
            step = servable.model.apply
        elif not quantized and entry.fused:
            step = entry.fn  # the one float fused step of this servable
        else:
            step = kern.pallas_apply_for(servable, quantized)
        model = servable.model
        ids = arrays.get("feat_ids")
        if ids is not None and ids.dtype == np.int64 and model.folds_ids_on_host:
            arrays = dict(arrays)
            arrays["feat_ids"] = fold_ids_host(ids, model.config.vocab_size)
        packed = pack_host(arrays, entry.spec) if entry.spec else arrays
        batch = unpack_device(to_device(packed, self.device), entry.spec)
        with torch.inference_mode():
            out = step(params, batch)
            if output_keys is not None:
                out = {k: v for k, v in out.items() if k in output_keys} or out
            host = {k: v.cpu().numpy() for k, v in out.items()}
        if fused:
            self.stats.fused_batches += 1
        return host

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
        queue is empty."""
        with self._cv:
            while True:
                while self._items:
                    it = self._items.popleft()
                    self._queued_candidates -= it.n
                    if not self._drop_stale_locked(it):
                        return it
                if self._stopping:
                    return None
                self._cv.wait()

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
                    self._cv.wait(deadline - now)
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
                    and nxt.arrays.keys() == item.arrays.keys()
                    and total + nxt.n <= self.max_batch_candidates
                ):
                    self._items.popleft()
                    self._queued_candidates -= nxt.n
                    return nxt
                return None

    def _loop(self) -> None:
        while True:
            item = self._take()
            if item is None:
                return
            group = [item]
            total = item.n
            deadline = item.enqueue_t + self.max_wait_s
            while total < self.max_batch_candidates:
                nxt = self._coalesce_next(item, total, deadline)
                if nxt is None:
                    break
                group.append(nxt)
                total += nxt.n
            self._dispatch(group, total)

    def _dispatch(self, group: list[_WorkItem], total: int) -> None:
        """Pad the group to its bucket, run it, and complete every member.
        A failure fails the whole group's futures, never the thread."""
        try:
            bucket = bucket_for(total, self.buckets)
            arrays = {}
            for key in group[0].arrays:
                # concatenate promotes mixed dtypes (int32 compact ids next
                # to raw int64 ids) instead of truncating into the first's.
                parts = [it.arrays[key] for it in group]
                first = parts[0]
                parts.append(np.zeros((bucket - total,) + first.shape[1:], first.dtype))
                arrays[key] = np.concatenate(parts)
            keys = None
            if all(it.output_keys is not None for it in group):
                keys = tuple(dict.fromkeys(k for it in group for k in it.output_keys))
            host = self._execute(group[0].servable, arrays, keys)
        except BaseException as exc:  # noqa: BLE001 — delivered to the waiters
            log.exception("batch of %d candidates failed", total)
            for it in group:
                if not it.future.done():
                    it.future.set_exception(exc)
            return
        self.stats.batches += 1
        self.stats.requests += len(group)
        self.stats.candidates += total
        self.stats.padded_candidates += bucket
        self._complete(group, host)

    @staticmethod
    def _complete(group: list[_WorkItem], host: dict[str, np.ndarray]) -> None:
        off = 0
        for it in group:
            sl = slice(off, off + it.n)
            off += it.n
            keys = it.output_keys or tuple(host)
            result = {k: host[k][sl] for k in keys if k in host}
            try:
                it.future.set_result(result)
            except InvalidStateError:
                pass  # the waiter gave up (deadline) meanwhile
