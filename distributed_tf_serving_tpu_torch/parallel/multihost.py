"""Multi-process execution: one logical model spanning processes (one card
each, or several processes sharing a card), joined by torch.distributed.

Serving on a multi-process mesh has a control-flow problem the training
loop does not: requests arrive at ONE process, but every process must take
part in the same collectives. The answer is a leader/follower step protocol
with a small broadcast control plane, the JAX package's protocol:

- every step starts with a fixed-shape HEADER broadcast `[op, arg]`, so
  followers know what shapes the next collective carries before entering
  it;
- `op=SCORE, arg=bucket`: the batch arrays for that bucket follow in a
  second broadcast (key by key, sorted), every process scores its
  contiguous row block of the bucket (its data shard: rank // model) on its
  own device, and the blocks are all-gathered and concatenated in shard
  order (the reference's host-order merge). A LADDER of buckets is
  supported: small requests pay small-bucket padding and broadcast bytes;
- `op=RELOAD, arg=version`: every process swaps `params` through the
  injected `param_loader(version)` (a hot version rollout without
  restarting the group);
- `op=SHUTDOWN`: followers leave their loop;
- `op=HEARTBEAT`: a no-op the idle leader sends every few seconds
  (start_heartbeat), so a dead follower is found while no request flows.

The gRPC frontend runs on process 0 only, with `as_run_fn()` plugged into a
DynamicBatcher configured with the same bucket ladder; followers are
headless `follow()` loops. A VersionWatcher on the leader hot-swaps
versions across the whole group through `watcher_loader()`.

Backend: NCCL where each process has a card of its own, gloo otherwise
(CPU processes, or several processes sharing one card: NCCL refuses two
ranks on one GPU). With gloo the collectives move host tensors and each
process scores on its own device. Failure semantics: a collective with a
dead peer raises (gloo: the closed connection; either backend: the process
group's timeout, `heartbeat_timeout_s`). The runner records the first such
failure (`failure`, `failed`), a follower re-raises it out of follow(), and
the serving leader exits nonzero (serving/multihost_server.py): a process
lost mid-collective-stream is not something SPMD serving can recover, so
the group fails fast and is restarted.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
import threading
from typing import Any, Callable, Sequence

import numpy as np
import torch

from .embedding_sharding import tree_map_with_path
from .mesh import DATA_AXIS, MODEL_AXIS, Mesh, make_mesh, row_blocks

log = logging.getLogger("dts_torch.multihost")

# Header ops (first word of the fixed-shape control broadcast).
_OP_SCORE = 0
_OP_RELOAD = 1
_OP_SHUTDOWN = 2
_OP_HEARTBEAT = 3


def pick_backend(num_processes: int) -> str:
    """NCCL when every process of this host can have a card of its own,
    gloo otherwise."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= max(num_processes, 1):
        return "nccl"
    return "gloo"


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    heartbeat_timeout_s: float | None = None,
) -> str:
    """torch.distributed.init_process_group with env fallbacks
    (COORDINATOR_ADDRESS "host:port" / NUM_PROCESSES / PROCESS_ID); returns
    the backend. Idempotent: a process whose group is up keeps it. One
    process with no coordinator gets a world of one over an in-process
    store, so the tier's collectives run the same code.

    heartbeat_timeout_s bounds every collective (the group's timeout): a
    peer that stops answering fails the waiting process within it. The
    backend is pick_backend(num_processes)'s."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_backend()
    if num_processes is None:
        num_processes = int(os.environ.get("NUM_PROCESSES", "1"))
    backend = pick_backend(num_processes)
    kwargs = {}
    if heartbeat_timeout_s is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=float(heartbeat_timeout_s))
    address = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if num_processes <= 1 and not address:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                **kwargs)
        return backend
    if not address:
        raise ValueError(f"{num_processes} processes need a coordinator address "
                         "(--coordinator or COORDINATOR_ADDRESS)")
    rank = int(os.environ["PROCESS_ID"]) if process_id is None else process_id
    dist.init_process_group(backend, init_method=f"tcp://{address}", rank=rank,
                            world_size=num_processes, **kwargs)
    return backend


def broadcast_int(value: int) -> int:
    """Process 0's `value` on every process of the group."""
    import torch.distributed as dist

    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor([int(value)], dtype=torch.int64, device=dev)
    dist.broadcast(t, src=0)
    return int(t.item())


def rank_device(rank: int, device=None) -> torch.device:
    """The device process `rank` scores on: the CPU when asked, else card
    rank % (cards on this host). One host's processes share its cards in
    turn, so two processes on a one-card host both use cuda:0."""
    kind = torch.device(device).type if device is not None else "cuda"
    if kind == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return torch.device("cuda", rank % torch.cuda.device_count())


def global_mesh(model_parallel: int = 1, device=None) -> Mesh:
    """Mesh over every process's device, one position per rank in rank
    order (data-major: the candidate axis spans processes, each feeding its
    contiguous rows)."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh(world, model_parallel=model_parallel,
                     devices=[rank_device(r, device) for r in range(world)])


@dataclasses.dataclass
class MultiHostRunner:
    """Leader/follower step protocol over a multi-process mesh.

    `score_fn(params, batch) -> scores` must be identical on every process
    (same model); it runs on this process's device over its row block.
    The batch schema comes from `batch_template` (single bucket) or
    `batch_templates` (a bucket ladder): each template fixes key order,
    trailing shapes and dtypes; leading dims are the padded bucket sizes.
    Every process must pass identical shapes and dtypes into each
    collective, so lead() validates batches against the templates instead
    of letting a mismatch hang the group; the header tells followers which
    bucket's shapes to expect.

    `param_loader(version) -> params` enables RELOAD: it must resolve the
    same version to the same params on every process (e.g. a shared
    checkpoint base path)."""

    mesh: Mesh
    params: Any
    score_fn: Callable[[Any, dict[str, torch.Tensor]], torch.Tensor]
    batch_template: dict[str, np.ndarray] | None = None
    batch_templates: Sequence[dict[str, np.ndarray]] | None = None
    param_loader: Callable[[int], Any] | None = None
    # Loaded params are moved to this process's device by default; a loader
    # that already places its tensors sets this False.
    place_loaded: bool = True

    def __post_init__(self):
        import torch.distributed as dist

        templates = list(self.batch_templates or [])
        if self.batch_template is not None:
            templates.append(self.batch_template)
        if not templates:
            raise ValueError("need batch_template or batch_templates")
        keys = tuple(sorted(templates[0]))
        self._keys = keys
        self._zeros: dict[int, dict[str, np.ndarray]] = {}
        for tmpl in templates:
            if tuple(sorted(tmpl)) != keys:
                raise ValueError(
                    f"all templates must share keys; got {sorted(tmpl)} vs {list(keys)}"
                )
            bucket = next(iter(tmpl.values())).shape[0]
            if any(tmpl[k].shape[0] != bucket for k in keys):
                raise ValueError("template arrays disagree on leading (bucket) dim")
            self._zeros[bucket] = {k: np.zeros_like(tmpl[k]) for k in keys}
        self.buckets: tuple[int, ...] = tuple(sorted(self._zeros))
        self.bucket = self.buckets[-1]  # largest
        if not dist.is_initialized():
            raise RuntimeError("MultiHostRunner needs init_distributed() first")
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        if self.world != self.mesh.size:
            raise ValueError(f"mesh of {self.mesh.size} positions for {self.world} processes")
        self.device = self.mesh.devices.flat[self.rank]
        # NCCL moves device tensors; gloo host tensors.
        self._coll_device = (self.device if dist.get_backend() == "nccl"
                             else torch.device("cpu"))
        # One broadcast / collective stream: the batcher thread (lead), a
        # version watcher (reload) and the heartbeat must never interleave
        # header and payload broadcasts, or the group desynchronizes into a
        # hang.
        self._lock = threading.Lock()
        self.version: int | None = None
        # The first collective failure (a dead or hung peer), and an event
        # set with it: the serving leader exits on it.
        self.failure: BaseException | None = None
        self.failed = threading.Event()
        self._hb_stop = threading.Event()
        self._hb_thread: threading.Thread | None = None
        # Placed here, at the one protocol point every process reaches
        # together.
        self.params = self._place(self.params)

    # ------- control plane: fixed-shape header, then bucket-shaped payload

    def _collective(self, fn, *args):
        """Run one collective step, recording the first failure (a dead or
        hung peer) before re-raising it."""
        try:
            return fn(*args)
        except BaseException as exc:
            if self.failure is None:
                self.failure = exc
                self.failed.set()
            raise

    def _header(self, op: int, arg: int) -> tuple[int, int]:
        import torch.distributed as dist

        t = torch.tensor([op, arg], dtype=torch.int64, device=self._coll_device)
        dist.broadcast(t, src=0)
        out = t.tolist()
        return int(out[0]), int(out[1])

    def _payload(self, bucket: int, batch: dict[str, np.ndarray] | None):
        import torch.distributed as dist

        zeros = self._zeros[bucket]
        out = {}
        for k in self._keys:
            arr = zeros[k] if batch is None else batch[k]
            t = torch.from_numpy(np.array(arr, copy=True)).to(self._coll_device)
            dist.broadcast(t, src=0)
            out[k] = t
        return out

    def _validate(self, batch: dict[str, np.ndarray]) -> int:
        if set(batch) != set(self._keys):
            raise ValueError(
                f"batch keys {sorted(batch)} != template keys {list(self._keys)}"
            )
        bucket = next(iter(batch.values())).shape[0]
        if bucket not in self._zeros:
            raise ValueError(
                f"batch leading dim {bucket} is not a configured bucket "
                f"{self.buckets}; pad to a bucket before lead()"
            )
        for k in self._keys:
            want = self._zeros[bucket][k]
            got = batch[k]
            if got.shape != want.shape or got.dtype != want.dtype:
                raise ValueError(
                    f"batch[{k!r}] is {got.dtype}{got.shape}, template requires "
                    f"{want.dtype}{want.shape} (pad to the bucket and convert "
                    "dtypes before lead(): all processes must broadcast "
                    "identical buffers or the collective hangs)"
                )
        return bucket

    def _step(self, batch: dict[str, torch.Tensor]) -> np.ndarray:
        """Score this process's data shard of the bucket, then all-gather
        the shards in rank order: the full score vector on every process."""
        import torch.distributed as dist

        rows = next(iter(batch.values())).shape[0]
        data, model = self.mesh.shape[DATA_AXIS], self.mesh.shape[MODEL_AXIS]
        pad = (-rows) % data
        lo, hi = row_blocks(rows + pad, data)[self.rank // model]
        block = {}
        for k, v in batch.items():
            if pad:
                v = torch.cat([v, v.new_zeros((pad,) + tuple(v.shape[1:]))])
            block[k] = v[lo:hi].to(self.device)
        with torch.inference_mode():
            scores = self.score_fn(self.params, block)
        mine = scores.to(self._coll_device).contiguous()
        parts = [torch.empty_like(mine) for _ in range(self.world)]
        dist.all_gather(parts, mine)
        # One copy per data shard: the ranks of a shard's model positions
        # scored the same rows.
        return torch.cat(parts[::model])[:rows].cpu().numpy()

    # ----------------------------------------------------------------- API

    def lead(self, batch: dict[str, np.ndarray]) -> np.ndarray:
        """Process 0: score one padded batch across all processes; returns
        the full score vector (the caller slices off padding)."""
        bucket = self._validate(batch)
        with self._lock:
            self._collective(self._header, _OP_SCORE, bucket)
            shared = self._collective(self._payload, bucket, batch)
            return self._collective(self._step, shared)

    def reload(self, version: int) -> None:
        """Process 0: hot-swap every process's params to `version` through
        the injected param_loader."""
        if self.param_loader is None:
            raise ValueError("reload requires a param_loader")
        # Load BEFORE broadcasting: a leader-side load failure must surface
        # before any follower has acted, or the group would serve v_old
        # leader shards beside v_new follower shards.
        self._swap(version, self.param_loader(version))
        log.info("hot-swapped to version %d", version)

    def _swap(self, version: int, params) -> None:
        """Broadcast RELOAD and bind already-loaded params (the one swap
        path of reload() and watcher_loader)."""
        with self._lock:
            self._collective(self._header, _OP_RELOAD, version)
            self.params = self._place(params)
            self.version = version

    def _place(self, params):
        if not self.place_loaded:
            return params
        dev = self.device
        return tree_map_with_path(lambda _p, leaf: leaf.to(dev), params)

    def follow(self) -> None:
        """Processes 1..k-1: execute leader-broadcast steps until shutdown.

        A failing step re-raises after logging: the leader is blocked inside
        the same collective stream, so carrying on would only desynchronize
        it into a hang. Exiting fails the leader's next collective, which
        surfaces the error on every process."""
        while True:
            op, arg = self._collective(self._header, _OP_SHUTDOWN, 0)
            if op == _OP_SHUTDOWN:
                return
            if op == _OP_HEARTBEAT:
                continue
            try:
                if op == _OP_RELOAD:
                    if self.param_loader is None:
                        raise ValueError(
                            "leader broadcast RELOAD but this follower has no param_loader"
                        )
                    self.params = self._place(self.param_loader(arg))
                    self.version = arg
                else:
                    batch = self._collective(self._payload, arg, None)
                    self._collective(self._step, batch)
            except Exception:
                log.exception("follower step failed; exiting so the leader's next "
                              "collective surfaces it")
                raise

    def shutdown(self) -> None:
        """Process 0: release followers."""
        self.stop_heartbeat()
        with self._lock:
            self._collective(self._header, _OP_SHUTDOWN, 0)

    def heartbeat(self) -> None:
        """Process 0: one no-op header; raises when a follower is gone."""
        with self._lock:
            self._collective(self._header, _OP_HEARTBEAT, 0)

    def start_heartbeat(self, interval_s: float) -> None:
        """Process 0: a daemon thread sending heartbeat() every interval_s
        until stop_heartbeat() or the first failure (then `failed` is set)."""
        if self._hb_thread is not None:
            return

        def loop():
            while not self._hb_stop.wait(interval_s):
                try:
                    self.heartbeat()
                except Exception:  # noqa: BLE001 — recorded in self.failure
                    log.exception("multihost heartbeat failed")
                    return

        self._hb_thread = threading.Thread(target=loop, name="multihost-heartbeat",
                                           daemon=True)
        self._hb_thread.start()

    def stop_heartbeat(self) -> None:
        self._hb_stop.set()
        th, self._hb_thread = self._hb_thread, None
        if th is not None and th is not threading.current_thread():
            th.join(timeout=60)

    def as_run_fn(self, output_key: str = "prediction_node"):
        """Adapter matching DynamicBatcher's run_fn contract
        (run_fn(servable, arrays) -> {key: array}).

        Configure the batcher with the SAME ladder —
        ``DynamicBatcher(buckets=runner.buckets, run_fn=runner.as_run_fn())``
        — so each dispatch pads to the smallest bucket that fits. The
        batcher slices each request's rows back out of the returned
        bucket-sized scores."""

        def run(servable, arrays: dict[str, np.ndarray]):
            del servable  # params are runner-owned (RELOAD swaps them)
            n = next(iter(arrays.values())).shape[0]
            bucket = next((b for b in self.buckets if n <= b), None)
            if bucket is None:
                raise ValueError(
                    f"batch of {n} exceeds largest multihost bucket {self.buckets[-1]}"
                )
            zeros = self._zeros[bucket]
            padded = {}
            for k in self._keys:
                tmpl = zeros[k]
                if k not in arrays:
                    padded[k] = tmpl  # optional input (e.g. dense): zeros
                    continue
                arr = np.asarray(arrays[k])
                if arr.shape == tmpl.shape and arr.dtype == tmpl.dtype:
                    padded[k] = arr  # already bucket-shaped: the steady state
                    continue
                arr = arr.astype(tmpl.dtype, copy=False)
                buf = np.zeros_like(tmpl)
                buf[:n] = arr
                padded[k] = buf
            return {output_key: self.lead(padded)}

        return run

    def watcher_loader(self, base_loader: Callable[[int, Any], Any]):
        """Wrap a VersionWatcher loader so a version load on the leader
        hot-swaps the WHOLE group: the wrapped loader loads the servable
        (leader-side), then broadcasts RELOAD so every follower's
        param_loader picks up the same version, and binds the new params to
        this runner. Use on process 0 only; followers sit in follow()."""

        def load(version: int, path):
            servable = base_loader(version, path)
            if self.param_loader is None:
                raise ValueError(
                    "watcher integration requires a param_loader (the "
                    "followers load versions through it)"
                )
            # The leader binds the just-loaded params directly (no second
            # checkpoint read); the RELOAD broadcast sends followers to
            # their own param_loader for the same version.
            self._swap(version, servable.params)
            log.info("hot-swapped to version %d (watcher)", version)
            return servable

        return load
