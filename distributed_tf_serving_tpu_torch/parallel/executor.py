"""Sharded serving executor: candidate scatter / score / ordered gather on a
device mesh.

Drops into DynamicBatcher through its run_fn hook, so the batching logic is
unchanged while execution spans the mesh: the batch's rows are split
contiguously over the data axis (mesh.scatter_rows), each data shard runs
the family's unchanged `model.apply` on its own device, and the outputs are
concatenated back in shard order (mesh.gather_rows), so scores come back in
the reference's concat order.

What XLA derives from the layout in the JAX package is explicit here:

- **EP.** For a family with named partition rules and a model axis > 1,
  each data shard gathers the rows its (folded) ids need from every vocab
  shard (embedding_sharding.masked_vocab_gather) into a compact table,
  remaps its ids into that table, and calls `apply` over it. `fold_ids` is
  a modulo, so ids below the compact table's size fold to themselves and
  the gathered rows are the single-device rows, bit for bit. Every
  vocab-major table of the family (`embedding`, `wide`, `linear`) is
  compacted with the same ids. A family without rules gathers its split
  leaves whole instead (ShardedLeaf.local), which is exact too.
- **TP.** A model-split dense weight is reassembled on the data shard's
  device before the forward (ShardedLeaf.local, a weight all-gather), so
  scores equal the replicated ones.

Serving contract, as the JAX executor's:

- **Data-axis divisibility is the executor's problem.** A bucket of any
  size is padded with zero rows to the next multiple of the data-axis size,
  and the outputs are sliced back to the real rows BEFORE the wire
  compaction (the int8 wire's range never sees pad rows).
- **Output selection (out_keys) is honoured**: each shard's unwanted
  outputs are dropped before the gather and never cross to the host
  (supports_out_keys tells the batcher to pass the group's union through).
- **Named partition rules** place the params when the servable's model kind
  has an entry in embedding_sharding.MODEL_PARTITION_RULES, the generic
  path-name layout otherwise; snapshot() names the source per model.
- **Thread-safe placement cache + serving counters** (batches / rows / pad
  work), the `mesh` /monitoring block and the dts_tpu_mesh_* series.

On the card a dcn_v2 with `use_pallas_cross` launches the cross-stack
kernel in every shard's forward, through the same wrapper as the
single-device path (models/dcn.py). `shard_map_score` is the plain
formulation of the same scatter / score / gather with replicated params.
"""

from __future__ import annotations

import contextlib
import threading
import weakref
from typing import Any

import numpy as np
import torch

from ..models.embeddings import fold_ids
from ..models.registry import Servable
from ..ops.transfer import (
    compact_outputs_device,
    output_wire_dtype as _wire_dtype_of,
    pack_host,
    transfer_spec,
    unpack_device,
)
from .embedding_sharding import (
    masked_vocab_gather,
    partition_rules_for,
    tree_map_with_path,
)
from .mesh import DATA_AXIS, MODEL_AXIS, Mesh, gather_rows, scatter_rows
from .sharding import VOCAB_MAJOR_KEYS, place_params


def device_scope(dev: torch.device):
    """The forward of a shard on another card launches on that card."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def compacted_keys(placed, mesh: Mesh) -> tuple[str, ...]:
    """The top-level vocab-major tables a data shard compacts: those split
    over a model axis > 1 on their rows, all of one vocab size."""
    if mesh.shape[MODEL_AXIS] == 1 or not isinstance(placed, dict):
        return ()
    keys = tuple(k for k in VOCAB_MAJOR_KEYS
                 if k in placed and hasattr(placed[k], "split_dim")
                 and placed[k].split_dim == 0)
    if len({placed[k].shape[0] for k in keys}) > 1:
        return ()  # tables of different vocab sizes: gathered whole
    return keys


def shard_params(placed, compact: tuple, i: int, batch: dict[str, torch.Tensor]):
    """(params, batch) of data shard i for model.apply on its lead device:
    the compact tables of its ids (EP: the masked vocab gather of the rows
    they fold to, the ids remapped into them), every other leaf whole
    (ShardedLeaf.local: its own block, or the TP weight all-gather). Both
    gathers are differentiable, so under autograd the shard's gradient
    reaches the blocks of its own row."""
    if not compact:
        return tree_map_with_path(lambda _p, leaf: leaf.local(i), placed), batch
    dev = placed[compact[0]].sharding.mesh.device(i, 0)
    rows = fold_ids(batch["feat_ids"], placed[compact[0]].shape[0])
    uniq, inv = torch.unique(rows, return_inverse=True)
    gathered = {k: masked_vocab_gather(placed[k].blocks[i], uniq, dev) for k in compact}

    def local(path, leaf):
        if len(path) == 1 and path[0] in gathered:
            return gathered[path[0]]
        return leaf.local(i)

    return tree_map_with_path(local, placed), dict(batch, feat_ids=inv.to(torch.int32))


class ShardedExecutor:
    """run_fn for DynamicBatcher executing over a mesh.

    Params are placed once per servable (vocab tables split over the model
    axis per the family's named partition rules, the rest replicated or,
    with tensor_parallel, model-split) and re-placed when servable.params
    is swapped. output_wire_dtype mirrors the batcher's output compaction:
    float32 outputs are downcast on the device before the readback, and the
    batcher's completer widens them back."""

    # The batcher passes the group's output-selection union through
    # run_fn(servable, arrays, out_keys=...) when this is True.
    supports_out_keys = True

    def __init__(
        self,
        mesh: Mesh,
        compress_transfer: bool = True,
        tensor_parallel: bool = False,
        output_wire_dtype: str = "float32",
    ):
        self.mesh = mesh
        self.compress_transfer = compress_transfer
        self.tensor_parallel = tensor_parallel
        self.output_wire_dtype = output_wire_dtype
        self._wire_dt = _wire_dtype_of(output_wire_dtype)  # an unknown name raises here
        # Weak keys: an unloaded servable must not pin its placed params.
        self._placed: weakref.WeakKeyDictionary[Servable, Any] = weakref.WeakKeyDictionary()
        self._entries: weakref.WeakKeyDictionary[Servable, Any] = weakref.WeakKeyDictionary()
        # _prepare is reached from the dispatch thread, the batcher thread
        # (warmup) and measurement harnesses: one lock keeps placement
        # single-shot and the counters whole.
        self._lock = threading.Lock()
        self.batches = 0
        self.rows = 0  # batch rows received (the batcher's bucket sizes)
        self.data_pad_rows = 0  # zero rows added for data-axis divisibility
        self.pad_batches = 0  # batches that needed the divisibility pad
        self.rules_used: dict[str, str] = {}  # servable name -> layout source

    # ------------------------------------------------------------ internals

    def _prepare(self, servable: Servable):
        """(entry, placed params) for `servable`, built once and rebuilt when
        servable.params was swapped, so this path tracks live params like
        the batcher's own path does. The entry is (transfer spec, the
        vocab-major keys each data shard compacts)."""
        key = servable
        with self._lock:
            placed_for = self._placed.get(key)
            if placed_for is not None and placed_for[0] is not servable.params:
                del self._placed[key]
                self._entries.pop(key, None)
            entry = self._entries.get(key)
            if entry is None:
                model_kind = getattr(servable.model, "kind", "") or ""
                ruled = partition_rules_for(model_kind) is not None
                self.rules_used[servable.name] = f"rules:{model_kind}" if ruled else "generic"
                placed = place_params(servable.params, self.mesh, self.tensor_parallel,
                                      model_kind=model_kind or None)
                entry = self._entries[key] = (
                    transfer_spec(servable.model) if self.compress_transfer else {},
                    compacted_keys(placed, self.mesh) if ruled else (),
                )
                self._placed[key] = (servable.params, placed)
            return entry, self._placed[key][1]

    def _shard_forward(self, servable: Servable, placed, compact: tuple, i: int,
                       batch: dict[str, torch.Tensor], out_keys) -> dict[str, torch.Tensor]:
        """Data shard i's forward on its lead device: its params
        (shard_params), the unchanged model.apply, the output selection."""
        params, batch = shard_params(placed, compact, i, batch)
        out = servable.model.apply(params, batch)
        if out_keys is not None:
            out = {k: v for k, v in out.items() if k in out_keys} or out
        return out

    # ----------------------------------------------------------------- API

    def place(self, servable: Servable) -> None:
        """Place `servable`'s params on the mesh now (loaders call it before
        a version serves), not at its first batch."""
        self._prepare(servable)

    def __call__(
        self,
        servable: Servable,
        arrays: dict[str, np.ndarray],
        out_keys: tuple[str, ...] | None = None,
    ) -> dict[str, torch.Tensor]:
        (spec, compact), placed = self._prepare(servable)
        rows = next(iter(arrays.values())).shape[0]
        data = self.mesh.shape[DATA_AXIS]
        pad = (-rows) % data
        if pad:
            # Rows split contiguously over the data axis: pad with zero rows
            # to the next multiple (the zoo scores rows independently, so
            # pad rows never perturb real scores) and slice the outputs
            # back below. The bucket ladder stays the operator's choice.
            padded = {}
            for k, v in arrays.items():
                buf = np.zeros((rows + pad,) + v.shape[1:], v.dtype)
                buf[:rows] = v
                padded[k] = buf
            arrays = padded
        with self._lock:
            self.batches += 1
            self.rows += rows
            if pad:
                self.pad_batches += 1
                self.data_pad_rows += pad
        packed = pack_host(arrays, spec) if spec else arrays
        parts = []
        with torch.inference_mode():
            for i, block in enumerate(scatter_rows(packed, self.mesh)):
                with device_scope(self.mesh.device(i, 0)):
                    parts.append(self._shard_forward(
                        servable, placed, compact, i, unpack_device(block, spec), out_keys))
            out = gather_rows(parts, self.mesh.device(0, 0))
            if pad:
                # The pad comes off BEFORE the wire compaction: the int8
                # wire's per-tensor range is over the real rows only.
                out = {k: v[:rows] if v.ndim >= 1 else v for k, v in out.items()}
            return compact_outputs_device(out, self._wire_dt)

    def clear_for_recovery(self) -> None:
        """REINIT hook (serving/recovery.py): drop the placed params and the
        entries; after a device failure they reference the dead context.
        The recovery re-warm places them again through the queue before
        replay: the executor recovers as ONE unit."""
        with self._lock:
            self._placed = weakref.WeakKeyDictionary()
            self._entries = weakref.WeakKeyDictionary()

    def snapshot(self) -> dict:
        """The `mesh` /monitoring block body: mesh geometry, devices, serving
        counters and the layout source per served model. Per-device
        occupancy rides in from the utilization ledger at the impl layer
        (every batch occupies every shard's device)."""
        with self._lock:
            counters = {
                "batches": self.batches,
                "rows": self.rows,
                "pad_batches": self.pad_batches,
                "data_pad_rows": self.data_pad_rows,
                "placed_servables": len(self._placed),
                "layout": dict(self.rules_used),
            }
        return {
            "enabled": True,
            "shape": {str(k): int(v) for k, v in self.mesh.shape.items()},
            "devices": self.mesh.device_names(),
            "tensor_parallel": self.tensor_parallel,
            "output_wire_dtype": self.output_wire_dtype,
            "executor": counters,
        }


def shard_map_score(servable: Servable, mesh: Mesh):
    """Explicit scatter / score / gather: each data shard scores its
    contiguous candidate block with replicated params on its device; the
    scores are concatenated in shard order. Returns fn(params, batch) ->
    prediction_node on the mesh's first device."""
    apply = servable.model.apply

    def run(params, batch: dict) -> torch.Tensor:
        parts = []
        with torch.inference_mode():
            for i, block in enumerate(scatter_rows(batch, mesh)):
                dev = mesh.device(i, 0)
                local = tree_map_with_path(lambda _p, leaf: leaf.to(dev), params)
                with device_scope(dev):
                    parts.append({"prediction_node": apply(local, block)["prediction_node"]})
        return gather_rows(parts, mesh.device(0, 0))["prediction_node"]

    return run
