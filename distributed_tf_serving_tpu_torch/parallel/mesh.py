"""Device mesh construction and sharding vocabulary.

A mesh is a ("data", "model") grid of torch devices, as in the JAX
package:

- "data":  the candidate (batch) dimension; each data shard scores a
           contiguous block of rows.
- "model": embedding vocab rows (the EP axis; dense weights too with tensor
           parallelism): a vocab-major table is split over it in contiguous
           row blocks.

torch has no SPMD partitioner, so what XLA derives from a sharding
annotation in the JAX package is explicit here: the row scatter of a batch
(a copy of each contiguous block to its data shard's device) and the
ordered gather of the outputs (a concatenation in shard order) are
`scatter_rows` and `gather_rows` below; the masked vocab gather lives in
embedding_sharding.py and the weight all-gather in sharding.py.

The device list may repeat a device: eight logical shards over "cpu" (the
CPU tests) or a 2x2 mesh over "cuda:0" (one card) compute the same function
as eight devices would. A placed leaf keeps one block per mesh position;
blocks on the same device share storage (a slice is a view).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"


class PartitionSpec(tuple):
    """One axis name (or None) per leaf dimension, the port's stand-in for
    jax.sharding.PartitionSpec: P(MODEL_AXIS, None) splits dim 0 over the
    model axis, P() replicates. A tuple, so it compares with tuples."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A (data, model) grid of torch devices (row-major: data shard i holds
    positions (i, 0..model-1))."""

    devices: np.ndarray  # object array of torch.device, shape (data, model)

    @property
    def shape(self) -> dict[str, int]:
        d, m = self.devices.shape
        return {DATA_AXIS: int(d), MODEL_AXIS: int(m)}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device(self, i: int, j: int = 0) -> torch.device:
        return self.devices[i, j]

    def data_devices(self) -> list[torch.device]:
        """Each data shard's lead device (model position 0): where its
        forward runs."""
        return [self.devices[i, 0] for i in range(self.devices.shape[0])]

    def device_names(self) -> list[str]:
        """One label per mesh position, in row-major order: the device's
        name, with the position appended (`cpu/3`) when the list repeats a
        device, so per-device surfaces keep one entry per shard."""
        names = [str(d) for d in self.devices.flat]
        if len(set(names)) < len(names):
            names = [f"{n}/{k}" for k, n in enumerate(names)]
        return names

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={self.device_names()})"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A partition spec over a mesh (jax.sharding.NamedSharding's role)."""

    mesh: Mesh
    spec: PartitionSpec


def default_devices() -> list[torch.device]:
    """Every visible card, in index order. No card is an error: a mesh runs
    on the CPU only when the caller passes CPU devices explicitly."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "no CUDA device is visible; pass devices=[torch.device('cpu'), ...] "
            "to build a mesh on the CPU"
        )
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(
    n_devices: int | None = None,
    model_parallel: int = 1,
    devices=None,
) -> Mesh:
    """Build a ("data", "model") mesh over the first n devices of `devices`
    (an ordered list, which may repeat a device; default every visible
    card). model_parallel devices shard embedding vocab; the rest of the
    factorization shards candidates. model_parallel=1 gives pure candidate
    sharding."""
    devs = [torch.device(d) for d in (devices if devices is not None else default_devices())]
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    if n % model_parallel != 0:
        raise ValueError(f"n_devices={n} not divisible by model_parallel={model_parallel}")
    grid = np.empty((n // model_parallel, model_parallel), dtype=object)
    for k, d in enumerate(devs[:n]):
        grid[k // model_parallel, k % model_parallel] = d
    return Mesh(grid)


def candidate_sharding(mesh: Mesh) -> NamedSharding:
    """Rows (candidates) split over the data axis."""
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def vocab_sharding(mesh: Mesh) -> NamedSharding:
    """Embedding tables: vocab rows split over the model axis (EP)."""
    return NamedSharding(mesh, P(MODEL_AXIS, None))


def row_blocks(rows: int, parts: int) -> list[tuple[int, int]]:
    """The contiguous [lo, hi) row block of each of `parts` shards; rows
    must divide (the executor pads first)."""
    if rows % parts:
        raise ValueError(f"{rows} rows do not split evenly over {parts} data shards")
    step = rows // parts
    return [(i * step, (i + 1) * step) for i in range(parts)]


def scatter_rows(arrays: dict, mesh: Mesh) -> list[dict[str, torch.Tensor]]:
    """The row scatter: each data shard's contiguous block of every input
    (host numpy arrays or tensors), copied to that shard's lead device.
    uint16 host arrays (bf16 bit patterns, ops/transfer.py pack_host) travel
    as int16, as transfer.to_device sends them."""
    rows = next(iter(arrays.values())).shape[0]
    out = []
    for (lo, hi), dev in zip(row_blocks(rows, mesh.shape[DATA_AXIS]), mesh.data_devices()):
        block = {}
        for k, v in arrays.items():
            if isinstance(v, np.ndarray):
                v = v[lo:hi]
                if v.dtype == np.uint16:
                    v = v.view(np.int16)
                t = torch.from_numpy(np.ascontiguousarray(v))
            else:
                t = v[lo:hi]
            block[k] = t.to(dev)
        out.append(block)
    return out


def gather_rows(parts: list[dict[str, torch.Tensor]], device) -> dict[str, torch.Tensor]:
    """The ordered gather: each output's per-shard blocks concatenated in
    shard order on `device` (the reference's host-order merge). Serving
    outputs are candidate-major (the batcher slices every output per
    request by rows); a 0-d output is taken from the first shard."""
    out = {}
    for k, first in parts[0].items():
        vs = [p[k] for p in parts]
        if first.ndim >= 1:
            out[k] = torch.cat([v.to(device) for v in vs], dim=0)
        else:
            out[k] = first.to(device)
    return out
