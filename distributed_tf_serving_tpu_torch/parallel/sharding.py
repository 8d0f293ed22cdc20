"""Parameter and batch sharding rules for the CTR model zoo.

Layout policy (the JAX package's, spec for spec):
- vocab-major tables (embedding bags, wide/linear scalar tables): rows split
  over the model axis, the memory-heavy EP dimension;
- dense MLP/cross weights: replicated by default, or with tensor_parallel
  split over the model axis: 2-D weights column-split on the output dim
  (row-split when only the input dim divides), a 1-D bias split only beside
  a column-split sibling of its length; dims that do not divide stay
  replicated;
- batches: candidates split over the data axis.

`place_params` stores each leaf as a ShardedLeaf: one block per mesh
position on that position's device. Where XLA would insert the collectives
a layout implies, the port does them explicitly: `ShardedLeaf.local(i)`
reassembles a model-split dense weight on data shard i's device (a weight
all-gather, so the product equals the replicated one), and the executor
gathers vocab rows through embedding_sharding.masked_vocab_gather.

Training places with `trainable=True`: every data row of the mesh gets a
replica of its own (distinct leaf tensors that require grad, even where
the mesh repeats a device), so a replica never shares a `.grad` with
another. Both collectives above are plain differentiable torch, so a data
shard's gradient flows back into its own row's blocks: the weight
all-gather hands each column block its slice, the masked vocab gather
scatter-adds into the rows of each vocab block it read.
`reduce_gradients` is then the data-axis all-reduce: every replica of a
block receives the sum, in data-row order, of the gradients its replicas
took, so replicas that start equal and step with equal optimizers stay
equal.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .embedding_sharding import tree_map_with_path
from .mesh import DATA_AXIS, MODEL_AXIS, Mesh, NamedSharding, P

# Parameter-tree keys holding vocab-major tables.
VOCAB_MAJOR_KEYS = ("embedding", "wide", "linear")


def param_shardings(
    params: Any,
    mesh: Mesh,
    tensor_parallel: bool = False,
    model_kind: str | None = None,
) -> Any:
    """NamedSharding tree matching `params`: vocab tables split over the
    model axis; dense weights replicated, or model-axis split when
    tensor_parallel (divisible dims only).

    model_kind (when the family has named rules in
    embedding_sharding.MODEL_PARTITION_RULES) resolves the vocab-table
    placements through those rules instead of the path-name heuristic;
    unmatched leaves fall through to the generic dense policy, so
    tensor_parallel behaves the same on both paths.

    A 1-D param (bias) is split over the model axis only when a sibling 2-D
    weight in the same subtree is column-split with a matching output dim:
    a column-split weight's output is split on features, so the bias
    matches the activation it adds into; a row-split weight's output is
    whole, so its bias stays replicated."""
    tp = mesh.shape[MODEL_AXIS]
    vocab_keys = set(VOCAB_MAJOR_KEYS)

    pin = None
    if model_kind is not None:
        from .embedding_sharding import partition_rules_for, rule_matcher

        rules = partition_rules_for(model_kind)
        if rules is not None:
            pin = rule_matcher(rules)

    def is_vocab(path) -> bool:
        return bool({p for p in path if isinstance(p, str)} & vocab_keys)

    # Output dims of column-split 2-D weights, per parent subtree: a 1-D
    # sibling of that length rides the same feature split.
    col_split_dims: dict[tuple, set[int]] = {}
    if tensor_parallel and tp > 1:
        def scan(path, leaf):
            if (
                getattr(leaf, "ndim", 0) == 2
                and not is_vocab(path)
                and leaf.shape[1] % tp == 0
            ):
                col_split_dims.setdefault(path[:-1], set()).add(leaf.shape[1])
            return leaf

        tree_map_with_path(scan, params)

    def rule(path, leaf):
        ndim = getattr(leaf, "ndim", 0)
        if pin is not None:
            spec = pin(path, leaf)
            if spec is not None:
                return NamedSharding(mesh, spec)
        if is_vocab(path) and ndim >= 1:
            return NamedSharding(mesh, P(MODEL_AXIS, *(None,) * (ndim - 1)))
        if tensor_parallel and tp > 1:
            shape = tuple(getattr(leaf, "shape", ()))
            if ndim == 2:
                if shape[1] % tp == 0:  # column split (output features)
                    return NamedSharding(mesh, P(None, MODEL_AXIS))
                if shape[0] % tp == 0:  # row split (input features)
                    return NamedSharding(mesh, P(MODEL_AXIS, None))
            elif ndim == 1 and shape[0] in col_split_dims.get(path[:-1], ()):
                return NamedSharding(mesh, P(MODEL_AXIS))
        return NamedSharding(mesh, P())

    return tree_map_with_path(rule, params)


def batch_shardings(batch: dict, mesh: Mesh) -> dict:
    """Candidate-dim sharding for every input array."""
    return {
        k: NamedSharding(mesh, P(DATA_AXIS, *(None,) * (v.ndim - 1)))
        for k, v in batch.items()
    }


@dataclasses.dataclass(frozen=True)
class Shard:
    """One mesh position's block of a placed leaf."""

    device: torch.device
    index: tuple[int, int]  # (data, model) position
    data: torch.Tensor


@dataclasses.dataclass(eq=False)
class ShardedLeaf:
    """A param placed on a mesh: blocks[i][j] is the block mesh position
    (i, j) holds (the whole leaf where the spec replicates it, the j-th
    contiguous slice of its split dim where it names the model axis)."""

    sharding: NamedSharding
    shape: tuple
    dtype: torch.dtype
    blocks: list[list[torch.Tensor]]

    @property
    def spec(self) -> P:
        return self.sharding.spec

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def split_dim(self) -> int | None:
        """The dim split over the model axis, or None (replicated)."""
        for d, axis in enumerate(self.spec):
            if axis == MODEL_AXIS:
                return d
        return None

    @property
    def addressable_shards(self) -> list[Shard]:
        mesh = self.sharding.mesh
        return [Shard(mesh.device(i, j), (i, j), blk)
                for i, row in enumerate(self.blocks) for j, blk in enumerate(row)]

    def local(self, i: int) -> torch.Tensor:
        """The whole leaf on data shard i's lead device: its own block when
        replicated, else the model-axis blocks concatenated in shard order
        there (the weight all-gather)."""
        row = self.blocks[i]
        d = self.split_dim
        if d is None:
            return row[0]
        dev = self.sharding.mesh.device(i, 0)
        return torch.cat([blk.to(dev) for blk in row], dim=d)

    def gather(self, device=None, grad: bool = False) -> torch.Tensor:
        """The whole leaf (or, with grad=True, its gradient) as one plain
        tensor on `device` (default: data shard 0's lead device), detached:
        what `np.asarray` of a sharded array is in the JAX package."""
        dev = torch.device(device) if device is not None else self.sharding.mesh.device(0, 0)
        row = [blk.grad if grad else blk for blk in self.blocks[0]]
        if any(t is None for t in row):
            return None
        row = [t.detach().to(dev) for t in row]
        d = self.split_dim
        return row[0] if d is None else torch.cat(row, dim=d)

    def distinct(self) -> list[torch.Tensor]:
        """Every distinct block tensor once, in mesh order (positions that
        share a tensor count it once)."""
        seen: dict[int, torch.Tensor] = {}
        for row in self.blocks:
            for blk in row:
                seen.setdefault(id(blk), blk)
        return list(seen.values())

    def replicas(self) -> list[list[torch.Tensor]]:
        """For each model-axis part (one when replicated), its distinct
        block tensors across the mesh in mesh order: the tensors that must
        hold the same values."""
        parts: dict[int, dict[int, torch.Tensor]] = {}
        split = self.split_dim is not None
        for row in self.blocks:
            for j, blk in enumerate(row):
                parts.setdefault(j if split else 0, {}).setdefault(id(blk), blk)
        return [list(group.values()) for _, group in sorted(parts.items())]

    def detached(self) -> "ShardedLeaf":
        """A copy of this leaf with every distinct block cloned once (the
        sharing between positions, and so the placement, preserved)."""
        clones: dict[int, torch.Tensor] = {}
        blocks = [[clones.setdefault(id(blk), blk.detach().clone()) for blk in row]
                  for row in self.blocks]
        return ShardedLeaf(sharding=self.sharding, shape=self.shape, dtype=self.dtype,
                           blocks=blocks)


def same_mesh(a: Mesh, b: Mesh) -> bool:
    """Two meshes over the same devices in the same (data, model) grid."""
    return a is b or (a.devices.shape == b.devices.shape
                      and all(x == y for x, y in zip(a.devices.flat, b.devices.flat)))


def put(leaf, sharding: NamedSharding, trainable: bool = False) -> ShardedLeaf:
    """Place one tensor per `sharding`: each mesh position gets its block on
    its device. Positions on the same device share one tensor (a slice of
    the leaf on its own device is a view, so a mesh over one device costs
    no copy). A leaf already placed with this sharding is returned as it
    is; one placed otherwise is gathered and placed again.

    trainable=True gives every data row its own blocks: fresh contiguous
    leaf tensors that require grad, shared only between the positions of
    one row on one device."""
    mesh = sharding.mesh
    spec = sharding.spec
    if isinstance(leaf, ShardedLeaf):
        if (not trainable and tuple(leaf.spec) == tuple(spec)
                and same_mesh(leaf.sharding.mesh, mesh)):
            return leaf
        leaf = leaf.gather()
    split = next((d for d, axis in enumerate(spec) if axis == MODEL_AXIS), None)
    if any(axis == DATA_AXIS for axis in spec):
        raise ValueError(f"params are never split over the data axis (spec {spec})")
    k = mesh.shape[MODEL_AXIS]
    if split is not None and leaf.shape[split] % k:
        raise ValueError(
            f"dim {split} of a {tuple(leaf.shape)} param is not divisible by "
            f"model-axis size {k}")
    made: dict[tuple, torch.Tensor] = {}
    blocks = []
    for i in range(mesh.shape[DATA_AXIS]):
        row = []
        for j in range(k):
            dev = mesh.device(i, j)
            part = 0 if split is None else j
            key = (i if trainable else None, str(dev), part)
            blk = made.get(key)
            if blk is None:
                src = leaf if split is None else leaf.narrow(
                    split, j * (leaf.shape[split] // k), leaf.shape[split] // k)
                if trainable:
                    src = src.detach().to(dev).clone(memory_format=torch.contiguous_format)
                    blk = made[key] = src.requires_grad_(True)
                else:
                    blk = made[key] = src.to(dev)
            row.append(blk)
        blocks.append(row)
    return ShardedLeaf(sharding=sharding, shape=tuple(leaf.shape), dtype=leaf.dtype,
                       blocks=blocks)


def place_params(
    params: Any,
    mesh: Mesh,
    tensor_parallel: bool = False,
    model_kind: str | None = None,
    trainable: bool = False,
) -> Any:
    """Place a param tree according to param_shardings (model_kind routes
    the vocab tables through the named partition rules): the same tree of
    ShardedLeaf. trainable=True places one trainable replica per data row
    (see `put`)."""
    shardings = param_shardings(params, mesh, tensor_parallel, model_kind)
    flat: dict[tuple, NamedSharding] = {}
    tree_map_with_path(lambda path, s: flat.__setitem__(path, s), shardings)
    return tree_map_with_path(lambda path, leaf: put(leaf, flat[path], trainable), params)


def placed_leaves(placed: Any) -> list[ShardedLeaf]:
    """The ShardedLeaf leaves of a placed tree, in tree order."""
    out: list[ShardedLeaf] = []
    tree_map_with_path(lambda _p, leaf: out.append(leaf), placed)
    return out


def gather_params(placed: Any, device=None) -> Any:
    """A placed tree as a plain tree of whole tensors on `device` (default
    data shard 0's lead device), for save_servable or a single-device
    server. Plain tensors pass through."""
    return tree_map_with_path(
        lambda _p, leaf: leaf.gather(device) if isinstance(leaf, ShardedLeaf) else leaf, placed)


@torch.no_grad()
def reduce_gradients(placed: Any) -> None:
    """The data-axis all-reduce of a trainable placed tree: for each part
    of each leaf, the gradients its replicas took are summed in mesh order
    on the first replica's device, and every replica's `.grad` becomes
    that sum (a replica that took none, a replicated leaf's copy at a
    model position > 0 on another device, receives it too)."""
    for leaf in placed_leaves(placed):
        for group in leaf.replicas():
            grads = [t.grad for t in group if t.grad is not None]
            if not grads:
                continue
            dev = group[0].device
            total = grads[0].to(dev, copy=True)
            for g in grads[1:]:
                total += g.to(dev)
            for t in group:
                t.grad = total.to(t.device, copy=True)
