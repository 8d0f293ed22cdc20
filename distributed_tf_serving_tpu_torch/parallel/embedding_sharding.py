"""Vocab-sharded embedding lookups (the EP axis) and the named partition
rules.

A vocab-major table split over the model axis holds vocab/k contiguous rows
per model shard. A lookup gathers each id's row from the one shard that
holds it: every shard looks up the ids that fall in its block (a clipped
gather, the rest masked to zero), and the partial results are summed over
the model axis in shard order. Exactly one shard contributes each row, so
the sum is the single-device lookup. `masked_vocab_gather` is that gather
for one data shard; `sharded_field_embed` is the weighted field lookup
built on it over a whole mesh; the sharded executor (executor.py) uses the
same gather to build each data shard's compact table. All of it is plain
torch: the JAX package computes it with jnp.take outside any Pallas
kernel.

The partition rules pin, per model family, the layout of the vocab-major
tables: ordered (regex, PartitionSpec) pairs matched against the "/"-joined
param path, first match wins. A rule that places more dims than the leaf
has is a config error; an unmatched leaf returns None, so the caller falls
back to the generic dense policy (sharding.param_shardings).
"""

from __future__ import annotations

import re

import torch

from .mesh import DATA_AXIS, MODEL_AXIS, Mesh, P, row_blocks


def tree_map_with_path(fn, tree, path: tuple = ()):
    """`fn(path, leaf)` over a param tree of dicts and lists; the path holds
    dict keys (str) and list indices (int), as jax key paths do."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def tree_path_str(path) -> str:
    """Key path -> "/"-joined name ("cross/0/w") for rule matching."""
    return "/".join(str(p) for p in path)


# Per-family rules. Only the vocab-major tables are pinned here: they are
# the memory of an embedding-dominated CTR model and the one layout
# decision that must not silently change with a param rename. Dense
# MLP/cross weights fall through (None) to the generic policy, so
# tensor_parallel behaves the same on both paths.
MODEL_PARTITION_RULES: dict[str, tuple[tuple[str, P], ...]] = {
    "dcn": (("^embedding$", P(MODEL_AXIS, None)),),
    "dcn_v2": (("^embedding$", P(MODEL_AXIS, None)),),
    "dlrm": (("^embedding$", P(MODEL_AXIS, None)),),
    "two_tower": (
        ("^embedding$", P(MODEL_AXIS, None)),
        ("^temperature$", P()),  # scalar: explicit, never sharded
    ),
    "wide_deep": (
        ("^embedding$", P(MODEL_AXIS, None)),
        ("^wide$", P(MODEL_AXIS)),  # per-vocab-row scalar table (EP too)
        ("^wide_bias$", P()),
    ),
    "deepfm": (
        ("^embedding$", P(MODEL_AXIS, None)),
        ("^linear$", P(MODEL_AXIS)),
    ),
    "generic_mlp": (("^embedding$", P(MODEL_AXIS, None)),),
}


def partition_rules_for(model_kind: str) -> tuple[tuple[str, P], ...] | None:
    """The family's ordered (regex, PartitionSpec) rules, or None for a
    family without rules (imported graphs, custom servables): callers then
    use the generic path-name layout."""
    return MODEL_PARTITION_RULES.get(model_kind)


def rule_matcher(rules, strict: bool = False):
    """(path, leaf) -> PartitionSpec-or-None resolver for an ordered rule
    list, shared by match_partition_rules and sharding.param_shardings.

    Scalars are never partitioned. A matched spec whose rank exceeds the
    leaf's raises (the table the rule was written for changed shape).
    Unmatched leaves yield None (generic-policy fallback); strict=True
    makes them errors."""
    compiled = [(re.compile(pat), spec) for pat, spec in rules]

    def resolve(path, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        if len(shape) == 0 or all(d == 1 for d in shape):
            return P()  # scalars/degenerate leaves are never partitioned
        name = tree_path_str(path)
        for pat, spec in compiled:
            if pat.search(name) is not None:
                if len(spec) > len(shape):
                    raise ValueError(
                        f"partition rule {pat.pattern!r} places "
                        f"{len(spec)} dims but param {name!r} has shape "
                        f"{shape} — the rule no longer matches the model"
                    )
                return spec
        if strict:
            raise ValueError(f"no partition rule matched param {name!r}")
        return None

    return resolve


def match_partition_rules(rules, params, strict: bool = False):
    """PartitionSpec-or-None tree for `params` per the ordered rules (see
    rule_matcher for the matching semantics)."""
    return tree_map_with_path(rule_matcher(rules, strict), params)


def masked_vocab_gather(blocks: list[torch.Tensor], ids: torch.Tensor, device) -> torch.Tensor:
    """Rows `ids` (already folded into [0, vocab)) of a table split into
    the contiguous row blocks `blocks` (model-axis order, each on its own
    device), on `device`: each block gathers the ids inside it (clipped
    gather, out-of-block rows masked to zero) and the partials are summed
    in shard order."""
    out = None
    lo = 0
    for blk in blocks:
        vshard = blk.shape[0]
        local = ids.to(blk.device, torch.int64) - lo
        in_shard = (local >= 0) & (local < vshard)
        emb = blk[local.clamp(0, vshard - 1)]
        mask = in_shard.reshape(in_shard.shape + (1,) * (emb.ndim - in_shard.ndim))
        emb = torch.where(mask, emb, torch.zeros((), dtype=emb.dtype, device=emb.device))
        emb = emb.to(device)
        out = emb if out is None else out + emb
        lo += vshard
    return out


def _model_blocks(table, mesh: Mesh, i: int) -> list[torch.Tensor]:
    """Data shard i's model-axis blocks of `table`: a placed leaf's own
    blocks (sharding.ShardedLeaf), or a full tensor split into views."""
    blocks = getattr(table, "blocks", None)
    if blocks is not None:
        return blocks[i]
    k = mesh.shape[MODEL_AXIS]
    step = table.shape[0] // k
    return [table[j * step:(j + 1) * step].to(mesh.device(i, j)) for j in range(k)]


def sharded_field_embed(
    table,
    feat_ids: torch.Tensor,
    feat_wts: torch.Tensor,
    mesh: Mesh,
    compute_dtype,
) -> torch.Tensor:
    """Weighted field lookup with the table sharded over the model axis and
    candidates sharded over the data axis.

    table     [V, D] tensor, or a placed leaf (sharding.place_params) with
              vocab_sharding (V divisible by the model-axis size)
    feat_ids  [n, F] int, already folded into [0, V); n divisible by the
              data-axis size
    feat_wts  [n, F] float
    returns   [n, F, D] in compute_dtype on the mesh's first device, in
              candidate order"""
    vocab = table.shape[0]
    k = mesh.shape[MODEL_AXIS]
    if vocab % k != 0:
        raise ValueError(f"vocab {vocab} not divisible by model-axis size {k}")
    parts = []
    for i, (lo, hi) in enumerate(row_blocks(feat_ids.shape[0], mesh.shape[DATA_AXIS])):
        dev = mesh.device(i, 0)
        emb = masked_vocab_gather(_model_blocks(table, mesh, i), feat_ids[lo:hi].to(dev), dev)
        wts = feat_wts[lo:hi].to(dev)
        parts.append(emb.to(compute_dtype) * wts[..., None].to(compute_dtype))
    first = mesh.device(0, 0)
    return torch.cat([p.to(first) for p in parts], dim=0)
