"""Embedding tables and weighted field lookups.

One [vocab, dim] table; ids are folded into the vocab by modulo, gathered,
and scaled by the feature weight.
"""

from __future__ import annotations

import numpy as np
import torch


def embedding_init(rng: np.random.Generator, vocab_size: int, embed_dim: int, dtype,
                   device) -> torch.Tensor:
    # 1/sqrt(dim) scale keeps dot-product magnitudes O(1).
    t = rng.standard_normal((vocab_size, embed_dim), dtype=np.float32)
    t /= np.float32(embed_dim**0.5)
    return torch.from_numpy(t).to(device=device, dtype=dtype)


def fold_ids(ids: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Fold arbitrary int64 feature ids into table rows (modulo hashing;
    torch.remainder takes the divisor's sign, like jnp.remainder)."""
    return torch.remainder(ids, vocab_size).to(torch.int32)


def sparse_linear(
    table: torch.Tensor,
    feat_ids: torch.Tensor,
    feat_wts: torch.Tensor,
) -> torch.Tensor:
    """Per-id scalar-weight sum in float32: the Wide&Deep wide half and the
    DeepFM first-order term.

    table     [V]
    feat_ids  [n, F] int
    feat_wts  [n, F] float
    returns   [n] float32

    Runs in float32 whatever the model's compute dtype: the raw weights are
    never cast to it (unlike field_embed), which is why models using it opt
    out of the bf16 weight transfer (Model.wts_in_compute_dtype=False)."""
    rows = fold_ids(feat_ids, table.shape[0]).long()
    return torch.sum(table[rows].float() * feat_wts.float(), dim=-1)


def field_embed(
    table: torch.Tensor,
    feat_ids: torch.Tensor,
    feat_wts: torch.Tensor,
    compute_dtype,
) -> torch.Tensor:
    """Weighted per-field embedding lookup.

    table     [V, D]
    feat_ids  [n, F] int
    feat_wts  [n, F] float
    returns   [n, F, D] in compute_dtype

    The gathered rows AND the weights are cast to the compute dtype before
    they are multiplied (so in bf16 the product is rounded to bf16)."""
    rows = fold_ids(feat_ids, table.shape[0]).long()
    emb = table[rows]  # [n, F, D]
    return emb.to(compute_dtype) * feat_wts[..., None].to(compute_dtype)
