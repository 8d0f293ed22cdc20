"""DeepFM CTR model (BASELINE.json: "DeepFM CTR (Criteo-1TB features),
batch_size=512").

First-order term: per-id scalar weights over the raw f32 feature weights
(embeddings.sparse_linear). Second-order FM term over the embedding bag by
the O(n·F·D) identity 0.5 * ((sum_f e_f)^2 - sum_f e_f^2). Deep half: an MLP
over the same bag.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import (
    Model,
    ModelConfig,
    dense_apply,
    dense_init,
    dense_shapes,
    meta_tensor,
    mlp_apply,
    mlp_init,
    mlp_shapes,
    register_model,
    sigmoid,
)
from .embeddings import embedding_init, field_embed, sparse_linear
from .wide_deep import scalar_table_init


def fm_second_order(emb: torch.Tensor) -> torch.Tensor:
    """emb [n, F, D] (any float dtype) -> the FM interaction [n], in f32."""
    e = emb.float()
    sum_sq = torch.square(torch.sum(e, dim=1))  # [n, D]
    sq_sum = torch.sum(torch.square(e), dim=1)  # [n, D]
    return 0.5 * torch.sum(sum_sq - sq_sum, dim=-1)


@register_model("deepfm")
def build_deepfm(config: ModelConfig) -> Model:
    d = config.num_fields * config.embed_dim

    def init(seed: int = 0, device="cpu"):
        rng = np.random.default_rng(seed)
        pd = config.pdtype
        return {
            "linear": scalar_table_init(rng, config.vocab_size, pd, device),
            "bias": torch.zeros((), dtype=pd, device=device),
            "embedding": embedding_init(rng, config.vocab_size, config.embed_dim, pd, device),
            "mlp": mlp_init(rng, d, config.mlp_dims, pd, device),
            "out": dense_init(rng, config.mlp_dims[-1], 1, pd, device),
        }

    def shapes():
        pd = config.pdtype
        return {
            "linear": meta_tensor((config.vocab_size,), pd),
            "bias": meta_tensor((), pd),
            "embedding": meta_tensor((config.vocab_size, config.embed_dim), pd),
            "mlp": mlp_shapes(d, config.mlp_dims, pd),
            "out": dense_shapes(config.mlp_dims[-1], 1, pd),
        }

    def apply(params, batch):
        cd = config.cdtype
        ids, wts = batch["feat_ids"], batch["feat_wts"]
        first = sparse_linear(params["linear"], ids, wts)
        emb = field_embed(params["embedding"], ids, wts, cd)
        second = fm_second_order(emb)
        h = mlp_apply(params["mlp"], emb.reshape(emb.shape[0], d), cd)
        deep = dense_apply(params["out"], h, cd)[:, 0]
        logit = first + second + deep + params["bias"].float()
        return {"prediction_node": sigmoid(logit), "logits": logit}

    # The first-order term reads the raw f32 weights: a bf16 weight
    # transfer would change its scores.
    return Model(config=config, init=init, apply=apply, shapes=shapes,
                 wts_in_compute_dtype=False)
