"""DLRM (BASELINE.json: "DLRM (embedding-bag heavy), v5e-8 ICI shard, 4k
batch").

A bottom MLP over the dense features, the per-field weighted embedding bag,
the pairwise dot-product interactions of [bottom output, fields] (the upper
triangle of Z Z^T without its diagonal), and a top MLP over [bottom output ++
interactions].

Serving contract: feat_ids/feat_wts [n, F] plus an optional `dense_features`
float [n, num_dense_features]; without it the dense features are zeros, so
the two-input request still serves. Z Z^T runs on compute-dtype operands with
an f32 result.

The interaction (gather, Z, the pairs) runs as one hand-written kernel on
the card in bf16 compute outside autograd (ops/dlrm_kernel.py, which raises
for a model it cannot take), and as the eager torch ops on the CPU, in
float32 compute and in training.
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
from .embeddings import embedding_init


@register_model("dlrm")
def build_dlrm(config: ModelConfig) -> Model:
    D = config.embed_dim
    F = config.num_fields
    if config.bottom_mlp_dims[-1] != D:
        # The bottom MLP output joins the interaction as one more "field".
        raise ValueError(
            f"bottom_mlp_dims[-1] ({config.bottom_mlp_dims[-1]}) must equal embed_dim ({D})"
        )
    num_pairs = (F + 1) * F // 2  # pairs of [bottom output, fields]
    top_in = D + num_pairs

    def init(seed: int = 0, device="cpu"):
        rng = np.random.default_rng(seed)
        pd = config.pdtype
        return {
            "embedding": embedding_init(rng, config.vocab_size, D, pd, device),
            "bottom_mlp": mlp_init(rng, config.num_dense_features, config.bottom_mlp_dims,
                                   pd, device),
            "top_mlp": mlp_init(rng, top_in, config.mlp_dims, pd, device),
            "out": dense_init(rng, config.mlp_dims[-1], 1, pd, device),
        }

    def shapes():
        pd = config.pdtype
        return {
            "embedding": meta_tensor((config.vocab_size, D), pd),
            "bottom_mlp": mlp_shapes(config.num_dense_features, config.bottom_mlp_dims, pd),
            "top_mlp": mlp_shapes(top_in, config.mlp_dims, pd),
            "out": dense_shapes(config.mlp_dims[-1], 1, pd),
        }

    def apply(params, batch):
        from ..ops.dlrm_kernel import dlrm_interact, interact_eager

        cd = config.cdtype
        ids = batch["feat_ids"]
        n = ids.shape[0]
        dense = batch.get("dense_features")
        if dense is None:
            dense = torch.zeros((n, config.num_dense_features), dtype=torch.float32,
                                device=ids.device)
        bot = mlp_apply(params["bottom_mlp"], dense, cd)  # [n, D] f32
        table, wts = params["embedding"], batch["feat_wts"]
        records_grad = torch.is_grad_enabled() and any(
            t.requires_grad for t in (table, bot, wts))
        if ids.is_cuda and cd == torch.bfloat16 and not records_grad:
            top = dlrm_interact(ids, wts, table, bot, cd)  # [n, top_in] bf16
        else:
            top = interact_eager(ids, wts, table, bot, cd)  # [n, top_in] f32
        logit = dense_apply(params["out"], mlp_apply(params["top_mlp"], top, cd), cd)[:, 0]
        return {"prediction_node": sigmoid(logit), "logits": logit}

    return Model(config=config, init=init, apply=apply, shapes=shapes)
