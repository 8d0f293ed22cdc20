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
)
from .embeddings import embedding_init, field_embed


@register_model("dlrm")
def build_dlrm(config: ModelConfig) -> Model:
    D = config.embed_dim
    F = config.num_fields
    if config.bottom_mlp_dims[-1] != D:
        # The bottom MLP output joins the interaction as one more "field".
        raise ValueError(
            f"bottom_mlp_dims[-1] ({config.bottom_mlp_dims[-1]}) must equal embed_dim ({D})"
        )
    num_feat = F + 1  # sparse fields + the bottom-MLP dense "field"
    num_pairs = num_feat * (num_feat - 1) // 2
    top_in = D + num_pairs
    # Flat [i * num_feat + j] positions of the upper triangle (k = 1), in
    # row-major order like jnp.triu_indices; one tensor per device.
    iu, ju = np.triu_indices(num_feat, k=1)
    pairs_host = torch.from_numpy((iu * num_feat + ju).astype(np.int64))
    pairs_on: dict[torch.device, torch.Tensor] = {}

    def pairs(device: torch.device) -> torch.Tensor:
        idx = pairs_on.get(device)
        if idx is None:
            idx = pairs_on[device] = pairs_host.to(device)
        return idx

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
        cd = config.cdtype
        ids = batch["feat_ids"]
        n = ids.shape[0]
        dense = batch.get("dense_features")
        if dense is None:
            dense = torch.zeros((n, config.num_dense_features), dtype=torch.float32,
                                device=ids.device)
        bot = mlp_apply(params["bottom_mlp"], dense, cd)  # [n, D] f32
        emb = field_embed(params["embedding"], ids, batch["feat_wts"], cd)
        z = torch.cat([bot[:, None, :].to(cd), emb], dim=1).float()  # [n, F+1, D]
        zzt = torch.bmm(z, z.transpose(1, 2))  # [n, F+1, F+1] f32
        inter = zzt.reshape(n, num_feat * num_feat)[:, pairs(zzt.device)]
        top = torch.cat([bot, inter], dim=-1)
        logit = dense_apply(params["out"], mlp_apply(params["top_mlp"], top, cd), cd)[:, 0]
        return {"prediction_node": torch.sigmoid(logit), "logits": logit}

    return Model(config=config, init=init, apply=apply, shapes=shapes)
