"""Two-tower retrieval model (BASELINE.json: "Two-tower retrieval (user/item
embed), 10k candidate scoring").

The first `num_user_fields` fields feed the user/context tower, the rest the
item tower. Each tower is an MLP (no ReLU after its last layer) over its part
of the weighted embedding bag; its output goes to f32 and is L2-normalized.
The score is the dot product of the two, times the `temperature` param. For
candidate scoring the caller replicates the user fields into each candidate
row, so the request stays feat_ids/feat_wts [n, F] -> prediction_node [n].
"""

from __future__ import annotations

import numpy as np
import torch

from .base import (
    Model,
    ModelConfig,
    meta_tensor,
    mlp_apply,
    mlp_init,
    mlp_shapes,
    register_model,
    sigmoid,
)
from .embeddings import embedding_init, field_embed


@register_model("two_tower")
def build_two_tower(config: ModelConfig) -> Model:
    nu = config.num_user_fields
    ni = config.num_fields - nu
    if ni <= 0:
        raise ValueError(f"num_user_fields={nu} must be < num_fields={config.num_fields}")
    du, di = nu * config.embed_dim, ni * config.embed_dim

    def init(seed: int = 0, device="cpu"):
        rng = np.random.default_rng(seed)
        pd = config.pdtype
        return {
            "embedding": embedding_init(rng, config.vocab_size, config.embed_dim, pd, device),
            "user_mlp": mlp_init(rng, du, config.mlp_dims, pd, device),
            "item_mlp": mlp_init(rng, di, config.mlp_dims, pd, device),
            "temperature": torch.tensor(10.0, dtype=pd, device=device),
        }

    def shapes():
        pd = config.pdtype
        return {
            "embedding": meta_tensor((config.vocab_size, config.embed_dim), pd),
            "user_mlp": mlp_shapes(du, config.mlp_dims, pd),
            "item_mlp": mlp_shapes(di, config.mlp_dims, pd),
            "temperature": meta_tensor((), pd),
        }

    def tower(layers, emb, cd):
        x = mlp_apply(layers, emb.reshape(emb.shape[0], -1), cd, final_relu=False).float()
        return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)

    def apply(params, batch):
        cd = config.cdtype
        emb = field_embed(params["embedding"], batch["feat_ids"], batch["feat_wts"], cd)
        u = tower(params["user_mlp"], emb[:, :nu], cd)
        v = tower(params["item_mlp"], emb[:, nu:], cd)
        score = torch.sum(u * v, dim=-1) * params["temperature"].float()
        return {"prediction_node": sigmoid(score), "logits": score}

    return Model(config=config, init=init, apply=apply, shapes=shapes)
