"""Wide&Deep CTR model (BASELINE.json: "Wide&Deep CTR SavedModel, 128-candidate
batch").

Wide half: a per-id scalar weight table summed over fields with the raw f32
feature weights (embeddings.sparse_linear). Deep half: an MLP over the shared
weighted embedding bag. Serving contract as DCN (feat_ids/feat_wts ->
prediction_node).
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
from .embeddings import embedding_init, field_embed, sparse_linear


def scalar_table_init(rng: np.random.Generator, vocab_size: int, dtype, device) -> torch.Tensor:
    """A [V] per-id scalar table (the wide half / first-order term), 0.01-scaled."""
    t = rng.standard_normal((vocab_size,), dtype=np.float32) * np.float32(0.01)
    return torch.from_numpy(t).to(device=device, dtype=dtype)


@register_model("wide_deep")
def build_wide_deep(config: ModelConfig) -> Model:
    d = config.num_fields * config.embed_dim

    def init(seed: int = 0, device="cpu"):
        rng = np.random.default_rng(seed)
        pd = config.pdtype
        return {
            "wide": scalar_table_init(rng, config.vocab_size, pd, device),
            "wide_bias": torch.zeros((), dtype=pd, device=device),
            "embedding": embedding_init(rng, config.vocab_size, config.embed_dim, pd, device),
            "mlp": mlp_init(rng, d, config.mlp_dims, pd, device),
            "out": dense_init(rng, config.mlp_dims[-1], 1, pd, device),
        }

    def shapes():
        pd = config.pdtype
        return {
            "wide": meta_tensor((config.vocab_size,), pd),
            "wide_bias": meta_tensor((), pd),
            "embedding": meta_tensor((config.vocab_size, config.embed_dim), pd),
            "mlp": mlp_shapes(d, config.mlp_dims, pd),
            "out": dense_shapes(config.mlp_dims[-1], 1, pd),
        }

    def apply(params, batch):
        cd = config.cdtype
        ids, wts = batch["feat_ids"], batch["feat_wts"]
        wide = sparse_linear(params["wide"], ids, wts) + params["wide_bias"].float()
        emb = field_embed(params["embedding"], ids, wts, cd)
        xd = mlp_apply(params["mlp"], emb.reshape(emb.shape[0], d), cd)
        logit = dense_apply(params["out"], xd, cd)[:, 0] + wide
        return {"prediction_node": torch.sigmoid(logit), "logits": logit}

    # The wide half reads the raw f32 weights: a bf16 weight transfer would
    # change its scores.
    return Model(config=config, init=init, apply=apply, shapes=shapes,
                 wts_in_compute_dtype=False)
