"""Generic embed + MLP family: the plain DNN classifier, for exports that are
structurally "embedding bag -> dense chain -> logit" but no other family.

  x0    = flatten(field_embed(ids, wts))      [n, F*D]
  h     = relu MLP over mlp_dims              [n, mlp_dims[-1]]  (x0 when mlp_dims = ())
  logit = dense(h)                            [n]
  prediction_node = sigmoid(logit)
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
from .embeddings import embedding_init, field_embed


@register_model("generic")
def build_generic(config: ModelConfig) -> Model:
    d = config.num_fields * config.embed_dim
    head_in = config.mlp_dims[-1] if config.mlp_dims else d

    def init(seed: int = 0, device="cpu"):
        rng = np.random.default_rng(seed)
        pd = config.pdtype
        return {
            "embedding": embedding_init(rng, config.vocab_size, config.embed_dim, pd, device),
            "mlp": mlp_init(rng, d, config.mlp_dims, pd, device),
            "out": dense_init(rng, head_in, 1, pd, device),
        }

    def shapes():
        pd = config.pdtype
        return {
            "embedding": meta_tensor((config.vocab_size, config.embed_dim), pd),
            "mlp": mlp_shapes(d, config.mlp_dims, pd),
            "out": dense_shapes(head_in, 1, pd),
        }

    def apply(params, batch):
        cd = config.cdtype
        emb = field_embed(params["embedding"], batch["feat_ids"], batch["feat_wts"], cd)
        x0 = emb.reshape(emb.shape[0], d)
        h = mlp_apply(params["mlp"], x0, cd) if config.mlp_dims else x0
        logit = dense_apply(params["out"], h, cd)[:, 0]
        return {"prediction_node": sigmoid(logit), "logits": logit}

    return Model(config=config, init=init, apply=apply, shapes=shapes)
