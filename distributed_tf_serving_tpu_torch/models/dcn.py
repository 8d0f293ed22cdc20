"""DCN / DCN-v2: explicit cross network + deep MLP over a shared embedding
bag, serving feat_ids/feat_wts [n, F] -> prediction_node [n].

Cross layers (per Wang et al.):
  v1 (rank-1):     x_{l+1} = x0 * (x_l . w_l) + b_l + x_l       w_l: [d]
  v2 (full-rank):  x_{l+1} = x0 * (x_l @ W_l + b_l) + x_l       W_l: [d, d]

The v2 matmul runs on compute-dtype operands with an f32 result; the
elementwise update is f32 and the carried activation is recast to the
compute dtype per layer. With `use_pallas_cross` the v2 stack goes through
the hand-written cross-stack kernel (ops/cross_kernel.py), whose weight
operands are prepared once per weight set; that kernel has no backward, so
such a forward under autograd raises (train with use_pallas_cross off).
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from .base import (
    Model,
    ModelConfig,
    dense_apply,
    dense_init,
    dense_shapes,
    matmul_f32,
    meta_tensor,
    mlp_apply,
    mlp_init,
    mlp_shapes,
    register_model,
)
from .embeddings import embedding_init, field_embed

log = logging.getLogger("dts_torch.models")


def _cross_init(rng: np.random.Generator, num_layers: int, d: int, full_matrix: bool,
                dtype, device):
    layers = []
    for _ in range(num_layers):
        shape = (d, d) if full_matrix else (d,)
        w = rng.standard_normal(shape, dtype=np.float32) / np.float32(d**0.5)
        layers.append({
            "w": torch.from_numpy(w).to(device=device, dtype=dtype),
            "b": torch.zeros((d,), dtype=dtype, device=device),
        })
    return layers


def cross_apply(layers, x0: torch.Tensor, compute_dtype) -> torch.Tensor:
    """Apply the stack of cross layers; x0 is [n, d] in compute_dtype.
    Takes float {"w","b"} layers and the int8 {"qw","qscale","b"} form:
    the per-channel scale folds into the f32 xw before the update."""
    x = x0
    x0f = x0.float()
    for p in layers:
        b = p["b"].float()
        if "qw" in p:  # quantized DCN-v2 (v1 rank-1 layers never quantize)
            xw = matmul_f32(x, p["qw"], compute_dtype) * p["qscale"].float()
            x = (x0f * (xw + b) + x.float()).to(compute_dtype)
            continue
        w = p["w"]
        if w.ndim == 2:  # DCN-v2
            xw = matmul_f32(x, w, compute_dtype)
            x = (x0f * (xw + b) + x.float()).to(compute_dtype)
        else:  # DCN-v1
            xw = torch.sum(x.float() * w.to(compute_dtype).float(), dim=-1, keepdim=True)
            x = (x0f * xw + b + x.float()).to(compute_dtype)
    return x


def _build(config: ModelConfig) -> Model:
    d = config.num_fields * config.embed_dim

    def init(seed: int = 0, device="cpu"):
        rng = np.random.default_rng(seed)
        pd = config.pdtype
        out_in = d + (config.mlp_dims[-1] if config.mlp_dims else 0)
        return {
            "embedding": embedding_init(rng, config.vocab_size, config.embed_dim, pd, device),
            "cross": _cross_init(
                rng, config.num_cross_layers, d, config.cross_full_matrix, pd, device
            ),
            "mlp": mlp_init(rng, d, config.mlp_dims, pd, device),
            "out": dense_init(rng, out_in, 1, pd, device),
        }

    def shapes():
        pd = config.pdtype
        w = (d, d) if config.cross_full_matrix else (d,)
        return {
            "embedding": meta_tensor((config.vocab_size, config.embed_dim), pd),
            "cross": [{"w": meta_tensor(w, pd), "b": meta_tensor((d,), pd)}
                      for _ in range(config.num_cross_layers)],
            "mlp": mlp_shapes(d, config.mlp_dims, pd),
            "out": dense_shapes(d + (config.mlp_dims[-1] if config.mlp_dims else 0), 1, pd),
        }

    def apply(params, batch):
        cd = config.cdtype
        emb = field_embed(params["embedding"], batch["feat_ids"], batch["feat_wts"], cd)
        x0 = emb.reshape(emb.shape[0], d)  # [n, F*D]
        use_fused = (
            config.use_pallas_cross
            and config.cross_full_matrix
            and "w" in params["cross"][0]
        )
        if use_fused:
            from ..ops.cross_kernel import fits_smem

            use_fused = fits_smem(d, cd)
            if not use_fused:
                # A size limit, not a failure: the stack does not fit one
                # block's shared memory, so the plain path computes it.
                log.info(
                    "cross-stack kernel declined d=%d (shared-memory limit); "
                    "using cross_apply", d,
                )
        if use_fused:
            from ..ops.cross_kernel import cross_stack, cross_weights, refuse_grad

            # The kernel has no backward: under autograd this raises before
            # any weight is prepared (as jax.grad through the Pallas kernel
            # raises), never a silently missing gradient.
            refuse_grad(x0, *(t for p in params["cross"] for t in p.values()))
            # Stacked, cast and laid out once per weight set (cached).
            xc = cross_stack(x0, cross_weights(params["cross"], cd))
        else:
            xc = cross_apply(params["cross"], x0, cd)
        xd = mlp_apply(params["mlp"], x0, cd)
        h = torch.cat([xc.float(), xd.float()], dim=-1)
        logit = dense_apply(params["out"], h, cd)[:, 0]
        return {"prediction_node": torch.sigmoid(logit), "logits": logit}

    return Model(config=config, init=init, apply=apply, shapes=shapes)


@register_model("dcn")
def build_dcn(config: ModelConfig) -> Model:
    return _build(dataclasses.replace(config, cross_full_matrix=False))


@register_model("dcn_v2")
def build_dcn_v2(config: ModelConfig) -> Model:
    return _build(dataclasses.replace(config, cross_full_matrix=True))
