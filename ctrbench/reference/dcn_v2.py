"""Plain DCN-v2 forward (Wang et al. 2021, the parallel structure): a
weighted per-field embedding bag, a stack of full-rank cross layers
x_{l+1} = x0 * (x_l W_l + b_l) + x_l beside a ReLU MLP over x0, and a
logistic head over [cross, deep]. float32, no kernels, no batching."""

from __future__ import annotations

import math

import torch

try:
    from . import common
except ImportError:  # loaded by path from the harness
    import importlib.util
    import pathlib

    _p = pathlib.Path(__file__).with_name("common.py")
    _s = importlib.util.spec_from_file_location("ctrbench_reference_common", _p)
    common = importlib.util.module_from_spec(_s)
    _s.loader.exec_module(common)


def leaf_shapes(model: dict) -> dict:
    """Dense leaves in the serving program's layout, each with its scale."""
    d = model["num_fields"] * model["embed_dim"]
    shapes = {}
    for i in range(model["num_cross_layers"]):
        shapes[f"cross.{i}.w"] = ((d, d), d ** -0.5)
        shapes[f"cross.{i}.b"] = ((d,), 0.01)
    fan_in = d
    for i, width in enumerate(model["mlp_dims"]):
        shapes[f"mlp.{i}.w"] = ((fan_in, width), math.sqrt(2.0 / fan_in))
        shapes[f"mlp.{i}.b"] = ((width,), 0.01)
        fan_in = width
    head_in = d + (model["mlp_dims"][-1] if model["mlp_dims"] else 0)
    shapes["out.w"] = ((head_in, 1), math.sqrt(2.0 / head_in))
    shapes["out.b"] = ((1,), 0.01)
    return shapes


def make_params(model: dict, seed: int, device) -> dict:
    tree = common.make_tree(leaf_shapes(model), seed, device,
                            (model["vocab_size"], model["embed_dim"]))
    return common.nest(tree)


def forward(params: dict, inputs: dict, model: dict, precision: str = "float32") -> torch.Tensor:
    """Scores [n] of one block of requests' rows."""
    emb = common.field_embed(params["embedding"], inputs["feat_ids"], inputs["feat_wts"],
                             precision)
    x0 = emb.reshape(emb.shape[0], -1)
    x = x0
    for layer in params["cross"]:
        x = x0 * common.dense(x, layer, precision) + x
    deep = common.mlp(x0, params["mlp"], precision)
    logit = common.dense(torch.cat([x, deep], dim=-1), params["out"], precision)[:, 0]
    return torch.sigmoid(logit)
