"""Plain DLRM forward (Naumov et al. 2019, as MLPerf's reference runs it): a
ReLU bottom MLP over the dense features, a weighted embedding row per sparse
field, the dot products of every pair of [bottom output, fields] (the upper
triangle of Z Z^T, no diagonal, row-major), a ReLU top MLP over [bottom
output, interactions] and a logistic head. float32, no kernels, no
batching."""

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


def _mlp_shapes(prefix: str, fan_in: int, dims) -> dict:
    shapes = {}
    for i, width in enumerate(dims):
        shapes[f"{prefix}.{i}.w"] = ((fan_in, width), math.sqrt(2.0 / fan_in))
        shapes[f"{prefix}.{i}.b"] = ((width,), 0.01)
        fan_in = width
    return shapes


def leaf_shapes(model: dict) -> dict:
    feats = model["num_fields"] + 1
    top_in = model["embed_dim"] + feats * (feats - 1) // 2
    shapes = _mlp_shapes("bottom_mlp", model["num_dense_features"], model["bottom_mlp_dims"])
    shapes.update(_mlp_shapes("top_mlp", top_in, model["mlp_dims"]))
    last = model["mlp_dims"][-1]
    shapes["out.w"] = ((last, 1), math.sqrt(2.0 / last))
    shapes["out.b"] = ((1,), 0.01)
    return shapes


def make_params(model: dict, seed: int, device) -> dict:
    tree = common.make_tree(leaf_shapes(model), seed, device,
                            (model["vocab_size"], model["embed_dim"]))
    return common.nest(tree)


def forward(params: dict, inputs: dict, model: dict, precision: str = "float32") -> torch.Tensor:
    bottom = common.mlp(inputs["dense_features"], params["bottom_mlp"], precision)
    emb = common.field_embed(params["embedding"], inputs["feat_ids"], inputs["feat_wts"],
                             precision)
    z = torch.cat([bottom[:, None, :], emb], dim=1)
    zr = common.rounded(z, precision)
    zzt = torch.bmm(zr, zr.transpose(1, 2))
    i, j = torch.triu_indices(z.shape[1], z.shape[1], offset=1, device=z.device)
    top = torch.cat([bottom, zzt[:, i, j]], dim=-1)
    logit = common.dense(common.mlp(top, params["top_mlp"], precision), params["out"],
                         precision)[:, 0]
    return torch.sigmoid(logit)
