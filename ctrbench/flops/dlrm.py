"""Operations and bytes of DLRM at a configuration's widths: the model's
work per scored row (what step_mfu divides). 2 operations per multiply-add
of every product; the interaction counts the pairs the model uses (the
upper triangle of Z Z^T), not the whole square a batched product computes."""

from __future__ import annotations


def _mlp_macs(fan_in: int, dims) -> int:
    macs = 0
    for width in dims:
        macs += fan_in * width
        fan_in = width
    return macs


def flops_per_row(model: dict) -> int:
    feats = model["num_fields"] + 1
    pairs = feats * (feats - 1) // 2
    d = model["embed_dim"]
    macs = _mlp_macs(model["num_dense_features"], model["bottom_mlp_dims"])
    macs += pairs * d
    macs += _mlp_macs(d + pairs, model["mlp_dims"])
    macs += model["mlp_dims"][-1]
    return 2 * macs


def gathered_bytes_per_row(model: dict, table_bytes: int = 4) -> int:
    return model["num_fields"] * model["embed_dim"] * table_bytes


def wire_bytes_per_row(model: dict) -> int:
    """24-bit ids, bfloat16 weights and float32 dense features."""
    return model["num_fields"] * (3 + 2) + model["num_dense_features"] * 4
