"""Operations and bytes of DCN-v2 at a configuration's widths: the model's
work per scored row (what step_mfu divides), and the fused serve kernel's
least work per call (what fused_serve_roofline divides). Counted from the
shapes: 2 operations per multiply-add of every product; elementwise work is
left out."""

from __future__ import annotations


def _d(model: dict) -> int:
    return model["num_fields"] * model["embed_dim"]


def _dense_macs(model: dict) -> int:
    d = _d(model)
    macs = model["num_cross_layers"] * d * d
    fan_in = d
    for width in model["mlp_dims"]:
        macs += fan_in * width
        fan_in = width
    return macs + d + (model["mlp_dims"][-1] if model["mlp_dims"] else 0)


def flops_per_row(model: dict) -> int:
    """The model's operations for one candidate."""
    return 2 * _dense_macs(model)


def gathered_bytes_per_row(model: dict, table_bytes: int = 4) -> int:
    """Embedding bytes one candidate gathers (float32 table)."""
    return model["num_fields"] * model["embed_dim"] * table_bytes


def wire_bytes_per_row(model: dict) -> int:
    """Bytes per row of the batch the serving path copies to the card for
    this model on the fused path: 24-bit ids and bfloat16 weights."""
    return model["num_fields"] * (3 + 2)


def fused_serve_cost(model: dict, rows: int) -> tuple[float, float]:
    """(operations, bytes) of one fused serve call over `rows` rows: every
    row's products; each input byte read once (the packed rows, the rows
    gathered from the float32 table, the dense weights in the compute dtype
    and their float32 biases) and each score written once."""
    d = _d(model)
    wbytes = 2 if model["compute_dtype"] == "bfloat16" else 4
    weights = _dense_macs(model) * wbytes
    biases = (model["num_cross_layers"] * d + sum(model["mlp_dims"]) + 1) * 4
    per_row = wire_bytes_per_row(model) + gathered_bytes_per_row(model) + 4
    return float(rows * flops_per_row(model)), float(weights + biases + rows * per_row)
