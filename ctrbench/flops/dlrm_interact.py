"""Operations and bytes of DLRM's interaction kernel
(`dlrm_interact_bf16_kernel`, what dlrm_interact_roofline divides), and the
bytes per row of the batch the serving path copies to the card when the
table has more than 2^24 rows: int32 ids (no 24-bit packing), bfloat16
weights and float32 dense features. 2 operations per multiply-add; only the
pairs the model uses (the upper triangle of Z Z^T) count."""

from __future__ import annotations


def pairs(model: dict) -> int:
    """Pairs of [bottom output, fields]: the interaction's outputs."""
    feats = model["num_fields"] + 1
    return feats * (feats - 1) // 2


def interact_cost(model: dict, rows: int, real: float | None = None) -> tuple[float, float]:
    """(operations, bytes) of one kernel call over `rows` rows, `real` of
    them requests' rows (all of them if None) and the rest the bucket's
    padding: every row's pairs' dots; each input byte read once (the int32
    ids, the bfloat16 weights, the float32 bottom output, and for a real
    row its gathered float32 table rows) and each output byte written once
    (the bfloat16 top input, bottom output and pairs). A padding row's ids
    are 0, so its table rows are row 0, read from HBM once a call and
    then from L2: they count no table bytes."""
    f, d = model["num_fields"], model["embed_dim"]
    p = pairs(model)
    real = rows if real is None else real
    ops = 2 * p * d
    per_row = f * 4 + f * 2 + d * 4 + (d + p) * 2
    return float(rows * ops), float(rows * per_row + real * f * d * 4)


def wire_bytes_per_row(model: dict) -> int:
    """int32 ids, bfloat16 weights and float32 dense features."""
    return model["num_fields"] * (4 + 2) + model["num_dense_features"] * 4
