"""Shared pieces of the plain references: seeded weights made on the device
in a few large calls, and the operand rounding of the precision control.
Plain PyTorch only; imports nothing of the program."""

from __future__ import annotations

import torch

# The reference's products are float32: no TF32 (10-bit mantissas).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# float8 e4m3: the largest finite value.
_E4M3_MAX = 448.0


def rounded(x: torch.Tensor, precision: str) -> torch.Tensor:
    """x as the precision computes with it, back in float32: "float32"
    leaves it; "fp8" rounds it to float8 e4m3 under one per-tensor scale
    (amax / 448), the control's precision."""
    if precision == "float32":
        return x
    if precision != "fp8":
        raise ValueError(f"unknown precision {precision!r}")
    scale = x.abs().amax().clamp_min(1e-30) / _E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def dense(x: torch.Tensor, layer: dict, precision: str) -> torch.Tensor:
    return rounded(x, precision) @ rounded(layer["w"], precision) + layer["b"]


def mlp(x: torch.Tensor, layers: list, precision: str) -> torch.Tensor:
    for layer in layers:
        x = torch.relu(dense(x, layer, precision))
    return x


def field_embed(table: torch.Tensor, ids: torch.Tensor, wts: torch.Tensor,
                precision: str) -> torch.Tensor:
    """[n, F, D]: each id folded into the table by modulo, its row scaled by
    its weight."""
    rows = torch.remainder(ids, table.shape[0])
    return rounded(table[rows], precision) * rounded(wts, precision)[..., None]


def make_tree(shapes: dict, seed: int, device, table_shape: tuple[int, int]) -> dict:
    """Weights for a tree of named leaf shapes, from `seed`, on `device`: one
    standard-normal draw for the embedding table and one for every dense
    leaf together, each leaf its own float32 tensor. `shapes` maps a path
    ("mlp.0.w") to (shape, scale)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    table = torch.randn(table_shape, generator=g, device=device, dtype=torch.float32)
    table.mul_(table_shape[1] ** -0.5)
    sizes = [int(torch.Size(s).numel()) for s, _ in shapes.values()]
    flat = torch.randn(sum(sizes), generator=g, device=device, dtype=torch.float32)
    leaves = {}
    for (path, (shape, scale)), chunk in zip(shapes.items(), torch.split(flat, sizes)):
        leaves[path] = (chunk * scale).reshape(shape)
    del flat
    return {"embedding": table, **leaves}


def nest(flat: dict) -> dict:
    """{"mlp.0.w": t, ...} -> {"mlp": [{"w": t}, ...]} (list where the key is
    a number)."""
    out: dict = {}
    for path, value in flat.items():
        node = out
        parts = path.split(".")
        for part, nxt in zip(parts, parts[1:]):
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    def fix(node):
        if not isinstance(node, dict):
            return node
        node = {k: fix(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return fix(out)
