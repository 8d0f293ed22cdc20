"""Post-training int8 weight quantization of a servable's dense layers.

Scheme: per-channel symmetric weight-only quantization of the 2-D dense
matrices (DCN-v2 cross W_l, MLP layers, the output head):

    scale[o] = max|w[:, o]| / 127          (per OUTPUT channel)
    qw[i, o] = round(w[i, o] / scale[o])   in int8 [-127, 127]

Activations stay in the compute dtype. At apply time the matmul runs on
qw cast to the compute dtype (|q| <= 127 is exact in bf16) with an f32
result, and the scale folds into that result:

    y[n, o] = (x @ qw)[n, o] * scale[o] + b[o]

The quantized tree uses {"qw", "qscale", "b"} in place of {"w", "b"};
models/base.py dense_apply and models/dcn.py cross_apply take either form.

Quantization runs once per servable, on the host in numpy, with the same
arithmetic as the JAX package's quantizer (f32 division, round half to
even, scale 1.0 for an all-zero channel), so both packages mint
bit-identical (qw, qscale) from the same weights. Embedding tables and
DCN-v1 rank-1 vectors pass through by reference.
"""

from __future__ import annotations

import numpy as np
import torch

Q8_MAX = 127  # symmetric int8 range [-127, 127]; -128 unused by design


def _host_f32(w) -> np.ndarray:
    if isinstance(w, torch.Tensor):
        return w.detach().float().cpu().numpy()
    return np.asarray(w, np.float32)


def quantize_channelwise(w, axis: int = -1) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel symmetric int8 quantization of a float matrix.

    Returns (qw int8, scale float32) on the input tensor's device (the CPU
    for a numpy input), the scale shaped along `axis` (the channel axis —
    the OUTPUT dim for dense weights)."""
    device = w.device if isinstance(w, torch.Tensor) else torch.device("cpu")
    a = _host_f32(w)
    reduce_axes = tuple(i for i in range(a.ndim) if i != (axis % a.ndim))
    amax = np.max(np.abs(a), axis=reduce_axes, keepdims=True)
    scale = np.where(amax > 0, amax / Q8_MAX, 1.0).astype(np.float32)
    qw = np.clip(np.rint(a / scale), -Q8_MAX, Q8_MAX).astype(np.int8)
    scale = np.squeeze(scale, axis=reduce_axes).astype(np.float32)
    return torch.from_numpy(qw).to(device), torch.from_numpy(scale).to(device)


def dequantize_channelwise(qw: torch.Tensor, scale: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Inverse of quantize_channelwise (float32)."""
    shape = [1] * qw.ndim
    shape[axis % qw.ndim] = qw.shape[axis % qw.ndim]
    return qw.float() * scale.float().reshape(shape)


def is_quantized_dense(p) -> bool:
    """True for the quantized dense-layer dict form {"qw","qscale","b"}."""
    return isinstance(p, dict) and "qw" in p


def quantize_params(params):
    """Walk a model param tree and swap every 2-D float dense layer
    {"w": [in,out], "b": [out]} for {"qw", "qscale", "b"}. Everything else
    (embedding tables, DCN-v1 rank-1 cross vectors) passes through by
    reference; the servable's own params are never mutated."""
    if isinstance(params, dict):
        w = params.get("w")
        if (
            isinstance(w, torch.Tensor)
            and "b" in params
            and w.ndim == 2
            and w.is_floating_point()
        ):
            qw, scale = quantize_channelwise(w, axis=-1)
            return {"qw": qw, "qscale": scale, "b": params["b"]}
        return {k: quantize_params(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        out = [quantize_params(v) for v in params]
        return type(params)(out) if isinstance(params, tuple) else out
    return params


def count_quantized(params) -> int:
    """Number of dense layers in their quantized form."""
    if isinstance(params, dict):
        if "qw" in params:
            return 1
        return sum(count_quantized(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(count_quantized(v) for v in params)
    return 0


def quantized_param_bytes(params) -> tuple[int, int]:
    """(quantized_bytes, f32_equivalent_bytes) over the dense layers."""
    q = f = 0
    if isinstance(params, dict):
        if "qw" in params:
            n = params["qw"].numel()
            return n + params["qscale"].numel() * 4, n * 4
        for v in params.values():
            a, b = quantized_param_bytes(v)
            q, f = q + a, f + b
    elif isinstance(params, (list, tuple)):
        for v in params:
            a, b = quantized_param_bytes(v)
            q, f = q + a, f + b
    return q, f
