"""Model runtime core: functional CTR models + builder registry (PyTorch).

Every model follows the TF-Serving CTR contract:

  inputs : feat_ids  int64  [n, num_fields]   hashed categorical ids
           feat_wts  float  [n, num_fields]   per-feature weights
  output : prediction_node  float [n]         CTR score in [0, 1]

Models are (init, apply) pairs over plain dicts of tensors, with the same
param names and [in, out] weight layouts as the JAX package, so a param tree
carried over by `convert.params_from_jax` computes the same function.

Numerics: parameters live in float32; matmuls run on operands rounded to the
compute dtype with a float32 result. JAX's `dot_general(...,
preferred_element_type=f32)` keeps the f32 accumulator, whereas a bf16
`torch.matmul` would round its OUTPUT to bf16 — so `matmul_f32` upcasts the
compute-dtype-rounded operands and multiplies in f32. TF32 would cut the f32
products to ~10 mantissa bits, so it is switched off here for matmuls and
convolutions alike.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable
from typing import Any

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

Params = Any  # dict/list tree of torch.Tensors
Batch = dict[str, torch.Tensor]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}; have {sorted(_DTYPES)}")
    return _DTYPES[name]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on. Default "cuda"; a missing card is
    an error unless the caller asked for the CPU explicitly — the port never
    drops to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Knob set shared by the CTR model zoo (same fields and defaults as
    the JAX package's ModelConfig)."""

    name: str = "DCN"
    num_fields: int = 43
    vocab_size: int = 1 << 20
    embed_dim: int = 16
    mlp_dims: tuple[int, ...] = (256, 128, 64)
    # DCN / DCN-v2
    num_cross_layers: int = 3
    cross_full_matrix: bool = False  # False => DCN-v1 rank-1 cross, True => DCN-v2
    # two-tower
    num_user_fields: int = 8
    # DLRM
    num_dense_features: int = 13
    bottom_mlp_dims: tuple[int, ...] = (64, 32, 16)
    # numerics
    compute_dtype: str = "bfloat16"  # "float32" for AUC-parity mode
    param_dtype: str = "float32"
    # Route the DCN-v2 cross stack through the hand-written cross-stack
    # kernel (ops/cross_kernel.py) on CUDA tensors.
    use_pallas_cross: bool = False

    @property
    def cdtype(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)


@dataclasses.dataclass(frozen=True)
class Model:
    """A functional model: params = init(seed, device); outputs =
    apply(params, batch); shapes() is init's tree as tensors on the "meta"
    device (shape and dtype only, nothing computed: the port's
    `jax.eval_shape(model.init, ...)`).

    wts_in_compute_dtype: True when the model consumes feat_wts only after
    casting to compute_dtype — the precondition for the batcher's lossless
    bf16 weight transfer. folds_ids_on_host: the batcher may fold raw ids
    into the vocab before transfer (models re-fold idempotently).
    score_output: the name of the per-candidate score vector in apply()'s
    output dict, the one tensor the serving path ranks on: top-k output
    compaction, the int8 score response wire and Classify / Regress key on
    it. needs_x64: the model's graph carries int64 / float64 tensors
    (interop/graph_exec.py); torch is 64-bit natively, so the flag means
    only that they reach it as they are: the batcher keeps float64 inputs,
    sends no combined buffer and reads back full-precision outputs, with no
    top-k or prune."""

    config: ModelConfig
    init: Callable[..., Params]
    apply: Callable[[Params, Batch], dict[str, torch.Tensor]]
    shapes: Callable[[], Params] | None = None
    wts_in_compute_dtype: bool = True
    score_output: str = "prediction_node"
    folds_ids_on_host: bool = True
    needs_x64: bool = False
    kind: str = ""


# ---------------------------------------------------------------------------
# Shared building blocks
# ---------------------------------------------------------------------------


# Rows per product call. A library product (cuBLAS on the card, MKL on the
# CPU) picks its algorithm, and so a row's reduction order, by the
# problem's row count: the same row scored in a call of 1000 rows and in
# one of 2048 may differ in its last bits. `matmul_f32` therefore runs
# every product as calls of exactly ROW_TILE rows (the last tile padded
# with zero rows), so a row's bits do not depend on the row count of its
# call: a data shard's forward gives a single device's bits.
ROW_TILE = 512


def matmul_f32(x: torch.Tensor, w: torch.Tensor, compute_dtype) -> torch.Tensor:
    """x @ w on operands rounded to compute_dtype, f32 result (the JAX
    preferred_element_type=f32 contract), in fixed tiles of ROW_TILE rows
    over x's leading dims."""
    a = x.to(compute_dtype).float()
    b = w.to(compute_dtype).float()
    lead = a.shape[:-1]
    a = a.reshape(-1, a.shape[-1])
    n = a.shape[0]
    if n == 0:
        return (a @ b).reshape(*lead, b.shape[-1])
    pad = (-n) % ROW_TILE
    if pad:
        a = torch.cat([a, a.new_zeros((pad, a.shape[1]))])
    out = torch.cat([a[i:i + ROW_TILE] @ b for i in range(0, n + pad, ROW_TILE)])
    return out[:n].reshape(*lead, b.shape[-1])


def sigmoid(logit: torch.Tensor) -> torch.Tensor:
    """torch.sigmoid with a row's bits independent of the row count of its
    call: the CPU's vectorized loop leaves the last (n mod vector width)
    elements to a scalar path that rounds differently, so the rows are
    padded to a multiple of ROW_TILE first."""
    n = logit.shape[0]
    pad = (-n) % ROW_TILE
    if pad == 0:
        return torch.sigmoid(logit)
    padded = torch.cat([logit, logit.new_zeros((pad,) + tuple(logit.shape[1:]))])
    return torch.sigmoid(padded)[:n]


def dense_init(rng: np.random.Generator, in_dim: int, out_dim: int, dtype,
               device) -> dict[str, torch.Tensor]:
    """He-style init for a dense layer (demo weights from a numpy seed)."""
    w = rng.standard_normal((in_dim, out_dim), dtype=np.float32) * np.float32(
        np.sqrt(2.0 / in_dim)
    )
    return {
        "w": torch.from_numpy(w).to(device=device, dtype=dtype),
        "b": torch.zeros((out_dim,), dtype=dtype, device=device),
    }


def dense_apply(p: dict[str, torch.Tensor], x: torch.Tensor, compute_dtype) -> torch.Tensor:
    """x @ w + b in compute_dtype with an f32 result. Takes the float
    {"w","b"} layer and the int8 {"qw","qscale","b"} form of
    ops/quantize.py: int8 magnitudes <= 127 are exact in bf16, and the
    per-output-channel scale folds into the f32 result."""
    qw = p.get("qw")
    if qw is not None:
        return matmul_f32(x, qw, compute_dtype) * p["qscale"].float() + p["b"].float()
    return matmul_f32(x, p["w"], compute_dtype) + p["b"].float()


def mlp_init(rng: np.random.Generator, in_dim: int, dims: tuple[int, ...], dtype,
             device) -> list:
    layers = []
    for out_dim in dims:
        layers.append(dense_init(rng, in_dim, out_dim, dtype, device))
        in_dim = out_dim
    return layers


def meta_tensor(shape: tuple[int, ...], dtype) -> torch.Tensor:
    """A tensor of this shape and dtype on the "meta" device (no storage):
    the leaves of a model's shapes() tree."""
    return torch.empty(shape, dtype=dtype, device="meta")


def dense_shapes(in_dim: int, out_dim: int, dtype) -> dict[str, torch.Tensor]:
    """dense_init's layer as meta tensors."""
    return {"w": meta_tensor((in_dim, out_dim), dtype), "b": meta_tensor((out_dim,), dtype)}


def mlp_shapes(in_dim: int, dims: tuple[int, ...], dtype) -> list:
    """mlp_init's layers as meta tensors."""
    layers = []
    for out_dim in dims:
        layers.append(dense_shapes(in_dim, out_dim, dtype))
        in_dim = out_dim
    return layers


def mlp_apply(layers: list, x: torch.Tensor, compute_dtype, final_relu: bool = True) -> torch.Tensor:
    for i, p in enumerate(layers):
        x = dense_apply(p, x, compute_dtype)
        if final_relu or i + 1 < len(layers):
            x = torch.relu(x)
    return x


# ---------------------------------------------------------------------------
# Builder registry
# ---------------------------------------------------------------------------

_BUILDERS: dict[str, Callable[[ModelConfig], Model]] = {}


def register_model(kind: str):
    def deco(fn: Callable[[ModelConfig], Model]):
        _BUILDERS[kind] = fn
        return fn

    return deco


def build_model(kind: str, config: ModelConfig | None = None, **overrides) -> Model:
    """Instantiate a model family by kind: dcn, dcn_v2, wide_deep, deepfm,
    two_tower, dlrm, generic."""
    if kind not in _BUILDERS:
        raise KeyError(f"unknown model kind {kind!r}; have {sorted(_BUILDERS)}")
    if config is None:
        config = ModelConfig(**overrides)
    elif overrides:
        config = dataclasses.replace(config, **overrides)
    model = _BUILDERS[kind](config)
    if not model.kind:
        model = dataclasses.replace(model, kind=kind)
    return model


def model_kinds() -> list[str]:
    return sorted(_BUILDERS)
