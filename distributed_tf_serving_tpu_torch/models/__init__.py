"""PyTorch CTR models + servable registry: the JAX package's families (dcn,
dcn_v2, wide_deep, deepfm, two_tower, dlrm, generic), each with the
TF-Serving contract feat_ids/feat_wts [n, F] -> prediction_node [n]."""

from .base import (
    Batch,
    Model,
    ModelConfig,
    Params,
    build_model,
    model_kinds,
    resolve_device,
)
from .registry import (
    DEFAULT_SIGNATURE,
    ModelNotFoundError,
    Servable,
    ServableRegistry,
    Signature,
    SignatureNotFoundError,
    TensorSpec,
    VersionNotFoundError,
    ctr_signatures,
)

# Import model modules for their registration side effects.
from . import dcn, deepfm, dlrm, generic, two_tower, wide_deep  # noqa: E402,F401

__all__ = [
    "Batch",
    "Model",
    "ModelConfig",
    "Params",
    "build_model",
    "model_kinds",
    "resolve_device",
    "Servable",
    "ServableRegistry",
    "Signature",
    "TensorSpec",
    "ctr_signatures",
    "DEFAULT_SIGNATURE",
    "ModelNotFoundError",
    "VersionNotFoundError",
    "SignatureNotFoundError",
]
