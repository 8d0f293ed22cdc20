"""Serving path: the dynamic batcher (no gRPC/protobuf needed), and the
transport-free PredictionService plus its gRPC frontend (service.py,
server.py). The service and server names are imported on first use, so
importing this package needs no grpc."""

import importlib

from .batcher import DeviceWedgedError, DynamicBatcher, bucket_for, fold_ids_host, prepare_inputs

_LAZY = {
    "PredictionServiceImpl": "service",
    "ServiceError": "service",
    "create_server": "server",
    "create_server_async": "server",
}

__all__ = ["DeviceWedgedError", "DynamicBatcher", "bucket_for", "fold_ids_host",
           "prepare_inputs", *_LAZY]


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(f".{_LAZY[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
