"""Serving path: the dynamic batcher (no gRPC/protobuf needed), and the
transport-free PredictionService plus its gRPC frontend (service.py,
server.py). `create_server_async` (the coroutine gRPC server) is imported
on first use, so importing this package needs no grpc."""

from .batcher import DeviceWedgedError, DynamicBatcher, bucket_for, fold_ids_host, prepare_inputs

__all__ = ["DeviceWedgedError", "DynamicBatcher", "bucket_for", "create_server_async",
           "fold_ids_host", "prepare_inputs"]


def __getattr__(name):
    if name == "create_server_async":
        from .server import create_server_async

        return create_server_async
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
