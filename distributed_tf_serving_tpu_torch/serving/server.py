"""gRPC frontend: PredictionService (Predict, GetModelMetadata),
ModelService (GetModelStatus) and grpc.health.v1 Health on one port, over
PredictionServiceImpl.

CLI:

    python -m distributed_tf_serving_tpu_torch.serving.server --port 9999 \
        [--config configs/latency.toml] [--device cuda|cpu] [--kernels]

serves a randomly initialized demo servable (numpy-seeded) of the
configured model kind. The device defaults to "cuda"; without a card the
server refuses to start unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import signal
import threading
import time
from concurrent import futures

import grpc

from ..models import ModelConfig, Servable, ServableRegistry, build_model, ctr_signatures
from ..models.base import resolve_device
from ..proto import (
    add_HealthServicer_to_server,
    add_ModelServiceServicer_to_server,
    add_PredictionServiceServicer_to_server,
)
from ..proto import health as health_proto
from ..proto.service_grpc import (
    KEEPALIVE_SERVER_OPTIONS,
    LARGE_MESSAGE_CHANNEL_OPTIONS,
    ModelServiceServicer,
    PredictionServiceServicer,
)
from ..utils.config import KernelsConfig, ServerConfig, load_config
from .batcher import DynamicBatcher
from .service import PredictionServiceImpl, ServiceError

log = logging.getLogger("dts_torch.server")


def _status(code_name: str) -> grpc.StatusCode:
    return getattr(grpc.StatusCode, code_name, grpc.StatusCode.UNKNOWN)


def _deadline_of(context) -> float | None:
    """The client's remaining budget (None = no deadline)."""
    remaining = context.time_remaining()
    if remaining is None or remaining == float("inf"):
        return None
    return remaining


def _call(name: str, fn, request, context):
    """ServiceError -> grpc status; anything else -> INTERNAL."""
    try:
        return fn(request)
    except ServiceError as e:
        context.abort(_status(e.code), str(e))
    except Exception as e:  # internal bug: surface as INTERNAL, keep serving
        log.exception("internal error serving %s", name)
        context.abort(grpc.StatusCode.INTERNAL, f"internal error: {e}")


class GrpcPredictionService(PredictionServiceServicer):
    """tensorflow.serving.PredictionService adapter; the RPCs not ported
    yet answer UNIMPLEMENTED (the servicer base class)."""

    def __init__(self, impl: PredictionServiceImpl):
        self.impl = impl

    def Predict(self, request, context):
        deadline_s = _deadline_of(context)
        return _call(
            "Predict", lambda req: self.impl.predict(req, deadline_s=deadline_s),
            request, context,
        )

    def GetModelMetadata(self, request, context):
        return _call("GetModelMetadata", self.impl.get_model_metadata, request, context)


class GrpcModelService(ModelServiceServicer):
    """tensorflow.serving.ModelService adapter: GetModelStatus."""

    def __init__(self, impl: PredictionServiceImpl):
        self.impl = impl

    def GetModelStatus(self, request, context):
        return _call("GetModelStatus", self.impl.get_model_status, request, context)


class GrpcHealthService:
    """grpc.health.v1 Health: service "" is SERVING once warmup completed
    and a model is loaded; service "<model>" is SERVING when the registry
    holds a version of it; unknown names get NOT_FOUND."""

    def __init__(self, impl: PredictionServiceImpl):
        self.impl = impl

    def _status(self, service: str) -> int | None:
        served = self.impl.registry.models()
        if not service:
            ready = self.impl.warmup_complete and any(served.values())
            return health_proto.SERVING if ready else health_proto.NOT_SERVING
        return health_proto.SERVING if served.get(service) else None

    def Check(self, request, context):
        st = self._status(request.service)
        if st is None:
            context.abort(grpc.StatusCode.NOT_FOUND, f"unknown service {request.service!r}")
        return health_proto.HealthCheckResponse(status=st)

    def Watch(self, request, context):
        context.abort(grpc.StatusCode.UNIMPLEMENTED, "Watch not implemented")


def create_server(
    impl: PredictionServiceImpl,
    address: str = "127.0.0.1:0",
    max_workers: int = 16,
) -> tuple[grpc.Server, int]:
    """Build (not start) a server; returns (server, bound_port)."""
    server = grpc.server(
        futures.ThreadPoolExecutor(max_workers=max_workers, thread_name_prefix="rpc"),
        options=list(LARGE_MESSAGE_CHANNEL_OPTIONS) + list(KEEPALIVE_SERVER_OPTIONS),
    )
    add_PredictionServiceServicer_to_server(GrpcPredictionService(impl), server)
    add_ModelServiceServicer_to_server(GrpcModelService(impl), server)
    add_HealthServicer_to_server(GrpcHealthService(impl), server)
    port = server.add_insecure_port(address)
    if port == 0:
        raise RuntimeError(f"could not bind {address}")
    return server, port


def load_demo_servable(
    registry: ServableRegistry,
    kind: str = "dcn_v2",
    name: str = "DCN",
    version: int = 1,
    seed: int = 0,
    config: ModelConfig | None = None,
    device=None,
    **config_overrides,
) -> Servable:
    """Build + register a randomly initialized servable (numpy-seeded
    weights) on `device` (default "cuda"). An explicit `config` wins over
    keyword overrides."""
    dev = resolve_device(device)
    config = config or ModelConfig(name=name, **config_overrides)
    model = build_model(kind, config)
    servable = Servable(
        name=name,
        version=version,
        model=model,
        params=model.init(seed, dev),
        signatures=ctr_signatures(config.num_fields),
    )
    registry.load(servable)
    return servable


def build_stack(cfg: ServerConfig, model_config: ModelConfig | None, device=None,
                seed: int = 0, fused_kernel: bool = True,
                kernels_config: KernelsConfig | None = None):
    """(impl, batcher, servable): a demo servable loaded, warmed through
    every bucket, and a started batcher. fused_kernel=False serves dcn_v2
    through model.apply instead of the fused serve kernel. An enabled
    `kernels_config` arms the kernel plane: the per-bucket autotune runs
    after warmup and its decisions pick the device step. On a CUDA device a
    failed autotune raises and the server does not start; on the CPU it is
    logged and every bucket serves the baseline."""
    batcher = DynamicBatcher(
        buckets=cfg.buckets, max_wait_us=cfg.max_wait_us, device=device,
        queue_capacity_candidates=cfg.queue_capacity_candidates,
        fused_kernel=fused_kernel, completion_workers=cfg.completion_workers,
        pipeline_depth=cfg.pipeline_depth,
    )
    kernels = kernels_config.build() if kernels_config is not None else None
    batcher.kernels = kernels
    registry = ServableRegistry()
    impl = PredictionServiceImpl(registry, batcher)
    impl.warmup_complete = False
    mc = model_config or ModelConfig(name=cfg.model_name, num_fields=cfg.num_fields)
    mc = dataclasses.replace(mc, name=cfg.model_name)
    servable = load_demo_servable(
        registry, kind=cfg.model_kind, name=cfg.model_name, seed=seed,
        config=mc, device=batcher.device,
    )
    t0 = time.perf_counter()
    batcher.warmup(servable)
    log.info("warmed %d buckets in %.2fs", len(batcher.buckets), time.perf_counter() - t0)
    if kernels is not None:
        t0 = time.perf_counter()
        try:
            kernels.prepare(batcher, servable)
        except Exception:  # noqa: BLE001 — on the CPU: no decisions, the baseline serves
            if batcher.device.type == "cuda":
                raise  # a kernel that fails on the card stops the server
            log.exception("kernel autotune failed; serving the baseline")
        log.info("kernel plane prepared in %.2fs", time.perf_counter() - t0)
    batcher.start()
    impl.warmup_complete = True
    return impl, batcher, servable


def serve(argv=None) -> None:
    p = argparse.ArgumentParser(description="PyTorch TF-Serving-compatible CTR server")
    p.add_argument("--config", help="TOML file with [server], [batching], [model] and "
                   "[kernels] sections")
    p.add_argument("--port", type=int, default=None)
    p.add_argument("--host", default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--seed", type=int, default=0, help="demo weight seed")
    p.add_argument(
        "--kernels", action="store_true",
        help="kernel/quantization plane: int8 weight quantization and the fused "
        "serve kernel, each enabled per bucket only where the load-time autotune "
        "measured a speedup on this device and the accuracy gates passed. "
        "Equivalent to [kernels] enabled = true",
    )
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")

    loaded = load_config(args.config) if args.config else {"server": ServerConfig()}
    cfg = loaded["server"]
    if args.port is not None:
        cfg = dataclasses.replace(cfg, port=args.port)
    if args.host is not None:
        cfg = dataclasses.replace(cfg, host=args.host)
    kernels_config = loaded.get("kernels") or KernelsConfig()
    if args.kernels:
        kernels_config = dataclasses.replace(kernels_config, enabled=True)
    impl, batcher, servable = build_stack(
        cfg, loaded.get("model"), args.device, args.seed, kernels_config=kernels_config,
    )
    server, port = create_server(impl, f"{cfg.host}:{cfg.port}", cfg.max_workers)
    server.start()
    log.info(
        "serving %s v%d (%s) on %s:%d, device %s",
        servable.name, servable.version, cfg.model_kind, cfg.host, port, batcher.device,
    )
    done = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: done.set())
    signal.signal(signal.SIGINT, lambda *_: done.set())
    done.wait()
    server.stop(grace=5).wait()
    batcher.stop()
    log.info("shutdown complete")


if __name__ == "__main__":
    serve()
