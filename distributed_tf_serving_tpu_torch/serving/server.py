"""gRPC frontend: PredictionService (Predict, PredictStream, Classify,
Regress, MultiInference, GetModelMetadata), ModelService (GetModelStatus)
and grpc.health.v1 Health on one port, over PredictionServiceImpl; with
`[transport] uds_path` (or --uds-path) on a Unix-domain socket as well.

CLI:

    python -m distributed_tf_serving_tpu_torch.serving.server --port 9999 \
        [--config configs/latency.toml] [--device cuda|cpu] [--kernels] \
        [--model-kind KIND] [--model-name NAME] \
        [--checkpoint DIR | --model-base-path DIR] [--uds-path PATH] \
        [--stream-chunk N]

serves, by default, a randomly initialized demo servable (numpy-seeded,
`--seed`) of the configured model kind ([server] model_kind, or
`--model-kind`: any family of models/); `--checkpoint DIR` serves the
checkpoint in DIR (train/checkpoint.py), and `--model-base-path DIR` the
newest versions under DIR's numeric version directories, hot-swapping as
new ones appear (serving/version_watcher.py). The device defaults to
"cuda"; without a card the server refuses to start unless `--device cpu`
is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import signal
import threading
import time
from concurrent import futures

import grpc

from ..models import ModelConfig, Servable, ServableRegistry, build_model
from ..models.base import resolve_device
from ..models.registry import model_signatures
from ..ops import cross_kernel
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
from ..utils.config import (
    BatchingConfig,
    KernelsConfig,
    ServerConfig,
    TransportConfig,
    load_config,
)
from .batcher import DynamicBatcher
from .service import PredictionServiceImpl, ServiceError

log = logging.getLogger("dts_torch.server")

# Request metadata: the int8 score response wire opt-in, and the
# PredictStream sub-batch size override.
SCORE_WIRE_KEY = "x-dts-score-wire"
STREAM_CHUNK_KEY = "x-dts-stream-chunk"


def _status(code_name: str) -> grpc.StatusCode:
    return getattr(grpc.StatusCode, code_name, grpc.StatusCode.UNKNOWN)


def _deadline_of(context) -> float | None:
    """The client's remaining budget (None = no deadline)."""
    remaining = context.time_remaining()
    if remaining is None or remaining == float("inf"):
        return None
    return remaining


def _score_wire_of(context) -> bool:
    """True when the request opted into the int8 score response wire
    (x-dts-score-wire: int8)."""
    try:
        for key, value in context.invocation_metadata() or ():
            if key == SCORE_WIRE_KEY:
                return str(value).strip().lower() == "int8"
    except Exception:  # noqa: BLE001 — a metadata quirk must not fail the RPC
        return False
    return False


def _stream_chunk_of(context) -> int | None:
    """The request's PredictStream sub-batch size (x-dts-stream-chunk,
    candidates per sub-batch; the service still clamps the chunk count).
    None = the server's stream_chunk_candidates."""
    try:
        for key, value in context.invocation_metadata() or ():
            if key == STREAM_CHUNK_KEY:
                return max(int(value), 0) or None
    except Exception:  # noqa: BLE001 — a malformed hint must not fail the RPC
        return None
    return None


def _call(name: str, fn, request, context):
    """ServiceError -> grpc status; anything else -> INTERNAL."""
    try:
        return fn(request)
    except ServiceError as e:
        context.abort(_status(e.code), str(e))
    except Exception as e:  # internal bug: surface as INTERNAL, keep serving
        log.exception("internal error serving %s", name)
        context.abort(grpc.StatusCode.INTERNAL, f"internal error: {e}")


def _call_stream(name: str, fn, request, context):
    """_call for a server-streaming RPC: `fn(request)` returns a chunk
    generator; an error aborts the stream after the chunks already sent."""
    try:
        yield from fn(request)
    except ServiceError as e:
        context.abort(_status(e.code), str(e))
    except Exception as e:  # internal bug: surface as INTERNAL, keep serving
        log.exception("internal error serving %s", name)
        context.abort(grpc.StatusCode.INTERNAL, f"internal error: {e}")


class GrpcPredictionService(PredictionServiceServicer):
    """tensorflow.serving.PredictionService adapter: every RPC of the
    service, PredictStream included."""

    def __init__(self, impl: PredictionServiceImpl):
        self.impl = impl

    def _unary(self, name: str, fn, request, context):
        deadline_s = _deadline_of(context)
        return _call(name, lambda req: fn(req, deadline_s=deadline_s), request, context)

    def Predict(self, request, context):
        deadline_s = _deadline_of(context)
        # The metadata is read only on a server whose plane armed the wire.
        int8_wire = self.impl.int8_score_wire and _score_wire_of(context)
        return _call("Predict", lambda req: self.impl.predict(
            req, deadline_s=deadline_s, int8_wire=int8_wire), request, context)

    def PredictStream(self, request, context):
        deadline_s = _deadline_of(context)
        chunk = _stream_chunk_of(context)
        return _call_stream("PredictStream", lambda req: self.impl.predict_stream(
            req, deadline_s=deadline_s, chunk=chunk), request, context)

    def Classify(self, request, context):
        return self._unary("Classify", self.impl.classify, request, context)

    def Regress(self, request, context):
        return self._unary("Regress", self.impl.regress, request, context)

    def MultiInference(self, request, context):
        return self._unary("MultiInference", self.impl.multi_inference, request, context)

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
    holds a version of it, NOT_SERVING while a version watcher owns it
    with no version loaded yet; unknown names get NOT_FOUND."""

    def __init__(self, impl: PredictionServiceImpl):
        self.impl = impl

    def _status(self, service: str) -> int | None:
        served = self.impl.registry.models()
        if not service:
            ready = self.impl.warmup_complete and any(served.values())
            return health_proto.SERVING if ready else health_proto.NOT_SERVING
        if served.get(service):
            return health_proto.SERVING
        return health_proto.NOT_SERVING if self.impl.is_configured(service) else None

    def Check(self, request, context):
        st = self._status(request.service)
        if st is None:
            context.abort(grpc.StatusCode.NOT_FOUND, f"unknown service {request.service!r}")
        return health_proto.HealthCheckResponse(status=st)

    def Watch(self, request, context):
        context.abort(grpc.StatusCode.UNIMPLEMENTED, "Watch not implemented")


def _add_uds_port(server, uds_path: str) -> None:
    """Bind the server to a Unix-domain socket next to its TCP port:
    co-located clients dial `unix:<path>` and skip the loopback TCP stack.
    A stale socket file of an earlier process is removed first (gRPC will
    not bind over it)."""
    try:
        if os.path.exists(uds_path):
            os.unlink(uds_path)
    except OSError:
        pass  # the bind below gives the actionable error
    if server.add_insecure_port(f"unix:{uds_path}") == 0:
        raise RuntimeError(f"could not bind unix:{uds_path}")


def create_server(
    impl: PredictionServiceImpl,
    address: str = "127.0.0.1:0",
    max_workers: int = 16,
    uds_path: str | None = None,
) -> tuple[grpc.Server, int]:
    """Build (not start) a server; returns (server, bound_port). `uds_path`
    binds a Unix-domain socket as well ([transport] uds_path)."""
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
    if uds_path:
        _add_uds_port(server, uds_path)
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
        signatures=model_signatures(model),
    )
    registry.load(servable)
    return servable


def _launch_counts() -> str:
    """The kernel launch counters that moved, as JSON."""
    return json.dumps({f"{k}/{cd}": n for (k, cd), n in cross_kernel.launches.items() if n},
                      sort_keys=True)


def _servable_change_hook(name: str) -> None:
    """The version watcher's on_servable_change: log the kernel launch
    counters, so each version's launches show."""
    log.info("kernel launches after a %s version change: %s", name, _launch_counts())


def build_stack(cfg: ServerConfig, model_config: ModelConfig | None, device=None,
                seed: int = 0, fused_kernel: bool = True,
                kernels_config: KernelsConfig | None = None,
                checkpoint=None, model_base_path=None,
                batching_config: BatchingConfig | None = None):
    """(impl, batcher, servable): the servable serving at start, warmed
    through every bucket (unless `cfg.warmup` is off), and a started
    batcher. The servable is the numpy-seeded demo (`seed`), the checkpoint
    in `checkpoint`, or — with `model_base_path` — the newest version a
    VersionWatcher loaded from that base path (None when no version is
    ready yet); the watcher is `impl.version_watcher` and keeps the
    registry serving the newest versions, each warmed through the batcher's
    queue and its warmup file replayed before it serves.

    fused_kernel=False serves dcn_v2 through model.apply instead of the
    fused serve kernel. An enabled `kernels_config` arms the kernel plane:
    the per-bucket autotune runs after warmup, for the servable serving at
    start (a version hot-loaded later serves the baseline), and its
    decisions pick the device step. On a CUDA device a failed autotune
    raises and the server does not start; on the CPU it is logged and every
    bucket serves the baseline. A built plane with int8_score_wire arms
    this server's int8 score response wire.

    The batcher reads back at `cfg.output_wire_dtype` and `output_top_k`;
    `batching_config.stream_chunk_candidates` is PredictStream's default
    split."""
    if checkpoint and model_base_path:
        raise ValueError(
            "--model-base-path is mutually exclusive with --checkpoint "
            "(the base path owns version lifecycle)")
    batcher = DynamicBatcher(
        buckets=cfg.buckets, max_wait_us=cfg.max_wait_us, device=device,
        queue_capacity_candidates=cfg.queue_capacity_candidates,
        fused_kernel=fused_kernel, completion_workers=cfg.completion_workers,
        pipeline_depth=cfg.pipeline_depth, output_wire_dtype=cfg.output_wire_dtype,
        output_top_k=cfg.output_top_k,
    )
    kernels = kernels_config.build() if kernels_config is not None else None
    batcher.kernels = kernels
    registry = ServableRegistry()
    impl = PredictionServiceImpl(registry, batcher)
    impl.warmup_complete = False
    impl.int8_score_wire = kernels is not None and kernels.config.int8_score_wire
    if batching_config is not None:
        impl.stream_chunk_candidates = batching_config.stream_chunk_candidates

    def prepare_kernels(servable) -> None:
        if kernels is None or servable is None:
            return
        t0 = time.perf_counter()
        try:
            kernels.prepare(batcher, servable)
        except Exception:  # noqa: BLE001 — on the CPU: no decisions, the baseline serves
            if batcher.device.type == "cuda":
                raise  # a kernel that fails on the card stops the server
            log.exception("kernel autotune failed; serving the baseline")
        log.info("kernel plane prepared in %.2fs", time.perf_counter() - t0)

    if model_base_path:
        from .version_watcher import VersionWatcher, VersionWatcherConfig
        from .warmup import replay_warmup_file

        # The watcher warms through the queue, so the batcher runs first.
        batcher.start()
        watcher = VersionWatcher(
            model_base_path, registry,
            VersionWatcherConfig(
                model_name=cfg.model_name,
                desired_labels=cfg.version_labels,
                poll_interval_s=cfg.file_system_poll_wait_seconds,
                # Upstream semantics: N RETRIES after the first attempt.
                max_load_attempts=cfg.max_num_load_retries + 1,
            ),
            warmup=batcher.warmup_via_queue if cfg.warmup else None,
            warmup_replay=(
                (lambda sv, wf: replay_warmup_file(wf, sv, batcher)) if cfg.warmup else None
            ),
            device=batcher.device,
            on_servable_change=_servable_change_hook,
        )
        impl.served_sources.add(cfg.model_name)
        impl.version_watcher = watcher.start()
        versions = registry.models().get(cfg.model_name, [])
        if versions:
            servable = registry.resolve(cfg.model_name)
            log.info("serving %s versions %s from %s", cfg.model_name, versions,
                     model_base_path)
        else:
            servable = None
            log.warning("no ready versions under %s yet; watching", model_base_path)
        prepare_kernels(servable)
        impl.warmup_complete = True
        return impl, batcher, servable

    if checkpoint:
        from ..train.checkpoint import load_servable

        servable = load_servable(checkpoint, device=batcher.device)
        registry.load(servable)
        log.info("loaded checkpoint %s: %s v%d", checkpoint, servable.name, servable.version)
    else:
        mc = model_config or ModelConfig(name=cfg.model_name, num_fields=cfg.num_fields)
        mc = dataclasses.replace(mc, name=cfg.model_name)
        servable = load_demo_servable(
            registry, kind=cfg.model_kind, name=cfg.model_name, seed=seed,
            config=mc, device=batcher.device,
        )
    if cfg.warmup:
        t0 = time.perf_counter()
        batcher.warmup(servable)
        log.info("warmed %d buckets in %.2fs", len(batcher.buckets), time.perf_counter() - t0)
    # The static paths load exactly the version above, so a label naming
    # another one is a config error at startup.
    for label, version in cfg.version_labels:
        registry.set_label(servable.name, label, version)
        log.info("label %r -> %s v%d", label, servable.name, version)
    prepare_kernels(servable)
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
    p.add_argument("--model-kind", help="model family of the demo servable (dcn, dcn_v2, "
                   "wide_deep, deepfm, two_tower, dlrm, generic). Overrides [server] model_kind")
    p.add_argument("--model-name", help="the served model's name. Overrides [server] model_name")
    source = p.add_mutually_exclusive_group()
    source.add_argument("--checkpoint", help="serve this checkpoint directory "
                        "(servable.json + params.safetensors)")
    source.add_argument("--model-base-path", help="serve the newest numeric version "
                        "directories under this path, hot-swapping new ones")
    p.add_argument("--uds-path", help="also serve gRPC on this Unix-domain socket path "
                   "(co-located clients dial unix:<path>). Equivalent to [transport] uds_path")
    p.add_argument("--stream-chunk", type=int, default=None,
                   help="default candidates per PredictStream sub-batch (0 = one chunk). "
                   "Equivalent to [batching] stream_chunk_candidates; a request's "
                   "x-dts-stream-chunk metadata overrides it")
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
    if args.model_kind is not None:
        cfg = dataclasses.replace(cfg, model_kind=args.model_kind)
    if args.model_name is not None:
        cfg = dataclasses.replace(cfg, model_name=args.model_name)
    kernels_config = loaded.get("kernels") or KernelsConfig()
    if args.kernels:
        kernels_config = dataclasses.replace(kernels_config, enabled=True)
    batching_config = loaded.get("batching") or BatchingConfig()
    if args.stream_chunk is not None:
        batching_config = dataclasses.replace(
            batching_config, stream_chunk_candidates=max(args.stream_chunk, 0))
    transport_config = loaded.get("transport") or TransportConfig()
    if args.uds_path:
        transport_config = dataclasses.replace(transport_config, uds_path=args.uds_path)
    impl, batcher, servable = build_stack(
        cfg, loaded.get("model"), args.device, args.seed, kernels_config=kernels_config,
        checkpoint=args.checkpoint, model_base_path=args.model_base_path,
        batching_config=batching_config,
    )
    server, port = create_server(impl, f"{cfg.host}:{cfg.port}", cfg.max_workers,
                                 uds_path=transport_config.uds_path or None)
    server.start()
    what = (f"{servable.name} v{servable.version}" if servable is not None
            else f"{cfg.model_name} (awaiting versions)")
    kind = servable.model.kind if servable is not None else cfg.model_kind
    log.info("serving %s (%s) on %s:%d, device %s", what, kind, cfg.host, port, batcher.device)
    if transport_config.uds_path:
        log.info("also serving on unix:%s", transport_config.uds_path)
    log.info("readback wire %s, top-k %d, PredictStream chunk %d, int8 score wire %s",
             cfg.output_wire_dtype, cfg.output_top_k, impl.stream_chunk_candidates,
             "armed" if impl.int8_score_wire else "off")
    servable = None  # a retired version must not stay alive here
    done = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: done.set())
    signal.signal(signal.SIGINT, lambda *_: done.set())
    done.wait()
    server.stop(grace=5).wait()
    if impl.version_watcher is not None:
        impl.version_watcher.stop()  # no load may race the batcher's stop
    batcher.stop()
    log.info("kernel launches at shutdown: %s", _launch_counts())
    log.info("shutdown complete")


if __name__ == "__main__":
    serve()
