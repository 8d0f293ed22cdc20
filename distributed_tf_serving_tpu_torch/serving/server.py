"""gRPC frontend: PredictionService (Predict, PredictStream, Classify,
Regress, MultiInference, GetModelMetadata), ModelService (GetModelStatus,
HandleReloadConfigRequest) and grpc.health.v1 Health on one port, over
PredictionServiceImpl; with `[transport] uds_path` (or --uds-path) on a
Unix-domain socket as well, or with `--ssl-config-file` over TLS; with
`--rest-port` the REST gateway (serving/rest.py) beside it. Every RPC of
both surfaces is observed into one ServerMetrics (utils/metrics.py); with
`--tracing` (or `[observability] tracing = true`) each opens a
`server.<RPC>` root span from the caller's `traceparent`.

With `[overload] enabled` (serving/overload.py) each inference RPC reads
its lane from `x-dts-criticality`, a refusal carries `retry-after-ms` and a
stale answer `x-dts-degraded` in the trailing metadata; with `[integrity]
enabled` (serving/integrity.py) Predict verifies `x-dts-input-crc` and
stamps `x-dts-score-crc`; with `[cascade] enabled` (serving/cascade.py)
an output-filtered Predict of at least `min_candidates` rows is pruned by
a stage-1 servable on the device and only the survivors are ranked; with
`[utilization] enabled` (serving/utilization.py) the batcher feeds an
occupancy ledger (GET /utilz); with `[quality] enabled`
(serving/quality.py) it feeds each request's scores to the quality
monitor (GET /qualityz, POST /labelz); with `[lifecycle] enabled`
(serving/lifecycle.py) and `--model-base-path` a controller routes a newer
version as a canary (probe lane first, then a ramp of default-lane
traffic), promotes it or rolls it back on the quality plane's evidence, and
with `fine_tune_interval_s > 0` fine-tunes the stable version and
publishes the result itself (GET /lifecyclez); with `[recovery] enabled`
(serving/recovery.py) a device-fatal batch failure, a wedge past
`wedge_quarantine_s` or a dead batcher thread starts a quarantine ->
REINIT -> replay cycle (health "" NOT_SERVING with the `quarantined`
reason meanwhile; GET /recoveryz), its watchdog started by the CLI. Each
section (or its flag: `--overload`, `--integrity`, `--cascade`,
`--utilization`, `--quality`, `--lifecycle`, `--recovery`) arms the plane
in build_stack, and so on either server; `--lifecycle` implies
`--quality`. With `[mesh] enabled` (or `--mesh`) the batcher runs each
batch over a ("data", "model") mesh of the visible cards (parallel/; GET
/meshz), with `[elastic] enabled` (or `--elastic`) over a ladder of splits
switched at run time. With
`--rest-port`, POST /profilez/start captures a torch.profiler trace and the
host threads' stacks whether or not the ledger is on.

`create_server` builds the threaded server (a handler thread per RPC);
`create_server_async` the coroutine one (grpc.aio: one event-loop thread
carries every RPC and awaits the batcher's futures), with the same
services, status codes, metrics and spans. Start it on the loop that owns
it:

    server, port = create_server_async(impl, "127.0.0.1:0")
    await server.start()

CLI:

    python -m distributed_tf_serving_tpu_torch.serving.server --port 9999 \
        [--config configs/latency.toml] [--device cuda|cpu] [--kernels] \
        [--model-kind KIND] [--model-name NAME] [--num-fields N] \
        [--checkpoint DIR | --savedmodel DIR | --model-base-path DIR |
         --model-config-file F] \
        [--version-label LABEL=VERSION ...] [--batching-parameters-file F] \
        [--ssl-config-file F] [--request-log-file F] [--request-log-sampling P] \
        [--no-warmup] [--max-wait-us N] [--max-workers N] \
        [--file-system-poll-wait-seconds S] [--max-num-load-retries N] \
        [--uds-path PATH] [--stream-chunk N] [--rest-port N] \
        [--metrics-every-s S] [--tracing] [--cache] [--overload] [--integrity] \
        [--cascade] [--utilization] [--quality] [--lifecycle] [--recovery] \
        [--mesh] [--elastic] [--mesh-devices N] [--model-parallel M] [--tensor-parallel]

serves, by default, a randomly initialized demo servable (numpy-seeded,
`--seed`) of the configured model kind ([server] model_kind, or
`--model-kind`: any family of models/); `--checkpoint DIR` serves the
checkpoint in DIR (train/checkpoint.py), `--savedmodel DIR` the TF
SavedModel export in DIR, imported as `--model-kind` (interop/savedmodel.py;
`graph` runs the export's own GraphDef) with its warmup file replayed,
`--model-base-path DIR` the newest versions under DIR's numeric version
directories (checkpoints or SavedModel exports), hot-swapping as new ones
appear (serving/version_watcher.py), and `--model-config-file F`
every model of a tensorflow_model_server ModelServerConfig, one version
watcher each (ModelLifecycle), the list replaceable at run time through
HandleReloadConfigRequest. SIGTERM (or SIGINT) drains: new inference RPCs
are refused UNAVAILABLE, accepted work is answered within [overload]
drain_grace_s (GracefulShutdown), then the server exits 0. The device
defaults to "cuda"; without a card the server refuses to start unless
`--device cpu` is given.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import dataclasses
import inspect
import json
import logging
import os
import pathlib
import signal
import threading
import time
from concurrent import futures

import grpc
import torch

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
from ..utils import tracing
from .. import codec, native
from ..utils.config import (
    DRAIN_GRACE_S,
    BatchingConfig,
    CacheConfig,
    CascadeConfig,
    ElasticConfig,
    FleetConfig,
    IntegrityConfig,
    KernelsConfig,
    LifecycleConfig,
    MeshConfig,
    ObservabilityConfig,
    OverloadConfig,
    QualityConfig,
    RecoveryConfig,
    ServerConfig,
    TransportConfig,
    UtilizationConfig,
    apply_batching_parameters,
    load_config,
    validate_model_config_entries,
)
from ..utils.metrics import ServerMetrics
from ..utils.tracing import request_trace
from . import lifecycle as lifecycle_mod
from . import overload as overload_mod
from . import utilization as utilization_mod
from .batcher import DynamicBatcher
from .service import PredictionServiceImpl, ServiceError

log = logging.getLogger("dts_torch.server")

# Request metadata: the int8 score response wire opt-in, and the
# PredictStream sub-batch size override.
SCORE_WIRE_KEY = "x-dts-score-wire"
STREAM_CHUNK_KEY = "x-dts-stream-chunk"


def _status(code_name: str) -> grpc.StatusCode:
    return getattr(grpc.StatusCode, code_name, grpc.StatusCode.UNKNOWN)


def _model_of(request) -> str | None:
    """The request's model name for the metrics and spans (None when the
    request carries no top-level model_spec, as MultiInference)."""
    return getattr(getattr(request, "model_spec", None), "name", "") or None


def _traceparent_of(context) -> str | None:
    """The W3C traceparent of the RPC's metadata, or None. Read only while
    tracing is on."""
    try:
        for key, value in context.invocation_metadata() or ():
            if key == "traceparent":
                return value
    except Exception:  # noqa: BLE001 — tracing must never fail an RPC
        return None
    return None


# Initial-metadata stamp on traced RPCs: a traced caller names the hop it
# reached (a replica, not a router) from it.
_PEER_ROLE_KEY = "x-dts-peer-role"


def _root_span(name: str, model: str | None, context):
    """The RPC's server root span (adopting the caller's trace), and the
    peer-role stamp; None with tracing off."""
    if not tracing.enabled():
        return None
    span_ctx = tracing.start_root(
        f"server.{name}", traceparent=_traceparent_of(context),
        attrs={"entrypoint": name, **({"model": model} if model else {})},
    )
    try:
        context.send_initial_metadata(((_PEER_ROLE_KEY, "replica"),))
    except Exception:  # noqa: BLE001 — advisory only
        pass
    return span_ctx


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


def _criticality_of(context) -> str | None:
    """The request's lane (x-dts-criticality), read only while a plane that
    consumes it is armed in this process: the overload controller (lane-
    ordered shedding) or the lifecycle controller (probe-lane-first canary
    routing); two module bool reads otherwise."""
    if not (overload_mod.active() or lifecycle_mod.active()):
        return None
    try:
        for key, value in context.invocation_metadata() or ():
            if key == overload_mod.CRITICALITY_KEY:
                return overload_mod.normalize_criticality(value)
    except Exception:  # noqa: BLE001 — a metadata quirk must not fail the RPC
        return None
    return None


def _input_crc_of(context, impl) -> str | None:
    """The request's x-dts-input-crc stamp, read only while the impl's
    integrity plane checks the wire."""
    integ = impl.integrity
    if integ is None or not integ.config.wire_checksums:
        return None
    try:
        for key, value in context.invocation_metadata() or ():
            if key == codec.CRC_INPUT_MD:
                return str(value)
    except Exception:  # noqa: BLE001 — a metadata quirk must not fail the RPC
        return None
    return None


def _stamp_response_crc(impl, context, resp) -> None:
    """The x-dts-score-crc trailing metadata over the encoded response,
    both transports. Advisory: a failed stamp never fails a good response,
    and the overload plane's metadata, set later on the same context, takes
    the slot (a client reads an absent stamp as an unverified server)."""
    try:
        sidecar = impl.response_crc_sidecar(resp)
        if sidecar:
            context.set_trailing_metadata(((codec.CRC_SCORE_MD, sidecar),))
    except Exception:  # noqa: BLE001 — advisory, never fatal
        pass


def _push_overload_metadata(context, exc: ServiceError | None) -> None:
    """The overload plane's trailing metadata, both transports: the
    retry-after-ms hint on a refusal, the degraded mark on a success that
    was served stale (exc None). Callers gate on overload.active()."""
    try:
        if exc is not None:
            ra = getattr(exc, "retry_after_ms", None)
            if ra:
                context.set_trailing_metadata(((overload_mod.RETRY_AFTER_KEY, str(int(ra))),))
        else:
            degraded = overload_mod.consume_degraded()
            if degraded:
                context.set_trailing_metadata(((overload_mod.DEGRADED_KEY, degraded),))
    except Exception:  # noqa: BLE001 — hints are advisory, never fatal
        pass


class TransportQuiesce:
    """Holds the RPCs that arrive in the last moments before the transport
    stops, so that none is on the wire when it does.

    gRPC core cancels every call that reaches the server after its shutdown
    began (before the client read the GOAWAY), and every call it had
    received but not yet handed to a handler; the client sees CANCELLED,
    which it does not retry. So GracefulShutdown first `settle()`s: from
    then on each RPC waits in its handler thread, before any work, and
    once none has arrived for QUIET_S (at most the settle budget) the
    transport stops — a client waiting on its call sends nothing more —
    and `release()` lets the held RPCs answer (UNAVAILABLE while the
    server drains). A held RPC waits at most HOLD_S, and never into the
    last DEADLINE_MARGIN_S of its own deadline."""

    QUIET_S = 0.1
    SETTLE_S = 0.5
    HOLD_S = 2.0
    DEADLINE_MARGIN_S = 0.05

    def __init__(self):
        self._cond = threading.Condition()
        self._holding = False
        self._last_arrival = 0.0

    def hold(self, context) -> None:
        """At the top of every handler: waits while the transport settles."""
        with self._cond:
            if not self._holding:
                return
            self._last_arrival = time.monotonic()
            limit = self.HOLD_S
            remaining = _deadline_of(context) if context is not None else None
            if remaining is not None:
                limit = min(limit, max(remaining - self.DEADLINE_MARGIN_S, 0.0))
            self._cond.wait_for(lambda: not self._holding, timeout=limit)

    def settle(self, budget_s: float) -> float:
        """Start holding; return (the seconds it took) once no RPC arrived
        for QUIET_S, or after `budget_s`."""
        t0 = time.monotonic()
        end = t0 + max(budget_s, 0.0)
        with self._cond:
            self._holding = True
            self._last_arrival = t0
        while True:
            now = time.monotonic()
            with self._cond:
                quiet = now - self._last_arrival
            if quiet >= self.QUIET_S or now >= end:
                return now - t0
            time.sleep(min(self.QUIET_S - quiet, end - now))

    def release(self) -> None:
        with self._cond:
            self._holding = False
            self._cond.notify_all()


class _ServicerBase:
    """The adapters' plumbing: the drain's hold (TransportQuiesce), then
    ServiceError -> grpc status (anything else INTERNAL), one
    ServerMetrics.observe per RPC under the request's model, and the
    `server.<RPC>` root span while tracing is on."""

    def __init__(self, impl: PredictionServiceImpl, quiesce: TransportQuiesce | None = None,
                 metrics: ServerMetrics | None = None):
        self.impl = impl
        self.quiesce = quiesce
        self.metrics = metrics or ServerMetrics()

    def _call(self, name: str, fn, request, context):
        if self.quiesce is not None:
            self.quiesce.hold(context)
        t0 = time.perf_counter()
        ok = False
        model = _model_of(request)
        overload_on = overload_mod.active()
        if overload_on:
            # A handler thread keeps its context: drop a mark a failed
            # earlier request left (marks are consumed on success only).
            overload_mod.consume_degraded()
        span_ctx = _root_span(name, model, context)
        try:
            if span_ctx is not None:
                with span_ctx:
                    resp = fn(request)
            else:
                resp = fn(request)
            ok = True
            if overload_on:
                _push_overload_metadata(context, None)
            return resp
        except ServiceError as e:
            if overload_on:
                _push_overload_metadata(context, e)
            context.abort(_status(e.code), str(e))
        except Exception as e:  # internal bug: surface as INTERNAL, keep serving
            log.exception("internal error serving %s", name)
            context.abort(grpc.StatusCode.INTERNAL, f"internal error: {e}")
        finally:
            self.metrics.observe(name, time.perf_counter() - t0, ok, model=model)

    def _call_stream(self, name: str, fn, request, context):
        """_call for a server-streaming RPC: `fn(request)` returns a chunk
        generator; an error aborts the stream after the chunks already
        sent. One observe per stream."""
        if self.quiesce is not None:
            self.quiesce.hold(context)
        t0 = time.perf_counter()
        ok = False
        model = _model_of(request)
        overload_on = overload_mod.active()
        if overload_on:
            overload_mod.consume_degraded()
        span_ctx = _root_span(name, model, context)
        try:
            if span_ctx is not None:
                with span_ctx:
                    yield from fn(request)
            else:
                yield from fn(request)
            ok = True
            if overload_on:
                _push_overload_metadata(context, None)
        except ServiceError as e:
            if overload_on:
                _push_overload_metadata(context, e)
            context.abort(_status(e.code), str(e))
        except Exception as e:  # internal bug: surface as INTERNAL, keep serving
            log.exception("internal error serving %s", name)
            context.abort(grpc.StatusCode.INTERNAL, f"internal error: {e}")
        finally:
            self.metrics.observe(name, time.perf_counter() - t0, ok, model=model)


class GrpcPredictionService(_ServicerBase, PredictionServiceServicer):
    """tensorflow.serving.PredictionService adapter: every RPC of the
    service, PredictStream included."""

    def _unary(self, name: str, fn, request, context):
        deadline_s = _deadline_of(context)
        crit = _criticality_of(context)
        return self._call(name, lambda req: fn(req, deadline_s=deadline_s, criticality=crit),
                          request, context)

    def Predict(self, request, context):
        deadline_s = _deadline_of(context)
        # The metadata is read only on a server whose plane armed the wire.
        int8_wire = self.impl.int8_score_wire and _score_wire_of(context)
        crit = _criticality_of(context)
        input_crc = _input_crc_of(context, self.impl)

        def handler(req):
            resp = self.impl.predict(req, deadline_s=deadline_s, int8_wire=int8_wire,
                                     criticality=crit, input_crc=input_crc)
            if self.impl.integrity is not None:
                _stamp_response_crc(self.impl, context, resp)
            return resp

        return self._call("Predict", handler, request, context)

    def PredictStream(self, request, context):
        deadline_s = _deadline_of(context)
        chunk = _stream_chunk_of(context)
        crit = _criticality_of(context)
        return self._call_stream("PredictStream", lambda req: self.impl.predict_stream(
            req, deadline_s=deadline_s, chunk=chunk, criticality=crit), request, context)

    def Classify(self, request, context):
        return self._unary("Classify", self.impl.classify, request, context)

    def Regress(self, request, context):
        return self._unary("Regress", self.impl.regress, request, context)

    def MultiInference(self, request, context):
        return self._unary("MultiInference", self.impl.multi_inference, request, context)

    def GetModelMetadata(self, request, context):
        return self._call("GetModelMetadata", self.impl.get_model_metadata, request, context)


class GrpcModelService(_ServicerBase, ModelServiceServicer):
    """tensorflow.serving.ModelService adapter: GetModelStatus and
    HandleReloadConfigRequest."""

    def GetModelStatus(self, request, context):
        return self._call("GetModelStatus", self.impl.get_model_status, request, context)

    def HandleReloadConfigRequest(self, request, context):
        return self._call("HandleReloadConfigRequest", self.impl.handle_reload_config,
                          request, context)


async def _aio_root_span(name: str, model: str | None, context):
    """_root_span on the coroutine server (its metadata send awaits)."""
    if not tracing.enabled():
        return None
    span_ctx = tracing.start_root(
        f"server.{name}", traceparent=_traceparent_of(context),
        attrs={"entrypoint": name, **({"model": model} if model else {})},
    )
    try:
        await context.send_initial_metadata(((_PEER_ROLE_KEY, "replica"),))
    except Exception:  # noqa: BLE001 — advisory only
        pass
    return span_ctx


class _AioServicerBase:
    """The coroutine adapters' plumbing, as _ServicerBase's: ServiceError
    -> grpc status (anything else INTERNAL), one ServerMetrics.observe per
    RPC under the request's model, and the `server.<RPC>` root span while
    tracing is on. `fn(request)` may return a response or an awaitable of
    one."""

    def __init__(self, impl: PredictionServiceImpl, metrics: ServerMetrics | None = None):
        self.impl = impl
        self.metrics = metrics or ServerMetrics()

    async def _call(self, name: str, fn, request, context):
        t0 = time.perf_counter()
        ok = False
        model = _model_of(request)
        overload_on = overload_mod.active()
        if overload_on:
            overload_mod.consume_degraded()
        span_ctx = await _aio_root_span(name, model, context)
        try:
            # A sync `with` is right across the awaits: contextvars are
            # coroutine-scoped, so the span stays current through them.
            with span_ctx if span_ctx is not None else contextlib.nullcontext():
                resp = fn(request)
                if inspect.isawaitable(resp):
                    resp = await resp
            ok = True
            if overload_on:
                _push_overload_metadata(context, None)
            return resp
        except ServiceError as e:
            if overload_on:
                _push_overload_metadata(context, e)
            await context.abort(_status(e.code), str(e))
        except grpc.aio.AbortError:
            raise
        except Exception as e:  # internal bug: surface as INTERNAL, keep serving
            log.exception("internal error serving %s", name)
            await context.abort(grpc.StatusCode.INTERNAL, f"internal error: {e}")
        finally:
            self.metrics.observe(name, time.perf_counter() - t0, ok, model=model)

    def _off_loop(self, fn):
        """`fn` run on the loop's default executor, under the batcher's
        device (a version it loads is copied and warmed on that thread):
        for the RPCs whose work blocks — MultiInference's sequential
        batches, a multi-model reload."""
        batcher = self.impl.batcher

        def bound(req):
            with batcher.device_scope():
                return fn(req)

        return lambda req: asyncio.get_running_loop().run_in_executor(None, bound, req)


class AioGrpcPredictionService(_AioServicerBase):
    """tensorflow.serving.PredictionService on the coroutine server: one
    event-loop thread carries every RPC. Predict, Classify, Regress and
    PredictStream await their `*_async` service entry points (decode,
    submit and encode run on the loop thread and touch no CUDA);
    GetModelMetadata runs inline; MultiInference, whose tasks block on the
    batcher one after another for a client-set deadline, runs off the
    loop."""

    async def Predict(self, request, context):
        deadline_s = _deadline_of(context)
        int8_wire = self.impl.int8_score_wire and _score_wire_of(context)
        crit = _criticality_of(context)
        input_crc = _input_crc_of(context, self.impl)

        async def handler(req):
            resp = await self.impl.predict_async(req, deadline_s=deadline_s, int8_wire=int8_wire,
                                                 criticality=crit, input_crc=input_crc)
            if self.impl.integrity is not None:
                _stamp_response_crc(self.impl, context, resp)
            return resp

        return await self._call("Predict", handler, request, context)

    async def Classify(self, request, context):
        deadline_s = _deadline_of(context)
        crit = _criticality_of(context)
        return await self._call("Classify", lambda req: self.impl.classify_async(
            req, deadline_s=deadline_s, criticality=crit), request, context)

    async def Regress(self, request, context):
        deadline_s = _deadline_of(context)
        crit = _criticality_of(context)
        return await self._call("Regress", lambda req: self.impl.regress_async(
            req, deadline_s=deadline_s, criticality=crit), request, context)

    async def MultiInference(self, request, context):
        deadline_s = _deadline_of(context)
        crit = _criticality_of(context)
        entry_t = time.perf_counter()

        def run(req):
            overload_on = overload_mod.active()
            if overload_on:
                # Executor threads keep their context: drop a failed
                # earlier request's mark.
                overload_mod.consume_degraded()
            # The budget left when the executor starts it: time queued
            # behind other executor work is the client's.
            left = None if deadline_s is None else deadline_s - (time.perf_counter() - entry_t)
            resp = self.impl.multi_inference(req, deadline_s=left, criticality=crit)
            # run_in_executor carries no contextvar back: a stale serve's
            # mark rides the return value.
            return resp, (overload_mod.consume_degraded() if overload_on else None)

        off_loop = self._off_loop(run)

        async def dispatch(req):
            resp, degraded = await off_loop(req)
            if degraded:
                overload_mod.mark_degraded(degraded)
            return resp

        return await self._call("MultiInference", dispatch, request, context)

    async def GetModelMetadata(self, request, context):
        return await self._call("GetModelMetadata", self.impl.get_model_metadata, request,
                                context)

    async def PredictStream(self, request, context):
        """An async generator of chunks, each yielded as its sub-batch
        completes; _call's error mapping, metrics and span, inlined because
        the stream yields through the adapter."""
        t0 = time.perf_counter()
        ok = False
        model = _model_of(request)
        overload_on = overload_mod.active()
        if overload_on:
            overload_mod.consume_degraded()
        deadline_s = _deadline_of(context)
        chunk = _stream_chunk_of(context)
        crit = _criticality_of(context)
        span_ctx = await _aio_root_span("PredictStream", model, context)
        try:
            with span_ctx if span_ctx is not None else contextlib.nullcontext():
                async for item in self.impl.predict_stream_async(
                        request, deadline_s=deadline_s, chunk=chunk, criticality=crit):
                    yield item
            ok = True
            if overload_on:
                _push_overload_metadata(context, None)
        except ServiceError as e:
            if overload_on:
                _push_overload_metadata(context, e)
            await context.abort(_status(e.code), str(e))
        except grpc.aio.AbortError:
            raise
        except Exception as e:  # internal bug: surface as INTERNAL, keep serving
            log.exception("internal error serving PredictStream")
            await context.abort(grpc.StatusCode.INTERNAL, f"internal error: {e}")
        finally:
            self.metrics.observe("PredictStream", time.perf_counter() - t0, ok, model=model)


class AioGrpcModelService(_AioServicerBase):
    """tensorflow.serving.ModelService on the coroutine server.
    GetModelStatus is a registry read and runs inline; a reload of a
    --model-config-file server loads and warms whole models, so it runs
    off the loop (the lifecycle's lock serializes reloads), while a
    label-only reload runs inline."""

    async def GetModelStatus(self, request, context):
        return await self._call("GetModelStatus", self.impl.get_model_status, request, context)

    async def HandleReloadConfigRequest(self, request, context):
        fn = self.impl.handle_reload_config
        if self.impl.model_lifecycle is not None:
            fn = self._off_loop(fn)
        return await self._call("HandleReloadConfigRequest", fn, request, context)


# Trailing-metadata key naming why health "" answered NOT_SERVING.
HEALTH_REASON_METADATA_KEY = "x-dts-health-reason"


class GrpcHealthService:
    """grpc.health.v1 Health: service "" is SERVING once warmup completed
    and a model is loaded, and NOT_SERVING again while the server drains for
    shutdown or the recovery plane runs a cycle (or holds a lost context
    quarantined); service "<model>" is SERVING when the registry holds a
    version of it, NOT_SERVING while a version watcher or the model
    lifecycle owns it with no version loaded yet; unknown names get
    NOT_FOUND. A NOT_SERVING "" names its reason in the
    x-dts-health-reason trailer: "draining", "quarantined" or
    "starting". Watch streams the current status at once, then one
    message per change (an unknown service streams SERVICE_UNKNOWN, as
    the health spec asks); the fleet router subscribes to it."""

    # How often Watch re-reads the status. A sync watcher holds a handler
    # thread for the stream's life: a surface for a few routers, not for
    # edge clients.
    watch_poll_s = 0.2

    def __init__(self, impl: PredictionServiceImpl, quiesce: TransportQuiesce | None = None):
        self.impl = impl
        self.quiesce = quiesce

    def _status(self, service: str) -> int | None:
        served = self.impl.registry.models()
        if not service:
            rec = self.impl.recovery
            ready = (self.impl.warmup_complete and any(served.values())
                     and not self.impl.draining
                     and not (rec is not None and rec.not_serving()))
            return health_proto.SERVING if ready else health_proto.NOT_SERVING
        if served.get(service):
            return health_proto.SERVING
        return health_proto.NOT_SERVING if self.impl.is_configured(service) else None

    def _reason(self, service: str) -> str:
        """Why "" is NOT_SERVING: "draining" (the process is leaving),
        "quarantined" (a recovery cycle: it comes back, unless its context
        is lost) or "starting". Empty for a model's own check."""
        if service:
            return ""
        if self.impl.draining:
            return "draining"
        rec = self.impl.recovery
        if rec is not None and rec.not_serving():
            return "quarantined"
        return "starting"

    def _trailer(self, request, st) -> tuple:
        reason = self._reason(request.service) if st == health_proto.NOT_SERVING else ""
        return ((HEALTH_REASON_METADATA_KEY, reason),) if reason else ()

    def Check(self, request, context):
        if self.quiesce is not None:
            self.quiesce.hold(context)
        st = self._status(request.service)
        if st is None:
            context.abort(grpc.StatusCode.NOT_FOUND, f"unknown service {request.service!r}")
        trailer = self._trailer(request, st)
        if trailer:
            context.set_trailing_metadata(trailer)
        return health_proto.HealthCheckResponse(status=st)

    def Watch(self, request, context):
        last = None
        while context.is_active():
            st = self._status(request.service)
            if st is None:
                st = health_proto.SERVICE_UNKNOWN
            if st != last:
                last = st
                yield health_proto.HealthCheckResponse(status=st)
            time.sleep(self.watch_poll_s)


class AioGrpcHealthService(GrpcHealthService):
    """The same status logic on the coroutine server (its abort awaits)."""

    async def Check(self, request, context):
        st = self._status(request.service)
        if st is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, f"unknown service {request.service!r}")
        trailer = self._trailer(request, st)
        if trailer:
            context.set_trailing_metadata(trailer)
        return health_proto.HealthCheckResponse(status=st)

    async def Watch(self, request, context):
        last = None
        while True:
            st = self._status(request.service)
            if st is None:
                st = health_proto.SERVICE_UNKNOWN
            if st != last:
                last = st
                yield health_proto.HealthCheckResponse(status=st)
            await asyncio.sleep(self.watch_poll_s)


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


def _refuse_uds_beside_tls(credentials, uds_path) -> None:
    if credentials is not None and uds_path:
        # The Unix socket is plaintext: next to a TLS port it would open an
        # unauthenticated side door to any local process.
        raise ValueError(
            "[transport] uds_path cannot be combined with --ssl-config-file: the "
            "unix socket is plaintext and would bypass the TLS/mTLS the TCP port enforces"
        )


def create_server(
    impl: PredictionServiceImpl,
    address: str = "127.0.0.1:0",
    max_workers: int = 16,
    uds_path: str | None = None,
    credentials: grpc.ServerCredentials | None = None,
    quiesce: TransportQuiesce | None = None,
    metrics: ServerMetrics | None = None,
) -> tuple[grpc.Server, int]:
    """Build (not start) a server; returns (server, bound_port). `uds_path`
    binds a Unix-domain socket as well ([transport] uds_path);
    `credentials` (load_ssl_credentials) makes the TCP port TLS, and then a
    socket is refused. Every handler waits on `quiesce`
    (GracefulShutdown.quiesce) while the transport settles to stop, and
    every PredictionService and ModelService RPC is observed into
    `metrics` (a new ServerMetrics when None)."""
    _refuse_uds_beside_tls(credentials, uds_path)
    server = grpc.server(
        futures.ThreadPoolExecutor(max_workers=max_workers, thread_name_prefix="rpc"),
        options=list(LARGE_MESSAGE_CHANNEL_OPTIONS) + list(KEEPALIVE_SERVER_OPTIONS),
    )
    metrics = metrics or ServerMetrics()
    add_PredictionServiceServicer_to_server(GrpcPredictionService(impl, quiesce, metrics),
                                            server)
    add_ModelServiceServicer_to_server(GrpcModelService(impl, quiesce, metrics), server)
    add_HealthServicer_to_server(GrpcHealthService(impl, quiesce), server)
    if credentials is not None:
        port = server.add_secure_port(address, credentials)
    else:
        port = server.add_insecure_port(address)
    if port == 0:
        raise RuntimeError(f"could not bind {address}")
    if uds_path:
        _add_uds_port(server, uds_path)
    return server, port


def create_server_async(
    impl: PredictionServiceImpl,
    address: str = "127.0.0.1:0",
    metrics: ServerMetrics | None = None,
    uds_path: str | None = None,
) -> tuple[grpc.aio.Server, int]:
    """Build (not start) a grpc.aio server with PredictionService,
    ModelService and grpc.health.v1 on one port; returns (server,
    bound_port). Call it on (or start it from) the event loop that will
    own it. `uds_path` binds a Unix-domain socket as well; every
    PredictionService and ModelService RPC is observed into `metrics` (a
    new ServerMetrics when None)."""
    server = grpc.aio.server(
        options=list(LARGE_MESSAGE_CHANNEL_OPTIONS) + list(KEEPALIVE_SERVER_OPTIONS),
    )
    metrics = metrics or ServerMetrics()
    add_PredictionServiceServicer_to_server(AioGrpcPredictionService(impl, metrics), server)
    add_ModelServiceServicer_to_server(AioGrpcModelService(impl, metrics), server)
    add_HealthServicer_to_server(AioGrpcHealthService(impl), server)
    port = server.add_insecure_port(address)
    if port == 0:
        raise RuntimeError(f"could not bind {address}")
    if uds_path:
        _add_uds_port(server, uds_path)
    return server, port


def start_rest_in_thread(impl: PredictionServiceImpl, host: str, port: int,
                         metrics: ServerMetrics | None = None) -> int:
    """Run the REST gateway (serving/rest.py) on its own event loop in a
    daemon thread beside the threaded gRPC server; returns the bound port.
    The start is synchronized: the caller gets a live port or a
    RuntimeError, never a healthy-looking process with a dead gateway (a
    wait that times out counts as a failure)."""
    import asyncio

    from .rest import start_rest_gateway

    ready: dict = {}
    up = threading.Event()

    def run_rest():
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        try:
            _runner, ready["port"] = loop.run_until_complete(
                start_rest_gateway(impl, host, port, metrics))
        except BaseException as exc:  # noqa: BLE001 — reported to the caller
            ready["error"] = exc
            return
        finally:
            up.set()
        loop.run_forever()

    threading.Thread(target=run_rest, name="rest", daemon=True).start()
    if not up.wait(timeout=30) or "error" in ready:
        raise RuntimeError(
            f"REST gateway failed to start on {host}:{port}: "
            f"{ready.get('error', 'startup timed out after 30s')}"
        )
    return ready["port"]


def _read_text_proto(path, message):
    from google.protobuf import text_format

    return text_format.Parse(pathlib.Path(path).read_text(), message)


def load_ssl_credentials(path) -> grpc.ServerCredentials:
    """tensorflow_model_server's --ssl_config_file: a text-format SSLConfig
    that carries the PEM contents inline. client_verify = true demands a
    client certificate chained to custom_ca (mTLS); custom_ca alone only
    offers it."""
    from ..proto import serving_apis_pb2 as apis

    cfg = _read_text_proto(path, apis.SSLConfig())
    if not cfg.server_key or not cfg.server_cert:
        raise ValueError(
            f"{path}: SSLConfig requires both server_key and server_cert (PEM contents inline)"
        )
    if cfg.client_verify and not cfg.custom_ca:
        # grpc itself refuses client auth without root certificates.
        raise ValueError(
            f"{path}: client_verify requires custom_ca (the CA that signs client "
            "certificates; grpc refuses client auth without roots)"
        )
    return grpc.ssl_server_credentials(
        [(cfg.server_key.encode(), cfg.server_cert.encode())],
        root_certificates=cfg.custom_ca.encode() if cfg.custom_ca else None,
        require_client_auth=cfg.client_verify,
    )


def read_batching_parameters(path):
    """A tensorflow_model_server --batching_parameters_file: the parsed
    text-format BatchingParameters (utils/config.apply_batching_parameters
    maps it onto [server])."""
    from ..proto import serving_apis_pb2 as apis

    return _read_text_proto(path, apis.BatchingParameters())


def _parse_model_server_config(path) -> list:
    """Parse and check a --model_config_file before any thread starts, so a
    bad file leaves nothing to tear down: the model_config_list entries."""
    from ..proto import serving_apis_pb2 as apis

    msc = _read_text_proto(path, apis.ModelServerConfig())
    if msc.WhichOneof("config") != "model_config_list" or not msc.model_config_list.config:
        raise ValueError(f"{path}: a model_config_list with at least one model is required")
    return validate_model_config_entries(msc.model_config_list.config, str(path))


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


def _servable_change_hook(score_cache=None, row_cache=None, quality=None):
    """The version watchers' on_servable_change: log the kernel launch
    counters, so each version's launches show, invalidate the model in
    each armed store of the cache plane, so a swap never serves the old
    version's scores, and count the change in the quality plane (its
    version-pair drift reads the per-version sketches)."""
    hooks = [store.invalidate_model for store in (score_cache, row_cache) if store is not None]
    if quality is not None:
        hooks.append(quality.note_servable_change)

    def hook(name: str) -> None:
        log.info("kernel launches after a %s version change: %s", name, _launch_counts())
        for h in hooks:
            h(name)

    return hook


def _make_watcher(base_path, model_name: str, desired_labels, cfg: ServerConfig, registry,
                  batcher, model_kind: str | None = None,
                  model_config: ModelConfig | None = None):
    """A VersionWatcher that serves `model_name` from `base_path`: each
    version warmed through the batcher's queue and its warmup file replayed
    before it serves (unless cfg.warmup is off), loaded onto the batcher's
    device, the kernel launch counters logged before each version's warmup
    and at every version change, the batcher's caches
    invalidated and the quality plane told at every version change. A
    SavedModel version is imported as `model_kind` (default cfg.model_kind)
    with `model_config`."""
    from .version_watcher import VersionWatcher, VersionWatcherConfig
    from .warmup import replay_warmup_file

    place = getattr(batcher.run_fn, "place", None)

    def warmup(servable: Servable) -> None:
        if place is not None:
            # A mesh places each version (its vocab and, with
            # tensor_parallel, dense blocks) before it serves.
            place(servable)
        if not cfg.warmup:
            return
        # The counters before a version's own launches: its warmup's are
        # the difference to the next version change's line.
        log.info("kernel launches before warming %s v%d: %s", servable.name,
                 servable.version, _launch_counts())
        batcher.warmup_via_queue(servable)

    return VersionWatcher(
        base_path, registry,
        VersionWatcherConfig(
            model_name=model_name,
            model_kind=model_kind or cfg.model_kind,
            desired_labels=tuple(desired_labels),
            poll_interval_s=cfg.file_system_poll_wait_seconds,
            # Upstream semantics: N RETRIES after the first attempt.
            max_load_attempts=cfg.max_num_load_retries + 1,
        ),
        warmup=warmup if cfg.warmup or place is not None else None,
        warmup_replay=(
            (lambda sv, wf: replay_warmup_file(wf, sv, batcher)) if cfg.warmup else None
        ),
        device=batcher.device,
        model_config=model_config,
        on_servable_change=_servable_change_hook(batcher.score_cache, batcher.row_cache,
                                                 batcher.quality),
    )


class ModelLifecycle:
    """The served model list of a --model-config-file server: one version
    watcher per model_config_list entry over one registry and one batcher,
    and `apply()`, HandleReloadConfigRequest's reconcile, where the
    supplied list replaces the served one (upstream semantics):

    1. unchanged entries (same base_path and model_platform) get their
       version_labels, atomically across models, before anything else
       moves: a label on an unloaded version fails the reload and applies
       nothing;
    2. entries that are gone stop their watcher and unload the model; an
       entry whose source moved is stopped here and started again in 3;
    3. new entries start a watcher, whose first poll loads any ready
       version before apply() returns (the model is registered when the
       RPC answers); their labels are set as their versions land.

    `model_platform` names the family ("tensorflow", or empty, means the
    server's model_kind) a SavedModel version is imported as, with
    `model_config`; a checkpoint's architecture comes from its own
    manifest, so models of different families, widths and compute dtypes
    share the registry and the batcher. One lock serializes reloads."""

    def __init__(self, cfg: ServerConfig, registry: ServableRegistry, batcher: DynamicBatcher,
                 model_config: ModelConfig | None = None):
        self._cfg = cfg
        self._registry = registry
        self._batcher = batcher
        self._model_config = model_config
        self._watchers: dict[str, object] = {}
        self._sources: dict[str, tuple[str, str]] = {}  # name -> (base_path, platform)
        self._lock = threading.Lock()  # reloads arrive on RPC threads

    @property
    def watchers(self) -> list:
        with self._lock:
            return list(self._watchers.values())

    def configured_models(self) -> set[str]:
        """The models this lifecycle owns a watcher for, whether or not a
        version has landed yet (GetModelStatus answers START for those)."""
        with self._lock:
            return set(self._watchers)

    @staticmethod
    def _source_of(mc) -> tuple[str, str]:
        return (mc.base_path, mc.model_platform)

    def _kind_of(self, mc) -> str:
        kind = mc.model_platform or self._cfg.model_kind
        return self._cfg.model_kind if kind == "tensorflow" else kind  # upstream's platform

    def apply(self, model_configs) -> None:
        """Reconcile toward `model_configs` (checked entries). A label error
        (ModelNotFoundError, VersionNotFoundError, ValueError) raises before
        anything changes."""
        with self._lock:
            wanted = {mc.name: mc for mc in model_configs}
            unchanged = {name for name in set(self._watchers) & set(wanted)
                         if self._sources[name] == self._source_of(wanted[name])}
            label_maps = {name: {label: int(v) for label, v in wanted[name].version_labels.items()}
                          for name in unchanged}
            if label_maps:
                self._registry.replace_label_maps(label_maps)
            for name in sorted(set(self._watchers) - unchanged):
                self._watchers.pop(name).stop()
                self._sources.pop(name)
                try:
                    self._registry.unload(name)
                except KeyError:
                    pass  # no version had landed
                log.info("reload: %s model %r", "restarting" if name in wanted else "removed",
                         name)
            for name in sorted(set(wanted) - unchanged):
                mc = wanted[name]
                labels = sorted((label, int(v)) for label, v in mc.version_labels.items())
                self._watchers[name] = _make_watcher(
                    mc.base_path, name, labels, self._cfg, self._registry, self._batcher,
                    model_kind=self._kind_of(mc), model_config=self._model_config).start()
                self._sources[name] = self._source_of(mc)
                log.info("reload: added model %r (base_path=%s, platform %s)", name,
                         mc.base_path, self._kind_of(mc))

    def stop(self) -> None:
        """Stop every watcher: all are signalled before any is joined."""
        with self._lock:
            watchers = list(self._watchers.values())
        for w in watchers:
            w.request_stop()
        for w in watchers:
            w.stop()


class GracefulShutdown:
    """The one way the CLI server stops (SIGTERM, SIGINT, or its main loop
    ending). In order:

    1. `impl.draining`: health "" answers NOT_SERVING and every new
       inference RPC is refused UNAVAILABLE, so balancers and fan-out
       clients go elsewhere; with the fleet plane armed, one gossip round
       announces the drain at once, so the router steers away before this
       replica refuses its first RPC;
    2. the lifecycle controller (its ticks drive the watcher, and its
       publisher must not land a version behind the drain), the cascade's
       stage-1 watcher, then the version watcher or the model lifecycle
       stop: no load or warmup enters the batcher behind the drain; then
       the recovery controller (`shutdown_for_drain`): its watchdog stops,
       a running cycle ends at its next phase boundary and what it still
       holds fails UNAVAILABLE, so no replay holds the drain;
    3. `batcher.drain(grace_s)`: what the server accepted is answered
       (queued, staged, running and read back), bounded by the grace;
    4. the transport settles (`quiesce`, TransportQuiesce: RPCs that
       arrive now are held until it has stopped, so gRPC core cancels no
       call that was on the wire) and stops with the grace that remains
       (at least MIN_RPC_GRACE_S, so handlers can send what the drain
       completed); then the held RPCs answer, and the fleet plane stops;
    5. the batcher stops; 6. the request log closes.

    The server's handlers wait on `quiesce` only when it was passed to
    create_server (`serve()` does).

    Idempotent and thread-safe: the first caller runs it, later callers
    wait for it to finish. `install_signal_handler()` runs it on its own
    thread at SIGTERM and SIGINT (main thread only)."""

    MIN_RPC_GRACE_S = 1.0

    def __init__(self, impl: PredictionServiceImpl, batcher: DynamicBatcher,
                 grace_s: float = DRAIN_GRACE_S, watcher=None, request_logger=None,
                 lifecycle=None, recovery=None):
        self.impl = impl
        self.batcher = batcher
        self.grace_s = max(float(grace_s), 0.0)
        self.watcher = watcher
        self.lifecycle = lifecycle
        self.recovery = recovery
        self.request_logger = request_logger
        # The fleet plane (fleet/replica.py), attached by serve() when
        # [fleet] arms it: announced right after the draining flip, stopped
        # with the transport.
        self.fleet = None
        self.server = None  # attached once created
        self.quiesce = TransportQuiesce()
        self.drained: bool | None = None
        self._lock = threading.Lock()
        self._started = False
        self._done = threading.Event()

    def install_signal_handler(self) -> bool:
        try:
            signal.signal(signal.SIGTERM, self._on_signal)
            signal.signal(signal.SIGINT, self._on_signal)
        except ValueError:  # not the main thread
            return False
        return True

    def _on_signal(self, signum, frame) -> None:
        # The main thread waits in wait_for_termination: the drain runs
        # elsewhere so that server.stop() can release it.
        log.info("%s: draining (grace %.1fs)", signal.Signals(signum).name, self.grace_s)
        threading.Thread(target=self.shutdown, name="graceful-drain", daemon=True).start()

    def shutdown(self) -> None:
        with self._lock:
            run_it = not self._started
            self._started = True
        if not run_it:
            self._done.wait()
            return
        try:
            t0 = time.perf_counter()
            self.impl.draining = True
            if self.fleet is not None:
                try:
                    self.fleet.announce()
                except Exception:  # noqa: BLE001 — the next round carries it
                    log.debug("fleet drain announce failed", exc_info=True)
            if self.lifecycle is not None:
                self.lifecycle.stop()
            if self.impl.cascade_watcher is not None:
                self.impl.cascade_watcher.stop()
            if self.watcher is not None:
                self.watcher.stop()
            if self.recovery is not None:
                self.recovery.shutdown_for_drain(self.grace_s)
            self.drained = self.batcher.drain(self.grace_s)
            if not self.drained:
                log.warning("drain grace %.1fs expired with work still in flight; stopping "
                            "anyway", self.grace_s)
            if self.server is not None:
                self.quiesce.settle(min(self.quiesce.SETTLE_S,
                                        self.grace_s - (time.perf_counter() - t0)))
                left = max(self.grace_s - (time.perf_counter() - t0), self.MIN_RPC_GRACE_S)
                stopped = self.server.stop(left)
                self.quiesce.release()
                stopped.wait()
            if self.fleet is not None:
                self.fleet.stop()
            self.batcher.stop()
            if self.request_logger is not None:
                self.request_logger.close()
            log.info("kernel launches at shutdown: %s", _launch_counts())
            log.info("shutdown complete (drained=%s, %.3fs)", self.drained,
                     time.perf_counter() - t0)
        finally:
            self._done.set()


def build_stack(cfg: ServerConfig, model_config: ModelConfig | None, device=None,
                seed: int = 0, fused_kernel: bool = True,
                kernels_config: KernelsConfig | None = None,
                checkpoint=None, model_base_path=None, savedmodel=None,
                batching_config: BatchingConfig | None = None,
                transport_config: TransportConfig | None = None,
                cache_config: CacheConfig | None = None,
                overload_config: OverloadConfig | None = None,
                integrity_config: IntegrityConfig | None = None,
                cascade_config: CascadeConfig | None = None,
                utilization_config: UtilizationConfig | None = None,
                quality_config: QualityConfig | None = None,
                lifecycle_config: LifecycleConfig | None = None,
                recovery_config: RecoveryConfig | None = None,
                mesh_config: MeshConfig | None = None,
                elastic_config: ElasticConfig | None = None,
                mesh_device_list=None):
    """(impl, batcher, servable): the servable serving at start, warmed
    through every bucket (unless `cfg.warmup` is off), and a started
    batcher. The servable is the numpy-seeded demo (`seed`), the checkpoint
    in `checkpoint`, the SavedModel export in `savedmodel` (imported as
    cfg.model_kind with `model_config`, its assets.extra warmup file
    replayed), or — with `model_base_path` — the newest version a
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

    With `cfg.model_config_file` the server serves every model of that
    ModelServerConfig instead, through a ModelLifecycle
    (`impl.model_lifecycle`, which HandleReloadConfigRequest reconciles);
    the servable returned is `cfg.model_name` when served, else any served
    model, else None. As in the JAX server, the kernel plane is not
    prepared in this mode (its decisions stay empty: the baseline serves).

    The batcher reads back at `cfg.output_wire_dtype` and `output_top_k`;
    `batching_config` sets its in-flight window and pad buffer ring and
    PredictStream's default split; `transport_config.response_arena` turns
    on the service's encode arenas. An enabled `cache_config` arms the
    cache plane: the score cache, the row cache with `row_granular`, and
    dedup with `dedup`; every version watcher invalidates the stores at a
    version change. An enabled `overload_config` hands the batcher an
    AdmissionController (serving/overload.py); an enabled
    `integrity_config` attaches one IntegrityPlane to the batcher and the
    impl (serving/integrity.py). A shadow_fraction above 0 beside an
    enabled score cache is refused (cache hits would never be
    re-checked), and on the card the wire checksums need the native host
    ops. An enabled `cascade_config` registers the stage-1 servable under
    its own name (built in process from the primary model's config, or
    served by a VersionWatcher from `stage1_base_path`,
    `impl.cascade_watcher`) and sets `impl.cascade`; beside `output_top_k`
    it is refused, and beside [mesh] too. An enabled `utilization_config` hands the batcher an OccupancyLedger named
    after its device (`cuda:N (<card>)` or `cpu`); an enabled
    `quality_config` hands it a QualityMonitor, told of every version
    change by each watcher. An enabled `lifecycle_config` sets
    `impl.lifecycle`, a LifecycleController over the registry, the version
    watcher and the quality monitor (it needs `model_base_path` and an
    enabled `quality_config`, and is refused otherwise); its thread is the
    caller's to start. An enabled `recovery_config` attaches a
    RecoveryController (serving/recovery.py) to the batcher and sets
    `impl.recovery`; its watchdog is the caller's to start (serve() does).

    An enabled `mesh_config` arms the mesh serving mode: a ("data",
    "model") mesh (parallel/mesh.py) over `mesh_device_list` (an ordered
    list of devices, which may repeat one: the CPU tests build eight
    logical shards over "cpu") or, by default, every visible card ("cpu"
    once with device="cpu"), with a ShardedExecutor as the batcher's
    run_fn (`impl.mesh_executor`): rows over the data axis, vocab over the
    model axis per the family's partition rules, dense weights too with
    tensor_parallel; the batcher runs on the mesh's first device. An
    enabled `elastic_config` (requires [mesh]) makes the run_fn an
    ElasticMeshExecutor over the split ladder, driven by an
    ElasticController (`impl.elastic`) fed by the batcher's queue_load and
    the overload plane. The JAX package's refusals, in its words: the
    legacy [server] mesh knobs beside [mesh], output_top_k, [recovery]
    scope = "per_chip", [elastic] without [mesh], [cascade] and [kernels]
    over a mesh. The legacy `cfg.mesh_devices` arms a static mesh alone.
    The source options are checked, and a model config file parsed, before
    any thread starts."""
    if model_base_path and (checkpoint or savedmodel):
        raise ValueError(
            "--model-base-path is mutually exclusive with --checkpoint/--savedmodel "
            "(the base path owns version lifecycle)")
    if checkpoint and savedmodel:
        raise ValueError("--checkpoint is mutually exclusive with --savedmodel")
    model_configs = None
    if cfg.model_config_file:
        if model_base_path or checkpoint or savedmodel:
            raise ValueError(
                "--model-config-file is mutually exclusive with "
                "--model-base-path/--checkpoint/--savedmodel (the config "
                "file owns the model list)")
        if cfg.version_labels:
            raise ValueError(
                "--version-label / [server] version_labels have no meaning with "
                "--model-config-file; put per-model version_labels maps in the config "
                "file's model entries instead")
        model_configs = _parse_model_server_config(cfg.model_config_file)
    integrity_armed = integrity_config is not None and integrity_config.enabled
    if (integrity_armed and integrity_config.shadow_fraction > 0
            and cache_config is not None and cache_config.enabled):
        # The JAX package's refusal: a cache hit re-serves score bytes
        # without re-execution, so sampled shadowing could never re-check
        # it.
        raise ValueError(
            "[integrity] shadow_fraction > 0 conflicts with [cache] "
            "enabled: exact-match cache hits re-serve cached score bytes "
            "without re-execution, so sampled shadow verification can "
            "never re-check them — the zero-corrupt-delivery guarantee "
            "would silently exclude every cache hit. Disable the score "
            "cache or set shadow_fraction = 0 (wire checksums and "
            "readback screens still compose with the cache)"
        )
    if (integrity_armed and integrity_config.wire_checksums
            and resolve_device(device).type == "cuda" and not native.ensure()):
        # Checksumming a 2048-row request by the table loop takes about a
        # second of host time per RPC.
        raise RuntimeError(
            "[integrity] wire_checksums needs the native host-ops library "
            "(native/hostops.cc dts_crc32c), which could not be built with g++")
    lifecycle_armed = lifecycle_config is not None and lifecycle_config.enabled
    if lifecycle_armed:
        if not model_base_path:
            raise ValueError(
                "[lifecycle] enabled requires --model-base-path: the watched versioned dir is "
                "both the publish target and the hot-swap mechanism the canary/rollback loop "
                "drives")
        if quality_config is None or not quality_config.enabled:
            raise ValueError(
                "[lifecycle] enabled requires [quality] enabled (or --quality): the rollback "
                "gate reads the quality plane's version-pair drift and per-version label "
                "AUC — a lifecycle with no signal could only ever promote blind")
    mesh_armed = mesh_config is not None and mesh_config.enabled
    if mesh_armed:
        if cfg.mesh_devices or cfg.model_parallel != 1 or cfg.tensor_parallel:
            raise ValueError(
                "[mesh] enabled conflicts with the legacy [server] mesh "
                "knobs (mesh_devices/model_parallel/tensor_parallel): "
                "configure the mesh in ONE place — the [mesh] section is "
                "the serving mode; drop the [server] copies"
            )
        if cfg.output_top_k:
            raise ValueError(
                "[mesh] enabled conflicts with output_top_k: top-k "
                "output compaction is a single-chip jitted-entry "
                "variant the sharded executor does not provide — "
                "disable one of them"
            )
        if (recovery_config is not None and recovery_config.enabled
                and recovery_config.scope == "per_chip"):
            # Whole-mesh recovery composes (the executor recovers as one
            # unit through clear_for_recovery); the finer grain does not.
            raise ValueError(
                "[recovery] scope='per_chip' conflicts with [mesh]: an "
                "SPMD executable spans every chip of the mesh, so there "
                "is no per-chip quarantine to run — a sick chip takes "
                "the executor with it. Use scope='executor' (the "
                "default): the mesh executor quarantines, reinits, and "
                "replays as ONE unit"
            )
    elastic_armed = elastic_config is not None and elastic_config.enabled
    if elastic_armed and not mesh_armed:
        raise ValueError(
            "[elastic] enabled requires [mesh] enabled: the elastic "
            "plane re-factorizes the MESH's devices at runtime — the "
            "[mesh] section's split is where serving starts (and the "
            "ladder's rungs must factorize its device count). Arm both, "
            "or drop [elastic]"
        )
    if (mesh_armed or cfg.mesh_devices) and kernels_config is not None and kernels_config.enabled:
        raise ValueError(
            "[kernels] enabled requires the single-chip batcher path: "
            "the ShardedExecutor mirrors the int8 output wire but owns "
            "its own executables (per-bucket kernel routing over a "
            "mesh is future work) — disable [kernels] or [mesh]"
        )
    cascade_armed = cascade_config is not None and cascade_config.enabled
    if cascade_armed and mesh_armed:
        raise ValueError(
            "[cascade] enabled conflicts with [mesh] (and [elastic]):"
            " the stage-1 prune is a single-chip jitted-entry "
            "variant the sharded run_fn does not provide, so the "
            "cascade could only ever run its host fallback — "
            "disable one of them"
        )
    if cascade_armed and cfg.output_top_k:
        raise ValueError(
            "[cascade] enabled conflicts with output_top_k: the "
            "top-k wire replaces the score vector with (score, "
            "index) pairs, but the cascade's scatter needs the full "
            "vector to fill non-survivors from stage-1 scores — the "
            "two selections cannot both own the response shape. "
            "The cascade IS the retrieval-style compaction; drop "
            "output_top_k"
        )
    run_fn, mesh = _mesh_run_fn(cfg, device, mesh_config if mesh_armed else None,
                                elastic_config if elastic_armed else None, mesh_device_list)
    if mesh is not None:
        device = mesh.device(0, 0)  # outputs gather there; the batcher reads back from it
    bc = batching_config or BatchingConfig()
    if bc.inflight_window or bc.buffer_ring:
        log.info("batching pipeline: depth=%d inflight_window=%s buffer_ring=%s",
                 cfg.pipeline_depth, bc.inflight_window or "unbounded", bc.buffer_ring)
    cc = cache_config or CacheConfig()
    score_cache = cc.build()
    if score_cache is not None:
        log.info("score cache on: max_entries=%d max_bytes=%d ttl_s=%.1f coalesce=%s "
                 "dedup=%s — GET /cachez on the REST surface", cc.max_entries, cc.max_bytes,
                 cc.ttl_s, cc.coalesce, cc.dedup)
    row_cache = cc.build_row()
    if row_cache is not None:
        log.info("row-granular score cache on: max_entries=%d max_bytes=%d ttl_s=%.1f "
                 "coalesce=%s — only cold rows execute; `row_cache` block in /cachez and "
                 "/monitoring", cc.row_max_entries, cc.row_max_bytes, cc.row_ttl_s,
                 cc.row_coalesce)
    overload = overload_config.build() if overload_config is not None else None
    if overload is not None:
        log.info("adaptive overload control on: target_queue_wait_ms=%.1f brownout_after=%d "
                 "shed_after=%d stale_while_overloaded_s=%.1f — `overload` block in "
                 "/monitoring", overload_config.target_queue_wait_ms,
                 overload_config.brownout_after_intervals, overload_config.shed_after_intervals,
                 overload_config.stale_while_overloaded_s)
    ledger = utilization_config.build() if utilization_config is not None else None
    if ledger is not None:
        ledger.device = utilization_mod.device_label(resolve_device(device))
        if mesh is not None:
            # Every batch occupies every shard's device: one busy timeline
            # per device (snapshot per_device, one Chrome track each).
            ledger.devices = mesh.device_names()
            ledger.device = f"mesh{mesh.shape}"
        log.info("utilization attribution on: ring=%d window_s=%.1f calibrated=%s device=%s — "
                 "GET /utilz on the REST surface", utilization_config.ring,
                 utilization_config.window_seconds, ledger.snapshot()["calibrated"],
                 ledger.device)
    quality = quality_config.build() if quality_config is not None else None
    if quality is not None:
        log.info("model-quality observability on: bins=%d window_s=%.1f drift_threshold_psi=%.2f "
                 "reference_file=%s — GET /qualityz and POST /labelz on the REST surface",
                 quality_config.bins, quality_config.window_seconds,
                 quality_config.drift_threshold_psi, quality_config.reference_file or "<none>")
    batcher = DynamicBatcher(
        buckets=cfg.buckets, max_wait_us=cfg.max_wait_us, device=device,
        queue_capacity_candidates=cfg.queue_capacity_candidates,
        fused_kernel=fused_kernel, completion_workers=cfg.completion_workers,
        pipeline_depth=cfg.pipeline_depth, output_wire_dtype=cfg.output_wire_dtype,
        output_top_k=cfg.output_top_k, inflight_window=bc.inflight_window,
        buffer_ring=bc.buffer_ring, score_cache=score_cache, row_cache=row_cache,
        # `enabled` is the master switch: dedup alone arms nothing.
        dedup=cc.enabled and cc.dedup, overload=overload, utilization=ledger, quality=quality,
        run_fn=run_fn,
    )
    kernels = kernels_config.build() if kernels_config is not None else None
    batcher.kernels = kernels
    registry = ServableRegistry()
    impl = PredictionServiceImpl(registry, batcher)
    impl.warmup_complete = False
    impl.int8_score_wire = kernels is not None and kernels.config.int8_score_wire
    impl.stream_chunk_candidates = bc.stream_chunk_candidates
    if transport_config is not None and transport_config.response_arena:
        impl.response_arena = True
        log.info("response-encode arenas on ([transport] response_arena)")
    if mesh is not None:
        # The `mesh` /monitoring block, /meshz and the dts_tpu_mesh_* series
        # read the executor's snapshot (the legacy knobs' mesh too).
        impl.mesh_executor = run_fn
    if elastic_armed:
        from ..parallel.elastic import ElasticController

        # No thread: ticks ride the dispatch path and monitoring scrapes.
        impl.elastic = ElasticController(elastic_config, run_fn, overload=overload,
                                         load_fn=batcher.queue_load,
                                         largest_bucket=max(cfg.buckets))
        log.info("elastic controller on: tick=%.2fs dwell=%.1fs up/down after %d/%d ticks, "
                 "load thresholds %.2f/%.2f, overload pressure %s",
                 elastic_config.tick_interval_s, elastic_config.dwell_s,
                 elastic_config.up_after_ticks, elastic_config.down_after_ticks,
                 elastic_config.load_up_threshold, elastic_config.load_down_threshold,
                 "wired" if overload is not None else "absent (load-only)")
    if integrity_armed:
        # One plane for every hook site: the batcher (shadow, screen), the
        # impl (input verify, response stamps, /integrityz), the transports.
        plane = integrity_config.build()
        batcher.integrity = plane
        impl.integrity = plane
        log.info("data-integrity plane on: wire_checksums=%s screen=%s shadow_fraction=%.3f "
                 "trips/window=%d/%.1fs — GET /integrityz on the REST surface",
                 integrity_config.wire_checksums, integrity_config.screen,
                 integrity_config.shadow_fraction, integrity_config.screen_trips_per_window,
                 integrity_config.screen_window_s)
    if recovery_config is not None and recovery_config.enabled:
        from .recovery import RecoveryController

        # Attaches itself as batcher.recovery; re-warms what the registry
        # serves and pauses the lifecycle controller (impl.lifecycle) while
        # a cycle runs.
        impl.recovery = RecoveryController(recovery_config, batcher, registry=registry,
                                           impl=impl)
        log.info("device-failure recovery on: wedge_quarantine_s=%.1f replay_budget=%d "
                 "poison_kills=%d — GET /recoveryz on the REST surface",
                 recovery_config.wedge_quarantine_s, recovery_config.replay_budget,
                 recovery_config.poison_kills)

    if cascade_armed:
        _arm_cascade(cfg, cascade_config, model_config, registry, batcher, impl)

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

    if model_configs is not None:
        # The watchers warm through the queue, so the batcher runs first.
        batcher.start()
        lifecycle = ModelLifecycle(cfg, registry, batcher, model_config)
        lifecycle.apply(model_configs)
        impl.model_lifecycle = lifecycle
        served = registry.models()
        if served:
            log.info("serving %d model(s) from %s: %s", len(served), cfg.model_config_file,
                     dict(sorted(served.items())))
        else:
            log.warning("no ready versions for any configured model yet; watching")
        ready = cfg.model_name if cfg.model_name in served else (
            sorted(served)[0] if served else None)
        impl.warmup_complete = True
        return impl, batcher, registry.resolve(ready) if ready else None

    if model_base_path:
        # The watcher warms through the queue, so the batcher runs first.
        batcher.start()
        watcher = _make_watcher(
            model_base_path, cfg.model_name, cfg.version_labels, cfg, registry, batcher,
            model_config=model_config or ModelConfig(name=cfg.model_name,
                                                     num_fields=cfg.num_fields))
        impl.served_sources[cfg.model_name] = (str(model_base_path), cfg.model_kind)
        impl.version_watcher = watcher.start()
        if lifecycle_armed:
            from .lifecycle import LifecycleController

            lc = lifecycle_config
            impl.lifecycle = LifecycleController(lc, registry=registry,
                                                 model_name=cfg.model_name, watcher=watcher,
                                                 quality=quality)
            log.info(
                "continuous-freshness lifecycle on: probe_only=%.1fs ramp %.2f+%.2f/%.1fs to "
                "%.2f, promote_after=%.1fs, rollback psi>=%.2f auc_drop>=%.3f, fine_tune every "
                "%s — GET /lifecyclez on the REST surface", lc.canary_probe_only_s,
                lc.canary_initial_fraction, lc.canary_ramp_step, lc.canary_step_dwell_s,
                lc.canary_max_fraction, lc.promote_after_s, lc.rollback_psi,
                lc.rollback_auc_drop,
                f"{lc.fine_tune_interval_s:.0f}s" if lc.fine_tune_interval_s > 0 else "<off>")
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

    replay_file = None
    if savedmodel:
        from ..interop.savedmodel import import_savedmodel
        from .warmup import warmup_file_for

        timings: dict = {}
        servable = import_savedmodel(
            savedmodel, cfg.model_kind,
            model_config or ModelConfig(name=cfg.model_name, num_fields=cfg.num_fields),
            name=cfg.model_name, device=batcher.device, timings=timings)
        registry.load(servable)
        replay_file = warmup_file_for(savedmodel)
        log.info("imported SavedModel %s: %s v%d %s", savedmodel, servable.name,
                 servable.version, json.dumps(timings, sort_keys=True))
    elif checkpoint:
        from ..train.checkpoint import load_servable

        servable = load_servable(checkpoint, device=batcher.device)
        if mesh is not None:
            run_fn.place(servable)
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
    if replay_file is not None and cfg.warmup:
        # The export's own warmup records go through the service and the
        # running batcher before the server answers anything.
        from .warmup import replay_warmup_file

        n = replay_warmup_file(replay_file, servable, batcher)
        log.info("replayed %d warmup records from %s", n, replay_file)
    # The warmup's launches: what a request path adds is the difference to
    # the count at shutdown.
    log.info("kernel launches at start: %s", _launch_counts())
    impl.warmup_complete = True
    return impl, batcher, servable


def _mesh_run_fn(cfg: ServerConfig, device, mesh_config: MeshConfig | None,
                 elastic_config: ElasticConfig | None, device_list):
    """(run_fn, mesh) of the mesh serving mode ([mesh], with [elastic] the
    ladder), of the legacy [server] mesh_devices knob, or (None, None)."""
    if mesh_config is None and not cfg.mesh_devices:
        return None, None
    from ..parallel import ShardedExecutor, make_mesh
    from ..parallel.mesh import default_devices

    if device_list is not None:
        pool = [torch.device(d) for d in device_list]
    elif resolve_device(device).type == "cpu":
        pool = [torch.device("cpu")]
    else:
        pool = default_devices()
    if mesh_config is None:
        # The legacy knobs: a static mesh, kept working unchanged.
        mesh = make_mesh(cfg.mesh_devices, model_parallel=cfg.model_parallel, devices=pool)
        return ShardedExecutor(mesh, tensor_parallel=cfg.tensor_parallel,
                               output_wire_dtype=cfg.output_wire_dtype), mesh
    n_devices = mesh_config.devices or len(pool)
    mp = mesh_config.model_parallel
    # The [mesh] section is authoritative for the layout (the legacy knobs
    # beside it were refused).
    tp = mesh_config.tensor_parallel
    if elastic_config is not None:
        from ..parallel.elastic import ElasticMeshExecutor, resolve_ladder

        if n_devices > len(pool):
            raise ValueError(f"requested {n_devices} devices, have {len(pool)}")
        if n_devices % mp != 0:
            # make_mesh's refusal, in its words, before the ladder's.
            raise ValueError(f"n_devices={n_devices} not divisible by model_parallel={mp}")
        initial = (n_devices // mp, mp)
        ladder = resolve_ladder(elastic_config.splits, n_devices, initial)
        run_fn = ElasticMeshExecutor(
            splits=ladder, initial=initial, devices=pool[:n_devices], tensor_parallel=tp,
            output_wire_dtype=cfg.output_wire_dtype,
            history_events=elastic_config.history_events)
        mesh = run_fn.mesh
        log.info("elastic mesh serving on: %d devices, ladder %s (initial %s) — `elastic` block "
                 "in /meshz and /monitoring, dts_tpu_elastic_* series", n_devices,
                 [f"{d}x{m}" for d, m in ladder], f"{initial[0]}x{initial[1]}")
    else:
        mesh = make_mesh(n_devices, model_parallel=mp, devices=pool)
        run_fn = ShardedExecutor(mesh, tensor_parallel=tp,
                                 output_wire_dtype=cfg.output_wire_dtype)
    log.info("mesh serving mode on: %d devices as %s tensor_parallel=%s wire=%s — `mesh` block "
             "in /monitoring, /meshz, dts_tpu_mesh_* series", n_devices, mesh.shape, tp,
             cfg.output_wire_dtype)
    return run_fn, mesh


def _arm_cascade(cfg: ServerConfig, cc: CascadeConfig, model_config: ModelConfig | None,
                 registry: ServableRegistry, batcher: DynamicBatcher,
                 impl: PredictionServiceImpl) -> None:
    """The stage-1 servable and the orchestrator. Stage 1 is a normal
    registry entry under `cc.stage1_model`: with `stage1_base_path`, the
    versions a VersionWatcher loads from it (warmed through the queue, so
    the batcher starts first); else a demo servable of `stage1_kind` built
    from the primary model's config (seed 0), warmed directly. A two_tower
    stage 1 whose user fields would cover every field is given half of them
    (its user / item split must stay a split), as in the JAX server."""
    from .cascade import CascadeOrchestrator

    if cc.stage1_base_path:
        from .version_watcher import VersionWatcher, VersionWatcherConfig

        batcher.start()
        impl.cascade_watcher = VersionWatcher(
            cc.stage1_base_path, registry,
            VersionWatcherConfig(
                model_name=cc.stage1_model,
                poll_interval_s=cfg.file_system_poll_wait_seconds,
                max_load_attempts=cfg.max_num_load_retries + 1,
            ),
            warmup=batcher.warmup_via_queue if cfg.warmup else None,
            device=batcher.device,
            on_servable_change=_servable_change_hook(batcher.score_cache, batcher.row_cache,
                                                     batcher.quality),
        ).start()
    else:
        base_mc = model_config or ModelConfig(name=cfg.model_name, num_fields=cfg.num_fields)
        overrides = {"name": cc.stage1_model}
        if cc.stage1_kind == "two_tower" and base_mc.num_user_fields >= base_mc.num_fields:
            overrides["num_user_fields"] = max(1, base_mc.num_fields // 2)
        stage1 = load_demo_servable(registry, kind=cc.stage1_kind, name=cc.stage1_model,
                                    config=dataclasses.replace(base_mc, **overrides),
                                    device=batcher.device)
        if cfg.warmup:
            batcher.warmup(stage1)
    impl.cascade = CascadeOrchestrator(
        registry, batcher, stage1_model=cc.stage1_model, survivor_k=cc.survivor_k,
        survivor_fraction=cc.survivor_fraction, score_threshold=cc.score_threshold,
        min_candidates=cc.min_candidates,
    )
    log.info("cascade on: stage1=%s (%s%s) survivors=%s threshold=%s min_candidates=%d — "
             "GET /cascadez on the REST surface", cc.stage1_model, cc.stage1_kind,
             f" from {cc.stage1_base_path}" if cc.stage1_base_path else " demo",
             cc.survivor_k or f"{cc.survivor_fraction:.0%}", cc.score_threshold or "<off>",
             cc.min_candidates)


def _start_fleet_plane(impl: PredictionServiceImpl, fleet_config: FleetConfig,
                       cfg: ServerConfig, port: int, obs: ObservabilityConfig,
                       metrics: ServerMetrics, shutdown: GracefulShutdown):
    """Join the fleet: a gossip agent publishing this replica's record every
    interval, and a rollout follower driving the lifecycle controller (when
    one runs) from the router's rollout state. The gossip port also serves
    `/monitoring` (the metrics' fleet wire) and `/tracez/export` (kept span
    trees, with [observability] trace_export on) to the router's
    aggregator. Returns the plane, set on `impl.fleet` and
    `shutdown.fleet`."""
    from ..fleet import gossip as fleet_gossip
    from ..fleet.replica import ReplicaFleetPlane

    # The gossip id defaults to this replica's serving address: the string
    # the router lists in its [client] hosts, so a record steers the
    # router's scoreboard with no id mapping.
    self_id = fleet_config.self_id or f"{cfg.host}:{port}"
    registry = impl.registry
    export_on = bool(obs.tracing and obs.trace_export)

    def record() -> dict:
        # Built every gossip interval: cheap reads only.
        if impl.draining:
            state = fleet_gossip.DRAINING
        elif impl.recovery is not None and impl.recovery.not_serving():
            state = fleet_gossip.QUARANTINED
        elif not (impl.warmup_complete and registry.models()):
            state = fleet_gossip.STARTING
        else:
            state = fleet_gossip.SERVING
        rec = {"state": state, "versions": tuple(registry.models().get(cfg.model_name, ()))}
        ov = impl.overload_stats()
        if ov:
            rec["pressure"] = str(ov.get("state") or "")
        if impl.integrity is not None:
            # The integrity verdict rides every record, so routers steer
            # around a replica whose shadow compare caught it miscomputing;
            # cleared after the configured clean passes.
            rec["suspect"] = bool(impl.integrity.suspect)
        if impl.lifecycle is not None:
            rec.update(impl.lifecycle.fleet_record())
        # The metrics digest and the scrape address: the router's aggregate
        # falls back to these numbers when the /monitoring scrape fails.
        plane = impl.fleet
        rec["obs"] = {**metrics.fleet_summary(),
                      "addr": plane.agent.listen_addr if plane is not None else "",
                      "trace_export": export_on}
        return rec

    def trace_export(query: dict) -> dict:
        if not export_on or not tracing.enabled():
            return {"enabled": False, "cursor": 0, "spans": []}
        try:
            since = int(query.get("since", 0) or 0)
        except (TypeError, ValueError):
            since = 0
        return tracing.recorder().export_since(since)

    plane = ReplicaFleetPlane(
        dataclasses.replace(fleet_config, self_id=self_id), record_fn=record,
        lifecycle=impl.lifecycle, extra_routes={"/monitoring": metrics.fleet_wire},
        query_routes={"/tracez/export": trace_export})
    impl.fleet = plane
    shutdown.fleet = plane
    plane.start()
    log.info("fleet plane up (id=%s gossip=%s peers=%d rollout_follow=%s)", self_id,
             plane.agent.listen_addr, len(fleet_config.peers), impl.lifecycle is not None)
    return plane


def _version_labels(raw_labels: list[str]) -> tuple[tuple[str, int], ...]:
    """--version-label LABEL=VERSION flags as sorted (label, version) pairs."""
    pairs = []
    for raw in raw_labels:
        label, sep, version = raw.partition("=")
        try:
            pairs.append((label, int(version)))
        except ValueError:
            sep = ""
        if not sep or not label:
            raise SystemExit(f"--version-label expects LABEL=VERSION, got {raw!r}")
    return tuple(sorted(pairs))


def serve(argv=None) -> None:
    p = argparse.ArgumentParser(description="PyTorch TF-Serving-compatible CTR server")
    p.add_argument("--config", help="TOML file with [server], [batching], [transport], "
                   "[model], [kernels], [observability], [cache], [overload], [integrity] and "
                   "[cascade] sections")
    p.add_argument("--port", type=int, default=None)
    p.add_argument("--host", default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--seed", type=int, default=0, help="demo weight seed")
    p.add_argument("--model-kind", help="model family of the demo servable (dcn, dcn_v2, "
                   "wide_deep, deepfm, two_tower, dlrm, generic), and the family a SavedModel "
                   "is imported as (`graph`: its own GraphDef). Overrides [server] model_kind")
    p.add_argument("--model-name", help="the served model's name. Overrides [server] model_name")
    p.add_argument("--num-fields", type=int, help="fields per candidate of the demo servable. "
                   "Overrides [server] and [model] num_fields")
    p.add_argument("--max-workers", type=int, help="gRPC handler threads")
    p.add_argument("--max-wait-us", type=int, help="the batcher's coalescing window")
    source = p.add_mutually_exclusive_group()
    source.add_argument("--checkpoint", help="serve this checkpoint directory "
                        "(servable.json + params.safetensors)")
    source.add_argument("--savedmodel", help="TF SavedModel dir to import and serve "
                        "(interop/savedmodel.py; model family and config from "
                        "--model-kind / [model]; --model-kind graph runs the export's "
                        "own GraphDef)")
    source.add_argument("--model-base-path", help="serve the newest numeric version "
                        "directories under this path, hot-swapping new ones")
    p.add_argument("--model-config-file",
                   help="multi-model serving: a tensorflow_model_server ModelServerConfig "
                   "textproto (model_config_list of name / base_path / model_platform / "
                   "version_labels; one version watcher per model). Equivalent to [server] "
                   "model_config_file")
    p.add_argument("--version-label", action="append", metavar="LABEL=VERSION", default=None,
                   help="assign a version label (repeatable), e.g. --version-label stable=2; "
                   "replaces [server] version_labels")
    p.add_argument("--file-system-poll-wait-seconds", type=float,
                   help="version watcher poll interval (the upstream flag)")
    p.add_argument("--max-num-load-retries", type=int,
                   help="retries of a failing version load after the first (the upstream flag)")
    p.add_argument("--no-warmup", action="store_true",
                   help="serve a version without warming its buckets and warmup file first")
    p.add_argument("--batching-parameters-file",
                   help="tensorflow_model_server batching config (text-format "
                   "BatchingParameters): allowed_batch_sizes -> bucket ladder, "
                   "batch_timeout_micros -> max_wait_us, ...; applied over [server]")
    p.add_argument("--ssl-config-file",
                   help="serve gRPC over TLS: a tensorflow_model_server SSLConfig textproto "
                   "(PEM contents inline; client_verify = true for mTLS)")
    p.add_argument("--request-log-file",
                   help="log a sample of the requests that succeed as PredictionLog "
                   "TFRecords (usable as a warmup file)")
    p.add_argument("--request-log-sampling", type=float,
                   help="sampling rate in [0, 1] of --request-log-file (default 0.01)")
    p.add_argument("--uds-path", help="also serve gRPC on this Unix-domain socket path "
                   "(co-located clients dial unix:<path>). Equivalent to [transport] uds_path")
    p.add_argument("--stream-chunk", type=int, default=None,
                   help="default candidates per PredictStream sub-batch (0 = one chunk). "
                   "Equivalent to [batching] stream_chunk_candidates; a request's "
                   "x-dts-stream-chunk metadata overrides it")
    p.add_argument("--rest-port", type=int, default=0,
                   help="also serve the TF-Serving REST API (the :8501 surface, /v1/models/... "
                   "routes, /monitoring, /tracez) on this port")
    p.add_argument("--metrics-every-s", type=float, default=0.0,
                   help="log a `metrics {...}` snapshot line every S seconds")
    p.add_argument("--tracing", action="store_true",
                   help="per-request span tracing (W3C traceparent propagation; GET /tracez on "
                   "the REST surface, ?format=chrome for a Chrome trace). Equivalent to "
                   "[observability] tracing = true")
    p.add_argument(
        "--cache", action="store_true",
        help="exact-match score cache and single-flight at the batcher (GET /cachez on the "
        "REST surface). Equivalent to [cache] enabled = true; the [cache] section carries "
        "the capacity, ttl, coalesce and dedup knobs and the row-granular tier")
    p.add_argument(
        "--overload", action="store_true", default=None,
        help="adaptive overload control (serving/overload.py): a self-tuning admission limit "
        "steered by queue wait, criticality lanes, doomed-work refusal, brownout stale-serve "
        "and retry-after pushback. Equivalent to [overload] enabled = true; the [overload] "
        "section carries the target, limit, brownout and stale knobs")
    p.add_argument(
        "--integrity", action="store_true", default=None,
        help="data-integrity plane (serving/integrity.py): CRC32C wire checksums both ways "
        "(x-dts-input-crc verified at decode, x-dts-score-crc stamped), the readback NaN/Inf "
        "screen and sampled bit-identity shadow re-execution. Equivalent to [integrity] "
        "enabled = true; the [integrity] section carries the knobs (GET /integrityz)")
    p.add_argument(
        "--cascade", action="store_true", default=None,
        help="in-server ranking cascade (serving/cascade.py): a cheap stage-1 servable (its "
        "own registry entry, hot-swappable) scores the whole candidate set, a prune on the "
        "device keeps the top survivors, and the primary model ranks only those; pruned rows "
        "keep their stage-1 scores and every row carries its stage in `cascade_stage`. "
        "Equivalent to [cascade] enabled = true (GET /cascadez, dts_tpu_cascade_* series); "
        "refused beside output_top_k")
    p.add_argument(
        "--utilization", action="store_true", default=None,
        help="device-utilization attribution (serving/utilization.py): an occupancy ledger and "
        "idle-gap waterfall (GET /utilz on the REST surface, the `utilization` block of "
        "/monitoring, dts_tpu_utilization_* series, a counter track in the Chrome export) with "
        "a live achieved_fraction_of_device_limit. Equivalent to [utilization] enabled = true; "
        "the [utilization] section carries the ring, window and calibration knobs")
    p.add_argument(
        "--quality", action="store_true", default=None,
        help="model-quality observability (serving/quality.py): per-(model, version) score "
        "sketches fed by the completion workers, PSI / JS drift against a pinned reference "
        "(POST /qualityz/snapshot) and between live versions, label feedback through POST "
        "/labelz (windowed AUC, calibration) and drift-linked /tracez exemplars (GET /qualityz, "
        "dts_tpu_quality_* series). Equivalent to [quality] enabled = true; the [quality] "
        "section carries the bins, window, drift and label knobs")
    p.add_argument(
        "--lifecycle", action="store_true", default=None,
        help="continuous-freshness lifecycle (serving/lifecycle.py): a newer version under "
        "--model-base-path becomes a canary (probe lane first, then a deterministic ramp of "
        "default-lane traffic), promoted after a healthy dwell or rolled back (retired and "
        "blacklisted) on the quality plane's version-pair PSI or label-AUC drop, with an "
        "optional fine-tune publisher ([lifecycle] fine_tune_interval_s). Equivalent to "
        "[lifecycle] enabled = true; implies --quality (the rollback gate's signal). GET "
        "/lifecyclez, the `lifecycle` block of /monitoring, dts_tpu_lifecycle_* series")
    p.add_argument(
        "--recovery", action="store_true", default=None,
        help="device-failure recovery plane (serving/recovery.py): a device-fatal batch "
        "failure, a wedge past wedge_quarantine_s or a dead batcher thread quarantines the "
        "replica (health NOT_SERVING, new work refused UNAVAILABLE), REINITs the executor "
        "(device steps, weight and input caches cleared, threads revived, the CUDA context "
        "probed; a lost context holds the quarantine until restart) and replays the "
        "accepted work, bisecting a batch that keeps killing it down to the one request "
        "that does (INVALID_ARGUMENT). Equivalent to [recovery] enabled = true; the "
        "[recovery] section carries the knobs (GET /recoveryz, the `recovery` block of "
        "/monitoring, dts_tpu_recovery_* series)")
    p.add_argument(
        "--fleet", action="store_true", default=None,
        help="fleet robustness plane (fleet/): join the cross-replica health gossip and "
        "follow the fleet-coordinated rollout state (fleet/gossip.py, fleet/rollout.py). "
        "Equivalent to [fleet] enabled = true; the [fleet] section carries the self_id, "
        "peers, gossip and rollout knobs (GET /fleetz, the `fleet` block of /monitoring, "
        "dts_tpu_fleet_* series)")
    p.add_argument(
        "--router", action="store_true", default=None,
        help="run as the fleet router instead of a serving replica (fleet/router.py): a "
        "PredictionService front that embeds the sharded fan-out client as its steering "
        "(row affinity, hedging, failover, a gossip-informed scoreboard, single-writer "
        "rollout coordination). It does no device work and starts without a card. "
        "Requires --config with [client] hosts (the replicas) and [fleet]; every serving "
        "and model flag is ignored")
    p.add_argument(
        "--mesh", action="store_true", default=None,
        help="mesh serving mode: shard serving over a ('data', 'model') device mesh of "
        "the visible cards — candidate rows over the data axis, embedding vocab over the "
        "model axis, one process behind the same wire protocol. Equivalent to [mesh] "
        "enabled = true; with it --mesh-devices / --model-parallel / --tensor-parallel "
        "configure the [mesh] section (`mesh` block in /monitoring, GET /meshz, "
        "dts_tpu_mesh_* series). Refuses [kernels], [cascade], [recovery] "
        "scope='per_chip' and output_top_k; whole-executor [recovery] and [elastic] "
        "compose")
    p.add_argument(
        "--elastic", action="store_true", default=None,
        help="elastic mesh serving (implies --mesh): a ladder of ('data', 'model') "
        "splits over the same devices, placed and warmed at load, with a pressure/load "
        "controller switching the serving split at run time, hitlessly. Equivalent to "
        "[elastic] enabled = true (`elastic` block in /meshz and /monitoring, "
        "dts_tpu_elastic_* series)")
    p.add_argument("--mesh-devices", type=int,
                   help="devices in the mesh ([mesh] devices with --mesh, else the legacy "
                   "[server] mesh_devices)")
    p.add_argument("--model-parallel", type=int,
                   help="devices per vocab shard ([mesh] model_parallel with --mesh)")
    p.add_argument("--tensor-parallel", action="store_true", default=None,
                   help="shard dense MLP/cross weights over the model axis")
    p.add_argument(
        "--kernels", action="store_true",
        help="kernel/quantization plane: int8 weight quantization and the fused "
        "serve kernel, each enabled per bucket only where the load-time autotune "
        "measured a speedup on this device and the accuracy gates passed. "
        "Equivalent to [kernels] enabled = true",
    )
    args = p.parse_args(argv)
    if args.router:
        # The router tier loads no model and touches no device: hand off to
        # its own entry point before any stack is built. The transport
        # flags pass through; the rest belong to replicas.
        if not args.config:
            raise SystemExit("--router requires --config ([client] hosts and a [fleet] section)")
        from ..fleet.router import main as router_main

        router_argv = ["--config", args.config]
        if args.host:
            router_argv += ["--host", args.host]
        if args.port:
            router_argv += ["--port", str(args.port)]
        if args.uds_path:
            router_argv += ["--uds-path", args.uds_path]
        return router_main(router_argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")

    loaded = load_config(args.config) if args.config else {"server": ServerConfig()}
    cfg = loaded["server"]
    kernels_config = loaded.get("kernels") or KernelsConfig()
    if args.kernels:
        kernels_config = dataclasses.replace(kernels_config, enabled=True)
    batching_config = loaded.get("batching") or BatchingConfig()
    if args.stream_chunk is not None:
        batching_config = dataclasses.replace(
            batching_config, stream_chunk_candidates=max(args.stream_chunk, 0))
    cache_config = loaded.get("cache") or CacheConfig()
    if args.cache:
        cache_config = dataclasses.replace(cache_config, enabled=True)
    overload_config = loaded.get("overload")
    if args.overload:
        overload_config = dataclasses.replace(overload_config or OverloadConfig(), enabled=True)
    integrity_config = loaded.get("integrity")
    if args.integrity:
        integrity_config = dataclasses.replace(integrity_config or IntegrityConfig(),
                                               enabled=True)
    cascade_config = loaded.get("cascade") or CascadeConfig()
    if args.cascade:
        cascade_config = dataclasses.replace(cascade_config, enabled=True)
    utilization_config = loaded.get("utilization") or UtilizationConfig()
    if args.utilization:
        utilization_config = dataclasses.replace(utilization_config, enabled=True)
    quality_config = loaded.get("quality") or QualityConfig()
    if args.quality:
        quality_config = dataclasses.replace(quality_config, enabled=True)
    lifecycle_config = loaded.get("lifecycle") or LifecycleConfig()
    if args.lifecycle:
        lifecycle_config = dataclasses.replace(lifecycle_config, enabled=True)
    if lifecycle_config.enabled and not quality_config.enabled:
        # The plane reads the quality plane's evidence: arming it implies
        # [quality] (build_stack would refuse the actuator without it).
        quality_config = dataclasses.replace(quality_config, enabled=True)
    recovery_config = loaded.get("recovery") or RecoveryConfig()
    if args.recovery:
        recovery_config = dataclasses.replace(recovery_config, enabled=True)
    fleet_config = loaded.get("fleet") or FleetConfig()
    if args.fleet:
        fleet_config = dataclasses.replace(fleet_config, enabled=True)
    mesh_config = loaded.get("mesh") or MeshConfig()
    if args.mesh:
        mesh_config = dataclasses.replace(mesh_config, enabled=True)
    elastic_config = loaded.get("elastic") or ElasticConfig()
    if args.elastic:
        elastic_config = dataclasses.replace(elastic_config, enabled=True)
        # The flag implies the mesh it resizes; a TOML [elastic] without
        # [mesh] is refused by build_stack instead.
        mesh_config = dataclasses.replace(mesh_config, enabled=True)
    if mesh_config.enabled:
        # With the mesh mode armed the geometry flags configure [mesh], and
        # are withheld from the legacy [server] knobs (which build_stack
        # refuses beside it).
        geometry = {k: v for k, v in {"devices": args.mesh_devices,
                                      "model_parallel": args.model_parallel,
                                      "tensor_parallel": args.tensor_parallel}.items()
                    if v is not None}
        if geometry:
            mesh_config = dataclasses.replace(mesh_config, **geometry)
        args.mesh_devices = args.model_parallel = args.tensor_parallel = None
    obs = loaded.get("observability") or ObservabilityConfig()
    if args.tracing:
        obs = dataclasses.replace(obs, tracing=True)
    transport_config = loaded.get("transport") or TransportConfig()
    if args.uds_path:
        transport_config = dataclasses.replace(transport_config, uds_path=args.uds_path)
    model_config = loaded.get("model")
    if model_config is not None:
        # The flags win over the [model] section, as over [server].
        arch = {k: v for k, v in {"num_fields": args.num_fields, "name": args.model_name}.items()
                if v is not None}
        if arch:
            model_config = dataclasses.replace(model_config, **arch)
    fields = {f.name for f in dataclasses.fields(ServerConfig)}
    overrides = {k: v for k, v in vars(args).items() if v is not None and k in fields}
    if args.no_warmup:
        overrides["warmup"] = False
    if args.version_label:
        overrides["version_labels"] = _version_labels(args.version_label)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    if args.batching_parameters_file:
        cfg = apply_batching_parameters(cfg, read_batching_parameters(
            args.batching_parameters_file))
    # Parsed before the stack is built: a bad file fails in milliseconds.
    credentials = load_ssl_credentials(args.ssl_config_file) if args.ssl_config_file else None
    _refuse_uds_beside_tls(credentials, transport_config.uds_path)
    request_logger = None
    if cfg.request_log_file:
        from .request_log import RequestLogger

        request_logger = RequestLogger(cfg.request_log_file,
                                       sampling_rate=cfg.request_log_sampling)

    try:
        impl, batcher, servable = build_stack(
            cfg, model_config, args.device, args.seed, kernels_config=kernels_config,
            checkpoint=args.checkpoint, model_base_path=args.model_base_path,
            savedmodel=args.savedmodel,
            batching_config=batching_config, transport_config=transport_config,
            cache_config=cache_config, overload_config=overload_config,
            integrity_config=integrity_config, cascade_config=cascade_config,
            utilization_config=utilization_config, quality_config=quality_config,
            lifecycle_config=lifecycle_config, recovery_config=recovery_config,
            mesh_config=mesh_config, elastic_config=elastic_config,
        )
    except BaseException:
        if request_logger is not None:
            request_logger.close()
        raise
    if impl.lifecycle is not None:
        # The CLI drives the controller from its thread: ticks and the
        # fine-tune publisher's cadence.
        impl.lifecycle.start()
    if impl.recovery is not None:
        # The watchdog: escalates the wedge clock on its interval; a failure
        # wakes it early.
        impl.recovery.start()
    shutdown = GracefulShutdown(
        impl, batcher, grace_s=loaded.get("drain_grace_s", DRAIN_GRACE_S),
        watcher=impl.model_lifecycle or impl.version_watcher, request_logger=request_logger,
        lifecycle=impl.lifecycle, recovery=impl.recovery)
    if request_logger is not None:
        impl.request_logger = request_logger
        log.info("request logging to %s (sampling %.4f)", cfg.request_log_file,
                 cfg.request_log_sampling)
    if obs.apply() is not None:
        log.info("per-request tracing on (buffer=%d sample_rate=%.3f slowest_n=%d): GET /tracez "
                 "on the REST surface", obs.trace_buffer, obs.trace_sample_rate,
                 obs.trace_slowest_n)
    metrics = ServerMetrics(window_s=obs.window_seconds)
    server, port = create_server(impl, f"{cfg.host}:{cfg.port}", cfg.max_workers,
                                 uds_path=transport_config.uds_path or None,
                                 credentials=credentials, quiesce=shutdown.quiesce,
                                 metrics=metrics)
    server.start()
    shutdown.server = server
    shutdown.install_signal_handler()
    if fleet_config.enabled:
        _start_fleet_plane(impl, fleet_config, cfg, port, obs, metrics, shutdown)
    if args.rest_port:
        # /profilez starts its profiler on another thread: the profiler's
        # process-wide setup runs here, on the thread that imported torch.
        utilization_mod.prime_profiler()
        try:
            bound = start_rest_in_thread(impl, cfg.host, args.rest_port, metrics)
        except RuntimeError as exc:
            shutdown.shutdown()
            raise SystemExit(str(exc)) from exc
        log.info("REST gateway on %s:%d (/v1/models/...)", cfg.host, bound)
    what = (f"{servable.name} v{servable.version}" if servable is not None
            else f"{cfg.model_name} (awaiting versions)")
    kind = servable.model.kind if servable is not None else cfg.model_kind
    log.info("serving %s (%s) on %s:%d, device %s", what, kind, cfg.host, port, batcher.device)
    if credentials is not None:
        log.info("the gRPC port is TLS-secured (--ssl-config-file)")
    if transport_config.uds_path:
        log.info("also serving on unix:%s", transport_config.uds_path)
    log.info("readback wire %s, top-k %d, PredictStream chunk %d, int8 score wire %s",
             cfg.output_wire_dtype, cfg.output_top_k, impl.stream_chunk_candidates,
             "armed" if impl.int8_score_wire else "off")
    servable = None  # a retired version must not stay alive here
    try:
        if args.metrics_every_s > 0:
            # wait_for_termination(timeout) is True while the server lives
            # on past the timeout, False once it has terminated.
            while server.wait_for_termination(timeout=args.metrics_every_s):
                snap = metrics.snapshot(batcher.stats)
                snap["phases"] = request_trace.snapshot()
                snap["decode"] = codec.decode_counts()
                log.info("metrics %s", json.dumps(snap))
        else:
            server.wait_for_termination()
    finally:
        # The drain a signal started, or this one; idempotent.
        shutdown.shutdown()
        lost = impl.recovery.context_lost() if impl.recovery is not None else None
        if lost is not None:
            # The interpreter's teardown would free the batcher's pinned
            # buffers, and torch aborts the process when it cannot record
            # their events on a dead context: the drained replica ends here.
            log.warning("exiting without the interpreter's teardown: the CUDA context is "
                        "lost (%s)", lost)
            logging.shutdown()
            os._exit(0)


if __name__ == "__main__":
    serve()
