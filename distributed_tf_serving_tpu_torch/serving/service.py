"""PredictionService semantics, transport-free: ModelSpec resolution with
latest-version default, signature lookup, input decode and validation
against the signature, output_filter selection, the int8 score response
wire, server-streaming Predict (PredictStream: the request split into
sub-batches, each answered as its readback completes), the Example-input
RPCs (Classify, Regress, MultiInference), the model-status / metadata
RPCs, and ModelService's HandleReloadConfigRequest. server.py is a thin
gRPC adapter over this class, and rest.py the REST gateway over it (the
`*_async` entry points await the batcher instead of blocking a thread).

Phases: `predict.decode`, `predict.execute` and `predict.encode` are timed
into utils/tracing.py's request_trace (and become child spans of the RPC's
root span while tracing is on); the current span rides into the batcher
with each submit.

Status codes: unknown model/version/signature -> NOT_FOUND; malformed
tensors, signature mismatches and an input whose bytes do not match the
request's x-dts-input-crc stamp ("corrupt-wire") -> INVALID_ARGUMENT;
oversized batches, a full queue and an overload-plane refusal ->
RESOURCE_EXHAUSTED (the refusal's retry-after-ms hint rides
ServiceError.retry_after_ms); an expired deadline -> DEADLINE_EXCEEDED; an
open circuit breaker (batcher.DeviceWedgedError), a recovery quarantine
(DeviceQuarantinedError), a readback-screen failure (IntegrityScreenError),
a shadow mismatch, a dead batcher thread (BatcherThreadDead), other batcher
failures, and any inference RPC once the server drains for shutdown ->
UNAVAILABLE; an input the recovery plane's bisection isolated as a device
killer (PoisonedInputError) -> INVALID_ARGUMENT; an injected fault
(faults.py, at `decode` here or at a batcher site) -> the code its rule
names. The threaded and the coroutine paths share one mapping.

The overload and integrity planes: every inference entry point takes the
request's `criticality` lane (x-dts-criticality) into the batcher's
admission; a result the batcher served stale leaves its degraded mark in
the calling context (serving/overload.py), whence the transports send
x-dts-degraded. With `integrity` armed, Predict verifies `input_crc` on the
decoded arrays and `response_crc_sidecar` stamps the response.

With `cascade` set (serving/cascade.py), a Predict that asked for the score
output alone and carries at least `min_candidates` rows runs the ranking
cascade: stage-1 scores and prunes on the device, the model ranks only the
survivors, and the response carries `cascade_stage` (int32, 1 = stage-1
score, 2 = ranked) beside the scores.

With `response_arena` ([transport] response_arena) the response encodes and
the Example decoder take their scratch from a per-thread codec.EncodeArena,
and each PredictStream reuses one chunk message.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import logging
import threading
import time

import numpy as np

from .. import codec, faults
from . import overload as overload_mod
from ..models.registry import (
    ModelNotFoundError,
    Servable,
    ServableRegistry,
    Signature,
    SignatureNotFoundError,
    VersionNotFoundError,
)
from ..proto import serving_apis_pb2 as apis
from ..proto import tf_framework_pb2 as fw
from ..utils import tracing
from ..utils.tracing import request_trace
from .batcher import (
    BatchTooLargeError,
    DeviceWedgedError,
    DynamicBatcher,
    PoisonedInputError,
    QueueOverloadError,
    RequestDeadlineError,
)
from .cascade import STAGE_OUTPUT
from .example_codec import ExampleDecodeError, decode_input
from .integrity import IntegrityScreenError

log = logging.getLogger("dts_torch.service")

SIGNATURE_DEF_FIELD = "signature_def"


class ServiceError(Exception):
    """Carries a grpc status code name ('NOT_FOUND', ...). `retry_after_ms`,
    when set (an overload-plane refusal), is the pushback hint the
    transports send as trailing metadata (gRPC) or Retry-After (REST)."""

    def __init__(self, code: str, message: str, retry_after_ms: int | None = None):
        super().__init__(message)
        self.code = code
        self.retry_after_ms = retry_after_ms


def _wrap_lookup(fn):
    try:
        return fn()
    except (ModelNotFoundError, VersionNotFoundError, SignatureNotFoundError) as e:
        raise ServiceError("NOT_FOUND", str(e)) from e


class PredictionServiceImpl:
    """Registry + batcher -> Predict, PredictStream, Classify, Regress,
    MultiInference, GetModelMetadata, GetModelStatus,
    HandleReloadConfigRequest."""

    # Bounded wait: a stuck batch must not hold an RPC thread forever.
    _BATCH_DEADLINE_S = 120.0
    # At most this many sub-batches per PredictStream: a small chunk
    # override on a big request is raised until the split fits.
    _STREAM_MAX_CHUNKS = 64

    def __init__(self, registry: ServableRegistry, batcher: DynamicBatcher):
        self.registry = registry
        self.batcher = batcher
        # Default candidates per PredictStream sub-batch ([batching]
        # stream_chunk_candidates); 0 = one chunk.
        self.stream_chunk_candidates = 0
        # The int8 score response wire, armed per server by a built kernels
        # plane with int8_score_wire = true (server.build_stack).
        self.int8_score_wire = False
        # False while the server loads and warms up: health reports
        # NOT_SERVING until then.
        self.warmup_complete = True
        # name -> (base_path, model kind) of the model a --model-base-path
        # watcher owns. Such a model with no version loaded yet is START in
        # GetModelStatus and NOT_SERVING in health, not NOT_FOUND; and a
        # label-only reload may restate this source, but not move it.
        self.served_sources: dict[str, tuple[str, str]] = {}
        # The VersionWatcher of a --model-base-path server, else None.
        self.version_watcher = None
        # The continuous-freshness controller (serving/lifecycle.py
        # LifecycleController), or None: with one, a DEFAULT resolution of
        # its model asks the canary router (a request that pins a version
        # or a label is never routed). None costs one attribute read per
        # resolution.
        self.lifecycle = None
        # The ModelLifecycle of a --model-config-file server (server.py),
        # else None: with it HandleReloadConfigRequest replaces the served
        # model list.
        self.model_lifecycle = None
        # The sampled request log (serving/request_log.RequestLogger), or
        # None: a request that succeeded is offered to it.
        self.request_logger = None
        # Set once shutdown starts (server.GracefulShutdown): every new
        # inference RPC is refused UNAVAILABLE while accepted work ends.
        self.draining = False
        # Reusable encode scratch ([transport] response_arena): a per-thread
        # codec.EncodeArena for the response encodes and the Example
        # decoder, and one reused chunk message per PredictStream. Off =
        # allocate per call.
        self.response_arena = False
        self._arenas = threading.local()
        # The integrity plane (serving/integrity.py), shared with the
        # batcher, or None: input CRC verify, response stamps, /integrityz.
        self.integrity = None
        # The ranking cascade (serving/cascade.py CascadeOrchestrator), or
        # None: an eligible Predict runs stage 1, the prune and stage 2.
        self.cascade = None
        # The stage-1 model's VersionWatcher ([cascade] stage1_base_path),
        # else None: the drain stops it before the main watcher.
        self.cascade_watcher = None
        # The recovery plane's RecoveryController (serving/recovery.py), or
        # None: health reads its not_serving(), /recoveryz its snapshot.
        self.recovery = None
        # The fleet plane (fleet/replica.py ReplicaFleetPlane), or None:
        # gossip membership and the rollout follower, set by the server
        # when [fleet] arms it. GET /fleetz and the dts_tpu_fleet_* series.
        self.fleet = None
        # The mesh executor (parallel/executor.py ShardedExecutor, or the
        # elastic ladder's ElasticMeshExecutor), or None when serving is
        # single-device: the `mesh` /monitoring block, GET /meshz and the
        # dts_tpu_mesh_* series read its snapshot().
        self.mesh_executor = None
        # The elastic controller (parallel/elastic.py ElasticController),
        # or None: the `elastic` section and the dts_tpu_elastic_* series.
        self.elastic = None

    def _arena(self) -> codec.EncodeArena | None:
        """The calling thread's EncodeArena, or None with response_arena
        off. Per thread: an arena is single-owner scratch."""
        if not self.response_arena:
            return None
        arena = getattr(self._arenas, "arena", None)
        if arena is None:
            arena = self._arenas.arena = codec.EncodeArena()
        return arena

    def mesh_stats(self, utilization: dict | None = None) -> dict | None:
        """The mesh snapshot (geometry and device list, executor batch and
        pad counters, layout source per served model, and per-device
        occupancy when the utilization ledger rides along): the `mesh`
        /monitoring block, GET /meshz and the dts_tpu_mesh_* series. None
        when serving is single-device. `utilization` (a utilization_stats()
        snapshot already taken) saves a second snapshot when the caller
        renders both blocks in one pass."""
        ex = self.mesh_executor
        if ex is None:
            return None
        snap = ex.snapshot()
        ledger = getattr(self.batcher, "utilization", None)
        if ledger is not None:
            # The per-device attribution has one implementation, the
            # ledger's own snapshot, lifted here. A ledger never labeled
            # with the devices (build_stack labels it) adopts the mesh's
            # first, which needs a fresh snapshot.
            try:
                usnap = utilization
                if getattr(ledger, "devices", None) is None:
                    ledger.devices = list(snap["devices"])
                    usnap = None
                if usnap is None:
                    usnap = ledger.snapshot()
                if usnap.get("per_device") is not None:
                    snap["per_device"] = usnap["per_device"]
                    snap["occupancy_attribution"] = usnap.get(
                        "occupancy_attribution", "spmd_uniform")
            except Exception:  # noqa: BLE001 — telemetry, never a dependency
                log.exception("mesh_stats: utilization attribution failed")
        return snap

    def elastic_stats(self, mesh: dict | None = None) -> dict | None:
        """The elastic snapshot (current split, ladder, per-split serve
        counters and live in-flight, switch history, controller state):
        the `elastic` /monitoring section and the dts_tpu_elastic_* series.
        None with [elastic] off. The same block rides inside mesh_stats()
        as its `elastic` key; `mesh` (a mesh_stats() snapshot already
        taken) lends it instead of a second walk of the executor."""
        ctrl = self.elastic
        if ctrl is None:
            return None
        if mesh is not None and mesh.get("elastic") is not None:
            return mesh["elastic"]
        return ctrl.executor.elastic_snapshot()

    def fleet_stats(self) -> dict | None:
        """The fleet plane's snapshot (gossip membership view and exchange
        counters, rollout-follower state): GET /fleetz, the `fleet` block in
        /monitoring and the dts_tpu_fleet_* series. None with the plane
        off."""
        fl = self.fleet
        return fl.fleet_stats() if fl is not None else None

    def recovery_stats(self) -> dict | None:
        """The recovery controller's snapshot (state machine, quarantine /
        reinit / replay / bisection counters, the last cycle, the MTTR
        history, events): GET /recoveryz, the /monitoring `recovery` block
        and the dts_tpu_recovery_* series. None with the plane off."""
        rec = self.recovery
        return rec.snapshot() if rec is not None else None

    def lifecycle_stats(self) -> dict | None:
        """The lifecycle controller's snapshot (state machine, canary
        routing share and counters, publish / promote / rollback history,
        the watcher's blacklist and pins): GET /lifecyclez, the
        /monitoring `lifecycle` block and the dts_tpu_lifecycle_* series.
        None with the plane off."""
        lc = self.lifecycle
        return lc.snapshot() if lc is not None else None

    def lifecycle_route(self, name: str, version, label,
                        criticality: str | None) -> int | None:
        """The canary router's version for one request, or None. Only
        DEFAULT resolutions of the controller's own model are routed: a
        pinned version or label is the client's choice."""
        lc = self.lifecycle
        if lc is None or version is not None or label is not None or name != lc.model:
            return None
        return lc.route(criticality)

    def overload_stats(self) -> dict | None:
        """The overload controller's snapshot (adaptive limit, pressure
        state, shed / doomed / brownout counters): the /monitoring
        `overload` block and the dts_tpu_overload_* series. None with the
        plane off."""
        ctrl = self.batcher.overload
        return ctrl.snapshot() if ctrl is not None else None

    def utilization_stats(self, window_s: float | None = None) -> dict | None:
        """The occupancy ledger's snapshot (counters, idle gaps by cause,
        the windowed gap waterfall, achieved_fraction_of_device_limit): GET
        /utilz, the /monitoring `utilization` block and the
        dts_tpu_utilization_* series. None with the plane off."""
        ledger = self.batcher.utilization
        return ledger.snapshot(window_s) if ledger is not None else None

    def quality_stats(self, model: str | None = None, version: int | None = None) -> dict | None:
        """The quality monitor's snapshot (per-(model, version) sketches,
        drift against the reference and between live versions, the label
        join's AUC and calibration, exemplars): GET /qualityz, the
        /monitoring `quality` block and the dts_tpu_quality_* series. None
        with the plane off."""
        monitor = self.batcher.quality
        if monitor is None:
            return None
        return monitor.snapshot(model=model, version=version)

    def _quality_monitor(self):
        monitor = self.batcher.quality
        if monitor is None:
            raise ServiceError("FAILED_PRECONDITION",
                               "no quality monitor is configured ([quality] enabled=false)")
        return monitor

    def quality_ingest_labels(self, items) -> dict:
        """POST /labelz: join (id, label, ts) records onto the score
        reservoir. FAILED_PRECONDITION with the plane off, INVALID_ARGUMENT
        on a malformed item (the whole call is then refused)."""
        monitor = self._quality_monitor()
        try:
            return monitor.ingest_labels(items)
        except (TypeError, ValueError) as e:
            raise ServiceError("INVALID_ARGUMENT", str(e)) from e

    def quality_pin_reference(self) -> dict:
        """POST /qualityz/snapshot: pin the current windowed score
        distributions as the drift reference, and write the artifact when a
        reference_file is configured."""
        return self._quality_monitor().pin_reference()

    def integrity_stats(self) -> dict | None:
        """The integrity plane's snapshot (wire verify / reject counters,
        screen trips, shadow batches / mismatches / audits, the suspect
        verdict, events): GET /integrityz, the /monitoring `integrity` block
        and the dts_tpu_integrity_* series. None with the plane off."""
        integ = self.integrity
        return integ.snapshot() if integ is not None else None

    def cascade_stats(self) -> dict | None:
        """The cascade's snapshot (requests, fallbacks, host prunes, row
        dispositions, stage seconds, survivor buckets: the JAX package's
        fields) with the batcher's prune counters under `batcher`: GET
        /cascadez, the /monitoring `cascade` block and the
        dts_tpu_cascade_* series. None with the plane off."""
        casc = self.cascade
        if casc is None:
            return None
        snap = casc.snapshot()
        stats = self.batcher.stats
        snap["batcher"] = {"prune_batches": stats.prune_batches,
                           "prune_fallback_batches": stats.prune_fallback_batches}
        return snap

    def response_crc_sidecar(self, resp) -> str | None:
        """The x-dts-score-crc value for one encoded PredictResponse, or
        None when the plane (or its wire layer) is off. The transports call
        it after the handler returns: the stamp covers the tensors on the
        wire."""
        integ = self.integrity
        if integ is None or not integ.config.wire_checksums:
            return None
        return integ.response_sidecar(resp.outputs)

    def cache_stats(self) -> dict | None:
        """The score cache's snapshot (per-model hit / miss / coalesced /
        eviction counters, occupancy, config): the body of GET /cachez and
        the /monitoring `cache` block. None when no score cache is armed."""
        cache = self.batcher.score_cache
        return cache.snapshot() if cache is not None else None

    def row_cache_stats(self) -> dict | None:
        """The row cache's snapshot (per-row counters, rows_executed
        against rows_requested, occupancy) with the batcher's row counters:
        the `row_cache` block of GET /cachez and /monitoring and the
        dts_tpu_cache_row_* series. None when no row cache is armed."""
        rc = self.batcher.row_cache
        if rc is None:
            return None
        snap = rc.snapshot()
        stats = self.batcher.stats
        snap["batcher"] = {
            "row_batches": stats.row_batches,
            "rows_requested": stats.rows_requested,
            "rows_executed": stats.rows_executed,
            "row_full_hit_batches": stats.row_full_hit_batches,
        }
        return snap

    def cache_flush(self, model: str | None = None) -> int:
        """Drop every cached score, or one model's, in both stores. The
        flush bumps the generation, so fills of computations already in
        flight are dropped too. Returns the entries dropped; without an
        armed store, FAILED_PRECONDITION."""
        cache, row_cache = self.batcher.score_cache, self.batcher.row_cache
        if cache is None and row_cache is None:
            raise ServiceError("FAILED_PRECONDITION",
                               "no score cache is configured ([cache] enabled=false)")
        dropped = cache.flush(model) if cache is not None else 0
        if row_cache is not None:
            dropped += row_cache.flush(model)
        return dropped

    def kernels_stats(self) -> dict | None:
        """The kernel plane's snapshot (ops/autotune.py KernelManager): the
        /monitoring `kernels` block and the dts_tpu_kernel_* series. None
        with the plane off."""
        kern = self.batcher.kernels
        return kern.snapshot() if kern is not None else None

    def versions_stats(self) -> dict | None:
        """The --model-base-path watcher's snapshot (the /monitoring
        `versions` block), or None without one."""
        watcher = self.version_watcher
        return watcher.snapshot() if watcher is not None else None

    def pipeline_stats(self) -> dict | None:
        """The batcher's dispatch pipeline (the /monitoring `pipeline` block
        and the dts_tpu_pipeline_* series)."""
        return self.batcher.pipeline_stats()

    def is_configured(self, name: str) -> bool:
        """True when this server is configured to serve `name` (a watcher
        or the model lifecycle owns it), whether or not a version of it is
        ready yet."""
        lifecycle = self.model_lifecycle
        return name in self.served_sources or (
            lifecycle is not None and name in lifecycle.configured_models())

    def _refuse_if_draining(self) -> None:
        """Once shutdown started, new inference work is refused UNAVAILABLE
        (fan-out clients reroute to another backend) while the work already
        accepted completes."""
        if self.draining:
            raise ServiceError(
                "UNAVAILABLE",
                "server is draining (shutdown in progress); retry against another backend",
            )

    def _log_request(self, kind: str, request) -> None:
        if self.request_logger is not None:
            self.request_logger.maybe_log(kind, request)

    @staticmethod
    def _version_choice(model_spec: apis.ModelSpec) -> tuple[int | None, str | None]:
        """(version, label); the two are a oneof upstream, so setting both
        is a client error."""
        version = model_spec.version.value if model_spec.HasField("version") else None
        label = model_spec.version_label or None
        if version is not None and label is not None:
            raise ServiceError(
                "INVALID_ARGUMENT",
                "model_spec sets both version and version_label; they are a "
                "oneof upstream — choose one",
            )
        return version, label

    def _resolve(self, model_spec: apis.ModelSpec,
                 criticality: str | None = None) -> tuple[Servable, Signature]:
        if not model_spec.name:
            raise ServiceError("INVALID_ARGUMENT", "model_spec.name is required")
        version, label = self._version_choice(model_spec)
        servable = self.resolve_servable(model_spec.name, version, label, criticality)
        signature = _wrap_lookup(lambda: servable.signature(model_spec.signature_name))
        return servable, signature

    def resolve_servable(self, name: str, version, label,
                         criticality: str | None = None) -> Servable:
        """The servable a request names, after the lifecycle plane's canary
        router has had its say on a DEFAULT resolution (the gRPC path and
        the REST gateway both resolve here). Lookup errors are NOT_FOUND."""
        routed = self.lifecycle_route(name, version, label, criticality)
        if routed is None:
            return _wrap_lookup(lambda: self.registry.resolve(name, version, label))
        try:
            servable = self.registry.resolve(name, routed)
        except (ModelNotFoundError, VersionNotFoundError):
            # The routed version vanished (a rollback racing this request):
            # the latest version serves it. A rollout action never fails
            # live traffic.
            servable = _wrap_lookup(lambda: self.registry.resolve(name))
        span = tracing.current_span()
        if span is not None:
            span.attrs["lifecycle_version"] = servable.version
        return servable

    @staticmethod
    def _echo_spec(servable: Servable, signature_name: str) -> apis.ModelSpec:
        spec = apis.ModelSpec(name=servable.name, signature_name=signature_name)
        spec.version.value = servable.version
        return spec

    # --------------------------------------------------------------- Predict

    def _decode_and_validate(
        self, servable: Servable, signature: Signature, inputs
    ) -> dict[str, np.ndarray]:
        arrays: dict[str, np.ndarray] = {}
        specs = signature.input_specs
        for key in inputs:
            if key not in specs:
                raise ServiceError(
                    "INVALID_ARGUMENT",
                    f"unexpected input {key!r}; signature expects {sorted(specs)}",
                )
        model = servable.model
        n = None
        for name, spec in specs.items():
            if name not in inputs:
                if name == "dense_features":
                    continue  # optional
                raise ServiceError("INVALID_ARGUMENT", f"missing required input {name!r}")
            tp = inputs[name]
            # Compact wire: a client may pre-apply the server's own first
            # transforms — int32 ids already folded into the vocab, and bf16
            # weights for a model that casts its weights to bf16 anyway.
            # bf16 decodes widened to f32, so check the declared dtype.
            if tp.dtype == fw.DataType.DT_BFLOAT16 and not (
                name == "feat_wts"
                and spec.dtype == fw.DataType.DT_FLOAT
                and model.wts_in_compute_dtype
                and model.config.compute_dtype == "bfloat16"
            ):
                raise ServiceError(
                    "INVALID_ARGUMENT",
                    f"input {name!r}: dtype DT_BFLOAT16 != signature "
                    f"{fw.DataType.Name(spec.dtype)}",
                )
            try:
                arr = codec.to_ndarray(tp)
            except codec.CodecError as e:
                raise ServiceError("INVALID_ARGUMENT", f"input {name!r}: {e}") from e
            if arr.dtype != codec.dtype_to_numpy(spec.dtype):
                widened = (
                    spec.dtype == fw.DataType.DT_INT64
                    and arr.dtype == np.int32
                    and name == "feat_ids"
                    and model.folds_ids_on_host
                )
                if not widened:
                    raise ServiceError(
                        "INVALID_ARGUMENT",
                        f"input {name!r}: dtype {arr.dtype} != signature "
                        f"{fw.DataType.Name(spec.dtype)}",
                    )
                if arr.size:
                    # int32 ids ride the u24 pack, which keeps 3 bytes: an
                    # unfolded or negative id would silently hit a wrong row.
                    lo, hi = int(arr.min()), int(arr.max())
                    if lo < 0 or hi >= model.config.vocab_size:
                        raise ServiceError(
                            "INVALID_ARGUMENT",
                            f"input {name!r}: int32 compact ids must be "
                            f"pre-folded into [0, {model.config.vocab_size}) "
                            f"(got range [{lo}, {hi}])",
                        )
            if spec.shape is None:
                if arr.ndim == 0:
                    raise ServiceError(
                        "INVALID_ARGUMENT",
                        f"input {name!r}: scalar tensor has no candidate dimension",
                    )
            elif (
                arr.ndim != len(spec.shape)
                or any(s is not None and s != d for s, d in zip(spec.shape, arr.shape))
            ):
                raise ServiceError(
                    "INVALID_ARGUMENT",
                    f"input {name!r}: shape {arr.shape} incompatible with signature "
                    f"{spec.shape}",
                )
            if n is None:
                n = arr.shape[0]
            elif arr.shape[0] != n:
                raise ServiceError(
                    "INVALID_ARGUMENT",
                    f"inconsistent candidate counts: {name!r} has {arr.shape[0]}, "
                    f"expected {n}",
                )
            arrays[name] = arr
        if n == 0:
            raise ServiceError("INVALID_ARGUMENT", "empty candidate batch")
        return arrays

    @staticmethod
    def _clock_deadline(deadline_s: float | None) -> float | None:
        """Absolute give-up instant for a remaining budget, taken at RPC
        entry, so decode and validation spend the client's budget."""
        return None if deadline_s is None else time.perf_counter() + deadline_s

    @staticmethod
    def _budget_left(deadline_t: float | None) -> float | None:
        return None if deadline_t is None else deadline_t - time.perf_counter()

    def _effective_timeout(self, deadline_s: float | None) -> float:
        if deadline_s is None:
            return self._BATCH_DEADLINE_S
        if deadline_s <= 0:
            raise ServiceError("DEADLINE_EXCEEDED", "client deadline already expired on arrival")
        return min(deadline_s, self._BATCH_DEADLINE_S)

    @staticmethod
    def _translate_batcher_error(exc: Exception, fut) -> ServiceError:
        """One mapping from batcher failures to RPC status, for unary and
        streamed Predicts alike. Re-raises anything that is not a batcher
        failure (the transport answers INTERNAL)."""
        if isinstance(exc, PoisonedInputError):
            # The bisection's verdict: these bytes kill the executor. A
            # ValueError, which would otherwise re-raise as INTERNAL.
            return ServiceError("INVALID_ARGUMENT", str(exc))
        if isinstance(exc, (BatchTooLargeError, QueueOverloadError)):
            # An overload-plane refusal carries its retry-after-ms hint.
            return ServiceError("RESOURCE_EXHAUSTED", str(exc),
                                retry_after_ms=getattr(exc, "retry_after_ms", None))
        if isinstance(exc, (DeviceWedgedError, IntegrityScreenError)):
            # A screen failure is this request's alone: retryable elsewhere.
            return ServiceError("UNAVAILABLE", str(exc))
        if isinstance(exc, RequestDeadlineError):
            # The batcher shed the queued item itself: nothing to withdraw.
            return ServiceError("DEADLINE_EXCEEDED", str(exc))
        if isinstance(exc, faults.InjectedFaultError):
            # An injected fault at a batcher site keeps its code instead of
            # falling into the RuntimeError catch-all below.
            return ServiceError(exc.code_name, str(exc))
        if isinstance(exc, concurrent.futures.TimeoutError):
            # Withdraw the work: a cancelled item is skipped by the batcher.
            if fut is not None:
                fut.cancel()
            return ServiceError("DEADLINE_EXCEEDED", "batch execution timed out")
        if isinstance(exc, RuntimeError):
            return ServiceError("UNAVAILABLE", str(exc))
        raise exc

    @staticmethod
    def _submit_kw(criticality: str | None = None, prune_k: int = 0) -> dict:
        """A submit's optional arguments: the current span (the transport's
        root span) while tracing is on, so the batcher's threads attach the
        batch phases to it, the request's lane when it has one, and the
        cascade's prune when it is one."""
        kw = {"span": tracing.current_span()} if tracing.enabled() else {}
        if criticality is not None:
            kw["criticality"] = criticality
        if prune_k:
            kw["_prune_k"] = prune_k
        return kw

    def _run(self, servable: Servable, arrays: dict[str, np.ndarray],
             output_keys: tuple[str, ...] | None = None, deadline_s: float | None = None,
             criticality: str | None = None, prune_k: int = 0) -> dict[str, np.ndarray]:
        """One batcher submit and its wait, the error translated. prune_k
        > 0 is the cascade's stage-1 prune (batcher.submit's _prune_k)."""
        timeout = self._effective_timeout(deadline_s)
        fut = None
        try:
            fut = self.batcher.submit(servable, arrays, output_keys=output_keys,
                                      deadline_s=deadline_s,
                                      **self._submit_kw(criticality, prune_k))
            out = fut.result(timeout=timeout)
            self._consume_future_degraded(fut)
            return out
        except Exception as e:  # noqa: BLE001 — the translator re-raises the rest
            raise self._translate_batcher_error(e, fut) from e

    async def _run_async(self, servable: Servable, arrays: dict[str, np.ndarray],
                         output_keys: tuple[str, ...] | None = None,
                         deadline_s: float | None = None,
                         criticality: str | None = None,
                         prune_k: int = 0) -> dict[str, np.ndarray]:
        """_run for coroutine callers (the REST gateway): the batcher's
        Future is awaited, under the same timeout, instead of blocked on."""
        timeout = self._effective_timeout(deadline_s)
        fut = None
        try:
            fut = self.batcher.submit(servable, arrays, output_keys=output_keys,
                                      deadline_s=deadline_s,
                                      **self._submit_kw(criticality, prune_k))
            # wait_for's TimeoutError is concurrent.futures.TimeoutError.
            out = await asyncio.wait_for(asyncio.wrap_future(fut), timeout=timeout)
            self._consume_future_degraded(fut)
            return out
        except Exception as e:  # noqa: BLE001 — the translator re-raises the rest
            raise self._translate_batcher_error(e, fut) from e

    @staticmethod
    def _consume_future_degraded(fut) -> None:
        """A row-tier stale serve marks the future (the batcher's threads
        cannot reach this request's context): forward the mark into the
        calling context, whence the transports send it. One getattr per
        request when nothing is marked."""
        degraded = getattr(fut, "dts_degraded", None)
        if degraded is not None:
            overload_mod.mark_degraded(degraded)

    def _predict_prepare(self, request: apis.PredictRequest, input_crc: str | None = None,
                         criticality: str | None = None):
        """The front half of Predict and PredictStream: resolution (the
        lane reaches the lifecycle plane's router), method check, decode
        and validation, output_filter. Returns (servable, arrays,
        out_names, fetch_keys). `input_crc` (the request's
        x-dts-input-crc) is verified on the decoded arrays, before any fold
        or cast (a bf16 input over the bits it was sent with), so a damaged
        request fails alone, before the batcher."""
        servable, signature = self._resolve(request.model_spec, criticality)
        if signature.method_name != "tensorflow/serving/predict":
            raise ServiceError(
                "INVALID_ARGUMENT",
                f"signature {request.model_spec.signature_name!r} has method "
                f"{signature.method_name!r}; use the matching RPC instead of Predict",
            )
        with request_trace.span("predict.decode"):
            try:
                faults.fire("decode")
            except faults.InjectedFaultError as e:
                raise ServiceError(e.code_name, str(e)) from e
            arrays = self._decode_and_validate(servable, signature, request.inputs)
            integ = self.integrity
            if input_crc is not None and integ is not None and integ.config.wire_checksums:
                # A bf16 input decoded widened: checked over its wire bits.
                bf16 = {k for k in arrays
                        if request.inputs[k].dtype == fw.DataType.DT_BFLOAT16}
                bad = integ.verify_inputs(arrays, input_crc, bf16)
                if bad:
                    raise ServiceError(
                        "INVALID_ARGUMENT",
                        "corrupt-wire: input tensor bytes do not match the request's "
                        f"x-dts-input-crc stamp on {bad} — the payload was damaged in "
                        "transit; resend",
                    )
        sig_outputs = signature.output_names
        if request.output_filter:
            missing = [k for k in request.output_filter if k not in sig_outputs]
            if missing:
                raise ServiceError(
                    "INVALID_ARGUMENT",
                    f"output_filter names unknown tensors {missing}; have {sig_outputs}",
                )
            out_names = list(dict.fromkeys(request.output_filter))
            fetch_keys = tuple(out_names)
        else:
            out_names = sig_outputs
            fetch_keys = None
        return servable, arrays, out_names, fetch_keys

    @staticmethod
    def _check_produced(out_names, outputs) -> None:
        if any(k not in outputs for k in out_names):
            raise ServiceError(
                "INTERNAL",
                f"model produced {sorted(outputs)} but signature declares {out_names}",
            )

    @staticmethod
    def _mirror_content(request) -> bool:
        """Mirror the client's encoding: repeated-field clients read
        float_val, which is empty if the reply uses tensor_content."""
        return any(request.inputs[name].tensor_content for name in request.inputs)

    def _encode_outputs(self, out_names, outputs, dest, mirror: bool) -> None:
        """The one per-tensor encode loop of unary responses and stream
        chunks, so their wire encodings cannot drift. `dest` is the
        message's outputs map. The thread's arena (response_arena) is
        filled and copied into the message within one call: nothing awaits
        in between."""
        arena = self._arena()
        for name in out_names:
            codec.from_ndarray(np.asarray(outputs[name]), use_tensor_content=mirror,
                               out=dest[name], arena=arena)

    def predict(self, request: apis.PredictRequest, deadline_s: float | None = None,
                int8_wire: bool = False, criticality: str | None = None,
                input_crc: str | None = None) -> apis.PredictResponse:
        """Unary Predict. int8_wire (the client opted in and this server's
        kernels plane armed the wire) sends a float32 score output as
        DT_INT8 plus its `/q8_scale` and `/q8_min` sidecar outputs."""
        self._refuse_if_draining()
        deadline_t = self._clock_deadline(deadline_s)
        servable, arrays, out_names, fetch_keys = self._predict_prepare(request, input_crc,
                                                                        criticality)
        casc = self.cascade
        if casc is not None and casc.eligible(servable, fetch_keys,
                                              next(iter(arrays.values())).shape[0]):
            # The ranking cascade: its provenance output rides the response
            # beside the signature's outputs.
            with request_trace.span("predict.execute"):
                outputs = casc.run(self, servable, arrays, fetch_keys, deadline_t, criticality)
            out_names = [*out_names, STAGE_OUTPUT]
        else:
            with request_trace.span("predict.execute"):
                outputs = self._run(servable, arrays, fetch_keys,
                                    self._budget_left(deadline_t), criticality)
        resp = self._predict_finish(request, servable, out_names, outputs, int8_wire)
        # Only a request that succeeded is logged: the log is a warmup file,
        # and a malformed request must never fail a later version's load.
        self._log_request("predict", request)
        return resp

    async def predict_async(self, request: apis.PredictRequest,
                            deadline_s: float | None = None,
                            int8_wire: bool = False, criticality: str | None = None,
                            input_crc: str | None = None) -> apis.PredictResponse:
        """Predict for coroutine callers: the same semantics, awaiting the
        batch instead of blocking a thread on it."""
        self._refuse_if_draining()
        deadline_t = self._clock_deadline(deadline_s)
        servable, arrays, out_names, fetch_keys = self._predict_prepare(request, input_crc,
                                                                        criticality)
        casc = self.cascade
        if casc is not None and casc.eligible(servable, fetch_keys,
                                              next(iter(arrays.values())).shape[0]):
            with request_trace.span("predict.execute"):
                outputs = await casc.run_async(self, servable, arrays, fetch_keys, deadline_t,
                                               criticality)
            out_names = [*out_names, STAGE_OUTPUT]
        else:
            with request_trace.span("predict.execute"):
                outputs = await self._run_async(servable, arrays, fetch_keys,
                                                self._budget_left(deadline_t), criticality)
        resp = self._predict_finish(request, servable, out_names, outputs, int8_wire)
        self._log_request("predict", request)
        return resp

    def _predict_finish(self, request, servable: Servable, out_names, outputs,
                        int8_wire: bool) -> apis.PredictResponse:
        self._check_produced(out_names, outputs)
        with request_trace.span("predict.encode"):
            resp = apis.PredictResponse()
            resp.model_spec.CopyFrom(
                self._echo_spec(servable, request.model_spec.signature_name or "serving_default")
            )
            mirror = self._mirror_content(request)
            names = out_names
            score_key = servable.model.score_output
            if int8_wire and score_key in out_names and outputs[score_key].dtype == np.float32:
                # Another dtype is never quantized: the wire guesses no
                # scheme for a dtype it does not own.
                names = [n for n in out_names if n != score_key]
                q, scale, mn = codec.quantize_scores(outputs[score_key])
                codec.from_ndarray(q, use_tensor_content=mirror, out=resp.outputs[score_key])
                codec.from_ndarray(np.asarray([scale], np.float32), use_tensor_content=mirror,
                                   out=resp.outputs[score_key + codec.Q8_WIRE_SCALE_SUFFIX])
                codec.from_ndarray(np.asarray([mn], np.float32), use_tensor_content=mirror,
                                   out=resp.outputs[score_key + codec.Q8_WIRE_MIN_SUFFIX])
            self._encode_outputs(names, outputs, resp.outputs, mirror)
        return resp

    # --------------------------------------------------------- PredictStream

    def _stream_plan(self, n: int, chunk: int | None) -> list[tuple[int, int]]:
        """[(offset, count)] sub-batch split of an n-candidate request.
        `chunk` (the request's x-dts-stream-chunk) wins over
        stream_chunk_candidates; 0 or absent on both = one chunk. The chunk
        size is raised until the split has at most _STREAM_MAX_CHUNKS."""
        chunk_n = int(chunk) if chunk else int(self.stream_chunk_candidates or 0)
        if chunk_n <= 0 or chunk_n >= n:
            return [(0, n)]
        chunk_n = max(chunk_n, -(-n // self._STREAM_MAX_CHUNKS))
        return [(off, min(chunk_n, n - off)) for off in range(0, n, chunk_n)]

    def _stream_submit(self, request, deadline_t, chunk, criticality=None):
        """Resolve, decode, split, and submit every sub-batch up front, so
        they ride the batcher's pipeline independently. Returns (servable,
        out_names, mirror, total, {future: (offset, count)}). A submit that
        fails cancels the sub-batches already queued."""
        servable, arrays, out_names, fetch_keys = self._predict_prepare(
            request, criticality=criticality)
        total = next(iter(arrays.values())).shape[0]
        plan = self._stream_plan(total, chunk)
        # A split request's sub-batches are solo, so the coalescer never
        # joins them back into the batch they were split from.
        solo = len(plan) > 1
        futs: dict = {}
        try:
            for off, cnt in plan:
                sub = {k: v[off:off + cnt] for k, v in arrays.items()}
                fut = self.batcher.submit(servable, sub, output_keys=fetch_keys,
                                          deadline_s=self._budget_left(deadline_t),
                                          _solo=solo, **self._submit_kw(criticality))
                futs[fut] = (off, cnt)
        except Exception as e:  # noqa: BLE001 — the translator re-raises the rest
            for f in futs:
                f.cancel()
            raise self._translate_batcher_error(e, None) from e
        return servable, out_names, self._mirror_content(request), total, futs

    def _encode_stream_chunk(self, request, servable, out_names, outputs, off: int, cnt: int,
                             total: int, final: bool, mirror: bool,
                             msg=None) -> apis.PredictStreamChunk:
        """One sub-batch's outputs as a PredictStreamChunk (the unary
        response's encode loop). `msg` is the stream's one reused chunk
        (response_arena), cleared and refilled: gRPC serializes a yielded
        message before the generator resumes, sync or coroutine."""
        self._check_produced(out_names, outputs)
        with request_trace.span("predict.encode"):
            if msg is None:
                chunk = apis.PredictStreamChunk()
            else:
                chunk = msg
                chunk.Clear()
            chunk.model_spec.CopyFrom(
                self._echo_spec(servable, request.model_spec.signature_name or "serving_default")
            )
            chunk.offset = int(off)
            chunk.count = int(cnt)
            chunk.total = int(total)
            chunk.final = bool(final)
            self._encode_outputs(out_names, outputs, chunk.outputs, mirror)
        return chunk

    def predict_stream(self, request: apis.PredictRequest, deadline_s: float | None = None,
                       chunk: int | None = None, criticality: str | None = None):
        """Server-streaming Predict: a generator of PredictStreamChunk. The
        request is split into sub-batches (_stream_plan) that ride the
        batcher independently, and each chunk is yielded as its readback
        completes, possibly out of order (chunks carry offset and count;
        exactly one is `final`). Unary Predict's resolution, validation,
        encode and status codes otherwise: a failed sub-batch cancels its
        siblings and aborts the stream with the translated status; a
        deadline that runs out mid-stream aborts with DEADLINE_EXCEEDED. A
        sub-batch served stale marks the whole stream degraded."""
        self._refuse_if_draining()
        deadline_t = self._clock_deadline(deadline_s)
        give_up_t = time.perf_counter() + self._effective_timeout(deadline_s)
        servable, out_names, mirror, total, futs = self._stream_submit(request, deadline_t, chunk,
                                                                       criticality)
        reuse = apis.PredictStreamChunk() if self.response_arena else None
        pending = set(futs)
        emitted = 0
        try:
            while pending:
                left = give_up_t - time.perf_counter()
                if left <= 0:
                    raise ServiceError(
                        "DEADLINE_EXCEEDED",
                        f"deadline expired mid-stream ({emitted}/{len(futs)} sub-batches "
                        "delivered)",
                    )
                done, pending = concurrent.futures.wait(
                    pending, timeout=left, return_when=concurrent.futures.FIRST_COMPLETED)
                for fut in done:
                    try:
                        outputs = fut.result()
                    except Exception as e:  # noqa: BLE001 — the translator re-raises the rest
                        raise self._translate_batcher_error(e, fut) from e
                    self._consume_future_degraded(fut)
                    off, cnt = futs[fut]
                    emitted += 1
                    yield self._encode_stream_chunk(
                        request, servable, out_names, outputs, off, cnt, total,
                        final=emitted == len(futs), mirror=mirror, msg=reuse)
        except BaseException:
            # Failure, deadline or a client gone: withdraw what is queued.
            for f in pending:
                f.cancel()
            raise
        self._log_request("predict", request)

    async def predict_stream_async(self, request: apis.PredictRequest,
                                   deadline_s: float | None = None, chunk: int | None = None,
                                   criticality: str | None = None):
        """predict_stream for coroutine servers: an async generator that
        awaits each sub-batch's completion instead of blocking a thread
        between chunks. The same split, encode, status codes and
        withdrawal."""
        self._refuse_if_draining()
        deadline_t = self._clock_deadline(deadline_s)
        give_up_t = time.perf_counter() + self._effective_timeout(deadline_s)
        servable, out_names, mirror, total, futs = self._stream_submit(request, deadline_t, chunk,
                                                                       criticality)
        reuse = apis.PredictStreamChunk() if self.response_arena else None
        wrapped = {asyncio.wrap_future(f): f for f in futs}
        pending = set(wrapped)
        emitted = 0
        try:
            while pending:
                left = give_up_t - time.perf_counter()
                if left <= 0:
                    raise ServiceError(
                        "DEADLINE_EXCEEDED",
                        f"deadline expired mid-stream ({emitted}/{len(futs)} sub-batches "
                        "delivered)",
                    )
                done, pending = await asyncio.wait(pending, timeout=left,
                                                   return_when=asyncio.FIRST_COMPLETED)
                for task in done:
                    try:
                        outputs = task.result()
                    except Exception as e:  # noqa: BLE001 — the translator re-raises the rest
                        raise self._translate_batcher_error(e, wrapped[task]) from e
                    self._consume_future_degraded(wrapped[task])
                    off, cnt = futs[wrapped[task]]
                    emitted += 1
                    yield self._encode_stream_chunk(
                        request, servable, out_names, outputs, off, cnt, total,
                        final=emitted == len(futs), mirror=mirror, msg=reuse)
        except BaseException:
            for task in pending:
                task.cancel()
            for f in wrapped.values():
                if not f.done():
                    f.cancel()
            raise
        self._log_request("predict", request)

    # ---------------------------------------------------- Classify / Regress

    def _examples_prepare(self, request, criticality: str | None = None
                          ) -> tuple[Servable, dict[str, np.ndarray]]:
        servable, _ = self._resolve(request.model_spec, criticality)
        try:
            arrays = decode_input(request.input, servable.model.config.num_fields,
                                  arena=self._arena())
        except ExampleDecodeError as e:
            raise ServiceError("INVALID_ARGUMENT", str(e)) from e
        return servable, arrays

    def _run_examples(self, request, deadline_s: float | None = None,
                      criticality: str | None = None):
        """Shared front half of Classify/Regress: resolution, Example
        decode and the batcher run. Returns (servable, outputs)."""
        deadline_t = self._clock_deadline(deadline_s)
        servable, arrays = self._examples_prepare(request, criticality)
        outputs = self._run(servable, arrays, (servable.model.score_output,),
                            self._budget_left(deadline_t), criticality)
        return servable, outputs

    async def _run_examples_async(self, request, deadline_s: float | None = None,
                                  criticality: str | None = None):
        """_run_examples for coroutine callers (the REST gateway's
        :classify and :regress)."""
        deadline_t = self._clock_deadline(deadline_s)
        servable, arrays = self._examples_prepare(request, criticality)
        outputs = await self._run_async(servable, arrays, (servable.model.score_output,),
                                        self._budget_left(deadline_t), criticality)
        return servable, outputs

    def classify(self, request: apis.ClassificationRequest, deadline_s: float | None = None,
                 criticality: str | None = None) -> apis.ClassificationResponse:
        """Two classes per Example: "0" scores 1 - p and "1" scores p."""
        self._refuse_if_draining()
        resp = self._classify(request, deadline_s, criticality)
        self._log_request("classify", request)
        return resp

    async def classify_async(self, request: apis.ClassificationRequest,
                             deadline_s: float | None = None,
                             criticality: str | None = None) -> apis.ClassificationResponse:
        self._refuse_if_draining()
        servable, outputs = await self._run_examples_async(request, deadline_s, criticality)
        resp = self._classify_finish(request, servable, outputs)
        self._log_request("classify", request)
        return resp

    def _classify(self, request: apis.ClassificationRequest, deadline_s: float | None,
                  criticality: str | None = None) -> apis.ClassificationResponse:
        servable, outputs = self._run_examples(request, deadline_s, criticality)
        return self._classify_finish(request, servable, outputs)

    def _classify_finish(self, request, servable: Servable,
                         outputs) -> apis.ClassificationResponse:
        resp = apis.ClassificationResponse()
        resp.model_spec.CopyFrom(
            self._echo_spec(servable, request.model_spec.signature_name or "classify")
        )
        for p in outputs[servable.model.score_output]:
            cls = resp.result.classifications.add()
            cls.classes.add(label="0", score=float(1.0 - p))
            cls.classes.add(label="1", score=float(p))
        return resp

    def regress(self, request: apis.RegressionRequest, deadline_s: float | None = None,
                criticality: str | None = None) -> apis.RegressionResponse:
        """One regression value per Example: the score p."""
        self._refuse_if_draining()
        resp = self._regress(request, deadline_s, criticality)
        self._log_request("regress", request)
        return resp

    async def regress_async(self, request: apis.RegressionRequest,
                            deadline_s: float | None = None,
                            criticality: str | None = None) -> apis.RegressionResponse:
        self._refuse_if_draining()
        servable, outputs = await self._run_examples_async(request, deadline_s, criticality)
        resp = self._regress_finish(request, servable, outputs)
        self._log_request("regress", request)
        return resp

    def _regress(self, request: apis.RegressionRequest, deadline_s: float | None,
                 criticality: str | None = None) -> apis.RegressionResponse:
        servable, outputs = self._run_examples(request, deadline_s, criticality)
        return self._regress_finish(request, servable, outputs)

    def _regress_finish(self, request, servable: Servable, outputs) -> apis.RegressionResponse:
        resp = apis.RegressionResponse()
        resp.model_spec.CopyFrom(
            self._echo_spec(servable, request.model_spec.signature_name or "regress")
        )
        for p in outputs[servable.model.score_output]:
            resp.result.regressions.add(value=float(p))
        return resp

    # --------------------------------------------------------- MultiInference

    def multi_inference(self, request: apis.MultiInferenceRequest,
                        deadline_s: float | None = None,
                        criticality: str | None = None) -> apis.MultiInferenceResponse:
        """Classify and regress tasks over one shared Input, in order (the
        request is logged once, as a MultiInference)."""
        self._refuse_if_draining()
        if not request.tasks:
            raise ServiceError("INVALID_ARGUMENT", "MultiInferenceRequest has no tasks")
        # Tasks run one after another, so each gets the budget REMAINING at
        # its own start, never the whole entry-time budget again.
        deadline_t = self._clock_deadline(deadline_s)

        def remaining() -> float | None:
            left = self._budget_left(deadline_t)
            if left is not None and left <= 0:
                raise ServiceError(
                    "DEADLINE_EXCEEDED",
                    "client deadline expired between MultiInference tasks",
                )
            return left

        resp = apis.MultiInferenceResponse()
        for task in request.tasks:
            method = task.method_name
            if method == "tensorflow/serving/classify":
                sub = apis.ClassificationRequest(model_spec=task.model_spec, input=request.input)
                out = self._classify(sub, deadline_s=remaining(), criticality=criticality)
                r = resp.results.add()
                r.model_spec.CopyFrom(out.model_spec)
                r.classification_result.CopyFrom(out.result)
            elif method == "tensorflow/serving/regress":
                sub = apis.RegressionRequest(model_spec=task.model_spec, input=request.input)
                out = self._regress(sub, deadline_s=remaining(), criticality=criticality)
                r = resp.results.add()
                r.model_spec.CopyFrom(out.model_spec)
                r.regression_result.CopyFrom(out.result)
            else:
                raise ServiceError(
                    "INVALID_ARGUMENT",
                    f"unsupported MultiInference method {method!r} "
                    "(expected tensorflow/serving/classify or .../regress)",
                )
        self._log_request("multi_inference", request)
        return resp

    # ------------------------------------------------------ status / metadata

    def get_model_status(self, request: apis.GetModelStatusRequest) -> apis.GetModelStatusResponse:
        """Version states for readiness probes: loaded versions are
        AVAILABLE (the registry flips after load + warmup). A model a
        version watcher owns whose first version has not landed yet is
        START; names this server was never told about are NOT_FOUND."""
        name = request.model_spec.name
        if not name:
            raise ServiceError("INVALID_ARGUMENT", "model_spec.name is required")
        loaded = self.registry.models().get(name)
        if not loaded:
            if not self.is_configured(name):
                raise ServiceError("NOT_FOUND", f"model {name!r} not found")
            version, _ = self._version_choice(request.model_spec)
            resp = apis.GetModelStatusResponse()
            st = resp.model_version_status.add()
            st.version = version or 0  # no version directory discovered yet
            st.state = apis.ModelVersionStatus.START
            st.status.error_code = 0
            return resp
        version, label = self._version_choice(request.model_spec)
        if label is not None:
            servable = _wrap_lookup(lambda: self.registry.resolve(name, None, label))
            loaded = [servable.version]
        elif version is not None:
            if version not in loaded:
                raise ServiceError(
                    "NOT_FOUND", f"model {name!r} has no version {version}; have {loaded}"
                )
            loaded = [version]
        resp = apis.GetModelStatusResponse()
        for v in sorted(loaded):
            st = resp.model_version_status.add()
            st.version = v
            st.state = apis.ModelVersionStatus.AVAILABLE
            st.status.error_code = 0
        return resp

    def handle_reload_config(self, request: apis.ReloadConfigRequest) -> apis.ReloadConfigResponse:
        """tensorflow.serving.ModelService/HandleReloadConfigRequest.

        - Multi-model mode (a --model-config-file server, `model_lifecycle`
          set): the supplied model_config_list replaces the served set, as
          upstream — new entries start a watcher, absent ones stop and
          unload, a moved base_path or platform restarts its model, and
          unchanged ones get the supplied version_labels. The entries pass
          the startup checks; an empty list (it would unload everything)
          is INVALID_ARGUMENT.
        - Single-model modes: the version_labels maps only (the blue-green
          flip). Each named model's map is its declarative label state. A
          config may restate the served source but not move it
          (FAILED_PRECONDITION); a model not served is NOT_FOUND. The maps
          are checked and applied under one registry lock
          (replace_label_maps), so a failed reload applies nothing.

        A label that names an unloaded version is FAILED_PRECONDITION in
        both modes; custom_model_config is INVALID_ARGUMENT."""
        cfg = request.config
        if cfg.WhichOneof("config") != "model_config_list":
            raise ServiceError(
                "INVALID_ARGUMENT",
                "only model_config_list reloads are supported "
                "(custom_model_config has no meaning here)",
            )
        if self.model_lifecycle is not None:
            from ..utils.config import validate_model_config_entries

            try:
                entries = validate_model_config_entries(cfg.model_config_list.config,
                                                        "reload config")
            except ValueError as e:
                raise ServiceError("INVALID_ARGUMENT", str(e)) from e
            if not entries:
                raise ServiceError(
                    "INVALID_ARGUMENT",
                    "refusing an empty model_config_list (it would unload every model; "
                    "unload explicitly per model instead)",
                )
            try:
                self.model_lifecycle.apply(entries)
            except ValueError as e:
                raise ServiceError("INVALID_ARGUMENT", str(e)) from e
            except (ModelNotFoundError, VersionNotFoundError) as e:
                raise ServiceError("FAILED_PRECONDITION", str(e)) from e
            resp = apis.ReloadConfigResponse()
            resp.status.error_code = 0
            return resp
        maps: dict[str, dict[str, int]] = {}
        served = self.registry.models()
        for mc in cfg.model_config_list.config:
            if not mc.name:
                raise ServiceError("INVALID_ARGUMENT", "model config missing name")
            if mc.base_path or mc.model_platform:
                # A deploy tool may replay its whole config to flip a label;
                # an actual move of the source cannot be applied here.
                src = self.served_sources.get(mc.name)
                moved = (
                    src is None
                    or (mc.base_path and mc.base_path != src[0])
                    or (mc.model_platform and mc.model_platform not in ("tensorflow", src[1]))
                )
                if moved:
                    raise ServiceError(
                        "FAILED_PRECONDITION",
                        f"model {mc.name!r}: this server was started in single-model mode "
                        "and cannot apply base_path/model_platform changes; model-list "
                        "reloads require --model-config-file (a config restating the "
                        "current source is accepted for label retargeting)",
                    )
            if not served.get(mc.name):
                raise ServiceError(
                    "NOT_FOUND",
                    f"model {mc.name!r} is not served here; reload applies version_labels "
                    "to already-served models (model-list lifecycle rides the "
                    "--model-base-path watcher)",
                )
            maps[mc.name] = {label: int(v) for label, v in mc.version_labels.items()}
        try:
            self.registry.replace_label_maps(maps)
        except ValueError as e:
            raise ServiceError("INVALID_ARGUMENT", str(e)) from e
        except (ModelNotFoundError, VersionNotFoundError) as e:
            raise ServiceError("FAILED_PRECONDITION", str(e)) from e
        resp = apis.ReloadConfigResponse()
        resp.status.error_code = 0
        return resp

    def get_model_metadata(
        self, request: apis.GetModelMetadataRequest
    ) -> apis.GetModelMetadataResponse:
        fields = list(request.metadata_field) or [SIGNATURE_DEF_FIELD]
        unknown = [f for f in fields if f != SIGNATURE_DEF_FIELD]
        if unknown:
            raise ServiceError("INVALID_ARGUMENT", f"unsupported metadata_field values {unknown}")
        if not request.model_spec.name:
            raise ServiceError("INVALID_ARGUMENT", "model_spec.name is required")
        version, label = self._version_choice(request.model_spec)
        servable = _wrap_lookup(
            lambda: self.registry.resolve(request.model_spec.name, version, label)
        )
        resp = apis.GetModelMetadataResponse()
        resp.model_spec.CopyFrom(self._echo_spec(servable, ""))
        resp.model_spec.ClearField("signature_name")
        sig_map = apis.SignatureDefMap()
        for name, sd in servable.signature_def_map().items():
            sig_map.signature_def[name].CopyFrom(sd)
        resp.metadata[SIGNATURE_DEF_FIELD].Pack(sig_map)
        return resp
