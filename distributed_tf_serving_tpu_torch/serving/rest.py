"""TF-Serving-compatible REST gateway (the :8501 surface), on aiohttp.

`tensorflow_model_server` serves every model on two ports: gRPC and a JSON
REST API with the `/v1/models/...` routes. This gateway answers the same
routes and JSON as the JAX package's (`serving/rest.py` there), over this
package's PredictionServiceImpl:

- `POST /v1/models/{model}[/versions/{v}|/labels/{l}]:predict`
  body `{"instances": [...]}` (row format: one object per instance, or the
  bare value for single-input signatures) -> `{"predictions": [...]}`;
  body `{"inputs": {...}}` (columnar) -> `{"outputs": ...}` (an object
  when the signature has several outputs, the bare tensor when one);
  optional `"signature_name"`.
- `POST /v1/models/{model}[/versions/{v}|/labels/{l}]:classify` and
  `...:regress`, body `{"examples": [{feat: val, ...}, ...], "context":
  {...}?}` -> `{"results": [...]}` (per example the [label, score] pairs
  for classify, one value for regress), through the gRPC RPCs' Example
  decoding.
- `GET /v1/models/{model}[/versions/{v}|/labels/{l}]` -> version status;
  `.../metadata` -> signature metadata.
- `GET /monitoring/prometheus/metrics` -> Prometheus text (TF-Serving's
  metric names); `GET /monitoring[?section=NAME]` -> the same data as JSON
  with the phase means and one block per plane; `GET
  /tracez[?format=chrome][&limit=N]` -> the retained span trees, or a
  Chrome-trace-event export; `GET /tracez/export?since=N` -> the kept span
  trees after a cursor.
- `GET /cachez` -> the score cache's counters with a `row_cache` block
  (`{"enabled": false}` with the plane off); `POST /cachez/flush[?model=]`
  -> drops every cached score (or one model's) in both stores,
  FAILED_PRECONDITION (500) with no store armed.
- `GET /cascadez` -> the ranking cascade's counters (serving/cascade.py;
  `{"enabled": false}` with the plane off).
- `GET /integrityz` -> the integrity plane's counters, suspect verdict and
  events (`{"enabled": false}` with the plane off); `POST
  /integrityz/audit[?batches=N]` -> the next N batches are shadowed
  whatever shadow_fraction says (404 with the plane off).
- The overload plane: a request's lane rides the `x-dts-criticality`
  header; a refusal answers 429 with `Retry-After` (whole seconds, rounded
  up) and `retry-after-ms`; an answer served stale carries
  `X-DTS-Degraded`.
- `GET /utilz[?window=S]` -> the occupancy ledger's counters, idle gaps
  by cause, the windowed gap waterfall (its components sum to the window's
  wall time) and achieved_fraction_of_device_limit (serving/utilization.py;
  `{"enabled": false}` with the plane off). `GET /profilez` -> whether a
  deep capture runs; `POST /profilez/start?seconds=N` -> a torch.profiler
  trace and a host-stack sample over the next N seconds, into the artifact
  dir it answers (409 while one runs), with or without the ledger.
- `GET /qualityz[?model=M][&version=V]` -> the score sketches, drift, the
  label join's AUC and calibration (serving/quality.py; `{"enabled":
  false}` with the plane off); `POST /qualityz/snapshot` pins the current
  distributions as the drift reference; `POST /labelz` joins labels by
  trace id or row digest. Both FAILED_PRECONDITION (500) with the plane
  off.
- `GET /lifecyclez` -> the lifecycle controller's state machine, canary
  routing share and counters, events and the watcher's blacklist / pins
  (serving/lifecycle.py; `{"enabled": false}` with the plane off); `POST
  /lifecyclez/rollback` rolls the live canary back now (409 with no
  canary, 404 with the plane off).
- `GET /recoveryz` -> the recovery controller's state machine, its
  quarantine / reinit / replay / bisection counters, the last cycle (its
  `context_lost` once the probe found the CUDA context dead), the MTTR
  history and events (serving/recovery.py; `{"enabled": false}` with the
  plane off).
- `GET /fleetz` -> this member's fleet view: every gossip record it
  knows, the exchange counters and the rollout follower's state
  (fleet/replica.py; `{"enabled": false}` with the plane off).
- `GET /meshz` -> the mesh serving mode: geometry and device list, the
  executor's batch / pad counters, the layout source per served model,
  per-device occupancy when the utilization ledger rides along, and with
  [elastic] the `elastic` block (current split, ladder, switch history,
  per-split counters, controller state) (parallel/executor.py and
  elastic.py; `{"enabled": false}` when serving is single-device).

A request becomes the same PredictRequest (or Classification /
RegressionRequest) the gRPC path parses and is handed to the impl's
`*_async` entry points: one implementation of resolution, validation,
batching and status codes; the gateway translates JSON to tensors and
ServiceError codes to HTTP statuses, with TF-Serving's error body
`{"error": "..."}`.
"""

from __future__ import annotations

import base64
import json
import logging
import time

import numpy as np
from aiohttp import web

from .. import codec
from ..proto import serving_apis_pb2 as apis
from ..proto import tf_example_pb2 as ex
from ..proto import tf_framework_pb2 as fw
from ..utils import tracing
from ..utils.metrics import ServerMetrics
from ..utils.tracing import request_trace
from . import lifecycle as lifecycle_mod
from . import overload as overload_mod
from .service import PredictionServiceImpl, ServiceError, _wrap_lookup
from .utilization import CaptureInProgressError, profiler_capture

log = logging.getLogger("dts_torch.rest")

_HTTP_STATUS = {
    "NOT_FOUND": 404,
    "INVALID_ARGUMENT": 400,
    "RESOURCE_EXHAUSTED": 429,
    "UNAVAILABLE": 503,
    "DEADLINE_EXCEEDED": 504,
    "INTERNAL": 500,
}

_OFF = {"enabled": False}


def _json_error(code: str, message: str, retry_after_ms: int | None = None) -> web.Response:
    resp = web.json_response({"error": message}, status=_HTTP_STATUS.get(code, 500))
    if retry_after_ms:
        # Overload pushback: the standard header in whole seconds (rounded
        # up: a 25 ms hint must not read as "now") and the precise hint.
        resp.headers["Retry-After"] = str(max((retry_after_ms + 999) // 1000, 1))
        resp.headers[overload_mod.RETRY_AFTER_KEY] = str(int(retry_after_ms))
    return resp


def _criticality_of(request: web.Request) -> str | None:
    """The request's lane from the x-dts-criticality header, read only
    while an overload or a lifecycle controller is armed."""
    if not (overload_mod.active() or lifecycle_mod.active()):
        return None
    value = request.headers.get(overload_mod.CRITICALITY_KEY)
    return overload_mod.normalize_criticality(value) if value else None


def _mark_degraded(resp: web.Response) -> web.Response:
    """An answer served stale carries X-DTS-Degraded (the gRPC trailing
    mark's twin; the contextvar is the handler task's own)."""
    if overload_mod.active():
        degraded = overload_mod.consume_degraded()
        if degraded:
            resp.headers[overload_mod.DEGRADED_KEY] = degraded
    return resp


def _dumps(obj) -> str:
    return json.dumps(obj, default=str)


class RestGateway:
    """aiohttp application exposing a PredictionServiceImpl over REST.
    Every :predict / :classify / :regress is observed into `metrics` under
    `REST.<Verb>` (the CLI passes the gRPC server's ServerMetrics, so both
    surfaces count in one place), inside a `server.REST.<Verb>` root span
    taken from the `traceparent` header while tracing is on."""

    def __init__(self, impl: PredictionServiceImpl, metrics: ServerMetrics | None = None):
        self.impl = impl
        self.metrics = metrics or ServerMetrics()
        self.app = web.Application(client_max_size=256 * 1024 * 1024)
        routes = []
        for verb, handler in (("predict", self.predict), ("classify", self.classify),
                              ("regress", self.regress)):
            routes += [
                web.post(f"/v1/models/{{model}}:{verb}", handler),
                web.post(f"/v1/models/{{model}}/versions/{{version}}:{verb}", handler),
                web.post(f"/v1/models/{{model}}/labels/{{label}}:{verb}", handler),
            ]
        routes += [
            web.get("/v1/models/{model}", self.status),
            web.get("/v1/models/{model}/versions/{version}", self.status),
            web.get("/v1/models/{model}/labels/{label}", self.status),
            web.get("/v1/models/{model}/metadata", self.metadata),
            web.get("/v1/models/{model}/versions/{version}/metadata", self.metadata),
            web.get("/v1/models/{model}/labels/{label}/metadata", self.metadata),
            web.get("/monitoring/prometheus/metrics", self.prometheus),
            web.get("/monitoring", self.monitoring),
            web.get("/tracez", self.tracez),
            web.get("/tracez/export", self.tracez_export),
            web.get("/cachez", self.cachez),
            web.post("/cachez/flush", self.cachez_flush),
            web.get("/utilz", self.utilz),
            web.get("/profilez", self.profilez_status),
            web.post("/profilez/start", self.profilez_start),
            web.get("/qualityz", self.qualityz),
            web.post("/qualityz/snapshot", self.qualityz_snapshot),
            web.post("/labelz", self.labelz),
            web.get("/lifecyclez", self.lifecyclez),
            web.post("/lifecyclez/rollback", self.lifecyclez_rollback),
            web.get("/fleetz", self.fleetz),
            web.get("/recoveryz", self.recoveryz),
            web.get("/meshz", self.meshz),
            web.get("/cascadez", self.cascadez),
            web.get("/integrityz", self.integrityz),
            web.post("/integrityz/audit", self.integrityz_audit),
        ]
        self.app.add_routes(routes)

    # ------------------------------------------------------------- helpers

    def _resolve_specs(self, model: str, version, signature_name: str, label=None,
                       criticality=None):
        # The gateway pins the concrete version it resolves here into the
        # request it hands the impl, so the canary router must have its say
        # here, or REST traffic would never reach a canary.
        servable = self.impl.resolve_servable(model, version, label, criticality)
        sig = _wrap_lookup(lambda: servable.signature(signature_name))
        return servable, sig

    @staticmethod
    def _parse_version(raw) -> int | None:
        if raw is None:
            return None
        try:
            return int(raw)
        except ValueError as e:
            # A non-numeric /versions/{v} segment is the client's error
            # (labels ride /labels/{l}).
            raise ServiceError(
                "INVALID_ARGUMENT", f"version must be an integer, got {raw!r}"
            ) from e

    @staticmethod
    def _fill_model_spec(spec, model: str, version: int | None, label) -> None:
        """Route segments -> ModelSpec, for all three POST verbs (version and
        label come from distinct routes, so they never both arrive here)."""
        spec.name = model
        if version is not None:
            spec.version.value = version
        if label:
            spec.version_label = label

    @staticmethod
    def _arrays_from_instances(instances, sig) -> dict[str, np.ndarray]:
        if not isinstance(instances, list) or not instances:
            raise ServiceError("INVALID_ARGUMENT", "instances must be a non-empty list")
        specs = sig.input_specs
        if isinstance(instances[0], dict):
            columns: dict[str, list] = {}
            for i, inst in enumerate(instances):
                if not isinstance(inst, dict):
                    raise ServiceError(
                        "INVALID_ARGUMENT",
                        f"instance {i} is not an object (mixed row formats)",
                    )
                for k, v in inst.items():
                    columns.setdefault(k, []).append(v)
            if any(len(v) != len(instances) for v in columns.values()):
                raise ServiceError(
                    "INVALID_ARGUMENT", "every instance must carry the same input names"
                )
        else:
            # Bare values: single-input signatures only (the TF-Serving rule).
            if len(specs) != 1:
                raise ServiceError(
                    "INVALID_ARGUMENT",
                    "bare-value instances require a single-input signature; "
                    f"this one expects {sorted(specs)}",
                )
            columns = {next(iter(specs)): instances}
        return RestGateway._to_ndarrays(columns, specs)

    @staticmethod
    def _to_ndarrays(columns: dict, specs) -> dict[str, np.ndarray]:
        arrays = {}
        for name, vals in columns.items():
            spec = specs.get(name)
            np_dtype = codec.dtype_to_numpy(spec.dtype) if spec else None
            try:
                arrays[name] = np.asarray(vals, dtype=np_dtype)
            except (TypeError, ValueError, OverflowError) as e:
                raise ServiceError("INVALID_ARGUMENT", f"input {name!r}: {e}") from e
        return arrays

    # -------------------------------------------------------------- routes

    async def _observed(self, name: str, handler, request) -> web.Response:
        t0 = time.perf_counter()
        if overload_mod.active():
            # aiohttp reuses one task per keep-alive connection: drop a mark
            # a failed earlier request left (marks are consumed on success).
            overload_mod.consume_degraded()
        model = request.match_info.get("model")
        if tracing.enabled():
            # The REST surface's root span adopts the caller's trace through
            # the standard W3C `traceparent` header.
            with tracing.start_root(
                f"server.{name}",
                traceparent=request.headers.get("traceparent"),
                attrs={"entrypoint": name, **({"model": model} if model else {})},
            ) as span:
                resp = await handler(request)
                # None when disable() raced this request.
                if span is not None and resp.status >= 400:
                    span.status = "ERROR"
                    span.attrs["http_status"] = resp.status
        else:
            resp = await handler(request)
        self.metrics.observe(name, time.perf_counter() - t0, resp.status < 400, model=model)
        return resp

    async def predict(self, request: web.Request) -> web.Response:
        return await self._observed("REST.Predict", self._predict, request)

    async def _predict(self, request: web.Request) -> web.Response:
        model = request.match_info["model"]
        try:
            version = self._parse_version(request.match_info.get("version"))
            label = request.match_info.get("label")
            try:
                body = await request.json()
            except Exception as e:  # noqa: BLE001 — malformed JSON is a 400
                return _json_error("INVALID_ARGUMENT", f"invalid JSON body: {e}")
            if not isinstance(body, dict):
                return _json_error("INVALID_ARGUMENT", "body must be a JSON object")
            signature_name = body.get("signature_name", "")
            row_format = "instances" in body
            if row_format == ("inputs" in body):
                return _json_error(
                    "INVALID_ARGUMENT",
                    'body must carry exactly one of "instances" or "inputs"',
                )
            servable, sig = self._resolve_specs(model, version, signature_name, label,
                                                criticality=_criticality_of(request))
            if row_format:
                arrays = self._arrays_from_instances(body["instances"], sig)
            else:
                cols = body["inputs"]
                if not isinstance(cols, dict):
                    # A bare columnar tensor: single-input shorthand.
                    specs = sig.input_specs
                    if len(specs) != 1:
                        return _json_error(
                            "INVALID_ARGUMENT", "bare inputs require a single-input signature"
                        )
                    cols = {next(iter(specs)): cols}
                arrays = self._to_ndarrays(cols, sig.input_specs)

            # The proto the gRPC surface parses, pinned to the CONCRETE
            # version resolved above: re-sending the label would let the
            # impl resolve again, and a retarget between here and the
            # execute would pair one version's signature with another's run.
            req = apis.PredictRequest()
            self._fill_model_spec(req.model_spec, model, servable.version, None)
            req.model_spec.signature_name = signature_name
            for key, arr in arrays.items():
                codec.from_ndarray(arr, use_tensor_content=True, out=req.inputs[key])
            resp = await self.impl.predict_async(req, criticality=_criticality_of(request))
            outputs = {k: codec.to_ndarray(v).tolist() for k, v in resp.outputs.items()}
            if row_format:
                names = list(outputs)
                if len(names) == 1:
                    predictions = outputs[names[0]]
                else:
                    n = len(next(iter(outputs.values())))
                    predictions = [{k: outputs[k][i] for k in names} for i in range(n)]
                return _mark_degraded(web.json_response({"predictions": predictions}))
            if len(outputs) == 1:
                return _mark_degraded(web.json_response({"outputs": next(iter(outputs.values()))}))
            return _mark_degraded(web.json_response({"outputs": outputs}))
        except ServiceError as e:
            return _json_error(e.code, str(e), retry_after_ms=e.retry_after_ms)
        except Exception as e:  # noqa: BLE001 — surface as 500, keep serving
            log.exception("internal error serving REST predict")
            return _json_error("INTERNAL", f"internal error: {e}")

    # ------------------------------------------------- classify / regress

    @staticmethod
    def _feature_from_json(key: str, value, feature) -> None:
        """One tf.Example Feature from a JSON value (TF-Serving's REST
        Example encoding: a scalar or a flat list; ints -> int64_list, floats
        -> float_list with ints coerced, strings -> bytes_list, `{"b64":
        ...}` objects for binary)."""
        vals = value if isinstance(value, list) else [value]
        if not vals:
            raise ServiceError("INVALID_ARGUMENT", f"feature {key!r}: empty value list")
        if any(isinstance(v, float) for v in vals):
            try:
                feature.float_list.value.extend(float(v) for v in vals)
            except (TypeError, ValueError) as e:
                raise ServiceError("INVALID_ARGUMENT", f"feature {key!r}: {e}") from e
        elif all(isinstance(v, bool) is False and isinstance(v, int) for v in vals):
            try:
                feature.int64_list.value.extend(vals)
            except ValueError as e:  # out of int64 range is the client's error
                raise ServiceError("INVALID_ARGUMENT", f"feature {key!r}: {e}") from e
        elif all(isinstance(v, str) for v in vals):
            feature.bytes_list.value.extend(v.encode("utf-8") for v in vals)
        elif all(isinstance(v, dict) and set(v) == {"b64"} for v in vals):
            try:
                feature.bytes_list.value.extend(base64.b64decode(v["b64"]) for v in vals)
            except Exception as e:  # noqa: BLE001 — bad base64 is a 400
                raise ServiceError(
                    "INVALID_ARGUMENT", f"feature {key!r}: invalid base64: {e}"
                ) from e
        else:
            raise ServiceError(
                "INVALID_ARGUMENT",
                f"feature {key!r}: values must be all-int, all-float "
                "(ints coerce), all-string, or all-b64 objects",
            )

    def _example_from_json(self, obj, index: int):
        if not isinstance(obj, dict):
            raise ServiceError("INVALID_ARGUMENT", f"example {index} is not a JSON object")
        example = ex.Example()
        for key, value in obj.items():
            self._feature_from_json(key, value, example.features.feature[key])
        return example

    def _build_example_request(self, request: web.Request, req, body: dict) -> None:
        """A :classify / :regress body -> the request's model_spec and Input
        (examples, and the context when given)."""
        model = request.match_info["model"]
        version = self._parse_version(request.match_info.get("version"))
        self._fill_model_spec(req.model_spec, model, version, request.match_info.get("label"))
        req.model_spec.signature_name = body.get("signature_name", "")
        examples = body.get("examples")
        if not isinstance(examples, list) or not examples:
            raise ServiceError(
                "INVALID_ARGUMENT", 'body must carry a non-empty "examples" list'
            )
        context = body.get("context")
        if context is not None:
            target = req.input.example_list_with_context
            target.context.CopyFrom(self._example_from_json(context, -1))
            dest = target.examples
        else:
            dest = req.input.example_list.examples
        for i, obj in enumerate(examples):
            dest.append(self._example_from_json(obj, i))

    async def _example_route(self, request: web.Request, kind: str) -> web.Response:
        try:
            try:
                body = await request.json()
            except Exception as e:  # noqa: BLE001 — malformed JSON is a 400
                return _json_error("INVALID_ARGUMENT", f"invalid JSON body: {e}")
            if not isinstance(body, dict):
                return _json_error("INVALID_ARGUMENT", "body must be a JSON object")
            if kind == "classify":
                req = apis.ClassificationRequest()
                self._build_example_request(request, req, body)
                resp = await self.impl.classify_async(req, criticality=_criticality_of(request))
                # TF-Serving's REST shape: per example its [[label, score],
                # ...] list, in order.
                results = [
                    [[c.label, c.score] for c in cls.classes]
                    for cls in resp.result.classifications
                ]
            else:
                req = apis.RegressionRequest()
                self._build_example_request(request, req, body)
                resp = await self.impl.regress_async(req, criticality=_criticality_of(request))
                results = [r.value for r in resp.result.regressions]
            return _mark_degraded(web.json_response({"results": results}))
        except ServiceError as e:
            return _json_error(e.code, str(e), retry_after_ms=e.retry_after_ms)
        except Exception as e:  # noqa: BLE001 — surface as 500, keep serving
            log.exception("internal error serving REST %s", kind)
            return _json_error("INTERNAL", f"internal error: {e}")

    async def classify(self, request: web.Request) -> web.Response:
        return await self._observed(
            "REST.Classify", lambda r: self._example_route(r, "classify"), request)

    async def regress(self, request: web.Request) -> web.Response:
        return await self._observed(
            "REST.Regress", lambda r: self._example_route(r, "regress"), request)

    # ----------------------------------------------------------- telemetry

    async def prometheus(self, request: web.Request) -> web.Response:
        # One snapshot of each, shared: mesh_stats lifts its per-device
        # attribution from the utilization snapshot, elastic_stats its block
        # from the mesh snapshot.
        utilization = self.impl.utilization_stats()
        mesh = self.impl.mesh_stats(utilization=utilization)
        return web.Response(
            body=self.metrics.prometheus_text(
                self.impl.batcher.stats,
                cache=self.impl.cache_stats(),
                row_cache=self.impl.row_cache_stats(),
                overload=self.impl.overload_stats(),
                utilization=utilization,
                mesh=mesh,
                elastic=self.impl.elastic_stats(mesh=mesh),
                quality=self.impl.quality_stats(),
                lifecycle=self.impl.lifecycle_stats(),
                recovery=self.impl.recovery_stats(),
                pipeline=self.impl.pipeline_stats(),
                kernels=self.impl.kernels_stats(),
                integrity=self.impl.integrity_stats(),
                cascade=self.impl.cascade_stats(),
                fleet=self.impl.fleet_stats(),
            ).encode("utf-8"),
            headers={"Content-Type": "text/plain; version=0.0.4; charset=utf-8"},
        )

    def _monitoring_builders(self) -> dict:
        """One builder per /monitoring block, so ?section=NAME builds only
        that block. The JAX gateway's section names; a plane that is off
        answers None."""

        def request_log():
            logger = self.impl.request_logger
            return logger.stats() if logger is not None else None

        impl = self.impl
        return {
            "metrics": lambda: self.metrics.snapshot(impl.batcher.stats),
            "phases": request_trace.snapshot,
            "tracing": lambda: {
                "enabled": tracing.enabled(),
                "recorded": tracing.recorder().recorded,
            },
            "cache": impl.cache_stats,
            "row_cache": impl.row_cache_stats,
            "overload": impl.overload_stats,
            "utilization": impl.utilization_stats,
            "quality": impl.quality_stats,
            "lifecycle": impl.lifecycle_stats,
            "recovery": impl.recovery_stats,
            "kernels": impl.kernels_stats,
            "mesh": impl.mesh_stats,
            "elastic": impl.elastic_stats,
            "fleet": impl.fleet_stats,
            "cascade": impl.cascade_stats,
            "integrity": impl.integrity_stats,
            "versions": impl.versions_stats,
            "pipeline": impl.pipeline_stats,
            "request_log": request_log,
            "draining": lambda: bool(impl.draining),
        }

    async def monitoring(self, request: web.Request) -> web.Response:
        """GET /monitoring[?section=NAME]: the metrics snapshot as JSON
        (rolling-window qps and percentiles beside the lifetime values,
        per-model blocks, batcher gauges), the phase means, and one block
        per plane that is on (a plane that is off is absent).
        ?section=NAME answers that block alone (null for a plane that is
        off); an unknown name is a 400."""
        builders = self._monitoring_builders()
        section = request.query.get("section")
        if section is not None:
            builder = builders.get(section)
            if builder is None:
                return _json_error(
                    "INVALID_ARGUMENT", f"unknown section {section!r}; have {sorted(builders)}"
                )
            return web.json_response({section: builder()})
        snap = builders["metrics"]()
        snap["phases"] = builders["phases"]()
        snap["tracing"] = builders["tracing"]()
        for name in ("cache", "row_cache", "overload", "utilization", "quality", "lifecycle",
                     "recovery", "kernels", "mesh", "elastic", "fleet", "cascade", "integrity",
                     "versions", "pipeline"):
            block = builders[name]()
            if block is not None:
                snap[name] = block
        snap["draining"] = builders["draining"]()
        log_block = builders["request_log"]()
        if log_block is not None:
            snap["request_log"] = log_block
        return web.json_response(snap)

    async def tracez(self, request: web.Request) -> web.Response:
        """GET /tracez: recent and slowest retained span trees as JSON;
        ?format=chrome answers Chrome-trace-event JSON; ?limit=N bounds the
        trace list."""
        rec = tracing.recorder()
        if request.query.get("format") == "chrome":
            return web.json_response(rec.chrome_trace(), dumps=_dumps)
        try:
            limit = int(request.query.get("limit", "50"))
        except ValueError:
            return _json_error("INVALID_ARGUMENT", "limit must be an integer")
        body = rec.tracez(limit=limit)
        body["enabled"] = tracing.enabled()
        return web.json_response(body, dumps=_dumps)

    async def tracez_export(self, request: web.Request) -> web.Response:
        """GET /tracez/export?since=CURSOR: the kept span trees after the
        cursor, with this process's clock anchor. `{"enabled": false}`
        while tracing is off."""
        if not tracing.enabled():
            return web.json_response({"enabled": False, "cursor": 0, "spans": []})
        try:
            since = int(request.query.get("since", "0") or 0)
        except ValueError:
            return _json_error("INVALID_ARGUMENT", "since must be an integer")
        return web.json_response(tracing.recorder().export_since(since), dumps=_dumps)

    # ------------------------------------------------------------- planes

    async def fleetz(self, request: web.Request) -> web.Response:
        """GET /fleetz: this member's fleet view — gossip membership (every
        known replica and router record with its state, pressure, versions
        and canary fields), exchange and record-disposition counters, and
        the rollout follower's state; `{"enabled": false}` with the plane
        off."""
        plane = self.impl.fleet
        if plane is None:
            return web.json_response(_OFF)
        return web.json_response({"enabled": True, **plane.snapshot()}, dumps=_dumps)

    async def lifecyclez(self, request: web.Request) -> web.Response:
        """GET /lifecyclez: the IDLE / CANARY / PROMOTING / ROLLED_BACK state
        machine, the stable and canary versions and the live routing share,
        the publish / promote / rollback counters and transition history,
        the last rollback's evidence (pair PSI / JS, AUC) and the version
        watcher's loaded / on-disk / blacklisted / pinned sets;
        `{"enabled": false}` with the plane off."""
        stats = self.impl.lifecycle_stats()
        return web.json_response(stats if stats is not None else _OFF)

    async def lifecyclez_rollback(self, request: web.Request) -> web.Response:
        """POST /lifecyclez/rollback: demote the live canary now, through the
        path the drift / AUC gate takes (retire + blacklist, traffic back on
        stable). Body (optional JSON): {"reason": "..."}. 409 with no canary
        live; 404 and `{"enabled": false}` with the plane off."""
        lifecycle = self.impl.lifecycle
        if lifecycle is None:
            return web.json_response(_OFF, status=404)
        reason = "operator"
        try:
            body = await request.json()
            if isinstance(body, dict) and body.get("reason"):
                reason = str(body["reason"])
        except Exception:  # noqa: BLE001 — an empty body is fine
            pass
        rolled = lifecycle.force_rollback(reason)
        return web.json_response(
            {"rolled_back": rolled, "reason": reason, "lifecycle": self.impl.lifecycle_stats()},
            status=200 if rolled else 409,
        )

    async def recoveryz(self, request: web.Request) -> web.Response:
        """GET /recoveryz: the SERVING / QUARANTINED / REINIT / REPLAY state
        machine, quarantine / reinit / replay / bisection counters, the last
        cycle's trigger and duration (MTTR), the MTTR history and the
        events; `{"enabled": false}` with the plane off."""
        stats = self.impl.recovery_stats()
        return web.json_response(stats if stats is not None else _OFF)

    async def meshz(self, request: web.Request) -> web.Response:
        """GET /meshz: mesh geometry and devices, executor batch / pad
        counters, the layout source per served model, per-device occupancy
        with the utilization ledger, and with [elastic] the `elastic` block;
        `{"enabled": false}` when serving is single-device."""
        stats = self.impl.mesh_stats()
        return web.json_response(stats if stats is not None else _OFF)

    async def cascadez(self, request: web.Request) -> web.Response:
        """GET /cascadez: the cascade's config echo (stage-1 model, survivor
        policy), request / fallback / stage-1 failure / host prune counters,
        row dispositions, stage seconds, observed survivor and rank
        fractions, survivor buckets, and the batcher's prune counters;
        `{"enabled": false}` with the plane off."""
        stats = self.impl.cascade_stats()
        return web.json_response(stats if stats is not None else _OFF)

    async def integrityz(self, request: web.Request) -> web.Response:
        """GET /integrityz: wire verify / reject counters, screen trips,
        shadow batches / mismatches / audits, the suspect verdict and the
        event history; `{"enabled": false}` with the plane off."""
        stats = self.impl.integrity_stats()
        return web.json_response(stats if stats is not None else _OFF)

    async def integrityz_audit(self, request: web.Request) -> web.Response:
        """POST /integrityz/audit[?batches=N]: the next N batches (default
        1) are shadowed and compared whatever shadow_fraction says. 404 with
        the plane off."""
        integ = self.impl.integrity
        if integ is None:
            return web.json_response(_OFF, status=404)
        try:
            batches = int(request.query.get("batches", "1"))
        except ValueError:
            return _json_error("INVALID_ARGUMENT", "batches must be an integer")
        if batches < 1:
            return _json_error("INVALID_ARGUMENT", "batches must be >= 1")
        pending = integ.request_audit(batches)
        return web.json_response({"requested": batches, "pending_audits": pending})

    async def cachez(self, request: web.Request) -> web.Response:
        """GET /cachez: the score cache's aggregate and per-model counters,
        hit rate, occupancy and config, with a `row_cache` block when the
        row tier is armed; `{"enabled": false}` with no store armed."""
        stats = self.impl.cache_stats()
        row = self.impl.row_cache_stats()
        if row is not None:
            stats = dict(stats) if stats is not None else {"enabled": False}
            stats["row_cache"] = row
        return web.json_response(stats if stats is not None else _OFF)

    async def cachez_flush(self, request: web.Request) -> web.Response:
        """POST /cachez/flush[?model=NAME]: drop every cached score, or one
        model's (generation-bumped: fills in flight are dropped too)."""
        try:
            dropped = self.impl.cache_flush(request.query.get("model") or None)
        except ServiceError as e:
            return _json_error(e.code, str(e))
        return web.json_response({"flushed": True, "entries_dropped": dropped})

    async def utilz(self, request: web.Request) -> web.Response:
        """GET /utilz[?window=S]: the occupancy ledger's counters, idle gaps
        by cause, the windowed gap waterfall (components sum to wall) and
        achieved_fraction_of_device_limit; `{"enabled": false}` with the
        plane off."""
        window = request.query.get("window")
        if window is not None:
            try:
                window = float(window)
            except ValueError:
                return _json_error("INVALID_ARGUMENT", "window must be a number")
        stats = self.impl.utilization_stats(window)
        return web.json_response(stats if stats is not None else _OFF)

    async def profilez_status(self, request: web.Request) -> web.Response:
        """GET /profilez: whether a deep capture runs, and where its
        artifacts land."""
        return web.json_response(profiler_capture().status())

    async def profilez_start(self, request: web.Request) -> web.Response:
        """POST /profilez/start?seconds=N: a torch.profiler trace and a
        host-thread stack sample over the next N seconds (default 3). Answers
        the artifact paths at once; the capture stops itself. A concurrent
        capture is refused with 409 (the profiler is process-global)."""
        try:
            seconds = float(request.query.get("seconds", "3"))
        except ValueError:
            return _json_error("INVALID_ARGUMENT", "seconds must be a number")
        try:
            info = profiler_capture().start(seconds)
        except CaptureInProgressError as e:
            return web.json_response({"error": str(e)}, status=409)
        return web.json_response({"started": True, **info})

    async def qualityz(self, request: web.Request) -> web.Response:
        """GET /qualityz[?model=NAME][&version=V]: per-(model, version)
        score sketches (lifetime and window, per lane), drift against the
        pinned reference and between live versions, the label join's AUC
        and calibration, the exemplar counters; `{"enabled": false}` with
        the plane off."""
        version = request.query.get("version")
        if version is not None:
            try:
                version = int(version)
            except ValueError:
                return _json_error("INVALID_ARGUMENT", "version must be an integer")
        stats = self.impl.quality_stats(model=request.query.get("model") or None,
                                        version=version)
        return web.json_response(stats if stats is not None else _OFF)

    async def qualityz_snapshot(self, request: web.Request) -> web.Response:
        """POST /qualityz/snapshot: pin the current windowed score
        distributions as the drift reference (and write the artifact when
        [quality] reference_file is set)."""
        try:
            pinned = self.impl.quality_pin_reference()
        except ServiceError as e:
            return _json_error(e.code, str(e))
        return web.json_response({"pinned": True, **pinned})

    async def labelz(self, request: web.Request) -> web.Response:
        """POST /labelz: the label-feedback ingest. Body: one label object
        `{"id": ..., "label": 0|1, "ts": ...?}`, a list of them, or
        `{"labels": [...]}`; `id` is a request trace id (optionally
        `#<row>`) or a row digest (quality.row_label_keys). Answers this
        call's joined and orphaned counts."""
        try:
            body = await request.json()
        except Exception as e:  # noqa: BLE001 — malformed JSON is a 400
            return _json_error("INVALID_ARGUMENT", f"invalid JSON body: {e}")
        if isinstance(body, dict) and "labels" in body:
            items = body["labels"]
        elif isinstance(body, dict):
            items = [body]
        else:
            items = body
        if not isinstance(items, list) or not items:
            return _json_error(
                "INVALID_ARGUMENT",
                'body must be a label object, a list, or {"labels": [...]}',
            )
        try:
            result = self.impl.quality_ingest_labels(items)
        except ServiceError as e:
            return _json_error(e.code, str(e))
        return web.json_response(result)

    # --------------------------------------------------- status / metadata

    async def status(self, request: web.Request) -> web.Response:
        # The ModelService RPC's body (impl.get_model_status) in TF-Serving's
        # REST JSON: the gRPC and REST answers cannot drift.
        model = request.match_info["model"]
        try:
            req = apis.GetModelStatusRequest()
            self._fill_model_spec(
                req.model_spec, model,
                self._parse_version(request.match_info.get("version")),
                request.match_info.get("label"),
            )
            resp = self.impl.get_model_status(req)
        except ServiceError as e:
            return _json_error(e.code, str(e))
        except ValueError as e:
            # e.g. a /versions/{v} segment past int64: the client's error.
            return _json_error("INVALID_ARGUMENT", str(e))
        except Exception as e:  # noqa: BLE001 — surface as 500, keep serving
            log.exception("internal error serving REST status")
            return _json_error("INTERNAL", f"internal error: {e}")
        state_name = apis.ModelVersionStatus.State.Name
        return web.json_response({
            "model_version_status": [
                {
                    "version": str(s.version),
                    "state": state_name(s.state),
                    # proto3 JSON names enums: parsers match "OK".
                    "status": {
                        "error_code": "OK" if s.status.error_code == 0 else s.status.error_code,
                        "error_message": s.status.error_message,
                    },
                }
                for s in resp.model_version_status
            ]
        })

    async def metadata(self, request: web.Request) -> web.Response:
        model = request.match_info["model"]
        try:
            # Resolution only: this route lists every signature, so a model
            # without serving_default must still answer.
            servable = _wrap_lookup(
                lambda: self.impl.registry.resolve(
                    model,
                    self._parse_version(request.match_info.get("version")),
                    request.match_info.get("label"),
                )
            )
        except ServiceError as e:
            return _json_error(e.code, str(e))
        except Exception as e:  # noqa: BLE001 — surface as 500, keep serving
            log.exception("internal error serving REST metadata")
            return _json_error("INTERNAL", f"internal error: {e}")

        def spec_json(spec):
            shape = (
                {"unknown_rank": True}
                if spec.shape is None
                else {"dim": [{"size": str(-1 if d is None else d)} for d in spec.shape]}
            )
            # Enum by NAME, as proto3 JSON prints it ("DT_INT64", not 9).
            try:
                dtype = fw.DataType.Name(spec.dtype)
            except ValueError:
                dtype = int(spec.dtype)
            return {"dtype": dtype, "tensor_shape": shape}

        sig_defs = {
            name: {
                "method_name": sig.method_name,
                "inputs": {s.name: spec_json(s) for s in sig.inputs},
                "outputs": {s.name: spec_json(s) for s in sig.outputs},
            }
            for name, sig in servable.signatures.items()
        }
        return web.json_response({
            "model_spec": {
                "name": servable.name,
                "version": str(servable.version),
                "signature_name": "",
            },
            "metadata": {"signature_def": {"signature_def": sig_defs}},
        })


async def start_rest_gateway(
    impl: PredictionServiceImpl,
    host: str = "127.0.0.1",
    port: int = 8501,
    metrics: ServerMetrics | None = None,
) -> tuple[web.AppRunner, int]:
    """Start the gateway on the running event loop; returns (runner,
    bound_port). Stop it with `await runner.cleanup()`. Pass the gRPC
    server's ServerMetrics so one Prometheus text counts both surfaces."""
    gw = RestGateway(impl, metrics)
    runner = web.AppRunner(gw.app)
    await runner.setup()
    site = web.TCPSite(runner, host, port)
    await site.start()
    return runner, runner.addresses[0][1]
