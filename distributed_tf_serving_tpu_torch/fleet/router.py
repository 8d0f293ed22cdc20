"""The fleet router.

A standalone process speaking the PredictionService wire protocol on
both transports (TCP + optional UDS) that embeds `ShardedPredictClient`
SERVER-side: every steering mechanism built for the fan-out client —
scoreboard ejection/half-open probes, hedging, failover, jittered
backoff, retry budgets, jump-hash row affinity (`placement="affinity"`),
partial results — becomes the fleet's routing brain, with zero new
steering code. An edge client dials ONE address; a replica's death is a
router-local failover, not a client-visible error.

Request metadata rides through the hop: the edge's deadline becomes the
embedded client's per-attempt timeout (context.time_remaining), its
`x-dts-criticality` lane and `traceparent` forward verbatim, and its
`x-dts-retry-budget` caps the router's own attempt budget at
min(local, advertised) — the fleet never multiplies the edge's retry
intent (all via `client.request_overrides`, a contextvar scope, so one
embedded client serves many concurrent edge requests).

Health arrives three ways, fastest wins:
- gossip (fleet/gossip.py): a replica announcing draining/quarantined
  steers the whole fleet BEFORE its first failed RPC;
- grpc.health.v1 Watch subscriptions per backend (the satellite: push,
  not half-open polling);
- the RPC outcomes themselves (the scoreboard's native signal).

The router is also the rollout coordinator (fleet/rollout.py,
`rollout_writer=true`): its gossip record carries the shared rollout
state every replica follows.

Run it as `python -m distributed_tf_serving_tpu_torch.fleet.router --config
router.toml` or `... .serving.server --router --config router.toml`:
[server] is the router's bind address, [client] its backend list +
steering knobs, [fleet] gossip/rollout. device-free by construction — the
router never loads a model.

Scores through the router are bit-identical to a direct backend call:
inputs decode/re-encode through the same codec both hops, and float32
tensors round-trip exactly. Deliberate simplifications, documented:
the router serves the client's single configured model + score output
(NOT_FOUND otherwise), and PredictStream answers as ONE final chunk —
the stream's incremental-merge benefit needs row ownership the router
already spent on fleet affinity.
"""

from __future__ import annotations

import argparse
import asyncio
import gc
import json
import logging
import signal
import threading
import time

import grpc
import grpc.aio

import numpy as np

from .. import codec
from ..client.client import (
    PredictClientError,
    PredictResult,
    build_predict_request,
    client_from_config,
)
from ..client.health import HEALTHY
from ..proto import health as health_proto
from ..proto import serving_apis_pb2 as apis
from ..proto.service_grpc import (
    KEEPALIVE_SERVER_OPTIONS,
    LARGE_MESSAGE_CHANNEL_OPTIONS,
    add_PredictionServiceServicer_to_server,
)
from ..utils import tracing
from ..utils.config import ClientConfig, load_config
from ..utils.metrics import WindowedLatency
from . import gossip as gossip_mod
from .gossip import GossipAgent
from .observability import FleetObservabilityPlane
from .rollout import RolloutCoordinator

log = logging.getLogger("dts_torch.fleet.router")

_CRITICALITY_KEY = "x-dts-criticality"
_RETRY_BUDGET_KEY = "x-dts-retry-budget"
_DEGRADED_KEY = "x-dts-degraded"
_PEER_ROLE_KEY = "x-dts-peer-role"


def _metadata_of(context) -> dict[str, str]:
    try:
        return {k: v for k, v in context.invocation_metadata() or ()
                if isinstance(v, str)}
    except Exception:  # noqa: BLE001 — metadata quirks must not fail RPCs
        return {}


def _deadline_of(context) -> float | None:
    remaining = context.time_remaining()
    if remaining is None or remaining == float("inf") or remaining <= 0:
        return None
    return remaining


class Router:
    """The wiring: embedded client + gossip agent + rollout coordinator
    + counters. Servicers below are thin adapters over `forward()`."""

    def __init__(self, cfgs: dict, *, clock=time.time):
        self.client = client_from_config(cfgs.get("client") or ClientConfig())
        self.fleet_cfg = cfgs.get("fleet")
        self.obs_cfg = cfgs.get("observability")
        self.slo_cfg = cfgs.get("slo")
        self._clock = clock
        # Router-side rolling latency window (always on — the /monitoring
        # parity surface needs "what is the router doing NOW" even with
        # tracing off; one histogram record per forward).
        self.window = WindowedLatency(
            window_s=(
                self.obs_cfg.window_seconds
                if self.obs_cfg is not None else 60.0
            )
        )
        # Per-backend windows on the embedded client (the /monitoring
        # parity satellite: windowed latency per replica as steered).
        self.client.enable_backend_windows(self.window.window_s)
        # Gossip record id -> backend index in the client's host list.
        # Convention: a replica's [fleet] self_id is its SERVING address
        # exactly as the router's [client] hosts lists it.
        self._backend_idx = {h: i for i, h in enumerate(self.client.hosts)}
        self.coordinator: RolloutCoordinator | None = None
        self.gossip: GossipAgent | None = None
        self.plane: FleetObservabilityPlane | None = None
        if self.fleet_cfg is not None and self.fleet_cfg.enabled:
            if self.fleet_cfg.rollout_writer:
                self.coordinator = RolloutCoordinator(
                    self.fleet_cfg.rollout_state_file, clock=clock
                )
            # The aggregation half: member scrape + trace
            # stitch + SLO burn. Created with gossip — member discovery
            # rides the gossip view — and ticked by its own daemon thread
            # once run_router starts it.
            self.plane = FleetObservabilityPlane(
                members_fn=self._members,
                self_source=self.fleet_cfg.self_id or "router",
                local_export=(
                    lambda since: tracing.recorder().export_since(since)
                ),
                slo_cfg=self.slo_cfg,
                interval_s=(
                    self.obs_cfg.trace_export_interval_s
                    if self.obs_cfg is not None else 1.0
                ),
                clock=clock,
            )
            self.gossip = GossipAgent(
                self.fleet_cfg.self_id or "router",
                role="router",
                host=self.fleet_cfg.gossip_host,
                port=self.fleet_cfg.gossip_port,
                uds_path=self.fleet_cfg.gossip_uds,
                peers=self.fleet_cfg.peers,
                interval_s=self.fleet_cfg.gossip_interval_s,
                ttl_s=self.fleet_cfg.record_ttl_s,
                record_fn=self._gossip_record,
                on_update=self.fold_gossip,
                extra_routes={
                    "/fleetz": self.fleetz,
                    "/metrics": self.prometheus_text,
                    "/monitoring": self.monitoring,
                    "/fleet/monitoring": self.plane.aggregate_snapshot,
                    "/sloz": self.plane.slo_snapshot,
                },
                query_routes={
                    "/tracez": self._tracez_route,
                    "/tracez/export": self._trace_export_route,
                },
                post_routes={
                    "/tracez/ingest": self.plane.ingest_push,
                },
                clock=clock,
            )
        # Counters (monotonic; /fleetz + dts_tpu_fleet_*).
        self.requests = 0
        self.errors = 0
        self.degraded = 0
        self.gossip_steers = 0
        self.gossip_rejoins = 0
        self.watch_updates = 0
        # Router-side integrity audit: a sampled fraction of
        # forwards ALSO fans the same tensors to two replicas and
        # compares the score bytes bit-identically — the only corruption
        # detector that works when a replica's own plane is lying (or
        # off). Armed by [integrity] router_audit_fraction in the
        # router's config; the deterministic accumulator mirrors the
        # replica-side shadow sampler (no RNG).
        self.integrity_cfg = cfgs.get("integrity")
        self._audit_acc = 0.0
        self.audits = 0
        self.audit_disagreements = 0
        self.audit_suspects_marked = 0
        self.suspect_steers = 0
        self._audit_tasks: set[asyncio.Task] = set()
        self._started_t = clock()
        self._watch_tasks: list[asyncio.Task] = []

    # ------------------------------------------------------ observability

    def _members(self) -> dict:
        return (
            self.gossip.view(include_self=False)
            if self.gossip is not None else {}
        )

    def _tracez_route(self, query: dict):
        """GET /tracez on the router's gossip port: the STITCHED
        cross-process view (json default; ?format=chrome for the
        multi-pid Perfetto export)."""
        if not tracing.enabled() or self.plane is None:
            return {"enabled": False, "traces": []}
        limit = 50
        try:
            limit = max(1, int(query.get("limit", limit)))
        except (TypeError, ValueError):
            pass
        if query.get("format") == "chrome":
            return self.plane.collector.chrome_trace(limit)
        return self.plane.collector.tracez(limit)

    def _trace_export_route(self, query: dict) -> dict:
        """GET /tracez/export on the router: the router's OWN local span
        trees (a higher-tier collector could stitch routers too)."""
        if not tracing.enabled():
            return {"enabled": False, "cursor": 0, "spans": []}
        try:
            since = int(query.get("since", 0) or 0)
        except (TypeError, ValueError):
            since = 0
        return tracing.recorder().export_since(since)

    # ------------------------------------------------------------- gossip

    def _gossip_record(self) -> dict:
        rec = {"state": gossip_mod.SERVING}
        if self.coordinator is not None and self.gossip is not None:
            # Coordination rides the publish cadence: fold the current
            # view (sans self — self_record() is what's being built) and
            # attach the resulting shared state to the outgoing record.
            view = self.gossip.view(include_self=False)
            rec["rollout"] = self.coordinator.tick(view).to_dict()
        return rec

    def fold_gossip(self, rec) -> None:
        """Gossip -> scoreboard steering: quarantine/drain announcements
        steer the fleet BEFORE the first failed RPC lands on them; a
        fresh serving record from a non-healthy backend is the rejoin
        path (the restarted process re-admits itself by speaking)."""
        sb = self.client.scoreboard
        idx = self._backend_idx.get(rec.id)
        if sb is None or idx is None:
            return
        if rec.state == gossip_mod.DRAINING:
            if sb.state(idx) != gossip_mod.DRAINING:
                self.gossip_steers += 1
            sb.record_failure(idx, kind="draining")
        elif rec.state in (gossip_mod.QUARANTINED, gossip_mod.STARTING):
            if sb.state(idx) == HEALTHY:
                self.gossip_steers += 1
                sb.record_failure(idx, kind="rebuilding")
        elif getattr(rec, "suspect", False):
            # SERVING but integrity-suspect: the replica's own
            # plane caught its data path miscomputing (shadow mismatch /
            # screen burst) and gossiped the verdict. Busy-bias steer
            # (kind="corrupt" — the pushback shape, never ejection on a
            # verdict alone): traffic prefers other replicas while the
            # suspect rehabilitates, and the next clean gossip record
            # rejoins it below.
            self.suspect_steers += 1
            sb.record_failure(idx, kind="corrupt")
        elif rec.state == gossip_mod.SERVING and sb.state(idx) != HEALTHY:
            self.gossip_rejoins += 1
            sb.record_success(idx)

    # --------------------------------------------------- health watchers

    async def watch_backends(self) -> None:
        """Subscribe to every backend's grpc.health.v1 Watch stream (the
        satellite: push replaces half-open polling). Each status CHANGE
        folds into the scoreboard; a broken stream retries with capped
        backoff forever — a dead backend simply has no stream."""
        for idx in range(len(self.client.hosts)):
            self._watch_tasks.append(
                asyncio.ensure_future(self._watch_one(idx))
            )

    async def _watch_one(self, idx: int) -> None:
        backoff = 0.5
        while True:
            try:
                # The client's channel for this backend: one connection
                # serves Predict traffic and the Watch subscription.
                stub = health_proto.HealthStub(
                    self.client._channels[idx][0]
                )
                call = stub.Watch(health_proto.HealthCheckRequest(""))
                async for resp in call:
                    backoff = 0.5
                    self._fold_watch(idx, resp.status)
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — a dead backend is normal
                pass
            await asyncio.sleep(backoff)
            backoff = min(backoff * 2, 5.0)

    def _fold_watch(self, idx: int, status: int) -> None:
        sb = self.client.scoreboard
        if sb is None:
            return
        self.watch_updates += 1
        if status == health_proto.SERVING:
            if sb.state(idx) != HEALTHY:
                self.gossip_rejoins += 1
                sb.record_success(idx)
        elif status == health_proto.NOT_SERVING and sb.state(idx) == HEALTHY:
            # No reason trailer on a stream message: steer-around bias
            # (rebuilding), not ejection — gossip carries the distinction
            # between drain and quarantine.
            sb.record_failure(idx, kind="rebuilding")

    def stop_watchers(self) -> None:
        for t in self._watch_tasks:
            t.cancel()
        self._watch_tasks = []
        for t in list(self._audit_tasks):
            t.cancel()
        self._audit_tasks.clear()

    # ----------------------------------------- integrity audit

    def _want_audit(self) -> bool:
        cfg = self.integrity_cfg
        if (
            cfg is None
            or not cfg.enabled
            or cfg.router_audit_fraction <= 0.0
            or len(self.client.hosts) < 2
        ):
            return False
        self._audit_acc += cfg.router_audit_fraction
        if self._audit_acc >= 1.0:
            self._audit_acc -= 1.0
            return True
        return False

    async def audit(self, arrays: dict) -> bool | None:
        """Two-replica bit-identity audit of one sampled request: the
        SAME tensors scored independently by two healthy replicas must
        produce byte-identical score vectors (same model version, same
        deterministic executable). Disagreement means one of them is
        corrupting silently; a third replica (when the fleet has one)
        breaks the tie and the MINORITY is marked in the scoreboard
        (kind="corrupt" — busy-bias steer, the gossip-suspect shape).
        Returns True (agreed), False (disagreed), None (not enough
        answers to judge)."""
        sb = self.client.scoreboard
        healthy = [
            i for i in range(len(self.client.hosts))
            if sb is None or sb.state(i) == HEALTHY
        ]
        if len(healthy) < 2:
            return None
        self.audits += 1
        a, b = healthy[0], healthy[1]
        ra = await self._audit_call(a, arrays)
        rb = await self._audit_call(b, arrays)
        if ra is None or rb is None:
            return None
        if self._bits_eq(ra, rb):
            return True
        self.audit_disagreements += 1
        minority = None
        if len(healthy) >= 3:
            rc = await self._audit_call(healthy[2], arrays)
            if rc is not None:
                if self._bits_eq(rc, ra):
                    minority = b
                elif self._bits_eq(rc, rb):
                    minority = a
                # Three distinct answers: nobody is a majority — mark
                # no one (a wrong conviction steers traffic away from a
                # healthy replica).
        if minority is not None and sb is not None:
            self.audit_suspects_marked += 1
            sb.record_failure(minority, kind="corrupt")
            log.warning(
                "integrity audit: replica %s disagreed with the majority "
                "score bytes — marked suspect (busy-bias steer)",
                self.client.hosts[minority],
            )
        return False

    @staticmethod
    def _bits_eq(a: np.ndarray, b: np.ndarray) -> bool:
        return (
            a.dtype == b.dtype
            and a.shape == b.shape
            and a.tobytes() == b.tobytes()
        )

    async def _audit_call(self, idx: int, arrays: dict):
        """One audit probe straight at one backend: no failover, no
        hedging, no scoreboard recording — a probe that fails is simply
        an inconclusive audit, never a health signal (the RPC path
        already owns that)."""
        try:
            req = build_predict_request(
                arrays,
                self.client.model_name,
                self.client.signature_name,
                output_filter=(self.client.output_key,),
                version_label=self.client.version_label,
                use_tensor_content=self.client.use_tensor_content,
            )
            stub = self.client._stubs[idx][0]
            resp = await stub.Predict(req, timeout=self.client.timeout_s)
            return np.ascontiguousarray(
                codec.to_ndarray(resp.outputs[self.client.output_key])
            )
        except Exception:  # noqa: BLE001 — an unanswerable probe is inconclusive
            return None

    # ------------------------------------------------------------ forward

    def healthy_backends(self) -> int:
        sb = self.client.scoreboard
        if sb is None:
            return len(self.client.hosts)
        return sum(
            1 for i in range(len(self.client.hosts))
            if sb.state(i) == HEALTHY
        )

    async def forward(self, request: apis.PredictRequest, context):
        """One edge Predict through the embedded client. Returns the
        merged score array (+ degraded flag); raises PredictClientError
        for the servicer to map."""
        name = request.model_spec.name
        if name and name != self.client.model_name:
            raise ServiceRefusal(
                grpc.StatusCode.NOT_FOUND,
                f"router serves model {self.client.model_name!r}, "
                f"not {name!r}",
            )
        try:
            # A DT_BFLOAT16 input (the compact wire) decodes widened to
            # f32 and narrows back exactly, so it leaves as it came.
            arrays = {
                k: (codec.bf16_bits(codec.to_ndarray(t))
                    if t.dtype == codec.DataType.DT_BFLOAT16
                    else codec.to_ndarray(t))
                for k, t in request.inputs.items()
            }
        except (codec.CodecError, ValueError) as e:
            raise ServiceRefusal(
                grpc.StatusCode.INVALID_ARGUMENT, f"bad input tensor: {e}"
            ) from e
        if not arrays:
            raise ServiceRefusal(
                grpc.StatusCode.INVALID_ARGUMENT, "request has no inputs"
            )
        md = _metadata_of(context)
        budget = md.get(_RETRY_BUDGET_KEY)
        try:
            budget = max(int(budget), 1) if budget else None
        except ValueError:
            budget = None
        self.requests += 1
        # Root router span: adopts the edge's traceparent, so
        # the edge client / router / replica trees share one trace id; the
        # embedded client re-roots ITS spans under this one (the override
        # traceparent below), so per-attempt/hedge `client.rpc` children
        # stitch in as grandchildren. One enabled() read when tracing is
        # off — the disabled path is the untraced code shape.
        span_cm = (
            tracing.start_root(
                "router.route",
                traceparent=md.get("traceparent"),
                attrs={
                    "backends": len(self.client.hosts),
                    "healthy_backends": self.healthy_backends(),
                    "criticality": md.get(_CRITICALITY_KEY) or "default",
                },
            )
            if tracing.enabled() else None
        )
        if span_cm is not None:
            # Peer-role attribution for the EDGE's client.rpc span:
            # answered on initial metadata —
            # trailing metadata already carries the degraded marker.
            try:
                await context.send_initial_metadata(
                    ((_PEER_ROLE_KEY, "router"),)
                )
            except Exception:  # noqa: BLE001 — advisory only
                pass
        t0 = time.perf_counter()
        try:
            if span_cm is None:
                with self.client.request_overrides(
                    criticality=md.get(_CRITICALITY_KEY),
                    timeout_s=_deadline_of(context),
                    traceparent=md.get("traceparent"),
                    max_attempts_total=budget,
                ):
                    result = await self.client.predict(arrays)
            else:
                with span_cm as span:
                    with self.client.request_overrides(
                        criticality=md.get(_CRITICALITY_KEY),
                        timeout_s=_deadline_of(context),
                        traceparent=tracing.make_traceparent(
                            span.trace_id, span.span_id
                        ),
                        max_attempts_total=budget,
                    ):
                        result = await self.client.predict(arrays)
                    if self.plane is not None and self.plane.slo_breached:
                        # Burn-rate breach in progress: mark the span so
                        # the tail sampler force-keeps it — the traces
                        # that EXPLAIN the breach survive sampling.
                        span.annotate(
                            "slo.burn",
                            breaches=self.plane.slo.breaches,
                        )
        finally:
            self.window.record(time.perf_counter() - t0)
        if self._want_audit():
            # Fire-and-forget: the audit must never add latency to the
            # forwarded answer it samples. Task refs held so the loop
            # cannot GC a running audit mid-flight.
            task = asyncio.ensure_future(self.audit(arrays))
            self._audit_tasks.add(task)
            task.add_done_callback(self._audit_tasks.discard)
        if isinstance(result, PredictResult):
            if result.degraded:
                self.degraded += 1
                try:
                    context.set_trailing_metadata(((_DEGRADED_KEY, "partial"),))
                except Exception:  # noqa: BLE001 — advisory only
                    pass
            return result.scores
        return result

    def encode_response(self, request, scores) -> apis.PredictResponse:
        resp = apis.PredictResponse()
        resp.model_spec.name = self.client.model_name
        resp.model_spec.signature_name = (
            request.model_spec.signature_name or "serving_default"
        )
        # Mirror the edge's tensor encoding (the server's own rule, so
        # the bytes match a direct backend response).
        mirror = any(
            request.inputs[name].tensor_content for name in request.inputs
        )
        codec.from_ndarray(
            scores, use_tensor_content=mirror,
            out=resp.outputs[self.client.output_key],
        )
        return resp

    # ----------------------------------------------------------- surfaces

    def fleetz(self) -> dict:
        out = {
            "enabled": True,
            "role": "router",
            "model": self.client.model_name,
            "backends": list(self.client.hosts),
            "healthy_backends": self.healthy_backends(),
            "uptime_s": round(self._clock() - self._started_t, 3),
            "counters": {
                "requests": self.requests,
                "errors": self.errors,
                "degraded": self.degraded,
                "gossip_steers": self.gossip_steers,
                "gossip_rejoins": self.gossip_rejoins,
                "watch_updates": self.watch_updates,
                "suspect_steers": self.suspect_steers,
                "integrity_audits": self.audits,
                "audit_disagreements": self.audit_disagreements,
                "audit_suspects_marked": self.audit_suspects_marked,
            },
            "resilience": self.client.resilience_counters(),
        }
        if self.gossip is not None:
            out["gossip"] = self.gossip.snapshot()
        if self.coordinator is not None:
            out["rollout"] = self.coordinator.snapshot()
        return out

    def monitoring(self) -> dict:
        """GET /monitoring parity for the router:
        the steering scoreboard, per-backend windowed latency, and
        gossip/rollout counters in ONE JSON — the replica's /monitoring
        sibling, so fleet dashboards scrape both roles the same way."""
        resilience = self.client.resilience_counters()
        out = {
            "role": "router",
            "model": self.client.model_name,
            "uptime_s": round(self._clock() - self._started_t, 3),
            "window": self.window.snapshot(),
            "counters": {
                "requests": self.requests,
                "errors": self.errors,
                "degraded": self.degraded,
                "gossip_steers": self.gossip_steers,
                "gossip_rejoins": self.gossip_rejoins,
                "watch_updates": self.watch_updates,
                "suspect_steers": self.suspect_steers,
                "integrity_audits": self.audits,
                "audit_disagreements": self.audit_disagreements,
                "audit_suspects_marked": self.audit_suspects_marked,
            },
            "healthy_backends": self.healthy_backends(),
            "scoreboard": resilience.get("scoreboard"),
            "backend_windows": self.client.backend_window_snapshots(),
            "resilience": resilience,
        }
        if self.gossip is not None:
            out["gossip"] = self.gossip.snapshot()
        if self.coordinator is not None:
            out["rollout"] = self.coordinator.snapshot()
        if self.plane is not None:
            out["fleet_aggregate"] = self.plane.agg_block()
            slo = self.plane.slo_block()
            if slo is not None:
                out["slo"] = slo
        return out

    def fleet_stats(self) -> dict:
        """The shape utils.metrics._fleet_prometheus_lines consumes (the
        replica side builds the same shape in service.fleet_stats)."""
        stats = {
            "role": "router",
            "router": {
                "requests": self.requests,
                "errors": self.errors,
                "degraded": self.degraded,
                "gossip_steers": self.gossip_steers,
                "gossip_rejoins": self.gossip_rejoins,
                "watch_updates": self.watch_updates,
                "suspect_steers": self.suspect_steers,
                "integrity_audits": self.audits,
                "audit_disagreements": self.audit_disagreements,
                "audit_suspects_marked": self.audit_suspects_marked,
                "healthy_backends": self.healthy_backends(),
                "backends": len(self.client.hosts),
            },
        }
        if self.gossip is not None:
            stats["gossip"] = self.gossip.snapshot()
        if self.coordinator is not None:
            stats["rollout"] = self.coordinator.snapshot()
        if self.plane is not None:
            agg = self.plane.agg_block()
            if agg:
                stats["agg"] = agg
            slo = self.plane.slo_block()
            if slo is not None:
                stats["slo"] = slo
        return stats

    def prometheus_text(self) -> str:
        from ..utils.metrics import fleet_prometheus_text

        return fleet_prometheus_text(self.fleet_stats())


class ServiceRefusal(Exception):
    """A router-local refusal with a grpc status (the ServiceError shape
    without the serving package's torch-linked import)."""

    def __init__(self, code, details: str):
        super().__init__(details)
        self.code = code
        self.details = details


class RouterPredictionService:
    """PredictionService servicer over Router.forward. Predict and
    PredictStream proxy; GetModelMetadata forwards to a healthy backend;
    the tf.Example RPCs answer UNIMPLEMENTED (the fleet tier fronts the
    tensor path — the reference deployment's shape)."""

    def __init__(self, router: Router):
        self.router = router

    async def _abort(self, context, e) -> None:
        self.router.errors += 1
        code = getattr(e, "code", None)
        if not isinstance(code, grpc.StatusCode):
            code = grpc.StatusCode.UNAVAILABLE
        await context.abort(code, getattr(e, "details", str(e)))

    async def Predict(self, request, context):
        try:
            scores = await self.router.forward(request, context)
            return self.router.encode_response(request, scores)
        except (ServiceRefusal, PredictClientError) as e:
            await self._abort(context, e)
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001 — surface as INTERNAL
            log.exception("router Predict failed")
            self.router.errors += 1
            await context.abort(
                grpc.StatusCode.INTERNAL, f"router internal error: {e}"
            )

    async def PredictStream(self, request, context):
        """One FINAL chunk carrying the whole merged result (documented
        simplification: the router already fanned the rows out by
        affinity; a second chunking layer would re-split the merge it
        just paid for). Wire-compatible with the incremental client —
        offset 0, count == total, final=True."""
        try:
            scores = await self.router.forward(request, context)
        except (ServiceRefusal, PredictClientError) as e:
            await self._abort(context, e)
            return
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001
            log.exception("router PredictStream failed")
            self.router.errors += 1
            await context.abort(
                grpc.StatusCode.INTERNAL, f"router internal error: {e}"
            )
            return
        chunk = apis.PredictStreamChunk()
        chunk.model_spec.name = self.router.client.model_name
        chunk.model_spec.signature_name = (
            request.model_spec.signature_name or "serving_default"
        )
        n = int(scores.shape[0]) if scores.ndim else 1
        chunk.offset = 0
        chunk.count = n
        chunk.total = n
        chunk.final = True
        mirror = any(
            request.inputs[name].tensor_content for name in request.inputs
        )
        codec.from_ndarray(
            scores, use_tensor_content=mirror,
            out=chunk.outputs[self.router.client.output_key],
        )
        yield chunk

    async def GetModelMetadata(self, request, context):
        """Proxied to one healthy backend (metadata is fleet-uniform: the
        replicas serve the same model dirs)."""
        client = self.router.client
        sb = client.scoreboard
        idx = (sb.pick(0) if sb is not None else 0) or 0
        stub = client._stubs[idx][0]
        try:
            return await stub.GetModelMetadata(
                request, timeout=client.timeout_s
            )
        except grpc.aio.AioRpcError as e:
            self.router.errors += 1
            await context.abort(e.code(), e.details() or "backend error")

    async def Classify(self, request, context):
        await context.abort(
            grpc.StatusCode.UNIMPLEMENTED,
            "the fleet router proxies the tensor Predict path only",
        )

    async def Regress(self, request, context):
        await context.abort(
            grpc.StatusCode.UNIMPLEMENTED,
            "the fleet router proxies the tensor Predict path only",
        )

    async def MultiInference(self, request, context):
        await context.abort(
            grpc.StatusCode.UNIMPLEMENTED,
            "the fleet router proxies the tensor Predict path only",
        )


class RouterHealthService:
    """grpc.health.v1 for the router itself: SERVING while at least one
    backend is believed healthy (the router without backends is down in
    every way that matters to an edge client)."""

    watch_poll_s = 0.2

    def __init__(self, router: Router):
        self.router = router

    def _status(self, service: str) -> int | None:
        if service and service != self.router.client.model_name:
            return None
        return (
            health_proto.SERVING
            if self.router.healthy_backends() > 0
            else health_proto.NOT_SERVING
        )

    async def Check(self, request, context):
        st = self._status(request.service)
        if st is None:
            await context.abort(
                grpc.StatusCode.NOT_FOUND,
                f"unknown service {request.service!r}",
            )
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


async def run_router(
    cfgs: dict,
    *,
    host: str | None = None,
    port: int | None = None,
    uds_path: str | None = None,
    ready_cb=None,
) -> None:
    """Build and serve a router until cancelled/SIGTERM. `ready_cb(port,
    router)` fires after bind (tests and readiness probes)."""
    obs = cfgs.get("observability")
    if obs is not None:
        # Same process-level arming the replica server does: enables the
        # router's own span plane when [observability] tracing=true.
        obs.apply()
    router = Router(cfgs)
    server = grpc.aio.server(
        options=list(LARGE_MESSAGE_CHANNEL_OPTIONS)
        + list(KEEPALIVE_SERVER_OPTIONS),
    )
    add_PredictionServiceServicer_to_server(
        RouterPredictionService(router), server
    )
    health_proto.add_HealthServicer_to_server(
        RouterHealthService(router), server
    )
    srv_cfg = cfgs["server"]
    bind_host = host if host is not None else srv_cfg.host
    bind_port = port if port is not None else srv_cfg.port
    bound = server.add_insecure_port(f"{bind_host}:{bind_port}")
    if bound == 0:
        raise RuntimeError(f"could not bind {bind_host}:{bind_port}")
    transport = cfgs.get("transport")
    eff_uds = uds_path if uds_path is not None else (
        getattr(transport, "uds_path", "") or ""
    )
    if eff_uds:
        import os

        try:
            if os.path.exists(eff_uds):
                os.unlink(eff_uds)
        except OSError:
            pass
        if server.add_insecure_port(f"unix:{eff_uds}") == 0:
            raise RuntimeError(f"could not bind unix:{eff_uds}")
    await server.start()
    if router.gossip is not None:
        router.gossip.start()
    if router.plane is not None:
        router.plane.start()
    await router.watch_backends()
    log.info(
        "fleet router up on %s:%d -> %d backends%s", bind_host, bound,
        len(router.client.hosts),
        f" (gossip {router.gossip.listen_addr})" if router.gossip else "",
    )
    if ready_cb is not None:
        ready_cb(bound, router)
    stop_evt = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            loop.add_signal_handler(sig, stop_evt.set)
        except (NotImplementedError, RuntimeError):
            pass  # non-main thread / platform without signal support
    try:
        await stop_evt.wait()
    finally:
        router.stop_watchers()
        if router.plane is not None:
            router.plane.stop()
        if router.gossip is not None:
            router.gossip.stop()
        await server.stop(grace=2.0)
        try:
            await router.client.close()
        except Exception:  # noqa: BLE001 — channels may already be gone
            pass


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="CTR-serving fleet router: PredictionService front "
        "for a replica fleet, steered by scoreboard + health gossip"
    )
    parser.add_argument("--config", required=True,
                        help="TOML with [server] (bind), [client] "
                        "(backends + steering), [fleet] (gossip/rollout)")
    parser.add_argument("--host", default=None)
    parser.add_argument("--port", type=int, default=None)
    parser.add_argument("--uds-path", default=None)
    parser.add_argument("--ready-fd", type=int, default=None,
                        help="fd to write one readiness JSON line to "
                        "after bind (harness plumbing)")
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    cfgs = load_config(args.config)

    def _ready(port: int, router: Router) -> None:
        if args.ready_fd is None:
            return
        import os

        line = json.dumps({
            "port": port,
            "gossip": router.gossip.listen_addr if router.gossip else None,
        })
        os.write(args.ready_fd, (line + "\n").encode("utf-8"))
        os.close(args.ready_fd)

    # What is imported by now lives as long as the process (with `--router`
    # the serving CLI's modules, torch among them): move it out of the
    # collector's generations, so a full collection scans what the router
    # allocates while it serves, not the interpreter's whole import heap.
    gc.freeze()
    asyncio.run(run_router(
        cfgs, host=args.host, port=args.port, uds_path=args.uds_path,
        ready_cb=_ready,
    ))


if __name__ == "__main__":
    main()
