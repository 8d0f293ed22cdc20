"""Fan-out Predict client — the reference's split/merge path, asyncio-native.

Reproduces C2-C6/C9 of the component inventory (SURVEY.md §2.1): one
long-lived channel per backend host shared by all in-flight requests
(DCNClient.java:118-125), per-request candidate sharding (contiguous,
remainder-to-last), concurrent per-shard Predict RPCs, host-order merge of
each shard's output tensor (DCNClient.java:161-164), and optional ascending
sort of the merged scores — the ranking step (DCNClient.java:195).

Improvements over the reference kept deliberately semantic-preserving:
asyncio tasks replace the 16-thread pool + blocking stubs (asynchrony moves
into gRPC itself), per-RPC deadlines + typed errors replace
print-and-drop/thread-death failure modes (DCNClient.java:158-159,185-188),
and channels actually close (the reference's shutDownChannels never calls
shutdown(), DCNClient.java:127-135).
"""

from __future__ import annotations

import asyncio
import contextvars
import dataclasses
import random
import time

import grpc
import grpc.aio
import numpy as np

from .. import codec, faults
from ..proto import serving_apis_pb2 as apis
from ..utils import tracing
# LARGE_MESSAGE_CHANNEL_OPTIONS re-exported: transport tuning lives with
# the grpc wiring, but callers historically reach it through the client.
from ..proto.service_grpc import (  # noqa: F401
    LARGE_MESSAGE_CHANNEL_OPTIONS,
    PredictionServiceStub,
)
from .health import HALF_OPEN, BackendScoreboard
from .partition import (
    StreamingMerger,
    affinity_groups,
    index_runs,
    merge_host_order,
    partition_bounds,
    shard_candidates,
)


class PredictClientError(RuntimeError):
    def __init__(self, host: str, code, details: str):
        super().__init__(f"Predict to {host} failed: {code} {details}")
        self.host = host
        self.code = code


def keepalive_channel_options(
    keepalive_time_ms: int = 10_000, keepalive_timeout_ms: int = 5_000
) -> tuple[tuple[str, int], ...]:
    """HTTP/2 keepalive pings for the long-lived backend channels: a
    silently-dead backend (power loss, network partition — no FIN, no RST)
    is detected within time+timeout instead of hanging every in-flight RPC
    until its full deadline. max_pings_without_data=0 +
    permit_without_calls=1 keep the probe running on an idle channel too,
    so the FIRST request after an idle period doesn't eat the discovery."""
    return (
        ("grpc.keepalive_time_ms", int(keepalive_time_ms)),
        ("grpc.keepalive_timeout_ms", int(keepalive_timeout_ms)),
        ("grpc.http2.max_pings_without_data", 0),
        ("grpc.keepalive_permit_without_calls", 1),
    )


@dataclasses.dataclass
class ResilienceCounters:
    """Client-side resilience events (load harnesses report these)."""

    hedges_fired: int = 0
    hedges_won: int = 0
    failovers: int = 0
    backoff_sleeps: int = 0
    partial_responses: int = 0
    # Streamed Predict: shards served over PredictStream and
    # the sub-batch chunks their incremental merges consumed.
    streamed_shards: int = 0
    stream_chunks: int = 0
    # Overload plane (serving/overload.py): RESOURCE_EXHAUSTED sheds seen
    # (the backend is busy, not dead), and backoffs that honored a
    # server-sent retry-after-ms pushback hint.
    pushbacks_received: int = 0
    retry_after_honored: int = 0
    # Retry budget: requests whose per-request attempt budget
    # (max_attempts_total across failover hops + hedges + streamed
    # reroutes) ran out — the storm-suppression the recovery plane's
    # quarantine relies on.
    retry_budget_exhausted: int = 0
    # Recovery plane: UNAVAILABLE answers that
    # carried the replica-rebuilding marker (a quarantined backend
    # announcing its own recovery cycle) — steered around as "alive but
    # rebuilding", never charged to the ejection budget.
    rebuilding_hints: int = 0
    # Drain hints: UNAVAILABLE refusals carrying the
    # GracefulShutdown drain detail, or NOT_SERVING health answers whose
    # x-dts-health-reason trailer says "draining" — the backend is
    # LEAVING. Recorded as kind="draining" on the scoreboard: steered
    # away from immediately, no ejection budget spent, and the
    # rebuilding retry window never cycled.
    draining_hints: int = 0
    # int8 score response wire: responses whose score tensor
    # arrived as DT_INT8 + sidecars and was dequantized locally.
    int8_responses: int = 0
    # Integrity plane: responses whose score tensor failed
    # the x-dts-score-crc verify — caught BEFORE the merge, recorded
    # kind="corrupt" on the scoreboard, retried on another backend.
    corrupt_responses: int = 0
    # NaN scores encountered by the ranking sort and pushed to the
    # deterministic worst-rank tail instead of floating arbitrarily
    # through the comparison order (defense in depth for unscreened
    # backends).
    nan_scores_merged: int = 0


class _AttemptBudget:
    """Per-logical-request pool of EXTRA backend attempts (beyond each
    shard's guaranteed first try): failover retries and hedges draw from
    it; when dry, the shard fails with its last error instead of
    mounting another attempt. Shared by every shard task of one request
    (asyncio single-threaded mutation — no lock needed)."""

    __slots__ = ("left", "tripped")

    def __init__(self, extra: int):
        self.left = max(int(extra), 0)
        # Exhaustion is counted ONCE per logical request, not once per
        # shard/hedge that notices the dry pool.
        self.tripped = False

    def take(self) -> bool:
        if self.left > 0:
            self.left -= 1
            return True
        return False


# Overload-plane wire metadata (serving/overload.py repeats these; the
# client package must stay importable without the serving package's torch
# dependency, so the literals live on both sides).
_CRITICALITY_KEY = "x-dts-criticality"
_RETRY_AFTER_KEY = "retry-after-ms"
# int8 score response wire opt-in (ops/autotune.py SCORE_WIRE_KEY — the
# literal lives on both sides for the same device-free-import reason).
_SCORE_WIRE_KEY = "x-dts-score-wire"
# Substring a quarantined replica's UNAVAILABLE refusal carries
# (serving/batcher.py DeviceQuarantinedError message: "replica
# quarantined: device executor is being rebuilt ..."): the backend is
# alive and ANSWERING — it announced its own executor rebuild — so the
# scoreboard marks it rebuilding instead of burning ejection budget.
# A drain refusal ("server draining ...") deliberately does NOT match:
# a draining replica is leaving, not coming back.
_REBUILDING_MARKER = "replica quarantined"
# Substring a DRAINING replica's UNAVAILABLE refusal carries
# (serving/service.py _refuse_if_draining: "server is draining (shutdown
# in progress); retry against another backend") and the value the health
# servicer's x-dts-health-reason trailer uses. Recorded as
# kind="draining": the scoreboard steers away from
# the FIRST hint and never cycles the rebuilding retry window — before
# this split, a draining replica burned the whole rebuilding_streak_limit
# before ejection, eating one routed request per busy-window cycle.
_DRAINING_MARKER = "server is draining"
# grpc.health.v1 carries no detail field, so the serving stack annotates
# NOT_SERVING Check answers with the refusal reason ("draining" /
# "quarantined" / "starting") in this trailing-metadata key. Advisory:
# absent on foreign servers, the bare status keeps its historical
# rebuilding interpretation.
_HEALTH_REASON_KEY = "x-dts-health-reason"
# Retry-budget forwarding across a fleet router hop: a client
# with max_attempts_total set advertises it here; the router caps its own
# server-side attempt budget at min(local, advertised) so the edge's
# storm-suppression intent survives the hop.
_RETRY_BUDGET_KEY = "x-dts-retry-budget"

# Initial-metadata key traced servers answer with so client.rpc spans can
# label the resolved peer (router vs replica).
_PEER_ROLE_KEY = "x-dts-peer-role"

# Integrity-plane wire checksums (serving/integrity.py repeats
# these — the device-free-import rationale again): the client stamps
# per-input CRC32C sidecars on requests, the server stamps score-tensor
# checksums on responses for opted-in clients to verify before merge.
_INPUT_CRC_KEY = codec.CRC_INPUT_MD
_SCORE_CRC_KEY = codec.CRC_SCORE_MD


def _flip_tensor_bytes(tp) -> None:
    """Deterministic wire corruption (the wire_corrupt fault site): flip
    one payload bit of a TensorProto so the CRC verify on the receiving
    end MUST catch it — the shape/dtype stay valid, only the value
    changes (the silent-corruption scenario, not a decode error)."""
    if tp.tensor_content:
        buf = bytearray(tp.tensor_content)
        buf[len(buf) // 2] ^= 0x01
        tp.tensor_content = bytes(buf)
    elif len(tp.float_val):
        tp.float_val[0] = tp.float_val[0] + 1.0


# Per-request override channel: the fleet router serves many
# edge requests through ONE embedded ShardedPredictClient, and each
# inbound RPC carries its own deadline / criticality / traceparent /
# retry budget. Client-level attributes cannot express that, so the
# router (or any embedding caller) wraps predict() in
# `with client.request_overrides(...)`: contextvars propagate into every
# shard task asyncio spawns under the call, and concurrent requests see
# only their own values. All default to None = use the client attribute.
_OVERRIDES: "contextvars.ContextVar[dict | None]" = contextvars.ContextVar(
    "dts_client_request_overrides", default=None
)


class _OverrideScope:
    __slots__ = ("_values", "_token")

    def __init__(self, values: dict):
        self._values = values
        self._token = None

    def __enter__(self):
        self._token = _OVERRIDES.set(self._values)
        return self

    def __exit__(self, *exc):
        _OVERRIDES.reset(self._token)
        return False


def _retry_after_ms_of(err) -> int | None:
    """The server's retry-after-ms pushback hint from an RPC error's
    trailing metadata (None when absent/unparseable — hints are advisory,
    a malformed one must never fail the failover path)."""
    get = getattr(err, "trailing_metadata", None)
    if get is None:
        return None
    try:
        md = get() if callable(get) else get
        for key, value in md or ():
            if key == _RETRY_AFTER_KEY:
                return max(int(value), 0)
    except Exception:  # noqa: BLE001 — advisory only
        return None
    return None


@dataclasses.dataclass
class PredictResult:
    """predict()'s return shape in partial-results mode.

    `scores` holds the merged candidates of every shard that ANSWERED, in
    host order; `missing_ranges` are the [start, end) candidate ranges of
    shards whose failover chain exhausted (empty when nothing failed);
    `degraded` flags the partial case so callers cannot mistake a reduced
    candidate set for a full ranking."""

    scores: np.ndarray
    missing_ranges: tuple[tuple[int, int], ...] = ()
    degraded: bool = False


class _StreamIncompleteError(Exception):
    """A PredictStream ended cleanly without covering the request — a
    server bug or a mid-stream connection teardown grpc surfaced as a
    normal end. Duck-types the AioRpcError surface (code()/details()) so
    the shard machinery treats it like any reroutable backend failure."""

    def __init__(self, detail: str):
        super().__init__(detail)
        self._detail = detail

    def code(self):
        return grpc.StatusCode.UNAVAILABLE

    def details(self) -> str:
        return self._detail


class _ShardAttemptError(Exception):
    """Internal: one failed shard attempt, tagged with the backend that
    failed it (the failover loop and hedge arbiter route on this)."""

    def __init__(self, host_idx: int, code, details: str,
                 retry_after_ms: int | None = None):
        super().__init__(details)
        self.host_idx = host_idx
        self.code = code  # grpc.StatusCode-like (has .name)
        self.details = details
        # Server pushback hint (overload plane): the failover backoff
        # waits at least this long before the next attempt.
        self.retry_after_ms = retry_after_ms

    @property
    def code_name(self) -> str:
        return getattr(self.code, "name", str(self.code))


@dataclasses.dataclass
class PreparedRequest:
    """A logical request pre-sharded and pre-serialized to wire bytes.

    For hot candidate sets that are re-scored continuously (the reference's
    own benchmark re-sends ONE payload for all 6,000 requests,
    DCNClient.java:208-210), building + serializing the half-MB
    PredictRequest per call is pure re-work — on a single-core client it is
    a real share of the whole request budget.
    prepare() hoists it out of the loop; predict_prepared() sends the cached
    bytes through the raw-bytes stub. The wire bytes are identical to
    predict()'s.

    Under placement="affinity" the blobs are the
    per-HOME row groups instead of the contiguous split: `homes[i]` is
    blob i's affine backend and `index_groups[i]` its original row
    indices, so predict_prepared scatters the merged scores back into
    candidate order exactly like predict() does. Both None = the
    contiguous split (positional shard i -> host i)."""

    shard_blobs: list[bytes]
    candidates: int
    homes: "tuple[int, ...] | None" = None
    index_groups: "tuple | None" = None


# Failures worth rerouting to another backend: the host is down/slow/
# shedding. Deterministic request errors (INVALID_ARGUMENT, NOT_FOUND)
# would fail identically everywhere and never retry.
_FAILOVER_CODES = frozenset({"UNAVAILABLE", "DEADLINE_EXCEEDED", "RESOURCE_EXHAUSTED"})


def compact_payload(
    arrays: dict[str, np.ndarray], vocab_size: int
) -> dict[str, np.ndarray]:
    """Pre-apply the server's own first transforms client-side so the wire
    carries half the bytes: int64 ids -> folded int32 (exact mod, the
    server's host fold; models re-fold idempotently) and f32 weights ->
    bf16 (the models' compute-dtype cast, round-to-nearest-even both
    sides). Scores are bit-identical to the wide encoding — the packed
    device bytes are the same — while the 516 KB reference request becomes
    258 KB. The transport is a large share of a single-core client's
    request budget, so this is the client knob with the largest
    throughput effect; the server accepts it via the compact-wire widening
    in service._decode_and_validate.

    numpy has no bfloat16 dtype here, so the weights come back as
    `codec.BF16Bits`: uint16 bit patterns (codec.bf16_bits, the host
    pack's round-to-nearest-even) that encode as DT_BFLOAT16, byte for
    byte the tensor an ml_dtypes bfloat16 array gives."""
    from .. import native

    out = {}
    for k, v in arrays.items():
        if k == "feat_ids" and v.dtype == np.int64:
            # The server's own canonical fold (native one-pass when built).
            out[k] = native.fold_ids(v, vocab_size)
        elif k == "feat_wts" and v.dtype == np.float32:
            # ONLY the weights input: other float inputs (DLRM
            # dense_features) are consumed in f32 by the models and the
            # server rejects them in bf16 (service widening gate).
            out[k] = codec.bf16_bits(v)
        else:
            out[k] = v
    return out


def build_predict_request(
    arrays: dict[str, np.ndarray],
    model_name: str,
    signature_name: str = "serving_default",
    output_filter: tuple[str, ...] = (),
    version: int | None = None,
    version_label: str | None = None,
    use_tensor_content: bool = True,
) -> apis.PredictRequest:
    if version is not None and version_label is not None:
        raise ValueError(
            "version and version_label are a oneof upstream; choose one"
        )
    req = apis.PredictRequest()
    req.model_spec.name = model_name
    req.model_spec.signature_name = signature_name
    if version is not None:
        req.model_spec.version.value = version
    if version_label is not None:
        req.model_spec.version_label = version_label
    for key, arr in arrays.items():
        # In-place into the map entry: skips CopyFrom's second half-MB copy.
        codec.from_ndarray(arr, use_tensor_content=use_tensor_content, out=req.inputs[key])
    req.output_filter.extend(output_filter)
    return req


class ShardedPredictClient:
    """Async fan-out over a fixed backend host list.

    With one host this degenerates to a plain client (the DCNClientSimple
    role); with several it is the reference's multi-backend scatter/gather.
    """

    def __init__(
        self,
        hosts: list[str],
        model_name: str = "DCN",
        signature_name: str = "serving_default",
        output_key: str = "prediction_node",
        timeout_s: float = 10.0,
        use_tensor_content: bool = True,
        channels_per_host: int = 1,
        full_async: bool = True,
        failover_attempts: int = 0,
        version_label: str | None = None,
        channel_credentials: "grpc.ChannelCredentials | None" = None,
        scoreboard: "BackendScoreboard | bool | None" = None,
        hedge_delay_s: float = 0.0,
        backoff_initial_s: float = 0.05,
        backoff_max_s: float = 2.0,
        partial_results: bool = False,
        health_probe: bool = False,
        keepalive_time_ms: int = 10_000,
        keepalive_timeout_ms: int = 5_000,
        score_cache=None,
        criticality: str = "",
        stream_chunk_candidates: int = 0,
        max_attempts_total: int = 0,
        score_wire_int8: bool = False,
        placement: str = "contiguous",
        integrity_checksums: bool = False,
    ):
        if not hosts:
            raise ValueError("need at least one backend host")
        if placement not in ("contiguous", "affinity"):
            raise ValueError(
                f"placement must be 'contiguous' or 'affinity', got {placement!r}"
            )
        self.hosts = list(hosts)
        self.model_name = model_name
        self.signature_name = signature_name
        # Route by version label ("stable"/"canary") instead of latest —
        # the server resolves it per request, so a label retarget flips
        # this client's traffic with no reconnect.
        self.version_label = version_label
        self.output_key = output_key
        self.timeout_s = timeout_s
        self.use_tensor_content = use_tensor_content
        # full_async=True fans the per-shard RPCs out concurrently (the
        # reference's default CompletableFuture mode, DCNClient.java:27,
        # 146-159); False issues them sequentially in host order — the
        # legacy mode's *scheduling* without replicating its out-of-order
        # merge laxity (merge order stays pinned either way).
        self.full_async = full_async
        # Beyond the reference (whose async mode let a dead host kill the
        # load thread, DCNClient.java:158-159): a shard whose home backend
        # fails with a reroutable status retries on the next host(s), up
        # to this many extra attempts. Results stay keyed by SHARD index,
        # so the host-order merge semantics are untouched. 0 = reference
        # fail-fast behavior.
        self.failover_attempts = max(0, failover_attempts)
        # --- resilience layer (client/health.py) --------------------------
        # scoreboard=True builds a default BackendScoreboard; an instance is
        # used as-is (tests inject a deterministic clock); None/False keeps
        # the blind next-host rotation.
        if scoreboard is True:
            scoreboard = BackendScoreboard(self.hosts)
        self.scoreboard: BackendScoreboard | None = scoreboard or None
        # Hedged shard RPCs: after this delay with no answer, fire a second
        # attempt on another healthy host — first answer wins, the loser is
        # cancelled. 0 = off. Tames the sick-backend tail at the cost of
        # bounded duplicate work (the hedge only exists while the primary
        # is already slower than the healthy-path p99 ought to be).
        self.hedge_delay_s = max(0.0, hedge_delay_s)
        # Jittered exponential backoff BETWEEN failover attempts: a backend
        # failing under overload (RESOURCE_EXHAUSTED) must not receive the
        # whole fleet's synchronized retry storm. Jitter is 0.5x-1.5x from
        # an ENTROPY-seeded RNG — a fixed seed would hand every client the
        # same draw sequence and re-synchronize the storm; tests that need
        # determinism set backoff_initial_s=0 or replace _jitter.
        self.backoff_initial_s = max(0.0, backoff_initial_s)
        self.backoff_max_s = max(self.backoff_initial_s, backoff_max_s)
        self._jitter = random.Random()
        # Partial-result mode: a shard whose failover chain exhausts yields
        # a DEGRADED merge (PredictResult.missing_ranges) instead of
        # failing the whole request — every shard failing still raises.
        self.partial_results = partial_results
        # Half-open ejected backends get a grpc.health.v1 Check before any
        # real traffic when enabled (needs a scoreboard to matter).
        self.health_probe = health_probe
        # Optional client-local score cache (cache/score_cache.py — the
        # SAME core the server's batcher uses, device-free): an exact repeat
        # of a recent predict() is answered without any RPC at all. OFF by
        # default; pass a ScoreCache instance, or True for defaults.
        # Degraded (partial) merges are NEVER cached — a reduced candidate
        # set must not masquerade as the full ranking on later hits — and
        # version-label routing rides the key, so a label retarget is only
        # served stale within the cache's TTL (size it accordingly, or
        # flush on retarget).
        if score_cache is True:
            from ..cache import ScoreCache

            score_cache = ScoreCache()
        self.score_cache = score_cache or None
        # Criticality lane (overload plane): sent as x-dts-criticality
        # metadata on every RPC. "critical" / "default" / "sheddable" —
        # overloaded servers running [overload] shed sheddable traffic
        # first. "" (default) sends nothing; the server treats absent as
        # "default".
        self.criticality = str(criticality or "").strip().lower()
        # Streamed Predict: default sub-batch size hint sent as
        # x-dts-stream-chunk on predict_streamed() RPCs (0 = server
        # default). First-scores latencies are tracked per streamed shard
        # (bounded ring) — the number streaming exists to improve.
        self.stream_chunk_candidates = max(int(stream_chunk_candidates or 0), 0)
        # Retry budget: cap on TOTAL backend
        # attempts per logical request across failover hops + hedges +
        # streamed reroutes. A replica recovering from a device failure
        # answers UNAVAILABLE while quarantined; without a cap, every
        # client's failover × hedging could multiply one request into a
        # fleet-wide retry storm against the survivors. Each shard's
        # first attempt is always allowed; the budget bounds the rest.
        # 0 = unlimited (historical behavior).
        self.max_attempts_total = max(int(max_attempts_total or 0), 0)
        # Candidate placement policy. "contiguous" = the reference's
        # positional split. "affinity": each candidate ROW routes to the backend its
        # canonical row digest jump-hashes to (cache/digest.py row
        # identity), so a hot row always lands on the same replica's
        # warm score cache instead of re-scoring on every replica. The
        # affine backend is the group's HOME in the existing failover
        # machinery, so the scoreboard still steers a group away while
        # its home is ejected/busy/rebuilding, and results scatter back
        # into the original candidate order (bit-identical to the
        # contiguous split's merge). Covers EVERY client entry point
        # (the server's row-granular cache is what
        # the routing warms): predict() routes groups live,
        # predict_streamed() streams each group from its home (chunk
        # offsets are group-relative, so the offset-scatter merge
        # composes unchanged), and prepare()/predict_prepared() serialize
        # per-group blobs with their homes + row indices pinned on the
        # PreparedRequest.
        self.placement = placement
        # int8 score response wire: opt into DT_INT8 score
        # tensors (+ scale/min sidecar outputs, dequantized locally) via
        # x-dts-score-wire metadata — 4x fewer response bytes per score
        # against a server with [kernels] int8_score_wire on; servers
        # without the plane ignore the metadata and answer normally.
        self.score_wire_int8 = bool(score_wire_int8)
        # Integrity wire checksums: stamp x-dts-input-crc
        # CRC32C sidecars over each shard's tensor bytes (an
        # [integrity]-armed server verifies at decode and fails ONLY the
        # corrupted request), and verify the server's x-dts-score-crc
        # response stamps BEFORE the merge — a mismatch is recorded
        # kind="corrupt" on the scoreboard (steer + failover, never
        # ejection on the first hit) and the shard retries elsewhere.
        # Message-path predict() only; prepared-bytes requests skip the
        # input stamp (their bytes are frozen at prepare()) but still
        # verify responses. Servers without the plane ignore the
        # metadata and stamp nothing — both directions are advisory.
        self.integrity_checksums = bool(integrity_checksums)
        self._first_score_ms: list[float] = []
        # Per-backend rolling latency windows (the router's
        # /monitoring parity surface). None until enable_backend_windows
        # — the hot path pays one attribute read when disabled.
        self._backend_windows: dict[str, "object"] | None = None
        self.counters = ResilienceCounters()
        self._health_stubs: list[object | None] = [None] * len(self.hosts)
        # Long-lived plaintext channels per host, created once and shared
        # (DCNClient.java:118-125). channels_per_host > 1 stripes requests
        # over several HTTP/2 connections — one connection's flow-control
        # window throttles a half-MB-per-request load at high concurrency.
        self.channels_per_host = max(1, channels_per_host)
        opts = list(LARGE_MESSAGE_CHANNEL_OPTIONS)
        if keepalive_time_ms > 0:
            # keepalive_time_ms=0 opts out entirely — for channels toward
            # stock gRPC backends whose default ping-abuse policy (5-minute
            # min interval, 2 strikes) would GOAWAY a 10s pinger. The
            # in-tree servers carry KEEPALIVE_SERVER_OPTIONS and tolerate
            # these pings.
            opts += list(
                keepalive_channel_options(keepalive_time_ms, keepalive_timeout_ms)
            )
        # TLS when the server runs --ssl-config-file: pass
        # grpc.ssl_channel_credentials(root_certificates=..., [+ client key/
        # cert for mTLS]); None keeps the reference's plaintext channels.
        make_channel = (
            (lambda h: grpc.aio.secure_channel(h, channel_credentials, options=opts))
            if channel_credentials is not None
            else (lambda h: grpc.aio.insecure_channel(h, options=opts))
        )
        self._channels = [
            [make_channel(h) for _ in range(self.channels_per_host)]
            for h in self.hosts
        ]
        self._stubs = [
            [PredictionServiceStub(ch) for ch in per_host] for per_host in self._channels
        ]
        self._rr = 0

    async def close(self) -> None:
        for per_host in self._channels:
            for ch in per_host:
                await ch.close()

    async def __aenter__(self):
        return self

    async def __aexit__(self, *exc):
        await self.close()

    def request_overrides(
        self,
        *,
        criticality: str | None = None,
        timeout_s: float | None = None,
        traceparent: str | None = None,
        max_attempts_total: int | None = None,
    ) -> _OverrideScope:
        """Per-request overrides for ONE predict()/predict_streamed()/
        predict_prepared() call issued inside the returned context
        (the fleet router forwards each inbound RPC's deadline,
        x-dts-criticality, traceparent, and retry budget through its
        embedded client). Contextvar-scoped: every shard/hedge task of
        the wrapped call inherits the values; concurrent requests on the
        same client see only their own. None = keep the client-level
        attribute. With tracing on, `traceparent` remote-parents the
        wrapped call's `client.predict` root (the router's embedded
        client joins the `router.route` trace); with tracing
        off it forwards verbatim on the wire, so a router hop never
        breaks the edge's trace either way."""
        return _OverrideScope({
            "criticality": criticality,
            "timeout_s": timeout_s,
            "traceparent": traceparent,
            "max_attempts_total": max_attempts_total,
        })

    @staticmethod
    def _override(key: str):
        values = _OVERRIDES.get()
        return values.get(key) if values else None

    def _rpc_timeout(self) -> float:
        """Per-attempt RPC deadline: the request override (the router
        forwarding the edge's remaining deadline) when present, else the
        client attribute."""
        t = self._override("timeout_s")
        return float(t) if t else self.timeout_s

    async def _one_rpc(
        self, i: int, rr: int, host_idx: int, invoke,
        attempt: int = 0, hedge: bool = False, extra_md: tuple = (),
    ):
        """One attempt on one backend: fault site, scoreboard recording,
        error tagging. Raises _ShardAttemptError on failure. When tracing
        is on, each attempt is its own span (hedges and failover hops
        render as siblings) and carries a W3C traceparent in the gRPC
        metadata so the server's span tree joins this trace."""
        host = self.hosts[host_idx]
        stubs = self._stubs[host_idx]
        attrs = {"host": host, "attempt": attempt}
        if hedge:
            attrs["hedge"] = True
        with tracing.start_span("client.rpc", attrs=attrs) as span:
            md = []
            if span is not None:
                md.append(
                    ("traceparent",
                     tracing.make_traceparent(span.trace_id, span.span_id))
                )
            else:
                # No local span (tracing disarmed): a forwarded
                # traceparent override still rides through verbatim, so
                # a router hop never breaks the edge's trace.
                fwd_tp = self._override("traceparent")
                if fwd_tp:
                    md.append(("traceparent", fwd_tp))
            crit = self._override("criticality")
            if crit is None:
                crit = self.criticality
            if crit:
                md.append((_CRITICALITY_KEY, crit))
            if self.max_attempts_total:
                # Advertise the retry budget across the hop:
                # a fleet router caps its own attempt budget at
                # min(local, advertised).
                md.append((_RETRY_BUDGET_KEY, str(self.max_attempts_total)))
            if self.score_wire_int8:
                md.append((_SCORE_WIRE_KEY, "int8"))
            md.extend(extra_md)
            metadata = tuple(md) or None
            t0 = time.perf_counter()
            try:
                if faults.active():
                    # Named fault site (faults.py): a rule keyed on this host
                    # can delay/fail/wedge exactly one backend of the fan-out.
                    # Bounded by the RPC timeout so an injected WEDGE presents
                    # exactly like a hung backend does on the wire: this
                    # attempt dies DEADLINE_EXCEEDED after timeout_s.
                    try:
                        await asyncio.wait_for(
                            faults.fire_async("client.rpc", key=host),
                            timeout=self._rpc_timeout(),
                        )
                    except asyncio.TimeoutError:
                        raise faults.InjectedFaultError(
                            "client.rpc", "DEADLINE_EXCEEDED",
                            f"injected wedge at {host} outlived the RPC deadline",
                        ) from None
                # rr advances once per logical request (not per shard), so shard
                # i of request r lands on channel (r + i) % k: consecutive
                # requests stripe every host's channels even when the shard
                # count divides k.
                call = invoke(stubs[(rr + i) % len(stubs)], metadata)
                resp = await call
                if span is not None:
                    # Peer-role attribution: traced
                    # servers stamp x-dts-peer-role on their INITIAL
                    # metadata, so stitched trees label each hop
                    # router/replica without guessing from ports. The
                    # streamed invoke is a plain coroutine (no call
                    # object) — getattr-guarded, advisory only.
                    get_initial = getattr(call, "initial_metadata", None)
                    if get_initial is not None:
                        try:
                            for k, v in (await get_initial()) or ():
                                if k == _PEER_ROLE_KEY and isinstance(v, str):
                                    span.attrs["peer.role"] = v
                        except Exception:  # noqa: BLE001
                            pass
            except asyncio.CancelledError:
                if self.scoreboard is not None:
                    # The attempt resolved neither way: free any half-open
                    # probe slot this host_idx holds, or a recovered backend
                    # whose probe got cancelled (caller timeout, shutdown)
                    # would be skipped by steering forever.
                    self.scoreboard.release_probe(host_idx)
                raise
            except (
                grpc.aio.AioRpcError,
                faults.InjectedFaultError,
                _StreamIncompleteError,
            ) as e:
                code = e.code()
                code_name = getattr(code, "name", str(code))
                if span is not None:
                    span.attrs["code"] = code_name
                retry_after_ms = None
                if code_name == "RESOURCE_EXHAUSTED":
                    # Overload pushback: the backend ANSWERED (alive, just
                    # shedding). Pick up its retry-after-ms hint and record
                    # "busy" — never "dead" — on the scoreboard, so a
                    # shedding backend is steered around without consuming
                    # its ejection budget (the cascade fix: ejecting it
                    # would pile its traffic onto the remaining hosts and
                    # overload them next).
                    retry_after_ms = _retry_after_ms_of(e)
                    self.counters.pushbacks_received += 1
                    if span is not None and retry_after_ms:
                        span.attrs["retry_after_ms"] = retry_after_ms
                details = e.details() or ""
                rebuilding = (
                    code_name == "UNAVAILABLE" and _REBUILDING_MARKER in details
                )
                draining = (
                    code_name == "UNAVAILABLE" and _DRAINING_MARKER in details
                )
                if draining:
                    # Drain-aware hint: the backend
                    # ANSWERED with its GracefulShutdown refusal — it is
                    # leaving, not recovering. Flip it to the scoreboard's
                    # DRAINING state: steering skips it from this first
                    # hint (no more routed requests while an alternative
                    # exists), no ejection budget is spent, and the
                    # rebuilding retry window is never cycled.
                    self.counters.draining_hints += 1
                    if span is not None:
                        span.attrs["draining"] = True
                if rebuilding:
                    # Quarantine-aware hint: the
                    # backend ANSWERED with its own recovery-cycle
                    # announcement — it is alive and will be back in
                    # seconds (one recovery cycle). Mirror the
                    # pushback-is-not-death pattern: steer around it
                    # without consuming the consecutive-failure ejection
                    # budget (ejecting would hold traffic off for the
                    # full doubling ejection window after a sub-second
                    # rebuild, and a fleet-wide chaos event would cascade
                    # exactly like the overload case did).
                    self.counters.rebuilding_hints += 1
                    if span is not None:
                        span.attrs["rebuilding"] = True
                if self.scoreboard is not None:
                    if draining:
                        self.scoreboard.record_failure(
                            host_idx, kind="draining"
                        )
                    elif rebuilding:
                        self.scoreboard.record_failure(
                            host_idx, kind="rebuilding"
                        )
                    elif code_name == "RESOURCE_EXHAUSTED":
                        self.scoreboard.record_failure(
                            host_idx, kind="pushback",
                            retry_after_s=(
                                retry_after_ms / 1e3
                                if retry_after_ms else None
                            ),
                        )
                    elif code_name in _FAILOVER_CODES:
                        self.scoreboard.record_failure(host_idx)
                    else:
                        # A deterministic request error PROVES the backend is
                        # alive and answering — that is a health success.
                        self.scoreboard.record_success(
                            host_idx, time.perf_counter() - t0
                        )
                raise _ShardAttemptError(
                    host_idx, code, e.details(), retry_after_ms=retry_after_ms
                ) from e
            if self.integrity_checksums and hasattr(resp, "outputs"):
                # Response-direction wire integrity: verify
                # the server's score-CRC stamp BEFORE this shard's array
                # reaches the merge. Raises _ShardAttemptError
                # (UNAVAILABLE — a reroutable status) on mismatch, so
                # the failover loop retries the shard elsewhere; the
                # scoreboard takes the kind="corrupt" verdict inside.
                resp = await self._verify_response_integrity(
                    call, resp, host_idx
                )
            elapsed = time.perf_counter() - t0
            if self.scoreboard is not None:
                self.scoreboard.record_success(host_idx, elapsed)
            if self._backend_windows is not None:
                self._backend_windows[host].record(elapsed)
            return resp

    async def _verify_response_integrity(self, call, resp, host_idx: int):
        """Verify the x-dts-score-crc trailing-metadata stamp against the
        response's decoded tensor bytes. Absent stamp = server without
        the plane: advisory, pass through. Mismatch (or a payload that no
        longer decodes) = corrupt response: counted, recorded
        kind="corrupt", raised as a reroutable _ShardAttemptError."""
        # Named fault site (faults.py): response-direction wire
        # corruption — one payload bit of the score tensor flips AFTER
        # the server stamped its checksum, exactly what a bad NIC/switch
        # would do. key="response" distinguishes the direction from the
        # request-side per-input-name keys.
        if faults.active() and faults.get().has_site("wire_corrupt"):
            try:
                faults.fire("wire_corrupt", key="response")
            except faults.InjectedFaultError:
                if self.output_key in resp.outputs:
                    _flip_tensor_bytes(resp.outputs[self.output_key])
        sidecar = None
        get_trailing = getattr(call, "trailing_metadata", None)
        if get_trailing is not None:
            try:
                for k, v in (await get_trailing()) or ():
                    if k == _SCORE_CRC_KEY and isinstance(v, str):
                        sidecar = v
                        break
            except Exception:  # noqa: BLE001 — advisory metadata
                sidecar = None
        if not sidecar:
            return resp
        bad: list[str]
        try:
            stamped = codec.parse_crc_sidecar(sidecar)
            decoded = {
                name: codec.to_ndarray(resp.outputs[name])
                for name in stamped if name in resp.outputs
            }
            bad = codec.verify_crc_sidecar(decoded, sidecar)
        except codec.CodecError as e:
            # A stamped tensor that no longer decodes (or a mangled
            # sidecar) IS corruption — it must fail the verify, never
            # pass it.
            bad = [f"undecodable: {e}"]
        if bad:
            self.counters.corrupt_responses += 1
            if self.scoreboard is not None:
                self.scoreboard.record_failure(host_idx, kind="corrupt")
            raise _ShardAttemptError(
                host_idx, grpc.StatusCode.UNAVAILABLE,
                f"corrupt response: score checksum mismatch on {bad} "
                "(integrity wire verify)",
            )
        return resp

    def _hedge_target(self, used: list[int]) -> int | None:
        """Extra host for a hedged attempt: the scoreboard's best healthy
        candidate, or (scoreboard-less) the next host in rotation."""
        if self.scoreboard is not None:
            return self.scoreboard.hedge_target(exclude=tuple(used))
        n = len(self.hosts)
        for k in range(1, n):
            h = (used[0] + k) % n
            if h not in used:
                return h
        return None

    @staticmethod
    async def _first_success(pending: set):
        """First task to complete SUCCESSFULLY wins; _ShardAttemptErrors
        are tolerated while any task is still running (a primary failure
        lets the in-flight hedge finish — it is the de-facto failover).
        Returns the winning TASK; raises the first failure when every task
        failed. Cleanup (cancel + exception reaping) is the caller's."""
        first_exc: _ShardAttemptError | None = None
        while pending:
            done, pending = await asyncio.wait(
                pending, return_when=asyncio.FIRST_COMPLETED
            )
            for t in done:
                if t.cancelled():
                    continue
                exc = t.exception()
                if exc is None:
                    return t
                if isinstance(exc, _ShardAttemptError):
                    if first_exc is None:
                        first_exc = exc
                else:
                    raise exc
        raise first_exc  # every attempt failed

    async def _attempt(
        self, i: int, rr: int, host_idx: int, invoke, used: list[int],
        attempt: int = 0, budget: "_AttemptBudget | None" = None,
        extra_md: tuple = (),
    ):
        """One failover attempt, optionally hedged: the primary RPC runs on
        `host_idx`; after hedge_delay_s without an answer a second attempt
        fires on another healthy host — first ANSWER wins, the loser is
        cancelled. Hosts burned here are appended to `used` so the outer
        loop never re-tries them. A hedge is an OPTIONAL extra attempt,
        so it draws from the per-request retry budget when one is set."""
        if not self.hedge_delay_s or len(self.hosts) < 2:
            # No task wrapper: the coroutine is awaited inline, so an outer
            # cancellation (gather's sibling-cancel on another shard's
            # failure, a caller timeout) cancels the RPC itself instead of
            # orphaning a detached task.
            return await self._one_rpc(
                i, rr, host_idx, invoke, attempt=attempt, extra_md=extra_md
            )
        primary = asyncio.ensure_future(
            self._one_rpc(
                i, rr, host_idx, invoke, attempt=attempt, extra_md=extra_md
            )
        )
        tasks: dict = {primary: host_idx}
        try:
            done, _ = await asyncio.wait({primary}, timeout=self.hedge_delay_s)
            hedge = None
            if not done:
                hedge_idx = self._hedge_target(used)
                if hedge_idx is not None and (
                    budget is not None and not budget.take()
                ):
                    # Budget dry: the hedge is skipped (the primary keeps
                    # running — nothing is lost but the duplicate work).
                    self._note_budget_exhausted(budget)
                    hedge_idx = None
                if hedge_idx is not None:
                    used.append(hedge_idx)
                    self.counters.hedges_fired += 1
                    hedge = asyncio.ensure_future(
                        self._one_rpc(
                            i, rr, hedge_idx, invoke,
                            attempt=attempt, hedge=True, extra_md=extra_md,
                        )
                    )
                    tasks[hedge] = hedge_idx
            winner = await self._first_success(set(tasks))
            if winner is hedge:
                self.counters.hedges_won += 1
            return winner.result()
        finally:
            # Runs on EVERY exit — win, both-failed, outer cancellation:
            # cancel stragglers (freeing any half-open probe slot they
            # hold) and retrieve every finished task's exception so none
            # surfaces as 'Task exception was never retrieved'.
            for t, h in tasks.items():
                if not t.done():
                    t.cancel()
                    if self.scoreboard is not None:
                        self.scoreboard.release_probe(h)
            for t in tasks:
                if t.done() and not t.cancelled():
                    t.exception()
                else:
                    try:
                        await t
                    except BaseException:  # noqa: BLE001 — reaping only
                        pass

    async def _health_check(self, host_idx: int) -> str:
        """grpc.health.v1 Check on the host's first channel (overall server
        health, service \"\") — the cheap half-open probe that never costs a
        real request its latency. Returns "serving", "not_serving" (the
        server ANSWERED — alive but refusing, e.g. a recovery-cycle
        rebuild or warmup), "draining" (NOT_SERVING with the server's
        `x-dts-health-reason: draining` trailer — it is leaving, don't
        re-probe it on the rebuild cadence), "inconclusive" (no health
        service — the answer proves liveness), or "down"."""
        from ..proto import health as health_proto

        stub = self._health_stubs[host_idx]
        if stub is None:
            stub = self._health_stubs[host_idx] = health_proto.HealthStub(
                self._channels[host_idx][0]
            )
        try:
            call = stub.Check(
                health_proto.HealthCheckRequest(""),
                timeout=min(self.timeout_s, 2.0),
            )
            resp = await call
            trailing = await call.trailing_metadata()
        except grpc.aio.AioRpcError as e:
            if getattr(e.code(), "name", "") == "UNIMPLEMENTED":
                # Backend build without the health service: the answer
                # PROVES it is alive — inconclusive, so fall through to
                # the real-request probe instead of re-ejecting forever.
                return "inconclusive"
            return "down"
        except Exception:  # noqa: BLE001 — any other probe failure = down
            return "down"
        if resp.status == health_proto.SERVING:
            return "serving"
        reason = ""
        for k, v in trailing or ():
            if k == _HEALTH_REASON_KEY:
                reason = v
                break
        return "draining" if reason == "draining" else "not_serving"

    def _new_budget(self, shards: int) -> "_AttemptBudget | None":
        """Per-request attempt budget, or None when the knob is off.
        Each shard's first attempt is guaranteed (the request cannot run
        without it), so the pool holds max(max_attempts_total - shards,
        0) EXTRA attempts shared across failover hops and hedges. A
        router forwarding an edge client's x-dts-retry-budget caps the
        local knob at the advertised value via request_overrides — the
        fleet never multiplies the edge's retry intent."""
        forwarded = self._override("max_attempts_total")
        caps = [
            c for c in (self.max_attempts_total, forwarded)
            if c  # 0/None = knob off
        ]
        if not caps:
            return None
        return _AttemptBudget(min(int(c) for c in caps) - shards)

    def _note_budget_exhausted(self, budget: "_AttemptBudget") -> None:
        """Count one REQUEST's budget exhaustion (first trip only: every
        shard task and skipped hedge of the same request shares one
        budget, and the counter's contract is requests, not sites)."""
        if budget.tripped:
            return
        budget.tripped = True
        self.counters.retry_budget_exhausted += 1
        if self.scoreboard is not None:
            self.scoreboard.note_retry_budget_exhausted()

    async def _shard_call(
        self, i: int, rr: int, invoke, extract=None, budget=None,
        extra_md: tuple = (),
    ) -> np.ndarray:
        """One shard's RPC with failover: `invoke(stub, metadata)` issues
        the call on the chosen stub (message path uses stub.Predict,
        prepared-bytes path stub.PredictRaw, streamed path
        stub.PredictStream with an incremental merge inside invoke); host
        steering (scoreboard when present, blind rotation otherwise),
        hedging, jittered backoff, reroutable-status retry, and error
        wrapping are shared here so the paths cannot diverge. `extract`
        maps invoke's return value to the shard's score array (default:
        decode this client's output_key tensor from a PredictResponse —
        streamed invokes already return the merged ndarray). With tracing
        on, the shard gets a span whose children are the individual
        attempts (failover hops and hedges as siblings)."""
        with tracing.start_span("client.shard", attrs={"shard": i}):
            return await self._shard_call_impl(
                i, rr, invoke, extract, budget, extra_md
            )

    async def _shard_call_impl(
        self, i: int, rr: int, invoke, extract=None, budget=None,
        extra_md: tuple = (),
    ) -> np.ndarray:
        n = len(self.hosts)
        used: list[int] = []
        last: _ShardAttemptError | None = None
        for attempt in range(self.failover_attempts + 1):
            if attempt and budget is not None and not budget.take():
                # Per-request retry budget dry (failover hops + hedges +
                # streamed reroutes all drew from it): fail with the last
                # error instead of mounting another attempt — a
                # recovering replica must not face the whole fleet's
                # multiplied retries.
                self._note_budget_exhausted(budget)
                break
            if self.scoreboard is not None:
                host_idx = self.scoreboard.pick(i % n, exclude=tuple(used))
            else:
                host_idx = next(
                    (
                        h
                        for h in ((i + attempt + k) % n for k in range(n))
                        if h not in used
                    ),
                    None,
                )
            if host_idx is None:
                # Every host already burned (hedges count too): wrap around
                # and reuse the rotation — the pre-scoreboard failover
                # retried the same host (transient errors DO clear on
                # retry-with-backoff), and the attempt budget still bounds
                # total work. Both fallbacks always yield a host.
                host_idx = (
                    self.scoreboard.pick((i + attempt) % n)
                    if self.scoreboard is not None
                    else (i + attempt) % n
                )
            used.append(host_idx)
            try:
                # From here to the RPC the attempt may be CANCELLED (caller
                # timeout, a sibling shard's failure cancelling the gather)
                # while this host_idx holds a half-open probe slot pick()
                # just granted — the except below releases it, or the
                # backend would be steered around forever (_one_rpc covers
                # only its own await).
                if attempt:
                    # Exponential with 0.5x-1.5x jitter: retries decorrelate
                    # across clients instead of synchronizing into a storm.
                    sleep_s = 0.0
                    if self.backoff_initial_s:
                        base = min(
                            self.backoff_initial_s * (2 ** (attempt - 1)),
                            self.backoff_max_s,
                        )
                        sleep_s = base * (0.5 + self._jitter.random())
                    hint_ms = getattr(last, "retry_after_ms", None)
                    if hint_ms:
                        # Server pushback (overload plane): wait AT LEAST
                        # the retry-after-ms hint — the server sized it
                        # from its backlog's drain time, which it knows
                        # and this client can only guess. Capped by the
                        # operator's backoff ceiling; honored even with
                        # backoff disabled (the hint is the whole point
                        # of pushback).
                        sleep_s = max(
                            sleep_s, min(hint_ms / 1e3, self.backoff_max_s)
                        )
                        self.counters.retry_after_honored += 1
                    if sleep_s > 0:
                        self.counters.backoff_sleeps += 1
                        await asyncio.sleep(sleep_s)
                if (
                    self.health_probe
                    and self.scoreboard is not None
                    and self.scoreboard.state(host_idx) == HALF_OPEN
                ):
                    status = await self._health_check(host_idx)
                    if status == "draining":
                        # The server answered NOT_SERVING and NAMED the
                        # reason: GracefulShutdown drain. Flip straight to
                        # the DRAINING scoreboard state — steer away now,
                        # never cycle the rebuilding retry window on a
                        # replica that is leaving.
                        self.counters.draining_hints += 1
                        self.scoreboard.record_failure(
                            host_idx, kind="draining"
                        )
                        if last is None:
                            last = _ShardAttemptError(
                                host_idx,
                                grpc.StatusCode.UNAVAILABLE,
                                "health probe reported draining",
                            )
                        continue
                    if status == "not_serving":
                        # The server ANSWERED NOT_SERVING: alive but
                        # refusing — a recovery-cycle rebuild (or warmup).
                        # Mark it rebuilding (steer-around bias) instead
                        # of a probe FAILURE, whose doubled re-ejection
                        # would hold traffic off long after the ~seconds
                        # rebuild finished.
                        self.counters.rebuilding_hints += 1
                        self.scoreboard.record_failure(
                            host_idx, kind="rebuilding"
                        )
                        if last is None:
                            last = _ShardAttemptError(
                                host_idx,
                                grpc.StatusCode.UNAVAILABLE,
                                "health probe reported not serving",
                            )
                        continue
                    if status == "down":
                        # Probe says still down: re-eject (doubled interval)
                        # without burning a real RPC + timeout on it.
                        self.scoreboard.record_failure(host_idx)
                        if last is None:
                            last = _ShardAttemptError(
                                host_idx,
                                grpc.StatusCode.UNAVAILABLE,
                                "health probe did not answer",
                            )
                        continue
                resp = await self._attempt(
                    i, rr, host_idx, invoke, used, attempt=attempt,
                    budget=budget, extra_md=extra_md,
                )
            except asyncio.CancelledError:
                if self.scoreboard is not None:
                    self.scoreboard.release_probe(host_idx)
                raise
            except _ShardAttemptError as e:
                last = e
                if attempt < self.failover_attempts and e.code_name in _FAILOVER_CODES:
                    self.counters.failovers += 1
                    continue  # reroute this shard to the next host
                raise PredictClientError(
                    self.hosts[e.host_idx], e.code, e.details
                ) from e
            if extract is not None:
                return extract(resp)
            if self.score_wire_int8:
                tp = resp.outputs[self.output_key]
                if tp.dtype == codec.DataType.DT_INT8:
                    self.counters.int8_responses += 1
                return codec.dequantize_response_output(
                    resp.outputs, self.output_key
                )
            return codec.to_ndarray(resp.outputs[self.output_key])
        assert last is not None, "exhaustion implies at least one failure"
        raise PredictClientError(
            self.hosts[last.host_idx], last.code, last.details
        ) from last

    def enable_backend_windows(self, window_s: float = 60.0) -> None:
        """Arm per-backend rolling latency windows: every successful RPC
        records into its host's WindowedLatency (the fleet router turns
        this on so its /monitoring can show per-replica latency AS
        STEERED — hedges and failovers land on the host that answered)."""
        from ..utils.metrics import WindowedLatency

        self._backend_windows = {
            h: WindowedLatency(window_s=window_s) for h in self.hosts
        }

    def backend_window_snapshots(self) -> dict:
        """Per-backend window snapshots ({} until enabled)."""
        if self._backend_windows is None:
            return {}
        return {h: w.snapshot() for h, w in self._backend_windows.items()}

    def resilience_counters(self) -> dict:
        """Client-side resilience events + per-backend scoreboard state —
        the block a load harness reports."""
        out = dataclasses.asdict(self.counters)
        if self.scoreboard is not None:
            out["scoreboard"] = self.scoreboard.snapshot()
        return out

    def resilience_prometheus_text(self) -> str:
        """resilience_counters() as Prometheus text exposition (the client
        has no scrape port; harnesses write this next to their artifacts
        so fleet dashboards ingest hedging/failover/ejection state in the
        same format as the server plane)."""
        from ..utils.metrics import resilience_prometheus_text

        return resilience_prometheus_text(self.resilience_counters())

    async def _predict_shard(
        self, i: int, shard: dict[str, np.ndarray], rr: int, budget=None
    ) -> np.ndarray:
        req = build_predict_request(
            shard,
            self.model_name,
            self.signature_name,
            output_filter=(self.output_key,),
            version_label=self.version_label,
            use_tensor_content=self.use_tensor_content,
        )
        extra_md: tuple = ()
        if self.integrity_checksums:
            # Stamp the CRC32C sidecar over the shard's TRUE tensor
            # bytes first; the fault site below then corrupts the
            # encoded proto AFTER stamping — exactly the wire-flip
            # ordering the server-side verify exists to catch. key is
            # the input tensor name, so a rule can corrupt one input of
            # a multi-tensor request.
            extra_md = ((_INPUT_CRC_KEY, codec.crc_sidecar(shard)),)
            if faults.active() and faults.get().has_site("wire_corrupt"):
                for name in list(req.inputs):
                    try:
                        faults.fire("wire_corrupt", key=name)
                    except faults.InjectedFaultError:
                        _flip_tensor_bytes(req.inputs[name])
        return await self._shard_call(
            i, rr,
            lambda stub, metadata=None: stub.Predict(
                req, timeout=self._rpc_timeout(), metadata=metadata
            ),
            budget=budget,
            extra_md=extra_md,
        )

    async def _fan_out(
        self,
        shard_coros: list,
        sort_scores: bool,
        bounds: list[tuple[int, int]] | None = None,
    ) -> "np.ndarray | PredictResult":
        """Await the per-shard coroutines (concurrently or in host order),
        host-order merge, optional ascending sort (Collections.sort parity,
        DCNClient.java:195). In partial-results mode (`bounds` carries the
        per-shard candidate ranges) shards whose failover chain exhausted
        degrade the merge instead of failing it."""
        if bounds is not None:
            return await self._fan_out_partial(shard_coros, sort_scores, bounds)
        if len(shard_coros) == 1:
            # Degenerate fan-out: await the one RPC directly — gather()'s
            # task + future machinery costs several event-loop callbacks per
            # call for nothing (measurable on a single-core client).
            results = [await shard_coros[0]]
        elif self.full_async:
            results = await asyncio.gather(*shard_coros)
        else:
            results = []
            try:
                for c in shard_coros:
                    results.append(await c)
            except BaseException:
                # Close the not-yet-awaited tail so an early shard failure
                # never leaves "coroutine was never awaited" warnings.
                for c in shard_coros[len(results) + 1:]:
                    c.close()
                raise
        return self._merge(list(results), sort_scores)

    def _merge(self, results: list, sort_scores: bool, degraded: bool = False):
        """ONE merge+optional-sort implementation (traced as client.merge)
        for the full and partial fan-out paths."""
        attrs = {"degraded": True} if degraded else None
        with tracing.start_span("client.merge", attrs=attrs):
            merged = merge_host_order(results)
            if sort_scores:
                merged = self._rank_sort(merged)
        return merged

    def _rank_sort(self, merged: np.ndarray) -> np.ndarray:
        """Ranking sort with NaN pinned deterministically to the WORST
        end. np.sort puts NaN LAST in ascending
        order — the best-rank position under the Collections.sort-parity
        read (best scores at the end) — so an unscreened backend's NaN
        would silently outrank every real score. Real scores sort
        ascending as before (bit-identical when no NaN is present); NaNs
        land at the head, counted in nan_scores_merged."""
        if merged.dtype.kind == "f":
            nan = np.isnan(merged)
            if nan.any():
                k = int(nan.sum())
                self.counters.nan_scores_merged += k
                return np.concatenate([
                    np.full(k, np.nan, merged.dtype),
                    np.sort(merged[~nan]),
                ])
        return np.sort(merged)

    @staticmethod
    def _screen_shard_failures(results: list) -> list[int]:
        """Shared failure bookkeeping for the degraded-merge fan-outs
        (contiguous partial + affinity): re-raise anything that is not a
        per-shard RPC failure (a client bug or a cancellation must never
        be laundered into a degraded merge), raise the first error when
        EVERY shard failed (an empty result would read as 'zero
        candidates scored well'), and return the failed indices."""
        for r in results:
            if isinstance(r, BaseException) and not isinstance(r, PredictClientError):
                raise r
        failed = [k for k, r in enumerate(results) if isinstance(r, BaseException)]
        if failed and len(failed) == len(results):
            raise results[0]  # total outage: degraded mode has nothing to merge
        return failed

    def _note_degraded_merge(self, missing_ranges) -> None:
        """Shared degraded-merge accounting: the partial-response counter
        plus the root-span annotation (degraded merges are tail-kept by
        the recorder, so /tracez shows WHICH candidate ranges went
        missing)."""
        self.counters.partial_responses += 1
        root = tracing.current_span()
        if root is not None:
            root.attrs["degraded"] = True
            root.annotate(
                "degraded_merge",
                missing_ranges=[list(r) for r in missing_ranges],
            )

    async def _fan_out_partial(
        self, shard_coros: list, sort_scores: bool, bounds: list[tuple[int, int]]
    ) -> PredictResult:
        """Degraded-merge fan-out: failed shards become missing_ranges.
        Shards are awaited concurrently regardless of full_async — the
        sequential mode's early-abort semantics make no sense when failures
        are survivable."""
        results = await asyncio.gather(*shard_coros, return_exceptions=True)
        failed = self._screen_shard_failures(results)
        if not failed:
            return PredictResult(scores=self._merge(list(results), sort_scores))
        missing = tuple(bounds[k] for k in failed)
        self._note_degraded_merge(missing)
        merged = self._merge(
            [r for r in results if not isinstance(r, BaseException)],
            sort_scores, degraded=True,
        )
        return PredictResult(
            scores=merged, missing_ranges=missing, degraded=True,
        )

    def _cache_key(self, arrays: dict[str, np.ndarray], sort_scores: bool) -> tuple:
        """Client cache key: model + label route + (signature, output key,
        sort flag) + the same canonical feature digest the server cache
        uses. The client never knows the resolved version number, so the
        label (or "latest") is the version axis — the TTL bounds staleness
        across retargets. The sort flag is part of the output contract
        (the cached vector is stored exactly as it was returned)."""
        return self.score_cache.make_key(
            self.model_name,
            self.version_label or "latest",
            (self.signature_name, self.output_key, bool(sort_scores)),
            arrays,
        )

    def _cache_serve(self, scores: np.ndarray):
        """Shape a cached merged-score vector like a fresh predict()'s
        return: copied (callers own their result arrays), wrapped in a
        PredictResult when partial mode is on."""
        out = scores.copy()
        if self.partial_results:
            return PredictResult(scores=out)
        return out

    async def predict(
        self, arrays: dict[str, np.ndarray], sort_scores: bool = False
    ) -> "np.ndarray | PredictResult":
        """One logical request: shard -> concurrent RPCs -> host-order merge
        (-> ascending sort when ranking semantics are wanted). Returns a
        PredictResult (possibly degraded) when partial_results is on, the
        plain merged score vector otherwise. With tracing on, this is the
        ROOT span of the distributed trace — every shard RPC (and the
        server work it lands on) joins it via the injected traceparent.
        With a client score cache armed, an exact repeat of a recent
        request returns its merged scores with no RPC at all."""
        cache_key = None
        if self.score_cache is not None:
            cache_key = self._cache_key(arrays, sort_scores)
            hit = self.score_cache.lookup(cache_key)
            if hit is not None:
                return self._cache_serve(hit["scores"])
        result = await self._predict_uncached(arrays, sort_scores)
        if cache_key is not None:
            merged = result.scores if isinstance(result, PredictResult) else result
            degraded = isinstance(result, PredictResult) and result.degraded
            if not degraded:
                # NEVER fill from a degraded merge: a reduced candidate set
                # must not be served as the full ranking to later repeats.
                self.score_cache.fill(cache_key, {"scores": merged})
        return result

    async def _predict_uncached(
        self, arrays: dict[str, np.ndarray], sort_scores: bool
    ) -> "np.ndarray | PredictResult":
        if self.placement == "affinity" and len(self.hosts) > 1:
            return await self._predict_affinity(arrays, sort_scores)
        shards = shard_candidates(arrays, len(self.hosts))
        self._rr += 1
        rr = self._rr
        n = next(iter(arrays.values())).shape[0]
        bounds = (
            partition_bounds(n, len(shards)) if self.partial_results else None
        )
        with tracing.start_root(
            "client.predict",
            traceparent=self._override("traceparent"),
            attrs={"model": self.model_name, "candidates": n,
                   "shards": len(shards)},
        ):
            budget = self._new_budget(len(shards))
            return await self._fan_out(
                [
                    self._predict_shard(i, s, rr, budget)
                    for i, s in enumerate(shards)
                ],
                sort_scores,
                bounds=bounds,
            )

    async def _predict_affinity(
        self, arrays: dict[str, np.ndarray], sort_scores: bool
    ) -> "np.ndarray | PredictResult":
        """Key-affinity fan-out (placement="affinity"): rows grouped by
        the jump hash of their canonical row digest, each group sent to
        its affine backend as that group's HOME — the existing
        steering/failover machinery then applies unchanged (the
        scoreboard routes a group elsewhere while its home is ejected/
        busy/rebuilding; hedges/retry budget/backoff all compose).
        Results scatter back by original row index, so the merged vector
        is bit-identical to the contiguous split's. Groups are always
        awaited concurrently (the partial-merge precedent: sequential
        host-order issue has no meaning for content-addressed groups).

        In partial-results mode a group whose failover chain exhausts
        degrades the merge: the surviving rows come back in candidate
        order and the lost group's rows become missing_ranges (scattered
        rows encode as several small [start, end) runs)."""
        groups = affinity_groups(arrays, len(self.hosts))
        self._rr += 1
        rr = self._rr
        n = next(iter(arrays.values())).shape[0]
        with tracing.start_root(
            "client.predict",
            traceparent=self._override("traceparent"),
            attrs={"model": self.model_name, "candidates": n,
                   "shards": len(groups), "placement": "affinity"},
        ):
            budget = self._new_budget(len(groups))
            return await self._affinity_gather(
                [idx for _h, idx, _s in groups],
                [
                    self._predict_shard(host, sub, rr, budget)
                    for host, _idx, sub in groups
                ],
                n, sort_scores,
            )

    async def _affinity_gather(
        self, index_groups: list, coros: list, n: int, sort_scores: bool
    ) -> "np.ndarray | PredictResult":
        """ONE gather+scatter implementation for every affinity entry
        point (predict / predict_streamed / predict_prepared): await the
        per-group coroutines concurrently, scatter each group's scores
        back by its original row indices (bit-identical to the
        contiguous split's merge), and in partial-results mode degrade a
        lost group into scattered missing_ranges runs."""
        results = await asyncio.gather(*coros, return_exceptions=True)
        if not self.partial_results:
            for r in results:
                if isinstance(r, BaseException):
                    raise r
        failed = set(self._screen_shard_failures(results))
        ok = [
            (index_groups[k], np.asarray(results[k]))
            for k in range(len(results)) if k not in failed
        ]
        with tracing.start_span(
            "client.merge",
            attrs={"degraded": True} if failed else None,
        ):
            idx = np.concatenate([i for i, _v in ok])
            vals = np.concatenate([v for _i, v in ok])
            if failed:
                # Surviving rows in candidate order (the degraded-
                # merge contract: a shorter vector + missing_ranges).
                merged = vals[np.argsort(idx, kind="stable")]
            else:
                merged = np.empty((n,) + vals.shape[1:], vals.dtype)
                merged[idx] = vals
            if sort_scores:
                merged = self._rank_sort(merged)
        if not failed:
            if self.partial_results:
                return PredictResult(scores=merged)
            return merged
        missing = index_runs(
            np.concatenate([index_groups[k] for k in sorted(failed)])
        )
        self._note_degraded_merge(missing)
        return PredictResult(
            scores=merged, missing_ranges=missing, degraded=True,
        )

    # ------------------------------------------------- streamed Predict

    def _note_first_scores(self, ms: float) -> None:
        self._first_score_ms.append(ms)
        if len(self._first_score_ms) > 1024:  # bounded ring
            del self._first_score_ms[:512]

    def stream_stats(self) -> dict:
        """Streamed-Predict telemetry: shards/chunks consumed and the
        first-scores latency distribution — the number streaming exists
        to improve (first scores land when the FIRST sub-batch's readback
        finishes, decoupled from the slowest)."""
        lat = np.asarray(self._first_score_ms, np.float64)
        return {
            "streamed_shards": self.counters.streamed_shards,
            "stream_chunks": self.counters.stream_chunks,
            "first_score_samples": int(lat.size),
            "first_score_p50_ms": (
                round(float(np.percentile(lat, 50)), 3) if lat.size else None
            ),
            "first_score_p99_ms": (
                round(float(np.percentile(lat, 99)), 3) if lat.size else None
            ),
        }

    async def _predict_shard_stream(
        self, i: int, shard: dict[str, np.ndarray], rr: int,
        chunk: int | None, budget=None,
    ) -> np.ndarray:
        req = build_predict_request(
            shard,
            self.model_name,
            self.signature_name,
            output_filter=(self.output_key,),
            version_label=self.version_label,
            use_tensor_content=self.use_tensor_content,
        )
        n = next(iter(shard.values())).shape[0]
        chunk_n = (
            int(chunk) if chunk is not None else self.stream_chunk_candidates
        )

        async def invoke(stub, metadata=None):
            md = tuple(metadata or ())
            if chunk_n:
                md += (("x-dts-stream-chunk", str(chunk_n)),)
            merger = StreamingMerger(n)
            t0 = time.perf_counter()
            call = stub.PredictStream(
                req, timeout=self._rpc_timeout(), metadata=md or None
            )
            first_ms: float | None = None
            async for ch in call:
                merger.add(
                    ch.offset, codec.to_ndarray(ch.outputs[self.output_key])
                )
                if first_ms is None:
                    first_ms = (time.perf_counter() - t0) * 1e3
            if not merger.complete:
                # A clean end without full coverage: reroutable — the
                # failover/hedge machinery treats it like a dead backend.
                raise _StreamIncompleteError(
                    f"stream covered {merger.filled}/{n} candidates "
                    f"(missing {merger.missing_ranges()})"
                )
            # Telemetry commits only on a COMPLETE stream: a failed or
            # hedged-and-cancelled attempt must not pollute the headline
            # first-scores distribution or the chunk counters with work
            # whose merger was discarded.
            self.counters.streamed_shards += 1
            self.counters.stream_chunks += merger.chunks
            if first_ms is not None:
                self._note_first_scores(first_ms)
            return merger.result()

        return await self._shard_call(
            i, rr, invoke, extract=lambda r: r, budget=budget
        )

    async def predict_streamed(
        self, arrays: dict[str, np.ndarray], sort_scores: bool = False,
        chunk: int | None = None,
    ) -> "np.ndarray | PredictResult":
        """predict() over the server-streaming RPC: each shard rides
        PredictStream, merging sub-batch chunks incrementally as their
        readbacks complete server-side (chunks arrive out of order; the
        merge scatters by offset). Identical result semantics to
        predict() — same host-order merge, optional sort, and (in
        partial-results mode) degraded merges with missing_ranges when a
        shard's failover chain exhausts. `chunk` overrides the
        per-sub-batch candidate count (None = this client's
        stream_chunk_candidates, 0 = the server's configured default).
        First-scores latency per shard lands in stream_stats().

        Under placement="affinity" each row GROUP streams from its home
        backend (the warm-cache routing covers the
        streamed path too): chunk offsets are relative to the group's own
        request, so the per-shard offset-scatter merge composes
        unchanged, and the merged groups scatter back into candidate
        order exactly like predict()."""
        self._rr += 1
        rr = self._rr
        n = next(iter(arrays.values())).shape[0]
        if self.placement == "affinity" and len(self.hosts) > 1:
            groups = affinity_groups(arrays, len(self.hosts))
            with tracing.start_root(
                "client.predict",
                traceparent=self._override("traceparent"),
                attrs={"model": self.model_name, "candidates": n,
                       "shards": len(groups), "streamed": True,
                       "placement": "affinity"},
            ):
                budget = self._new_budget(len(groups))
                return await self._affinity_gather(
                    [idx for _h, idx, _s in groups],
                    [
                        self._predict_shard_stream(host, sub, rr, chunk, budget)
                        for host, _idx, sub in groups
                    ],
                    n, sort_scores,
                )
        shards = shard_candidates(arrays, len(self.hosts))
        bounds = (
            partition_bounds(n, len(shards)) if self.partial_results else None
        )
        with tracing.start_root(
            "client.predict",
            traceparent=self._override("traceparent"),
            attrs={"model": self.model_name, "candidates": n,
                   "shards": len(shards), "streamed": True},
        ):
            budget = self._new_budget(len(shards))
            return await self._fan_out(
                [
                    self._predict_shard_stream(i, s, rr, chunk, budget)
                    for i, s in enumerate(shards)
                ],
                sort_scores,
                bounds=bounds,
            )

    def prepare(self, arrays: dict[str, np.ndarray]) -> PreparedRequest:
        """Shard + build + serialize once; returns the reusable wire bytes
        for predict_prepared (see PreparedRequest). Under
        placement="affinity" the split is the per-home row grouping:
        each blob carries one backend's affine rows
        with its home + original row indices pinned on the result, so the
        prepared-bytes path routes rows to warm caches too."""

        def _blob(s: dict) -> bytes:
            return build_predict_request(
                s,
                self.model_name,
                self.signature_name,
                output_filter=(self.output_key,),
                version_label=self.version_label,
                use_tensor_content=self.use_tensor_content,
            ).SerializeToString()

        n = next(iter(arrays.values())).shape[0]
        if self.placement == "affinity" and len(self.hosts) > 1:
            groups = affinity_groups(arrays, len(self.hosts))
            return PreparedRequest(
                shard_blobs=[_blob(sub) for _h, _idx, sub in groups],
                candidates=n,
                homes=tuple(h for h, _idx, _s in groups),
                index_groups=tuple(idx for _h, idx, _s in groups),
            )
        shards = shard_candidates(arrays, len(self.hosts))
        return PreparedRequest(shard_blobs=[_blob(s) for s in shards], candidates=n)

    async def _predict_shard_raw(
        self, i: int, blob: bytes, rr: int, budget=None
    ) -> np.ndarray:
        return await self._shard_call(
            i, rr,
            lambda stub, metadata=None: stub.PredictRaw(
                blob, timeout=self._rpc_timeout(), metadata=metadata
            ),
            budget=budget,
        )

    async def predict_prepared(
        self, prep: PreparedRequest, sort_scores: bool = False
    ) -> "np.ndarray | PredictResult":
        """predict() over pre-serialized shard bytes: identical wire traffic
        and merge/sort semantics (including partial-results degradation),
        none of the per-call build+serialize. An affinity-prepared request
        (prepare() under placement="affinity") sends each blob to its
        pinned home backend and scatters the scores back by the pinned row
        indices — the warm-cache routing covers the prepared path too."""
        self._rr += 1
        rr = self._rr
        if prep.homes is not None:
            with tracing.start_root(
                "client.predict",
                traceparent=self._override("traceparent"),
                attrs={"model": self.model_name,
                       "candidates": prep.candidates,
                       "shards": len(prep.shard_blobs), "prepared": True,
                       "placement": "affinity"},
            ):
                budget = self._new_budget(len(prep.shard_blobs))
                return await self._affinity_gather(
                    list(prep.index_groups),
                    [
                        self._predict_shard_raw(home, b, rr, budget)
                        for home, b in zip(prep.homes, prep.shard_blobs)
                    ],
                    prep.candidates, sort_scores,
                )
        bounds = (
            partition_bounds(prep.candidates, len(prep.shard_blobs))
            if self.partial_results
            else None
        )
        with tracing.start_root(
            "client.predict",
            traceparent=self._override("traceparent"),
            attrs={"model": self.model_name, "candidates": prep.candidates,
                   "shards": len(prep.shard_blobs), "prepared": True},
        ):
            budget = self._new_budget(len(prep.shard_blobs))
            return await self._fan_out(
                [
                    self._predict_shard_raw(i, b, rr, budget)
                    for i, b in enumerate(prep.shard_blobs)
                ],
                sort_scores,
                bounds=bounds,
            )


def client_from_config(cfg) -> ShardedPredictClient:
    """ShardedPredictClient from a utils.config.ClientConfig — every
    reference knob (DCNClient.java:25-40) lands on the matching client
    parameter, including the sync/async mode flag."""
    from .health import ScoreboardConfig

    scoreboard = (
        BackendScoreboard(
            list(cfg.hosts),
            ScoreboardConfig(
                failure_threshold=cfg.ejection_failures,
                ejection_s=cfg.ejection_interval_s,
            ),
        )
        if cfg.health_scoreboard
        else None
    )
    return ShardedPredictClient(
        list(cfg.hosts),
        model_name=cfg.model_name,
        signature_name=cfg.signature_name,
        output_key=cfg.output_key,
        timeout_s=cfg.timeout_s,
        use_tensor_content=cfg.use_tensor_content,
        full_async=cfg.full_async_mode,
        failover_attempts=cfg.failover_attempts,
        version_label=cfg.version_label or None,
        channel_credentials=_credentials_from_config(cfg),
        scoreboard=scoreboard,
        hedge_delay_s=cfg.hedge_delay_ms / 1e3,
        backoff_initial_s=cfg.backoff_initial_ms / 1e3,
        backoff_max_s=cfg.backoff_max_ms / 1e3,
        partial_results=cfg.partial_results,
        health_probe=cfg.health_probe,
        keepalive_time_ms=cfg.keepalive_time_ms,
        keepalive_timeout_ms=cfg.keepalive_timeout_ms,
        criticality=cfg.criticality,
        max_attempts_total=cfg.max_attempts_total,
        placement=cfg.placement,
        integrity_checksums=getattr(cfg, "integrity_checksums", False),
    )


def _credentials_from_config(cfg):
    """grpc.ssl_channel_credentials from the ClientConfig tls_* file paths
    (None when ALL unset — plaintext, the reference default). Any tls_*
    key set means the operator intended TLS: a partial identity pair is a
    config error, never a silent plaintext downgrade."""
    if not (cfg.tls_root_certs_file or cfg.tls_client_cert_file
            or cfg.tls_client_key_file):
        return None
    if bool(cfg.tls_client_key_file) != bool(cfg.tls_client_cert_file):
        raise ValueError(
            "tls_client_key_file and tls_client_cert_file must be set "
            "together (the mTLS identity pair); got key="
            f"{cfg.tls_client_key_file!r} cert={cfg.tls_client_cert_file!r}"
        )

    def read(path):
        return open(path, "rb").read() if path else None

    return grpc.ssl_channel_credentials(
        root_certificates=read(cfg.tls_root_certs_file),
        private_key=read(cfg.tls_client_key_file),
        certificate_chain=read(cfg.tls_client_cert_file),
    )


# Per-row stage provenance output a cascade-armed server appends to the
# response (serving/cascade.py): 1 = the row was pruned after stage 1 and
# carries its stage-1 score; 2 = the row survived and carries the full
# model's score. Rides the response like the int8-wire sidecars — an
# extra tensor beyond the signature, absent when the cascade is off.
CASCADE_STAGE_KEY = "cascade_stage"


def cascade_stage(response) -> "np.ndarray | None":
    """Per-row cascade provenance from a Predict response — accepts the
    raw PredictResponse proto or a decoded outputs dict (predict_sync's
    return). None when the server ran no cascade for this request.

    Note the fleet router tier merges SCORES across replica shards and
    re-encodes, so provenance survives only on direct replica responses.
    """
    outputs = getattr(response, "outputs", response)
    if CASCADE_STAGE_KEY not in outputs:
        return None
    value = outputs[CASCADE_STAGE_KEY]
    if isinstance(value, np.ndarray):
        return value
    return codec.to_ndarray(value)


def predict_sync(
    host: str,
    arrays: dict[str, np.ndarray],
    model_name: str = "DCN",
    signature_name: str = "serving_default",
    timeout_s: float = 10.0,
    version: int | None = None,
    version_label: str | None = None,
    channel_credentials: "grpc.ChannelCredentials | None" = None,
) -> dict[str, np.ndarray]:
    """Single-backend blocking Predict (the DCNClientSimple smoke role,
    DCNClientSimple.java:25-62) returning all outputs."""
    with (
        grpc.secure_channel(host, channel_credentials)
        if channel_credentials is not None
        else grpc.insecure_channel(host)
    ) as ch:
        stub = PredictionServiceStub(ch)
        req = build_predict_request(
            arrays, model_name, signature_name,
            version=version, version_label=version_label,
        )
        resp = stub.Predict(req, timeout=timeout_s)
    return {k: codec.to_ndarray(v) for k, v in resp.outputs.items()}


# ------------------------------------------------------- label feedback


def label_keys(arrays: dict[str, np.ndarray]) -> list[str]:
    """Per-candidate join keys for the server's label-feedback plane
    (serving/quality.py): a hex digest of each row's canonical feature
    bytes, computed over the EXACT arrays this client sends — the server
    computes the same digest over the arrays it decodes, so the keys meet
    in the middle with no id plumbing through the Predict protocol.
    Compute over the same encoding you send (a compact_payload request
    needs keys over the compact arrays)."""
    from ..cache.digest import row_label_keys

    return row_label_keys(arrays)


def report_label(
    rest_base_url: str,
    key: str | list[str],
    label: float | list[float],
    ts: float | None = None,
    timeout_s: float = 5.0,
) -> dict:
    """Report outcome labels to a server's label-feedback plane
    (POST /labelz on the REST surface, serving/quality.py): the
    client-side half of the windowed-AUC/calibration loop. `key` is a
    per-row digest from label_keys() (or a trace id, optionally
    `#<row>`); a key and its BINARY label (0/1 — the AUC ranks exact
    class membership) pair positionally when lists are given. `ts` is
    the label EVENT's epoch time, feeding the server's feedback-delay
    telemetry (never window membership). Returns the server's
    {"joined": n, "orphaned": m} — an orphaned label means the server
    no longer holds (or never sampled) that key's score. Blocking,
    stdlib-only (urllib): label feedback is an offline/batch path, not
    the serving hot path."""
    import json as json_mod
    import urllib.request

    keys = key if isinstance(key, (list, tuple)) else [key]
    labels = label if isinstance(label, (list, tuple)) else [label]
    if len(keys) != len(labels):
        raise ValueError(
            f"{len(keys)} keys vs {len(labels)} labels — they pair positionally"
        )
    items = [
        {"id": str(k), "label": float(lb),
         **({"ts": float(ts)} if ts is not None else {})}
        for k, lb in zip(keys, labels)
    ]
    req = urllib.request.Request(
        rest_base_url.rstrip("/") + "/labelz",
        data=json_mod.dumps({"labels": items}).encode("utf-8"),
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=timeout_s) as resp:
        return json_mod.loads(resp.read().decode("utf-8"))
