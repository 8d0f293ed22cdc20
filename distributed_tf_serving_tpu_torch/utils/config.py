"""TOML config: the [server], [batching], [transport], [model], [kernels],
[observability], [cache], [overload], [integrity], [cascade],
[utilization], [quality], [lifecycle], [recovery], [client], [fleet],
[slo], [mesh] and [elastic] sections the port reads, the checks of the
model-config entries, and the mapping of a tensorflow_model_server
batching-parameters file onto [server].

The JAX package's config files load unchanged. What changes no result
here is ignored with one log line: the transfer knobs of [server].
[overload] drain_grace_s feeds the shutdown drain whether or not the plane
is on. A section or key the JAX package does not know either raises, as
there.
"""

from __future__ import annotations

import dataclasses
import logging
import pathlib
import tomllib
from typing import Any


log = logging.getLogger("dts_torch.config")

# The readback wire dtypes `[server] output_wire_dtype` may name (their
# torch dtypes: ops/transfer.py). This module imports no torch, so the
# client and the fleet router load their configs without it.
OUTPUT_WIRE_DTYPES = ("float32", "bfloat16", "float16", "int8")


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """Serving frontend + batcher knobs."""

    host: str = "0.0.0.0"
    port: int = 9999
    max_workers: int = 16
    model_kind: str = "dcn_v2"
    model_name: str = "DCN"
    num_fields: int = 43
    buckets: tuple[int, ...] = (32, 64, 128, 256, 512, 1024, 2048, 4096)
    max_wait_us: int = 200
    # Threads that wait for a batch's readback, slice it per request and
    # complete the futures.
    completion_workers: int = 4
    # How many assembled batches may be staged for the device stage,
    # counting the one it runs (min 1: assembly and device stage in
    # turn). The [batching] section's pipeline_depth, when nonzero, wins.
    pipeline_depth: int = 2
    queue_capacity_candidates: int | None = None
    # The legacy mesh knobs: 0 = single device; > 0 = shard over the first
    # n devices, model_parallel of them per vocab shard, with
    # tensor_parallel the dense weights split too. The [mesh] section is
    # the serving mode; build_stack refuses both at once.
    mesh_devices: int = 0
    model_parallel: int = 1
    tensor_parallel: bool = False
    # Warm a loaded version before it serves: the bucket ladder, then the
    # version's own assets.extra/tf_serving_warmup_requests records.
    warmup: bool = True
    # Version-label routing (tensorflow_model_server's version_labels map:
    # "stable"/"canary" -> version number). TOML: version_labels = {stable
    # = 2, canary = 3}; stored as sorted (label, version) pairs so the
    # frozen config stays hashable.
    version_labels: tuple[tuple[str, int], ...] = ()
    # Version-watcher knobs (--model-base-path), named for their
    # tensorflow_model_server flags: --file_system_poll_wait_seconds and
    # --max_num_load_retries (retries AFTER the first attempt).
    file_system_poll_wait_seconds: float = 5.0
    max_num_load_retries: int = 2
    # Readback wire dtype: float32 outputs are downcast on the device
    # before the D2H copy and widened back to float32 on the host.
    # "float32" = no downcast (bit-exact); "bfloat16" / "float16" halve the
    # readback bytes; "int8" quarters them (affine, range/508 worst case).
    output_wire_dtype: str = "float32"
    # > 0: a single-request batch that asked for exactly the score output
    # reads back only its top-k (score, index) pairs; the host rebuilds the
    # full-length vector with 0.0 off the head. 0 = off.
    output_top_k: int = 0
    # Sampled request logging (tensorflow_model_server's LoggingConfig):
    # PredictionLog TFRecords usable directly as warmup files
    # (serving/request_log.py). "" = off.
    request_log_file: str = ""
    request_log_sampling: float = 0.01
    # Multi-model serving (tensorflow_model_server's --model_config_file):
    # a text-format ModelServerConfig whose model_config_list entries each
    # get a version watcher (name, base_path, model_platform = the family,
    # version_labels). "" = the single-model modes.
    model_config_file: str = ""

    def __post_init__(self):
        for name in ("completion_workers", "pipeline_depth"):
            v = getattr(self, name)
            if not isinstance(v, int) or isinstance(v, bool) or v < 1:
                raise ValueError(f"[server] {name} must be a positive integer, got {v!r}")
        if self.output_wire_dtype not in OUTPUT_WIRE_DTYPES:
            raise ValueError(f"unknown output wire dtype {self.output_wire_dtype!r}; have "
                             f"{sorted(OUTPUT_WIRE_DTYPES)}")
        v = self.output_top_k
        if not isinstance(v, int) or isinstance(v, bool) or v < 0:
            raise ValueError(f"[server] output_top_k must be a non-negative integer, got {v!r}")


@dataclasses.dataclass(frozen=True)
class ClientConfig:
    """Fan-out client + closed-loop bench knobs (the DCNClient constants)."""

    hosts: tuple[str, ...] = ("127.0.0.1:9999",)  # DCNClient.java:38
    model_name: str = "DCN"  # DCNClient.java:33
    signature_name: str = "serving_default"  # DCNClient.java:34
    output_key: str = "prediction_node"  # DCNClient.java:35
    num_fields: int = 43  # FIELD_NUM
    candidate_num: int = 1500  # DCNClient.java:29
    request_num: int = 1000  # DCNClient.java:30
    concurrent_num: int = 6  # DCNClient.java:31
    # DCNClient.java:27 — True: concurrent per-shard fan-out; False: shards
    # issued sequentially in host order (ShardedPredictClient.full_async).
    full_async_mode: bool = True
    sort_scores: bool = True  # the ranking sort, DCNClient.java:195
    timeout_s: float = 10.0
    use_tensor_content: bool = True
    # Beyond the reference: reroute a failed shard to the next host(s) on
    # UNAVAILABLE/DEADLINE_EXCEEDED/RESOURCE_EXHAUSTED, up to this many
    # extra attempts (0 = the reference's fail-fast behavior).
    failover_attempts: int = 0
    # Candidate-to-backend placement. "contiguous" = the reference's
    # positional split (DCNClient.java:46-55). "affinity" = rows route to backends by a
    # consistent (jump) hash of each row's canonical feature digest
    # (cache/digest.py row identity), so a hot candidate row always lands
    # on the same replica's warm score cache instead of being re-scored
    # everywhere; the scoreboard still steers a group away from its
    # affine backend while that backend is ejected/busy/rebuilding.
    placement: str = "contiguous"
    # Retry budget: cap on TOTAL backend attempts
    # per logical request across every shard's failover hops, hedges,
    # and streamed reroutes — one recovering/quarantined replica must
    # not be able to multiply a request into a fleet-wide retry storm.
    # Each shard's FIRST attempt is always allowed (the request needs
    # it); the budget bounds everything beyond. 0 = unlimited (the
    # historical behavior). Exhaustion counts as
    # `retry_budget_exhausted` in the scoreboard snapshot.
    max_attempts_total: int = 0
    # ---- resilience layer (client/health.py + client.py) -----------------
    # Per-backend scoreboard: EWMA latency + consecutive-failure ejection
    # with half-open probing; steers shard placement and failover rotation
    # away from ejected hosts.
    health_scoreboard: bool = False
    # Consecutive reroutable failures before a backend is ejected, and the
    # first ejection interval (doubles per failed half-open probe).
    ejection_failures: int = 3
    ejection_interval_s: float = 5.0
    # Hedged shard RPCs: fire a second attempt on another healthy host
    # after this delay; first answer wins, the loser is cancelled. 0 = off.
    hedge_delay_ms: int = 0
    # Jittered exponential backoff between failover attempts.
    backoff_initial_ms: int = 50
    backoff_max_ms: int = 2000
    # Exhausted shards degrade the merge (PredictResult.missing_ranges +
    # degraded flag) instead of failing the whole request.
    partial_results: bool = False
    # Half-open backends get a grpc.health.v1 Check before real traffic.
    health_probe: bool = False
    # HTTP/2 keepalive pings on the backend channels: a silently-dead
    # backend is detected in ~time+timeout instead of hanging until the
    # RPC deadline. 0 disables (for stock gRPC backends whose default
    # ping-abuse policy would GOAWAY a 10s pinger; the in-tree servers
    # tolerate it via KEEPALIVE_SERVER_OPTIONS).
    keepalive_time_ms: int = 10000
    keepalive_timeout_ms: int = 5000
    # Route by version label instead of latest ("" = unset; upstream
    # ModelSpec.version_label routing, e.g. "stable"/"canary").
    version_label: str = ""
    # Request criticality lane sent in gRPC metadata (x-dts-criticality):
    # "critical" / "default" / "sheddable". Overloaded servers running the
    # [overload] plane shed sheddable traffic first. "" = unset (servers
    # treat it as "default").
    criticality: str = ""
    # TLS toward an --ssl-config-file server ("" = plaintext). PATHS here
    # (unlike the server's inline-PEM textproto): client configs name the
    # deployed cert files. key+cert both set => mTLS identity.
    tls_root_certs_file: str = ""
    tls_client_key_file: str = ""
    tls_client_cert_file: str = ""
    # Integrity wire checksums: stamp x-dts-input-crc CRC32C
    # sidecars on requests and verify the server's x-dts-score-crc
    # response stamps before merging — a mismatch steers (scoreboard
    # kind="corrupt") and fails the shard over to another backend.
    # Advisory both ways: servers without [integrity] ignore/omit the
    # metadata.
    integrity_checksums: bool = False


@dataclasses.dataclass(frozen=True)
class BatchingConfig:
    """The [batching] section: the dispatch pipeline's depth, the in-flight
    window, the pad buffer ring and the PredictStream sub-batch split. The
    JAX package's fields, defaults, checks and messages."""

    # 0 = inherit [server] pipeline_depth; >= 1 otherwise.
    pipeline_depth: int = 0
    # Max live batches executing or awaiting their readback at once: at the
    # bound the dispatch thread waits for a completion before issuing the
    # next. 0 = unbounded.
    inflight_window: int = 0
    # Recycle the padded-batch host buffers of the batch.pad path (each
    # back once its batch's readback is done).
    buffer_ring: bool = False
    # Default candidates per PredictStream sub-batch (the server-side
    # split; a request's x-dts-stream-chunk metadata overrides it). 0 = no
    # split: PredictStream answers with one chunk.
    stream_chunk_candidates: int = 0

    def __post_init__(self):
        for name in ("pipeline_depth", "inflight_window", "stream_chunk_candidates"):
            v = getattr(self, name)
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                raise ValueError(
                    f"[batching] {name} must be a non-negative integer, "
                    f"got {v!r}"
                )
        if self.inflight_window and self.inflight_window > 64:
            raise ValueError(
                "[batching] inflight_window > 64 would pin that many "
                "batches of HBM at once; this is almost certainly a typo"
            )


@dataclasses.dataclass(frozen=True)
class TransportConfig:
    """The [transport] section: the Unix-domain-socket listener for
    co-located clients, and the reusable response-encode arenas."""

    # Also bind the gRPC server to this Unix-domain socket path, next to
    # the TCP port; co-located clients dial "unix:<path>". "" = TCP only.
    uds_path: str = ""
    # Encode responses (and decode Examples) through a per-thread
    # codec.EncodeArena, and reuse one PredictStreamChunk per stream,
    # instead of allocating per call.
    response_arena: bool = False

    def __post_init__(self):
        if self.uds_path:
            if not isinstance(self.uds_path, str):
                raise ValueError("[transport] uds_path must be a string")
            # The kernel's sockaddr_un limit is ~107 bytes: fail at parse,
            # not at bind time.
            if len(self.uds_path.encode()) > 100:
                raise ValueError(
                    "[transport] uds_path exceeds the AF_UNIX path limit "
                    f"(~107 bytes): {self.uds_path!r}"
                )
            if ":" in self.uds_path:
                raise ValueError(
                    "[transport] uds_path is a filesystem path, not a "
                    f"host:port or URI: {self.uds_path!r}"
                )


@dataclasses.dataclass(frozen=True)
class KernelsConfig:
    """Kernel/quantization plane knobs (ops/quantize.py, ops/autotune.py and
    the fused serve kernel): post-training int8 weight quantization and the
    fused serve step, each enabled per bucket only where the load-time
    autotune measured it faster than the baseline (model.apply on the float
    params) on this device AND it passed the accuracy gates. Off by
    default; off, the batcher reads one attribute per dispatch and serves
    as it does without the plane. Same fields and defaults as the JAX
    package's [kernels] section, but for the table file."""

    # Master switch: build a KernelManager, attach it to the batcher, and
    # run the autotune at load.
    enabled: bool = False
    # Candidate families the autotune considers.
    quantize: bool = True
    pallas: bool = True  # the fused serve kernel (the JAX package's name)
    # Measure at load; False serves only decisions adopted from table_file.
    autotune: bool = True
    # Measure and record everything, enable nothing.
    measure_only: bool = False
    # Decision-table persistence ("" disables it). Not the JAX package's
    # file: the two servers' tables would overwrite each other.
    table_file: str = "artifacts/kernel_autotune_torch.json"
    # Gates: speedup >= min_speedup AND max |dscore| vs the float baseline
    # <= max_abs_delta AND (with labeled eval data) |dAUC| <= auc_margin.
    min_speedup: float = 1.0
    max_abs_delta: float = 0.005
    auc_margin: float = 0.005
    # Timing iterations per (bucket, variant); 0 = auto (device-scaled).
    measure_iters: int = 0
    # Subset of the bucket ladder to tune; empty = the whole ladder.
    autotune_buckets: tuple[int, ...] = ()
    # The int8 score response wire: a Predict whose metadata carries
    # x-dts-score-wire: int8 gets its score tensor as DT_INT8 plus the
    # (scale, min) sidecars. Armed only by a built (enabled) plane, and per
    # server (PredictionServiceImpl.int8_score_wire).
    int8_score_wire: bool = False

    def __post_init__(self):
        for name in ("min_speedup", "max_abs_delta", "auc_margin"):
            v = getattr(self, name)
            if not isinstance(v, (int, float)) or isinstance(v, bool) or v <= 0:
                raise ValueError(f"[kernels] {name} must be a positive number, got {v!r}")
        if not isinstance(self.measure_iters, int) or \
                isinstance(self.measure_iters, bool) or self.measure_iters < 0:
            raise ValueError(
                "[kernels] measure_iters must be a non-negative integer, "
                f"got {self.measure_iters!r}"
            )
        for b in self.autotune_buckets:
            if not isinstance(b, int) or b <= 0:
                raise ValueError(
                    "[kernels] autotune_buckets must be positive integers, "
                    f"got {self.autotune_buckets!r}"
                )

    def build(self):
        """KernelManager per this config, or None when disabled."""
        from ..ops.autotune import KernelManager

        return KernelManager(self) if self.enabled else None


@dataclasses.dataclass(frozen=True)
class ObservabilityConfig:
    """The [observability] section: the per-request trace recorder behind
    GET /tracez (utils/tracing.py) and the rolling-window horizon of
    /monitoring and the Prometheus text (utils/metrics.py). The JAX
    package's fields, defaults and checks."""

    # Per-request span tracing (W3C traceparent propagation, /tracez,
    # Chrome-trace export). Off by default: every hook is then one global
    # bool read.
    tracing: bool = False
    # Retained local-root spans per ring (recent / error): the memory bound.
    trace_buffer: int = 256
    # Tail-sampling rate for unremarkable traces (errors and annotated
    # traces are always kept). 0.0 keeps only the tails; 1.0 keeps
    # everything the buffer holds.
    trace_sample_rate: float = 1.0
    # The slowest-N traces are always kept whatever the sampling.
    trace_slowest_n: int = 32
    # Rolling-window horizon of the sliding QPS and windowed p50/p99.
    window_seconds: float = 60.0
    # Span export to a fleet collector. It acts only through the fleet
    # plane's gossip port, which is not ported ([fleet] is refused); the
    # key loads, as in the JAX package.
    trace_export: bool = False
    trace_export_interval_s: float = 1.0

    def __post_init__(self):
        v = self.trace_export_interval_s
        if not isinstance(v, (int, float)) or isinstance(v, bool) or v <= 0:
            raise ValueError(
                "[observability] trace_export_interval_s must be a positive number, "
                f"got {v!r}"
            )

    def apply(self):
        """Switch this package's tracing plane to this config; returns the
        active TraceRecorder (or None when tracing stays off)."""
        from . import tracing as tracing_mod

        if not self.tracing:
            tracing_mod.disable()
            return None
        return tracing_mod.enable(
            buffer_size=self.trace_buffer,
            sample_rate=self.trace_sample_rate,
            slowest_n=self.trace_slowest_n,
        )


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """The [cache] section (cache/): the exact-match score cache with
    single-flight at the batcher's submit, the intra-batch duplicate
    collapse, and the row-granular score cache. The JAX package's fields
    and defaults. Everything is off by default, and `enabled` is the master
    switch: off, nothing is armed, whatever `dedup` or `row_granular` say."""

    # Build a ScoreCache and hand it to the batcher.
    enabled: bool = False
    # LRU capacity in entries and in cached-score bytes (whichever binds
    # first; split across the sharded locks).
    max_entries: int = 8192
    max_bytes: int = 64 << 20
    # Shelf life of an entry: CTR scores go stale with state that is not
    # in the request. A version swap invalidates at once whatever the TTL.
    ttl_s: float = 30.0
    # Single-flight: concurrent identical misses ride one computation.
    coalesce: bool = True
    # Intra-batch duplicate collapse: a batch's identical rows execute once.
    dedup: bool = False
    # Per-row score caching: a batch executes only its cold rows, in their
    # own bucket, and the cached rows are scattered back per request.
    row_granular: bool = False
    # The row tier's LRU bounds and shelf life.
    row_max_entries: int = 131072
    row_max_bytes: int = 32 << 20
    row_ttl_s: float = 30.0
    # Per-row single-flight: two batches sharing a cold row execute it once.
    row_coalesce: bool = True

    def build(self):
        """ScoreCache per this config, or None when disabled."""
        if not self.enabled:
            return None
        from ..cache import ScoreCache

        return ScoreCache(max_entries=self.max_entries, max_bytes=self.max_bytes,
                          ttl_s=self.ttl_s, coalesce=self.coalesce)

    def build_row(self):
        """RowScoreCache per this config, or None unless both `enabled`
        and `row_granular` are set."""
        if not (self.enabled and self.row_granular):
            return None
        from ..cache import RowScoreCache

        return RowScoreCache(max_entries=self.row_max_entries, max_bytes=self.row_max_bytes,
                             ttl_s=self.row_ttl_s, coalesce=self.row_coalesce)


@dataclasses.dataclass(frozen=True)
class OverloadConfig:
    """The [overload] section (serving/overload.py): the adaptive admission
    controller, criticality lanes, brownout stale-serve, and the drain
    grace of the shutdown. The JAX package's fields and defaults. Off, the
    batcher keeps its static queue_capacity_candidates bound and reads one
    attribute per submit."""

    # Build an AdmissionController and hand it to the batcher (replacing
    # the static queue_capacity_candidates check).
    enabled: bool = False
    # The controlled variable: the windowed queue-wait p99 is steered
    # toward this target by growing and shrinking the admission limit.
    target_queue_wait_ms: float = 50.0
    # The window the p99 is taken over, and the controller's tick.
    queue_wait_window_s: float = 10.0
    adjust_interval_s: float = 0.5
    # AIMD steps: additive growth under target, multiplicative shrink over.
    increase_candidates: int = 1024
    decrease_factor: float = 0.7
    # Limit clamp in candidates. 0 = auto: min one largest bucket, max the
    # static queue capacity the controller replaces.
    min_limit_candidates: int = 0
    max_limit_candidates: int = 0
    # EWMA smoothing of the per-candidate service time.
    service_ewma_alpha: float = 0.2
    # Refuse at enqueue when the backlog's estimated wait already exceeds
    # the request's remaining deadline.
    deadline_refusal: bool = True
    # Consecutive over-target ticks before NOMINAL->BROWNOUT and (further)
    # before BROWNOUT->SHED; consecutive under-target ticks per step down.
    brownout_after_intervals: int = 4
    shed_after_intervals: int = 12
    recover_after_intervals: int = 6
    # Past NOMINAL, cache entries up to this far past their TTL still
    # answer (marked degraded, never refilled). 0 disables it.
    stale_while_overloaded_s: float = 30.0
    # Clamp of the retry-after-ms hint on refusals.
    retry_after_floor_ms: int = 25
    retry_after_cap_ms: int = 2000
    # Shutdown drain grace (honored with the controller off too).
    drain_grace_s: float = 5.0

    def build(self):
        """AdmissionController per this config, or None when disabled."""
        if not self.enabled:
            return None
        from ..serving.overload import AdmissionController

        return AdmissionController(self)


@dataclasses.dataclass(frozen=True)
class IntegrityConfig:
    """The [integrity] section (serving/integrity.py): wire CRC32C
    sidecars, the readback screen and sampled bit-identity shadow
    verification, and the fleet router's two-replica audit
    (router_audit_fraction, read by fleet/router.py). The JAX package's
    fields, defaults and checks. Off by default: every
    hook is one attribute read and the served bytes are those of a stack
    without the plane."""

    # Build an IntegrityPlane and attach it to the impl and the batcher.
    enabled: bool = False
    # Verify x-dts-input-crc at decode (a mismatch fails that request alone,
    # INVALID_ARGUMENT) and stamp x-dts-score-crc on Predict responses.
    wire_checksums: bool = True
    # NaN/Inf screen of each request's score rows after the readback.
    screen: bool = True
    # Optional plausible interval the screen also enforces; (0, 0) = off.
    screen_min: float = 0.0
    screen_max: float = 0.0
    # Trips past this count inside screen_window_s escalate (suspect).
    screen_trips_per_window: int = 3
    screen_window_s: float = 10.0
    # Fraction of batches run a second time and compared bit for bit;
    # 0 = sampling off (POST /integrityz/audit still forces shadows).
    shadow_fraction: float = 0.0
    # Router tier: fraction of forwarded requests also sent to two
    # replicas and compared bit for bit; the minority of a disagreement
    # is marked suspect. 0 = off.
    router_audit_fraction: float = 0.0
    # Consecutive clean shadow compares that clear the suspect verdict.
    suspect_clear_passes: int = 3
    # Retained detection events (/integrityz `events`).
    history_events: int = 64

    def __post_init__(self):
        for name in ("screen_trips_per_window", "suspect_clear_passes", "history_events"):
            v = getattr(self, name)
            if not isinstance(v, int) or isinstance(v, bool) or v < 1:
                raise ValueError(f"[integrity] {name} must be a positive integer, got {v!r}")
        for name in ("shadow_fraction", "router_audit_fraction"):
            v = getattr(self, name)
            if not isinstance(v, (int, float)) or isinstance(v, bool) or not 0.0 <= v <= 1.0:
                raise ValueError(f"[integrity] {name} must be in [0, 1], got {v!r}")
        v = self.screen_window_s
        if not isinstance(v, (int, float)) or isinstance(v, bool) or v <= 0:
            raise ValueError(
                f"[integrity] screen_window_s must be a positive number, got {v!r}")
        for name in ("screen_min", "screen_max"):
            v = getattr(self, name)
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                raise ValueError(f"[integrity] {name} must be a number, got {v!r}")
        if self.screen_max < self.screen_min:
            raise ValueError(
                f"[integrity] screen_max ({self.screen_max!r}) must be >= "
                f"screen_min ({self.screen_min!r}); use (0, 0) to disable "
                "the range check"
            )

    def build(self):
        from ..serving.integrity import IntegrityPlane

        return IntegrityPlane(self)


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Fleet robustness plane knobs (fleet/ package): the
    cross-replica health gossip every member runs, and the shared rollout
    state the router (single writer) coordinates. The router process
    itself is `--router` / `python -m distributed_tf_serving_tpu_torch.fleet.router`
    over the SAME file: [server] is its bind address, [client] its
    backend list + steering knobs, [fleet] this section. Off by default;
    a disarmed replica pays one attribute read per hook."""

    # Master switch: start a GossipAgent next to the server and register
    # /fleetz.
    enabled: bool = False
    # Stable member name in gossip records. "" = derive from the gossip
    # listen address (fine for static fleets; set it when replicas sit
    # behind NAT or get respawned on new ports).
    self_id: str = ""
    # Address PEERS use to reach this member's gossip listener
    # ("host:port" or "unix:/path"). "" = the listener's own bind
    # address.
    advertise_addr: str = ""
    # Other members' gossip endpoints ("host:port" or "unix:/path").
    # Every member gossips with every listed peer each interval
    # (push-pull, so one live peer in common converges the fleet).
    peers: tuple[str, ...] = ()
    # Gossip listener bind. Port 0 = ephemeral (tests); production sets
    # a fixed port so peers can list it. gossip_uds switches the
    # listener (and dialing peers given as unix:...) to AF_UNIX.
    gossip_host: str = "127.0.0.1"
    gossip_port: int = 0
    gossip_uds: str = ""
    # Push-pull exchange cadence; fleet-wide convergence is one or two
    # intervals (record rides both the push and the response).
    gossip_interval_s: float = 0.5
    # A member silent this long is dropped from the view (SIGKILL with
    # no goodbye). Must exceed a few intervals or flaky peers flap.
    record_ttl_s: float = 5.0
    # Rollout coordination (fleet/rollout.py). Exactly ONE member — the
    # router — sets rollout_writer=true and owns the state file; every
    # other member follows the rollout state it sees in gossip.
    rollout_writer: bool = False
    # Where the writer persists rollout state (atomic rename). "" on
    # the writer = in-memory only (still distributed via gossip, lost
    # on router restart).
    rollout_state_file: str = ""

    def __post_init__(self):
        for name in ("gossip_interval_s", "record_ttl_s"):
            v = getattr(self, name)
            if not isinstance(v, (int, float)) or isinstance(v, bool) \
                    or v <= 0:
                raise ValueError(
                    f"[fleet] {name} must be a positive number, got {v!r}"
                )
        if not isinstance(self.gossip_port, int) or \
                isinstance(self.gossip_port, bool) or self.gossip_port < 0:
            raise ValueError(
                f"[fleet] gossip_port must be a non-negative integer, "
                f"got {self.gossip_port!r}"
            )
        if self.record_ttl_s <= self.gossip_interval_s:
            raise ValueError(
                "[fleet] record_ttl_s must exceed gossip_interval_s "
                f"(got ttl={self.record_ttl_s!r} <= "
                f"interval={self.gossip_interval_s!r}) — a member would "
                "expire between its own heartbeats"
            )


@dataclasses.dataclass(frozen=True)
class SloConfig:
    """SLO burn-rate monitor knobs (fleet/observability.py):
    the router's multi-window error-budget monitor over aggregated
    fleet telemetry, served at GET /sloz and as dts_tpu_slo_* series.
    Off by default; when on, a breach annotates in-flight router spans
    (`slo.burn`) so the tail sampler force-keeps explaining traces."""

    enabled: bool = False
    # Latency SLO: fraction of requests under latency_target_ms must
    # meet latency_objective.
    latency_target_ms: float = 50.0
    latency_objective: float = 0.99
    # Availability SLO: fraction of non-error requests.
    availability_objective: float = 0.999
    # Multi-window burn rates (Google SRE workbook shape): a page fires
    # only when BOTH the short and long window burn fast — short alone
    # is noise, long alone is stale.
    short_window_s: float = 300.0
    long_window_s: float = 3600.0
    # burn = bad_fraction / error_budget. 14.4x exhausts a 30-day
    # budget in 2 days (page); 6x in 5 days (ticket/warn).
    burn_threshold_fast: float = 14.4
    burn_threshold_slow: float = 6.0

    def __post_init__(self):
        for name in (
            "latency_target_ms", "short_window_s", "long_window_s",
            "burn_threshold_fast", "burn_threshold_slow",
        ):
            v = getattr(self, name)
            if not isinstance(v, (int, float)) or isinstance(v, bool) \
                    or v <= 0:
                raise ValueError(
                    f"[slo] {name} must be a positive number, got {v!r}"
                )
        for name in ("latency_objective", "availability_objective"):
            v = getattr(self, name)
            if not isinstance(v, (int, float)) or isinstance(v, bool) \
                    or not (0.0 < v < 1.0):
                raise ValueError(
                    f"[slo] {name} must be in (0, 1), got {v!r} — an "
                    "objective of 1.0 leaves zero error budget and "
                    "every burn rate divides by zero"
                )
        if self.long_window_s <= self.short_window_s:
            raise ValueError(
                "[slo] long_window_s must exceed short_window_s "
                f"(got long={self.long_window_s!r} <= "
                f"short={self.short_window_s!r}) — multi-window burn "
                "alerting needs distinct horizons"
            )


@dataclasses.dataclass(frozen=True)
class CascadeConfig:
    """The [cascade] section (serving/cascade.py): a cheap stage-1 servable
    prunes each eligible Predict on the device and the primary model ranks
    only the survivors. The JAX package's fields, defaults and checks. Off
    by default (one attribute read per Predict). build_stack refuses it
    beside output_top_k (its wire replaces the score vector the cascade
    fills)."""

    enabled: bool = False
    # The stage-1 servable's registry name: a normal model name.
    stage1_model: str = "stage1"
    # The family built for the stage-1 servable in process, when no
    # stage1_base_path supplies its versions (two_tower: the cheap scorer).
    stage1_kind: str = "two_tower"
    # A versioned base path a VersionWatcher serves stage 1 from; empty =
    # the in-process stage-1 servable.
    stage1_base_path: str = ""
    # Survivors: a fixed count when > 0, else this fraction of the request.
    survivor_k: int = 0
    survivor_fraction: float = 0.25
    # Survivors scoring below this at stage 1 are pruned too (0 = off;
    # applied after the top-k, so it only shrinks the ranked set).
    score_threshold: float = 0.0
    # Smaller requests skip the cascade (two submits would cost more).
    min_candidates: int = 8

    def __post_init__(self):
        if not self.stage1_model:
            raise ValueError("[cascade] stage1_model must be non-empty")
        if not isinstance(self.survivor_k, int) or isinstance(
            self.survivor_k, bool
        ) or self.survivor_k < 0:
            raise ValueError(
                "[cascade] survivor_k must be a non-negative int, got "
                f"{self.survivor_k!r}"
            )
        if not isinstance(self.survivor_fraction, (int, float)) or isinstance(
            self.survivor_fraction, bool
        ) or not (0.0 < self.survivor_fraction <= 1.0):
            raise ValueError(
                "[cascade] survivor_fraction must be in (0, 1], got "
                f"{self.survivor_fraction!r}"
            )
        if not isinstance(self.min_candidates, int) or isinstance(
            self.min_candidates, bool
        ) or self.min_candidates < 2:
            raise ValueError(
                "[cascade] min_candidates must be an int >= 2, got "
                f"{self.min_candidates!r} — a 1-candidate cascade prunes "
                "nothing and pays two submits"
            )
        if not isinstance(self.score_threshold, (int, float)) or isinstance(
            self.score_threshold, bool
        ) or self.score_threshold < 0.0:
            raise ValueError(
                "[cascade] score_threshold must be >= 0, got "
                f"{self.score_threshold!r}"
            )


@dataclasses.dataclass(frozen=True)
class UtilizationConfig:
    """The [utilization] section (serving/utilization.py): the occupancy
    ledger and gap waterfall behind GET /utilz, the `utilization` block of
    /monitoring, the dts_tpu_utilization_* series and the counter track of
    the Chrome export. The JAX package's fields and defaults. Off by
    default: every batcher hook is one attribute read."""

    # Build an OccupancyLedger and hand it to the batcher.
    enabled: bool = False
    # Bound on the retained batch intervals, idle gaps and waits (the
    # waterfall's memory and lookback).
    ring: int = 4096
    # The default waterfall window of /utilz and /monitoring.
    window_seconds: float = 60.0
    # A per-bucket device-step table ({bucket: us}, JSON) measured on the
    # card that serves, calibrating achieved_fraction_of_device_limit. "" =
    # uncalibrated (the busy fraction, labelled so in the waterfall).
    calibration_file: str = ""
    # Where POST /profilez/start writes its artifacts (the profiler's
    # Chrome trace and host_stacks.json). "" = a subfolder of the temp dir.
    profile_dir: str = ""

    def build(self):
        """The OccupancyLedger (registered as a counter-track source of the
        Chrome export), or None when disabled. profile_dir applies to the
        process-global capture slot either way: /profilez serves with or
        without the ledger."""
        from ..serving import utilization as util_mod

        if self.profile_dir:
            util_mod.profiler_capture().base_dir = self.profile_dir
        if not self.enabled:
            return None
        calibration = (util_mod.load_calibration(self.calibration_file)
                       if self.calibration_file else None)
        ledger = util_mod.OccupancyLedger(ring=self.ring, window_s=self.window_seconds,
                                          calibration=calibration)
        from . import tracing as tracing_mod

        tracing_mod.register_counter_source(ledger)
        return ledger


@dataclasses.dataclass(frozen=True)
class QualityConfig:
    """The [quality] section (serving/quality.py): per-(model, version)
    score sketches, PSI / JS drift against a pinned reference and between
    live versions, the /labelz label join (windowed AUC, calibration) and
    drift-linked trace exemplars. The JAX package's fields and defaults.
    Off by default: the completion worker reads one attribute per batch."""

    # Build a QualityMonitor and hand it to the batcher.
    enabled: bool = False
    # The fixed-bin histogram: CTR scores are sigmoid probabilities, so
    # [0, 1]; a score outside clamps into an edge bin.
    bins: int = 50
    range_lo: float = 0.0
    range_hi: float = 1.0
    # The rolling window of the drift math and the windowed AUC, and the
    # slices it is built from.
    window_seconds: float = 300.0
    slices: int = 6
    # A window PSI at or above this (against the reference or between live
    # versions) arms the exemplars.
    drift_threshold_psi: float = 0.2
    # How often the drift math runs (from the observe path, no thread), and
    # how many of the next traced requests get `quality.drift` per check
    # while drift stays above the threshold.
    drift_check_interval_s: float = 5.0
    exemplar_traces: int = 8
    # Window samples (each side) before a drift number is computed.
    min_drift_count: int = 50
    # The label join's bounds: reservoir keys (LRU; a label for an evicted
    # key counts as orphaned), joined pairs kept, and the largest request
    # whose rows get digest keys.
    reservoir_keys: int = 8192
    label_window: int = 8192
    digest_rows_limit: int = 256
    # The pinned-reference artifact: loaded at build when present, written
    # by POST /qualityz/snapshot. "" = pin only, no file.
    reference_file: str = "artifacts/quality_reference.json"

    def build(self):
        """The QualityMonitor, or None when disabled."""
        if not self.enabled:
            return None
        from ..serving.quality import QualityMonitor

        return QualityMonitor(
            bins=self.bins,
            lo=self.range_lo,
            hi=self.range_hi,
            window_s=self.window_seconds,
            slices=self.slices,
            drift_threshold_psi=self.drift_threshold_psi,
            drift_check_interval_s=self.drift_check_interval_s,
            exemplar_traces=self.exemplar_traces,
            min_drift_count=self.min_drift_count,
            reservoir_keys=self.reservoir_keys,
            label_window=self.label_window,
            digest_rows_limit=self.digest_rows_limit,
            reference_file=self.reference_file,
        )


@dataclasses.dataclass(frozen=True)
class RecoveryConfig:
    """The [recovery] section (serving/recovery.py): the watchdog that
    escalates the batcher's wedge clock into a quarantine, the in-process
    REINIT, the replay budget and the poisoned-input bisection thresholds.
    The JAX package's fields, defaults and checks, with one refusal:
    reinit_clear_backend = true (a CUDA context cannot be rebuilt in
    process). Off by default: each batcher hook reads one attribute."""

    # Build a RecoveryController and attach it to the batcher and the impl.
    enabled: bool = False
    # The watchdog's poll interval (a failure wakes it early).
    watchdog_interval_s: float = 0.5
    # A dispatched or in-flight batch outstanding this long quarantines the
    # replica: far below the circuit breaker's fail-fast bound (90 s). Also
    # the deadline of REINIT's context probe.
    wedge_quarantine_s: float = 15.0
    # Re-dispatches per work item over its whole life; past it the item
    # fails with the original device error.
    replay_budget: int = 8
    # A single-request batch that killed the executor this many times is
    # the poison: it alone fails (INVALID_ARGUMENT).
    poison_kills: int = 2
    # A multi-request batch whose members have this many kills is split in
    # halves instead of replayed whole.
    bisect_after_kills: int = 2
    # Re-warm every servable's bucket ladder through the queue after REINIT.
    reinit_warmup: bool = True
    rewarm_timeout_s: float = 120.0
    # The JAX package's backend teardown; refused here (__post_init__).
    reinit_clear_backend: bool = False
    # How long REPLAY waits for the requeued items before the cycle ends.
    replay_drain_s: float = 30.0
    # Bound on REINIT + REPLAY rounds in one cycle; past it the rest fail.
    max_cycle_rounds: int = 20
    # Transition events (and MTTR records) kept for /recoveryz.
    history_events: int = 64
    # "executor" (the default: a mesh executor recovers as one unit) or
    # "per_chip", which build_stack refuses over a mesh.
    scope: str = "executor"

    def __post_init__(self):
        if self.scope not in ("executor", "per_chip"):
            raise ValueError(
                f"[recovery] scope must be 'executor' or 'per_chip', got {self.scope!r}")
        for name in ("replay_budget", "poison_kills", "bisect_after_kills", "max_cycle_rounds"):
            v = getattr(self, name)
            if not isinstance(v, int) or isinstance(v, bool) or v < 1:
                raise ValueError(f"[recovery] {name} must be a positive integer, got {v!r}")
        for name in ("watchdog_interval_s", "wedge_quarantine_s", "replay_drain_s",
                     "rewarm_timeout_s"):
            v = getattr(self, name)
            if not isinstance(v, (int, float)) or isinstance(v, bool) or v <= 0:
                raise ValueError(f"[recovery] {name} must be a positive number, got {v!r}")
        if self.reinit_clear_backend:
            raise ValueError(
                "[recovery] reinit_clear_backend = true is refused: a CUDA context cannot be "
                "rebuilt in-process (after a sticky error every launch of the process fails); "
                "restart the process instead. REINIT probes the context and, when it is dead, "
                "holds the replica quarantined (serving/recovery.py)")


@dataclasses.dataclass(frozen=True)
class LifecycleConfig:
    """The [lifecycle] section (serving/lifecycle.py): the online fine-tune
    publisher, the canary admission ramp and the drift / AUC auto-rollback.
    The JAX package's fields and defaults. Off by default: a version
    resolution reads one attribute. Arming it needs --model-base-path (the
    watched versioned dir is both the publish target and the hot-swap
    mechanism) and [quality] enabled (the rollback gate reads its
    version-pair drift and per-version label AUC); build_stack refuses it
    otherwise."""

    # Build a LifecycleController and hand it to the impl.
    enabled: bool = False
    # The background thread's tick interval, also the spacing of the
    # opportunistic ticks on the routing path.
    tick_interval_s: float = 1.0
    # Canary admission ramp: a probe-lane-only warm phase, then a
    # deterministic share of default-lane traffic stepping up per dwell
    # until max_fraction.
    canary_probe_only_s: float = 10.0
    canary_initial_fraction: float = 0.05
    canary_ramp_step: float = 0.10
    canary_step_dwell_s: float = 10.0
    canary_max_fraction: float = 0.5
    # Promotion: healthy time at max fraction, with at least
    # min_canary_scores windowed canary scores.
    promote_after_s: float = 60.0
    min_canary_scores: int = 200
    # Rollback: version-pair PSI at or above rollback_psi, over
    # rollback_compare_bins merged bins (a small canary window's sampling
    # noise stays well under it), or a windowed label AUC drop of at least
    # rollback_auc_drop with min_auc_pairs joined on each side. The
    # rolled-back state holds rollback_hold_s before the next rollout.
    rollback_psi: float = 0.5
    rollback_compare_bins: int = 10
    rollback_auc_drop: float = 0.05
    min_auc_pairs: int = 100
    rollback_hold_s: float = 30.0
    # Fine-tune publisher: every interval (while IDLE), continue training
    # the stable servable on fresh rows and publish it as the next
    # version. 0 = off (canary and rollback still manage versions
    # published from outside).
    fine_tune_interval_s: float = 0.0
    fine_tune_steps: int = 200
    fine_tune_batch_size: int = 256
    fine_tune_learning_rate: float = 1e-4
    # Transition events kept for /lifecyclez.
    history_events: int = 64


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Mesh serving mode: shard serving over a ("data", "model") device
    mesh — candidate rows split over the data axis, embedding vocab over
    the model axis (parallel/mesh.py). Off by default: with the section
    absent serving is single-device.

    Arming it installs a parallel/executor.ShardedExecutor as the
    batcher's run_fn: same wire protocol, same client semantics, one
    process spanning N devices. Mode conflicts ([kernels], [recovery]
    scope = "per_chip", [cascade], the legacy [server] mesh knobs,
    output_top_k) are refused at build time — see build_stack."""

    # Master switch: construct the mesh and install the ShardedExecutor.
    enabled: bool = False
    # Devices in the mesh; 0 = every visible card. Must be divisible by
    # model_parallel (the ("data", "model") factorization).
    devices: int = 0
    # Devices sharding the embedding vocab (the EP axis); the rest of the
    # factorization shards candidates. 1 = pure candidate sharding.
    model_parallel: int = 1
    # Also shard dense MLP/cross weights over the model axis (the TP row;
    # embedding tables are vocab-sharded regardless).
    tensor_parallel: bool = False

    def __post_init__(self):
        for name in ("devices", "model_parallel"):
            v = getattr(self, name)
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                raise ValueError(
                    f"[mesh] {name} must be a non-negative integer, got {v!r}"
                )
        if self.model_parallel < 1:
            raise ValueError(
                f"[mesh] model_parallel must be >= 1, got {self.model_parallel!r}"
            )
        if self.devices and self.devices % self.model_parallel != 0:
            raise ValueError(
                f"[mesh] devices={self.devices} is not divisible by "
                f"model_parallel={self.model_parallel} (the mesh is the "
                "(devices/model_parallel, model_parallel) factorization)"
            )


@dataclasses.dataclass(frozen=True)
class ElasticConfig:
    """Elastic mesh serving (parallel/elastic.py): a ladder of ("data",
    "model") splits over the SAME devices, placed and warmed at load time,
    with a pressure-driven controller switching the serving split at
    runtime — hitlessly (in-flight batches on the old split drain behind
    the per-split in-flight barrier; new dispatches route to the target
    at once). Requires [mesh] enabled (the initial split IS the [mesh]
    factorization); off by default — with the section absent, mesh
    serving is the static mode."""

    # Master switch: build an ElasticMeshExecutor + ElasticController
    # instead of the static ShardedExecutor.
    enabled: bool = False
    # The split ladder, e.g. ["8x1", "4x2", "2x4"] (DATAxMODEL; every
    # entry must factorize the [mesh] device count). Empty = derived:
    # {n,1}, {n/2,2} (n even), and the [mesh] split. Sorted
    # throughput-first internally; "up" switches move toward the
    # data-parallel end.
    splits: tuple = ()
    # Controller cadence (opportunistic — ticked from dispatches and
    # monitoring scrapes, no thread; the overload plane's precedent).
    tick_interval_s: float = 0.5
    # Minimum time between switches (the anti-flap floor; also the time
    # the FIRST switch waits after arming).
    dwell_s: float = 5.0
    # Consecutive over/under ticks before a one-rung move. Down is
    # deliberately slower: relaxing parallelism is a latency nicety,
    # escalating it is a survival move.
    up_after_ticks: int = 2
    down_after_ticks: int = 6
    # Load-EWMA thresholds (queue fraction / bucket occupancy, max of
    # both): >= up counts an up tick even at NOMINAL pressure; <= down
    # (at NOMINAL) counts a down tick; between is the hysteresis band
    # (streaks reset, split holds).
    load_up_threshold: float = 0.75
    load_down_threshold: float = 0.20
    load_ewma_alpha: float = 0.3
    # Retained switch-history events (the /meshz ring).
    history_events: int = 64

    def __post_init__(self):
        for s in self.splits:
            d, sep, m = str(s).strip().lower().partition("x")
            if not sep or not d.isdigit() or not m.isdigit() \
                    or int(d) < 1 or int(m) < 1:
                raise ValueError(
                    f"[elastic] splits entry {s!r} is not 'DATAxMODEL' "
                    "with positive integer axes (e.g. '4x2')"
                )
        for name in ("tick_interval_s", "dwell_s", "load_ewma_alpha"):
            v = getattr(self, name)
            if not isinstance(v, (int, float)) or isinstance(v, bool) or v <= 0:
                raise ValueError(
                    f"[elastic] {name} must be a positive number, got {v!r}"
                )
        for name in ("up_after_ticks", "down_after_ticks", "history_events"):
            v = getattr(self, name)
            if not isinstance(v, int) or isinstance(v, bool) or v < 1:
                raise ValueError(
                    f"[elastic] {name} must be a positive integer, got {v!r}"
                )
        up, down = self.load_up_threshold, self.load_down_threshold
        for name, v in (("load_up_threshold", up), ("load_down_threshold", down)):
            if not isinstance(v, (int, float)) or isinstance(v, bool) \
                    or not 0.0 <= v <= 1.0:
                raise ValueError(
                    f"[elastic] {name} must be in [0, 1], got {v!r}"
                )
        if down >= up:
            raise ValueError(
                f"[elastic] load_down_threshold ({down}) must be below "
                f"load_up_threshold ({up}) — the gap IS the hysteresis "
                "band; equal thresholds would flap on every load wiggle"
            )
        if self.load_ewma_alpha > 1.0:
            raise ValueError(
                f"[elastic] load_ewma_alpha must be in (0, 1], got "
                f"{self.load_ewma_alpha!r}"
            )

# [server] keys of the JAX package that change no result here: the JAX
# runtime's transfer knobs, whose work the port's host path always does one
# way (one combined buffer, async readback, a dispatch thread).
_IGNORED_KEYS = {"server": ("compress_transfer", "async_readback", "pipelined_dispatch",
                            "donate_buffers")}
# The shutdown drain's grace when [overload] does not set it (seconds).
DRAIN_GRACE_S = 5.0


def _coerce(cls, data: dict[str, Any], section: str):
    fields = {f.name for f in dataclasses.fields(cls)}
    ignored = set(_IGNORED_KEYS.get(section, ()))
    unknown = sorted(set(data) - fields - ignored)
    if unknown:
        raise ValueError(f"unknown [{section}] keys: {unknown}")
    dropped = sorted(set(data) - fields)
    if dropped:
        log.info("ignoring [%s] keys that change nothing here: %s", section, dropped)
    kwargs = {}
    for key, value in data.items():
        if key not in fields:
            continue
        if isinstance(value, list):
            value = tuple(value)
        elif isinstance(value, dict) and key == "version_labels":
            # TOML inline table -> the hashable pair form.
            value = tuple(sorted((str(k), int(v)) for k, v in value.items()))
        kwargs[key] = value
    return cls(**kwargs)


def load_config(path) -> dict[str, Any]:
    """Parse a TOML file: {"server": ServerConfig, "batching":
    BatchingConfig, "transport": TransportConfig, "drain_grace_s": float,
    "model": ModelConfig, "kernels": KernelsConfig, "observability":
    ObservabilityConfig, "cache": CacheConfig, "overload": OverloadConfig,
    "integrity": IntegrityConfig, "cascade": CascadeConfig, "utilization":
    UtilizationConfig, "quality": QualityConfig, "lifecycle":
    LifecycleConfig, "recovery": RecoveryConfig, "client": ClientConfig,
    "fleet": FleetConfig, "slo": SloConfig, "mesh": MeshConfig, "elastic":
    ElasticConfig} ("model", "kernels", "observability", "cache",
    "overload", "integrity", "cascade", "utilization", "quality",
    "lifecycle", "recovery", "client", "fleet" and "slo" only when the file
    has that section; "mesh" and "elastic" always, disabled when absent, as
    in the JAX package). A nonzero [batching] pipeline_depth replaces the
    [server] one, as in the JAX package's server; "drain_grace_s" is
    [overload] drain_grace_s (honored with the plane off, as there). Raises
    ValueError on a section or key the JAX package does not know."""
    raw = tomllib.loads(pathlib.Path(path).read_text())
    known = {"server", "batching", "transport", "model", "kernels", "observability", "cache",
             "overload", "integrity", "cascade", "utilization", "quality", "lifecycle",
             "recovery", "client", "fleet", "slo", "mesh", "elastic"}
    unknown = sorted(set(raw) - known)
    if unknown:
        raise ValueError(f"unknown config sections: {unknown}")
    server = _coerce(ServerConfig, raw.get("server", {}), "server")
    batching = _coerce(BatchingConfig, raw.get("batching", {}), "batching")
    if batching.pipeline_depth:
        server = dataclasses.replace(server, pipeline_depth=batching.pipeline_depth)
    grace = raw.get("overload", {}).get("drain_grace_s", DRAIN_GRACE_S)
    if not isinstance(grace, (int, float)) or isinstance(grace, bool):
        raise ValueError(f"[overload] drain_grace_s must be a number, got {grace!r}")
    out: dict[str, Any] = {
        "server": server,
        "batching": batching,
        "transport": _coerce(TransportConfig, raw.get("transport", {}), "transport"),
        "drain_grace_s": float(grace),
        "mesh": _coerce(MeshConfig, raw.get("mesh", {}), "mesh"),
        "elastic": _coerce(ElasticConfig, raw.get("elastic", {}), "elastic"),
    }
    if "model" in raw:
        from ..models.base import ModelConfig

        out["model"] = _coerce(ModelConfig, raw["model"], "model")
    if "kernels" in raw:
        out["kernels"] = _coerce(KernelsConfig, raw["kernels"], "kernels")
    if "observability" in raw:
        out["observability"] = _coerce(ObservabilityConfig, raw["observability"],
                                       "observability")
    if "cache" in raw:
        out["cache"] = _coerce(CacheConfig, raw["cache"], "cache")
    if "overload" in raw:
        out["overload"] = _coerce(OverloadConfig, raw["overload"], "overload")
    if "integrity" in raw:
        out["integrity"] = _coerce(IntegrityConfig, raw["integrity"], "integrity")
    if "cascade" in raw:
        out["cascade"] = _coerce(CascadeConfig, raw["cascade"], "cascade")
    if "utilization" in raw:
        out["utilization"] = _coerce(UtilizationConfig, raw["utilization"], "utilization")
    if "quality" in raw:
        out["quality"] = _coerce(QualityConfig, raw["quality"], "quality")
    if "lifecycle" in raw:
        out["lifecycle"] = _coerce(LifecycleConfig, raw["lifecycle"], "lifecycle")
    if "recovery" in raw:
        out["recovery"] = _coerce(RecoveryConfig, raw["recovery"], "recovery")
    if "client" in raw:
        out["client"] = _coerce(ClientConfig, raw["client"], "client")
    if "fleet" in raw:
        out["fleet"] = _coerce(FleetConfig, raw["fleet"], "fleet")
    if "slo" in raw:
        out["slo"] = _coerce(SloConfig, raw["slo"], "slo")
    return out


def validate_model_config_entries(entries, source: str) -> list:
    """The shape checks of model_config_list entries (parsed ModelConfig
    messages), one rule set for the --model-config-file at startup and for
    HandleReloadConfigRequest: every entry has a name and a base_path, and
    no name repeats. Raises ValueError; returns the entries as a list."""
    seen = set()
    for mc in entries:
        if not mc.name or not mc.base_path:
            raise ValueError(
                f"{source}: every model config needs name and base_path "
                f"(got name={mc.name!r} base_path={mc.base_path!r})"
            )
        if mc.name in seen:
            raise ValueError(f"{source}: duplicate model {mc.name!r}")
        seen.add(mc.name)
    return list(entries)


def apply_batching_parameters(cfg: ServerConfig, bp) -> ServerConfig:
    """Map a parsed tensorflow_model_server BatchingParameters message (the
    --batching-parameters-file, read by serving/server.py) onto the
    ServerConfig's batcher knobs, as the JAX package does:

    - allowed_batch_sizes   -> the bucket ladder (when both are set, the
                               largest allowed size must equal
                               max_batch_size, the upstream rule);
    - max_batch_size        -> the top bucket (alone: the ladder's buckets
                               below it, then it);
    - batch_timeout_micros  -> max_wait_us;
    - max_enqueued_batches  -> queue_capacity_candidates (x the top bucket:
                               upstream bounds queued batches, the batcher
                               queued candidates);
    - num_batch_threads     -> completion_workers;
    - thread_pool_name, pad_variable_length_inputs: no analog, ignored with
      a log line."""
    updates: dict[str, Any] = {}
    max_batch = bp.max_batch_size.value if bp.HasField("max_batch_size") else None
    if max_batch is not None and max_batch <= 0:
        raise ValueError(f"max_batch_size must be positive, got {max_batch}")
    if bp.allowed_batch_sizes:
        buckets = tuple(sorted(int(b) for b in bp.allowed_batch_sizes))
        if any(b <= 0 for b in buckets):
            raise ValueError(f"allowed_batch_sizes must be positive, got {buckets}")
        if max_batch is not None and buckets[-1] != max_batch:
            raise ValueError(
                f"largest allowed_batch_sizes entry ({buckets[-1]}) must equal "
                f"max_batch_size ({max_batch}) — the upstream batching rule"
            )
        updates["buckets"] = buckets
    elif max_batch is not None:
        kept = tuple(b for b in cfg.buckets if b < max_batch)
        updates["buckets"] = kept + (int(max_batch),)
    if bp.HasField("batch_timeout_micros"):
        updates["max_wait_us"] = int(bp.batch_timeout_micros.value)
    if bp.HasField("max_enqueued_batches"):
        top = max_batch or (updates.get("buckets") or cfg.buckets)[-1]
        updates["queue_capacity_candidates"] = int(bp.max_enqueued_batches.value * top)
    if bp.HasField("num_batch_threads"):
        threads = int(bp.num_batch_threads.value)
        if threads <= 0:
            raise ValueError(f"num_batch_threads must be positive, got {threads}")
        updates["completion_workers"] = threads
    for field in ("thread_pool_name", "pad_variable_length_inputs"):
        if bp.HasField(field):
            log.info("batching parameter %s has no analog here; ignored", field)
    return dataclasses.replace(cfg, **updates)
