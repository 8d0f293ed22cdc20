"""Serving metrics: latency histograms, rolling windows, per-RPC counters,
and their /monitoring JSON and Prometheus text.

The core is a fixed-bucket log-scale histogram: O(1) record, percentiles
by interpolation inside the winning bucket, mergeable across RPCs. Each
RPC carries two horizons: LIFETIME aggregates (the totals dashboards
trend on) and a ROLLING WINDOW (sliding QPS and windowed p50/p99 over the
last `window_s` seconds), so `/monitoring` says what the server is doing
now instead of a lifetime average that decays toward 0 on an idle server.
Both carry per-model labels when the transport adapters pass the model
name. The metric names, the JSON and the text are the JAX package's, so
one dashboard reads both servers; the planes that are not ported yet emit
nothing here.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time

# Log-spaced bucket edges: 1us .. ~107s, 12.5% resolution.
_BASE_US = 1.0
_GROWTH = 1.125
_NUM_BUCKETS = 156


def _bucket_index(us: float) -> int:
    if us <= _BASE_US:
        return 0
    return min(int(math.log(us / _BASE_US, _GROWTH)) + 1, _NUM_BUCKETS - 1)


_EDGES_US = [_BASE_US * _GROWTH**i for i in range(_NUM_BUCKETS)]


def _percentile_ms(
    counts: list[int], total: int, min_us: float, max_us: float, q: float
) -> float:
    """q in [0, 100] over a consistent (counts, total) snapshot; linear
    interpolation inside the winning bucket. Shared by the lifetime
    histogram and the rolling-window slices (merged counts)."""
    if total == 0:
        return 0.0
    target = q / 100.0 * total
    acc = 0
    for i, c in enumerate(counts):
        if acc + c >= target and c > 0:
            lo = _EDGES_US[i - 1] if i > 0 else 0.0
            hi = _EDGES_US[i]
            frac = (target - acc) / c
            val = lo + (hi - lo) * frac
            return min(max(val, min_us), max_us) / 1e3
        acc += c
    return max_us / 1e3


class LatencyHistogram:
    """Log-bucketed latency histogram with percentile readout."""

    def __init__(self):
        self._counts = [0] * _NUM_BUCKETS
        self._total = 0
        self._sum_us = 0.0
        self._min_us = math.inf
        self._max_us = 0.0
        self._lock = threading.Lock()

    def record(self, seconds: float) -> None:
        us = seconds * 1e6
        with self._lock:
            self._counts[_bucket_index(us)] += 1
            self._total += 1
            self._sum_us += us
            self._min_us = min(self._min_us, us)
            self._max_us = max(self._max_us, us)

    @property
    def count(self) -> int:
        with self._lock:  # pairs count with the same instant's sums
            return self._total

    def mean_ms(self) -> float:
        # total and sum read under ONE lock: a snapshot racing a record()
        # must never pair a new count with an old sum.
        with self._lock:
            return self._sum_us / self._total / 1e3 if self._total else 0.0

    def _state(self) -> tuple[list[int], int, float, float, float]:
        """One consistent copy of the mutable state."""
        with self._lock:
            return (
                list(self._counts), self._total, self._sum_us,
                self._min_us, self._max_us,
            )

    def percentile_ms(self, q: float) -> float:
        counts, total, _sum_us, min_us, max_us = self._state()
        return _percentile_ms(counts, total, min_us, max_us, q)

    def snapshot(self) -> dict:
        # One locked copy feeds count/mean AND every percentile, so the
        # block is internally consistent even mid-record.
        counts, total, sum_us, min_us, max_us = self._state()
        return {
            "count": total,
            "mean_ms": round(sum_us / total / 1e3 if total else 0.0, 3),
            "p50_ms": round(_percentile_ms(counts, total, min_us, max_us, 50), 3),
            "p90_ms": round(_percentile_ms(counts, total, min_us, max_us, 90), 3),
            "p99_ms": round(_percentile_ms(counts, total, min_us, max_us, 99), 3),
        }

    def prometheus_buckets(self) -> tuple[list[tuple[float, int]], float, int]:
        """(cumulative (le_us, count) pairs, sum_us, total) for Prometheus
        histogram exposition. Trimmed past the last occupied bucket — the
        +Inf bucket the caller appends covers the remainder — so an idle
        RPC costs 1 line, not 156."""
        with self._lock:
            counts = list(self._counts)
            total, sum_us = self._total, self._sum_us
        last = max((i for i, c in enumerate(counts) if c), default=-1)
        out, acc = [], 0
        for i in range(last + 1):
            acc += counts[i]
            out.append((_EDGES_US[i], acc))
        return out, sum_us, total


class WindowedLatency:
    """Sliding-window latency + rate over the last `window_s` seconds.

    A ring of `slices` sub-histograms, each covering window_s/slices of
    wall time; record() lands in the current slice (lazily reset when its
    slot is reused), and readout merges only the slices still inside the
    window. O(1) record, bounded memory, no background thread — the
    standard cheap approximation to a true sliding window (granularity =
    one slice; with the 60s/6-slice default, 10s).
    """

    def __init__(
        self,
        window_s: float = 60.0,
        slices: int = 6,
        clock=time.monotonic,
    ):
        self.window_s = float(window_s)
        self.slices = max(2, int(slices))
        self.slice_s = self.window_s / self.slices
        self._clock = clock
        self._created = clock()
        self._lock = threading.Lock()
        self._counts = [[0] * _NUM_BUCKETS for _ in range(self.slices)]
        self._totals = [0] * self.slices
        self._sums_us = [0.0] * self.slices
        self._mins_us = [math.inf] * self.slices
        self._maxs_us = [0.0] * self.slices
        self._epochs = [-1] * self.slices  # which slice-epoch each slot holds

    def _slot(self, now: float) -> int:
        """Current slot index, reset if its epoch is stale. Caller holds
        the lock."""
        epoch = int(now / self.slice_s)
        idx = epoch % self.slices
        if self._epochs[idx] != epoch:
            self._epochs[idx] = epoch
            self._counts[idx] = [0] * _NUM_BUCKETS
            self._totals[idx] = 0
            self._sums_us[idx] = 0.0
            self._mins_us[idx] = math.inf
            self._maxs_us[idx] = 0.0
        return idx

    def record(self, seconds: float) -> None:
        us = seconds * 1e6
        with self._lock:
            idx = self._slot(self._clock())
            self._counts[idx][_bucket_index(us)] += 1
            self._totals[idx] += 1
            self._sums_us[idx] += us
            self._mins_us[idx] = min(self._mins_us[idx], us)
            self._maxs_us[idx] = max(self._maxs_us[idx], us)

    def _merged(self) -> tuple[list[int], int, float, float, float]:
        """Merge the in-window slices into one consistent histogram."""
        with self._lock:
            now = self._clock()
            current_epoch = int(now / self.slice_s)
            counts = [0] * _NUM_BUCKETS
            total, sum_us = 0, 0.0
            min_us, max_us = math.inf, 0.0
            for idx in range(self.slices):
                # In-window = one of the last `slices` epochs (the current
                # partial slice counts; the slot about to be recycled does
                # not).
                if current_epoch - self._epochs[idx] >= self.slices:
                    continue
                if self._epochs[idx] < 0:
                    continue
                sl = self._counts[idx]
                for i, c in enumerate(sl):
                    if c:
                        counts[i] += c
                total += self._totals[idx]
                sum_us += self._sums_us[idx]
                min_us = min(min_us, self._mins_us[idx])
                max_us = max(max_us, self._maxs_us[idx])
            return counts, total, sum_us, min_us, max_us

    def count(self) -> int:
        return self._merged()[1]

    def effective_window_s(self) -> float:
        """Rate divisor: the nominal window, shrunk while the recorder is
        YOUNGER than it (a server 8 s old serving 100 req/s must report
        ~100 qps, not 800/60) and floored at 1 s so a burst in the first
        milliseconds doesn't quote an absurd spike."""
        return min(self.window_s, max(self._clock() - self._created, 1.0))

    def qps(self) -> float:
        return self._merged()[1] / self.effective_window_s()

    def snapshot(self) -> dict:
        counts, total, sum_us, min_us, max_us = self._merged()
        return {
            "window_s": self.window_s,
            "count": total,
            "qps": round(total / self.effective_window_s(), 2),
            "mean_ms": round(sum_us / total / 1e3 if total else 0.0, 3),
            "p50_ms": round(_percentile_ms(counts, total, min_us, max_us, 50), 3),
            "p99_ms": round(_percentile_ms(counts, total, min_us, max_us, 99), 3),
        }

    # ------------------------------------------------------------ wire form
    # A merged window as JSON, to ship between processes: sparse bucket
    # counts keyed by bucket index (the edges are a shared constant on both
    # sides), so a whole window is a few dozen ints, and any number of
    # wires re-merge into one histogram with exact counts.

    def to_dict(self) -> dict:
        counts, total, sum_us, min_us, max_us = self._merged()
        return {
            "window_s": self.window_s,
            "effective_window_s": round(self.effective_window_s(), 3),
            "total": total,
            "sum_us": round(sum_us, 1),
            "min_us": None if total == 0 else round(min_us, 1),
            "max_us": round(max_us, 1),
            "buckets": {str(i): c for i, c in enumerate(counts) if c},
        }

    @staticmethod
    def from_dict(d: dict) -> tuple[list[int], int, float, float, float]:
        """Wire dict back to a merged-histogram state tuple — the same
        shape `_merged()` returns, so `_percentile_ms` works on it."""
        counts = [0] * _NUM_BUCKETS
        for k, c in (d.get("buckets") or {}).items():
            i = int(k)
            if 0 <= i < _NUM_BUCKETS:
                counts[i] += int(c)
        total = int(d.get("total") or 0)
        sum_us = float(d.get("sum_us") or 0.0)
        min_us = d.get("min_us")
        min_us = math.inf if min_us is None else float(min_us)
        max_us = float(d.get("max_us") or 0.0)
        return counts, total, sum_us, min_us, max_us

    @staticmethod
    def merge_dicts(wires: list[dict]) -> dict:
        """Sum several wire dicts into one. The merged rate uses each
        wire's own effective window: each reports its local qps, and the
        aggregate is the sum."""
        counts = [0] * _NUM_BUCKETS
        total, sum_us = 0, 0.0
        min_us, max_us = math.inf, 0.0
        window_s, eff_s, qps = 0.0, 0.0, 0.0
        for w in wires:
            c, t, s, mn, mx = WindowedLatency.from_dict(w)
            for i, v in enumerate(c):
                if v:
                    counts[i] += v
            total += t
            sum_us += s
            min_us = min(min_us, mn)
            max_us = max(max_us, mx)
            window_s = max(window_s, float(w.get("window_s") or 0.0))
            e = float(w.get("effective_window_s") or 0.0)
            eff_s = max(eff_s, e)
            if e > 0:
                qps += t / e
        return {
            "window_s": window_s,
            "effective_window_s": round(eff_s, 3),
            "total": total,
            "sum_us": round(sum_us, 1),
            "min_us": None if total == 0 else round(min_us, 1),
            "max_us": round(max_us, 1),
            "qps": round(qps, 3),
            "buckets": {str(i): c for i, c in enumerate(counts) if c},
        }

    @staticmethod
    def wire_stats(wire: dict) -> dict:
        """Human-facing summary of a wire dict (member or merged)."""
        counts, total, sum_us, min_us, max_us = WindowedLatency.from_dict(wire)
        eff = float(wire.get("effective_window_s") or 0.0)
        qps = wire.get("qps")
        if qps is None:
            qps = total / eff if eff > 0 else 0.0
        return {
            "count": total,
            "qps": round(float(qps), 3),
            "mean_ms": round(sum_us / total / 1e3 if total else 0.0, 3),
            "p50_ms": round(_percentile_ms(counts, total, min_us, max_us, 50), 3),
            "p99_ms": round(_percentile_ms(counts, total, min_us, max_us, 99), 3),
        }


@dataclasses.dataclass
class RpcMetrics:
    latency: LatencyHistogram = dataclasses.field(default_factory=LatencyHistogram)
    window: WindowedLatency = dataclasses.field(default_factory=WindowedLatency)
    ok: int = 0
    errors: int = 0


def escape_label_value(value) -> str:
    """Prometheus text-format 0.0.4 label-value escaping: backslash, double
    quote, and line feed must be escaped or the exposition line is
    malformed (a model named `he"llo` or a path-ish entrypoint must not
    corrupt the scrape)."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


# Curated HELP text for the families whose meaning is not readable off the
# name; everything else derives a serviceable line from the name itself.
# Every family in the aggregated exposition goes through _family_lines, so
# the lint invariant (tools/check_prom.py: HELP + TYPE present per family,
# no family declared twice) holds by construction.
_HELP = {
    ":tensorflow:serving:request_count":
        "Requests per entrypoint and status (TF-Serving-compatible name)",
    ":tensorflow:serving:request_latency":
        "Request latency in microseconds (TF-Serving-compatible name)",
    "dts_tpu_qps_window": "Rolling-window overall request rate",
    "dts_tpu_cache_row_hits_total":
        "Candidate rows answered from the row-granular score cache "
        "instead of executing on device",
    "dts_tpu_cache_row_misses_total":
        "Candidate rows not in the row cache (cold — this batch executes "
        "them and fills on completion)",
    "dts_tpu_cache_row_coalesced_total":
        "Cold rows that joined another in-flight batch's fill instead of "
        "executing again (per-row single-flight)",
    "dts_tpu_cache_row_stale_serves_total":
        "Rows served past TTL inside the brownout stale window "
        "(responses touching them are marked degraded, never re-filled)",
    "dts_tpu_cache_row_evictions_total":
        "Row entries evicted by the LRU entry/byte bounds",
    "dts_tpu_cache_row_expirations_total":
        "Row entries dropped on sight past their TTL (and any stale "
        "window)",
    "dts_tpu_cache_row_invalidations_total":
        "Row entries dropped by generation invalidation (version swaps, "
        "operator flushes)",
    "dts_tpu_cache_row_fills_total":
        "Executed rows stored into the row cache",
    "dts_tpu_cache_row_hit_rate":
        "row hits / (row hits + row misses) over the process lifetime",
    "dts_tpu_cache_row_entries":
        "Live row entries in the row-granular store",
    "dts_tpu_cache_row_value_bytes":
        "Bytes of cached per-row output values in the row-granular store",
    "dts_tpu_cache_rows_requested_total":
        "Rows that entered cold-row extraction (the denominator of the "
        "row plane's executed-vs-requested ratio)",
    "dts_tpu_cache_rows_executed_total":
        "Rows actually packed, bucketed, and dispatched to the device "
        "after row-cache extraction",
    "dts_tpu_cache_rows_executed_fraction":
        "rows_executed / rows_requested — the row-granular cache's "
        "headline: well below 1.0 at zipfian skew",
    "dts_tpu_pipeline_in_flight":
        "Batches currently executing or awaiting D2H readback "
        "(the continuous-batching pipeline's live occupancy)",
    "dts_tpu_pipeline_readback_overlap_fraction":
        "Fraction of the in-flight D2H window the completers did NOT "
        "block on (1.0 = readback fully hidden behind other work)",
    "dts_tpu_pipeline_window_waits_total":
        "Times the dispatch thread waited for the k-deep in-flight "
        "window to open before issuing the next batch",
    "dts_tpu_kernel_quantized_batches_total":
        "Batches served by the int8 weight-quantized executables",
    "dts_tpu_kernel_pallas_batches_total":
        "Batches served by the fused serve kernel",
    "dts_tpu_kernel_bucket_quantized":
        "Per-bucket autotune decision: 1 = int8 weight path enabled",
    "dts_tpu_kernel_bucket_pallas":
        "Per-bucket autotune decision: 1 = fused serve kernel enabled",
    "dts_tpu_kernel_variant_speedup":
        "Measured step-time speedup of a kernel variant vs the f32 "
        "model.apply baseline at one bucket (autotune harness, live device)",
    "dts_tpu_integrity_wire_inputs_verified_total":
        "Requests whose input tensors carried an x-dts-input-crc stamp "
        "and matched it at decode (CRC32C over dtype/shape + payload "
        "bytes)",
    "dts_tpu_integrity_wire_inputs_rejected_total":
        "Requests failed INVALID_ARGUMENT at decode because the input "
        "bytes did not match the client's checksum stamp — corruption "
        "in transit, caught before the batch formed (only the damaged "
        "request fails)",
    "dts_tpu_integrity_wire_responses_stamped_total":
        "Responses stamped with an x-dts-score-crc trailing-metadata "
        "sidecar for opted-in clients to verify before merging scores",
    "dts_tpu_integrity_screen_trips_total":
        "Score rows the post-readback sanity screen rejected (NaN/Inf, "
        "or outside the configured plausible range); each trip fails "
        "only its own request while batchmates deliver",
    "dts_tpu_integrity_screen_window_trips":
        "Screen trips inside the current escalation window — crossing "
        "screen_trips_per_window hands the group to the recovery "
        "plane's output_corrupt cycle",
    "dts_tpu_integrity_shadow_batches_total":
        "Batches re-executed through the same jitted entry and "
        "compared bit-identically on host (sampled by shadow_fraction "
        "plus operator-forced audits)",
    "dts_tpu_integrity_shadow_mismatches_total":
        "Shadow re-executions whose bytes differed from the primary "
        "pass — same program, same inputs, different bits: the silent-"
        "corruption signature (escalates to recovery + gossips "
        "suspect)",
    "dts_tpu_integrity_audits_requested_total":
        "Operator-forced shadow verifications requested via POST "
        "/integrityz/audit",
    "dts_tpu_integrity_audits_run_total":
        "Operator-forced shadow verifications actually consumed by a "
        "dispatched batch",
    "dts_tpu_integrity_escalations_total":
        "Detections the plane escalated into the recovery controller's "
        "output_corrupt cycle (screen-trip threshold or shadow "
        "mismatch)",
    "dts_tpu_cascade_requests_total":
        "Requests that entered the multi-stage ranking cascade (stage-1 "
        "prune + stage-2 rank in one RPC)",
    "dts_tpu_cascade_fallbacks_total":
        "Cascade requests that fell back to a single full-model pass "
        "(stage-1 resolve/submit failure — e.g. mid-hot-swap — or an "
        "ineligible composition detected at run time); the request "
        "still succeeds",
    "dts_tpu_cascade_stage1_failures_total":
        "Stage-1 submits that raised and were absorbed by the full-pass "
        "fallback (a version hot-swap window, typically)",
    "dts_tpu_cascade_host_prunes_total":
        "Prunes computed host-side from the full stage-1 score vector "
        "because the on-device top-k variant did not arm for that batch",
    "dts_tpu_cascade_rows_total":
        "Candidate rows through the cascade by disposition: requested = "
        "all rows entering stage 1, survivor = rows selected for stage "
        "2, pruned = rows answered with their stage-1 score",
    "dts_tpu_cascade_rows_ranked_total":
        "Rows actually scored by the full model (survivors, plus every "
        "row of fallback requests) — the numerator of the goodput win: "
        "rank_fraction = ranked / requested",
    "dts_tpu_cascade_zero_survivor_requests_total":
        "Requests whose score threshold eliminated every candidate "
        "(answered entirely from stage-1 scores; stage 2 skipped)",
    "dts_tpu_cascade_stage_seconds_total":
        "Wall time per cascade stage (stage1 = cheap-model submit, "
        "prune = survivor selection + gather, stage2 = full-model "
        "submit over survivors)",
    "dts_tpu_cascade_survivor_fraction":
        "Observed survivor_rows / rows_requested over the process "
        "lifetime (the configured target is survivor_k or "
        "survivor_fraction)",
    "dts_tpu_cascade_rank_fraction":
        "Observed rows_ranked / rows_requested — under 1.0 means the "
        "full model is doing less work than a cascade-off server",
    "dts_tpu_cascade_survivor_bucket_total":
        "Stage-2 submits by the padded batch rung the survivors packed "
        "into (the cascade's win shows as survivor traffic landing in "
        "smaller rungs than the candidate batches)",
    "dts_tpu_quality_score":
        "Predicted-score distribution per model and version",
    "dts_tpu_quality_drift_psi":
        "Population Stability Index of the windowed score distribution "
        "vs the pinned reference (kind=reference) or the concurrently "
        "serving previous version (kind=version_pair)",
    "dts_tpu_quality_drift_js":
        "Jensen-Shannon divergence (base 2) companion to the PSI series",
    "dts_tpu_quality_auc":
        "Windowed AUC over label-feedback (score, label) joins",
    "dts_tpu_quality_calibration_error":
        "Count-weighted |mean predicted - observed rate| over predicted-"
        "probability deciles (expected calibration error)",
    "dts_tpu_lifecycle_state":
        "Continuous-freshness state machine, one-hot over idle/canary/"
        "promoting/rolled_back",
    "dts_tpu_lifecycle_canary_fraction":
        "Share of default-lane traffic currently routed to the canary "
        "version (probe-lane traffic always routes to it)",
    "dts_tpu_lifecycle_routed_total":
        "Requests the canary router resolved, labeled by target version "
        "role",
    "dts_tpu_lifecycle_blacklisted_versions":
        "Versions the watcher excludes from reconcile after a rollback",
    "dts_tpu_recovery_state":
        "Device-failure recovery state machine, one-hot over serving/"
        "quarantined/reinit/replay",
    "dts_tpu_recovery_replayed_items_total":
        "In-flight/queued requests re-dispatched by the replay path "
        "instead of failed on device death",
    "dts_tpu_recovery_poisoned_requests_total":
        "Requests isolated by bisection as deterministic executor "
        "killers and failed alone (INVALID_ARGUMENT)",
    "dts_tpu_recovery_mttr_mean_seconds":
        "Mean recovery-cycle duration over the retained MTTR history ring",
    "dts_tpu_recovery_last_cycle_seconds":
        "Duration of the last completed quarantine->reinit->replay "
        "cycle (the live MTTR evidence)",
    "dts_tpu_integrity_suspect":
        "1 while this replica's own shadow verification has it marked "
        "suspect (also gossiped in the fleet record so routers steer "
        "around it); clears after suspect_clear_passes clean compares",
    "dts_tpu_fleet_router_integrity_audits_total":
        "Router-side two-replica bit-identity audits by outcome: run = "
        "sampled forwards fanned to two replicas, disagreed = the score "
        "bytes differed, suspect_marked = a third replica broke the tie "
        "and the minority was busy-biased in the scoreboard",
    "dts_tpu_fleet_agg_qps":
        "Fleet-aggregated rolling request rate: the sum of member-"
        "reported windowed qps (scraped /monitoring wires; gossip-"
        "piggybacked summaries when a member is scrape-unreachable)",
    "dts_tpu_fleet_agg_latency_ms":
        "Fleet windowed latency quantiles from the merged member bucket "
        "counts (an exact histogram merge, not an average of member "
        "percentiles)",
    "dts_tpu_fleet_agg_requests":
        "Sum of member-reported lifetime requests (gauge: member churn "
        "and restarts can lower it)",
    "dts_tpu_fleet_agg_errors":
        "Sum of member-reported lifetime errors (gauge: member churn "
        "and restarts can lower it)",
    "dts_tpu_fleet_agg_members":
        "Members contributing to the current fleet aggregate",
    "dts_tpu_fleet_agg_members_degraded":
        "Members whose contribution fell back to the gossip-piggybacked "
        "summary because the /monitoring scrape failed",
    "dts_tpu_fleet_agg_member_qps":
        "Per-member windowed request rate as the router aggregated it",
    "dts_tpu_slo_latency_target_ms":
        "Configured latency SLO target: a request is `good` for the "
        "latency SLI when it completes under this",
    "dts_tpu_slo_objective":
        "Configured good-fraction objective per SLO",
    "dts_tpu_slo_burn_rate":
        "Error-budget burn rate per SLO and window: bad fraction over "
        "the window divided by the budget (1 - objective); 1.0 consumes "
        "the budget exactly at the sustainable rate",
    "dts_tpu_slo_budget_remaining":
        "Fraction of the long-window error budget not yet consumed",
    "dts_tpu_slo_breached":
        "1 while BOTH burn windows of some SLO exceed the fast "
        "threshold (the multi-window page condition; breaching traces "
        "are force-kept via the slo.burn span annotation)",
    "dts_tpu_slo_breaches_total":
        "Breach episodes since the monitor started (0->1 transitions "
        "of dts_tpu_slo_breached)",
}


def _family_lines(lines: list, name: str, kind: str) -> None:
    """Append the # HELP + # TYPE pair declaring a metric family. The ONE
    way families enter the exposition: the Prometheus lint requires a
    HELP and TYPE line for every family and forbids re-declaration, and
    text-format HELP must escape backslash and line feed."""
    text = (
        _HELP.get(name, name.replace("_", " ").strip())
        .replace("\\", "\\\\")
        .replace("\n", "\\n")
    )
    lines.append(f"# HELP {name} {text}")
    lines.append(f"# TYPE {name} {kind}")


class ServerMetrics:
    """Per-RPC latency/outcome metrics + rolling windows, exported as one
    dict (the /monitoring body). `observe(..., model=...)` additionally aggregates under the
    resolved model name, so both surfaces carry per-model labels."""

    # Per-model series are keyed on CLIENT-SUPPLIED model names (a
    # NOT_FOUND still observes under the name it asked for), so the key
    # space must be bounded or a fuzzer's ever-new names would grow
    # memory and scrape cardinality without limit. Real deployments serve
    # a handful of models; past the cap, overflow traffic aggregates
    # under one sentinel label instead of allocating new series.
    MAX_MODEL_LABELS = 64
    OVERFLOW_MODEL = "_other"

    def __init__(self, window_s: float = 60.0, clock=time.monotonic):
        self.window_s = float(window_s)
        self._clock = clock
        self._rpcs: dict[str, RpcMetrics] = {}
        self._models: dict[tuple[str, str], RpcMetrics] = {}
        self._model_names: set[str] = set()
        self._lock = threading.Lock()
        self._start = clock()

    def _new_rpc_metrics(self) -> RpcMetrics:
        return RpcMetrics(
            window=WindowedLatency(window_s=self.window_s, clock=self._clock)
        )

    def rpc(self, name: str) -> RpcMetrics:
        with self._lock:
            if name not in self._rpcs:
                self._rpcs[name] = self._new_rpc_metrics()
            return self._rpcs[name]

    def _model_rpc(self, name: str, model: str) -> RpcMetrics:
        with self._lock:
            if (
                model not in self._model_names
                and len(self._model_names) >= self.MAX_MODEL_LABELS
            ):
                model = self.OVERFLOW_MODEL
            self._model_names.add(model)
            key = (name, model)
            if key not in self._models:
                self._models[key] = self._new_rpc_metrics()
            return self._models[key]

    def observe(
        self, name: str, seconds: float, ok: bool, model: str | None = None
    ) -> None:
        targets = [self.rpc(name)]
        if model:
            targets.append(self._model_rpc(name, model))
        for m in targets:
            m.latency.record(seconds)
            m.window.record(seconds)
            with self._lock:  # counters race across handler threads otherwise
                if ok:
                    m.ok += 1
                else:
                    m.errors += 1

    @staticmethod
    def _rpc_block(m: RpcMetrics) -> tuple[dict, int]:
        """ONE construction of the per-entrypoint stats block — lifetime
        histogram + counters + the rolling-window horizon — shared by the
        aggregate and per-model surfaces so they can never drift. Returns
        (block, windowed count) so callers never re-merge the window
        slices for a count this snapshot already produced."""
        win = m.window.snapshot()
        block = {
            **m.latency.snapshot(),
            "ok": m.ok,
            "errors": m.errors,
            # Rolling horizon next to the lifetime values: what this
            # entrypoint is doing NOW (windowed qps + percentiles).
            "window": {
                "qps": win["qps"],
                "p50_ms": win["p50_ms"],
                "p99_ms": win["p99_ms"],
            },
        }
        return block, win["count"]

    def snapshot(self, batcher_stats=None) -> dict:
        uptime = self._clock() - self._start
        out: dict = {
            "uptime_s": round(uptime, 1),
            "window_s": self.window_s,
            "rpcs": {},
        }
        total = 0
        window_count = 0
        with self._lock:  # rpc() may insert concurrently
            items = sorted(self._rpcs.items())
            model_items = sorted(self._models.items())
        for name, m in items:
            out["rpcs"][name], win_count = self._rpc_block(m)
            total += m.ok + m.errors
            window_count += win_count
        if model_items:
            models: dict = {}
            for (name, model), m in model_items:
                models.setdefault(model, {})[name] = self._rpc_block(m)[0]
            out["models"] = models
        # `qps` is the ROLLING rate (what the server is doing now); the
        # lifetime average — which decays toward 0 on an idle server and
        # under-reports after any idle stretch — stays visible as
        # qps_lifetime. The divisor shrinks while the
        # server is younger than the window (see effective_window_s).
        out["qps"] = round(
            window_count / min(self.window_s, max(uptime, 1.0)), 2
        )
        out["qps_lifetime"] = round(total / uptime, 2) if uptime > 0 else 0.0
        if batcher_stats is not None:
            out["batcher"] = {
                "batches": batcher_stats.batches,
                "requests": batcher_stats.requests,
                "mean_occupancy": round(batcher_stats.mean_occupancy, 3),
                "mean_requests_per_batch": round(batcher_stats.mean_requests_per_batch, 2),
                "max_queue_depth": batcher_stats.max_queue_depth,
                # D2H transfer attribution (output compaction + async
                # readback pipeline): actual wire bytes fetched, the
                # full-fp32 all-outputs baseline they're charged against,
                # and how much of the in-flight transfer window the
                # completers actually blocked on.
                "bytes_downloaded": batcher_stats.bytes_downloaded,
                "bytes_download_full_f32": batcher_stats.bytes_download_full_f32,
                "download_compaction_ratio": round(
                    batcher_stats.download_compaction_ratio, 2
                ),
                "readback_overlap_fraction": round(
                    batcher_stats.readback_overlap_fraction, 3
                ),
                "topk_batches": batcher_stats.topk_batches,
                # Queued work shed because its client deadline expired.
                "deadline_sheds": getattr(batcher_stats, "deadline_sheds", 0),
                # The cache plane: duplicate rows collapsed, and the row
                # tier's rows dispatched against rows requested.
                "dedup_batches": batcher_stats.dedup_batches,
                "dedup_rows_collapsed": batcher_stats.dedup_rows_collapsed,
                "row_batches": batcher_stats.row_batches,
                "rows_requested": batcher_stats.rows_requested,
                "rows_executed": batcher_stats.rows_executed,
                "row_full_hit_batches": batcher_stats.row_full_hit_batches,
            }
        return out

    # -------------------------------------------------------- fleet wire
    # The fleet aggregator's member-side surfaces: a full wire
    # snapshot served on the gossip port's /monitoring route, and a cheap
    # digest piggybacked on every gossip record so the router's aggregate
    # degrades gracefully when the scrape fails.

    def _window_wires_and_counters(self) -> tuple[dict, int, int]:
        with self._lock:
            items = sorted(self._rpcs.items())
        window = WindowedLatency.merge_dicts(
            [m.window.to_dict() for _, m in items]
        )
        ok = sum(m.ok for _, m in items)
        errors = sum(m.errors for _, m in items)
        return window, ok, errors

    def fleet_wire(self) -> dict:
        """Every entrypoint's rolling window merged into ONE wire
        histogram (the router re-merges members' wires with exact bucket
        counts), plus lifetime ok/error counters and the lifetime latency
        bucket counts the SLO monitor diffs — monotonic within a process,
        so the router clamps per-member deltas across restarts."""
        window, ok, errors = self._window_wires_and_counters()
        with self._lock:
            items = sorted(self._rpcs.items())
        life_counts = [0] * _NUM_BUCKETS
        life_total, life_sum = 0, 0.0
        for _, m in items:
            c, t, s, _mn, _mx = m.latency._state()
            for i, v in enumerate(c):
                if v:
                    life_counts[i] += v
            life_total += t
            life_sum += s
        return {
            "uptime_s": round(self._clock() - self._start, 1),
            "ok": ok,
            "errors": errors,
            "window": window,
            "lifetime": {
                "total": life_total,
                "sum_us": round(life_sum, 1),
                "buckets": {
                    str(i): c for i, c in enumerate(life_counts) if c
                },
            },
        }

    def fleet_summary(self) -> dict:
        """Digest of fleet_wire() small enough to ride every gossip
        record: qps + quantiles only, no mergeable histogram — a
        gossip-only member contributes its self-reported numbers to the
        aggregate instead of exact bucket counts."""
        window, ok, errors = self._window_wires_and_counters()
        stats = WindowedLatency.wire_stats(window)
        return {
            "qps": stats["qps"],
            "p50_ms": stats["p50_ms"],
            "p99_ms": stats["p99_ms"],
            "requests": ok + errors,
            "errors": errors,
        }

    def prometheus_text(self, batcher_stats=None, cache=None, row_cache=None, overload=None,
                        pipeline=None, kernels=None, integrity=None, cascade=None,
                        utilization=None, quality=None, lifecycle=None,
                        recovery=None, fleet=None) -> str:
        """Prometheus exposition (text format 0.0.4) of the same data
        snapshot() serves as JSON. Metric names mirror tensorflow_model_
        server's monitoring surface (`:tensorflow:serving:request_count` /
        `:tensorflow:serving:request_latency`, microsecond buckets) so
        existing TF-Serving dashboards and alert rules scrape unchanged;
        rolling-window gauges, per-model series, and batcher gauges are
        framework-native and ride the dts_tpu_ prefix."""
        rc, rl = ":tensorflow:serving:request_count", ":tensorflow:serving:request_latency"
        esc = escape_label_value
        lines: list[str] = []
        _family_lines(lines, rc, "counter")
        with self._lock:
            items = sorted(self._rpcs.items())
            model_items = sorted(self._models.items())
        for name, m in items:
            lines.append(f'{rc}{{entrypoint="{esc(name)}",status="OK"}} {m.ok}')
            if m.errors:
                lines.append(
                    f'{rc}{{entrypoint="{esc(name)}",status="ERROR"}} {m.errors}'
                )
        _family_lines(lines, rl, "histogram")
        for name, m in items:
            buckets, sum_us, total = m.latency.prometheus_buckets()
            for le_us, cum in buckets:
                lines.append(
                    f'{rl}_bucket{{entrypoint="{esc(name)}",le="{le_us:.6g}"}} {cum}'
                )
            lines.append(f'{rl}_bucket{{entrypoint="{esc(name)}",le="+Inf"}} {total}')
            lines.append(f'{rl}_sum{{entrypoint="{esc(name)}"}} {sum_us:.6g}')
            lines.append(f'{rl}_count{{entrypoint="{esc(name)}"}} {total}')
        # Rolling-window horizon: sliding QPS + windowed percentiles per
        # entrypoint, plus the overall rolling rate `snapshot()["qps"]`
        # reports.
        win_qps = "dts_tpu_request_window_qps"
        win_lat = "dts_tpu_request_window_latency_ms"
        _family_lines(lines, win_qps, "gauge")
        overall = 0.0
        win_snaps = [(name, m.window.snapshot()) for name, m in items]
        for name, win in win_snaps:
            overall += win["qps"]
            lines.append(f'{win_qps}{{entrypoint="{esc(name)}"}} {win["qps"]}')
        _family_lines(lines, "dts_tpu_qps_window", "gauge")
        lines.append(f"dts_tpu_qps_window {round(overall, 2)}")
        _family_lines(lines, win_lat, "gauge")
        for name, win in win_snaps:
            for q, key in (("0.5", "p50_ms"), ("0.99", "p99_ms")):
                lines.append(
                    f'{win_lat}{{entrypoint="{esc(name)}",quantile="{q}"}} '
                    f'{win[key]}'
                )
        if model_items:
            mrc = "dts_tpu_model_request_count"
            mqps = "dts_tpu_model_window_qps"
            mlat = "dts_tpu_model_window_latency_ms"
            _family_lines(lines, mrc, "counter")
            for (name, model), m in model_items:
                base = f'entrypoint="{esc(name)}",model_name="{esc(model)}"'
                lines.append(f'{mrc}{{{base},status="OK"}} {m.ok}')
                if m.errors:
                    lines.append(f'{mrc}{{{base},status="ERROR"}} {m.errors}')
            # Families stay GROUPED (declaration followed by all of its
            # samples): the exposition lint enforces the text-format rule
            # that a family's lines form one contiguous block.
            qps_lines, lat_lines = [], []
            for (name, model), m in model_items:
                base = f'entrypoint="{esc(name)}",model_name="{esc(model)}"'
                win = m.window.snapshot()
                qps_lines.append(f'{mqps}{{{base}}} {win["qps"]}')
                for q, key in (("0.5", "p50_ms"), ("0.99", "p99_ms")):
                    lat_lines.append(
                        f'{mlat}{{{base},quantile="{q}"}} {win[key]}'
                    )
            _family_lines(lines, mqps, "gauge")
            lines.extend(qps_lines)
            _family_lines(lines, mlat, "gauge")
            lines.extend(lat_lines)
        if batcher_stats is not None:
            for metric, kind, value in (
                ("dts_tpu_batcher_batches_total", "counter", batcher_stats.batches),
                ("dts_tpu_batcher_requests_total", "counter", batcher_stats.requests),
                ("dts_tpu_batcher_mean_occupancy", "gauge",
                 round(batcher_stats.mean_occupancy, 4)),
                ("dts_tpu_batcher_mean_requests_per_batch", "gauge",
                 round(batcher_stats.mean_requests_per_batch, 3)),
                ("dts_tpu_batcher_max_queue_depth", "gauge",
                 batcher_stats.max_queue_depth),
                ("dts_tpu_batcher_bytes_downloaded_total", "counter",
                 batcher_stats.bytes_downloaded),
                ("dts_tpu_batcher_bytes_download_full_f32_total", "counter",
                 batcher_stats.bytes_download_full_f32),
                ("dts_tpu_batcher_topk_batches_total", "counter",
                 batcher_stats.topk_batches),
                ("dts_tpu_batcher_readback_overlap_fraction", "gauge",
                 round(batcher_stats.readback_overlap_fraction, 4)),
                ("dts_tpu_batcher_deadline_sheds_total", "counter",
                 getattr(batcher_stats, "deadline_sheds", 0)),
                ("dts_tpu_batcher_dedup_batches_total", "counter",
                 batcher_stats.dedup_batches),
                ("dts_tpu_batcher_dedup_rows_collapsed_total", "counter",
                 batcher_stats.dedup_rows_collapsed),
            ):
                _family_lines(lines, metric, kind)
                lines.append(f"{metric} {value}")
        if pipeline is not None:
            # The batcher.pipeline_stats() snapshot as dts_tpu_pipeline_*
            # series: configured depth/window, live in-flight occupancy
            # (total + per bucket), the high-water mark, and the
            # readback-overlap fraction.
            for metric, kind, value in (
                ("dts_tpu_pipeline_depth_configured", "gauge",
                 pipeline.get("depth", 0)),
                ("dts_tpu_pipeline_inflight_window", "gauge",
                 pipeline.get("inflight_window", 0)),
                ("dts_tpu_pipeline_in_flight", "gauge",
                 pipeline.get("in_flight", 0)),
                ("dts_tpu_pipeline_inflight_peak", "gauge",
                 pipeline.get("inflight_peak", 0)),
                ("dts_tpu_pipeline_dispatch_pending", "gauge",
                 pipeline.get("dispatch_pending", 0)),
                ("dts_tpu_pipeline_window_waits_total", "counter",
                 pipeline.get("inflight_window_waits", 0)),
                ("dts_tpu_pipeline_readback_overlap_fraction", "gauge",
                 pipeline.get("readback_overlap_fraction", 0.0)),
            ):
                _family_lines(lines, metric, kind)
                lines.append(f"{metric} {value}")
            per_bucket = pipeline.get("per_bucket_in_flight") or {}
            if per_bucket:
                bm = "dts_tpu_pipeline_bucket_in_flight"
                _family_lines(lines, bm, "gauge")
                for bucket, n in sorted(per_bucket.items()):
                    lines.append(f'{bm}{{bucket="{esc(bucket)}"}} {n}')
            ring = pipeline.get("buffer_ring")
            if ring is not None:
                for metric, kind, value in (
                    ("dts_tpu_pipeline_buffer_ring_reuses_total", "counter",
                     ring.get("reuses", 0)),
                    ("dts_tpu_pipeline_buffer_ring_allocs_total", "counter",
                     ring.get("allocs", 0)),
                    ("dts_tpu_pipeline_buffer_ring_free", "gauge",
                     ring.get("free_buffers", 0)),
                ):
                    _family_lines(lines, metric, kind)
                    lines.append(f"{metric} {value}")
        if cache is not None:
            # The ScoreCache snapshot as dts_tpu_cache_* series: aggregate
            # counters and gauges plus per-model hit / miss / coalesced /
            # eviction counters.
            for metric, kind, value in (
                ("dts_tpu_cache_hits_total", "counter", cache.get("hits", 0)),
                ("dts_tpu_cache_misses_total", "counter", cache.get("misses", 0)),
                ("dts_tpu_cache_coalesced_total", "counter",
                 cache.get("coalesced", 0)),
                ("dts_tpu_cache_evictions_total", "counter",
                 cache.get("evictions", 0)),
                ("dts_tpu_cache_expirations_total", "counter",
                 cache.get("expirations", 0)),
                ("dts_tpu_cache_invalidations_total", "counter",
                 cache.get("invalidations", 0)),
                # Expired entries answered inside the overload plane's
                # brownout stale window.
                ("dts_tpu_cache_stale_serves_total", "counter",
                 cache.get("stale_serves", 0)),
                ("dts_tpu_cache_hit_rate", "gauge", cache.get("hit_rate", 0.0)),
                ("dts_tpu_cache_entries", "gauge", cache.get("entries", 0)),
                ("dts_tpu_cache_value_bytes", "gauge",
                 cache.get("value_bytes", 0)),
            ):
                _family_lines(lines, metric, kind)
                lines.append(f"{metric} {value}")
            models = cache.get("models") or {}
            if models:
                mc = "dts_tpu_cache_model_events_total"
                _family_lines(lines, mc, "counter")
                for model, counters in sorted(models.items()):
                    base = f'model_name="{esc(model)}"'
                    for event in ("hits", "misses", "coalesced", "evictions"):
                        lines.append(
                            f'{mc}{{{base},event="{event}"}} '
                            f'{counters.get(event, 0)}'
                        )
        if row_cache is not None:
            # The row tier: per-row hit / miss / coalesced counters and
            # the rows executed on the device against the rows requested.
            for metric, kind, value in (
                ("dts_tpu_cache_row_hits_total", "counter",
                 row_cache.get("hits", 0)),
                ("dts_tpu_cache_row_misses_total", "counter",
                 row_cache.get("misses", 0)),
                ("dts_tpu_cache_row_coalesced_total", "counter",
                 row_cache.get("coalesced", 0)),
                ("dts_tpu_cache_row_stale_serves_total", "counter",
                 row_cache.get("stale_serves", 0)),
                ("dts_tpu_cache_row_evictions_total", "counter",
                 row_cache.get("evictions", 0)),
                ("dts_tpu_cache_row_expirations_total", "counter",
                 row_cache.get("expirations", 0)),
                ("dts_tpu_cache_row_invalidations_total", "counter",
                 row_cache.get("invalidations", 0)),
                ("dts_tpu_cache_row_fills_total", "counter",
                 row_cache.get("fills", 0)),
                ("dts_tpu_cache_row_hit_rate", "gauge",
                 row_cache.get("hit_rate", 0.0)),
                ("dts_tpu_cache_row_entries", "gauge",
                 row_cache.get("entries", 0)),
                ("dts_tpu_cache_row_value_bytes", "gauge",
                 row_cache.get("value_bytes", 0)),
                ("dts_tpu_cache_rows_requested_total", "counter",
                 row_cache.get("rows_requested", 0)),
                ("dts_tpu_cache_rows_executed_total", "counter",
                 row_cache.get("rows_executed", 0)),
                ("dts_tpu_cache_rows_executed_fraction", "gauge",
                 row_cache.get("rows_executed_fraction", 0.0)),
            ):
                _family_lines(lines, metric, kind)
                lines.append(f"{metric} {value}")
        if overload is not None:
            lines.extend(_overload_prometheus_lines(overload))
        if utilization is not None:
            lines.extend(_utilization_prometheus_lines(utilization))
        if quality is not None:
            lines.extend(_quality_prometheus_lines(quality))
        if lifecycle is not None:
            lines.extend(_lifecycle_prometheus_lines(lifecycle))
        if recovery is not None:
            lines.extend(_recovery_prometheus_lines(recovery))
        if kernels is not None:
            lines.extend(_kernel_prometheus_lines(kernels))
        if fleet is not None:
            lines.extend(_fleet_prometheus_lines(fleet))
        if cascade is not None:
            lines.extend(_cascade_prometheus_lines(cascade))
        if integrity is not None:
            lines.extend(_integrity_prometheus_lines(integrity))
        return "\n".join(lines) + "\n"


def _recovery_prometheus_lines(recovery: dict) -> list[str]:
    """dts_tpu_recovery_* exposition from a RecoveryController snapshot:
    the one-hot state gauge, the quarantine / reinit / replay / bisection
    counters, the pending-replay gauge, the last cycle's duration and the
    MTTR ring's mean. Each family declared once (the lint's rule)."""
    lines: list[str] = []
    st = "dts_tpu_recovery_state"
    _family_lines(lines, st, "gauge")
    current = recovery.get("state", "serving")
    for state in ("serving", "quarantined", "reinit", "replay"):
        lines.append(f'{st}{{state="{escape_label_value(state)}"}} '
                     f'{1 if state == current else 0}')
    counters = recovery.get("counters") or {}
    last = recovery.get("last_cycle") or {}
    for metric, kind, value in (
        ("dts_tpu_recovery_quarantines_total", "counter", counters.get("quarantines", 0)),
        ("dts_tpu_recovery_reinits_total", "counter", counters.get("reinits", 0)),
        ("dts_tpu_recovery_cycles_completed_total", "counter",
         counters.get("cycles_completed", 0)),
        ("dts_tpu_recovery_device_failures_total", "counter",
         counters.get("device_failures", 0)),
        ("dts_tpu_recovery_replayed_items_total", "counter", counters.get("replayed_items", 0)),
        ("dts_tpu_recovery_replay_budget_exhausted_total", "counter",
         counters.get("replay_budget_exhausted", 0)),
        ("dts_tpu_recovery_poisoned_requests_total", "counter",
         counters.get("poisoned_requests", 0)),
        ("dts_tpu_recovery_bisections_total", "counter", counters.get("bisections", 0)),
        ("dts_tpu_recovery_watchdog_wedge_trips_total", "counter",
         counters.get("watchdog_wedge_trips", 0)),
        ("dts_tpu_recovery_thread_deaths_total", "counter", counters.get("thread_deaths", 0)),
        ("dts_tpu_recovery_pending_replay_items", "gauge",
         recovery.get("pending_replay_items", 0)),
        ("dts_tpu_recovery_last_cycle_seconds", "gauge", last.get("duration_s", 0.0)),
        ("dts_tpu_recovery_mttr_mean_seconds", "gauge",
         (recovery.get("mttr") or {}).get("mean_s") or 0.0),
    ):
        _family_lines(lines, metric, kind)
        lines.append(f"{metric} {value}")
    return lines


def _utilization_prometheus_lines(utilization: dict) -> list[str]:
    """dts_tpu_utilization_* exposition from an OccupancyLedger snapshot:
    the busy and achieved fractions and the depth gauge, the windowed
    waterfall's components (labelled), and the lifetime idle-gap counters
    by blocking cause. Each family is one contiguous block (the lint's
    rule)."""
    esc = escape_label_value
    lines: list[str] = []
    wf = utilization.get("waterfall") or {}
    for metric, kind, value in (
        ("dts_tpu_utilization_busy_fraction", "gauge", wf.get("busy_fraction", 0.0)),
        ("dts_tpu_utilization_achieved_fraction_of_device_limit", "gauge",
         wf.get("achieved_fraction_of_device_limit", 0.0)),
        ("dts_tpu_utilization_window_wall_seconds", "gauge", wf.get("wall_s", 0.0)),
        ("dts_tpu_utilization_waterfall_sum_over_wall", "gauge", wf.get("sum_over_wall", 0.0)),
        ("dts_tpu_utilization_in_flight", "gauge", utilization.get("in_flight", 0)),
        ("dts_tpu_utilization_max_in_flight", "gauge", utilization.get("max_in_flight", 0)),
        ("dts_tpu_utilization_batches_total", "counter", utilization.get("batches", 0)),
        ("dts_tpu_utilization_busy_seconds_total", "counter", utilization.get("busy_s", 0.0)),
        ("dts_tpu_utilization_sheds_total", "counter", utilization.get("sheds", 0)),
    ):
        _family_lines(lines, metric, kind)
        lines.append(f"{metric} {value}")
    comps = wf.get("components_s") or {}
    if comps:
        cm = "dts_tpu_utilization_component_seconds"
        _family_lines(lines, cm, "gauge")
        for comp, secs in sorted(comps.items()):
            lines.append(f'{cm}{{component="{esc(comp)}"}} {secs}')
    gaps = utilization.get("idle_gaps") or {}
    if gaps:
        gc = "dts_tpu_utilization_idle_gaps_total"
        gs = "dts_tpu_utilization_idle_gap_seconds_total"
        _family_lines(lines, gc, "counter")
        for cause, blk in sorted(gaps.items()):
            lines.append(f'{gc}{{cause="{esc(cause)}"}} {blk.get("count", 0)}')
        _family_lines(lines, gs, "counter")
        for cause, blk in sorted(gaps.items()):
            lines.append(f'{gs}{{cause="{esc(cause)}"}} {blk.get("total_s", 0.0)}')
    return lines


def _quality_prometheus_lines(quality: dict) -> list[str]:
    """dts_tpu_quality_* exposition from a QualityMonitor snapshot dict:
    plane counters, label-join counters + windowed AUC /
    calibration error, per-(model, version) score counts / means / the
    score histogram family, and per-model drift gauges (PSI + JS, labeled
    by kind: vs the pinned reference or between live versions). Families
    are grouped and declared exactly once — the exposition lint's
    invariants."""
    esc = escape_label_value
    lines: list[str] = []
    exemplars = quality.get("exemplars") or {}
    for metric, kind, value in (
        ("dts_tpu_quality_observed_requests_total", "counter",
         quality.get("observed_requests", 0)),
        ("dts_tpu_quality_version_changes_total", "counter",
         quality.get("version_changes", 0)),
        ("dts_tpu_quality_exemplars_marked_total", "counter",
         exemplars.get("marked", 0)),
        ("dts_tpu_quality_drift_events_total", "counter",
         exemplars.get("drift_events", 0)),
    ):
        _family_lines(lines, metric, kind)
        lines.append(f"{metric} {value}")
    labels_blk = quality.get("labels") or {}
    for metric, kind, value in (
        ("dts_tpu_quality_labels_joined_total", "counter",
         labels_blk.get("joined", 0)),
        ("dts_tpu_quality_labels_orphaned_total", "counter",
         labels_blk.get("orphaned", 0)),
        ("dts_tpu_quality_labels_late_total", "counter",
         labels_blk.get("late", 0)),
        ("dts_tpu_quality_label_window_pairs", "gauge",
         labels_blk.get("window_pairs", 0)),
    ):
        _family_lines(lines, metric, kind)
        lines.append(f"{metric} {value}")
    if labels_blk.get("auc") is not None:
        _family_lines(lines, "dts_tpu_quality_auc", "gauge")
        lines.append(f'dts_tpu_quality_auc {labels_blk["auc"]}')
    cal_err = (labels_blk.get("calibration") or {}).get("error")
    if cal_err is not None:
        _family_lines(lines, "dts_tpu_quality_calibration_error", "gauge")
        lines.append(f"dts_tpu_quality_calibration_error {cal_err}")
    models = quality.get("models") or {}
    if not models:
        return lines
    count_lines, mean_lines, wmean_lines, hist_lines = [], [], [], []
    for model, blk in sorted(models.items()):
        for ver, vs in sorted(
            (blk.get("versions") or {}).items(), key=lambda kv: int(kv[0])
        ):
            base = f'model_name="{esc(model)}",version="{esc(ver)}"'
            total = vs.get("count", 0)
            count_lines.append(f"dts_tpu_quality_scores_total{{{base}}} {total}")
            mean_lines.append(
                f'dts_tpu_quality_score_mean{{{base}}} {vs.get("mean", 0.0)}'
            )
            wmean_lines.append(
                f"dts_tpu_quality_score_window_mean{{{base}}} "
                f'{(vs.get("window") or {}).get("mean", 0.0)}'
            )
            hg = vs.get("histogram") or {}
            counts = hg.get("counts") or []
            lo, hi = hg.get("lo", 0.0), hg.get("hi", 1.0)
            width = (hi - lo) / len(counts) if counts else 0.0
            last = max((i for i, c in enumerate(counts) if c), default=-1)
            acc = 0
            for i in range(last + 1):
                acc += counts[i]
                le = lo + width * (i + 1)
                hist_lines.append(
                    f'dts_tpu_quality_score_bucket{{{base},le="{le:.6g}"}} {acc}'
                )
            hist_lines.append(
                f'dts_tpu_quality_score_bucket{{{base},le="+Inf"}} {total}'
            )
            hist_lines.append(
                f"dts_tpu_quality_score_sum{{{base}}} "
                f'{round(vs.get("mean", 0.0) * total, 6)}'
            )
            hist_lines.append(f"dts_tpu_quality_score_count{{{base}}} {total}")
    _family_lines(lines, "dts_tpu_quality_scores_total", "counter")
    lines.extend(count_lines)
    _family_lines(lines, "dts_tpu_quality_score_mean", "gauge")
    lines.extend(mean_lines)
    _family_lines(lines, "dts_tpu_quality_score_window_mean", "gauge")
    lines.extend(wmean_lines)
    _family_lines(lines, "dts_tpu_quality_score", "histogram")
    lines.extend(hist_lines)
    psi_lines, js_lines, exceeded_lines = [], [], []
    for model, blk in sorted(models.items()):
        drift = blk.get("drift") or {}
        for kind_name in ("reference", "version_pair"):
            entry = drift.get(kind_name)
            if entry:
                lbl = f'model_name="{esc(model)}",kind="{kind_name}"'
                psi_lines.append(
                    f'dts_tpu_quality_drift_psi{{{lbl}}} {entry["psi"]}'
                )
                js_lines.append(
                    f'dts_tpu_quality_drift_js{{{lbl}}} {entry["js"]}'
                )
        exceeded_lines.append(
            f'dts_tpu_quality_drift_exceeded{{model_name="{esc(model)}"}} '
            f'{1 if drift.get("exceeded") else 0}'
        )
    if psi_lines:
        _family_lines(lines, "dts_tpu_quality_drift_psi", "gauge")
        lines.extend(psi_lines)
        _family_lines(lines, "dts_tpu_quality_drift_js", "gauge")
        lines.extend(js_lines)
    _family_lines(lines, "dts_tpu_quality_drift_exceeded", "gauge")
    lines.extend(exceeded_lines)
    return lines


def _lifecycle_prometheus_lines(lifecycle: dict) -> list[str]:
    """dts_tpu_lifecycle_* exposition from a LifecycleController snapshot
    dict: the one-hot state gauge (the overload plane's enum
    encoding, so dashboards `max by (state)` it), the live canary
    fraction + version gauges, tick/publish/promote/rollback counters,
    routed-request counters labeled by target role, and the watcher's
    blacklist size. Families grouped and declared once — the exposition
    lint's invariants."""
    esc = escape_label_value
    lines: list[str] = []
    st = "dts_tpu_lifecycle_state"
    _family_lines(lines, st, "gauge")
    current = lifecycle.get("state", "idle")
    for state in ("idle", "canary", "promoting", "rolled_back"):
        lines.append(
            f'{st}{{state="{esc(state)}"}} {1 if state == current else 0}'
        )
    counters = lifecycle.get("counters") or {}
    for metric, kind, value in (
        ("dts_tpu_lifecycle_canary_fraction", "gauge",
         lifecycle.get("canary_fraction", 0.0)),
        ("dts_tpu_lifecycle_stable_version", "gauge",
         lifecycle.get("stable_version") or 0),
        ("dts_tpu_lifecycle_canary_version", "gauge",
         lifecycle.get("canary_version") or 0),
        ("dts_tpu_lifecycle_ticks_total", "counter",
         counters.get("ticks", 0)),
        ("dts_tpu_lifecycle_publishes_total", "counter",
         counters.get("publishes", 0)),
        ("dts_tpu_lifecycle_publish_failures_total", "counter",
         counters.get("publish_failures", 0)),
        ("dts_tpu_lifecycle_promotes_total", "counter",
         counters.get("promotes", 0)),
        ("dts_tpu_lifecycle_rollbacks_total", "counter",
         counters.get("rollbacks", 0)),
        ("dts_tpu_lifecycle_blacklisted_versions", "gauge",
         len((lifecycle.get("watcher") or {}).get("blacklisted", ()))),
    ):
        _family_lines(lines, metric, kind)
        lines.append(f"{metric} {value}")
    rt = "dts_tpu_lifecycle_routed_total"
    _family_lines(lines, rt, "counter")
    for target, key in (
        ("canary", "routed_canary"),
        ("stable", "routed_stable"),
    ):
        lines.append(
            f'{rt}{{target="{esc(target)}"}} {counters.get(key, 0)}'
        )
    # Probe-lane routes are a SUBSET of target="canary" (the lane always
    # routes there), so they get their own family, not a third target.
    pr = "dts_tpu_lifecycle_probe_routed_total"
    _family_lines(lines, pr, "counter")
    lines.append(f"{pr} {counters.get('routed_probe', 0)}")
    return lines


def _overload_prometheus_lines(overload: dict) -> list[str]:
    """dts_tpu_overload_* exposition from an AdmissionController snapshot:
    the adaptive limit and the controlled variable, shed / doomed /
    brownout counters, sheds per lane, and the pressure state one-hot (the
    Prometheus encoding of an enum)."""
    esc = escape_label_value
    lines: list[str] = []
    for metric, kind, value in (
        ("dts_tpu_overload_limit_candidates", "gauge", overload.get("limit", 0)),
        ("dts_tpu_overload_queue_wait_p99_ms", "gauge", overload.get("queue_wait_p99_ms", 0.0)),
        ("dts_tpu_overload_target_queue_wait_ms", "gauge",
         overload.get("target_queue_wait_ms", 0.0)),
        ("dts_tpu_overload_admitted_total", "counter", overload.get("admitted", 0)),
        ("dts_tpu_overload_sheds_total", "counter", overload.get("sheds", 0)),
        ("dts_tpu_overload_doomed_refusals_total", "counter",
         overload.get("doomed_refusals", 0)),
        ("dts_tpu_overload_brownout_serves_total", "counter",
         overload.get("brownout_serves", 0)),
        ("dts_tpu_overload_limit_increases_total", "counter",
         overload.get("limit_increases", 0)),
        ("dts_tpu_overload_limit_decreases_total", "counter",
         overload.get("limit_decreases", 0)),
        ("dts_tpu_overload_state_changes_total", "counter", overload.get("state_changes", 0)),
    ):
        _family_lines(lines, metric, kind)
        lines.append(f"{metric} {value}")
    by_lane = overload.get("sheds_by_lane") or {}
    if by_lane:
        ls = "dts_tpu_overload_lane_sheds_total"
        _family_lines(lines, ls, "counter")
        for lane, n in sorted(by_lane.items()):
            lines.append(f'{ls}{{lane="{esc(lane)}"}} {n}')
    st = "dts_tpu_overload_pressure_state"
    _family_lines(lines, st, "gauge")
    current = overload.get("state", "nominal")
    for state in ("nominal", "brownout", "shed"):
        lines.append(f'{st}{{state="{esc(state)}"}} {1 if state == current else 0}')
    return lines


def _cascade_prometheus_lines(cascade: dict) -> list[str]:
    """dts_tpu_cascade_* exposition from a cascade_stats() snapshot, the
    JAX package's text: request / fallback counters, row dispositions
    (requested / survivor / pruned), per-stage wall time, the observed
    survivor and rank fractions, and the survivor-bucket counts."""
    esc = escape_label_value
    lines: list[str] = []
    for metric, kind, value in (
        ("dts_tpu_cascade_requests_total", "counter",
         cascade.get("requests", 0)),
        ("dts_tpu_cascade_fallbacks_total", "counter",
         cascade.get("fallbacks", 0)),
        ("dts_tpu_cascade_stage1_failures_total", "counter",
         cascade.get("stage1_failures", 0)),
        ("dts_tpu_cascade_host_prunes_total", "counter",
         cascade.get("host_prunes", 0)),
        ("dts_tpu_cascade_rows_ranked_total", "counter",
         cascade.get("rows_ranked", 0)),
        ("dts_tpu_cascade_zero_survivor_requests_total", "counter",
         cascade.get("zero_survivor_requests", 0)),
        ("dts_tpu_cascade_survivor_fraction", "gauge",
         cascade.get("survivor_fraction_observed", 0.0)),
        ("dts_tpu_cascade_rank_fraction", "gauge",
         cascade.get("rank_fraction", 0.0)),
    ):
        _family_lines(lines, metric, kind)
        lines.append(f"{metric} {value}")
    rows = "dts_tpu_cascade_rows_total"
    _family_lines(lines, rows, "counter")
    for disposition, key in (
        ("requested", "rows_requested"),
        ("survivor", "survivor_rows"),
        ("pruned", "pruned_rows"),
    ):
        lines.append(
            f'{rows}{{disposition="{disposition}"}} {cascade.get(key, 0)}'
        )
    st = "dts_tpu_cascade_stage_seconds_total"
    _family_lines(lines, st, "counter")
    for stage, key in (
        ("stage1", "stage1_seconds_total"),
        ("prune", "prune_seconds_total"),
        ("stage2", "stage2_seconds_total"),
    ):
        lines.append(f'{st}{{stage="{stage}"}} {cascade.get(key, 0.0)}')
    buckets = cascade.get("survivor_buckets") or {}
    if buckets:
        sb = "dts_tpu_cascade_survivor_bucket_total"
        _family_lines(lines, sb, "counter")
        for bucket, count in sorted(
            buckets.items(), key=lambda kv: int(kv[0])
        ):
            lines.append(f'{sb}{{bucket="{esc(str(bucket))}"}} {count}')
    return lines


def _integrity_prometheus_lines(integrity: dict) -> list[str]:
    """dts_tpu_integrity_* exposition from an integrity_stats() snapshot:
    wire verify / reject / stamp counters, screen trips (lifetime and the
    current window), shadow batches / mismatches and audits, escalations
    and the suspect verdict."""
    wire = integrity.get("wire") or {}
    screen = integrity.get("screen") or {}
    shadow = integrity.get("shadow") or {}
    lines: list[str] = []
    for metric, kind, value in (
        ("dts_tpu_integrity_wire_inputs_verified_total", "counter",
         wire.get("inputs_verified", 0)),
        ("dts_tpu_integrity_wire_inputs_rejected_total", "counter",
         wire.get("inputs_rejected", 0)),
        ("dts_tpu_integrity_wire_responses_stamped_total", "counter",
         wire.get("responses_stamped", 0)),
        ("dts_tpu_integrity_screen_trips_total", "counter", screen.get("trips", 0)),
        ("dts_tpu_integrity_screen_window_trips", "gauge", screen.get("window_trips", 0)),
        ("dts_tpu_integrity_shadow_batches_total", "counter", shadow.get("batches", 0)),
        ("dts_tpu_integrity_shadow_mismatches_total", "counter", shadow.get("mismatches", 0)),
        ("dts_tpu_integrity_audits_requested_total", "counter",
         shadow.get("audits_requested", 0)),
        ("dts_tpu_integrity_audits_run_total", "counter", shadow.get("audits_run", 0)),
        ("dts_tpu_integrity_escalations_total", "counter", integrity.get("escalations", 0)),
        ("dts_tpu_integrity_suspect", "gauge", int(bool(integrity.get("suspect")))),
    ):
        _family_lines(lines, metric, kind)
        lines.append(f"{metric} {value}")
    return lines


def _kernel_prometheus_lines(kernels: dict) -> list[str]:
    """dts_tpu_kernel_* exposition from a KernelManager snapshot dict
    (ops/autotune.py): plane counters, the per-bucket decision gauges (which
    variant each bucket serves), and the measured per-variant speedups —
    the autotune evidence, scrapeable. Families grouped and declared once
    — the exposition lint's invariants."""
    esc = escape_label_value
    lines: list[str] = []
    counters = kernels.get("counters") or {}
    for metric, kind, value in (
        ("dts_tpu_kernel_autotunes_total", "counter",
         counters.get("autotunes", 0)),
        ("dts_tpu_kernel_table_reuses_total", "counter",
         counters.get("table_reuses", 0)),
        ("dts_tpu_kernel_quantized_batches_total", "counter",
         counters.get("quantized_batches", 0)),
        ("dts_tpu_kernel_pallas_batches_total", "counter",
         counters.get("pallas_batches", 0)),
        ("dts_tpu_kernel_measure_only", "gauge",
         1 if kernels.get("measure_only") else 0),
        ("dts_tpu_kernel_int8_score_wire", "gauge",
         1 if kernels.get("int8_score_wire") else 0),
    ):
        _family_lines(lines, metric, kind)
        lines.append(f"{metric} {value}")
    decisions = kernels.get("decisions") or {}
    if decisions:
        q_lines, p_lines = [], []
        for mv, per_bucket in sorted(decisions.items()):
            for bucket, dec in sorted(
                per_bucket.items(), key=lambda kv: int(kv[0])
            ):
                base = (
                    f'model_version="{esc(mv)}",bucket="{esc(bucket)}"'
                )
                q_lines.append(
                    f"dts_tpu_kernel_bucket_quantized{{{base}}} "
                    f'{1 if dec.get("quantized") else 0}'
                )
                p_lines.append(
                    f"dts_tpu_kernel_bucket_pallas{{{base}}} "
                    f'{1 if dec.get("pallas") else 0}'
                )
        _family_lines(lines, "dts_tpu_kernel_bucket_quantized", "gauge")
        lines.extend(q_lines)
        _family_lines(lines, "dts_tpu_kernel_bucket_pallas", "gauge")
        lines.extend(p_lines)
    speed_lines = []
    for mv, table in sorted((kernels.get("tables") or {}).items()):
        for bucket, row in sorted(
            (table.get("buckets") or {}).items(), key=lambda kv: int(kv[0])
        ):
            for variant, entry in row.items():
                if not isinstance(entry, dict):
                    continue
                sp = entry.get("speedup")
                if sp is None:
                    continue
                speed_lines.append(
                    f'dts_tpu_kernel_variant_speedup{{model_version='
                    f'"{esc(mv)}",bucket="{esc(bucket)}",variant='
                    f'"{esc(variant)}"}} {sp}'
                )
    if speed_lines:
        _family_lines(lines, "dts_tpu_kernel_variant_speedup", "gauge")
        lines.extend(speed_lines)
    return lines


def _fleet_prometheus_lines(fleet: dict) -> list[str]:
    """dts_tpu_fleet_* exposition from a fleet_stats() snapshot: gossip membership (member count + members-by-state), exchange /
    record-disposition counters, the coordinated rollout picture (seq /
    fraction / blacklist on the router's coordinator; applied seq +
    apply counters on a replica's follower), and the router's forwarding
    counters. One function serves BOTH shapes — `role: "router"` carries
    `router`/`rollout` blocks, `role: "replica"` carries `follower` —
    so the lint's families-declared-once invariant holds either way."""
    esc = escape_label_value
    lines: list[str] = []
    role = str(fleet.get("role") or "replica")
    rl = "dts_tpu_fleet_role"
    _family_lines(lines, rl, "gauge")
    lines.append(f'{rl}{{role="{esc(role)}"}} 1')
    gossip = fleet.get("gossip") or {}
    members = gossip.get("members") or {}
    mc = "dts_tpu_fleet_members"
    _family_lines(lines, mc, "gauge")
    lines.append(f"{mc} {gossip.get('member_count', len(members))}")
    by_state: dict[str, int] = {}
    for rec in members.values():
        st = str((rec or {}).get("state") or "unknown")
        by_state[st] = by_state.get(st, 0) + 1
    ms = "dts_tpu_fleet_members_by_state"
    _family_lines(lines, ms, "gauge")
    for st, n in sorted(by_state.items()):
        lines.append(f'{ms}{{state="{esc(st)}"}} {n}')
    counters = gossip.get("counters") or {}
    ex = "dts_tpu_fleet_gossip_exchanges_total"
    _family_lines(lines, ex, "counter")
    lines.append(f'{ex}{{status="ok"}} {counters.get("exchanges_ok", 0)}')
    lines.append(
        f'{ex}{{status="failed"}} {counters.get("exchanges_failed", 0)}'
    )
    rec_t = "dts_tpu_fleet_gossip_records_total"
    _family_lines(lines, rec_t, "counter")
    for disp in ("accepted", "stale", "expired"):
        lines.append(
            f'{rec_t}{{disposition="{esc(disp)}"}} '
            f'{counters.get(f"records_{disp}", 0)}'
        )
    rollout = fleet.get("rollout") or {}
    follower = fleet.get("follower") or {}
    state = rollout.get("state") or {}
    if state or follower:
        seq = "dts_tpu_fleet_rollout_seq"
        _family_lines(lines, seq, "gauge")
        if state:
            lines.append(f'{seq}{{side="coordinator"}} {state.get("seq", 0)}')
        if follower:
            lines.append(
                f'{seq}{{side="applied"}} {follower.get("applied_seq", -1)}'
            )
    if state:
        for metric, value in (
            ("dts_tpu_fleet_rollout_fraction", state.get("fraction", 0.0)),
            ("dts_tpu_fleet_rollout_canary_version",
             state.get("canary_version") or 0),
            ("dts_tpu_fleet_rollout_blacklist_size",
             len(state.get("blacklist") or ())),
        ):
            _family_lines(lines, metric, "gauge")
            lines.append(f"{metric} {value}")
        rc = rollout.get("counters") or {}
        ch = "dts_tpu_fleet_rollout_changes_total"
        _family_lines(lines, ch, "counter")
        for kind in ("adoptions", "blacklists", "clears"):
            lines.append(f'{ch}{{kind="{esc(kind)}"}} {rc.get(kind, 0)}')
    if follower:
        ap = "dts_tpu_fleet_rollout_applies_total"
        _family_lines(lines, ap, "counter")
        lines.append(f"{ap} {follower.get('applies', 0)}")
        bl = "dts_tpu_fleet_rollout_blacklists_applied_total"
        _family_lines(lines, bl, "counter")
        lines.append(f"{bl} {follower.get('blacklists_applied', 0)}")
    router = fleet.get("router") or {}
    if router:
        rr = "dts_tpu_fleet_router_requests_total"
        _family_lines(lines, rr, "counter")
        lines.append(f'{rr}{{status="ok"}} {router.get("requests", 0)}')
        lines.append(f'{rr}{{status="error"}} {router.get("errors", 0)}')
        lines.append(
            f'{rr}{{status="degraded"}} {router.get("degraded", 0)}'
        )
        st = "dts_tpu_fleet_router_steers_total"
        _family_lines(lines, st, "counter")
        lines.append(
            f'{st}{{source="gossip"}} {router.get("gossip_steers", 0)}'
        )
        lines.append(
            f'{st}{{source="watch"}} {router.get("watch_updates", 0)}'
        )
        lines.append(
            f'{st}{{source="suspect"}} {router.get("suspect_steers", 0)}'
        )
        au = "dts_tpu_fleet_router_integrity_audits_total"
        _family_lines(lines, au, "counter")
        for outcome, key in (
            ("run", "integrity_audits"),
            ("disagreed", "audit_disagreements"),
            ("suspect_marked", "audit_suspects_marked"),
        ):
            lines.append(
                f'{au}{{outcome="{esc(outcome)}"}} {router.get(key, 0)}'
            )
        rj = "dts_tpu_fleet_router_rejoins_total"
        _family_lines(lines, rj, "counter")
        lines.append(f"{rj} {router.get('gossip_rejoins', 0)}")
        hb = "dts_tpu_fleet_router_healthy_backends"
        _family_lines(lines, hb, "gauge")
        lines.append(f"{hb} {router.get('healthy_backends', 0)}")
        tb = "dts_tpu_fleet_router_backends"
        _family_lines(lines, tb, "gauge")
        lines.append(f"{tb} {router.get('backends', 0)}")
    # Fleet aggregate + SLO blocks: present only on a router
    # whose observability plane is armed — fleet_stats() attaches them.
    agg = fleet.get("agg") or {}
    if agg:
        aq = "dts_tpu_fleet_agg_qps"
        _family_lines(lines, aq, "gauge")
        lines.append(f"{aq} {agg.get('qps', 0.0)}")
        al = "dts_tpu_fleet_agg_latency_ms"
        _family_lines(lines, al, "gauge")
        for q in ("p50", "p99"):
            lines.append(
                f'{al}{{quantile="{q}"}} {agg.get(f"{q}_ms", 0.0)}'
            )
        for metric, value in (
            ("dts_tpu_fleet_agg_requests", agg.get("requests", 0)),
            ("dts_tpu_fleet_agg_errors", agg.get("errors", 0)),
            ("dts_tpu_fleet_agg_members", agg.get("members", 0)),
            ("dts_tpu_fleet_agg_members_degraded",
             agg.get("members_degraded", 0)),
        ):
            _family_lines(lines, metric, "gauge")
            lines.append(f"{metric} {value}")
        per = agg.get("member_qps") or {}
        if per:
            mq = "dts_tpu_fleet_agg_member_qps"
            _family_lines(lines, mq, "gauge")
            for member, v in sorted(per.items()):
                lines.append(f'{mq}{{member="{esc(member)}"}} {v}')
    slo = fleet.get("slo") or {}
    if slo:
        lt = "dts_tpu_slo_latency_target_ms"
        _family_lines(lines, lt, "gauge")
        lines.append(f"{lt} {slo.get('latency_target_ms', 0.0)}")
        ob = "dts_tpu_slo_objective"
        _family_lines(lines, ob, "gauge")
        for name, v in sorted((slo.get("objectives") or {}).items()):
            lines.append(f'{ob}{{slo="{esc(name)}"}} {v}')
        br = "dts_tpu_slo_burn_rate"
        _family_lines(lines, br, "gauge")
        for name, wins in sorted((slo.get("burn") or {}).items()):
            for win in ("short", "long"):
                lines.append(
                    f'{br}{{slo="{esc(name)}",window="{win}"}} '
                    f'{(wins or {}).get(win, 0.0)}'
                )
        bu = "dts_tpu_slo_budget_remaining"
        _family_lines(lines, bu, "gauge")
        for name, v in sorted((slo.get("budget_remaining") or {}).items()):
            lines.append(f'{bu}{{slo="{esc(name)}"}} {v}')
        bd = "dts_tpu_slo_breached"
        _family_lines(lines, bd, "gauge")
        lines.append(f"{bd} {1 if slo.get('breached') else 0}")
        bt = "dts_tpu_slo_breaches_total"
        _family_lines(lines, bt, "counter")
        lines.append(f"{bt} {slo.get('breaches', 0)}")
    return lines


def fleet_prometheus_text(fleet: dict) -> str:
    """Standalone dts_tpu_fleet_* exposition — the router's /metrics body
    (the router has no ServerMetrics; its only Prometheus surface is the
    fleet plane itself). Replica-side fleet series ride the main
    prometheus_text(fleet=...) path instead."""
    return "\n".join(_fleet_prometheus_lines(fleet)) + "\n"


def resilience_prometheus_text(resilience: dict) -> str:
    """Prometheus text exposition of the CLIENT resilience state — the
    dict client.ShardedPredictClient.resilience_counters() returns
    (ResilienceCounters fields + an optional BackendScoreboard snapshot).
    The client has no scrape port of its own; a load harness writes this
    next to its artifacts so fleet dashboards ingest client-side hedging
    /failover/ejection state in the same format as the server plane."""
    esc = escape_label_value
    lines = []
    for key in (
        "hedges_fired", "hedges_won", "failovers",
        "backoff_sleeps", "partial_responses",
    ):
        if key in resilience:
            metric = f"dts_tpu_client_{key}_total"
            lines.append(f"# TYPE {metric} counter")
            lines.append(f"{metric} {int(resilience[key])}")
    sb = resilience.get("scoreboard")
    if sb:
        for key in ("ejections", "probes", "recoveries"):
            if key in sb:
                metric = f"dts_tpu_client_{key}_total"
                lines.append(f"# TYPE {metric} counter")
                lines.append(f"{metric} {int(sb[key])}")
        backends = sb.get("backends", {})
        if backends:
            lines.append("# TYPE dts_tpu_client_backend_up gauge")
            lines.append("# TYPE dts_tpu_client_backend_ewma_ms gauge")
            lines.append("# TYPE dts_tpu_client_backend_successes_total counter")
            lines.append("# TYPE dts_tpu_client_backend_failures_total counter")
            for host, st in backends.items():
                label = f'host="{esc(host)}"'
                up = 1 if st.get("state") == "healthy" else 0
                lines.append(
                    f'dts_tpu_client_backend_up{{{label},'
                    f'state="{esc(st.get("state", ""))}"}} {up}'
                )
                if st.get("ewma_ms") is not None:
                    lines.append(
                        f"dts_tpu_client_backend_ewma_ms{{{label}}} "
                        f'{st["ewma_ms"]}'
                    )
                lines.append(
                    f"dts_tpu_client_backend_successes_total{{{label}}} "
                    f'{st.get("successes", 0)}'
                )
                lines.append(
                    f"dts_tpu_client_backend_failures_total{{{label}}} "
                    f'{st.get("failures", 0)}'
                )
    return "\n".join(lines) + "\n" if lines else ""
