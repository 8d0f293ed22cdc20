"""Model-quality observability plane (the JAX package's serving/quality.py,
the same behaviour line for line): what the model predicts, per (model,
version), live.

- **ScoreSketch**: a streaming fixed-bin histogram (mergeable: drift math
  and the reference snapshot are bin-wise) with moments, at two horizons:
  lifetime and a sliced rolling window (a ring of epoch-stamped
  sub-histograms, O(bins) per record, no background thread).
- **Drift**: PSI and Jensen-Shannon divergence between binned score
  distributions: (a) the current window against a pinned reference (a JSON
  artifact, `[quality] reference_file`, pinned live by `POST
  /qualityz/snapshot`; the JAX package's format, so either package loads
  the other's), and (b) the two live versions of a model while the version
  watcher serves two (the `on_servable_change` hook).
- **Label feedback**: `POST /labelz` joins (trace id | row digest from
  cache/digest.py, the one row identity) + label + ts onto a bounded score
  reservoir: windowed AUC (train/data.py `auc`) and calibration (mean
  predicted against observed rate per predicted-probability decile).
- **Drift-linked exemplars**: when a drift check crosses the PSI
  threshold, the next N traced requests are annotated `quality.drift`;
  the tail sampler always keeps an annotated span, so /tracez shows which
  requests moved the distribution.

Fed by one hook in the batcher's completion worker (the scores are in host
memory after the readback: no device work). Only freshly computed scores
are sketched: warmup items, a batch with a screened row, top-k and cascade
prune readbacks, mixed row-cache assemblies and the integrity shadow's
readback are skipped, and whole-request cache hits never reach the
completion worker. The request's criticality lane rides along as a label.
Off by default; when off the completion worker reads one attribute per
batch. numpy only.
"""

from __future__ import annotations

import json
import logging
import math
import os
import threading
import time
from collections import OrderedDict, deque

import numpy as np

log = logging.getLogger("dts_torch.quality")

# Lane label for observations that carried no criticality metadata — the
# overload plane's own default lane name, duplicated here so this module
# stays importable without the controller.
_DEFAULT_LANE = "default"
_KNOWN_LANES = ("critical", "default", "sheddable", "probe")


def _normalize_lane(lane) -> str:
    lane = str(lane).strip().lower() if lane else ""
    return lane if lane in _KNOWN_LANES else _DEFAULT_LANE


# --------------------------------------------------------------------------
# Drift math: PSI + Jensen-Shannon over binned distributions.


def _proportions(counts, eps: float) -> np.ndarray:
    """Bin proportions with additive smoothing — drift math must stay
    finite when a bin is empty on one side (the textbook PSI failure)."""
    c = np.asarray(counts, dtype=np.float64) + eps
    return c / c.sum()


def psi(expected_counts, actual_counts, eps: float = 1e-4) -> float:
    """Population Stability Index between two binned distributions
    (expected = the reference). Industry reading: < 0.1 stable, 0.1-0.25
    moderate shift, > 0.25 major shift; the plane's default alert
    threshold (0.2) sits inside the moderate band."""
    p = _proportions(expected_counts, eps)
    q = _proportions(actual_counts, eps)
    return float(np.sum((q - p) * np.log(q / p)))


def js_divergence(p_counts, q_counts, eps: float = 1e-12) -> float:
    """Jensen-Shannon divergence (base 2: bounded [0, 1], symmetric) —
    the bounded companion to PSI, which is unbounded and jumpy on thin
    bins."""
    p = _proportions(p_counts, eps)
    q = _proportions(q_counts, eps)
    m = 0.5 * (p + q)

    def _kl(a, b):
        return float(np.sum(a * np.log2(a / b)))

    return 0.5 * _kl(p, m) + 0.5 * _kl(q, m)


def coarsen_counts(counts, target_bins: int) -> np.ndarray:
    """Merge adjacent histogram bins down to ~target_bins (bin-wise sums,
    so the result is still a valid distribution of the same data). PSI
    over many thin bins is dominated by sampling noise when one side's
    window is small — E[PSI] grows with occupied-bin count over sample
    size, and the empty-bin smoothing terms blow it up further — so
    DECISION consumers (the lifecycle rollback gate) compare coarsened
    views while the exposition keeps the fine bins."""
    counts = np.asarray(counts)
    k = max(2, min(int(target_bins), len(counts)))
    edges = np.linspace(0, len(counts), k + 1).astype(int)[:-1]
    return np.add.reduceat(counts, edges)


def histogram_percentile(
    counts, lo: float, hi: float, q: float
) -> float:
    """q in [0, 100] from a fixed-bin histogram over [lo, hi]; linear
    interpolation inside the winning bin."""
    counts = np.asarray(counts, dtype=np.float64)
    total = counts.sum()
    if total <= 0:
        return 0.0
    width = (hi - lo) / len(counts)
    target = q / 100.0 * total
    acc = 0.0
    for i, c in enumerate(counts):
        if acc + c >= target and c > 0:
            frac = (target - acc) / c
            return lo + width * (i + frac)
        acc += c
    return hi


# --------------------------------------------------------------------------
# Streaming sketch.


class ScoreSketch:
    """Streaming fixed-bin score histogram + moments, two horizons.

    Bins span [lo, hi] (CTR scores are sigmoid probabilities; out-of-range
    values clamp into the edge bins so nothing is silently dropped).
    Mergeable by construction: a distribution is its bin-count vector, so
    reference snapshots, version-pair drift, and cross-version merges are
    all element-wise adds. The rolling window is a ring of epoch-stamped
    slices (the utils/metrics.WindowedLatency pattern): record lands in
    the current slice, readout merges the slices still inside the window
    — O(bins) memory per slice, no background thread, injectable clock.
    """

    def __init__(
        self,
        bins: int = 50,
        lo: float = 0.0,
        hi: float = 1.0,
        window_s: float = 300.0,
        slices: int = 6,
        clock=time.monotonic,
    ):
        if hi <= lo:
            raise ValueError(f"sketch range [{lo}, {hi}] is empty")
        self.bins = max(2, int(bins))
        self.lo, self.hi = float(lo), float(hi)
        self.window_s = float(window_s)
        self.slices = max(2, int(slices))
        self.slice_s = self.window_s / self.slices
        self._clock = clock
        self._lock = threading.Lock()
        self._counts = np.zeros(self.bins, dtype=np.int64)
        self.count = 0
        self._sum = 0.0
        self._sum_sq = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._win_counts = np.zeros((self.slices, self.bins), dtype=np.int64)
        self._win_sums = [0.0] * self.slices
        self._win_sum_sqs = [0.0] * self.slices
        self._epochs = [-1] * self.slices

    def _bin_indices(self, scores: np.ndarray) -> np.ndarray:
        width = (self.hi - self.lo) / self.bins
        idx = np.floor((scores - self.lo) / width).astype(np.int64)
        return np.clip(idx, 0, self.bins - 1)

    def observe(self, scores) -> None:
        scores = np.asarray(scores, dtype=np.float64).ravel()
        if scores.size == 0:
            return
        binned = np.bincount(self._bin_indices(scores), minlength=self.bins)
        s, ss = float(scores.sum()), float(np.square(scores).sum())
        with self._lock:
            now = self._clock()
            epoch = int(now / self.slice_s)
            slot = epoch % self.slices
            if self._epochs[slot] != epoch:
                self._epochs[slot] = epoch
                self._win_counts[slot] = 0
                self._win_sums[slot] = 0.0
                self._win_sum_sqs[slot] = 0.0
            self._counts += binned
            self._win_counts[slot] += binned
            self._win_sums[slot] += s
            self._win_sum_sqs[slot] += ss
            self.count += scores.size
            self._sum += s
            self._sum_sq += ss
            self._min = min(self._min, float(scores.min()))
            self._max = max(self._max, float(scores.max()))

    def lifetime_counts(self) -> np.ndarray:
        with self._lock:
            return self._counts.copy()

    def window_counts(self) -> np.ndarray:
        """Merged bin counts of the slices still inside the window."""
        with self._lock:
            current = int(self._clock() / self.slice_s)
            out = np.zeros(self.bins, dtype=np.int64)
            for slot in range(self.slices):
                e = self._epochs[slot]
                if e >= 0 and current - e < self.slices:
                    out += self._win_counts[slot]
            return out

    def _window_moments(self) -> tuple[int, float, float]:
        with self._lock:
            current = int(self._clock() / self.slice_s)
            n, s, ss = 0, 0.0, 0.0
            for slot in range(self.slices):
                e = self._epochs[slot]
                if e >= 0 and current - e < self.slices:
                    n += int(self._win_counts[slot].sum())
                    s += self._win_sums[slot]
                    ss += self._win_sum_sqs[slot]
            return n, s, ss

    @staticmethod
    def _moment_stats(n: int, s: float, ss: float) -> dict:
        if n == 0:
            return {"count": 0, "mean": 0.0, "std": 0.0}
        mean = s / n
        var = max(ss / n - mean * mean, 0.0)
        return {"count": n, "mean": round(mean, 6), "std": round(math.sqrt(var), 6)}

    def snapshot(self) -> dict:
        counts = self.lifetime_counts()
        with self._lock:
            n, s, ss = self.count, self._sum, self._sum_sq
        win = self.window_counts()
        wn, wsum, wss = self._window_moments()
        pct = lambda c, q: round(  # noqa: E731
            histogram_percentile(c, self.lo, self.hi, q), 6
        )
        return {
            **self._moment_stats(n, s, ss),
            "min": round(self._min, 6) if n else 0.0,
            "max": round(self._max, 6) if n else 0.0,
            "p50": pct(counts, 50),
            "p90": pct(counts, 90),
            "p99": pct(counts, 99),
            "window": {
                "window_s": self.window_s,
                **self._moment_stats(wn, wsum, wss),
                "p50": pct(win, 50),
                "p99": pct(win, 99),
            },
        }


# --------------------------------------------------------------------------
# Label feedback: score reservoir + windowed (score, label) join.


# Re-exported from cache/digest.py, the one row identity (shared with
# dedup and the score-cache key), so "this label belongs to that
# candidate" means the same bytes on both sides.
from ..cache.digest import row_label_keys  # noqa: E402  (public API here)


class _LabelJoin:
    """Bounded score reservoir + the windowed (score, label) pair set.

    Reservoir entries are keyed by string id — a trace id (whole-request
    scores vector; `<trace_id>#<row>` addresses one candidate) or a row
    digest hex (one candidate's scalar score). LRU-bounded: feedback
    loops deliver labels minutes after the impression, so the reservoir
    holds the most recent keys and everything older joins as ORPHANED —
    visible, never silently dropped."""

    def __init__(
        self, max_keys: int = 8192, pair_window: int = 8192,
        window_s: float = 300.0, clock=time.monotonic,
    ):
        self.max_keys = max(16, int(max_keys))
        self.window_s = float(window_s)
        self._clock = clock
        self._lock = threading.Lock()
        # key -> (model, version, scores ndarray | float, t)
        self._reservoir: OrderedDict[str, tuple] = OrderedDict()
        self._pairs: deque[tuple] = deque(maxlen=max(16, int(pair_window)))
        self.joined = 0
        self.orphaned = 0
        self.late = 0
        # Label-feedback delay (seconds between the client-reported event
        # time `ts`, epoch wall clock, and ingest) — the loop-lag signal
        # a rollback gate must subtract before reading a windowed AUC.
        self.delay_count = 0
        self.delay_sum_s = 0.0
        self.delay_max_s = 0.0

    def put(self, key: str, model: str, version: int, scores, t: float) -> None:
        with self._lock:
            self._reservoir[key] = (model, version, scores, t)
            self._reservoir.move_to_end(key)
            while len(self._reservoir) > self.max_keys:
                self._reservoir.popitem(last=False)

    def reservoir_len(self) -> int:
        with self._lock:
            return len(self._reservoir)

    def ingest(self, key: str, label: float, ts: float | None = None) -> bool:
        """Join one label; True = joined, False = orphaned (no score under
        that key — evicted, never sampled, or a bad id). `<id>#<row>`
        addresses one row of a vector entry. `ts` (epoch seconds of the
        label EVENT, when the client reports one) feeds the feedback-
        delay telemetry; it is never used for window membership — the
        window runs on this process's monotonic clock, and trusting a
        remote wall clock there would let skew rewrite history."""
        if ts is not None:
            delay = time.time() - float(ts)
            if 0.0 <= delay < 7 * 86400.0:  # sane: not future, not ancient
                with self._lock:
                    self.delay_count += 1
                    self.delay_sum_s += delay
                    self.delay_max_s = max(self.delay_max_s, delay)
        base, _, row = key.partition("#")
        try:
            row_idx = int(row) if row else 0
        except ValueError:
            row_idx = -1
        with self._lock:
            entry = self._reservoir.get(base if row else key)
            if entry is None or row_idx < 0:
                self.orphaned += 1
                return False
            model, version, scores, t0 = entry
            if isinstance(scores, np.ndarray):
                if row_idx >= scores.size:
                    self.orphaned += 1
                    return False
                score = float(scores[row_idx])
            else:
                score = float(scores)
            now = self._clock()
            if now - t0 > self.window_s:
                # Joined, but the impression already aged out of the
                # rolling window — counted so a slow feedback loop is
                # visible as `late`, not mistaken for orphaning.
                self.late += 1
            self.joined += 1
            self._pairs.append((score, float(label), now, model, version))
            return True

    def window_pairs(
        self, model: str | None = None, version: int | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """In-window (score, label) pairs; model/version restrict to one
        series — the per-version windowed AUC the lifecycle plane's
        rollback gate compares between a stable and its canary."""
        with self._lock:
            cutoff = self._clock() - self.window_s
            live = [
                (s, l) for s, l, t, m, v in self._pairs
                if t >= cutoff
                and (model is None or m == model)
                and (version is None or int(v) == int(version))
            ]
        if not live:
            return np.empty(0), np.empty(0)
        arr = np.asarray(live, dtype=np.float64)
        return arr[:, 0], arr[:, 1]


def calibration_report(
    scores: np.ndarray, labels: np.ndarray, deciles: int = 10
) -> dict:
    """Mean predicted vs observed positive rate per predicted-probability
    decile, plus the count-weighted expected calibration error."""
    if scores.size == 0:
        return {"error": None, "deciles": []}
    edges = np.linspace(0.0, 1.0, deciles + 1)
    idx = np.clip(
        np.digitize(np.clip(scores, 0.0, 1.0), edges[1:-1]), 0, deciles - 1
    )
    out = []
    err = 0.0
    for d in range(deciles):
        mask = idx == d
        n = int(mask.sum())
        if n == 0:
            continue
        mean_pred = float(scores[mask].mean())
        observed = float(labels[mask].mean())
        err += n / scores.size * abs(mean_pred - observed)
        out.append({
            "decile": d,
            "count": n,
            "mean_predicted": round(mean_pred, 6),
            "observed_rate": round(observed, 6),
        })
    return {"error": round(err, 6), "deciles": out}


# --------------------------------------------------------------------------
# The monitor.


class QualityMonitor:
    """Per-(model, version) score-distribution plane + drift + label join.

    One `observe()` per completed (non-warmup) request from the batcher
    completer; everything else is read paths (/qualityz, /monitoring,
    Prometheus) or the label-feedback ingest. Thread-safe; the sketches
    carry their own locks so concurrent completers never serialize on the
    monitor lock for the histogram math."""

    # Bounded series space, the ServerMetrics precedent: client-supplied
    # model names must not grow sketches without limit.
    MAX_SERIES = 64

    def __init__(
        self,
        *,
        bins: int = 50,
        lo: float = 0.0,
        hi: float = 1.0,
        window_s: float = 300.0,
        slices: int = 6,
        drift_threshold_psi: float = 0.2,
        drift_check_interval_s: float = 5.0,
        exemplar_traces: int = 8,
        reservoir_keys: int = 8192,
        label_window: int = 8192,
        digest_rows_limit: int = 256,
        reference_file: str = "",
        min_drift_count: int = 50,
        clock=time.monotonic,
    ):
        self.bins, self.lo, self.hi = int(bins), float(lo), float(hi)
        self.window_s, self.slices = float(window_s), int(slices)
        self.drift_threshold_psi = float(drift_threshold_psi)
        self.drift_check_interval_s = float(drift_check_interval_s)
        self.exemplar_traces = int(exemplar_traces)
        self.digest_rows_limit = int(digest_rows_limit)
        self.reference_file = reference_file
        self.min_drift_count = int(min_drift_count)
        self._clock = clock
        self._lock = threading.Lock()
        self._sketches: dict[tuple[str, int], ScoreSketch] = {}
        self._lanes: dict[tuple[str, int], dict[str, int]] = {}
        # model -> {"counts": np.ndarray, "count": int, "pinned_at": float}
        self._reference: dict[str, dict] = {}
        self._labels = _LabelJoin(
            max_keys=reservoir_keys, pair_window=label_window,
            window_s=window_s, clock=clock,
        )
        self._last_drift_check = -math.inf
        self._last_drift: dict[str, dict] = {}
        self._exemplar_budget = 0
        self.exemplars_marked = 0
        self.drift_events = 0
        self.version_changes = 0
        self.observed_requests = 0
        self.series_overflow = 0
        if reference_file:
            try:
                self.load_reference(reference_file, missing_ok=True)
            except Exception:  # noqa: BLE001 — a corrupt artifact must
                log.exception(    # never fail serving startup
                    "could not load quality reference %s", reference_file
                )

    # ------------------------------------------------------------ ingestion

    def _sketch(self, model: str, version: int) -> ScoreSketch | None:
        key = (model, int(version))
        with self._lock:
            sk = self._sketches.get(key)
            if sk is None:
                if len(self._sketches) >= self.MAX_SERIES:
                    self.series_overflow += 1
                    return None
                sk = ScoreSketch(
                    bins=self.bins, lo=self.lo, hi=self.hi,
                    window_s=self.window_s, slices=self.slices,
                    clock=self._clock,
                )
                self._sketches[key] = sk
                self._lanes[key] = {}
            return sk

    def observe(
        self,
        model: str,
        version: int,
        scores,
        *,
        lane: str | None = None,
        span=None,
        arrays: dict[str, np.ndarray] | None = None,
        trace_id: str | None = None,
    ) -> None:
        """One completed request's freshly computed scores. Called from
        the batcher completer with warmup already excluded (cache hits and
        brownout stale-serves never reach the completer — structural
        exclusion). `span`/`trace_id` arm the exemplar + trace-id join
        paths when tracing is on; `arrays` (the request's decoded feature
        tensors) feeds the row-digest join for small requests."""
        scores = np.asarray(scores, dtype=np.float64).ravel()
        if scores.size == 0:
            return
        sketch = self._sketch(model, int(version))
        if sketch is None:
            return
        sketch.observe(scores)
        now = self._clock()
        lane = _normalize_lane(lane)
        with self._lock:
            self.observed_requests += 1
            lanes = self._lanes[(model, int(version))]
            lanes[lane] = lanes.get(lane, 0) + 1
        # Score reservoir for the label join — outside the lock (put()
        # locks internally); f32 copies so resolved futures can't alias.
        kept = scores.astype(np.float32)
        if trace_id:
            self._labels.put(trace_id, model, int(version), kept, now)
        if arrays is not None and scores.size <= self.digest_rows_limit:
            try:
                keys = row_label_keys(arrays)
            except Exception:  # noqa: BLE001 — odd dtypes must not
                keys = []      # poison the completer
            for i, key in enumerate(keys[: scores.size]):
                self._labels.put(key, model, int(version), float(kept[i]), now)
        # Drift tick: opportunistic, no background thread (the overload
        # controller's cadence pattern) — O(models x bins) at most once
        # per drift_check_interval_s.
        if now - self._last_drift_check >= self.drift_check_interval_s:
            self._drift_tick(now)
        # Drift-linked exemplar: while the budget is armed, annotate the
        # next traced requests — annotated spans are ALWAYS retained by
        # the tail sampler, so /tracez shows the requests that moved the
        # distribution.
        if span is not None and self._exemplar_budget > 0:
            with self._lock:
                if self._exemplar_budget <= 0:
                    return
                self._exemplar_budget -= 1
                self.exemplars_marked += 1
                worst = self._max_reference_psi()
            try:
                span.annotate(
                    "quality.drift", model=model, version=int(version),
                    psi=round(worst, 4) if worst is not None else None,
                )
            except Exception:  # noqa: BLE001 — a finished/odd span must
                pass           # never poison the completer

    def note_servable_change(self, model: str) -> None:
        """Version-watcher hook (load or retire) — the same wiring slot
        the cache plane's invalidation rides. Counts transitions; the
        version-pair drift itself reads from whatever versions have
        window data, so no bookkeeping beyond the sketches is needed."""
        with self._lock:
            self.version_changes += 1

    # ---------------------------------------------------------------- drift

    def _window_counts_locked(self, model: str) -> np.ndarray:
        """Merged window counts across every version of `model`. Caller
        must NOT hold the monitor lock for sketch reads (sketches lock
        themselves); this only reads the key list under the lock."""
        with self._lock:
            keys = [k for k in self._sketches if k[0] == model]
        out = np.zeros(self.bins, dtype=np.int64)
        for k in keys:
            out += self._sketches[k].window_counts()
        return out

    def _max_reference_psi(self) -> float | None:
        vals = [
            d["reference"]["psi"]
            for d in self._last_drift.values()
            if d.get("reference")
        ]
        return max(vals) if vals else None

    def _drift_tick(self, now: float) -> None:
        with self._lock:
            if now - self._last_drift_check < self.drift_check_interval_s:
                return  # another completer ticked while we raced here
            self._last_drift_check = now
            models = sorted({m for m, _v in self._sketches})
            reference = dict(self._reference)
        drift: dict[str, dict] = {}
        exceeded = False
        for model in models:
            entry: dict = {"reference": None, "version_pair": None}
            window = self._window_counts_locked(model)
            ref = reference.get(model)
            if ref is not None and window.sum() >= self.min_drift_count:
                entry["reference"] = {
                    "psi": round(psi(ref["counts"], window), 6),
                    "js": round(js_divergence(ref["counts"], window), 6),
                    "window_count": int(window.sum()),
                    "reference_count": int(ref["count"]),
                }
                if entry["reference"]["psi"] >= self.drift_threshold_psi:
                    exceeded = True
            entry["version_pair"] = self._version_pair_drift(model)
            if (
                entry["version_pair"] is not None
                and entry["version_pair"]["psi"] >= self.drift_threshold_psi
            ):
                exceeded = True
            drift[model] = entry
        with self._lock:
            was_armed = self._exemplar_budget > 0
            self._last_drift = drift
            if exceeded:
                if not was_armed:
                    self.drift_events += 1
                # Re-arm every tick while above threshold: a sustained
                # shift keeps producing exemplars at a bounded rate (N
                # per check interval), not one burst then silence.
                self._exemplar_budget = self.exemplar_traces
            elif not exceeded and was_armed:
                self._exemplar_budget = 0

    def _version_pair_drift(self, model: str) -> dict | None:
        """PSI/JS between the two live versions' windowed distributions —
        the canary-vs-stable comparison the lifecycle plane needs. 'Live' =
        has at least min_drift_count scores in the current window; with
        fewer than two live versions there is nothing to compare."""
        with self._lock:
            versions = sorted(v for m, v in self._sketches if m == model)
        live = []
        for v in versions:
            counts = self._sketches[(model, v)].window_counts()
            if counts.sum() >= self.min_drift_count:
                live.append((v, counts))
        if len(live) < 2:
            return None
        (v_old, c_old), (v_new, c_new) = live[-2], live[-1]
        return {
            "versions": [int(v_old), int(v_new)],
            "psi": round(psi(c_old, c_new), 6),
            "js": round(js_divergence(c_old, c_new), 6),
            "counts": [int(c_old.sum()), int(c_new.sum())],
        }

    # ------------------------------------------------ lifecycle read API

    def version_window_count(self, model: str, version: int) -> int:
        """Scores observed for one (model, version) inside the rolling
        window — the lifecycle controller's evidence floor before a
        canary may be judged (promote OR rollback)."""
        with self._lock:
            sk = self._sketches.get((model, int(version)))
        return int(sk.window_counts().sum()) if sk is not None else 0

    def pair_drift(
        self, model: str, v_old: int, v_new: int,
        min_count: int | None = None, decision_bins: int | None = None,
    ) -> dict | None:
        """PSI/JS between TWO NAMED versions' windowed distributions —
        the explicit (stable, canary) comparison the lifecycle rollback
        gate reads, as opposed to _version_pair_drift's 'two most active'
        heuristic the passive surfaces show. None until both sides hold
        at least `min_count` (default: this monitor's min_drift_count)
        windowed scores — drift over a handful of scores is noise.

        decision_bins coarsens both sides before the divergence math: a
        fresh canary's window is SMALL, and same-distribution PSI over
        50 thin bins at a few hundred samples measures 0.2-0.3 of pure
        sampling noise (measured; the empty-bin smoothing terms dominate)
        — within reach of a rollback threshold — while ~10 merged bins
        put the noise floor at ~0.03 with a genuine shift still reading
        >1. Gates should pass ~10; the passive surfaces keep the fine
        bins."""
        floor = self.min_drift_count if min_count is None else int(min_count)
        with self._lock:
            sk_old = self._sketches.get((model, int(v_old)))
            sk_new = self._sketches.get((model, int(v_new)))
        if sk_old is None or sk_new is None:
            return None
        c_old, c_new = sk_old.window_counts(), sk_new.window_counts()
        if c_old.sum() < floor or c_new.sum() < floor:
            return None
        if decision_bins:
            c_old = coarsen_counts(c_old, decision_bins)
            c_new = coarsen_counts(c_new, decision_bins)
        return {
            "versions": [int(v_old), int(v_new)],
            "psi": round(psi(c_old, c_new), 6),
            "js": round(js_divergence(c_old, c_new), 6),
            "counts": [int(c_old.sum()), int(c_new.sum())],
            "bins": int(len(c_old)),
        }

    def version_auc(
        self, model: str, version: int
    ) -> tuple[float | None, int]:
        """(windowed AUC, pair count) for ONE version's label-feedback
        joins — the exact train/data.py::auc, None when the window is
        empty or single-class. The lifecycle gate compares this between
        stable and canary before trusting an AUC delta."""
        scores, labels = self._labels.window_pairs(model, int(version))
        if scores.size == 0:
            return None, 0
        try:
            from ..train.data import auc as exact_auc

            return round(float(exact_auc(labels, scores)), 6), int(scores.size)
        except ValueError:
            return None, int(scores.size)  # single-class window

    # ------------------------------------------------------------ reference

    def pin_reference(self, save: bool = True) -> dict:
        """Pin each model's CURRENT windowed distribution (merged across
        its versions; lifetime fallback when the window is empty) as the
        drift reference, and persist the artifact when a reference_file is
        configured. Returns {model: count_pinned, "path": ...}."""
        with self._lock:
            models = sorted({m for m, _v in self._sketches})
        pinned: dict = {}
        now = self._clock()
        for model in models:
            counts = self._window_counts_locked(model)
            if counts.sum() == 0:
                with self._lock:
                    keys = [k for k in self._sketches if k[0] == model]
                for k in keys:
                    counts += self._sketches[k].lifetime_counts()
            if counts.sum() == 0:
                continue
            with self._lock:
                self._reference[model] = {
                    "counts": counts.astype(np.int64),
                    "count": int(counts.sum()),
                    "pinned_at": now,
                }
            pinned[model] = int(counts.sum())
        path = None
        if save and self.reference_file:
            path = self.save_reference(self.reference_file)
        return {"models": pinned, "path": path}

    def save_reference(self, path: str) -> str:
        with self._lock:
            doc = {
                "bins": self.bins, "lo": self.lo, "hi": self.hi,
                "models": {
                    m: {
                        "counts": [int(c) for c in ref["counts"]],
                        "count": ref["count"],
                    }
                    for m, ref in self._reference.items()
                },
            }
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)  # atomic: a reader never sees a torn artifact
        return path

    def load_reference(self, path: str, missing_ok: bool = False) -> int:
        """Load a pinned-reference artifact; returns the number of model
        entries loaded. Entries whose bin geometry differs from this
        monitor's are skipped (logged) — comparing across geometries would
        produce confident nonsense."""
        if missing_ok and not os.path.exists(path):
            return 0
        with open(path) as f:
            doc = json.load(f)
        if (
            doc.get("bins") != self.bins
            or doc.get("lo") != self.lo
            or doc.get("hi") != self.hi
        ):
            log.warning(
                "quality reference %s has bin geometry (%s, %s, %s) != "
                "configured (%d, %s, %s); ignoring it",
                path, doc.get("bins"), doc.get("lo"), doc.get("hi"),
                self.bins, self.lo, self.hi,
            )
            return 0
        loaded = 0
        now = self._clock()
        with self._lock:
            for model, ref in (doc.get("models") or {}).items():
                counts = np.asarray(ref.get("counts", ()), dtype=np.int64)
                if counts.shape != (self.bins,) or counts.sum() <= 0:
                    continue
                self._reference[model] = {
                    "counts": counts,
                    "count": int(ref.get("count", counts.sum())),
                    "pinned_at": now,
                }
                loaded += 1
        return loaded

    # ------------------------------------------------------- label feedback

    def ingest_labels(self, items) -> dict:
        """POST /labelz body: items of {"id": str, "label": 0|1,
        "ts": optional epoch seconds of the label event}. Returns
        joined/orphaned counts for THIS call.

        Labels are BINARY: the windowed AUC ranks against exact class
        membership (train/data.py::auc), so a fractional "label" would
        silently produce garbage — refused up front instead. The whole
        batch is validated BEFORE any item is applied: a malformed item
        mid-list must not leave a joined prefix behind a 400 (the
        client's retry would double-count those pairs)."""
        validated = []
        for item in items:
            if not isinstance(item, dict) or "id" not in item or "label" not in item:
                raise ValueError(
                    'each label item needs "id" and "label" fields'
                )
            label = float(item["label"])
            if label not in (0.0, 1.0):
                raise ValueError(f"label must be 0 or 1, got {label}")
            ts = item.get("ts")
            if ts is not None:
                ts = float(ts)
            validated.append((str(item["id"]), label, ts))
        joined = orphaned = 0
        for key, label, ts in validated:
            if self._labels.ingest(key, label, ts):
                joined += 1
            else:
                orphaned += 1
        return {"joined": joined, "orphaned": orphaned}

    def _label_block(self) -> dict:
        scores, labels = self._labels.window_pairs()
        auc_val = None
        if scores.size:
            try:
                from ..train.data import auc as exact_auc

                auc_val = round(float(exact_auc(labels, scores)), 6)
            except ValueError:
                auc_val = None  # single-class window: AUC undefined
        lj = self._labels
        return {
            "joined": lj.joined,
            "orphaned": lj.orphaned,
            "late": lj.late,
            "window_pairs": int(scores.size),
            "reservoir_keys": lj.reservoir_len(),
            "auc": auc_val,
            "calibration": calibration_report(scores, labels),
            # Client-reported event-time lag (ts -> ingest): how stale
            # the feedback loop itself runs.
            "feedback_delay": {
                "count": lj.delay_count,
                "mean_s": round(
                    lj.delay_sum_s / lj.delay_count, 3
                ) if lj.delay_count else None,
                "max_s": round(lj.delay_max_s, 3),
            },
        }

    # --------------------------------------------------------------- export

    def snapshot(self, model: str | None = None, version: int | None = None) -> dict:
        """The /qualityz body (and the `quality` /monitoring block).
        model=/version= restrict the per-series detail; drift, labels, and
        the counters are plane-wide either way."""
        with self._lock:
            keys = sorted(self._sketches)
            drift = {
                m: {
                    k: (dict(v) if isinstance(v, dict) else v)
                    for k, v in d.items()
                }
                for m, d in self._last_drift.items()
            }
            reference = {
                m: {"count": ref["count"], "pinned_at": round(ref["pinned_at"], 3)}
                for m, ref in self._reference.items()
            }
            counters = {
                "observed_requests": self.observed_requests,
                "version_changes": self.version_changes,
                "series_overflow": self.series_overflow,
            }
            exemplars = {
                "budget": self._exemplar_budget,
                "marked": self.exemplars_marked,
                "drift_events": self.drift_events,
            }
        models: dict = {}
        for m, v in keys:
            if model is not None and m != model:
                continue
            if version is not None and v != int(version):
                continue
            blk = models.setdefault(m, {"versions": {}})
            sk = self._sketches[(m, v)]
            snap = sk.snapshot()
            snap["lanes"] = dict(self._lanes.get((m, v), {}))
            # Raw lifetime bin counts ride the snapshot so exporters (the
            # Prometheus histogram family) and offline drift tooling can
            # work from the JSON alone, no monitor object in hand.
            snap["histogram"] = {
                "lo": self.lo, "hi": self.hi,
                "counts": [int(c) for c in sk.lifetime_counts()],
            }
            blk["versions"][str(v)] = snap
        for m, blk in models.items():
            d = drift.get(m, {"reference": None, "version_pair": None})
            ref_psi = (d.get("reference") or {}).get("psi")
            pair_psi = (d.get("version_pair") or {}).get("psi")
            blk["drift"] = {
                **d,
                "threshold_psi": self.drift_threshold_psi,
                "exceeded": any(
                    p is not None and p >= self.drift_threshold_psi
                    for p in (ref_psi, pair_psi)
                ),
            }
            blk["reference_pinned"] = m in reference
        return {
            "enabled": True,
            "config": {
                "bins": self.bins, "lo": self.lo, "hi": self.hi,
                "window_s": self.window_s,
                "drift_threshold_psi": self.drift_threshold_psi,
                "drift_check_interval_s": self.drift_check_interval_s,
                "exemplar_traces": self.exemplar_traces,
                "reference_file": self.reference_file,
            },
            **counters,
            "exemplars": exemplars,
            "reference": reference,
            "labels": self._label_block(),
            "models": models,
        }
