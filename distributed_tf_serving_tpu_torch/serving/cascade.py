"""The ranking cascade inside the server: retrieval, then rank, in one RPC.

A cheap stage-1 servable scores every candidate of a Predict; a prune on
the device keeps the `plan_k(n)` best (ops/transfer.py cascade_prune_device:
only the survivor (score, index) pairs and the stage-1 vector, at the wire
dtype, are read back); the primary model ranks only the survivors, in the
smaller bucket they fit. Stage-2 scores go back to their rows, pruned rows
keep their stage-1 scores, and the response carries per-row provenance
(`cascade_stage`: 1 = stage-1 score, 2 = ranked by the primary model).

- Both stages are ordinary DynamicBatcher submits of ordinary servables,
  so the cache, overload, deadline and tracing planes apply to each. The
  prune submit salts its score cache key with its k, so a prune result
  never answers a full request; the row cache keys on the model name.
- The stage-1 model is a normal servable under its own name: published with
  `publish_stage1` (interop/export.py publish_version over
  train/checkpoint.py save_servable), it is loaded and hot-swapped by a
  VersionWatcher. A stage-1 model that is missing, or a stage-1 submit that
  fails, degrades to a full stage-2 pass (provenance all 2): the RPC never
  fails because of stage 1.
- Deadlines are recomputed between the stages: stage 2 gets what is left.
- Refused beside `output_top_k` (its wire replaces the score vector the
  scatter fills), serving/server.py build_stack.

Spans: `cascade.stage1` (submit and wait), `cascade.prune` (the host
finish: threshold filter and survivor gather), `cascade.stage2`.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from ..utils.tracing import request_trace

# The provenance output, encoded beside the score tensor (not part of the
# signature).
STAGE_OUTPUT = "cascade_stage"
STAGE1 = 1  # the row kept its stage-1 score (pruned before ranking)
STAGE2 = 2  # the row was ranked by the primary model


class CascadeStats:
    """The counters behind /cascadez and dts_tpu_cascade_*; RPC threads of
    both transports bump them, under the lock."""

    _FIELDS = (
        "requests", "fallbacks", "stage1_failures", "rows_requested",
        "rows_ranked", "pruned_rows", "survivor_rows",
        "zero_survivor_requests", "host_prunes",
    )

    def __init__(self):
        self._lock = threading.Lock()
        for f in self._FIELDS:
            setattr(self, f, 0)
        self.stage1_s = 0.0
        self.prune_s = 0.0
        self.stage2_s = 0.0
        # Stage-2 submits by the bucket the survivors ran in.
        self.survivor_buckets: dict[int, int] = {}


class CascadeOrchestrator:
    """The two-stage pipeline above the DynamicBatcher, consulted by
    PredictionServiceImpl per Predict. Eligible: the output filter names
    exactly the score output (the scatter fills a score vector, and mixed
    stages would mean nothing for another output), the request has at
    least `min_candidates` rows and the survivor count prunes something."""

    def __init__(
        self,
        registry,
        batcher,
        stage1_model: str = "stage1",
        survivor_k: int = 0,
        survivor_fraction: float = 0.25,
        score_threshold: float = 0.0,
        min_candidates: int = 8,
    ):
        self.registry = registry
        self.batcher = batcher
        self.stage1_model = stage1_model
        self.survivor_k = survivor_k
        self.survivor_fraction = survivor_fraction
        self.score_threshold = score_threshold
        self.min_candidates = min_candidates
        self.stats = CascadeStats()

    # ------------------------------------------------------- eligibility

    def eligible(self, servable, fetch_keys, n: int) -> bool:
        """The per-request gate, on the RPC thread."""
        return (
            n >= self.min_candidates
            and servable.name != self.stage1_model
            and fetch_keys is not None
            and len(fetch_keys) == 1
            and fetch_keys[0] == servable.model.score_output
            and self.plan_k(n) < n
        )

    def plan_k(self, n: int) -> int:
        """Survivors of an n-candidate request: survivor_k when set, else
        the fraction of n (at least 1)."""
        if self.survivor_k > 0:
            return self.survivor_k
        return max(1, int(n * self.survivor_fraction))

    # ---------------------------------------------------------- pipeline

    def _stage1_servable(self):
        """The newest stage-1 version, or None (not published yet, or
        unloaded mid-rollout): the caller falls back to a full pass."""
        try:
            return self.registry.resolve(self.stage1_model, None)
        except Exception:  # noqa: BLE001 — NOT_FOUND during a rollout
            return None

    def _finalize_prune(self, s1: dict, stage1, n: int, k: int):
        """The host end of the prune: the device prune's result (survivor
        pairs and the stage-1 vector), or a full score vector where the
        prune did not arm (pruned here, counted in host_prunes); then the
        score threshold. Returns (survivor indices, the stage-1 scores as
        a writable float32[n])."""
        if "survivor_indices" in s1:
            idx = np.asarray(s1["survivor_indices"])[:k]
            vals = np.asarray(s1["survivor_scores"], np.float32)[:k]
            full = np.array(s1["stage1_scores"], np.float32, copy=True)
        else:
            with self.stats._lock:
                self.stats.host_prunes += 1
            full = np.array(s1[stage1.model.score_output], np.float32, copy=True).reshape(-1)
            # The head ordered by score, descending, as the device returns
            # it, so the threshold below sees the same view.
            idx = np.argpartition(-full, k - 1)[:k]
            idx = idx[np.argsort(-full[idx], kind="stable")]
            vals = full[idx]
        if self.score_threshold > 0.0:
            idx = idx[vals >= self.score_threshold]
        return idx.astype(np.int64), full

    @staticmethod
    def _scatter(final: np.ndarray, idx, stage2_scores) -> np.ndarray:
        """Stage-2 scores into their rows of `final`; the provenance."""
        provenance = np.full(final.shape[0], STAGE1, np.int32)
        if len(idx):
            final[idx] = np.asarray(stage2_scores, np.float32).reshape(-1)
            provenance[idx] = STAGE2
        return provenance

    def _note(self, n: int, idx, bucket: int, t1: float, tp: float, t2: float) -> None:
        s = self.stats
        with s._lock:
            s.requests += 1
            s.rows_requested += n
            s.rows_ranked += len(idx)
            s.survivor_rows += len(idx)
            s.pruned_rows += n - len(idx)
            if len(idx) == 0:
                s.zero_survivor_requests += 1
            else:
                s.survivor_buckets[bucket] = s.survivor_buckets.get(bucket, 0) + 1
            s.stage1_s += t1
            s.prune_s += tp
            s.stage2_s += t2

    def _note_fallback(self, n: int, stage1_failed: bool) -> None:
        s = self.stats
        with s._lock:
            s.requests += 1
            s.fallbacks += 1
            s.rows_requested += n
            s.rows_ranked += n
            if stage1_failed:
                s.stage1_failures += 1

    def _bucket_of(self, rows: int) -> int:
        from .batcher import bucket_for

        try:
            return bucket_for(rows, self.batcher.buckets)
        except Exception:  # noqa: BLE001 — accounting only
            return rows

    def _prune(self, s1: dict, stage1, arrays: dict, n: int, k: int):
        """(survivor indices, stage-1 scores, survivor rows or None)."""
        with request_trace.span("cascade.prune"):
            idx, final = self._finalize_prune(s1, stage1, n, k)
            surv = {key: v[idx] for key, v in arrays.items()} if len(idx) else None
        return idx, final, surv

    def _answer(self, score_key: str, n: int, idx, final, out2, t0: float, t1: float,
                tp: float) -> dict:
        """The response's outputs and the accounting, once stage 2 (if any)
        is back."""
        t2 = time.perf_counter()
        if out2 is None:
            self._note(n, idx, 0, t1 - t0, tp - t1, 0.0)
            return {score_key: final, STAGE_OUTPUT: self._scatter(final, idx, [])}
        provenance = self._scatter(final, idx, out2[score_key])
        self._note(n, idx, self._bucket_of(len(idx)), t1 - t0, tp - t1, t2 - tp)
        return {score_key: final, STAGE_OUTPUT: provenance}

    def run(self, impl, servable, arrays, fetch_keys, deadline_t, criticality) -> dict:
        """The cascade for thread-per-RPC transports. `impl` is the
        PredictionServiceImpl whose _run and _budget_left each stage rides,
        so its error translation and degraded marks apply per stage."""
        score_key = servable.model.score_output
        n = next(iter(arrays.values())).shape[0]
        k = self.plan_k(n)
        stage1 = self._stage1_servable()
        if stage1 is None:
            return self._full_fallback(impl, servable, arrays, fetch_keys, deadline_t,
                                       criticality, n, score_key, stage1_failed=False)
        t0 = time.perf_counter()
        try:
            with request_trace.span("cascade.stage1"):
                s1 = impl._run(stage1, arrays, output_keys=(stage1.model.score_output,),
                               deadline_s=impl._budget_left(deadline_t),
                               criticality=criticality, prune_k=k)
        except Exception:  # noqa: BLE001 — stage 1 never fails the RPC
            # An unload mid-rollout, a shape stage 1 refuses, a failed
            # batch: the request degrades to a full ranking pass.
            return self._full_fallback(impl, servable, arrays, fetch_keys, deadline_t,
                                       criticality, n, score_key, stage1_failed=True)
        t1 = time.perf_counter()
        idx, final, surv = self._prune(s1, stage1, arrays, n, k)
        tp = time.perf_counter()
        out2 = None
        if surv is not None:
            with request_trace.span("cascade.stage2"):
                out2 = impl._run(servable, surv, output_keys=fetch_keys,
                                 deadline_s=impl._budget_left(deadline_t),
                                 criticality=criticality)
        return self._answer(score_key, n, idx, final, out2, t0, t1, tp)

    async def run_async(self, impl, servable, arrays, fetch_keys, deadline_t,
                        criticality) -> dict:
        """run() for coroutine callers: the same semantics, each stage's
        wait awaited instead of blocking the event loop."""
        score_key = servable.model.score_output
        n = next(iter(arrays.values())).shape[0]
        k = self.plan_k(n)
        stage1 = self._stage1_servable()
        stage1_failed = False
        if stage1 is not None:
            t0 = time.perf_counter()
            try:
                with request_trace.span("cascade.stage1"):
                    s1 = await impl._run_async(
                        stage1, arrays, output_keys=(stage1.model.score_output,),
                        deadline_s=impl._budget_left(deadline_t), criticality=criticality,
                        prune_k=k)
            except Exception:  # noqa: BLE001 — stage 1 never fails the RPC
                stage1_failed = True
            else:
                t1 = time.perf_counter()
                idx, final, surv = self._prune(s1, stage1, arrays, n, k)
                tp = time.perf_counter()
                out2 = None
                if surv is not None:
                    with request_trace.span("cascade.stage2"):
                        out2 = await impl._run_async(
                            servable, surv, output_keys=fetch_keys,
                            deadline_s=impl._budget_left(deadline_t), criticality=criticality)
                return self._answer(score_key, n, idx, final, out2, t0, t1, tp)
        out = await impl._run_async(servable, arrays, output_keys=fetch_keys,
                                    deadline_s=impl._budget_left(deadline_t),
                                    criticality=criticality)
        self._note_fallback(n, stage1_failed)
        return self._with_full_provenance(out, score_key, n)

    def _full_fallback(self, impl, servable, arrays, fetch_keys, deadline_t, criticality, n,
                       score_key, stage1_failed):
        """A full stage-2 pass: every row ranked, provenance all 2 (the
        answer of a cascade-off server, with honest provenance)."""
        out = impl._run(servable, arrays, output_keys=fetch_keys,
                        deadline_s=impl._budget_left(deadline_t), criticality=criticality)
        self._note_fallback(n, stage1_failed)
        return self._with_full_provenance(out, score_key, n)

    @staticmethod
    def _with_full_provenance(out: dict, score_key: str, n: int) -> dict:
        out = dict(out)
        out[STAGE_OUTPUT] = np.full(n, STAGE2, np.int32)
        return out

    # ------------------------------------------------------------- stats

    def snapshot(self) -> dict:
        """/cascadez, /monitoring?section=cascade and dts_tpu_cascade_*:
        the JAX package's fields."""
        s = self.stats
        with s._lock:
            rows_req = s.rows_requested
            return {
                "stage1_model": self.stage1_model,
                "survivor_k": self.survivor_k,
                "survivor_fraction": self.survivor_fraction,
                "score_threshold": self.score_threshold,
                "min_candidates": self.min_candidates,
                "requests": s.requests,
                "fallbacks": s.fallbacks,
                "stage1_failures": s.stage1_failures,
                "host_prunes": s.host_prunes,
                "rows_requested": rows_req,
                "rows_ranked": s.rows_ranked,
                "pruned_rows": s.pruned_rows,
                "survivor_rows": s.survivor_rows,
                "zero_survivor_requests": s.zero_survivor_requests,
                "survivor_fraction_observed": s.survivor_rows / rows_req if rows_req else 0.0,
                "rank_fraction": s.rows_ranked / rows_req if rows_req else 0.0,
                "stage1_seconds_total": s.stage1_s,
                "prune_seconds_total": s.prune_s,
                "stage2_seconds_total": s.stage2_s,
                "survivor_buckets": dict(sorted(s.survivor_buckets.items())),
            }


def publish_stage1(base_dir: str, servable, kind: str) -> tuple[int, str]:
    """Publish a stage-1 servable as a normal versioned model: a checkpoint
    (train/checkpoint.py save_servable) renamed into the next numeric
    version directory (interop/export.py publish_version), where a
    VersionWatcher on `base_dir` loads it like any rollout. Returns
    (version, path)."""
    from ..interop.export import publish_version
    from ..train.checkpoint import save_servable

    return publish_version(base_dir, lambda tmp: save_servable(tmp, servable, kind))
