"""Closed-loop benchmark harness — the reference's L6 layer, with percentiles.

Reproduces DCNClient.main's methodology (DCNClient.java:205-241): the payload
is built ONCE and re-sent for every request (DCNClient.java:208-210), N
concurrent workers each issue M sequential logical requests
(concurrentNum=6 x requestNum=1000 upstream), every request is wall-clock
timed end to end including the merge+sort, and an aggregate is reported.
The reference prints only the mean (DCNClient.java:234-236); BASELINE.md's
target metric set needs p50/p99 and QPS, so the raw sample list is kept and
summarized here.
"""

from __future__ import annotations

import asyncio
import dataclasses
import math
import multiprocessing as mp
import queue
import time

import numpy as np

from .client import ShardedPredictClient


@dataclasses.dataclass
class BenchReport:
    latencies_ms: np.ndarray
    wall_s: float
    concurrency: int
    requests_per_worker: int
    candidates: int

    @property
    def requests(self) -> int:
        return self.latencies_ms.size

    def percentile(self, q: float) -> float:
        return float(np.percentile(self.latencies_ms, q))

    @property
    def qps(self) -> float:
        return self.requests / self.wall_s

    @property
    def candidates_per_s(self) -> float:
        return self.requests * self.candidates / self.wall_s

    def summary(self) -> dict:
        return {
            "requests": self.requests,
            "concurrency": self.concurrency,
            "candidates_per_request": self.candidates,
            "mean_ms": float(self.latencies_ms.mean()),
            "p50_ms": self.percentile(50),
            "p90_ms": self.percentile(90),
            "p99_ms": self.percentile(99),
            "qps": self.qps,
            "candidates_per_s": self.candidates_per_s,
            "wall_s": self.wall_s,
        }


def transfer_counters(stats) -> dict:
    """D2H attribution block for bench artifacts, from a BatcherStats-like
    object (duck-typed: this client package stays batcher-import-free).
    Pairs the actual wire bytes fetched (post output-compaction dtype, post
    output filter) with the full-fp32 all-outputs baseline, plus how much
    of the in-flight readback window the completer threads actually
    blocked on (1.0 = the transfer hid entirely behind other work)."""
    down = getattr(stats, "bytes_downloaded", 0)
    full = getattr(stats, "bytes_download_full_f32", 0)
    return {
        "bytes_downloaded_mb": round(down / 1e6, 3),
        "bytes_full_f32_mb": round(full / 1e6, 3),
        "bytes_saved_mb": round(max(full - down, 0) / 1e6, 3),
        "compaction_ratio": round(full / down, 2) if down else None,
        "readback_overlap_fraction": round(
            getattr(stats, "readback_overlap_fraction", 0.0), 3
        ),
        "topk_batches": getattr(stats, "topk_batches", 0),
    }


def make_payload(candidates: int = 1500, num_fields: int = 43, seed: int = 7):
    """The reference workload point: [candidateNum, FIELD_NUM] int64 ids +
    float weights (DCNClient.java:25,29,57-74)."""
    rng = np.random.RandomState(seed)
    return {
        "feat_ids": rng.randint(0, 1 << 40, size=(candidates, num_fields)).astype(np.int64),
        "feat_wts": rng.rand(candidates, num_fields).astype(np.float32),
    }


def zipfian_indices(
    n: int, pool_size: int, skew: float = 1.1, seed: int = 0
) -> np.ndarray:
    """Deterministic seeded zipfian index stream: n draws over
    [0, pool_size) with P(i) ∝ 1/(i+1)^skew. The SAME (n, pool_size, skew,
    seed) replays the identical sequence, so cache-on/cache-off A/B runs
    serve the identical request stream — the anti-flattering requirement
    for any cache measurement."""
    if pool_size <= 0:
        raise ValueError(f"pool_size must be positive, got {pool_size}")
    rng = np.random.RandomState(seed)
    p = np.arange(1, pool_size + 1, dtype=np.float64) ** -float(skew)
    p /= p.sum()
    return rng.choice(pool_size, size=n, p=p)


def make_zipfian_payloads(
    pool: int,
    candidates: int,
    num_fields: int = 43,
    skew: float = 1.1,
    seed: int = 0,
    catalog: int = 4096,
) -> list[dict[str, np.ndarray]]:
    """`pool` payloads whose candidate ROWS are drawn zipfian (seeded, so
    deterministic) from a catalog of `catalog` distinct candidate rows —
    the CTR traffic shape the cache plane exists for: hot rows recur
    WITHIN a payload (intra-batch duplicate collapse) and ACROSS payloads,
    while whole-payload repeats (zipfian_indices over this pool) exercise
    the exact-match score cache and single-flight coalescing."""
    rng = np.random.RandomState(seed)
    cat_ids = rng.randint(
        0, 1 << 40, size=(catalog, num_fields)
    ).astype(np.int64)
    cat_wts = rng.rand(catalog, num_fields).astype(np.float32)
    p = np.arange(1, catalog + 1, dtype=np.float64) ** -float(skew)
    p /= p.sum()
    out = []
    for _ in range(pool):
        rows = rng.choice(catalog, size=candidates, p=p)
        out.append({
            "feat_ids": np.ascontiguousarray(cat_ids[rows]),
            "feat_wts": np.ascontiguousarray(cat_wts[rows]),
        })
    return out


async def run_closed_loop(
    client: ShardedPredictClient,
    payload: dict[str, np.ndarray],
    concurrency: int = 6,
    requests_per_worker: int = 1000,
    sort_scores: bool = True,
    warmup_requests: int = 3,
    payload_pool: list[dict[str, np.ndarray]] | None = None,
    prepared: bool = False,
    schedule: "np.ndarray | None" = None,
) -> BenchReport:
    """payload_pool, when given, varies the request bytes: worker w's i-th
    request sends pool[(w + i*STRIDE) % len(pool)] with STRIDE=73 (odd, so
    coprime to power-of-two pools): every worker cycles the FULL pool,
    concurrent workers hold distinct payloads, and batch compositions churn
    — the anti-flattering mode for content-addressed caches (the
    reference's own methodology re-sends ONE payload,
    DCNClient.java:208-210; both numbers are reported). A stride of
    `concurrency` would degenerate to period len(pool)/gcd and re-send a
    couple of payloads per worker.

    schedule, when given with payload_pool, REPLACES the stride walk with
    an explicit pool-index stream: worker w's i-th request sends
    pool[schedule[(w*requests_per_worker + i) % len(schedule)]] — the
    zipfian replay mode (zipfian_indices), where cache-on and cache-off
    runs must serve the byte-identical request sequence.

    prepared=True hoists the request build+serialize out of the loop
    (client.prepare + predict_prepared): the reference methodology already
    fixes the payload once (DCNClient.java:208-210), so the serialized
    bytes are loop-invariant too. Only meaningful without a payload_pool —
    the varied-payload mode exists to charge the FULL per-request path, so
    it always builds per call."""
    if prepared and payload_pool:
        raise ValueError("prepared mode is for the single-payload methodology; "
                         "payload_pool must charge the full build path")
    if schedule is not None and not payload_pool:
        raise ValueError("schedule indexes payload_pool; provide both")
    prep = client.prepare(payload) if prepared else None
    for _ in range(warmup_requests):
        if prep is not None:
            await client.predict_prepared(prep, sort_scores=sort_scores)
        else:
            await client.predict(payload, sort_scores=sort_scores)

    latencies: list[float] = []
    # Stride must be coprime to the pool size for EVERY worker to cycle the
    # FULL pool (73 alone would degenerate for pools of length 73k).
    stride = 1
    if payload_pool:
        stride = next(
            s for s in range(73, 73 + len(payload_pool) + 1)
            if math.gcd(s, len(payload_pool)) == 1
        )

    async def worker(w: int):
        for i in range(requests_per_worker):
            if prep is not None:
                t0 = time.perf_counter()
                scores = await client.predict_prepared(prep, sort_scores=sort_scores)
                latencies.append((time.perf_counter() - t0) * 1e3)
                assert scores.shape[0] == prep.candidates
                continue
            if schedule is not None:
                p = payload_pool[
                    schedule[(w * requests_per_worker + i) % len(schedule)]
                ]
            elif payload_pool:
                p = payload_pool[(w + i * stride) % len(payload_pool)]
            else:
                p = payload
            t0 = time.perf_counter()
            scores = await client.predict(p, sort_scores=sort_scores)
            latencies.append((time.perf_counter() - t0) * 1e3)
            assert scores.shape[0] == p["feat_ids"].shape[0]

    t0 = time.perf_counter()
    await asyncio.gather(*(worker(w) for w in range(concurrency)))
    wall = time.perf_counter() - t0
    return BenchReport(
        latencies_ms=np.asarray(latencies),
        wall_s=wall,
        concurrency=concurrency,
        requests_per_worker=requests_per_worker,
        candidates=payload["feat_ids"].shape[0],
    )


def _mp_load_worker(args) -> None:
    """Child-process load generator: its own event loop, channels, and GIL.

    Runs via the spawn context so it never inherits the parent's grpc
    state; the client import chain is numpy+grpc only (no torch), keeping child
    startup cheap.
    """
    (hosts, model_name, channels_per_host, ids, wts, concurrency,
     requests_per_worker, sort_scores, warmup_requests, barrier, out_q) = args
    payload = {"feat_ids": ids, "feat_wts": wts}

    async def go():
        async with ShardedPredictClient(
            hosts, model_name, channels_per_host=channels_per_host
        ) as client:
            for _ in range(warmup_requests):
                await client.predict(payload, sort_scores=sort_scores)
            barrier.wait(timeout=120)  # all children warmed: start together
            return await run_closed_loop(
                client, payload,
                concurrency=concurrency,
                requests_per_worker=requests_per_worker,
                sort_scores=sort_scores,
                warmup_requests=0,
            )

    report = asyncio.run(go())
    # Report the child's own wall: perf_counter epochs are only comparable
    # within one process, so the parent aggregates per-child walls instead
    # of subtracting cross-process timestamps.
    out_q.put((report.latencies_ms, report.wall_s))


def run_closed_loop_mp(
    hosts: list[str],
    payload: dict[str, np.ndarray],
    model_name: str = "DCN",
    processes: int = 4,
    concurrency: int = 64,
    requests_per_worker: int = 15,
    sort_scores: bool = True,
    warmup_requests: int = 3,
    channels_per_host: int = 2,
) -> BenchReport:
    """Closed loop with the load generators in separate OS processes.

    The reference's 6 load threads ran on a JVM with real parallelism
    (DCNClient.java:213-224); a single CPython event loop serializes request
    marshalling behind the GIL it shares with the in-process server, so the
    generators move out of process. Wall time spans first-start to last-end
    across children (children synchronize on a barrier after warmup).
    """
    ctx = mp.get_context("spawn")
    out_q = ctx.Queue()
    barrier = ctx.Barrier(processes)
    per_proc = max(1, concurrency // processes)
    args = [
        (hosts, model_name, channels_per_host, payload["feat_ids"], payload["feat_wts"],
         per_proc, requests_per_worker, sort_scores, warmup_requests, barrier, out_q)
        for _ in range(processes)
    ]
    procs = [ctx.Process(target=_mp_load_worker, args=(a,), daemon=True) for a in args]
    for p in procs:
        p.start()
    results = []
    try:
        while len(results) < len(procs):
            try:
                results.append(out_q.get(timeout=2))
            except queue.Empty:
                # Each child reports exactly once, right before exiting: more
                # finished children than reports (whatever the exitcode) means
                # someone died without reporting — fail fast, don't spin.
                finished = [p for p in procs if not p.is_alive()]
                if len(finished) > len(results):
                    # A report can still be in the feeder pipe between our
                    # get() timeout and the liveness scan; drain before
                    # declaring anyone dead.
                    try:
                        while True:
                            results.append(out_q.get_nowait())
                    except queue.Empty:
                        pass
                    if len(finished) > len(results):
                        raise RuntimeError(
                            f"{len(finished) - len(results)} load process(es) exited "
                            f"without reporting (exitcodes "
                            f"{[p.exitcode for p in finished]}); see their stderr "
                            "for the underlying error"
                        ) from None
    finally:
        for p in procs:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
    lat = np.concatenate([r[0] for r in results])
    # Children start together (post-warmup barrier), so the slowest child's
    # wall spans the whole run.
    wall = max(r[1] for r in results)
    return BenchReport(
        latencies_ms=lat,
        wall_s=wall,
        concurrency=per_proc * processes,
        requests_per_worker=requests_per_worker,
        candidates=payload["feat_ids"].shape[0],
    )
