"""The port's fan-out client (client/client.py, client/health.py) and its
resilience layer, case for case as the JAX package's tests/test_resilience.py
holds the JAX client: deterministic fault injection driving the backend
scoreboard (ejection / half-open recovery), hedged shard RPCs, partial-result
degraded merges, deadline propagation through the batcher, the
grpc.health.v1 service, keepalive channel options, and the version
watcher's transient-filesystem tolerance — all against port servers on the
CPU at a small width (8 fields, embed 4, one cross layer, f32) whose weights
are the JAX package's, carried across by convert.py.

Below those cases, the port held to the JAX package on the same seeded
inputs: the scoreboard's states under one event script and fake clock,
the serialized bytes of build_predict_request / compact_payload /
PreparedRequest, and each package's client against the other's server
within 1e-5 (f32)."""

import asyncio
import dataclasses
import time

import functools

import grpc
import jax
import numpy as np
import pytest
import torch

from distributed_tf_serving_tpu.models import ModelConfig as JaxConfig
from distributed_tf_serving_tpu.models import build_model as jax_build

from distributed_tf_serving_tpu_torch import faults
from distributed_tf_serving_tpu_torch.convert import params_from_jax
from distributed_tf_serving_tpu_torch.client import (
    BackendScoreboard,
    PredictClientError,
    PredictResult,
    ScoreboardConfig,
    ShardedPredictClient,
    build_predict_request,
    keepalive_channel_options,
)
from distributed_tf_serving_tpu_torch.client.health import EJECTED, HALF_OPEN, HEALTHY
from distributed_tf_serving_tpu_torch.models import (
    ModelConfig,
    Servable,
    ServableRegistry,
    build_model,
    ctr_signatures,
)
from distributed_tf_serving_tpu_torch.proto import health as health_proto
from distributed_tf_serving_tpu_torch.serving import (
    DynamicBatcher,
    PredictionServiceImpl,
    ServiceError,
    create_server,
)
from distributed_tf_serving_tpu_torch.serving.batcher import (
    RequestDeadlineError,
    fold_ids_host,
)

CFG = ModelConfig(
    num_fields=8, vocab_size=1009, embed_dim=4, mlp_dims=(16,), num_cross_layers=1,
    compute_dtype="float32",
)


@functools.lru_cache(maxsize=None)
def _jax_params(kind="dcn_v2", seed=0):
    """The JAX package's initial weights for CFG (numpy leaves)."""
    jm = jax_build(kind, JaxConfig(**dataclasses.asdict(CFG)))
    return jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))


def _servable(version=1, seed=0):
    model = build_model("dcn_v2", CFG)
    return Servable(
        name="DCN", version=version, model=model,
        params=params_from_jax(_jax_params("dcn_v2", seed), "cpu"),
        signatures=ctr_signatures(CFG.num_fields),
    )


def _arrays(n=9, seed=3):
    rng = np.random.RandomState(seed)
    return {
        "feat_ids": rng.randint(0, 1 << 40, size=(n, CFG.num_fields)).astype(np.int64),
        "feat_wts": rng.rand(n, CFG.num_fields).astype(np.float32),
    }


def _golden(servable, arrays):
    batch = {
        "feat_ids": fold_ids_host(arrays["feat_ids"], CFG.vocab_size),
        "feat_wts": arrays["feat_wts"],
    }
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    return servable.model.apply(servable.params, batch)["prediction_node"].numpy()


@pytest.fixture(autouse=True)
def _clean_faults():
    """Every test starts and ends with an empty global injector: leaked
    rules would make UNRELATED tests nondeterministic — the exact failure
    mode this harness exists to kill."""
    faults.reset(seed=0)
    yield
    faults.reset(seed=0)


@pytest.fixture(scope="module")
def three_backends():
    servers, hosts, batchers = [], [], []
    for _ in range(3):
        registry = ServableRegistry()
        servable = _servable(version=1, seed=0)
        registry.load(servable)
        batcher = DynamicBatcher(device="cpu", buckets=(32, 128), max_wait_us=0).start()
        batcher.warmup(servable, buckets=(32, 128))
        impl = PredictionServiceImpl(registry, batcher)
        server, port = create_server(impl, "127.0.0.1:0")
        server.start()
        servers.append(server)
        batchers.append(batcher)
        hosts.append(f"127.0.0.1:{port}")
    yield hosts
    for s in servers:
        s.stop(0)
    for b in batchers:
        b.stop()


# ------------------------------------------------------------ fault injector


def test_fault_rate_draws_are_deterministic():
    a = faults.FaultInjector(seed=42)
    b = faults.FaultInjector(seed=42)
    ra = a.add("client.rpc", "error", rate=0.3)
    rb = b.add("client.rpc", "error", rate=0.3)
    outcomes_a, outcomes_b = [], []
    for inj, out in ((a, outcomes_a), (b, outcomes_b)):
        for _ in range(200):
            try:
                inj.fire("client.rpc")
                out.append(0)
            except faults.InjectedFaultError:
                out.append(1)
    assert outcomes_a == outcomes_b
    assert 20 < sum(outcomes_a) < 120  # rate ~0.3 over 200 draws
    assert ra.fired == rb.fired == sum(outcomes_a)


def test_fault_key_and_count_scoping():
    inj = faults.FaultInjector()
    inj.add("client.rpc", "error", key="hostA", count=2)
    inj.fire("client.rpc", key="hostB")  # wrong key: no fire
    for _ in range(2):
        with pytest.raises(faults.InjectedFaultError):
            inj.fire("client.rpc", key="hostA")
    inj.fire("client.rpc", key="hostA")  # count exhausted: no fire
    assert inj.fires["client.rpc"] == 2


def test_fault_env_config(monkeypatch):
    monkeypatch.setenv(
        "DTS_TPU_FAULTS",
        "client.rpc=error,rate=0.5,code=RESOURCE_EXHAUSTED,key=h1;"
        "readback=delay,delay=0.01",
    )
    monkeypatch.setenv("DTS_TPU_FAULT_SEED", "7")
    assert faults.configure_from_env() == 2
    snap = faults.get().snapshot()
    assert {r["site"] for r in snap["rules"]} == {"client.rpc", "readback"}
    assert faults.get().seed == 7
    with pytest.raises(ValueError):
        monkeypatch.setenv("DTS_TPU_FAULTS", "no-kind-here")
        faults.configure_from_env()


def test_injected_error_mimics_aio_rpc_error():
    e = faults.InjectedFaultError("client.rpc", "UNAVAILABLE")
    assert e.code().name == "UNAVAILABLE"
    assert "client.rpc" in e.details()


# --------------------------------------------------------------- scoreboard


def test_scoreboard_ejection_halfopen_recovery_cycle():
    clock = [0.0]
    sb = BackendScoreboard(
        ["a", "b", "c"],
        ScoreboardConfig(failure_threshold=3, ejection_s=5.0),
        clock=lambda: clock[0],
    )
    # Below the threshold: stays healthy.
    sb.record_failure(1)
    sb.record_failure(1)
    assert sb.state(1) == HEALTHY
    sb.record_failure(1)
    assert sb.state(1) == EJECTED and sb.ejections == 1
    # Steering: shard homed at 1 goes to the next healthy host.
    assert sb.pick(1) == 2
    # Ejection interval passes: half-open, the home shard's request is the
    # probe — and exactly ONE probe slot exists.
    clock[0] = 5.1
    assert sb.state(1) == HALF_OPEN
    assert sb.pick(1) == 1 and sb.probes == 1
    assert sb.pick(1) == 2  # probe slot taken: steer away meanwhile
    # Probe failure re-ejects with a DOUBLED interval.
    sb.record_failure(1)
    assert sb.state(1) == EJECTED and sb.ejections == 2
    clock[0] = 5.1 + 9.9
    assert sb.state(1) == EJECTED  # 10s interval now
    clock[0] = 5.1 + 10.1
    assert sb.state(1) == HALF_OPEN
    assert sb.pick(1) == 1 and sb.probes == 2
    # Probe success recovers.
    sb.record_success(1, latency_s=0.004)
    assert sb.state(1) == HEALTHY and sb.recoveries == 1
    snap = sb.snapshot()
    assert snap["backends"]["b"]["ewma_ms"] == pytest.approx(4.0)
    assert snap["ejections"] == 2 and snap["probes"] == 2


def test_scoreboard_all_ejected_still_routes():
    sb = BackendScoreboard(["a", "b"], ScoreboardConfig(failure_threshold=1))
    sb.record_failure(0)
    sb.record_failure(1)
    assert sb.pick(0) == 0  # last resort: send somewhere
    assert sb.pick(0, exclude=(0, 1)) is None  # exhausted


def test_scoreboard_ewma_tracks_latency():
    sb = BackendScoreboard(["a"])
    sb.record_success(0, 0.010)
    assert sb.snapshot()["backends"]["a"]["ewma_ms"] == pytest.approx(10.0)
    sb.record_success(0, 0.020)
    # alpha=0.2: 0.8*10 + 0.2*20 = 12
    assert sb.snapshot()["backends"]["a"]["ewma_ms"] == pytest.approx(12.0)


# ------------------------------------- chaos (a): partial merge + recovery


def test_wedged_backend_partial_merge_eject_and_recover(three_backends):
    """Acceptance (a): one backend wedged -> degraded merges with correct
    missing_ranges; the scoreboard ejects it (steering subsequent requests
    whole again), and after the fault clears the half-open probe recovers
    it. Fully deterministic: injected fault, injectable clock."""
    servable = _servable(version=1, seed=0)
    arrays = _arrays(n=9, seed=21)
    want = _golden(servable, arrays)
    sick = three_backends[1]

    clock = [0.0]
    sb = BackendScoreboard(
        list(three_backends),
        ScoreboardConfig(failure_threshold=3, ejection_s=5.0),
        clock=lambda: clock[0],
    )
    async def go():
        async with ShardedPredictClient(
            list(three_backends), "DCN",
            timeout_s=1.0, scoreboard=sb, partial_results=True,
            backoff_initial_s=0.0,
        ) as client:
            # Every backend answers once before the 1 s budget counts: the
            # channels connect and the servers' first Predicts run here,
            # not inside a healthy shard's budget on a loaded host.
            await client.predict(arrays)
            # Wedge-equivalent with a bounded test budget: the shard RPC
            # against the sick backend hangs (fire_async wedge capped at
            # 30s) while the client's own timeout converts it to
            # DEADLINE_EXCEEDED quickly.
            faults.get().add("client.rpc", "wedge", key=sick, delay_s=30.0)
            degraded = []
            # 3 consecutive failures of the sick shard -> ejection.
            for _ in range(3):
                degraded.append(await client.predict(arrays))
            # Ejected now: shard 1 steers to a healthy host -> whole again.
            steered = await client.predict(arrays)
            # Fault heals; ejection interval passes -> half-open probe on
            # the home host succeeds -> recovery.
            faults.get().clear("client.rpc")
            clock[0] = 6.0
            probed = await client.predict(arrays)
            return degraded, steered, probed, client.resilience_counters()

    degraded, steered, probed, counters = asyncio.run(go())

    for r in degraded:
        assert isinstance(r, PredictResult) and r.degraded
        assert r.missing_ranges == ((3, 6),)  # shard 1 of 9-over-3
        np.testing.assert_allclose(
            r.scores, np.concatenate([want[:3], want[6:]]), rtol=1e-6
        )
    assert isinstance(steered, PredictResult) and not steered.degraded
    np.testing.assert_allclose(steered.scores, want, rtol=1e-6)
    assert not probed.degraded
    np.testing.assert_allclose(probed.scores, want, rtol=1e-6)

    sb_snap = counters["scoreboard"]
    assert sb_snap["ejections"] >= 1
    assert sb_snap["probes"] >= 1
    assert sb_snap["recoveries"] >= 1
    assert sb_snap["backends"][sick]["state"] == HEALTHY
    assert counters["partial_responses"] == 3


def test_partial_results_all_shards_failed_raises(three_backends):
    faults.get().add("client.rpc", "error", code="UNAVAILABLE")  # every host

    async def go():
        async with ShardedPredictClient(
            list(three_backends), "DCN", partial_results=True,
            backoff_initial_s=0.0,
        ) as client:
            await client.predict(_arrays())

    with pytest.raises(PredictClientError):
        asyncio.run(go())


def test_partial_results_prepared_path(three_backends):
    """predict_prepared degrades identically to predict()."""
    servable = _servable(version=1, seed=0)
    arrays = _arrays(n=9, seed=5)
    want = _golden(servable, arrays)
    faults.get().add("client.rpc", "error", key=three_backends[2])

    async def go():
        async with ShardedPredictClient(
            list(three_backends), "DCN", partial_results=True,
            backoff_initial_s=0.0,
        ) as client:
            prep = client.prepare(arrays)
            return await client.predict_prepared(prep)

    r = asyncio.run(go())
    assert r.degraded and r.missing_ranges == ((6, 9),)
    np.testing.assert_allclose(r.scores, want[:6], rtol=1e-6)


# ------------------------------------------------- failover path (satellite)


def test_breaker_open_backend_reroutes_shard(three_backends):
    """A backend shedding with RESOURCE_EXHAUSTED (its breaker open) is a
    reroutable failure: the shard fails over to a healthy host and the
    merge is complete and correct."""
    servable = _servable(version=1, seed=0)
    arrays = _arrays(n=9, seed=31)
    want = _golden(servable, arrays)
    faults.get().add(
        "client.rpc", "error", key=three_backends[0], code="RESOURCE_EXHAUSTED"
    )

    async def go():
        async with ShardedPredictClient(
            list(three_backends), "DCN",
            failover_attempts=1, backoff_initial_s=0.0,
        ) as client:
            return await client.predict(arrays)

    np.testing.assert_allclose(asyncio.run(go()), want, rtol=1e-6)


def test_failover_exhaustion_names_last_host(three_backends):
    """partial_results=False + every host injected dead: the typed error
    names the LAST host tried (full_async=False pins shard 0's chain)."""
    faults.get().add("client.rpc", "error", code="UNAVAILABLE")

    async def go():
        async with ShardedPredictClient(
            list(three_backends), "DCN",
            failover_attempts=2, full_async=False, backoff_initial_s=0.0,
        ) as client:
            await client.predict(_arrays(n=9))

    with pytest.raises(PredictClientError) as ei:
        asyncio.run(go())
    assert ei.value.host == three_backends[2]
    assert getattr(ei.value.code, "name", "") == "UNAVAILABLE"


def test_backoff_is_jittered_exponential(three_backends):
    """Failover sleeps between attempts: bounded, growing, jittered — and
    the counter records them."""
    faults.get().add("client.rpc", "error", key=three_backends[0], count=2)

    async def go():
        async with ShardedPredictClient(
            list(three_backends), "DCN",
            failover_attempts=2, backoff_initial_s=0.01, backoff_max_s=0.05,
        ) as client:
            t0 = time.perf_counter()
            await client.predict(_arrays(n=9))
            return time.perf_counter() - t0, client.counters

    elapsed, counters = asyncio.run(go())
    assert counters.failovers >= 1
    assert counters.backoff_sleeps >= 1
    assert elapsed < 5.0  # backoff stayed bounded


# ------------------------------------------------------------------ hedging


def test_hedged_shard_first_wins(three_backends):
    """Shard 0's home backend is slow (injected delay); the hedge fires on
    another healthy host after hedge_delay_s and wins — correct scores,
    counters visible, total latency far below the injected delay."""
    servable = _servable(version=1, seed=0)
    arrays = _arrays(n=9, seed=41)
    want = _golden(servable, arrays)
    faults.get().add("client.rpc", "delay", key=three_backends[0], delay_s=1.5)

    async def go():
        async with ShardedPredictClient(
            list(three_backends), "DCN",
            scoreboard=True, hedge_delay_s=0.05, timeout_s=10.0,
        ) as client:
            t0 = time.perf_counter()
            merged = await client.predict(arrays)
            return merged, time.perf_counter() - t0, client.resilience_counters()

    merged, elapsed, counters = asyncio.run(go())
    np.testing.assert_allclose(merged, want, rtol=1e-6)
    assert counters["hedges_fired"] >= 1
    assert counters["hedges_won"] >= 1
    assert elapsed < 1.4  # did NOT wait out the injected 1.5s delay


# -------------------------------------- deadline propagation (b) + shedding


def test_queued_work_past_deadline_is_shed():
    """A queued item whose propagated client deadline expires while a slow
    batch occupies the device is shed (RequestDeadlineError) the moment the
    batcher reaches it — before wasting a dispatch slot — and counted."""
    registry = ServableRegistry()
    servable = _servable()
    registry.load(servable)
    # Inline dispatch (no pipeline thread): the wedge occupies the batching
    # thread itself, so the deadlined item stays in the QUEUE.
    batcher = DynamicBatcher(
        device="cpu", buckets=(32,), max_wait_us=0, pipeline_depth=1
    ).start()
    try:
        batcher.warmup(servable, buckets=(32,))
        faults.get().add("batcher.dispatch", "wedge", delay_s=30.0)
        blocked = batcher.submit(servable, _arrays(n=4, seed=1))
        time.sleep(0.05)  # let it reach the wedged dispatch
        doomed = batcher.submit(servable, _arrays(n=4, seed=2), deadline_s=0.2)
        time.sleep(0.4)  # deadline expires while still queued
        faults.get().clear("batcher.dispatch")
        assert blocked.result(timeout=30) is not None
        with pytest.raises(RequestDeadlineError):
            doomed.result(timeout=30)
        assert batcher.stats.deadline_sheds == 1
    finally:
        faults.reset()
        batcher.stop()


def test_predict_with_2s_deadline_fails_in_2s_not_120():
    """Acceptance (b): a Predict carrying a ~2s client deadline against a
    saturated (wedged) batcher comes back DEADLINE_EXCEEDED in ~deadline
    time — never the fixed 120s batch deadline."""
    registry = ServableRegistry()
    servable = _servable()
    registry.load(servable)
    batcher = DynamicBatcher(
        device="cpu", buckets=(32,), max_wait_us=0, pipeline_depth=1,
        breaker_timeout_s=None,  # isolate deadline behavior from the breaker
    ).start()
    impl = PredictionServiceImpl(registry, batcher)
    try:
        batcher.warmup(servable, buckets=(32,))
        faults.get().add("batcher.dispatch", "wedge", delay_s=30.0)
        batcher.submit(servable, _arrays(n=4, seed=1))  # saturate
        time.sleep(0.05)
        req = build_predict_request(_arrays(n=4, seed=2), "DCN")
        t0 = time.perf_counter()
        with pytest.raises(ServiceError) as ei:
            impl.predict(req, deadline_s=2.0)
        elapsed = time.perf_counter() - t0
        assert ei.value.code == "DEADLINE_EXCEEDED"
        assert elapsed < 6.0  # ~2s + slack; nowhere near 120s
        # Already-expired deadline sheds before submit.
        with pytest.raises(ServiceError) as ei2:
            impl.predict(req, deadline_s=0.0)
        assert ei2.value.code == "DEADLINE_EXCEEDED"
    finally:
        faults.reset()
        batcher.stop()


def test_batcher_site_injected_error_keeps_status_code():
    """An `error` rule at a batcher site surfaces with ITS code at the RPC
    layer (not the RuntimeError->UNAVAILABLE catch-all)."""
    registry = ServableRegistry()
    servable = _servable()
    registry.load(servable)
    batcher = DynamicBatcher(device="cpu", buckets=(32,), max_wait_us=0).start()
    impl = PredictionServiceImpl(registry, batcher)
    try:
        batcher.warmup(servable, buckets=(32,))
        faults.get().add(
            "batcher.dispatch", "error", code="RESOURCE_EXHAUSTED", count=1
        )
        with pytest.raises(ServiceError) as ei:
            impl.predict(build_predict_request(_arrays(n=4), "DCN"))
        assert ei.value.code == "RESOURCE_EXHAUSTED"
        # Rule exhausted (count=1): serving continues unharmed.
        impl.predict(build_predict_request(_arrays(n=4), "DCN"))
    finally:
        faults.reset()
        batcher.stop()


def test_deadline_sheds_visible_in_monitoring():
    from distributed_tf_serving_tpu_torch.serving.batcher import BatcherStats
    from distributed_tf_serving_tpu_torch.utils.metrics import ServerMetrics

    stats = BatcherStats()
    stats.deadline_sheds = 4
    m = ServerMetrics()
    snap = m.snapshot(stats)
    assert snap["batcher"]["deadline_sheds"] == 4
    text = m.prometheus_text(stats)
    assert "dts_tpu_batcher_deadline_sheds_total 4" in text


# --------------------------------------------------------- grpc.health.v1


def test_health_service_sync_server():
    registry = ServableRegistry()
    registry.load(_servable())
    batcher = DynamicBatcher(device="cpu", buckets=(32,), max_wait_us=0).start()
    impl = PredictionServiceImpl(registry, batcher)
    server, port = create_server(impl, "127.0.0.1:0")
    server.start()
    try:
        with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
            stub = health_proto.HealthStub(ch)
            # Overall server + per-model: SERVING.
            assert stub.Check(
                health_proto.HealthCheckRequest(""), timeout=5
            ).status == health_proto.SERVING
            assert stub.Check(
                health_proto.HealthCheckRequest("DCN"), timeout=5
            ).status == health_proto.SERVING
            # Warmup not complete: overall NOT_SERVING, model still SERVING.
            impl.warmup_complete = False
            assert stub.Check(
                health_proto.HealthCheckRequest(""), timeout=5
            ).status == health_proto.NOT_SERVING
            assert stub.Check(
                health_proto.HealthCheckRequest("DCN"), timeout=5
            ).status == health_proto.SERVING
            # Unknown service: grpc NOT_FOUND (health spec).
            with pytest.raises(grpc.RpcError) as ei:
                stub.Check(health_proto.HealthCheckRequest("NOPE"), timeout=5)
            assert ei.value.code() == grpc.StatusCode.NOT_FOUND
            # Configured-but-no-version-yet: NOT_SERVING, not NOT_FOUND.
            impl.served_sources["PENDING"] = ("/models/PENDING", "dcn_v2")
            assert stub.Check(
                health_proto.HealthCheckRequest("PENDING"), timeout=5
            ).status == health_proto.NOT_SERVING
    finally:
        server.stop(0)
        batcher.stop()


def test_health_service_aio_server():
    from distributed_tf_serving_tpu_torch.serving.server import create_server_async

    registry = ServableRegistry()
    registry.load(_servable())
    batcher = DynamicBatcher(device="cpu", buckets=(32,), max_wait_us=0).start()
    impl = PredictionServiceImpl(registry, batcher)

    async def go():
        import grpc.aio

        server, port = create_server_async(impl, "127.0.0.1:0")
        await server.start()
        try:
            async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as ch:
                stub = health_proto.HealthStub(ch)
                overall = await stub.Check(
                    health_proto.HealthCheckRequest(""), timeout=5
                )
                model = await stub.Check(
                    health_proto.HealthCheckRequest("DCN"), timeout=5
                )
                try:
                    await stub.Check(
                        health_proto.HealthCheckRequest("NOPE"), timeout=5
                    )
                    unknown = None
                except grpc.aio.AioRpcError as e:
                    unknown = e.code()
                return overall.status, model.status, unknown
        finally:
            await server.stop(0)

    overall, model, unknown = asyncio.run(go())
    assert overall == health_proto.SERVING
    assert model == health_proto.SERVING
    assert unknown == grpc.StatusCode.NOT_FOUND
    batcher.stop()


def test_client_half_open_health_probe(three_backends):
    """health_probe=True: a half-open backend is probed with a
    grpc.health.v1 Check (cheap) before any real shard lands on it."""
    sick = three_backends[1]
    clock = [0.0]
    sb = BackendScoreboard(
        list(three_backends),
        ScoreboardConfig(failure_threshold=1, ejection_s=5.0),
        clock=lambda: clock[0],
    )
    faults.get().add("client.rpc", "error", key=sick, count=1)

    async def go():
        async with ShardedPredictClient(
            list(three_backends), "DCN",
            scoreboard=sb, health_probe=True, partial_results=True,
            backoff_initial_s=0.0,
        ) as client:
            first = await client.predict(_arrays(n=9))  # ejects the sick host
            clock[0] = 6.0  # half-open now
            second = await client.predict(_arrays(n=9))  # home probe: Check
            return first, second, client.resilience_counters()

    first, second, counters = asyncio.run(go())
    assert first.degraded and first.missing_ranges == ((3, 6),)
    assert not second.degraded  # probe passed; real request followed
    assert counters["scoreboard"]["recoveries"] >= 1


# ---------------------------------------------------- keepalive + config


def test_keepalive_channel_options():
    opts = dict(keepalive_channel_options(12_000, 3_000))
    assert opts["grpc.keepalive_time_ms"] == 12_000
    assert opts["grpc.keepalive_timeout_ms"] == 3_000
    assert opts["grpc.http2.max_pings_without_data"] == 0
    assert opts["grpc.keepalive_permit_without_calls"] == 1


def test_client_from_config_resilience_knobs():
    from distributed_tf_serving_tpu_torch.client import client_from_config
    from distributed_tf_serving_tpu_torch.utils.config import ClientConfig

    cfg = ClientConfig(
        hosts=("127.0.0.1:1",),
        health_scoreboard=True,
        hedge_delay_ms=25,
        partial_results=True,
        failover_attempts=2,
        backoff_initial_ms=10,
        backoff_max_ms=100,
        ejection_failures=2,
        ejection_interval_s=3.0,
    )
    async def go():
        # grpc.aio channels want a running loop; build inside one.
        client = client_from_config(cfg)
        try:
            assert client.scoreboard is not None
            assert client.scoreboard.config.failure_threshold == 2
            assert client.scoreboard.config.ejection_s == 3.0
            assert client.hedge_delay_s == pytest.approx(0.025)
            assert client.partial_results is True
            assert client.backoff_initial_s == pytest.approx(0.010)
            assert client.backoff_max_s == pytest.approx(0.100)
        finally:
            await client.close()

    asyncio.run(go())


# ------------------------------------------- version watcher FS transients


def test_scan_versions_survives_listing_race(tmp_path, monkeypatch):
    from distributed_tf_serving_tpu_torch.serving import version_watcher as vw

    base = tmp_path / "models"
    base.mkdir()
    (base / "1").mkdir()

    # ENOENT mid-listing (base swapped out during iterdir).
    import pathlib

    real_iterdir = pathlib.Path.iterdir

    def racy_iterdir(self):
        if self == base:
            raise FileNotFoundError(f"{self} vanished mid-listing")
        return real_iterdir(self)

    monkeypatch.setattr(pathlib.Path, "iterdir", racy_iterdir)
    assert vw.scan_versions(base) == {}  # degraded, not raised
    monkeypatch.undo()

    # Stat race on ONE entry: that entry is skipped, the rest survive.
    (base / "2").mkdir()

    class RacyChild:
        name = "3"

        def is_dir(self):
            raise OSError("stat race: dir being swapped")

    def partial_iterdir(self):
        if self == base:
            return iter([base / "1", base / "2", RacyChild()])
        return real_iterdir(self)

    monkeypatch.setattr(pathlib.Path, "iterdir", partial_iterdir)
    out = vw.scan_versions(base)
    assert sorted(out) == [1, 2]


def test_watcher_poll_survives_fs_transients(tmp_path, monkeypatch):
    """A transient scan failure inside the poll loop logs and retries next
    tick — the watcher thread (and the synchronous startup scan) survive."""
    from distributed_tf_serving_tpu_torch.serving import version_watcher as vw

    base = tmp_path / "models"
    base.mkdir()
    registry = ServableRegistry()
    watcher = vw.VersionWatcher(
        base, registry, vw.VersionWatcherConfig(poll_interval_s=3600)
    )
    import pathlib

    def broken_iterdir(self):
        raise FileNotFoundError("transient")

    monkeypatch.setattr(pathlib.Path, "iterdir", broken_iterdir)
    watcher.poll_once()  # must not raise
    monkeypatch.undo()

    def broken_ready(path):
        raise OSError("stat race")

    # _version_ready's guard: a race inside the readiness probe reads as
    # not-ready this tick.
    (base / "1").mkdir()
    assert vw._version_ready(base / "1") is False  # no manifest anyway
    monkeypatch.setattr(vw, "is_native_checkpoint", broken_ready)
    assert vw._version_ready(base / "1") is False


# --------------------------------- rebuilding hint


def test_scoreboard_rebuilding_steers_without_ejecting():
    """kind="rebuilding" (a quarantined replica's own announcement):
    steer around for rebuilding_busy_s, never touch the ejection budget —
    the pushback-is-not-death pattern below the RPC layer. A
    SUCCESS between hints resets the streak, so a host that keeps
    genuinely recovering keeps the hint forever."""
    clock = [0.0]
    sb = BackendScoreboard(
        ["a", "b"],
        ScoreboardConfig(failure_threshold=3, rebuilding_busy_s=2.0),
        clock=lambda: clock[0],
    )
    for _ in range(5):  # past the ejection threshold; streak reset between
        sb.record_failure(0, kind="rebuilding")
        sb.record_failure(0, kind="rebuilding")
        sb.record_success(0)
    assert sb.state(0) == HEALTHY and sb.ejections == 0
    assert sb.rebuilds == 10
    sb.record_failure(0, kind="rebuilding")
    # Steering prefers the non-busy peer while the rebuild bias holds...
    assert sb.pick(0) == 1
    # ...and returns home as soon as it lapses (no ejection window).
    clock[0] = 2.1
    assert sb.pick(0) == 0
    snap = sb.snapshot()
    assert snap["rebuilds"] == 11
    assert snap["backends"]["a"]["rebuilds"] == 11


def test_scoreboard_rebuilding_streak_limit_ejects_draining_host():
    """A host that answers NOTHING BUT rebuilding hints (a draining
    replica's health also reads NOT_SERVING, and drain never ends in
    recovery) must not cycle healthy-busy forever: past the consecutive
    streak limit the hints count as ordinary failures and the normal
    eject-with-doubling machinery bounds further probing."""
    clock = [0.0]
    sb = BackendScoreboard(
        ["a", "b"],
        ScoreboardConfig(
            failure_threshold=3, rebuilding_streak_limit=3, ejection_s=5.0,
        ),
        clock=lambda: clock[0],
    )
    for _ in range(6):
        sb.record_failure(0, kind="rebuilding")
    assert sb.rebuilds == 3  # only the in-streak hints counted as rebuilds
    assert sb.state(0) == EJECTED and sb.ejections == 1


def test_scoreboard_rebuilding_clears_failure_streak_and_recovers():
    """A rebuild announcement PROVES the host answers: the consecutive-
    failure streak resets, and an already-ejected host recovers to
    healthy-but-busy instead of re-ejecting with a doubled interval."""
    clock = [0.0]
    sb = BackendScoreboard(
        ["a", "b"], ScoreboardConfig(failure_threshold=2, ejection_s=5.0),
        clock=lambda: clock[0],
    )
    sb.record_failure(0)
    sb.record_failure(0)
    assert sb.state(0) == EJECTED
    sb.record_failure(0, kind="rebuilding")
    assert sb.state(0) == HEALTHY and sb.recoveries == 1
    # Streak cleared: one later transient failure must not insta-eject.
    sb.record_failure(0)
    assert sb.state(0) == HEALTHY


def test_quarantine_refusal_marks_rebuilding_in_client():
    """End to end over the wire: a server whose recovery plane is
    refusing (DeviceQuarantinedError -> UNAVAILABLE with the 'replica
    quarantined' marker) must be recorded as rebuilding by the fan-out
    client — zero ejection-budget burn — while the request fails over to
    the healthy peer."""
    import asyncio

    from distributed_tf_serving_tpu_torch.serving.recovery import RecoveryController
    from distributed_tf_serving_tpu_torch.utils.config import RecoveryConfig

    cfg = ModelConfig(
        num_fields=8, vocab_size=1009, embed_dim=4, mlp_dims=(16,),
        num_cross_layers=1, compute_dtype="float32",
    )
    model = build_model("dcn", cfg)
    servable = Servable(
        name="DCN", version=1, model=model,
        params=params_from_jax(_jax_params("dcn", 0), "cpu"),
        signatures=ctr_signatures(cfg.num_fields),
    )

    def start_one(quarantined: bool):
        registry = ServableRegistry()
        registry.load(servable)
        batcher = DynamicBatcher(device="cpu", buckets=(32,), max_wait_us=0).start()
        impl = PredictionServiceImpl(registry, batcher)
        if quarantined:
            rec = RecoveryController(
                RecoveryConfig(enabled=True), batcher, registry=registry,
                impl=impl,
            )
            rec.auto_cycle = False
            rec._enter("quarantined")  # pin the refusing state
        server, port = create_server(impl, "127.0.0.1:0")
        server.start()
        return server, batcher, port

    s1, b1, p1 = start_one(quarantined=True)
    s2, b2, p2 = start_one(quarantined=False)

    async def run():
        async with ShardedPredictClient(
            [f"127.0.0.1:{p1}", f"127.0.0.1:{p2}"], "DCN",
            scoreboard=True, failover_attempts=1,
        ) as client:
            rng = np.random.RandomState(0)
            payload = {
                "feat_ids": rng.randint(0, 1000, size=(8, 8)).astype(np.int64),
                "feat_wts": rng.rand(8, 8).astype(np.float32),
            }
            scores = await client.predict(payload)
            assert scores.shape == (8,)
            return client.resilience_counters()

    try:
        counters = asyncio.get_event_loop_policy().new_event_loop() \
            .run_until_complete(run())
        assert counters["rebuilding_hints"] >= 1
        sb = counters["scoreboard"]
        assert sb["rebuilds"] >= 1
        assert sb["ejections"] == 0
        host1 = sb["backends"][f"127.0.0.1:{p1}"]
        assert host1["consecutive_failures"] == 0
    finally:
        s1.stop(0)
        s2.stop(0)
        b1.stop()
        b2.stop()


# ------------------------------------------- the port against the JAX package

from distributed_tf_serving_tpu import codec as jax_codec  # noqa: E402
from distributed_tf_serving_tpu import faults as jax_faults  # noqa: E402
from distributed_tf_serving_tpu.client import ShardedPredictClient as JaxClient  # noqa: E402
from distributed_tf_serving_tpu.client import build_predict_request as jax_build_request  # noqa: E402
from distributed_tf_serving_tpu.client import compact_payload as jax_compact  # noqa: E402
from distributed_tf_serving_tpu.client.health import BackendScoreboard as JaxScoreboard  # noqa: E402
from distributed_tf_serving_tpu.client.health import ScoreboardConfig as JaxScoreboardConfig  # noqa: E402
from distributed_tf_serving_tpu_torch import codec  # noqa: E402
from distributed_tf_serving_tpu_torch.client import compact_payload  # noqa: E402


def _scoreboard_script(board_cls, cfg_cls):
    """One event script against a fresh scoreboard under a fake clock:
    the snapshot and each host's state after every step."""
    clock = [0.0]
    sb = board_cls(["a", "b", "c"], cfg_cls(failure_threshold=2, ejection_s=1.0,
                                            rebuilding_busy_s=0.5, rebuilding_streak_limit=2),
                   clock=lambda: clock[0])
    script = [("fail", 0, None), ("fail", 0, None), ("tick", 1.1), ("pick", 0), ("ok", 0, 0.004),
              ("fail", 1, "rebuilding"), ("pick", 1), ("fail", 1, "rebuilding"),
              ("fail", 1, "rebuilding"), ("tick", 0.6), ("fail", 2, "draining"), ("pick", 2),
              ("fail", 2, "corrupt"), ("ok", 2, 0.010), ("fail", 1, None), ("tick", 3.0),
              ("pick", 1), ("fail", 1, None), ("tick", 5.0), ("pick", 1), ("ok", 1, 0.002),
              ("fail", 0, "pushback"), ("pick", 0), ("budget",), ("hedge", (0,))]
    trail = []
    for step in script:
        op = step[0]
        if op == "fail":
            sb.record_failure(step[1], **({"kind": step[2]} if step[2] else {}))
        elif op == "ok":
            sb.record_success(step[1], latency_s=step[2])
        elif op == "tick":
            clock[0] += step[1]
        elif op == "pick":
            trail.append(("pick", sb.pick(step[1])))
        elif op == "budget":
            sb.note_retry_budget_exhausted()
        elif op == "hedge":
            trail.append(("hedge", sb.hedge_target(step[1])))
        trail.append(tuple(sb.state(i) for i in range(3)))
    return trail, sb.snapshot()


def test_scoreboard_states_equal_the_jax_package_s_under_one_script():
    got, got_snap = _scoreboard_script(BackendScoreboard, ScoreboardConfig)
    want, want_snap = _scoreboard_script(JaxScoreboard, JaxScoreboardConfig)
    assert got == want
    assert got_snap == want_snap


@pytest.mark.parametrize("compact", [False, True], ids=["wide", "compact"])
@pytest.mark.parametrize("tensor_content", [True, False], ids=["content", "repeated"])
def test_request_bytes_equal_the_jax_package_s(compact, tensor_content):
    """build_predict_request over the same arrays (compact_payload's folded
    int32 ids and bf16 weights included, NaN and ties of the rounding too)
    serializes to the JAX client's bytes, and the CRC stamp agrees."""
    arrays = _arrays(n=33, seed=7)
    arrays["feat_wts"][0, :4] = [np.nan, -np.nan, 1.0 + 2.0 ** -8, -(1.0 + 3 * 2.0 ** -8)]
    ours = compact_payload(arrays, CFG.vocab_size) if compact else arrays
    theirs = jax_compact(arrays, CFG.vocab_size) if compact else arrays
    for k in ours:
        assert np.asarray(ours[k]).tobytes() == np.asarray(theirs[k]).tobytes()
    kw = dict(output_filter=("prediction_node",), version_label="stable",
              use_tensor_content=tensor_content)
    got = build_predict_request(ours, "DCN", "serving_default", **kw)
    want = jax_build_request(theirs, "DCN", "serving_default", **kw)
    assert got.SerializeToString(deterministic=True) == want.SerializeToString(deterministic=True)
    assert codec.crc_sidecar(ours) == jax_codec.crc_sidecar(theirs)


@pytest.mark.parametrize("placement", ["contiguous", "affinity"])
def test_prepared_request_blobs_equal_the_jax_package_s(placement):
    hosts = ["127.0.0.1:1", "127.0.0.1:2", "127.0.0.1:3"]
    arrays = compact_payload(_arrays(n=100, seed=11), CFG.vocab_size)
    jarrays = jax_compact(_arrays(n=100, seed=11), CFG.vocab_size)

    async def go():
        async with ShardedPredictClient(hosts, "DCN", placement=placement) as ours, \
                JaxClient(hosts, "DCN", placement=placement) as theirs:
            return ours.prepare(arrays), theirs.prepare(jarrays)

    got, want = asyncio.run(go())
    assert got.shard_blobs == want.shard_blobs
    assert got.candidates == want.candidates and got.homes == want.homes
    if placement == "affinity":
        for g, w in zip(got.index_groups, want.index_groups):
            np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def jax_backend():
    """One JAX package server on the same weights as three_backends."""
    from distributed_tf_serving_tpu.models import Servable as JaxServable
    from distributed_tf_serving_tpu.models import ServableRegistry as JaxRegistry
    from distributed_tf_serving_tpu.models import ctr_signatures as jax_signatures
    from distributed_tf_serving_tpu.serving import DynamicBatcher as JaxBatcher
    from distributed_tf_serving_tpu.serving import PredictionServiceImpl as JaxImpl
    from distributed_tf_serving_tpu.serving import create_server as jax_create_server

    jcfg = JaxConfig(**dataclasses.asdict(CFG))
    registry = JaxRegistry()
    registry.load(JaxServable(name="DCN", version=1, model=jax_build("dcn_v2", jcfg),
                              params=jax.tree.map(jax.numpy.asarray, _jax_params("dcn_v2", 0)),
                              signatures=jax_signatures(CFG.num_fields)))
    batcher = JaxBatcher(buckets=(32, 128), max_wait_us=0).start()
    server, port = jax_create_server(JaxImpl(registry, batcher), "127.0.0.1:0")
    server.start()
    yield f"127.0.0.1:{port}"
    server.stop(0)
    batcher.stop()


def test_each_client_scores_through_the_other_package_s_server(three_backends, jax_backend):
    """The port's client against the JAX server, the JAX client against the
    port's servers: within 1e-5 of the port's plain forward (f32)."""
    arrays = _arrays(n=40, seed=13)
    want = _golden(_servable(), arrays)
    jax_faults.reset(seed=0)

    async def go():
        out = {}
        async with ShardedPredictClient([jax_backend], "DCN") as ours:
            out["port->jax"] = await ours.predict(arrays)
        async with JaxClient(list(three_backends), "DCN") as theirs:
            out["jax->port"] = await theirs.predict(arrays)
        return out

    got = asyncio.run(go())
    for name in ("port->jax", "jax->port"):
        np.testing.assert_allclose(got[name], want, rtol=1e-5, atol=1e-5, err_msg=name)


def test_client_rpc_and_wire_corrupt_sites_fire_in_the_port_client(three_backends):
    """The two client fault sites are live in the port's client:
    `client.rpc` keyed to a backend fails that shard over; `wire_corrupt`
    keyed to an input flips its bytes after the CRC stamp, so a port
    server with the integrity plane refuses that request alone as
    corrupt-wire, and keyed to "response" it flips the score bytes, which
    the client's verify catches before the merge and retries."""
    from distributed_tf_serving_tpu_torch.utils.config import IntegrityConfig

    faults.get().add("client.rpc", "error", key=three_backends[0], code="UNAVAILABLE", count=1)
    arrays = _arrays(n=9, seed=17)
    servable = _servable()
    want = _golden(servable, arrays)

    async def failover():
        async with ShardedPredictClient(list(three_backends), "DCN", failover_attempts=1,
                                        backoff_initial_s=0.0) as client:
            scores = await client.predict(arrays)
            return scores, client.resilience_counters()

    scores, counters = asyncio.run(failover())
    np.testing.assert_allclose(scores, want, rtol=1e-6)
    assert counters["failovers"] >= 1
    assert faults.get().fires["client.rpc"] == 1

    plane = IntegrityConfig(enabled=True).build()
    registry = ServableRegistry()
    registry.load(servable)
    batcher = DynamicBatcher(device="cpu", buckets=(32,), max_wait_us=0).start()
    impl = PredictionServiceImpl(registry, batcher)
    batcher.integrity = impl.integrity = plane
    server, port = create_server(impl, "127.0.0.1:0")
    server.start()

    async def wired(payloads, **kw):
        async with ShardedPredictClient([f"127.0.0.1:{port}"], "DCN", integrity_checksums=True,
                                        **kw) as client:
            out = await asyncio.gather(*(client.predict(p) for p in payloads),
                                       return_exceptions=True)
            return out, client.resilience_counters()

    try:
        faults.get().add("wire_corrupt", "error", key="feat_wts", count=1)
        results, _ = asyncio.run(wired([_arrays(n=5, seed=s) for s in (20, 21, 22)]))
        errs = [r for r in results if isinstance(r, Exception)]
        assert len(errs) == 1 and isinstance(errs[0], PredictClientError)
        assert "corrupt-wire" in str(errs[0])
        assert plane.snapshot()["wire"]["inputs_rejected"] == 1
        faults.get().add("wire_corrupt", "error", key="response", count=1)
        (got,), counters = asyncio.run(wired([arrays], scoreboard=True, failover_attempts=3,
                                             backoff_initial_s=0.0))
        np.testing.assert_allclose(got, want, rtol=1e-6)
        assert counters["corrupt_responses"] == 1
        assert counters["scoreboard"]["corruptions"] == 1
        assert faults.get().fires["wire_corrupt"] == 2
    finally:
        server.stop(0)
        batcher.stop()
