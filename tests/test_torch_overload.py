"""The port's overload plane (serving/overload.py and its wiring) against
the JAX package's on the CPU: the AdmissionController's AIMD limit, doomed-
work refusal, criticality lanes and pressure state machine under a fake
clock, and the same scripted sequence of queue waits, batch times, ticks,
admits and `pressure` rules giving the JAX controller's decisions and
snapshots step by step; through the batcher, a refusal with its retry-after
hint, the static bound with the plane off, the brownout stale-serve of the
score cache (marked degraded, never refilled); over gRPC, the JAX
`ShardedPredictClient` refused with `retry-after-ms` and honouring it, and
the degraded mark of a MultiInference served stale surviving the coroutine
server's executor hop; the [overload] section, build_stack's switch, the
dts_tpu_overload_* series (the JAX exposition's text) and the REST
headers."""

import asyncio
import dataclasses
import threading

import grpc
import grpc.aio
import jax
import numpy as np
import pytest

from distributed_tf_serving_tpu import faults as jax_faults
from distributed_tf_serving_tpu.models import ModelConfig as JaxConfig
from distributed_tf_serving_tpu.models import build_model as jax_build
from distributed_tf_serving_tpu.serving import overload as jax_overload
from distributed_tf_serving_tpu.utils import config as jax_config
from distributed_tf_serving_tpu.utils.metrics import ServerMetrics as JaxMetrics
from distributed_tf_serving_tpu_torch import faults
from distributed_tf_serving_tpu_torch.cache import ScoreCache
from distributed_tf_serving_tpu_torch.convert import params_from_jax
from distributed_tf_serving_tpu_torch.models import (
    ModelConfig,
    Servable,
    ServableRegistry,
    build_model,
    ctr_signatures,
)
from distributed_tf_serving_tpu_torch.proto import PredictionServiceStub
from distributed_tf_serving_tpu_torch.proto import serving_apis_pb2 as apis
from distributed_tf_serving_tpu_torch.serving import overload as overload_mod
from distributed_tf_serving_tpu_torch.serving.batcher import (
    AdmissionRefusedError,
    DynamicBatcher,
    QueueOverloadError,
)
from distributed_tf_serving_tpu_torch.serving.example_codec import make_example
from distributed_tf_serving_tpu_torch.serving.overload import (
    BROWNOUT,
    NOMINAL,
    SHED,
    AdmissionController,
)
from distributed_tf_serving_tpu_torch.serving.service import PredictionServiceImpl, ServiceError
from distributed_tf_serving_tpu_torch.utils.config import OverloadConfig, ServerConfig, load_config
from distributed_tf_serving_tpu_torch.utils.metrics import ServerMetrics

F = 6
KW = dict(num_fields=F, vocab_size=1 << 10, embed_dim=4, mlp_dims=(8,), num_cross_layers=1,
          compute_dtype="float32")


@pytest.fixture(scope="module")
def servable():
    jm = jax_build("dcn_v2", JaxConfig(name="DCN", **KW))
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    return Servable(name="DCN", version=1,
                    model=build_model("dcn_v2", ModelConfig(name="DCN", **KW)),
                    params=params_from_jax(jp, "cpu"), signatures=ctr_signatures(F))


def make_arrays(n, seed=0):
    rng = np.random.RandomState(seed)
    return {"feat_ids": rng.randint(0, 1 << 40, size=(n, F)).astype(np.int64),
            "feat_wts": rng.rand(n, F).astype(np.float32)}


@pytest.fixture(autouse=True)
def _clean_overload_state():
    """A controller switches its module's fast path on; both packages'
    gates, marks and injectors start and end clear."""
    faults.reset(0)
    jax_faults.reset(0)
    yield
    faults.reset(0)
    jax_faults.reset(0)
    for mod in (overload_mod, jax_overload):
        mod.deactivate()
        mod.consume_degraded()


def _cfg(**kw) -> OverloadConfig:
    return OverloadConfig(enabled=True, **kw)


# ------------------------------------------------------- AIMD convergence


def test_limit_converges_down_then_up_with_fake_clock():
    clock = [0.0]
    ctrl = AdmissionController(
        _cfg(target_queue_wait_ms=50.0, queue_wait_window_s=1.0, adjust_interval_s=0.5,
             increase_candidates=10, decrease_factor=0.5, min_limit_candidates=16,
             max_limit_candidates=128),
        clock=lambda: clock[0],
    )
    assert ctrl.limit == 128  # starts at max: unloaded == the static bound
    for want in (64, 32, 16, 16):
        ctrl.note_queue_wait(0.2)  # 200 ms >> the 50 ms target
        clock[0] += 0.6
        ctrl.state()
        assert ctrl.limit == want
    assert ctrl.limit_decreases == 3
    clock[0] += 2.0  # the over-target samples age out
    for _ in range(20):
        ctrl.note_queue_wait(0.001)
        clock[0] += 0.6
        ctrl.state()
    assert ctrl.limit == 128 and ctrl.limit_increases >= 11
    snap = ctrl.snapshot()
    assert snap["min_limit"] == 16 and snap["max_limit"] == 128


def test_bind_resolves_auto_limits_from_batcher_geometry():
    ctrl = AdmissionController(_cfg(), clock=lambda: 0.0)
    ctrl.bind(largest_bucket=4096, queue_capacity=65536)
    assert (ctrl.min_limit, ctrl.max_limit, ctrl.limit) == (4096, 65536, 65536)


# ----------------------------------------------------- doomed-work refusal


def test_doomed_work_refused_at_enqueue():
    ctrl = AdmissionController(
        _cfg(min_limit_candidates=1000, max_limit_candidates=10000, adjust_interval_s=1e9),
        clock=lambda: 0.0)
    ctrl.note_batch(100, 1.0)  # EWMA: 10 ms per candidate
    d = ctrl.admit(10, backlog=500, deadline_s=1.0)  # estimated wait 5 s > 1 s
    assert not d.admitted and d.reason == "doomed"
    assert d.retry_after_ms == 2000  # the 2.5 s half-drain hint, capped
    assert ctrl.doomed_refusals == 1
    assert ctrl.admit(10, backlog=500, deadline_s=10.0).admitted
    assert ctrl.admit(10, backlog=500).admitted
    fresh = AdmissionController(_cfg(min_limit_candidates=1000, adjust_interval_s=1e9),
                                clock=lambda: 0.0)
    assert fresh.admit(10, backlog=500, deadline_s=0.001).admitted  # no estimate: no doom


def test_deadline_refusal_config_gate():
    ctrl = AdmissionController(
        _cfg(deadline_refusal=False, min_limit_candidates=1000, adjust_interval_s=1e9),
        clock=lambda: 0.0)
    ctrl.note_batch(100, 1.0)
    assert ctrl.admit(10, backlog=500, deadline_s=0.001).admitted


# ------------------------------------------------------ criticality lanes


def test_lane_shed_ordering():
    ctrl = AdmissionController(
        _cfg(min_limit_candidates=100, max_limit_candidates=100, adjust_interval_s=1e9),
        clock=lambda: 0.0)
    # 68 + 5 = 73: past the probe (50) and sheddable (70) caps, inside
    # default (90) and critical (100).
    assert not ctrl.admit(5, 68, lane="probe").admitted
    assert not ctrl.admit(5, 68, lane="sheddable").admitted
    assert ctrl.admit(5, 68, lane="default").admitted
    assert ctrl.admit(5, 68, lane="critical").admitted
    assert ctrl.admit(10_000, 0, lane="probe").admitted  # an empty queue always admits
    assert overload_mod.normalize_criticality("CRITICAL") == "critical"
    assert overload_mod.normalize_criticality("best-effort") == "default"
    assert overload_mod.normalize_criticality(None) == "default"
    snap = ctrl.snapshot()
    assert snap["sheds_by_lane"]["probe"] == 1 and snap["sheds_by_lane"]["sheddable"] == 1


def test_shed_state_refuses_sheddable_outright():
    ctrl = AdmissionController(_cfg(min_limit_candidates=100, adjust_interval_s=1e9),
                               clock=lambda: 0.0)
    ctrl._state = SHED
    assert not ctrl.admit(1, 0, lane="sheddable").admitted
    assert not ctrl.admit(1, 0, lane="probe").admitted
    assert ctrl.admit(1, 0, lane="default").admitted


def test_brownout_still_admits_probe_warmup():
    ctrl = AdmissionController(
        _cfg(min_limit_candidates=100, max_limit_candidates=100, adjust_interval_s=1e9),
        clock=lambda: 0.0)
    ctrl._state = BROWNOUT
    assert ctrl.admit(32, 0, lane="probe").admitted
    assert ctrl.admit(5, 40, lane="probe").admitted
    assert not ctrl.admit(5, 60, lane="probe").admitted
    assert ctrl.admit(1, 0, lane="sheddable").admitted  # brownout is not shed


# -------------------------------------------------- pressure state machine


def test_pressure_state_machine_escalates_and_recovers():
    clock = [0.0]
    ctrl = AdmissionController(
        _cfg(target_queue_wait_ms=50.0, queue_wait_window_s=1.0, adjust_interval_s=0.5,
             brownout_after_intervals=2, shed_after_intervals=4, recover_after_intervals=2,
             min_limit_candidates=16, max_limit_candidates=128),
        clock=lambda: clock[0])

    def tick(over: bool):
        if over:
            ctrl.note_queue_wait(0.2)
        clock[0] += 0.6
        return ctrl.state()

    assert [tick(True) for _ in range(6)] == [NOMINAL, BROWNOUT, BROWNOUT, BROWNOUT,
                                              BROWNOUT, SHED]
    clock[0] += 2.0
    assert [tick(False) for _ in range(4)] == [SHED, BROWNOUT, BROWNOUT, NOMINAL]
    assert ctrl.state_changes == 4


def test_pressure_fault_site_pins_state():
    ctrl = AdmissionController(_cfg(adjust_interval_s=0.0), clock=lambda: 0.0)
    faults.get().add("pressure", "error", code="BROWNOUT")
    assert ctrl.state() == BROWNOUT and ctrl.stale_serve_active()
    faults.reset()
    faults.get().add("pressure", "error", code="SHED")
    assert ctrl.state() == SHED
    faults.reset()
    for _ in range(int(ctrl.cfg.recover_after_intervals) * 2 + 1):
        ctrl.state()
    assert ctrl.state() == NOMINAL


# --------------------------------------------- the JAX controller, step by step


def _script(seed: int, n_ops: int = 400):
    """A seeded script of controller operations: queue waits, batch times,
    clock steps, admits across lanes and deadlines, state reads, stale-serve
    reads, and `pressure` rules added and cleared."""
    rng = np.random.RandomState(seed)
    lanes = ["critical", "default", "sheddable", "probe", "bogus", None]
    ops = []
    for _ in range(n_ops):
        r = rng.rand()
        if r < 0.2:
            ops.append(("waits", [float(w) for w in rng.exponential(0.03, rng.randint(1, 6))]))
        elif r < 0.3:
            ops.append(("batch", int(rng.randint(0, 3000)), float(rng.exponential(0.02))))
        elif r < 0.5:
            ops.append(("clock", float(rng.choice([0.05, 0.2, 0.6, 1.5]))))
        elif r < 0.85:
            deadline = None if rng.rand() < 0.5 else float(rng.exponential(0.05))
            ops.append(("admit", int(rng.randint(1, 2049)), int(rng.randint(0, 40000)),
                        lanes[rng.randint(len(lanes))], deadline))
        elif r < 0.9:
            ops.append(("state",))
        elif r < 0.95:
            ops.append(("stale",))
        elif r < 0.98:
            ops.append(("pressure", str(rng.choice(["BROWNOUT", "SHED", "NOMINAL"]))))
        else:
            ops.append(("clear",))
    return ops


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scripted_sequence_gives_the_jax_controller_s_decisions(seed):
    knobs = dict(enabled=True, target_queue_wait_ms=20.0, queue_wait_window_s=2.0,
                 adjust_interval_s=0.5, increase_candidates=512, decrease_factor=0.6,
                 brownout_after_intervals=2, shed_after_intervals=3,
                 recover_after_intervals=2, stale_while_overloaded_s=4.0)
    clock = [0.0]
    ours = AdmissionController(OverloadConfig(**knobs), clock=lambda: clock[0])
    theirs = jax_overload.AdmissionController(jax_config.OverloadConfig(**knobs),
                                              clock=lambda: clock[0])
    ours.bind(2048, 32768)
    theirs.bind(2048, 32768)
    for step, op in enumerate(_script(seed)):
        kind = op[0]
        if kind == "waits":
            ours.note_queue_waits(op[1])
            theirs.note_queue_waits(op[1])
        elif kind == "batch":
            ours.note_batch(op[1], op[2])
            theirs.note_batch(op[1], op[2])
        elif kind == "clock":
            clock[0] += op[1]
        elif kind == "admit":
            _, n, backlog, lane, deadline = op
            a = ours.admit(n, backlog, lane=lane, deadline_s=deadline)
            b = theirs.admit(n, backlog, lane=lane, deadline_s=deadline)
            assert dataclasses.asdict(a) == dataclasses.asdict(b), step
        elif kind == "state":
            assert ours.state() == theirs.state(), step
        elif kind == "stale":
            assert ours.stale_serve_active() == theirs.stale_serve_active(), step
        elif kind == "pressure":
            faults.get().add("pressure", "error", code=op[1])
            jax_faults.get().add("pressure", "error", code=op[1])
        else:
            faults.get().clear()
            jax_faults.get().clear()
        if step % 25 == 0:
            assert ours.snapshot() == theirs.snapshot(), step
    snap = ours.snapshot()
    assert snap == theirs.snapshot()
    assert snap["admitted"] and snap["sheds"] and snap["ticks"]


# --------------------------------------------- batcher admission (armed)


def test_batcher_refusal_carries_retry_after_and_maps_resource_exhausted(servable):
    ctrl = AdmissionController(
        _cfg(min_limit_candidates=8, max_limit_candidates=8, adjust_interval_s=1e9))
    batcher = DynamicBatcher(buckets=(8,), max_wait_us=0, device="cpu", overload=ctrl,
                             pipeline_depth=1).start()
    faults.get().add("batcher.dispatch", "wedge", count=1, delay_s=30)
    futs, err = [], None
    try:
        for i in range(8):
            try:
                futs.append(batcher.submit(servable, make_arrays(4, seed=i)))
            except AdmissionRefusedError as e:
                err = e
                break
        assert err is not None, "the adaptive limit never refused"
        assert isinstance(err, QueueOverloadError)
        assert err.reason == "shed" and err.retry_after_ms >= 25
        assert ctrl.sheds >= 1
        mapped = PredictionServiceImpl._translate_batcher_error(err, None)
        assert mapped.code == "RESOURCE_EXHAUSTED" and mapped.retry_after_ms == err.retry_after_ms
    finally:
        faults.get().clear()
        for f in futs:
            f.result(timeout=30)  # accepted work still completes
        batcher.stop()


def test_disabled_mode_keeps_static_bound(servable):
    assert not overload_mod.active()
    batcher = DynamicBatcher(buckets=(32,), max_wait_us=0, device="cpu").start()
    try:
        assert batcher.overload is None
        assert batcher.submit(servable, make_arrays(4)).result(timeout=60)[
            "prediction_node"].shape == (4,)
    finally:
        batcher.stop()
    assert OverloadConfig().build() is None


def test_queue_waits_and_service_time_feed_the_controller(servable):
    """Each dispatched batch feeds its members' queue waits, and each
    completed batch its service time (up to the readback), so the EWMA
    prices the backlog; warmup feeds neither."""
    ctrl = AdmissionController(_cfg(adjust_interval_s=1e9))
    batcher = DynamicBatcher(buckets=(8, 32), max_wait_us=0, device="cpu",
                             overload=ctrl).start()
    try:
        batcher.warmup_via_queue(servable)
        assert not ctrl._waits and ctrl.snapshot()["ewma_service_us_per_candidate"] is None
        for i in range(3):
            batcher.submit(servable, make_arrays(5, seed=i)).result(timeout=60)
        snap = ctrl.snapshot()
        assert len(ctrl._waits) == 3 and snap["ewma_service_us_per_candidate"] > 0
        assert snap["admitted"] == 3 + len(batcher.buckets)  # warmup admits on the probe lane
    finally:
        batcher.stop()


# ------------------------------------------------- brownout stale-serve


def test_brownout_serves_stale_cache_marked_degraded_no_refill(servable):
    cache_clock = [0.0]
    cache = ScoreCache(ttl_s=1.0, clock=lambda: cache_clock[0])
    ctrl = AdmissionController(
        _cfg(adjust_interval_s=0.0, stale_while_overloaded_s=5.0, recover_after_intervals=1))
    batcher = DynamicBatcher(buckets=(32,), max_wait_us=0, device="cpu", score_cache=cache,
                             overload=ctrl).start()
    try:
        arrays = make_arrays(4, seed=7)
        fresh = batcher.submit(servable, arrays).result(timeout=60)
        assert overload_mod.consume_degraded() is None
        cache_clock[0] = 1.5
        faults.get().add("pressure", "error", code="BROWNOUT")
        assert ctrl.state() == BROWNOUT
        stale = batcher.submit(servable, arrays).result(timeout=60)
        np.testing.assert_array_equal(stale["prediction_node"], fresh["prediction_node"])
        assert overload_mod.consume_degraded() == "stale"
        assert ctrl.snapshot()["brownout_serves"] == 1
        assert cache.snapshot()["stale_serves"] == 1
        faults.reset()
        assert ctrl.state() == NOMINAL
        misses_before = cache.snapshot()["misses"]
        again = batcher.submit(servable, arrays).result(timeout=60)
        assert overload_mod.consume_degraded() is None
        assert cache.snapshot()["misses"] == misses_before + 1
        np.testing.assert_array_equal(again["prediction_node"], fresh["prediction_node"])
        cache_clock[0] = 1.5 + 1.0 + 5.1  # past ttl + the stale window
        faults.get().add("pressure", "error", code="BROWNOUT")
        assert ctrl.state() == BROWNOUT
        recomputed = batcher.submit(servable, arrays).result(timeout=60)
        assert overload_mod.consume_degraded() is None
        assert ctrl.snapshot()["brownout_serves"] == 1
        np.testing.assert_array_equal(recomputed["prediction_node"], fresh["prediction_node"])
    finally:
        batcher.stop()


def test_planes_off_and_on_give_the_same_bits(servable):
    """An armed controller that admits everything changes no score."""
    arrays = [make_arrays(n, seed=n) for n in (1, 7, 30)]
    outs = []
    for ctrl in (None, AdmissionController(_cfg())):
        b = DynamicBatcher(buckets=(8, 32), max_wait_us=0, device="cpu", overload=ctrl).start()
        try:
            outs.append([b.submit(servable, a).result(timeout=60)["prediction_node"]
                         for a in arrays])
        finally:
            b.stop()
    for x, y in zip(*outs):
        assert np.array_equal(x, y)


# ------------------------------------------------------------ over gRPC


def _impl(servable, **batcher_kw):
    registry = ServableRegistry()
    registry.load(servable)
    batcher = DynamicBatcher(buckets=(32,), max_wait_us=0, device="cpu", **batcher_kw).start()
    return PredictionServiceImpl(registry, batcher), batcher


def test_grpc_pushback_end_to_end(servable):
    """Pinned in SHED: the JAX client's sheddable Predict is refused
    RESOURCE_EXHAUSTED with retry-after-ms, which its backoff honours; its
    scoreboard records pushback, never an ejection; default traffic still
    flows on the same server."""
    from distributed_tf_serving_tpu.client import (
        BackendScoreboard,
        PredictClientError,
        ScoreboardConfig,
        ShardedPredictClient,
    )
    from distributed_tf_serving_tpu.client.health import HEALTHY
    from distributed_tf_serving_tpu_torch.serving.server import create_server

    ctrl = AdmissionController(_cfg(adjust_interval_s=0.0))
    faults.get().add("pressure", "error", code="SHED")
    impl, batcher = _impl(servable, overload=ctrl)
    server, port = create_server(impl, "127.0.0.1:0")
    server.start()
    host = f"127.0.0.1:{port}"

    async def go():
        async with ShardedPredictClient(
            [host], "DCN", criticality="sheddable", failover_attempts=1,
            backoff_initial_s=0.0,
            scoreboard=BackendScoreboard([host], ScoreboardConfig(failure_threshold=1)),
        ) as shed_client:
            with pytest.raises(PredictClientError) as ei:
                await shed_client.predict(make_arrays(4, seed=1))
            counters = shed_client.resilience_counters()
            code = getattr(ei.value.code, "name", str(ei.value.code))
        async with ShardedPredictClient([host], "DCN") as ok_client:
            scores = await ok_client.predict(make_arrays(4, seed=1))
        return code, counters, scores

    try:
        code, counters, scores = asyncio.run(go())
    finally:
        server.stop(0)
        batcher.stop()
    assert code == "RESOURCE_EXHAUSTED"
    assert counters["pushbacks_received"] >= 2 and counters["retry_after_honored"] >= 1
    sb = counters["scoreboard"]
    assert sb["ejections"] == 0 and sb["pushbacks"] >= 2
    assert sb["backends"][host]["state"] == HEALTHY
    assert scores.shape == (4,)
    assert ctrl.sheds_by_lane["sheddable"] >= 2 and ctrl.snapshot()["state"] == SHED


def _multi_inference_request(n=3, seed=0):
    rng = np.random.RandomState(seed)
    req = apis.MultiInferenceRequest()
    for _ in range(n):
        req.input.example_list.examples.append(make_example(
            rng.randint(0, 1 << 30, size=F).tolist(), rng.rand(F).astype(np.float32).tolist()))
    for method in ("tensorflow/serving/classify", "tensorflow/serving/regress"):
        task = req.tasks.add()
        task.model_spec.name = "DCN"
        task.method_name = method
    return req


@pytest.mark.parametrize("server_kind", ["sync", "aio"])
def test_a_stale_multi_inference_is_marked_degraded_on_both_servers(servable, server_kind):
    """MultiInference runs off the coroutine server's loop, whose executor
    carries no contextvar back: the stale serve's mark rides the return
    value and reaches the trailing metadata, as on the threaded server."""
    from distributed_tf_serving_tpu_torch.serving.server import create_server, create_server_async

    cache_clock = [0.0]
    cache = ScoreCache(ttl_s=1.0, clock=lambda: cache_clock[0])
    ctrl = AdmissionController(_cfg(adjust_interval_s=0.0, stale_while_overloaded_s=5.0))
    impl, batcher = _impl(servable, score_cache=cache, overload=ctrl)
    req = _multi_inference_request()

    async def call(stub):
        c = stub.MultiInference(req, timeout=30)
        resp = await c
        md = await c.trailing_metadata()
        return resp, dict(list(md or ()))

    async def go():
        if server_kind == "aio":
            server, port = create_server_async(impl, "127.0.0.1:0")
            await server.start()
        else:
            server, port = create_server(impl, "127.0.0.1:0")
            server.start()
        try:
            async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as ch:
                stub = PredictionServiceStub(ch)
                fresh, md_fresh = await call(stub)
                cache_clock[0] = 1.5
                faults.get().add("pressure", "error", code="BROWNOUT")
                stale, md_stale = await call(stub)
                faults.reset()
                return fresh, md_fresh, stale, md_stale
        finally:
            res = server.stop(0)
            if asyncio.iscoroutine(res):
                await res

    try:
        fresh, md_fresh, stale, md_stale = asyncio.run(go())
    finally:
        batcher.stop()
    assert overload_mod.DEGRADED_KEY not in md_fresh
    assert md_stale.get(overload_mod.DEGRADED_KEY) == "stale"
    assert stale.SerializeToString() == fresh.SerializeToString()
    assert ctrl.snapshot()["brownout_serves"] >= 1


# ------------------------------------------------ config + observability


def test_overload_config_section(tmp_path):
    text = ("[server]\n[overload]\nenabled = true\ntarget_queue_wait_ms = 20.0\n"
            "min_limit_candidates = 64\ndecrease_factor = 0.5\n"
            "stale_while_overloaded_s = 3.0\ndrain_grace_s = 2.5\n")
    p = tmp_path / "cfg.toml"
    p.write_text(text)
    loaded = load_config(str(p))
    oc = loaded["overload"]
    assert oc.enabled and oc.target_queue_wait_ms == 20.0 and oc.min_limit_candidates == 64
    assert oc.decrease_factor == 0.5 and oc.stale_while_overloaded_s == 3.0
    assert oc.drain_grace_s == loaded["drain_grace_s"] == 2.5
    assert dataclasses.asdict(oc) == dataclasses.asdict(jax_config.load_config(str(p))["overload"])
    ctrl = oc.build()
    assert ctrl is not None and ctrl.min_limit == 64


def test_build_stack_overload_master_switch():
    from distributed_tf_serving_tpu_torch.serving.server import build_stack

    cfg = ServerConfig(warmup=False, buckets=(32,), num_fields=F)
    for enabled in (False, True):
        impl, batcher, _ = build_stack(cfg, ModelConfig(name="DCN", **KW), device="cpu",
                                       overload_config=OverloadConfig(enabled=enabled))
        try:
            assert (batcher.overload is not None) == enabled
            if enabled:
                assert batcher.overload.min_limit == batcher.buckets[-1]
                assert batcher.overload.max_limit == batcher.queue_capacity_candidates
                assert impl.overload_stats()["enabled"] is True
            else:
                assert impl.overload_stats() is None
        finally:
            batcher.stop()


def test_overload_prometheus_series_are_the_jax_exposition():
    ctrl = AdmissionController(_cfg(min_limit_candidates=100, adjust_interval_s=1e9),
                               clock=lambda: 0.0)
    ctrl.admit(5, 68, lane="sheddable")
    snap = ctrl.snapshot()
    text = ServerMetrics().prometheus_text(overload=snap)
    assert text == JaxMetrics().prometheus_text(overload=snap)
    assert "dts_tpu_overload_limit_candidates 100" in text
    assert "dts_tpu_overload_sheds_total 1" in text
    assert 'dts_tpu_overload_lane_sheds_total{lane="sheddable"} 1' in text
    assert 'dts_tpu_overload_pressure_state{state="nominal"} 1' in text


def test_rest_overload_headers():
    from aiohttp import web

    from distributed_tf_serving_tpu_torch.serving.rest import _json_error, _mark_degraded

    r = _json_error("RESOURCE_EXHAUSTED", "shed", retry_after_ms=25)
    assert r.status == 429 and r.headers["Retry-After"] == "1"
    assert r.headers["retry-after-ms"] == "25"
    assert "Retry-After" not in _json_error("NOT_FOUND", "x").headers
    overload_mod._set_active(True)
    overload_mod.mark_degraded("stale")
    assert _mark_degraded(web.json_response({})).headers["X-DTS-Degraded"] == "stale"
    assert "X-DTS-Degraded" not in _mark_degraded(web.json_response({})).headers


def test_rest_refusal_and_criticality_over_http(servable):
    """Over the REST gateway: a sheddable request under SHED answers 429
    with Retry-After, a default one 200."""
    import aiohttp

    from distributed_tf_serving_tpu_torch.serving.rest import start_rest_gateway

    ctrl = AdmissionController(_cfg(adjust_interval_s=0.0))
    faults.get().add("pressure", "error", code="SHED")
    impl, batcher = _impl(servable, overload=ctrl)
    arrays = make_arrays(2, seed=3)
    body = {"inputs": {k: v.tolist() for k, v in arrays.items()}}

    async def go():
        runner, port = await start_rest_gateway(impl, port=0)
        try:
            async with aiohttp.ClientSession(f"http://127.0.0.1:{port}") as s:
                async with s.post("/v1/models/DCN:predict", json=body,
                                  headers={"x-dts-criticality": "sheddable"}) as r:
                    shed = (r.status, dict(r.headers))
                async with s.post("/v1/models/DCN:predict", json=body) as r:
                    ok = r.status
                async with s.get("/monitoring?section=overload") as r:
                    sec = await r.json()
            return shed, ok, sec
        finally:
            await runner.cleanup()

    try:
        (status, headers), ok, sec = asyncio.run(go())
    finally:
        batcher.stop()
    assert status == 429 and int(headers["Retry-After"]) >= 1
    assert int(headers["retry-after-ms"]) >= 25
    assert ok == 200
    assert sec["overload"]["state"] == SHED and sec["overload"]["sheds_by_lane"]["sheddable"] == 1


def test_service_error_carries_the_hint_through_predict(servable):
    ctrl = AdmissionController(_cfg(adjust_interval_s=0.0))
    faults.get().add("pressure", "error", code="SHED")
    impl, batcher = _impl(servable, overload=ctrl)
    try:
        req = apis.PredictRequest()
        req.model_spec.name = "DCN"
        from distributed_tf_serving_tpu_torch import codec

        for k, v in make_arrays(2).items():
            codec.from_ndarray(v, out=req.inputs[k])
        with pytest.raises(ServiceError) as e:
            impl.predict(req, criticality="sheddable")
        assert e.value.code == "RESOURCE_EXHAUSTED" and e.value.retry_after_ms >= 25
        assert impl.predict(req, criticality="critical").outputs["prediction_node"]
    finally:
        batcher.stop()


def test_controller_is_thread_safe_under_concurrent_admits():
    ctrl = AdmissionController(_cfg(adjust_interval_s=0.0, min_limit_candidates=10,
                                    max_limit_candidates=1000))
    errors = []

    def hammer(seed):
        rng = np.random.RandomState(seed)
        try:
            for _ in range(500):
                ctrl.admit(int(rng.randint(1, 50)), int(rng.randint(0, 2000)),
                           lane=["critical", "sheddable"][seed % 2])
                ctrl.note_queue_wait(float(rng.exponential(0.05)))
        except Exception as e:  # noqa: BLE001 — collected for the assert
            errors.append(e)

    threads = [threading.Thread(target=hammer, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    snap = ctrl.snapshot()
    assert not errors and snap["admitted"] + snap["sheds"] == 2000
