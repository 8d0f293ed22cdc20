"""Elastic mesh serving in the port against the JAX package, case for case
with tests/test_elastic.py: ladder parsing and validation, the per-split
in-flight drain barrier, the controller's dwell / hysteresis trajectory
under a fake clock (both packages' executors and controllers driven through
the same steps, their snapshots compared), the batcher's issue-token
protocol on every path, warmup of every rung, build_stack's wiring and
refusals, [recovery] x [mesh] as one unit, and the elastic surfaces.

Scores: a split switch changes each shard's row count; a row's bits do not
depend on it (models/base.py ROW_TILE; tests/test_torch_row_count.py), so
the scores are held to the per-shard reference's bits on each split and,
as in the JAX test, bit-identical across switches."""

import asyncio
import time

import jax
import numpy as np
import pytest
import torch

from distributed_tf_serving_tpu.models import ModelConfig as JaxConfig
from distributed_tf_serving_tpu.models import build_model as jax_build
from distributed_tf_serving_tpu.parallel import elastic as jax_elastic
from distributed_tf_serving_tpu.serving.server import build_stack as jax_build_stack
from distributed_tf_serving_tpu.utils import config as jax_config
from distributed_tf_serving_tpu.utils.metrics import ServerMetrics as JaxMetrics
from distributed_tf_serving_tpu_torch import faults
from distributed_tf_serving_tpu_torch.convert import params_from_jax
from distributed_tf_serving_tpu_torch.models import ModelConfig, Servable, build_model
from distributed_tf_serving_tpu_torch.models import ctr_signatures
from distributed_tf_serving_tpu_torch.parallel import (
    ElasticMeshExecutor,
    ShardedExecutor,
    make_mesh,
)
from distributed_tf_serving_tpu_torch.parallel import elastic as port_elastic
from distributed_tf_serving_tpu_torch.parallel.elastic import (
    format_split,
    parse_split,
    resolve_ladder,
)
from distributed_tf_serving_tpu_torch.parallel.mesh import row_blocks
from distributed_tf_serving_tpu_torch.serving.batcher import DynamicBatcher, fold_ids_host
from distributed_tf_serving_tpu_torch.serving.server import build_stack
from distributed_tf_serving_tpu_torch.utils.config import (
    ElasticConfig,
    MeshConfig,
    OverloadConfig,
    RecoveryConfig,
    ServerConfig,
    load_config,
)
from distributed_tf_serving_tpu_torch.utils.metrics import ServerMetrics

KW = dict(num_fields=8, vocab_size=1024, embed_dim=4, mlp_dims=(16,), num_cross_layers=1,
          compute_dtype="float32")
CFG = ModelConfig(**KW)
CPU8 = [torch.device("cpu")] * 8
# (the elastic module, its ElasticConfig) of each package
BOTH = ((port_elastic, ElasticConfig), (jax_elastic, jax_config.ElasticConfig))


def _servable(seed=0):
    """The port's dcn_v2 servable with the JAX package's seeded params."""
    jm = jax_build("dcn_v2", JaxConfig(**KW))
    params = params_from_jax(jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed))))
    return Servable(name="DCN", version=1, model=build_model("dcn_v2", CFG), params=params,
                    signatures=ctr_signatures(8))


def _arrays(n, seed=0):
    rng = np.random.RandomState(seed)
    return {
        "feat_ids": rng.randint(0, 1 << 40, size=(n, 8)).astype(np.int64),
        "feat_wts": rng.rand(n, 8).astype(np.float32),
    }


def _shard_golden(sv, arrays, data, bucket):
    n = arrays["feat_ids"].shape[0]
    rows = bucket + (-bucket) % data
    padded = {}
    for k, v in {"feat_ids": fold_ids_host(arrays["feat_ids"], 1024),
                 "feat_wts": arrays["feat_wts"]}.items():
        buf = np.zeros((rows,) + v.shape[1:], v.dtype)
        buf[:n] = v
        padded[k] = torch.from_numpy(buf)
    with torch.inference_mode():
        return np.concatenate([sv.model.apply(sv.params, {k: v[lo:hi] for k, v in padded.items()})
                               ["prediction_node"].numpy() for lo, hi in row_blocks(rows, data)])[:n]


def _fake_exec(name):
    def fn(servable, arrays, out_keys=None):
        n = next(iter(arrays.values())).shape[0]
        fn.calls.append(n)
        return {"prediction_node": np.full(n, fn.value, np.float32)}

    fn.calls = []
    fn.value = float(sum(map(ord, name)) % 7)
    return fn


def _fake_elastic(el=port_elastic, clock=None, splits=((8, 1), (4, 2))):
    execs = {s: _fake_exec(format_split(s)) for s in splits}
    kwargs = {"clock": clock} if clock is not None else {}
    ex = el.ElasticMeshExecutor(splits=list(splits), initial=splits[-1], executors=execs,
                                **kwargs)
    return ex, execs


def _drop_times(snap):
    """An elastic snapshot without the wall-clock stamps of its history."""
    out = dict(snap)
    out["history"] = [{k: v for k, v in h.items() if k != "t"} for h in snap["history"]]
    return out


# ----------------------------------------------------------- ladder/config


def test_parse_split_forms_and_errors():
    for el, _ in BOTH:
        assert el.parse_split("4x2") == (4, 2)
        assert el.parse_split((2, 4)) == (2, 4)
        assert el.format_split((8, 1)) == "8x1"
    for bad in ("4", "x2", "ax2", "0x8", "4x-1", "4x2x1"):
        with pytest.raises(ValueError) as ours:
            parse_split(bad)
        with pytest.raises(ValueError) as theirs:
            jax_elastic.parse_split(bad)
        assert str(ours.value) == str(theirs.value)


def test_resolve_ladder_derived_and_explicit():
    for el, _ in BOTH:
        assert el.resolve_ladder((), 8, (4, 2)) == [(8, 1), (4, 2)]
        assert el.resolve_ladder((), 8, (2, 4)) == [(8, 1), (4, 2), (2, 4)]
        assert el.resolve_ladder(["2x4", "8x1"], 8, (4, 2)) == [(8, 1), (4, 2), (2, 4)]
        assert el.resolve_ladder((), 4, (1, 4)) == [(4, 1), (2, 2), (1, 4)]
    for args, match in ((( ["3x2"], 8, (8, 1)), "factorize"), ((["8x1"], 8, (8, 1)), ">= 2")):
        with pytest.raises(ValueError, match=match) as ours:
            resolve_ladder(*args)
        with pytest.raises(ValueError, match=match) as theirs:
            jax_elastic.resolve_ladder(*args)
        assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("bad,match", [
    ({"splits": ("8by1",)}, "DATAxMODEL"),
    ({"dwell_s": 0}, "positive number"),
    ({"up_after_ticks": 0}, "positive integer"),
    ({"load_up_threshold": 0.5, "load_down_threshold": 0.5}, "hysteresis"),
    ({"load_ewma_alpha": 1.5}, "load_ewma_alpha"),
])
def test_elastic_config_validation(bad, match):
    ElasticConfig(splits=("8x1", "4x2"))
    with pytest.raises(ValueError, match=match) as ours:
        ElasticConfig(**bad)
    with pytest.raises(ValueError, match=match) as theirs:
        jax_config.ElasticConfig(**bad)
    assert str(ours.value) == str(theirs.value)


def test_executor_rejects_initial_outside_ladder():
    for el, _ in BOTH:
        with pytest.raises(ValueError, match="not in the"):
            el.ElasticMeshExecutor(splits=[(8, 1), (4, 2)], initial=(2, 4),
                                   executors={(8, 1): _fake_exec("a"), (4, 2): _fake_exec("b")})


# ------------------------------------------------- switch + drain barrier


def _switch_scenario(el):
    clk = [0.0]
    ex, execs = _fake_elastic(el, clock=lambda: clk[0])
    sv, arrays = object(), {"x": np.zeros((4, 1), np.float32)}
    ex(sv, arrays)
    tok = ex.take_issue_token()
    assert tok == ((4, 2), 0)  # (split, in-flight epoch)
    assert ex.elastic_snapshot()["per_split"]["4x2"]["in_flight"] == 1
    clk[0] = 1.0
    assert ex.switch_split((8, 1), reason="test")
    assert ex.current_split == (8, 1) and ex.drain_pending
    ex(sv, arrays)
    assert ex.take_issue_token()[0] == (8, 1)
    assert execs[(8, 1)].calls == [4]
    assert not ex.switch_split((4, 2), reason="too-soon")
    assert ex.switches_refused_drain == 1
    clk[0] = 3.5
    ex.note_complete(tok)
    assert not ex.drain_pending
    snap = ex.elastic_snapshot()
    assert snap["last_drain_s"] == pytest.approx(2.5)
    assert snap["history"][-1]["drain_s"] == pytest.approx(2.5)
    assert snap["history"][-1]["direction"] == "up"
    assert ex.switch_split((4, 2), reason="back")
    snap = ex.elastic_snapshot()
    assert snap["switches_up"] == 1 and snap["switches_down"] == 1
    return snap


def test_switch_routes_new_dispatches_and_drains_old():
    """A switch while a batch is in flight routes new dispatches to the
    target at once and drains the old split behind the barrier, in both
    packages, to the same snapshot."""
    assert _switch_scenario(port_elastic) == _switch_scenario(jax_elastic)


def test_idle_switch_records_zero_drain():
    for el, _ in BOTH:
        ex, _ = _fake_elastic(el)
        assert ex.switch_split((8, 1))
        assert not ex.drain_pending
        assert ex.last_drain_s == 0.0


def test_dispatch_failure_releases_registration():
    for el, _ in BOTH:
        ex, _ = _fake_elastic(el)

        def boom(servable, arrays, out_keys=None):
            raise RuntimeError("device gone")

        ex._executors[(4, 2)] = boom
        with pytest.raises(RuntimeError):
            ex(object(), {"x": np.zeros((2, 1), np.float32)})
        assert ex.take_issue_token() is None
        assert ex.elastic_snapshot()["per_split"]["4x2"]["in_flight"] == 0


def test_clear_for_recovery_resets_accounting():
    for el, _ in BOTH:
        ex, _ = _fake_elastic(el)
        ex(object(), {"x": np.zeros((2, 1), np.float32)})
        ex.take_issue_token()
        assert ex.switch_split((8, 1))  # old split still draining
        assert ex.drain_pending
        ex.clear_for_recovery()
        assert not ex.drain_pending
        snap = ex.elastic_snapshot()
        assert all(b["in_flight"] == 0 for b in snap["per_split"].values())


def test_stale_epoch_token_never_closes_new_registrations():
    """A completer stranded by a recovery capture reports in after the
    accounting reset: its dead-epoch token is a no-op, so it cannot release
    the drain barrier while a post-recovery batch is in flight."""
    for el, _ in BOTH:
        ex, _ = _fake_elastic(el)
        ex(object(), {"x": np.zeros((2, 1), np.float32)})
        stale = ex.take_issue_token()
        ex.clear_for_recovery()
        ex(object(), {"x": np.zeros((2, 1), np.float32)})
        fresh = ex.take_issue_token()
        assert stale[1] != fresh[1]
        ex.note_complete(stale)
        assert ex.elastic_snapshot()["per_split"]["4x2"]["in_flight"] == 1
        assert ex.switch_split((8, 1), reason="test")
        assert ex.drain_pending
        ex.note_complete(fresh)
        assert not ex.drain_pending


# ------------------------------------------------------------- controller


class _FakeOverload:
    def __init__(self):
        self.pressure = "nominal"

    def state(self):
        return self.pressure


def _controller(el, cfg_cls, ex, clock, **over):
    kw = dict(enabled=True, tick_interval_s=1.0, dwell_s=5.0, up_after_ticks=2,
              down_after_ticks=3, load_up_threshold=0.75, load_down_threshold=0.2)
    kw.update(over)
    ov = _FakeOverload()
    load = [0]
    ctrl = el.ElasticController(cfg_cls(**kw), ex, overload=ov,
                                load_fn=lambda: (load[0], 100), largest_bucket=100, clock=clock)
    return ctrl, ov, load


def _trajectory(steps, **over):
    """Drive both packages' executor + controller through `steps` (t,
    pressure, load, action) under a fake clock; the controller snapshots
    and executor states after each step, per package."""
    traces = []
    for el, cfg_cls in BOTH:
        clk = [0.0]
        ex, _ = _fake_elastic(el, clock=lambda: clk[0])
        ctrl, ov, load = _controller(el, cfg_cls, ex, lambda: clk[0], **over)
        held = []
        trace = []
        for t, pressure, qload, action in steps:
            if action == "dispatch":
                ex(object(), {"x": np.zeros((2, 1), np.float32)})
                held.append(ex.take_issue_token())
            elif action == "complete":
                ex.note_complete(held.pop())
            clk[0] = t
            ov.pressure = pressure
            load[0] = qload
            ctrl.maybe_tick()
            trace.append((ex.current_split, ctrl.snapshot(), ex.drain_pending))
        traces.append((trace, ex, ctrl))
    assert traces[0][0] == traces[1][0]
    return traces[0][1], traces[0][2]


def test_controller_pressure_up_then_recovery_down():
    steps = [(1.1, "brownout", 0, None), (2.2, "brownout", 0, None),
             (5.5, "brownout", 0, None)]
    steps += [(t, "nominal", 0, None) for t in (6.6, 7.7, 8.8, 9.9)]
    steps += [(11.0, "nominal", 0, None)]
    ex, ctrl = _trajectory(steps)
    assert ex.current_split == (4, 2)
    assert ex.switches_up == 1 and ex.switches_down == 1
    assert ctrl.holds_dwell >= 2


def test_controller_load_ewma_drives_up_without_pressure():
    ex, ctrl = _trajectory([(t, "nominal", 95, None) for t in (1.1, 2.2, 3.3, 4.4, 5.6)])
    assert ex.current_split == (8, 1)
    assert ctrl.snapshot()["load_ewma"] > 0.75


def test_controller_hysteresis_band_never_switches():
    ex, ctrl = _trajectory([(1.1 * (i + 1), "nominal", 50, None) for i in range(20)])
    assert ex.current_split == (4, 2)
    assert ex.switches_up == 0 and ex.switches_down == 0
    snap = ctrl.snapshot()
    assert snap["up_streak"] == 0 and snap["down_streak"] == 0


def test_controller_holds_while_drain_pending():
    steps = [(1.1, "shed", 0, "dispatch"), (2.2, "shed", 0, None)]
    steps += [(t, "nominal", 0, None) for t in (3.3, 4.4, 5.5)]
    steps += [(6.6, "nominal", 0, "complete")]
    ex, ctrl = _trajectory(steps, dwell_s=0.5)
    assert ctrl.holds_drain >= 1
    assert ex.current_split == (4, 2)


# ------------------------------------------------- batcher integration


def test_batcher_switches_bit_identical_and_drained():
    """Scores through every split of the ladder: each split's the bits of
    its per-shard reference, all bit-identical to one another; every
    registration closed and every split served."""
    sv = _servable()
    ex = ElasticMeshExecutor(splits=["8x1", "4x2", "2x4"], initial=(4, 2), devices=CPU8)
    b = DynamicBatcher(buckets=(10, 50), max_wait_us=100, device="cpu", run_fn=ex).start()
    try:
        b.warmup(sv)
        payloads = [_arrays(7, 1), _arrays(33, 2), _arrays(50, 3)]

        def score_all():
            return [b.submit(sv, dict(p), output_keys=("prediction_node",)).result(timeout=60)
                    ["prediction_node"] for p in payloads]

        ref = score_all()
        for target in ((8, 1), (2, 4), (4, 2)):
            assert ex.switch_split(target, reason="test")
            got = score_all()
            for p, g, r in zip(payloads, got, ref):
                bucket = 10 if p["feat_ids"].shape[0] <= 10 else 50
                np.testing.assert_array_equal(g, _shard_golden(sv, p, target[0], bucket))
                np.testing.assert_array_equal(g, r)
        snap = ex.elastic_snapshot()
        assert all(blk["in_flight"] == 0 for blk in snap["per_split"].values())
        assert snap["switches_up"] + snap["switches_down"] == 3
        assert all(blk["batches"] > 0 for blk in snap["per_split"].values())
    finally:
        b.stop()


def test_snapshot_counters_aggregate_across_rungs():
    """The dts_tpu_mesh_*_total families are process-lifetime counters: a
    switch never makes them fall back to the new rung's count."""
    sv = _servable()
    ex = ElasticMeshExecutor(splits=["8x1", "4x2"], initial=(4, 2), devices=CPU8)
    b = DynamicBatcher(buckets=(10,), max_wait_us=100, device="cpu", run_fn=ex).start()
    try:
        b.warmup(sv)
        for _ in range(3):
            b.submit(sv, _arrays(7, 1)).result(timeout=60)
        before = ex.snapshot()["executor"]
        assert ex.switch_split((8, 1), reason="test")
        b.submit(sv, _arrays(7, 2)).result(timeout=60)
        after = ex.snapshot()["executor"]
        assert after["batches"] > before["batches"]
        live = sum(blk["batches"] for blk in ex.elastic_snapshot()["per_split"].values())
        # Warmup batches count in the executor totals, not in the per-split
        # serve counters (they mint no tokens).
        assert after["batches"] >= live
        assert after["layout"].get("DCN") == "rules:dcn_v2"
    finally:
        b.stop()


def test_warmup_warms_every_split():
    sv = _servable()
    ex = ElasticMeshExecutor(splits=["8x1", "4x2"], initial=(8, 1), devices=CPU8)
    b = DynamicBatcher(buckets=(10,), max_wait_us=100, device="cpu", run_fn=ex).start()
    try:
        b.warmup(sv)
        for split in ((8, 1), (4, 2)):
            sub = ex._executors[split]
            assert len(sub._placed) == 1, split
            assert sub.batches > 0, split
        snap = ex.elastic_snapshot()
        assert all(blk["in_flight"] == 0 for blk in snap["per_split"].values())
    finally:
        b.stop()


def test_warmup_via_queue_warms_every_split():
    """A hot load warms through the queue (the current split), then the rest
    of the ladder directly."""
    sv = _servable()
    ex = ElasticMeshExecutor(splits=["8x1", "4x2"], initial=(8, 1), devices=CPU8)
    b = DynamicBatcher(buckets=(10,), max_wait_us=100, device="cpu", run_fn=ex).start()
    try:
        b.warmup_via_queue(sv)
        for split in ((8, 1), (4, 2)):
            assert len(ex._executors[split]._placed) == 1, split
        snap = ex.elastic_snapshot()
        assert all(blk["in_flight"] == 0 for blk in snap["per_split"].values())
    finally:
        b.stop()


@pytest.mark.parametrize("site", ["readback", "batcher.dispatch"])
def test_completer_failure_still_closes_token(site):
    """A failure on the readback (the completion worker) or before the
    dispatch releases the per-split registration, or the drain barrier
    would never open."""
    ex, _ = _fake_elastic()
    b = DynamicBatcher(buckets=(4,), max_wait_us=100, device="cpu", run_fn=ex).start()
    try:
        faults.get().add(site, kind="error", code="INTERNAL", count=1)
        fut = b.submit(_servable(), _arrays(2, 0))
        with pytest.raises(Exception):
            fut.result(timeout=30)
        snap = ex.elastic_snapshot()
        assert all(blk["in_flight"] == 0 for blk in snap["per_split"].values())
        assert ex.take_issue_token() is None
    finally:
        faults.reset()
        b.stop()


# ------------------------------------------------------ build_stack wiring


def _server_cfg(**over):
    return ServerConfig(model_kind="dcn_v2", model_name="DCN", num_fields=8, buckets=(10, 50),
                        max_wait_us=100, warmup=True, **over)


def test_build_stack_elastic_requires_mesh():
    with pytest.raises(ValueError, match="requires \\[mesh\\]") as ours:
        build_stack(_server_cfg(), CFG, "cpu", elastic_config=ElasticConfig(enabled=True))
    with pytest.raises(ValueError, match="requires \\[mesh\\]") as theirs:
        jax_build_stack(jax_config.ServerConfig(model_kind="dcn_v2", num_fields=8,
                                                buckets=(10, 50), warmup=False),
                        model_config=JaxConfig(**KW),
                        elastic_config=jax_config.ElasticConfig(enabled=True))
    assert str(ours.value) == str(theirs.value)


def test_build_stack_elastic_full_wiring():
    from distributed_tf_serving_tpu_torch.serving import overload as overload_mod

    impl, b, sv = build_stack(
        _server_cfg(), CFG, "cpu",
        mesh_config=MeshConfig(enabled=True, devices=8, model_parallel=2),
        elastic_config=ElasticConfig(enabled=True, tick_interval_s=0.05, dwell_s=0.1),
        overload_config=OverloadConfig(enabled=True), mesh_device_list=CPU8)
    try:
        assert impl.elastic is not None
        assert impl.elastic.executor.splits == [(8, 1), (4, 2)]
        assert impl.mesh_executor.mesh.shape == {"data": 4, "model": 2}
        assert impl.elastic.overload is b.overload and b.run_fn is impl.elastic.executor
        # Warmup on the CPU takes less than a tick interval: wait one, so
        # the dispatch below ticks the controller.
        time.sleep(0.06)
        r = b.submit(sv, _arrays(7, 1), output_keys=("prediction_node",)).result(timeout=60)
        assert np.asarray(r["prediction_node"]).shape == (7,)
        es = impl.elastic_stats()
        assert es["current_split"] == "4x2"
        assert es["controller"]["ticks"] >= 1
        assert impl.mesh_stats()["elastic"]["current_split"] == "4x2"
    finally:
        b.stop()
        overload_mod.deactivate()


def test_build_stack_elastic_off_is_static_mesh():
    impl, b, _sv = build_stack(
        _server_cfg(), CFG, "cpu",
        mesh_config=MeshConfig(enabled=True, devices=8, model_parallel=2),
        elastic_config=ElasticConfig(enabled=False), mesh_device_list=CPU8)
    try:
        assert impl.elastic is None
        assert impl.elastic_stats() is None
        assert "elastic" not in (impl.mesh_stats() or {})
    finally:
        b.stop()


def test_elastic_toml_parsing(tmp_path):
    cfg_file = tmp_path / "cfg.toml"
    cfg_file.write_text(
        "[server]\nmodel_kind = \"dcn_v2\"\n\n[mesh]\nenabled = true\ndevices = 8\n"
        "model_parallel = 2\n\n[elastic]\nenabled = true\nsplits = [\"8x1\", \"4x2\", \"2x4\"]\n"
        "dwell_s = 2.5\nup_after_ticks = 3\n")
    el = load_config(cfg_file)["elastic"]
    assert el.enabled and el.splits == ("8x1", "4x2", "2x4")
    assert el.dwell_s == 2.5 and el.up_after_ticks == 3
    assert el == ElasticConfig(**vars(jax_config.load_config(cfg_file)["elastic"]))
    cfg_file.write_text("[server]\nmodel_kind = 'dcn_v2'\n")
    assert load_config(cfg_file)["elastic"].enabled is False


# --------------------------------------------- [recovery] x [mesh] compose


def test_per_chip_recovery_refused_over_mesh():
    with pytest.raises(ValueError, match="per_chip") as ours:
        build_stack(_server_cfg(), CFG, "cpu", mesh_config=MeshConfig(enabled=True, devices=8),
                    recovery_config=RecoveryConfig(enabled=True, scope="per_chip"),
                    mesh_device_list=CPU8)
    with pytest.raises(ValueError, match="per_chip") as theirs:
        jax_build_stack(jax_config.ServerConfig(model_kind="dcn_v2", num_fields=8,
                                                buckets=(10, 50), warmup=False),
                        model_config=JaxConfig(**KW),
                        mesh_config=jax_config.MeshConfig(enabled=True, devices=8),
                        recovery_config=jax_config.RecoveryConfig(enabled=True,
                                                                  scope="per_chip"))
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="scope"):
        RecoveryConfig(scope="per_host")


def test_recovery_composes_with_mesh_whole_unit():
    """A device-fatal batch failure over the elastic mesh quarantines the
    whole executor, REINIT clears its placed params (clear_for_recovery),
    and the replay answers the captured request with the same bits."""
    impl, b, sv = build_stack(
        _server_cfg(), CFG, "cpu",
        mesh_config=MeshConfig(enabled=True, devices=8, model_parallel=2),
        elastic_config=ElasticConfig(enabled=True, tick_interval_s=0.05, dwell_s=0.1),
        recovery_config=RecoveryConfig(enabled=True, watchdog_interval_s=0.1),
        mesh_device_list=CPU8)
    rec = impl.recovery
    try:
        arrays = _arrays(7, 11)
        keys = ("prediction_node",)
        ref = b.submit(sv, dict(arrays), output_keys=keys).result(timeout=60)["prediction_node"]
        cleared = []
        orig = impl.mesh_executor.clear_for_recovery
        impl.mesh_executor.clear_for_recovery = lambda: (cleared.append(1), orig())[1]
        faults.get().add("device_lost", kind="error", code="UNAVAILABLE", count=1)
        fut = b.submit(sv, dict(arrays), output_keys=keys)
        deadline = time.time() + 90
        while not fut.done() and time.time() < deadline:
            rec.check()
            if rec.cycle_active():
                rec.run_cycle("test")
            time.sleep(0.05)
        got = fut.result(timeout=60)["prediction_node"]
        np.testing.assert_array_equal(ref, got)
        assert cleared
        es = impl.elastic_stats()
        assert all(blk["in_flight"] == 0 for blk in es["per_split"].values())
        # Every rung was placed again by the re-warm.
        assert all(len(sub._placed) == 1 for sub in impl.mesh_executor._executors.values())
    finally:
        faults.reset()
        b.stop()


def test_sharded_executor_clear_for_recovery():
    sv = _servable()
    ex = ShardedExecutor(make_mesh(8, model_parallel=2, devices=CPU8))
    arrays = _arrays(8, 0)
    arrays["feat_ids"] = fold_ids_host(arrays["feat_ids"], 1024)
    first = ex(sv, arrays)["prediction_node"]
    assert len(ex._placed) == 1
    ex.clear_for_recovery()
    assert len(ex._placed) == 0 and len(ex._entries) == 0
    again = ex(sv, arrays)["prediction_node"]  # placed afresh
    assert torch.equal(first, again)


# ---------------------------------------------------------------- surfaces


def test_meshz_route_and_elastic_sections():
    """GET /meshz serves the mesh block with the elastic sub-block;
    /monitoring gains an `elastic` section; Prometheus carries
    dts_tpu_elastic_*; a mesh-less impl answers enabled = false."""
    aiohttp = pytest.importorskip("aiohttp")

    from distributed_tf_serving_tpu_torch.models import ServableRegistry
    from distributed_tf_serving_tpu_torch.serving.rest import start_rest_gateway
    from distributed_tf_serving_tpu_torch.serving.service import PredictionServiceImpl

    sv = _servable()
    registry = ServableRegistry()
    registry.load(sv)
    ex = ElasticMeshExecutor(splits=["8x1", "4x2"], initial=(4, 2), devices=CPU8)
    b = DynamicBatcher(buckets=(10,), max_wait_us=100, device="cpu", run_fn=ex).start()
    impl = PredictionServiceImpl(registry, b)
    impl.mesh_executor = ex
    ctrl, _ov, _load = _controller(port_elastic, ElasticConfig, ex, time.monotonic)
    impl.elastic = ctrl

    async def go():
        runner, port = await start_rest_gateway(impl, port=0)
        try:
            async with aiohttp.ClientSession(f"http://127.0.0.1:{port}") as s:
                async with s.get("/meshz") as r:
                    body = await r.json()
                    assert r.status == 200 and body["enabled"] is True
                    assert body["elastic"]["current_split"] == "4x2"
                    assert body["elastic"]["splits"] == ["8x1", "4x2"]
                async with s.get("/monitoring?section=elastic") as r:
                    sec = await r.json()
                    assert set(sec) == {"elastic"}
                    assert sec["elastic"]["current_split"] == "4x2"
                async with s.get("/monitoring") as r:
                    snap = await r.json()
                    assert "elastic" in snap and "mesh" in snap
                async with s.get("/monitoring/prometheus/metrics") as r:
                    text = await r.text()
                assert "dts_tpu_elastic_model_parallel 2" in text
                assert 'dts_tpu_elastic_split_batches_total{split="8x1"}' in text
                impl.mesh_executor = None
                impl.elastic = None
                async with s.get("/meshz") as r:
                    assert (await r.json()) == {"enabled": False}
                async with s.get("/monitoring") as r:
                    assert "elastic" not in await r.json()
        finally:
            await runner.cleanup()

    try:
        asyncio.run(go())
    finally:
        b.stop()


def test_elastic_prometheus_series_and_lint():
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                    "tools"))
    from check_prom import lint_text

    texts = []
    for el, cfg_cls in BOTH:
        clk = [0.0]
        ex, _ = _fake_elastic(el, clock=lambda: clk[0])
        ctrl, ov, _load = _controller(el, cfg_cls, ex, lambda: clk[0])
        ex(object(), {"x": np.zeros((3, 1), np.float32)})
        ex.note_complete(ex.take_issue_token())
        clk[0] = 6.0
        ov.pressure = "shed"
        ctrl.maybe_tick()
        clk[0] = 7.1
        ctrl.maybe_tick()  # up-switch
        texts.append(_drop_times(ex.elastic_snapshot()))
    assert texts[0] == texts[1]
    text = ServerMetrics().prometheus_text(None, elastic=texts[0])
    assert lint_text(text) == []
    for marker in (
        "dts_tpu_elastic_data_parallel 8",
        "dts_tpu_elastic_model_parallel 1",
        'dts_tpu_elastic_switches_total{direction="up"} 1',
        'dts_tpu_elastic_switches_total{direction="down"} 0',
        'dts_tpu_elastic_split_batches_total{split="4x2"} 1',
        "dts_tpu_elastic_controller_ticks_total",
        'dts_tpu_elastic_holds_total{reason="dwell"}',
        "dts_tpu_elastic_load_ewma",
    ):
        assert marker in text, marker
    samples = lambda t: [ln for ln in t.splitlines()  # noqa: E731
                         if ln.startswith("dts_tpu_elastic_")]
    assert samples(text) == samples(JaxMetrics().prometheus_text(None, elastic=texts[0]))
