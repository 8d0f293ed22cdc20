"""The batcher's failure paths and pipeline knobs in the port on the CPU,
the counterparts of the JAX package's tests/test_batcher.py (the wedge
circuit breaker, warmup's exemption) and tests/test_streaming.py (the
in-flight window, the pad buffer ring, the encode arena): a stuck batch,
driven by a `wedge` rule of faults.py, opens the breaker — new work fails
fast with UNAVAILABLE, the backlog is shed, the breaker closes once the
batch completes — warmup does not trip it, the window bounds issuance, and
recycled buffers and arenas change no byte of an answer."""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from distributed_tf_serving_tpu import codec as jax_codec
from distributed_tf_serving_tpu.models import ModelConfig as JaxConfig
from distributed_tf_serving_tpu.models import build_model as jax_build
from distributed_tf_serving_tpu.serving import example_codec as jax_example_codec
from distributed_tf_serving_tpu_torch import codec, faults
from distributed_tf_serving_tpu_torch.convert import params_from_jax
from distributed_tf_serving_tpu_torch.models import (
    ModelConfig,
    Servable,
    ServableRegistry,
    build_model,
    ctr_signatures,
)
from distributed_tf_serving_tpu_torch.proto import serving_apis_pb2 as apis
from distributed_tf_serving_tpu_torch.serving import DeviceWedgedError
from distributed_tf_serving_tpu_torch.serving.batcher import DynamicBatcher
from distributed_tf_serving_tpu_torch.serving.example_codec import decode_input, make_example
from distributed_tf_serving_tpu_torch.serving.service import PredictionServiceImpl, ServiceError

F = 6
KW = dict(num_fields=F, vocab_size=1 << 12, embed_dim=8, mlp_dims=(16,), num_cross_layers=2,
          compute_dtype="float32")


@pytest.fixture(autouse=True)
def _no_rules():
    faults.reset(0)
    yield
    faults.reset(0)  # releases any wedge a failed test left


@pytest.fixture(scope="module")
def servable():
    jm = jax_build("dcn_v2", JaxConfig(name="DCN", **KW))
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    return Servable(name="DCN", version=1,
                    model=build_model("dcn_v2", ModelConfig(name="DCN", **KW)),
                    params=params_from_jax(jp, "cpu"), signatures=ctr_signatures(F))


def _arrays(n=4, seed=0):
    rng = np.random.RandomState(seed)
    return {"feat_ids": rng.randint(0, 1 << 40, size=(n, F)).astype(np.int64),
            "feat_wts": rng.rand(n, F).astype(np.float32)}


def _reference(servable, arrays):
    with torch.inference_mode():
        batch = {k: torch.from_numpy(v) for k, v in arrays.items()}
        return servable.model.apply(servable.params, batch)["prediction_node"].numpy()


def _until(pred, timeout=10.0):
    end = time.perf_counter() + timeout
    while not pred():
        assert time.perf_counter() < end, "condition not reached"
        time.sleep(0.005)


def _backdate(batcher, site: str) -> None:
    """Move the stuck batch's start back past the threshold instead of
    sleeping it away (the JAX test's method)."""
    with batcher._cv:
        if site == "batcher.dispatch":
            assert batcher._dispatching_since is not None
            batcher._dispatching_since -= batcher.breaker_timeout_s + 1
        else:
            assert len(batcher._inflight_since) == 1
            for k in batcher._inflight_since:
                batcher._inflight_since[k] -= batcher.breaker_timeout_s + 1


def _stuck(batcher, site: str) -> bool:
    with batcher._cv:
        return (batcher._dispatching_since is not None if site == "batcher.dispatch"
                else bool(batcher._inflight_since))


@pytest.mark.parametrize("site", ["batcher.dispatch", "readback"])
def test_wedged_device_circuit_breaker(servable, site):
    """A batch stuck in the device stage (or awaiting its readback) past
    breaker_timeout_s fails NEW requests in under a second, sheds the
    backlog with the same error, and the breaker closes by itself once the
    stuck batch completes."""
    batcher = DynamicBatcher(buckets=(32,), max_wait_us=0, device="cpu",
                             breaker_timeout_s=5.0).start()
    faults.get().add(site, "wedge", count=1)
    try:
        a0, a1, a2, a3 = (_arrays(4, seed=s) for s in range(4))
        stuck = batcher.submit(servable, a0)
        _until(lambda: _stuck(batcher, site))
        # The backlog, before the breaker opens: it queues behind a stuck
        # device stage (a stuck readback holds no later batch).
        queued = batcher.submit(servable, a1) if site == "batcher.dispatch" else None
        _backdate(batcher, site)
        t0 = time.perf_counter()
        with pytest.raises(DeviceWedgedError, match="stuck"):
            batcher.submit(servable, a2)
        assert time.perf_counter() - t0 < 1.0  # fail fast, no deadline burnt
        if queued is not None:
            with pytest.raises(DeviceWedgedError):
                queued.result(timeout=1)  # the backlog is shed with it
        faults.get().clear()  # the device un-wedges
        np.testing.assert_array_equal(stuck.result(timeout=30)["prediction_node"],
                                      _reference(servable, _padded(a0, 32))[:4])
        # The breaker closed by itself: new work flows again.
        ok = batcher.submit(servable, a3).result(timeout=30)["prediction_node"]
        np.testing.assert_allclose(ok, _reference(servable, a3), rtol=0, atol=1e-6)
        assert batcher._wedged_for(time.perf_counter()) == 0.0
        assert batcher.drain(5)
    finally:
        faults.get().clear()
        batcher.stop()


def _padded(arrays, bucket):
    return {k: np.concatenate([v, np.zeros((bucket - v.shape[0],) + v.shape[1:], v.dtype)])
            for k, v in arrays.items()}


def test_the_breaker_turns_callers_away_unavailable(servable):
    """Through the service: UNAVAILABLE in under a second while the stuck
    batch holds, instead of the 120 s cap; the stuck request then answers."""
    registry = ServableRegistry()
    registry.load(servable)
    batcher = DynamicBatcher(buckets=(32,), max_wait_us=0, device="cpu",
                             breaker_timeout_s=5.0).start()
    impl = PredictionServiceImpl(registry, batcher)
    faults.get().add("batcher.dispatch", "wedge", count=1)

    def request(seed):
        req = apis.PredictRequest()
        req.model_spec.name = "DCN"
        for k, v in _arrays(3, seed).items():
            codec.from_ndarray(v, out=req.inputs[k])
        return req

    answers = {}
    t = threading.Thread(target=lambda: answers.setdefault("stuck", impl.predict(request(0))))
    try:
        t.start()
        _until(lambda: _stuck(batcher, "batcher.dispatch"))
        _backdate(batcher, "batcher.dispatch")
        t0 = time.perf_counter()
        with pytest.raises(ServiceError) as e:
            impl.predict(request(1))
        assert e.value.code == "UNAVAILABLE" and time.perf_counter() - t0 < 1.0
        faults.get().clear()
        t.join(30)
        assert answers["stuck"].outputs["prediction_node"].tensor_shape.dim[0].size == 3
        impl.predict(request(2))
    finally:
        faults.get().clear()
        t.join(30)
        batcher.stop()


def test_breaker_off_never_trips(servable):
    batcher = DynamicBatcher(buckets=(32,), max_wait_us=0, device="cpu",
                             breaker_timeout_s=None).start()
    faults.get().add("batcher.dispatch", "wedge", count=1)
    try:
        stuck = batcher.submit(servable, _arrays(4))
        _until(lambda: _stuck(batcher, "batcher.dispatch"))
        with batcher._cv:
            batcher._dispatching_since -= 1e6
            assert batcher._wedged_for(time.perf_counter()) == 0.0
        queued = batcher.submit(servable, _arrays(4, seed=1))  # accepted
        faults.get().clear()
        stuck.result(timeout=30)
        queued.result(timeout=30)
    finally:
        faults.get().clear()
        batcher.stop()


def test_warmup_does_not_trip_the_breaker(servable):
    """An all-warmup group (warmup_via_queue) stuck past the threshold
    starts no wedge clock: a live submit meanwhile is accepted. The same
    delay on a live group opens the breaker (the control)."""
    batcher = DynamicBatcher(buckets=(8, 32), max_wait_us=0, device="cpu",
                             breaker_timeout_s=0.3).start()
    try:
        faults.get().add("batcher.dispatch", "delay", delay_s=3.0, count=1)
        t = threading.Thread(target=lambda: batcher.warmup_via_queue(servable, buckets=(8, 32)),
                             daemon=True)
        t.start()
        _until(lambda: faults.get().fires.get("batcher.dispatch"))
        time.sleep(0.6)  # inside the slow warmup dispatch, past the threshold
        with batcher._cv:
            assert batcher._dispatching and batcher._dispatching_since is None
        fut = batcher.submit(servable, _arrays(4))  # accepted, not DeviceWedged
        assert fut.result(timeout=30)["prediction_node"].shape == (4,)
        t.join(timeout=30)
        assert not t.is_alive()

        faults.get().add("batcher.dispatch", "delay", delay_s=3.0, count=1)
        slow = batcher.submit(servable, _arrays(4, seed=1))
        _until(lambda: batcher._wedged_for(time.perf_counter()) > 0)
        with pytest.raises(DeviceWedgedError):
            batcher.submit(servable, _arrays(4, seed=2))
        assert slow.result(timeout=30)["prediction_node"].shape == (4,)
    finally:
        faults.get().clear()
        batcher.stop()


def test_stage_wait_escapes_a_wedged_dispatch_thread(servable):
    """At pipeline_depth 1 the batching thread waits for the device stage
    before staging the next group; once the breaker opens it stops waiting,
    so the groups behind the wedge are staged and a submit sheds them all."""
    batcher = DynamicBatcher(buckets=(32,), max_wait_us=0, device="cpu",
                             pipeline_depth=1, breaker_timeout_s=5.0).start()
    faults.get().add("batcher.dispatch", "wedge", count=1)
    try:
        stuck = batcher.submit(servable, _arrays(4))
        _until(lambda: _stuck(batcher, "batcher.dispatch"))
        behind = [batcher.submit(servable, _arrays(4, seed=s), _solo=True) for s in (1, 2, 3)]
        _backdate(batcher, "batcher.dispatch")
        _until(lambda: not batcher._items and not batcher._collecting)  # all staged
        with batcher._cv:
            assert len(batcher._staged) == 3 and batcher._dispatch_pending == 4
        with pytest.raises(DeviceWedgedError):
            batcher.submit(servable, _arrays(4, seed=4))
        for f in behind:
            with pytest.raises(DeviceWedgedError):
                f.result(timeout=1)
        with batcher._cv:
            assert not batcher._staged and batcher._dispatch_pending == 1
        faults.get().clear()
        stuck.result(timeout=30)
        assert batcher.drain(5)
    finally:
        faults.get().clear()
        batcher.stop()


def test_inflight_window_bounds_issuance(servable):
    """inflight_window = 1: with batch 1's readback held open, batch 2 is
    not issued (the peak stays 1, a window wait is counted); releasing the
    readback lets the pipeline drain."""
    batcher = DynamicBatcher(buckets=(32,), max_wait_us=0, device="cpu",
                             pipeline_depth=2, inflight_window=1).start()
    faults.get().add("readback", "wedge", count=1)
    try:
        futs = [batcher.submit(servable, _arrays(8, seed=s), _solo=True) for s in range(3)]
        _until(lambda: batcher.stats.inflight_window_waits)
        with batcher._cv:
            assert len(batcher._inflight_since) <= 1
        assert batcher.stats.batches == 1  # batch 2 waits at the window
        faults.get().clear()
        for s, f in enumerate(futs):
            np.testing.assert_allclose(f.result(timeout=30)["prediction_node"],
                                       _reference(servable, _arrays(8, seed=s)),
                                       rtol=0, atol=1e-6)
        stats = batcher.pipeline_stats()
        assert stats["inflight_peak"] == 1 and stats["in_flight"] == 0
        assert stats["inflight_window"] == 1 and stats["inflight_window_waits"] >= 1
        assert batcher._completers._max_workers == 4
    finally:
        faults.get().clear()
        batcher.stop()


def test_window_sizes_the_completion_pool_and_warmup_skips_it(servable):
    batcher = DynamicBatcher(buckets=(8, 32), max_wait_us=0, device="cpu",
                             completion_workers=2, inflight_window=6).start()
    try:
        assert batcher._completers._max_workers == 6
        batcher.warmup_via_queue(servable)
        assert batcher.stats.inflight_window_waits == 0 and batcher.stats.inflight_peak == 0
    finally:
        batcher.stop()


def test_buffer_ring_reuses_and_stays_correct(servable):
    """Recycled pad buffers change no bit of a score: sequential distinct
    payloads, and coalesced groups of mixed id dtypes, score exactly as on
    a ring-off batcher while the ring reports reuse."""
    ring = DynamicBatcher(buckets=(32, 64), max_wait_us=0, device="cpu", buffer_ring=True).start()
    plain = DynamicBatcher(buckets=(32, 64), max_wait_us=0, device="cpu").start()
    try:
        assert ring._fused_ctx(servable, [_arrays()]) is None  # the batch.pad path
        for s in range(6):
            arrays = _arrays(20, seed=100 + s)
            got = ring.submit(servable, arrays).result(timeout=30)["prediction_node"]
            want = plain.submit(servable, arrays).result(timeout=30)["prediction_node"]
            np.testing.assert_array_equal(got, want)
            np.testing.assert_allclose(got, _reference(servable, arrays), rtol=0, atol=1e-6)
        snap = ring.pipeline_stats()["buffer_ring"]
        assert snap["reuses"] > 0
        assert snap["allocs"] <= 4  # 2 inputs x <= 2 bucket geometries
        assert ring.buffer_ring.per_key == 8  # max(window, 4) + 4
        assert "buffer_ring" not in plain.pipeline_stats()
        # A coalesced group whose ids mix int32 and int64 pads into the
        # promoted dtype, as np.concatenate does.
        a = _arrays(5, seed=1)
        b = _arrays(7, seed=2)
        b["feat_ids"] = (b["feat_ids"] % KW["vocab_size"]).astype(np.int32)
        for bat in (ring, plain):
            bat.max_wait_s = 0.2
        got = [ring.submit(servable, x) for x in (a, b)]
        want = [plain.submit(servable, x) for x in (a, b)]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.result(timeout=30)["prediction_node"],
                                          w.result(timeout=30)["prediction_node"])
    finally:
        ring.stop()
        plain.stop()


def test_buffer_ring_returns_buffers_on_a_failure_before_the_device_stage(servable):
    batcher = DynamicBatcher(buckets=(32,), max_wait_us=0, device="cpu", buffer_ring=True).start()
    faults.get().add("batcher.dispatch", "error", code="INTERNAL", count=1)
    try:
        with pytest.raises(faults.InjectedFaultError):
            batcher.submit(servable, _arrays(4)).result(timeout=30)
        assert batcher.buffer_ring.snapshot()["free_buffers"] == 2
        batcher.submit(servable, _arrays(4, seed=1)).result(timeout=30)
        assert batcher.buffer_ring.snapshot()["reuses"] == 2
    finally:
        batcher.stop()


# --------------------------------------------------------- the encode arena


def test_encode_arena_reuse_and_growth_match_jax():
    ours, theirs = codec.EncodeArena(), jax_codec.EncodeArena()
    for shape, dtype in [((4, 8), np.float32), ((4, 8), np.float32), ((100, 43), np.int64),
                         ((50, 43), np.int64), ((300, 43), np.int64), ((2,), np.float32),
                         ((5000,), np.float32)]:
        a, b = ours.ndarray(shape, dtype), theirs.ndarray(shape, dtype)
        assert a.shape == b.shape == shape and a.dtype == b.dtype
        assert a.flags.writeable
    assert (ours.grows, ours.reuses) == (theirs.grows, theirs.reuses)
    assert ours.grows == 4 and ours.reuses == 3
    # Scratch of one dtype is one backing buffer, reused in place.
    x = ours.ndarray((10,), np.float32)
    x[:] = 7.0
    assert ours.ndarray((10,), np.float32)[0] == 7.0


@pytest.mark.parametrize("dtype", [np.float32, np.int64, np.int32, np.float16])
@pytest.mark.parametrize("tensor_content", [True, False])
def test_arena_encodes_are_byte_identical_to_fresh_ones(dtype, tensor_content):
    rng = np.random.RandomState(0)
    arena = codec.EncodeArena()
    for rows in (64, 9, 200):
        strided = (rng.rand(rows, 8) * 100).astype(dtype)[::2, 1::2]  # not contiguous
        fresh = codec.from_ndarray(strided, use_tensor_content=tensor_content)
        via = codec.from_ndarray(strided, use_tensor_content=tensor_content, arena=arena)
        theirs = jax_codec.from_ndarray(strided, use_tensor_content=tensor_content)
        assert fresh.SerializeToString() == via.SerializeToString() == \
            theirs.SerializeToString()
    assert arena.reuses > 0
    half = rng.rand(33).astype(np.float16)
    np.testing.assert_array_equal(arena.widen_f32(half), half.astype(np.float32))


def test_example_decode_arena_matches_fresh_and_jax():
    arena = codec.EncodeArena()
    inp = apis.Input()
    for i in range(3):
        inp.example_list.examples.append(
            make_example(range(i, i + F), [0.5 * i] * F if i != 1 else None))
    plain = decode_input(inp, F)
    for _ in range(2):
        via = decode_input(inp, F, arena=arena)
        for k in ("feat_ids", "feat_wts"):
            np.testing.assert_array_equal(via[k], plain[k])
    assert arena.grows == 2 and arena.reuses == 2  # the same geometry reused
    from distributed_tf_serving_tpu.proto import serving_apis_pb2 as japis

    theirs = jax_example_codec.decode_input(japis.Input.FromString(inp.SerializeToString()), F)
    for k in ("feat_ids", "feat_wts"):
        np.testing.assert_array_equal(plain[k], theirs[k])


def test_stream_arena_mode_identical_chunks(servable):
    """response_arena: the arena's encodes and the one reused chunk message
    serialize chunk for chunk the bytes of the allocate-per-chunk stream
    (`final` rides whichever chunk completes last: compared apart)."""
    registry = ServableRegistry()
    registry.load(servable)
    # One bucket: the sub-batches and the unary batch run the same shape,
    # so the unary answer's slices are the chunks' bits.
    batcher = DynamicBatcher(buckets=(64,), max_wait_us=0, device="cpu").start()
    impl = PredictionServiceImpl(registry, batcher)
    try:
        impl.stream_chunk_candidates = 16
        req = apis.PredictRequest()
        req.model_spec.name = "DCN"
        for k, v in _arrays(60, seed=11).items():
            codec.from_ndarray(v, out=req.inputs[k])
        req.output_filter.append("prediction_node")

        def by_offset(stream):
            chunks, finals = {}, 0
            for c in stream:
                finals += bool(c.final)
                c.final = False
                chunks[c.offset] = c.SerializeToString()
            return chunks, finals

        plain, finals_plain = by_offset(impl.predict_stream(req))
        impl.response_arena = True
        arena, finals_arena = by_offset(impl.predict_stream(req))
        assert finals_plain == finals_arena == 1
        assert len(plain) == 4 and plain == arena
        unary = impl.predict(req)  # through the same arena
        whole = codec.to_ndarray(unary.outputs["prediction_node"])
        for off, data in arena.items():
            c = apis.PredictStreamChunk.FromString(data)
            np.testing.assert_array_equal(codec.to_ndarray(c.outputs["prediction_node"]),
                                          whole[off:off + c.count])
    finally:
        batcher.stop()
