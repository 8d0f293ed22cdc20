"""The cache plane of the port (distributed_tf_serving_tpu_torch/cache/, the
batcher's score cache with single-flight and dedup, /cachez, [cache]) on
the CPU, held to the JAX package's in the same process: the digests and
the native hash128 / hash128_rows byte for byte (with and without the
native host ops), the stores' LRU / TTL / byte bounds / generations and
their snapshots under one fake clock, single-flight through the batcher
(a leader held by a `wedge` rule of faults.py), a failing leader, a leader
ended by its deadline, a store detached mid-flight, dedup against the
cache-off batcher and the JAX one, the version watcher's hook, the REST
surface and the config section. Scores agree with the JAX package's within
1e-5 (f32); counters are equal."""

import asyncio
import dataclasses
import hashlib
import threading
import time
from concurrent.futures import Future

import jax
import numpy as np
import pytest

from distributed_tf_serving_tpu import native as jax_native
from distributed_tf_serving_tpu.cache import RowScoreCache as JaxRowScoreCache
from distributed_tf_serving_tpu.cache import ScoreCache as JaxScoreCache
from distributed_tf_serving_tpu.cache import canonical_rows as jax_canonical_rows
from distributed_tf_serving_tpu.cache import collapse_rows as jax_collapse_rows
from distributed_tf_serving_tpu.cache import features_digest as jax_features_digest
from distributed_tf_serving_tpu.cache.row_cache import digest_rows as jax_digest_rows
from distributed_tf_serving_tpu.cache.row_cache import row_structure_header as jax_header
from distributed_tf_serving_tpu.models import ModelConfig as JaxConfig
from distributed_tf_serving_tpu.models import Servable as JaxServable
from distributed_tf_serving_tpu.models import ServableRegistry as JaxRegistry
from distributed_tf_serving_tpu.models import build_model as jax_build
from distributed_tf_serving_tpu.models import ctr_signatures as jax_signatures
from distributed_tf_serving_tpu.serving import DynamicBatcher as JaxBatcher
from distributed_tf_serving_tpu.serving import PredictionServiceImpl as JaxImpl
from distributed_tf_serving_tpu.utils import config as jax_config
from distributed_tf_serving_tpu_torch import codec, faults, native
from distributed_tf_serving_tpu_torch.cache import (
    CoalescedLeaderCancelled,
    RowScoreCache,
    ScoreCache,
    canonical_rows,
    collapse_rows,
    features_digest,
)
from distributed_tf_serving_tpu_torch.cache.row_cache import digest_rows, row_structure_header
from distributed_tf_serving_tpu_torch.convert import params_from_jax
from distributed_tf_serving_tpu_torch.models import (
    ModelConfig,
    Servable,
    ServableRegistry,
    build_model,
    ctr_signatures,
)
from distributed_tf_serving_tpu_torch.serving.batcher import DynamicBatcher
from distributed_tf_serving_tpu_torch.serving.service import PredictionServiceImpl
from distributed_tf_serving_tpu_torch.utils.config import CacheConfig, ServerConfig, load_config

F = 6
KW = dict(num_fields=F, vocab_size=1 << 10, embed_dim=4, mlp_dims=(8,), num_cross_layers=2,
          compute_dtype="float32")


@pytest.fixture(autouse=True)
def _no_rules():
    faults.reset(0)
    yield
    faults.reset(0)  # releases any wedge a failed test left


@pytest.fixture(scope="module")
def pair():
    # A request's digest is hash128 once the host ops are loaded, blake2b
    # before: load them first, as a server's warmup does, so one test's
    # keys do not change primitive halfway.
    assert native.ensure()
    """(port servable, JAX servable) on the same seed-0 weights."""
    jm = jax_build("dcn_v2", JaxConfig(name="DCN", **KW))
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    jsv = JaxServable(name="DCN", version=1, model=jm, params=jp, signatures=jax_signatures(F))
    sv = Servable(name="DCN", version=1, model=build_model("dcn_v2", ModelConfig(name="DCN", **KW)),
                  params=params_from_jax(jp, "cpu"), signatures=ctr_signatures(F))
    return sv, jsv


@pytest.fixture(scope="module")
def servable(pair):
    return pair[0]


def make_arrays(n, seed=0):
    rng = np.random.RandomState(seed)
    return {"feat_ids": rng.randint(0, 1 << 40, size=(n, F)).astype(np.int64),
            "feat_wts": rng.rand(n, F).astype(np.float32)}


def _score(batcher, sv, arrays, **kw):
    return batcher.submit(sv, arrays, **kw).result(timeout=60)["prediction_node"]


def _until(pred, timeout=10.0):
    end = time.perf_counter() + timeout
    while not pred():
        assert time.perf_counter() < end, "condition not reached"
        time.sleep(0.005)


def _filled(cache, n=1):
    """The leader's fill runs in its future's done-callback, after the
    caller can already see the answer: wait for it to land."""
    _until(lambda: cache.entry_count() >= n)


def _dispatching(batcher) -> bool:
    with batcher._cv:
        return batcher._dispatching_since is not None


# ---------------------------------------------------------------- digests


def test_digest_invariant_across_proto_encodings():
    """Two protobuf encodings of the same features (tensor_content bytes
    and repeated *_val fields) decode to the same digest."""
    arrays = make_arrays(5, seed=3)
    digests = []
    for use_content in (True, False):
        decoded = {}
        for name, arr in arrays.items():
            proto = codec.from_ndarray(arr, use_tensor_content=use_content)
            assert bool(proto.tensor_content) == use_content
            decoded[name] = codec.to_ndarray(proto)
        digests.append(features_digest(decoded))
    assert digests[0] == digests[1]


def test_digest_distinguishes_structure_and_content():
    a = make_arrays(4, seed=0)
    assert features_digest(a) == features_digest({k: v.copy() for k, v in a.items()})
    b = {k: v.copy() for k, v in a.items()}
    b["feat_wts"][2, 1] += 1e-3
    assert features_digest(a) != features_digest(b)
    # The same ids folded to int32 (the compact wire) digest apart.
    compact = {"feat_ids": np.remainder(a["feat_ids"], 1 << 10).astype(np.int32),
               "feat_wts": a["feat_wts"]}
    assert features_digest(a) != features_digest(compact)
    assert features_digest({"x": a["feat_ids"]}) != features_digest({"y": a["feat_ids"]})


@pytest.mark.parametrize("with_native", [True, False], ids=["native", "blake2b"])
def test_digests_equal_the_jax_package_s(monkeypatch, with_native):
    """features_digest, canonical_rows and the row digests give the JAX
    package's bytes, through native.hash128 / hash128_rows when the host
    ops are built and through blake2b when they are not."""
    if with_native:
        assert native.ensure() and jax_native.ensure()
    else:
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(jax_native, "available", lambda: False)
    for n, seed in ((1, 0), (7, 1), (33, 2)):
        a = make_arrays(n, seed)
        assert features_digest(a) == jax_features_digest(a)
        assert features_digest(a, salt=b"s") == jax_features_digest(a, salt=b"s")
        blob = canonical_rows(a)
        np.testing.assert_array_equal(blob, jax_canonical_rows(a))
        header = row_structure_header(a)
        assert header == jax_header(a)
        assert digest_rows(blob, header) == jax_digest_rows(blob, header)
        want = [hashlib.blake2b(header + blob[i].tobytes(), digest_size=16).digest()
                for i in range(n)]
        assert digest_rows(blob, header) == want


@pytest.mark.parametrize("nbytes", [0, 1, 31, 32, 33, 4096 + 5])
def test_hash128_equals_the_jax_native_one(nbytes):
    assert native.ensure() and jax_native.ensure()
    arr = np.random.RandomState(nbytes).randint(0, 256, nbytes).astype(np.uint8)
    assert native.hash128(arr) == jax_native.hash128(arr)
    assert len(native.hash128(arr)) == 16


@pytest.mark.parametrize("header", [b"", b"hdr:int64:(6,);"])
def test_hash128_rows_equals_hashlib_and_the_jax_native_one(header):
    assert native.ensure() and jax_native.ensure()
    blob = np.random.RandomState(1).randint(0, 256, size=(9, 301)).astype(np.uint8)
    got = native.hash128_rows(blob, header)
    np.testing.assert_array_equal(got, jax_native.hash128_rows(blob, header))
    for i in range(blob.shape[0]):
        assert got[i].tobytes() == hashlib.blake2b(header + blob[i].tobytes(),
                                                   digest_size=16).digest()


# ------------------------------------------------------- store semantics


def _key(cache, i, model="DCN", version=1):
    return cache.make_key(model, version, None, {"feat_ids": np.full((2, 2), i, np.int64)})


def _val(n=4):
    return {"prediction_node": np.arange(n, dtype=np.float32)}


def test_lru_entry_eviction():
    cache = ScoreCache(max_entries=4, shards=1)
    keys = [_key(cache, i) for i in range(6)]
    for k in keys:
        assert cache.fill(k, _val())
    assert cache.lookup(keys[0]) is None
    assert cache.lookup(keys[1]) is None
    for k in keys[2:]:
        assert cache.lookup(k) is not None
    snap = cache.snapshot()
    assert snap["evictions"] == 2 and snap["entries"] == 4


def test_lru_recency_protects_hot_entries():
    cache = ScoreCache(max_entries=2, shards=1)
    k0, k1, k2 = (_key(cache, i) for i in range(3))
    cache.fill(k0, _val())
    cache.fill(k1, _val())
    assert cache.lookup(k0) is not None  # k0 is now the most recent
    cache.fill(k2, _val())  # evicts k1
    assert cache.lookup(k0) is not None
    assert cache.lookup(k1) is None


def test_byte_bound_eviction():
    cache = ScoreCache(max_entries=1000, max_bytes=1000, shards=1)  # 400-byte values: 2 fit
    keys = [_key(cache, i) for i in range(3)]
    for k in keys:
        assert cache.fill(k, {"s": np.zeros(100, np.float32)})
    assert cache.entry_count() == 2
    assert cache.lookup(keys[0]) is None
    assert cache.value_bytes() <= 1000
    assert not cache.fill(_key(cache, 9), {"s": np.zeros(1024, np.float32)})


def test_ttl_expiry_with_fake_clock():
    now = [0.0]
    cache = ScoreCache(ttl_s=10.0, clock=lambda: now[0])
    k = _key(cache, 0)
    cache.fill(k, _val())
    now[0] = 9.9
    assert cache.lookup(k) is not None
    now[0] = 10.1
    assert cache.lookup(k) is None
    assert cache.snapshot()["expirations"] == 1 and cache.entry_count() == 0


def test_version_swap_invalidation():
    cache = ScoreCache()
    k1 = cache.make_key("DCN", 1, None, make_arrays(3))
    k_other = cache.make_key("OTHER", 1, None, make_arrays(3))
    cache.fill(k1, _val())
    cache.fill(k_other, _val())
    assert cache.invalidate_model("DCN") == 1
    assert cache.lookup(k1) is None
    assert cache.lookup(k_other) is not None
    assert cache.snapshot()["models"]["DCN"]["invalidations"] == 1


def test_stale_generation_fill_refused():
    cache = ScoreCache()
    handle = cache.begin("DCN", 1, None, make_arrays(2))
    assert handle.leader
    cache.invalidate_model("DCN")
    assert not cache.fill(handle.key, _val(), gen=handle.gen)
    assert cache.entry_count() == 0


def test_flush_all_and_per_model():
    cache = ScoreCache()
    cache.fill(cache.make_key("A", 1, None, make_arrays(2)), _val())
    cache.fill(cache.make_key("B", 1, None, make_arrays(2, seed=1)), _val())
    assert cache.flush("A") == 1 and cache.entry_count() == 1
    assert cache.flush() == 1 and cache.entry_count() == 0


def _store_ops(cls, now):
    """One sequence of store operations (fills, hits, misses, evictions,
    expiry, single-flight, invalidation, flush) on a fake clock."""
    cache = cls(max_entries=8, max_bytes=4096, ttl_s=5.0, shards=2, clock=lambda: now[0])
    for i in range(12):
        cache.fill(cache.make_key("DCN", 1, None, make_arrays(2, seed=i)), _val(i + 1))
    for i in range(12):
        cache.lookup(cache.make_key("DCN", 1, None, make_arrays(2, seed=i)))
    lead = cache.begin("DCN", 1, None, make_arrays(3, seed=99))
    join = cache.begin("DCN", 1, None, make_arrays(3, seed=99))
    fut = Future()
    fut.set_result(_val(3))
    cache.complete(lead, fut)
    assert join.waiter.result(timeout=1) is not None
    cache.begin("DCN", 1, None, make_arrays(3, seed=99))  # a hit
    now[0] = 6.0
    cache.lookup(cache.make_key("DCN", 1, None, make_arrays(2, seed=11)))  # expired
    cache.fill(cache.make_key("OTHER", 2, ("prediction_node",), make_arrays(2, 5)), _val())
    cache.invalidate_model("DCN")
    cache.flush()
    return cache.snapshot()


@pytest.mark.parametrize("which", ["score", "row"])
def test_store_snapshots_equal_the_jax_package_s(which):
    # One digest primitive on both sides (the key's digest picks the shard).
    assert native.ensure() and jax_native.ensure()
    ours, theirs = (ScoreCache, JaxScoreCache) if which == "score" else (
        RowScoreCache, JaxRowScoreCache)
    assert _store_ops(ours, [0.0]) == _store_ops(theirs, [0.0])


# ------------------------------------------------------- single flight


def test_single_flight_via_store_api():
    cache = ScoreCache()
    leader = cache.begin("DCN", 1, None, make_arrays(2))
    assert leader.leader and leader.hit is None
    waiter = cache.begin("DCN", 1, None, make_arrays(2))
    assert waiter.waiter is not None and not waiter.leader
    fut = Future()
    fut.set_result(_val())
    cache.complete(leader, fut)
    np.testing.assert_array_equal(waiter.waiter.result(timeout=1)["prediction_node"],
                                  _val()["prediction_node"])
    assert cache.begin("DCN", 1, None, make_arrays(2)).hit is not None
    assert cache.snapshot()["coalesced"] == 1


def test_single_flight_leader_cancelled_fails_waiters_as_timeout():
    cache = ScoreCache()
    leader = cache.begin("DCN", 1, None, make_arrays(2))
    waiter = cache.begin("DCN", 1, None, make_arrays(2))
    fut = Future()
    fut.cancel()
    cache.complete(leader, fut)
    with pytest.raises(CoalescedLeaderCancelled):
        waiter.waiter.result(timeout=1)
    assert cache.entry_count() == 0


def test_stale_flight_replacement_never_orphans_waiters():
    """A leader whose generation went stale mid-flight resolves its own
    waiters, and the leader that replaced it resolves the new ones."""
    cache = ScoreCache()
    old_leader = cache.begin("DCN", 1, None, make_arrays(2))
    old_waiter = cache.begin("DCN", 1, None, make_arrays(2))
    cache.invalidate_model("DCN")
    new_leader = cache.begin("DCN", 1, None, make_arrays(2))
    assert new_leader.leader
    new_waiter = cache.begin("DCN", 1, None, make_arrays(2))
    f_old = Future()
    f_old.set_result({"s": np.array([1.0], np.float32)})
    cache.complete(old_leader, f_old)
    np.testing.assert_array_equal(old_waiter.waiter.result(timeout=1)["s"], [1.0])
    assert not new_waiter.waiter.done() and cache.entry_count() == 0
    f_new = Future()
    f_new.set_result({"s": np.array([2.0], np.float32)})
    cache.complete(new_leader, f_new)
    np.testing.assert_array_equal(new_waiter.waiter.result(timeout=1)["s"], [2.0])
    assert cache.entry_count() == 1


def test_flush_kills_in_flight_fill_of_unseen_model():
    cache = ScoreCache()
    leader = cache.begin("DCN", 1, None, make_arrays(2))
    assert cache.flush() == 0
    assert not cache.fill(leader.key, _val(), gen=leader.gen)
    assert cache.entry_count() == 0


def test_single_flight_coalesces_concurrent_misses(pair):
    """Six identical submits while the leader's batch is held: one device
    batch, every answer the same bits, within 1e-5 of the JAX batcher's;
    then a seventh is a hit."""
    sv, jsv = pair
    cache = ScoreCache()
    batcher = DynamicBatcher(buckets=(32,), max_wait_us=0, device="cpu",
                             score_cache=cache).start()
    jb = JaxBatcher(buckets=(32,), max_wait_us=0).start()
    faults.get().add("batcher.dispatch", "wedge", count=1, delay_s=30)
    try:
        arrays = make_arrays(8, seed=5)
        futs = [batcher.submit(sv, arrays, output_keys=("prediction_node",))
                for _ in range(6)]
        _until(lambda: _dispatching(batcher))
        faults.get().clear()
        results = [f.result(timeout=30)["prediction_node"] for f in futs]
        for r in results[1:]:
            np.testing.assert_array_equal(results[0], r)
        _filled(cache)
        assert batcher.stats.batches == 1
        snap = cache.snapshot()
        assert snap["coalesced"] == 5 and snap["misses"] == 1
        hit = _score(batcher, sv, arrays, output_keys=("prediction_node",))
        np.testing.assert_array_equal(hit, results[0])
        assert batcher.stats.batches == 1 and cache.snapshot()["hits"] == 1
        np.testing.assert_allclose(results[0], _score(jb, jsv, arrays), rtol=0, atol=1e-5)
    finally:
        faults.get().clear()
        batcher.stop()
        jb.stop()


def test_failed_leader_fans_failure_out_and_never_fills(servable):
    cache = ScoreCache()
    batcher = DynamicBatcher(buckets=(32,), max_wait_us=0, device="cpu",
                             score_cache=cache).start()
    faults.get().add("batcher.dispatch", "wedge", count=1, delay_s=30)
    faults.get().add("readback", "error", code="INTERNAL", count=1)
    try:
        arrays = make_arrays(4, seed=9)
        futs = [batcher.submit(servable, arrays) for _ in range(3)]
        _until(lambda: _dispatching(batcher))
        faults.get().clear("batcher.dispatch")
        for f in futs:
            with pytest.raises(faults.InjectedFaultError):
                f.result(timeout=30)
        assert cache.entry_count() == 0
        assert cache.snapshot()["coalesced"] == 2
    finally:
        faults.get().clear()
        batcher.stop()


def test_cached_scores_bit_identical_and_bypass_queue(pair):
    """A hit has the bits of the computation that filled it and touches
    no queue; the hit and miss counts are the JAX batcher's, the scores
    within 1e-5 of its."""
    sv, jsv = pair
    cache, jcache = ScoreCache(), JaxScoreCache()
    batcher = DynamicBatcher(buckets=(32, 64), max_wait_us=0, device="cpu",
                             score_cache=cache).start()
    jb = JaxBatcher(buckets=(32, 64), max_wait_us=0, score_cache=jcache).start()
    try:
        arrays = make_arrays(11, seed=2)
        miss = batcher.submit(sv, arrays).result(timeout=30)
        _filled(cache)
        batches = batcher.stats.batches
        hit = batcher.submit(sv, arrays).result(timeout=5)
        assert batcher.stats.batches == batches
        for k in miss:
            assert np.array_equal(miss[k], hit[k]), k
        jmiss = jb.submit(jsv, arrays).result(timeout=30)
        _filled(jcache)
        jb.submit(jsv, arrays).result(timeout=30)
        np.testing.assert_allclose(miss["prediction_node"], jmiss["prediction_node"],
                                   rtol=0, atol=1e-5)
        snap, jsnap = cache.snapshot(), jcache.snapshot()
        for key in ("hits", "misses", "coalesced", "fills", "entries"):
            assert snap[key] == jsnap[key], key
    finally:
        batcher.stop()
        jb.stop()


def test_warmup_submits_skip_the_cache(servable):
    cache = ScoreCache()
    batcher = DynamicBatcher(buckets=(32,), max_wait_us=0, device="cpu",
                             score_cache=cache).start()
    try:
        batcher.warmup_via_queue(servable, buckets=(32,))
        snap = cache.snapshot()
        assert snap["hits"] == 0 and snap["misses"] == 0 and cache.entry_count() == 0
    finally:
        batcher.stop()


def test_waiters_survive_leader_deadline_cancellation(servable):
    """A joined request's budget is its own: when the leader is withdrawn
    (the service's timeout) the computation runs again for the waiter."""
    cache = ScoreCache()
    batcher = DynamicBatcher(buckets=(32,), max_wait_us=0, device="cpu",
                             score_cache=cache).start()
    faults.get().add("batcher.dispatch", "wedge", count=1, delay_s=30)
    try:
        arrays = make_arrays(4, seed=37)
        blocker = batcher.submit(servable, make_arrays(4, seed=36))  # holds the device stage
        _until(lambda: _dispatching(batcher))
        leader = batcher.submit(servable, arrays)
        waiter = batcher.submit(servable, arrays)
        assert leader.cancel()  # still queued: the service's withdrawal
        faults.get().clear()
        blocker.result(timeout=30)
        got = waiter.result(timeout=30)["prediction_node"]
        want = DynamicBatcher(buckets=(32,), device="cpu")._execute(
            servable, {k: np.concatenate([v, np.zeros((28, F), v.dtype)])
                       for k, v in arrays.items()}, None)["prediction_node"][:4]
        np.testing.assert_array_equal(got, want)
    finally:
        faults.get().clear()
        batcher.stop()


def test_detached_cache_still_closes_leader_flights(servable):
    """Taking the store off the batcher while a leader is in flight still
    answers the requests that joined it: the completion uses the store
    the leader's submit saw."""
    cache = ScoreCache()
    batcher = DynamicBatcher(buckets=(32,), max_wait_us=0, device="cpu",
                             score_cache=cache).start()
    faults.get().add("batcher.dispatch", "wedge", count=1, delay_s=30)
    try:
        arrays = make_arrays(4, seed=31)
        leader_fut = batcher.submit(servable, arrays)
        waiter_fut = batcher.submit(servable, arrays)
        batcher.score_cache = None
        faults.get().clear()
        want = leader_fut.result(timeout=30)["prediction_node"]
        np.testing.assert_array_equal(waiter_fut.result(timeout=5)["prediction_node"], want)
    finally:
        faults.get().clear()
        batcher.stop()


def test_build_stack_cache_master_switch():
    """[cache] enabled = false arms nothing, dedup included."""
    from distributed_tf_serving_tpu_torch.serving.server import build_stack

    cfg = ServerConfig(warmup=False, buckets=(32,), num_fields=F)
    mc = ModelConfig(name="DCN", **KW)
    for enabled, want in ((False, False), (True, True)):
        _impl, batcher, _sv = build_stack(cfg, mc, "cpu",
                                          cache_config=CacheConfig(enabled=enabled, dedup=True))
        try:
            assert (batcher.score_cache is not None) == want
            assert batcher.dedup == want
            assert batcher.row_cache is None
        finally:
            batcher.stop()


# ------------------------------------------------------------------ dedup


def _unique_order(arrays):
    """The rows collapse_rows executes, in its order, and the map back."""
    uniq, scatter, _ = collapse_rows({k: [v] for k, v in arrays.items()})
    return uniq, scatter


def test_dedup_scatter_matches_uncached_scores(pair):
    """Duplicate rows execute once, in a smaller bucket: the answer has the
    bits of the cache-off batcher's answer on the unique rows scattered
    back, is within 1e-5 of the JAX dedup batcher's, and the counters are
    the JAX batcher's."""
    sv, jsv = pair
    base = make_arrays(6, seed=7)
    sel = np.array([0, 1, 2, 0, 1, 2, 3, 0, 4, 5, 3, 2, 1, 4, 0, 5, 2, 3, 1, 0])
    arrays = {k: np.ascontiguousarray(v[sel]) for k, v in base.items()}
    plain = DynamicBatcher(buckets=(16, 32), max_wait_us=0, device="cpu").start()
    deduped = DynamicBatcher(buckets=(16, 32), max_wait_us=0, device="cpu", dedup=True).start()
    jb = JaxBatcher(buckets=(16, 32), max_wait_us=0, dedup=True).start()
    try:
        uniq, scatter = _unique_order(arrays)
        want = _score(plain, sv, uniq)[scatter]
        got = _score(deduped, sv, arrays)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(got, _score(jb, jsv, arrays), rtol=0, atol=1e-5)
        for name in ("dedup_batches", "dedup_rows_collapsed", "padded_candidates", "batches"):
            assert getattr(deduped.stats, name) == getattr(jb.stats, name), name
        assert deduped.stats.dedup_rows_collapsed == len(sel) - 6
        assert deduped.stats.padded_candidates == 16
    finally:
        plain.stop()
        deduped.stop()
        jb.stop()


def test_dedup_across_coalesced_requests(pair):
    """Rows repeated across the requests of one batch collapse too, and
    each request gets its own slice."""
    sv, jsv = pair
    a = make_arrays(10, seed=11)
    b = {k: np.ascontiguousarray(v[::-1]) for k, v in a.items()}
    batcher = DynamicBatcher(buckets=(16, 32, 64), max_wait_us=200_000, device="cpu",
                             dedup=True).start()
    jb = JaxBatcher(buckets=(16, 32, 64), max_wait_us=0).start()
    try:
        fa = batcher.submit(sv, a)
        fb = batcher.submit(sv, b)
        ra = fa.result(timeout=30)["prediction_node"]
        rb = fb.result(timeout=30)["prediction_node"]
        np.testing.assert_allclose(ra, _score(jb, jsv, a), rtol=0, atol=1e-5)
        np.testing.assert_array_equal(rb, ra[::-1])
        assert batcher.stats.batches == 1 and batcher.stats.dedup_rows_collapsed == 10
        assert batcher.stats.padded_candidates == 16
    finally:
        batcher.stop()
        jb.stop()


def test_collapse_rows_roundtrip_and_none_when_unique():
    parts = {"x": [np.array([[1, 2], [3, 4]], np.int64), np.array([[1, 2], [5, 6]], np.int64)],
             "w": [np.array([[0.5], [1.5]], np.float32), np.array([[0.5], [2.5]], np.float32)]}
    uniq, scatter, cats = collapse_rows(parts)
    juniq, jscatter, _ = jax_collapse_rows(parts)
    assert uniq["x"].shape[0] == 3
    np.testing.assert_array_equal(scatter, jscatter)
    for k in uniq:
        np.testing.assert_array_equal(uniq[k], juniq[k])
    cat = np.concatenate(parts["x"])
    np.testing.assert_array_equal(cats["x"], cat)
    np.testing.assert_array_equal(uniq["x"][scatter], cat)
    arr = np.arange(8).reshape(4, 2)
    uniq2, scatter2, cats2 = collapse_rows({"x": [arr]})
    assert uniq2 is None and scatter2 is None
    np.testing.assert_array_equal(cats2["x"], arr)


def test_disabled_mode_inert(servable):
    """No store, no dedup: the counters stay 0 and the answer is the
    no-cache batcher's."""
    batcher = DynamicBatcher(buckets=(32,), max_wait_us=0, device="cpu").start()
    off = DynamicBatcher(buckets=(32,), max_wait_us=0, device="cpu",
                         input_cache_entries=0).start()
    try:
        assert batcher.score_cache is None and batcher.row_cache is None
        assert batcher.dedup is False
        arrays = make_arrays(7, seed=13)
        sel = np.array([0, 1, 0, 1, 2, 3, 4, 5, 6, 0])
        dup = {k: np.ascontiguousarray(v[sel]) for k, v in arrays.items()}
        np.testing.assert_array_equal(_score(batcher, servable, dup), _score(off, servable, dup))
        assert batcher.stats.dedup_batches == batcher.stats.dedup_rows_collapsed == 0
        assert batcher.stats.row_batches == 0
    finally:
        batcher.stop()
        off.stop()


# -------------------------------------------- version-watcher integration


def test_watcher_hook_drops_old_generation(tmp_path, servable):
    """A version swap through a VersionWatcher with the server's hook drops
    the model's cached scores."""
    from distributed_tf_serving_tpu_torch.serving.server import _servable_change_hook
    from distributed_tf_serving_tpu_torch.serving.version_watcher import (
        VersionWatcher,
        VersionWatcherConfig,
    )
    from distributed_tf_serving_tpu_torch.train.checkpoint import save_servable

    cache = ScoreCache()
    registry = ServableRegistry()
    save_servable(tmp_path / "1", servable, kind="dcn_v2")
    watcher = VersionWatcher(
        tmp_path, registry, VersionWatcherConfig(poll_interval_s=3600, model_name="DCN"),
        device="cpu", on_servable_change=_servable_change_hook(cache, None))
    watcher.poll_once()
    sv1 = registry.resolve("DCN")
    key = cache.make_key(sv1.name, sv1.version, None, make_arrays(3, seed=17))
    cache.fill(key, _val())
    assert cache.lookup(key) is not None
    save_servable(tmp_path / "2", dataclasses.replace(servable, version=2), kind="dcn_v2")
    watcher.poll_once()
    assert 2 in registry.models()["DCN"]
    assert cache.lookup(key) is None
    assert cache.snapshot()["invalidations"] >= 1


# ------------------------------------------------------------- /cachez


def _rest_calls(impl, calls):
    import aiohttp

    from distributed_tf_serving_tpu_torch.serving.rest import start_rest_gateway as ours
    from distributed_tf_serving_tpu.serving.rest import start_rest_gateway as theirs

    start = ours if isinstance(impl, PredictionServiceImpl) else theirs

    async def go():
        runner, port = await start(impl, port=0)
        out = []
        try:
            async with aiohttp.ClientSession(f"http://127.0.0.1:{port}") as session:
                for method, path in calls:
                    async with session.request(method, path) as r:
                        body = await (r.text() if path.endswith("metrics") else r.json())
                        out.append((r.status, body))
        finally:
            await runner.cleanup()
        return out

    return asyncio.run(go())


_CACHEZ_CALLS = [("GET", "/cachez"), ("GET", "/monitoring"),
                 ("GET", "/monitoring/prometheus/metrics"), ("POST", "/cachez/flush"),
                 ("GET", "/cachez")]


def test_cachez_routes_and_monitoring_block(pair):
    """/cachez, the /monitoring cache block, the dts_tpu_cache_* series and
    POST /cachez/flush answer as the JAX gateway's after the same two
    Predicts."""
    sv, jsv = pair
    registry, jregistry = ServableRegistry(), JaxRegistry()
    registry.load(sv)
    jregistry.load(jsv)
    batcher = DynamicBatcher(buckets=(32,), max_wait_us=0, device="cpu",
                             score_cache=ScoreCache(), dedup=True).start()
    jb = JaxBatcher(buckets=(32,), max_wait_us=0, score_cache=JaxScoreCache(), dedup=True).start()
    try:
        arrays = make_arrays(4, seed=29)
        for b, s in ((batcher, sv), (jb, jsv)):
            b.submit(s, arrays).result(timeout=30)
            _filled(b.score_cache)
            b.submit(s, arrays).result(timeout=5)
        ours = _rest_calls(PredictionServiceImpl(registry, batcher), _CACHEZ_CALLS)
        theirs = _rest_calls(JaxImpl(jregistry, jb), _CACHEZ_CALLS)
    finally:
        batcher.stop()
        jb.stop()
    (s1, cz), (_, mon), (_, prom), (s4, fl), (_, cz2) = ours
    assert s1 == s4 == 200
    assert cz["enabled"] and cz["hits"] == 1 and cz["misses"] == 1
    assert cz["models"]["DCN"]["hits"] == 1
    assert mon["cache"]["hits"] == 1 and mon["batcher"]["dedup_batches"] == 0
    assert "dts_tpu_cache_hits_total 1" in prom
    assert 'dts_tpu_cache_model_events_total{model_name="DCN",event="hits"} 1' in prom
    assert fl == {"flushed": True, "entries_dropped": 1}
    assert cz2["entries"] == 0
    assert cz == theirs[0][1] and cz2 == theirs[4][1] and fl == theirs[3][1]
    assert mon["cache"] == theirs[1][1]["cache"]
    ours_cache = [ln for ln in prom.splitlines() if "dts_tpu_cache" in ln]
    theirs_cache = [ln for ln in theirs[2][1].splitlines() if "dts_tpu_cache" in ln]
    assert ours_cache == theirs_cache and ours_cache


def test_cachez_disabled_answers(servable):
    registry = ServableRegistry()
    registry.load(servable)
    batcher = DynamicBatcher(buckets=(32,), max_wait_us=0, device="cpu").start()
    try:
        (s1, cz), (s2, body) = _rest_calls(PredictionServiceImpl(registry, batcher),
                                           [("GET", "/cachez"), ("POST", "/cachez/flush")])
    finally:
        batcher.stop()
    assert s1 == 200 and cz == {"enabled": False}
    assert s2 == 500 and "no score cache is configured" in body["error"]


def test_cache_config_section(tmp_path):
    path = tmp_path / "c.toml"
    path.write_text("[cache]\nenabled = true\nmax_entries = 64\nttl_s = 5.0\n"
                    "coalesce = false\ndedup = true\n")
    cfg = load_config(path)["cache"]
    assert cfg == CacheConfig(enabled=True, max_entries=64, ttl_s=5.0, coalesce=False, dedup=True)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_config.load_config(path)["cache"])
    built = cfg.build()
    assert isinstance(built, ScoreCache)
    assert built.max_entries == 64 and built.coalesce is False
    assert CacheConfig().build() is None
    assert "cache" not in load_config(_toml_without_cache(tmp_path))


def _toml_without_cache(tmp_path):
    p = tmp_path / "plain.toml"
    p.write_text("[server]\nmax_wait_us = 0\n")
    return p


# -------------------------------------------- cached values own their memory


@pytest.mark.parametrize("wire,top_k", [("float32", 0), ("bfloat16", 0), ("int8", 0),
                                        ("float32", 3)],
                         ids=["f32", "bf16-wire", "int8-wire", "top-k"])
def test_a_cached_answer_survives_the_ring_reusing_its_buffer(servable, wire, top_k):
    """The readback lands in the host buffer ring, whose buffers are
    reused: a cached answer must own its memory. Serve A, then 50 other
    batches through the same ring, then A again from the cache: the same
    bits as the first answer."""
    cache = ScoreCache()
    batcher = DynamicBatcher(buckets=(8, 32), max_wait_us=0, device="cpu", score_cache=cache,
                             output_wire_dtype=wire, output_top_k=top_k).start()
    batcher.ring.per_size = 1
    keys = ("prediction_node",)
    try:
        a = make_arrays(6, seed=500)
        first = batcher.submit(servable, a, output_keys=keys).result(timeout=30)
        _filled(cache)
        kept = {k: v.copy() for k, v in first.items()}
        for s in range(50):
            batcher.submit(servable, make_arrays(6, seed=501 + s),
                           output_keys=keys).result(timeout=30)
        batches = batcher.stats.batches
        again = batcher.submit(servable, a, output_keys=keys).result(timeout=30)
        assert batcher.stats.batches == batches and cache.snapshot()["hits"] == 1
        assert batcher.ring.snapshot()["reuses"] > 0
        for k in kept:
            np.testing.assert_array_equal(again[k], kept[k])
            np.testing.assert_array_equal(first[k], kept[k])
    finally:
        batcher.stop()
