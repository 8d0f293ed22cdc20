"""The row-granular score cache of the port (cache/row_cache.py and the
batcher's cold-row extraction) on the CPU: the store's LRU / TTL /
generations and its plan, a batch that executes only its cold rows in a
smaller bucket, the scatter across coalesced requests, dedup composed with
it, per-row single-flight across batches, a failing leader failing only the
batches that joined it (from each failure path of the batcher), a wedged
leader whose joiners fail fast once the breaker opens, a degraded leader
never filling the request cache, the version watcher's hook, the disabled
mode, [cache] row_granular and build_stack's switch; and the same requests
through the JAX batcher give the same row, dedup and padding counters.

Bit identity is held bucket for bucket: on the CPU a row's f32 scores
depend on where the GEMM tiles it, so an executed cold row is held to the
cache-off batcher's answer for the cold rows alone (the bucket and the
position the row cache ran them at), and a cached row to the answer that
filled it. Against the JAX package, scores agree within 1e-5."""

import dataclasses
import threading
import time

import jax
import numpy as np
import pytest

from distributed_tf_serving_tpu.cache import RowScoreCache as JaxRowScoreCache
from distributed_tf_serving_tpu.models import ModelConfig as JaxConfig
from distributed_tf_serving_tpu.models import Servable as JaxServable
from distributed_tf_serving_tpu.models import build_model as jax_build
from distributed_tf_serving_tpu.models import ctr_signatures as jax_signatures
from distributed_tf_serving_tpu.serving import DynamicBatcher as JaxBatcher
from distributed_tf_serving_tpu.utils import config as jax_config
from distributed_tf_serving_tpu_torch import faults, native
from distributed_tf_serving_tpu_torch.cache import RowScoreCache, ScoreCache, canonical_rows
from distributed_tf_serving_tpu_torch.cache.row_cache import digest_rows, row_structure_header
from distributed_tf_serving_tpu_torch.convert import params_from_jax
from distributed_tf_serving_tpu_torch.models import (
    ModelConfig,
    Servable,
    ServableRegistry,
    build_model,
    ctr_signatures,
)
from distributed_tf_serving_tpu_torch.serving import DeviceWedgedError
from distributed_tf_serving_tpu_torch.serving.batcher import DynamicBatcher
from distributed_tf_serving_tpu_torch.utils.config import CacheConfig, ServerConfig, load_config

F = 6
KW = dict(num_fields=F, vocab_size=1 << 10, embed_dim=4, mlp_dims=(8,), num_cross_layers=2,
          compute_dtype="float32")
SCORE = ("prediction_node",)


@pytest.fixture(autouse=True)
def _no_rules():
    faults.reset(0)
    yield
    faults.reset(0)


@pytest.fixture(scope="module")
def pair():
    # A request's digest is hash128 once the host ops are loaded, blake2b
    # before: load them first, as a server's warmup does, so one test's
    # keys do not change primitive halfway.
    assert native.ensure()
    jm = jax_build("dcn_v2", JaxConfig(name="DCN", **KW))
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    jsv = JaxServable(name="DCN", version=1, model=jm, params=jp, signatures=jax_signatures(F))
    sv = Servable(name="DCN", version=1, model=build_model("dcn_v2", ModelConfig(name="DCN", **KW)),
                  params=params_from_jax(jp, "cpu"), signatures=ctr_signatures(F))
    return sv, jsv


@pytest.fixture(scope="module")
def servable(pair):
    return pair[0]


@pytest.fixture()
def plain_batcher():
    b = DynamicBatcher(buckets=(8, 16, 32, 64), max_wait_us=0, device="cpu",
                       input_cache_entries=0).start()
    yield b
    b.stop()


def make_arrays(n, seed=0):
    rng = np.random.RandomState(seed)
    return {"feat_ids": rng.randint(0, 1 << 40, size=(n, F)).astype(np.int64),
            "feat_wts": rng.rand(n, F).astype(np.float32)}


def _cat(*parts):
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def row_keys_of(arrays):
    return digest_rows(canonical_rows(arrays), row_structure_header(arrays))


def _val(x=0.5):
    return {"prediction_node": np.asarray(np.float32(x))}


def _score(batcher, sv, arrays, **kw):
    return batcher.submit(sv, arrays, output_keys=SCORE, **kw).result(
        timeout=60)["prediction_node"]


def _until(pred, timeout=10.0):
    end = time.perf_counter() + timeout
    while not pred():
        assert time.perf_counter() < end, "condition not reached"
        time.sleep(0.005)


def _dispatching(batcher) -> bool:
    with batcher._cv:
        return batcher._dispatching_since is not None


# ------------------------------------------------------------- store unit


def test_row_lru_ttl_and_byte_bounds():
    clock = [0.0]
    rc = RowScoreCache(max_entries=4, ttl_s=10.0, shards=1, clock=lambda: clock[0])
    keys = [rc.row_key("DCN", 1, None, d) for d in row_keys_of(make_arrays(6, seed=1))]
    for i, k in enumerate(keys[:4]):
        assert rc.fill(k, _val(i))
    assert rc.entry_count() == 4
    rc.fill(keys[4], _val())
    rc.fill(keys[5], _val())
    assert rc.entry_count() == 4
    assert rc.lookup(keys[0]) is None and rc.lookup(keys[1]) is None
    assert rc.lookup(keys[5]) is not None
    clock[0] = 11.0
    assert rc.lookup(keys[5]) is None
    assert rc.snapshot()["expirations"] >= 1


def test_row_generation_invalidation_drops_entries_and_kills_fills():
    rc = RowScoreCache(shards=1)
    key = rc.row_key("DCN", 1, None, row_keys_of(make_arrays(1, seed=2))[0])
    gen = rc._gen_of("DCN")
    assert rc.fill(key, _val())
    assert rc.invalidate_model("DCN") == 1
    assert rc.lookup(key) is None
    assert rc.fill(key, _val(), gen=gen) is False
    assert rc.fill(key, _val()) is True


def test_begin_rows_classifies_hits_waiters_leads():
    rc = RowScoreCache(shards=1)
    digs = row_keys_of(make_arrays(3, seed=3))
    rc.fill(rc.row_key("DCN", 1, None, digs[0]), _val(0.7))
    plan_a = rc.begin_rows("DCN", 1, None, digs)
    assert set(plan_a.hits) == {0} and plan_a.lead == [1, 2]
    plan_b = rc.begin_rows("DCN", 1, None, [digs[1]])
    assert plan_b.lead == [] and set(plan_b.waiters) == {0}
    rc.complete_rows(plan_a, {1: _val(0.1), 2: _val(0.2)})
    assert float(plan_b.waiters[0].result(timeout=5)["prediction_node"]) == np.float32(0.1)
    plan_c = rc.begin_rows("DCN", 1, None, digs)
    assert len(plan_c.hits) == 3 and not plan_c.lead
    plan_d = rc.begin_rows("DCN", 1, None, [digs[0]] * 2 + row_keys_of(make_arrays(1, seed=33)))
    assert len(plan_d.hits) == 2
    rc.abort_rows(plan_d, RuntimeError("cleanup"))


def test_stale_window_serves_expired_rows_marked():
    """The store keeps the stale window: an entry past its TTL but inside
    the window answers as a hit marked stale; past it, it is gone. (The
    batcher passes no window yet: it belongs to the overload plane.)"""
    clock = [0.0]
    rc = RowScoreCache(ttl_s=1.0, shards=1, clock=lambda: clock[0])
    d = row_keys_of(make_arrays(1, seed=6))[0]
    rc.fill(rc.row_key("DCN", 1, None, d), _val())
    clock[0] = 2.0
    plan = rc.begin_rows("DCN", 1, None, [d], stale_s=5.0)
    assert set(plan.hits) == {0} and plan.stale_slots == {0}
    assert rc.snapshot()["stale_serves"] == 1
    clock[0] = 7.5
    plan2 = rc.begin_rows("DCN", 1, None, [d], stale_s=5.0)
    assert plan2.lead == [0] and not plan2.hits
    rc.abort_rows(plan2, RuntimeError("cleanup"))


def test_abort_rows_fails_waiters():
    rc = RowScoreCache(shards=1)
    digs = row_keys_of(make_arrays(1, seed=4))
    plan_a = rc.begin_rows("DCN", 1, None, digs)
    plan_b = rc.begin_rows("DCN", 1, None, digs)
    assert set(plan_b.waiters) == {0}
    rc.abort_rows(plan_a, RuntimeError("device died"))
    with pytest.raises(RuntimeError, match="device died"):
        plan_b.waiters[0].result(timeout=5)


def test_output_selection_keys_entries_apart():
    rc = RowScoreCache(shards=1)
    d = row_keys_of(make_arrays(1, seed=5))[0]
    rc.fill(rc.row_key("DCN", 1, SCORE, d), _val())
    plan = rc.begin_rows("DCN", 1, None, [d])
    assert plan.lead == [0]
    rc.abort_rows(plan, RuntimeError("cleanup"))


def test_structure_header_separates_identical_bytes():
    a = {"feat_ids": np.arange(F, dtype=np.int64).reshape(1, F)}
    b = {"feat_ids": np.arange(F, dtype=np.int64).reshape(1, F).view(np.uint8).reshape(1, -1)}
    assert row_keys_of(a)[0] != row_keys_of(b)[0]


# ------------------------------------------------- batcher: bit identity


def test_cold_extraction_scatter_bit_identity(plain_batcher, servable):
    """All cold: the cache-off answer's bits. Partly hot: the hot rows have
    the bits of the answer that filled them and of the cache-off answer,
    the 4 cold rows run alone in bucket 8 with the bits of the cache-off
    batcher's answer for those rows. A full repeat runs no batch."""
    rc = RowScoreCache(ttl_s=600.0)
    b = DynamicBatcher(buckets=(8, 16, 32, 64), max_wait_us=0, device="cpu",
                       row_cache=rc).start()
    try:
        a1 = make_arrays(20, seed=11)
        r1 = _score(b, servable, a1)
        np.testing.assert_array_equal(r1, _score(plain_batcher, servable, a1))
        assert b.stats.rows_executed == 20
        padded0 = b.stats.padded_candidates
        fresh = make_arrays(4, seed=12)
        a2 = _cat({k: v[:16] for k, v in a1.items()}, fresh)
        r2 = _score(b, servable, a2)
        np.testing.assert_array_equal(r2[:16], r1[:16])
        np.testing.assert_array_equal(r2[:16], _score(plain_batcher, servable, a2)[:16])
        np.testing.assert_array_equal(r2[16:], _score(plain_batcher, servable, fresh))
        assert b.stats.rows_executed == 24
        assert b.stats.padded_candidates - padded0 == 8  # 4 cold rows: bucket 8
        batches0 = b.stats.batches
        np.testing.assert_array_equal(_score(b, servable, a1), r1)
        assert b.stats.batches == batches0
        assert b.stats.row_full_hit_batches == 1 and b.stats.rows_requested == 60
        snap = rc.snapshot()
        assert snap["hits"] >= 36 and snap["rows_executed"] == 24
    finally:
        b.stop()


def test_scatter_across_coalesced_requests(plain_batcher, servable):
    """Two requests coalesced into one batch, some rows hot and some cold:
    each gets its own slice."""
    rc = RowScoreCache(ttl_s=600.0)
    warm = make_arrays(6, seed=21)
    b = DynamicBatcher(buckets=(8, 16, 32, 64), max_wait_us=200_000, device="cpu",
                       row_cache=rc).start()
    try:
        w = _score(b, servable, warm)
        new_a, new_c = make_arrays(5, seed=22), make_arrays(4, seed=23)
        a = _cat({k: v[:3] for k, v in warm.items()}, new_a)
        c = _cat(new_c, {k: v[3:] for k, v in warm.items()})
        fa = b.submit(servable, a, output_keys=SCORE)
        fc = b.submit(servable, c, output_keys=SCORE)
        ra = fa.result(timeout=60)["prediction_node"]
        rcv = fc.result(timeout=60)["prediction_node"]
        assert b.stats.batches == 2  # the warm request, then both together
        np.testing.assert_array_equal(ra[:3], w[:3])
        np.testing.assert_array_equal(rcv[4:], w[3:])
        # The cold rows ran together, a's then c's, in bucket 16.
        cold = _score(plain_batcher, servable, _cat(new_a, new_c))
        np.testing.assert_array_equal(ra[3:], cold[:5])
        np.testing.assert_array_equal(rcv[:4], cold[5:])
        assert rc.snapshot()["rows_executed"] == 6 + 9
    finally:
        b.stop()


def test_dedup_row_cache_composition(plain_batcher, servable):
    """dedup and the row cache together: duplicates collapse through the
    plan (the dedup counters move), each distinct row runs once, and the
    repeat is a full hit."""
    rc = RowScoreCache(ttl_s=600.0)
    base = make_arrays(6, seed=31)
    sel = np.array([0, 1, 2, 0, 1, 2, 3, 0, 4, 5, 3, 2, 1, 4, 0, 5, 2, 3, 1, 0])
    arrays = {k: np.ascontiguousarray(v[sel]) for k, v in base.items()}
    b = DynamicBatcher(buckets=(8, 16, 32), max_wait_us=0, device="cpu", row_cache=rc,
                       dedup=True).start()
    try:
        got = _score(b, servable, arrays)
        # The plan runs the distinct rows in digest order.
        digs = np.frombuffer(b"".join(row_keys_of(arrays)), np.uint8).reshape(len(sel), 16)
        _, first, inverse = np.unique(digs, axis=0, return_index=True, return_inverse=True)
        uniq = {k: np.ascontiguousarray(v[first]) for k, v in arrays.items()}
        np.testing.assert_array_equal(
            got, _score(plain_batcher, servable, uniq)[inverse.reshape(-1)])
        assert b.stats.dedup_batches == 1 and b.stats.dedup_rows_collapsed == len(sel) - 6
        assert b.stats.rows_executed == 6
        np.testing.assert_array_equal(_score(b, servable, arrays), got)
        assert b.stats.row_full_hit_batches == 1
    finally:
        b.stop()


def _jax_and_port(pair, **kw):
    sv, jsv = pair
    ours = DynamicBatcher(max_wait_us=0, device="cpu", row_cache=RowScoreCache(ttl_s=600.0),
                          **kw).start()
    theirs = JaxBatcher(max_wait_us=0, row_cache=JaxRowScoreCache(ttl_s=600.0), **kw).start()
    return ours, theirs


@pytest.mark.parametrize("dedup", [False, True], ids=["rows", "rows+dedup"])
def test_row_counters_equal_the_jax_package_s(pair, dedup):
    """The same requests through the JAX batcher and the port's, both with
    the row cache: equal rows_executed, row_full_hit_batches,
    dedup_rows_collapsed and padded_candidates, and scores within 1e-5."""
    sv, jsv = pair
    ours, theirs = _jax_and_port(pair, buckets=(8, 16, 32, 64), dedup=dedup)
    catalog = make_arrays(40, seed=70)
    rng = np.random.RandomState(71)
    requests = [{k: np.ascontiguousarray(v[rng.randint(0, 40, size=n)])
                 for k, v in catalog.items()} for n in (20, 30, 12, 25, 40, 20)]
    requests.append(requests[0])
    try:
        for req in requests:
            np.testing.assert_allclose(_score(ours, sv, req), _score(theirs, jsv, req),
                                       rtol=0, atol=1e-5)
        for name in ("rows_requested", "rows_executed", "row_batches", "row_full_hit_batches",
                     "dedup_batches", "dedup_rows_collapsed", "padded_candidates", "batches"):
            assert getattr(ours.stats, name) == getattr(theirs.stats, name), name
        assert ours.stats.rows_executed < ours.stats.rows_requested
        assert ours.row_cache.snapshot()["hits"] == theirs.row_cache.snapshot()["hits"]
    finally:
        ours.stop()
        theirs.stop()


def test_a_row_fill_owns_its_memory(servable):
    """Row fills are copies: after 50 other batches through the same ring
    buffers, a full hit still answers the first answer's bits."""
    b = DynamicBatcher(buckets=(8, 32), max_wait_us=0, device="cpu",
                       row_cache=RowScoreCache(ttl_s=600.0)).start()
    b.ring.per_size = 1
    try:
        a = make_arrays(6, seed=600)
        first = _score(b, servable, a).copy()
        for s in range(50):
            _score(b, servable, make_arrays(6, seed=601 + s))
        batches = b.stats.batches
        np.testing.assert_array_equal(_score(b, servable, a), first)
        assert b.stats.batches == batches and b.ring.snapshot()["reuses"] > 0
    finally:
        b.stop()


# -------------------------------------------- per-row single-flight


def test_row_single_flight_across_batches(servable):
    """Two batches sharing 4 cold rows run them once: the second joins the
    first's flights (held in its device stage) and runs only its own 2."""
    rc = RowScoreCache(ttl_s=600.0)
    b = DynamicBatcher(buckets=(8, 16), max_wait_us=0, device="cpu", row_cache=rc).start()
    faults.get().add("batcher.dispatch", "wedge", count=1, delay_s=30)
    try:
        shared = make_arrays(4, seed=41)
        a = _cat(shared, make_arrays(2, seed=42))
        c = _cat(shared, make_arrays(2, seed=43))
        fa = b.submit(servable, a, output_keys=SCORE, _solo=True)
        _until(lambda: _dispatching(b))
        fc = b.submit(servable, c, output_keys=SCORE, _solo=True)
        _until(lambda: rc.snapshot()["coalesced"] >= 4)
        faults.get().clear()
        ra = fa.result(timeout=30)["prediction_node"]
        rcv = fc.result(timeout=30)["prediction_node"]
        np.testing.assert_array_equal(ra[:4], rcv[:4])
        assert rc.snapshot()["coalesced"] == 4
        assert rc.snapshot()["rows_executed"] == 6 + 2
    finally:
        faults.get().clear()
        b.stop()


@pytest.mark.parametrize("site", ["batcher.dispatch", "readback", "executor_abort"])
def test_row_leader_failure_fails_dependent_requests_only(servable, site):
    """A batch that fails (in its device stage, at its readback, or as its
    step aborts) aborts its row flights: a batch that joined all its rows
    fails with the same error, an unrelated one answers, and a fresh
    submit of the rows plans them again and answers."""
    rc = RowScoreCache(ttl_s=600.0)
    b = DynamicBatcher(buckets=(8, 16), max_wait_us=0, device="cpu", row_cache=rc,
                       pipeline_depth=3).start()
    inj = faults.get()
    try:
        arrays = make_arrays(4, seed=51)
        if site == "batcher.dispatch":
            # A blocker holds the device stage while the leader is planned
            # and staged; the error then meets the leader's own stage.
            inj.add(site, "wedge", count=1, delay_s=0.5)
            blocker = b.submit(servable, make_arrays(3, seed=52), output_keys=SCORE)
            _until(lambda: _dispatching(b))
            inj.add(site, "error", code="INTERNAL", count=1)
        else:
            blocker = None
            inj.add("batcher.dispatch", "wedge", count=1, delay_s=0.5)
            inj.add(site, "error", code="INTERNAL", count=1)
        leader = b.submit(servable, arrays, output_keys=SCORE)
        if blocker is None:
            _until(lambda: _dispatching(b))
        joiner = b.submit(servable, arrays, output_keys=SCORE)
        _until(lambda: rc.snapshot()["coalesced"] >= 4)
        for f in (leader, joiner):
            with pytest.raises(faults.InjectedFaultError):
                f.result(timeout=30)
        if blocker is not None:
            assert blocker.result(timeout=30)["prediction_node"].shape == (3,)
        inj.clear()
        assert _score(b, servable, arrays).shape == (4,)
        assert rc.snapshot()["fills"] >= 4
    finally:
        inj.clear()
        b.stop()


def test_a_wedged_leader_and_the_breaker_fail_its_joiners_fast(servable):
    """A leader wedged in its device stage; B joins 3 of its rows and leads
    3 new ones (staged); D joins B's 3 new rows (planned, waiting). The
    breaker opens: a new submit, B and D all fail with DeviceWedgedError
    (UNAVAILABLE at the RPC layer) in under a second; none hangs. The
    leader answers once the device un-wedges."""
    rc = RowScoreCache(ttl_s=600.0)
    b = DynamicBatcher(buckets=(8, 32), max_wait_us=0, device="cpu", row_cache=rc,
                       breaker_timeout_s=5.0, pipeline_depth=3).start()
    faults.get().add("batcher.dispatch", "wedge", count=1, delay_s=60)
    try:
        a = make_arrays(6, seed=80)
        new = make_arrays(3, seed=81)
        fa = b.submit(servable, a, output_keys=SCORE)
        _until(lambda: _dispatching(b))
        fb = b.submit(servable, _cat({k: v[:3] for k, v in a.items()}, new), output_keys=SCORE)
        _until(lambda: len(b._staged) == 1)
        fd = b.submit(servable, new, output_keys=SCORE)
        _until(lambda: rc.snapshot()["coalesced"] >= 6)
        with b._cv:
            b._dispatching_since -= b.breaker_timeout_s + 1
        t0 = time.perf_counter()
        with pytest.raises(DeviceWedgedError):
            b.submit(servable, make_arrays(2, seed=82))
        for f in (fb, fd):
            with pytest.raises(DeviceWedgedError):
                f.result(timeout=1)
        assert time.perf_counter() - t0 < 1.0
        faults.get().clear()
        assert fa.result(timeout=30)["prediction_node"].shape == (6,)
    finally:
        faults.get().clear()
        b.stop()


def test_degraded_leader_never_fills_request_cache(servable):
    """A leader whose answer is marked degraded (row entries served past
    their TTL while the overload plane's `pressure` site pins BROWNOUT)
    must not fill the request cache, and the request that joined it gets
    the mark with the answer; back at NOMINAL a clean leader fills as
    before."""
    from distributed_tf_serving_tpu_torch.serving import overload as overload_mod
    from distributed_tf_serving_tpu_torch.utils.config import OverloadConfig

    clock = [0.0]
    cache = ScoreCache()
    rc = RowScoreCache(ttl_s=1.0, clock=lambda: clock[0])
    ctrl = OverloadConfig(enabled=True, adjust_interval_s=0.0, stale_while_overloaded_s=5.0,
                          recover_after_intervals=1).build()
    b = DynamicBatcher(buckets=(8,), max_wait_us=0, device="cpu", score_cache=cache,
                       row_cache=rc, overload=ctrl).start()
    try:
        a = make_arrays(3, seed=66)
        b.submit(servable, a, output_keys=SCORE).result(timeout=30)  # fills A's rows
        clock[0] = 1.5  # A's rows expired, inside the stale window
        faults.get().add("pressure", "error", code="BROWNOUT")
        assert ctrl.state() == "brownout"
        # A's (stale) rows and one fresh row: the leader dispatches; hold it
        # so an identical request joins its flight.
        arrays = _cat(a, make_arrays(1, seed=67))
        faults.get().add("batcher.dispatch", "wedge", count=1, delay_s=30)
        fut = b.submit(servable, arrays, output_keys=SCORE)
        _until(lambda: _dispatching(b))
        joined = b.submit(servable, arrays, output_keys=SCORE)
        faults.get().clear("batcher.dispatch")
        out = fut.result(timeout=30)["prediction_node"]
        assert getattr(fut, "dts_degraded", None) == "stale"
        np.testing.assert_array_equal(joined.result(timeout=5)["prediction_node"], out)
        assert getattr(joined, "dts_degraded", None) == "stale"
        key = cache.begin("DCN", 1, SCORE, arrays)
        assert key.leader  # nothing was filled: this lookup leads again
        cache.abort(key, RuntimeError("probe"))
        assert rc.snapshot()["stale_serves"] >= 3 and ctrl.snapshot()["brownout_serves"] >= 1
        faults.get().clear()
        assert ctrl.state() == "nominal"
        clean = b.submit(servable, arrays, output_keys=SCORE)
        clean.result(timeout=30)
        assert getattr(clean, "dts_degraded", None) is None
        assert cache.begin("DCN", 1, SCORE, arrays).hit is not None
    finally:
        faults.get().clear()
        b.stop()
        overload_mod.deactivate()
        overload_mod.consume_degraded()


# ------------------------------------------------- watcher + inertness


def test_watcher_swap_invalidates_row_cache(tmp_path, servable):
    from distributed_tf_serving_tpu_torch.serving.server import _servable_change_hook
    from distributed_tf_serving_tpu_torch.serving.version_watcher import (
        VersionWatcher,
        VersionWatcherConfig,
    )
    from distributed_tf_serving_tpu_torch.train.checkpoint import save_servable

    rc = RowScoreCache()
    registry = ServableRegistry()
    save_servable(tmp_path / "1", servable, kind="dcn_v2")
    watcher = VersionWatcher(
        tmp_path, registry, VersionWatcherConfig(poll_interval_s=3600, model_name="DCN"),
        device="cpu", on_servable_change=_servable_change_hook(None, rc))
    watcher.poll_once()
    sv1 = registry.resolve("DCN")
    key = rc.row_key(sv1.name, sv1.version, None, row_keys_of(make_arrays(1, seed=61))[0])
    rc.fill(key, _val())
    assert rc.lookup(key) is not None
    save_servable(tmp_path / "2", dataclasses.replace(servable, version=2), kind="dcn_v2")
    watcher.poll_once()
    assert 2 in registry.models()["DCN"]
    assert rc.lookup(key) is None and rc.snapshot()["invalidations"] >= 1


def test_disabled_mode_is_inert(servable):
    b = DynamicBatcher(buckets=(8, 16), max_wait_us=0, device="cpu").start()
    try:
        arrays = make_arrays(4, seed=71)
        first = _score(b, servable, arrays)
        np.testing.assert_array_equal(_score(b, servable, arrays), first)
        assert b.row_cache is None
        assert b.stats.row_batches == b.stats.rows_requested == b.stats.rows_executed == 0
        assert b.stats.batches == 2
    finally:
        b.stop()


# ---------------------------------------------------- config + build gate


def test_cache_config_row_parsing(tmp_path):
    path = tmp_path / "c.toml"
    path.write_text("[cache]\nenabled = true\nrow_granular = true\n"
                    "row_max_entries = 512\nrow_ttl_s = 7.5\nrow_coalesce = false\n")
    cfg = load_config(path)["cache"]
    assert cfg == CacheConfig(enabled=True, row_granular=True, row_max_entries=512,
                              row_ttl_s=7.5, row_coalesce=False)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_config.load_config(path)["cache"])
    built = cfg.build_row()
    assert isinstance(built, RowScoreCache)
    assert built.max_entries == 512 and built.coalesce is False
    assert CacheConfig(enabled=False, row_granular=True).build_row() is None
    assert CacheConfig(enabled=True, row_granular=False).build_row() is None


def test_build_stack_row_master_switch():
    from distributed_tf_serving_tpu_torch.serving.server import build_stack

    cfg = ServerConfig(warmup=False, buckets=(32,), num_fields=F)
    mc = ModelConfig(name="DCN", **KW)
    for enabled, row, want in ((True, True, True), (True, False, False), (False, True, False)):
        _impl, batcher, _sv = build_stack(
            cfg, mc, "cpu", cache_config=CacheConfig(enabled=enabled, row_granular=row))
        try:
            assert (batcher.row_cache is not None) == want
        finally:
            batcher.stop()


def test_build_stack_armed_answers_as_the_plane_off(servable):
    """build_stack with the whole plane armed answers bit-identical to the
    plane off for an all-cold request and its repeat, and /cachez's
    row_cache block counts it."""
    from distributed_tf_serving_tpu_torch.serving.server import build_stack

    cfg = ServerConfig(warmup=False, buckets=(8, 32), num_fields=F, max_wait_us=0)
    mc = ModelConfig(name="DCN", **KW)
    impl, on, sv_on = build_stack(cfg, mc, "cpu", cache_config=CacheConfig(
        enabled=True, dedup=True, row_granular=True))
    _impl, off, sv_off = build_stack(cfg, mc, "cpu")
    try:
        arrays = make_arrays(20, seed=90)
        want = _score(off, sv_off, arrays)
        np.testing.assert_array_equal(_score(on, sv_on, arrays), want)
        _until(lambda: on.score_cache.entry_count() == 1)  # the leader's fill
        np.testing.assert_array_equal(_score(on, sv_on, arrays), want)
        row = impl.row_cache_stats()
        assert row["batcher"]["rows_requested"] == 20 and row["rows_executed"] == 20
        assert impl.cache_stats()["hits"] == 1
    finally:
        on.stop()
        off.stop()


def test_flush_drops_both_tiers(servable):
    from distributed_tf_serving_tpu_torch.serving.service import PredictionServiceImpl

    registry = ServableRegistry()
    registry.load(servable)
    b = DynamicBatcher(buckets=(8,), max_wait_us=0, device="cpu", score_cache=ScoreCache(),
                       row_cache=RowScoreCache()).start()
    impl = PredictionServiceImpl(registry, b)
    try:
        _score(b, servable, make_arrays(3, seed=95))
        _until(lambda: b.score_cache.entry_count() == 1)  # the leader's fill
        assert impl.cache_flush() == 1 + 3
        assert impl.cache_flush("DCN") == 0
        batches = b.stats.batches
        _score(b, servable, make_arrays(3, seed=95))
        assert b.stats.batches == batches + 1
    finally:
        b.stop()


def test_join_order_is_independent_of_thread_timing(servable):
    """Eight threads submit the same rows at once with the request cache
    off: whichever batch leads, every answer has the same bits."""
    b = DynamicBatcher(buckets=(8, 16), max_wait_us=0, device="cpu",
                       row_cache=RowScoreCache(ttl_s=600.0)).start()
    try:
        arrays = make_arrays(5, seed=97)
        out = [None] * 8
        go = threading.Event()

        def run(i):
            go.wait(5)
            out[i] = _score(b, servable, arrays)

        threads = [threading.Thread(target=run, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        go.set()
        for t in threads:
            t.join(30)
        for o in out[1:]:
            np.testing.assert_array_equal(o, out[0])
        assert b.stats.rows_executed == 5
    finally:
        b.stop()
