"""The batcher's DeviceInputCache in the port on the CPU, the counterparts
of the JAX package's input-cache tests (tests/test_batcher.py,
tests/test_fused_pack.py): a repeated batch skips the pack and the upload
and answers the same bits, distinct content never hits, the LRU bound, the
adaptive bypass and its regime-aware re-probe, one group lookup per
natively packed batch, the vocab in the packed path's key, the per-key
path, a cached buffer the host ring never recycles; and the same batches
through the JAX batcher give the same hits, misses and bypass cycles."""

import jax
import numpy as np
import pytest
import torch

from distributed_tf_serving_tpu.models import ModelConfig as JaxConfig
from distributed_tf_serving_tpu.models import Servable as JaxServable
from distributed_tf_serving_tpu.models import build_model as jax_build
from distributed_tf_serving_tpu.models import ctr_signatures as jax_signatures
from distributed_tf_serving_tpu.serving import DynamicBatcher as JaxBatcher
from distributed_tf_serving_tpu_torch import native
from distributed_tf_serving_tpu_torch.convert import params_from_jax
from distributed_tf_serving_tpu_torch.models import ModelConfig, Servable, build_model, ctr_signatures
from distributed_tf_serving_tpu_torch.serving.batcher import DeviceInputCache, DynamicBatcher

F = 6


def _kw(cd, vocab=1 << 10):
    return dict(num_fields=F, vocab_size=vocab, embed_dim=4, mlp_dims=(8,), num_cross_layers=2,
                compute_dtype=cd)


def _pair(cd, vocab=1 << 10, name="DCN"):
    jm = jax_build("dcn_v2", JaxConfig(name=name, **_kw(cd, vocab)))
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    jsv = JaxServable(name=name, version=1, model=jm, params=jp, signatures=jax_signatures(F))
    sv = Servable(name=name, version=1,
                  model=build_model("dcn_v2", ModelConfig(name=name, **_kw(cd, vocab))),
                  params=params_from_jax(jp, "cpu"), signatures=ctr_signatures(F))
    return sv, jsv


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    assert native.ensure()
    return _pair(request.param)


@pytest.fixture(scope="module")
def servable(pair):
    return pair[0]


def make_arrays(n, seed=0):
    rng = np.random.RandomState(seed)
    return {"feat_ids": rng.randint(0, 1 << 40, size=(n, F)).astype(np.int64),
            "feat_wts": rng.rand(n, F).astype(np.float32)}


def _score(batcher, sv, arrays):
    return batcher.submit(sv, arrays).result(timeout=60)["prediction_node"]


def _reference(sv, arrays, bucket):
    """The cache-off batcher's answer on the same padded batch."""
    off = DynamicBatcher(buckets=(bucket,), device="cpu", input_cache_entries=0)
    padded = {k: np.concatenate([v, np.zeros((bucket - v.shape[0], F), v.dtype)])
              for k, v in arrays.items()}
    return off._execute(sv, padded, None)["prediction_node"][:arrays["feat_ids"].shape[0]]


def test_input_cache_correctness_and_hits(servable):
    """Repeated content hits and answers the same bits as the cache-off
    path; distinct content misses."""
    batcher = DynamicBatcher(buckets=(32,), max_wait_us=0, device="cpu").start()
    try:
        cache = batcher.input_cache
        a, b = make_arrays(8, seed=1), make_arrays(8, seed=2)
        got_a1 = _score(batcher, servable, a)
        h0, m0, copies = cache.hits, cache.misses, batcher.stats.h2d_copies
        got_a2 = _score(batcher, servable, a)
        assert cache.hits == h0 + 1 and cache.misses == m0
        assert batcher.stats.h2d_copies == copies  # no upload on a hit
        got_b = _score(batcher, servable, b)
        assert cache.misses == m0 + 1
        np.testing.assert_array_equal(got_a1, got_a2)
        np.testing.assert_array_equal(got_a1, _reference(servable, a, 32))
        np.testing.assert_array_equal(got_b, _reference(servable, b, 32))
        assert cache.bytes_skipped > 0
        assert batcher.stats.h2d_copies + cache.hits == batcher.stats.batches
    finally:
        batcher.stop()


def test_input_cache_lru_eviction(servable):
    batcher = DynamicBatcher(buckets=(32,), max_wait_us=0, device="cpu",
                             input_cache_entries=2).start()
    try:
        payloads = [make_arrays(8, seed=s) for s in range(3)]
        for p in payloads:
            _score(batcher, servable, p)
        assert len(batcher.input_cache._lru) <= 2
        m0 = batcher.input_cache.misses
        got = _score(batcher, servable, payloads[0])
        assert batcher.input_cache.misses == m0 + 1  # evicted: uploaded again
        np.testing.assert_array_equal(got, _reference(servable, payloads[0], 32))
    finally:
        batcher.stop()


def test_input_cache_off_with_zero_entries(servable):
    batcher = DynamicBatcher(buckets=(32,), max_wait_us=0, device="cpu",
                             input_cache_entries=0).start()
    try:
        a = make_arrays(8, seed=3)
        _score(batcher, servable, a)
        _score(batcher, servable, a)
        assert batcher.input_cache is None
        assert batcher.stats.h2d_copies == batcher.stats.batches == 2
    finally:
        batcher.stop()


def test_input_cache_adaptive_bypass(servable):
    """Unique traffic stops paying the digest: a window of misses flips the
    cache to bypass and drops its entries; answers stay right."""
    batcher = DynamicBatcher(buckets=(32,), max_wait_us=0, device="cpu").start()
    try:
        batcher.input_cache.probe_window = 4
        for s in range(5):
            _score(batcher, servable, make_arrays(8, seed=100 + s))
        assert batcher.input_cache.bypassed and not batcher.input_cache._lru
        p = make_arrays(8, seed=200)
        np.testing.assert_array_equal(_score(batcher, servable, p), _reference(servable, p, 32))
    finally:
        batcher.stop()


def test_input_cache_bypass_is_regime_aware(servable):
    """The probe window slides: a unique phase after a hot one still flips
    to bypass, and after reprobe_every bypassed lookups the cache probes
    again and re-engages on repeated traffic."""
    batcher = DynamicBatcher(buckets=(32,), max_wait_us=0, device="cpu").start()
    try:
        cache = batcher.input_cache
        cache.probe_window = 4
        cache.reprobe_every = 3
        hot = make_arrays(8, seed=7)
        for _ in range(12):
            _score(batcher, servable, hot)
        assert not cache.bypassed and cache.hits >= 8
        for s in range(5):
            _score(batcher, servable, make_arrays(8, seed=300 + s))
        assert cache.bypassed and cache.bypass_cycles == 1
        for s in range(2):
            _score(batcher, servable, make_arrays(8, seed=400 + s))
        assert not cache.bypassed
        for _ in range(4):
            _score(batcher, servable, hot)
        assert not cache.bypassed
        h0 = cache.hits
        for _ in range(3):
            _score(batcher, servable, hot)
        assert cache.hits > h0
        cache.rearm()
        assert not cache.bypassed
    finally:
        batcher.stop()


def test_input_cache_counters_equal_the_jax_package_s(pair):
    """The same batches through the JAX batcher and the port's: equal hits,
    misses, bypass cycles and bypass state, and scores within 1e-5."""
    sv, jsv = pair
    ours = DynamicBatcher(buckets=(16, 32), max_wait_us=0, device="cpu").start()
    theirs = JaxBatcher(buckets=(16, 32), max_wait_us=0).start()
    try:
        for b in (ours.input_cache, theirs.input_cache):
            b.probe_window, b.reprobe_every = 4, 5
        hot = make_arrays(8, seed=7)
        seq = [hot] * 6 + [make_arrays(20, seed=500 + s) for s in range(6)] + [hot] * 6
        for arrays in seq:
            np.testing.assert_allclose(_score(ours, sv, arrays), _score(theirs, jsv, arrays),
                                       rtol=0, atol=1e-5)
        for name in ("hits", "misses", "bypass_cycles", "bypassed"):
            assert getattr(ours.input_cache, name) == getattr(theirs.input_cache, name), name
        assert len(ours.input_cache._lru) == len(theirs.input_cache._lru)
    finally:
        ours.stop()
        theirs.stop()


def test_fused_path_content_cache_hits():
    """A natively packed (bf16) batch is one group lookup: a repeat is one
    hit, with no pack, and the same bits."""
    assert native.ensure()
    sv, _ = _pair("bfloat16")
    batcher = DynamicBatcher(buckets=(16,), max_wait_us=0, device="cpu").start()
    try:
        p = make_arrays(10, seed=11)
        a = _score(batcher, sv, p)
        h0, packs = batcher.input_cache.hits, batcher.stats.native_packs
        b = _score(batcher, sv, p)
        assert batcher.input_cache.hits == h0 + 1 and batcher.stats.native_packs == packs
        np.testing.assert_array_equal(a, b)
        assert packs == 1
    finally:
        batcher.stop()


def test_the_vocab_is_in_the_packed_key():
    """Two bf16 servables with different vocabs on one batcher: the
    packed buffer folds raw ids by the vocab, so the same raw payload must
    not share an entry between them."""
    assert native.ensure()
    small, _ = _pair("bfloat16", vocab=1 << 8, name="SMALL")
    large, _ = _pair("bfloat16", vocab=1 << 10, name="LARGE")
    batcher = DynamicBatcher(buckets=(16,), max_wait_us=0, device="cpu").start()
    try:
        p = make_arrays(10, seed=12)
        got_small = _score(batcher, small, p)
        got_large = _score(batcher, large, p)
        assert batcher.input_cache.hits == 0 and batcher.input_cache.misses == 2
        np.testing.assert_array_equal(got_small, _reference(small, p, 16))
        np.testing.assert_array_equal(got_large, _reference(large, p, 16))
        _score(batcher, small, p)
        assert batcher.input_cache.hits == 1
    finally:
        batcher.stop()


def test_per_key_path_looks_each_input_up(servable):
    """The per-key upload keys each input on its own: a repeat hits once
    per input, copies nothing, and answers the same bits."""
    batcher = DynamicBatcher(buckets=(16,), device="cpu")
    arrays = {k: np.concatenate([v, np.zeros((6, F), v.dtype)])
              for k, v in make_arrays(10, seed=13).items()}
    first = batcher._execute(servable, arrays, None, _per_key=True)["prediction_node"]
    copies = batcher.stats.h2d_copies
    second = batcher._execute(servable, arrays, None, _per_key=True)["prediction_node"]
    assert batcher.input_cache.hits == 2 and batcher.stats.h2d_copies == copies
    np.testing.assert_array_equal(first, second)
    np.testing.assert_array_equal(
        first, batcher._execute(servable, arrays, None)["prediction_node"])


def test_a_cached_buffer_is_not_recycled_by_the_ring(servable):
    """On the CPU the uploaded buffer is the ring's own: one the cache
    keeps never goes back to the ring, so 50 later batches through a
    one-buffer ring leave the cached batch's bytes, and its answer, as they
    were."""
    batcher = DynamicBatcher(buckets=(16,), max_wait_us=0, device="cpu").start()
    batcher.ring.per_size = 1
    try:
        a = make_arrays(10, seed=14)
        first = _score(batcher, servable, a)
        (cached,) = batcher.input_cache._lru.values()
        kept = cached.clone()
        for s in range(50):
            _score(batcher, servable, make_arrays(10, seed=700 + s))
        assert batcher.ring.snapshot()["reuses"] > 0
        assert torch.equal(cached, kept)
        h0 = batcher.input_cache.hits
        np.testing.assert_array_equal(_score(batcher, servable, a), first)
        assert batcher.input_cache.hits == h0 + 1
    finally:
        batcher.stop()


@pytest.mark.parametrize("entries", [64, 0])
def test_a_failed_upload_returns_its_buffer_to_the_ring(servable, entries, monkeypatch):
    """The packed ring buffer goes back to the ring when its upload raises,
    with the cache on (a miss) and off; the next batch then reuses it."""
    batcher = DynamicBatcher(buckets=(16,), max_wait_us=0, device="cpu",
                             input_cache_entries=entries)
    a = make_arrays(10, seed=15)
    padded = {k: np.concatenate([v, np.zeros((6, F), v.dtype)]) for k, v in a.items()}

    def broken(buf):
        raise RuntimeError("upload failed")

    monkeypatch.setattr(batcher, "_upload", broken)
    with pytest.raises(RuntimeError, match="upload failed"):
        batcher._execute(servable, padded, None)
    assert batcher.ring.snapshot()["free_buffers"] == 1
    assert not (batcher.input_cache and batcher.input_cache._lru)
    monkeypatch.undo()
    reuses = batcher.ring.snapshot()["reuses"]
    np.testing.assert_array_equal(batcher._execute(servable, padded, None)["prediction_node"][:10],
                                  _reference(servable, a, 16))
    assert batcher.ring.snapshot()["reuses"] > reuses


def test_the_store_reports_its_bytes_and_clears():
    cache = DeviceInputCache(max_entries=2)
    t = cache.get_or_put_group({"x": np.arange(4)}, lambda keep: torch.zeros(16, dtype=torch.uint8),
                               tag="t")
    assert cache.nbytes() == t.nbytes == 16 and cache.misses == 1
    assert cache.get_or_put_group({"x": np.arange(4)}, lambda keep: None, tag="t") is t
    cache.clear()
    assert cache.nbytes() == 0 and not cache._lru
