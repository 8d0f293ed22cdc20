"""The seeded generators are deterministic, and seeds reorder a fixed
amount of work."""

import numpy as np

from ctrbench.harness import spec
from ctrbench.harness.traffic import Traffic, reachable_buckets

BIG_SEED = 3_000_000_019


def _traffic(name):
    return Traffic(name, spec.Bench().traffic(name))


def test_request_content_is_a_function_of_seed_stream_and_index():
    t = _traffic("ref6-closed-1500")
    a = t.request(BIG_SEED, 2, 17, 1500, 43)
    b = t.request(BIG_SEED, 2, 17, 1500, 43)
    c = t.request(BIG_SEED + 1, 2, 17, 1500, 43)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["feat_ids"], c["feat_ids"])
    assert a["feat_ids"].min() >= 0 and a["feat_ids"].max() < 2 ** 40
    assert a["feat_wts"].dtype == np.float32 and 0 <= a["feat_wts"].min() < 1


def test_dense_features_and_one_hot_weights():
    t = _traffic("mlperf-server-open")
    r = t.request(BIG_SEED, 0, 3, 200, 26, 13)
    assert r["dense_features"].shape == (200, 13) and np.all(r["dense_features"] >= 0)
    assert np.all(r["feat_wts"] == 1.0)


def test_open_loop_schedule_is_a_fixed_multiset_per_seed():
    t = _traffic("mlperf-server-open")
    d1, s1 = t.schedule(BIG_SEED, 20.0)
    d1b, s1b = t.schedule(BIG_SEED, 20.0)
    d2, s2 = t.schedule(7, 20.0)
    assert np.array_equal(d1, d1b) and np.array_equal(s1, s1b)
    assert not np.array_equal(s1, s2)
    assert np.all(np.diff(d1) > 0) and d1[-1] < 20.0
    # The same gaps and sizes in another order: the same amount of work.
    assert len(d1) == len(d2) == round(t.spec["rate_per_s"] * 20)
    assert int(s1.sum()) == int(s2.sum())
    low, high = t.size_range()
    assert s1.min() >= low and s1.max() <= high


def test_closed_loop_sizes_are_a_permuted_table():
    t = _traffic("rerank-short-open")
    spec_closed = dict(t.spec, loop="closed", clients=2)
    tc = Traffic("x", spec_closed)
    a, b = tc.stream_sizes(BIG_SEED, 0), tc.stream_sizes(5, 0)
    assert np.array_equal(np.sort(a), np.sort(b)) and not np.array_equal(a, b)
    assert np.array_equal(a, tc.stream_sizes(BIG_SEED, 0))


def test_only_reachable_buckets_are_warmed():
    ladder = (256, 512, 1024, 2048)
    assert reachable_buckets(_traffic("ref6-closed-1500"), ladder) == (2048,)
    assert reachable_buckets(_traffic("rerank-short-open"), ladder) == ladder
    one = Traffic("x", {"loop": "closed", "candidates": {"dist": "uniform", "low": 300,
                                                        "high": 700}})
    assert reachable_buckets(one, ladder) == (512, 1024, 2048)
