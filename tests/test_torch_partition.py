"""The port's sharder (client/partition.py), case for case as the JAX
package's tests/test_partition.py holds its own (SURVEY.md §4):
concat-of-shards == original, reference split-point parity, rejection of the
flat-split misalignment, and the fleet-scope jump-hash continuity. Below
those cases, every partition function of the port against the JAX
package's on the same seeded inputs: equal outputs."""

import numpy as np
import pytest

from distributed_tf_serving_tpu_torch.client import (
    merge_host_order,
    partition_bounds,
    partition_flat,
    partition_list,
    shard_candidates,
)


def test_reference_workload_split():
    """1500 candidates x 43 fields over 3 hosts -> 500 candidates each
    (DCNClient.java:25,29,38: the even case the reference runs)."""
    flat = list(range(1500 * 43))
    shards = partition_flat(flat, 3, 43)
    assert [len(s) // 43 for s in shards] == [500, 500, 500]


def test_remainder_goes_to_last():
    shards = partition_list(list(range(10)), 3)
    assert [len(s) for s in shards] == [3, 3, 4]
    assert shards[2] == [6, 7, 8, 9]


@pytest.mark.parametrize("n,parts", [(10, 3), (1500, 3), (7, 7), (100, 1), (11, 4)])
def test_concat_of_shards_is_original(n, parts):
    seq = list(range(n))
    assert sum(partition_list(seq, parts), []) == seq
    bounds = partition_bounds(n, parts)
    assert bounds[0][0] == 0 and bounds[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))


def test_flat_misalignment_rejected():
    """10 candidates x 43 fields over 3 hosts: shard size 143 is not a
    multiple of 43 -> the reference would silently truncate mid-candidate
    (DCNClient.java:97); we refuse."""
    flat = list(range(10 * 43))
    with pytest.raises(ValueError, match="truncate mid-candidate"):
        partition_flat(flat, 3, 43)


def test_row_sharding_always_aligned():
    """Row-wise sharding handles the case flat splitting cannot."""
    arrays = {
        "feat_ids": np.arange(10 * 43).reshape(10, 43),
        "feat_wts": np.ones((10, 43), np.float32),
    }
    shards = shard_candidates(arrays, 3)
    assert [s["feat_ids"].shape for s in shards] == [(3, 43), (3, 43), (4, 43)]
    merged = merge_host_order([s["feat_ids"] for s in shards])
    np.testing.assert_array_equal(merged, arrays["feat_ids"])


def test_inconsistent_rows_rejected():
    with pytest.raises(ValueError, match="inconsistent"):
        shard_candidates(
            {"a": np.zeros((10, 2)), "b": np.zeros((9, 2))}, 2
        )


def test_more_parts_than_items_rejected():
    with pytest.raises(ValueError, match="non-empty"):
        partition_list([1, 2], 3)


# ----------------------- fleet-scope jump-hash continuity


def test_jump_hash_shrink_remaps_exactly_the_killed_tail_bucket():
    """Consistency property the fleet's affinity routing leans on:
    shrinking n -> n-1 buckets remaps EXACTLY the keys that lived in
    bucket n-1 (~1/n of them); every other key keeps its home — so a
    fleet resize does not cold-start every warm row cache at once."""
    from distributed_tf_serving_tpu_torch.client.partition import jump_hash

    n, keys = 8, 4000
    before = [jump_hash(k * 2654435761 + 17, n) for k in range(keys)]
    after = [jump_hash(k * 2654435761 + 17, n - 1) for k in range(keys)]
    moved = [k for k in range(keys) if before[k] != after[k]]
    # Only ex-tail keys moved, and ALL of them did (the bucket is gone).
    assert all(before[k] == n - 1 for k in moved)
    assert len(moved) == sum(1 for b in before if b == n - 1)
    # ~1/n of the keyspace (binomial around 500/4000 here).
    assert 0.5 * keys / n < len(moved) < 1.6 * keys / n


def test_affinity_groups_survive_replica_kill_with_one_nth_remap():
    """Killing replica k of n at FLEET scope: affinity assignment is a
    pure function of the row digests, so the surviving groups are
    byte-identical — only the dead replica's ~1/n of row groups need
    re-homing (the router's scoreboard steers just those)."""
    from distributed_tf_serving_tpu_torch.client.partition import affinity_groups

    rng = np.random.RandomState(7)
    rows, n = 400, 4
    arrays = {
        "feat_ids": rng.randint(0, 1 << 40, size=(rows, 8)).astype(np.int64),
        "feat_wts": rng.rand(rows, 8).astype(np.float32),
    }
    groups = {h: idx for h, idx, _ in affinity_groups(arrays, n)}
    assert sum(len(idx) for idx in groups.values()) == rows
    for killed in range(n):
        # Recomputing after the kill changes NOTHING about placement —
        # the hash runs over the same n buckets; the router reroutes the
        # dead group at pick() time instead of reshuffling the fleet.
        regrouped = {h: idx for h, idx, _ in affinity_groups(arrays, n)}
        assert sorted(regrouped) == sorted(groups)
        for h in groups:
            np.testing.assert_array_equal(regrouped[h], groups[h])
        # The displaced share is ~1/n of the rows, never the whole set.
        displaced = len(groups.get(killed, ()))
        assert displaced < 2 * rows / n
    # Balance: every replica owns a non-trivial share (the hash spreads).
    assert all(rows / (3 * n) < len(idx) for idx in groups.values())


# ------------------------------------------- the port against the JAX package

from distributed_tf_serving_tpu.client import partition as jax_part  # noqa: E402
from distributed_tf_serving_tpu_torch.client import partition as port_part  # noqa: E402


def _payload(rows, fields=8, seed=0):
    rng = np.random.RandomState(seed)
    return {"feat_ids": rng.randint(0, 1 << 40, size=(rows, fields)).astype(np.int64),
            "feat_wts": rng.rand(rows, fields).astype(np.float32)}


def _outcome(fn, *args):
    """fn's result, or its error's type and message (the misaligned flat
    split raises in both packages)."""
    try:
        return fn(*args)
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("n,parts", [(1000, 3), (1500, 3), (7, 7), (11, 4), (2048, 5)])
def test_bounds_lists_and_shards_equal_the_jax_package_s(n, parts):
    assert port_part.partition_bounds(n, parts) == jax_part.partition_bounds(n, parts)
    seq = list(range(n))
    assert port_part.partition_list(seq, parts) == jax_part.partition_list(seq, parts)
    flat = list(range(n * 3))
    assert _outcome(port_part.partition_flat, flat, parts, 3) == \
        _outcome(jax_part.partition_flat, flat, parts, 3)
    arrays = _payload(n, seed=n)
    got, want = port_part.shard_candidates(arrays, parts), jax_part.shard_candidates(arrays, parts)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])
    merged = [np.arange(lo, hi, dtype=np.float32) for lo, hi in port_part.partition_bounds(n, parts)]
    np.testing.assert_array_equal(port_part.merge_host_order(merged),
                                  jax_part.merge_host_order(merged))


def test_jump_hash_equals_the_jax_package_s():
    rng = np.random.RandomState(5)
    keys = [int(k) for k in rng.randint(0, 1 << 62, size=3000, dtype=np.int64)] + [0, 1, 2**64 - 1]
    for buckets in (1, 2, 3, 7, 64, 1000):
        assert [port_part.jump_hash(k, buckets) for k in keys] == \
            [jax_part.jump_hash(k, buckets) for k in keys]


@pytest.mark.parametrize("rows,n", [(400, 4), (1000, 3), (9, 5)])
def test_affinity_groups_and_index_runs_equal_the_jax_package_s(rows, n):
    arrays = _payload(rows, seed=rows + n)
    got, want = port_part.affinity_groups(arrays, n), jax_part.affinity_groups(arrays, n)
    assert [h for h, _, _ in got] == [h for h, _, _ in want]
    for (_, gi, ga), (_, wi, wa) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        assert port_part.index_runs(gi) == jax_part.index_runs(wi)
        for k in ga:
            np.testing.assert_array_equal(ga[k], wa[k])


def test_streaming_merger_equals_the_jax_package_s():
    rng = np.random.RandomState(2)
    total, order = 100, [(40, 30), (0, 25), (70, 30)]
    mergers = [port_part.StreamingMerger(total), jax_part.StreamingMerger(total)]
    for off, cnt in order:
        vals = rng.rand(cnt).astype(np.float32)
        for m in mergers:
            m.add(off, vals)
    assert mergers[0].missing_ranges() == mergers[1].missing_ranges() == ((25, 40),)
    assert mergers[0].complete is mergers[1].complete is False
    gap = rng.rand(15).astype(np.float32)
    for m in mergers:
        m.add(25, gap)
    np.testing.assert_array_equal(mergers[0].result(), mergers[1].result())
