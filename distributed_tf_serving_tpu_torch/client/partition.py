"""Candidate partitioning — the reference's client-side data parallelism.

`partition_list` reproduces the contiguous split of DCNClient.partitionList
(DCNClient.java:46-55): the first `parts-1` shards get floor(N/parts)
elements each and the last takes the remainder. The reference applies this
to *flattened* candidate x field arrays, which silently mis-aligns shard
boundaries whenever N*FIELD_NUM doesn't divide evenly (the latent bug at
DCNClient.java:97 — per-shard row count is recomputed as len/FIELD_NUM,
truncating). Here sharding happens on candidate *rows*, which is always
aligned; `partition_flat` exists for wire-parity testing and refuses the
misaligned case instead of truncating.
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np


def partition_bounds(n: int, parts: int) -> list[tuple[int, int]]:
    """Contiguous [start, end) bounds: floor(n/parts) each, remainder to last."""
    if parts <= 0:
        raise ValueError(f"parts must be positive, got {parts}")
    if n < parts:
        raise ValueError(f"cannot split {n} items into {parts} non-empty shards")
    base = n // parts
    bounds = [(i * base, (i + 1) * base) for i in range(parts - 1)]
    bounds.append(((parts - 1) * base, n))
    return bounds


def partition_list(seq: Sequence, parts: int) -> list[Sequence]:
    """Reference semantics (DCNClient.java:46-55) over any sequence."""
    return [seq[lo:hi] for lo, hi in partition_bounds(len(seq), parts)]


def shard_candidates(
    arrays: dict[str, np.ndarray], parts: int
) -> list[dict[str, np.ndarray]]:
    """Split candidate-major arrays into per-backend shards (row-aligned)."""
    n = next(iter(arrays.values())).shape[0]
    for key, arr in arrays.items():
        if arr.shape[0] != n:
            raise ValueError(
                f"inconsistent candidate counts: {key!r} has {arr.shape[0]}, expected {n}"
            )
    return [
        {k: v[lo:hi] for k, v in arrays.items()} for lo, hi in partition_bounds(n, parts)
    ]


def partition_flat(flat: Sequence, parts: int, num_fields: int) -> list[Sequence]:
    """The reference's flat-array split, with its misalignment made an error.

    The reference splits candidateNum*FIELD_NUM flat values and later infers
    each shard's row count as len/FIELD_NUM (DCNClient.java:57-74,97),
    silently dropping elements when shard boundaries fall mid-row. That case
    is rejected here.
    """
    shards = partition_list(flat, parts)
    for i, s in enumerate(shards):
        if len(s) % num_fields != 0:
            raise ValueError(
                f"shard {i} has {len(s)} elements, not a multiple of num_fields="
                f"{num_fields}: flat split would truncate mid-candidate "
                "(the DCNClient.java:97 misalignment)"
            )
    return shards


def jump_hash(key: int, buckets: int) -> int:
    """Lamping–Veach jump consistent hash: key -> [0, buckets). Cheap
    integer math per key (no per-bucket hashing), and consistent: growing
    the backend list from n to n+1 remaps only ~1/(n+1) of the keys, so a
    fleet resize does not cold-start every warm cache at once."""
    if buckets <= 0:
        raise ValueError(f"buckets must be positive, got {buckets}")
    key &= (1 << 64) - 1
    b, j = -1, 0
    while j < buckets:
        b = j
        key = (key * 2862933555777941757 + 1) & ((1 << 64) - 1)
        j = int((b + 1) * (float(1 << 31) / float((key >> 33) + 1)))
    return b


def affinity_groups(
    arrays: dict[str, np.ndarray], parts: int
) -> list[tuple[int, np.ndarray, dict[str, np.ndarray]]]:
    """Key-affinity candidate placement: assign each
    candidate row to a backend by jump-hashing its canonical row digest
    (cache/digest.py row identity — the SAME bytes the server's dedup and
    label-join planes key on), then gather per-backend row groups.

    Returns [(home_backend_idx, original_row_indices, sub_arrays), ...]
    for the non-empty groups only. Every row appears in exactly one
    group; scattering each group's scores back by its indices
    reconstructs the original candidate order exactly (so results are
    bit-identical to the contiguous split — the same rows score the same
    on whichever replica, and order is restored by construction).

    The row digest is cache/digest.row_label_keys — the ONE per-row
    identity the server's dedup and label-join planes already key on
    (never a second implementation that could drift); its first 64 bits
    feed the jump hash. Cost is one blake2b per row on the predict path
    (~µs/row) — acceptable for the seed; a batched native digest is the
    follow-up if affinity graduates to the hot default.
    """
    from ..cache.digest import row_label_keys

    if parts <= 0:
        raise ValueError(f"parts must be positive, got {parts}")
    n = next(iter(arrays.values())).shape[0]
    if n == 0:
        raise ValueError("cannot place an empty candidate set")
    for key, arr in arrays.items():
        if arr.shape[0] != n:
            raise ValueError(
                f"inconsistent candidate counts: {key!r} has {arr.shape[0]}, expected {n}"
            )
    keys = row_label_keys(arrays)
    assign = np.empty(n, np.int64)
    for i in range(n):
        assign[i] = jump_hash(int(keys[i][:16], 16), parts)
    out = []
    for host in range(parts):
        idx = np.nonzero(assign == host)[0]
        if idx.size == 0:
            continue
        out.append((host, idx, {k: v[idx] for k, v in arrays.items()}))
    return out


def index_runs(indices: np.ndarray) -> tuple[tuple[int, int], ...]:
    """Sorted row indices -> contiguous [start, end) runs — the
    missing_ranges encoding for an affinity group's failure (its rows are
    scattered, so one group degrades into several small ranges)."""
    idx = np.sort(np.asarray(indices, np.int64))
    if idx.size == 0:
        return ()
    breaks = np.nonzero(np.diff(idx) > 1)[0]
    starts = np.concatenate(([0], breaks + 1))
    ends = np.concatenate((breaks, [idx.size - 1]))
    return tuple(
        (int(idx[s]), int(idx[e]) + 1) for s, e in zip(starts, ends)
    )


class StreamingMerger:
    """Incremental merge of out-of-order PredictStream chunks.

    The server flushes each sub-batch as its readback completes, so chunk
    arrival order is completion order, not offset order. The merger
    scatters each chunk into a preallocated result vector by its
    [offset, offset+count) range and tracks coverage, so the caller knows
    the instant the FIRST scores land (first-scores latency decoupled
    from the slowest sub-batch) and whether the stream fully covered the
    request before trusting the merge."""

    def __init__(self, total: int):
        if total <= 0:
            raise ValueError(f"total must be positive, got {total}")
        self.total = int(total)
        self.filled = 0
        self.chunks = 0
        self._out: np.ndarray | None = None
        self._covered = np.zeros(self.total, bool)

    def add(self, offset: int, values: np.ndarray) -> None:
        values = np.asarray(values)
        n = values.shape[0]
        if offset < 0 or offset + n > self.total:
            raise ValueError(
                f"chunk [{offset}, {offset + n}) outside request [0, {self.total})"
            )
        if self._out is None:
            # Geometry comes from the first chunk: dtype + per-candidate
            # trailing shape (scores are 1-D in practice, but the merge
            # works for any candidate-major output).
            self._out = np.empty((self.total,) + values.shape[1:], values.dtype)
        seg = self._covered[offset: offset + n]
        if seg.any():
            raise ValueError(
                f"chunk [{offset}, {offset + n}) overlaps rows already merged"
            )
        seg[:] = True
        self._out[offset: offset + n] = values
        self.filled += n
        self.chunks += 1

    @property
    def complete(self) -> bool:
        return self.filled == self.total

    def missing_ranges(self) -> tuple[tuple[int, int], ...]:
        """Contiguous [start, end) ranges the stream never covered."""
        out, start = [], None
        for i, covered in enumerate(self._covered):
            if not covered and start is None:
                start = i
            elif covered and start is not None:
                out.append((start, i))
                start = None
        if start is not None:
            out.append((start, self.total))
        return tuple(out)

    def result(self) -> np.ndarray:
        if not self.complete:
            raise ValueError(
                f"stream covered {self.filled}/{self.total} candidates; "
                f"missing {self.missing_ranges()}"
            )
        assert self._out is not None
        return self._out


def merge_host_order(parts: list[np.ndarray]) -> np.ndarray:
    """Concatenate per-shard results in shard (host) order — the merge
    semantics of DCNClient.java:161-164. A single WRITABLE shard passes
    through uncopied; read-only shards (codec's zero-copy frombuffer views
    over response bytes) are copied so callers always get the owned,
    writable array this function has always returned."""
    if len(parts) == 1:
        p = np.asarray(parts[0])
        return p if p.flags.writeable else p.copy()
    return np.concatenate(list(parts), axis=0)
