"""Row-granular score cache — execute only the cold rows.

The exact-match ScoreCache (score_cache.py) answers WHOLE-request repeats;
at zipfian fleet traffic most requests are distinct as requests while
their candidate ROWS recur heavily (the same hot items are re-ranked for
every user). This module caches scores PER CANDIDATE ROW, keyed
(model, version, output-selection, row digest), so a request whose rows
are 90% hot executes only the cold 10%: the batcher consults the row
cache after collect, packs/buckets/dispatches only the cold rows, and the
completer scatters device scores (cold) and cached scores (hot) back into
each request's slice — bit-identical to a full execution, because every
cached value IS a prior execution's post-readback f32 output.

Reuses the ScoreCache machinery wholesale (RowScoreCache subclasses it):
the sharded-lock LRU store, TTL + byte/entry bounds, per-model generation
invalidation (version swaps drop row entries eagerly and kill in-flight
fills), and single-flight — now PER ROW: two co-resident batches sharing
a cold row execute it once (the first batch leads the row's flight; the
second joins as a waiter and assembles from the leader's fill). Brownout
stale-serve extends to row entries via the same `stale_s` window.

Row identity is the canonical row layout shared with dedup and the
label-join plane (cache/digest.py canonical_rows), pinned with a
structure header (per-input name/dtype/row-shape) so identical raw bytes
under a different tensor structure can never share a digest — the same
contract features_digest makes for whole requests.
"""

from __future__ import annotations

import hashlib
import logging
from concurrent.futures import Future, InvalidStateError

import numpy as np

from .digest import canonical_rows
from .score_cache import ScoreCache, _Entry, _Flight


def row_structure_header(arrays: dict[str, "np.ndarray"]) -> bytes:
    """Structure pin for per-row digests: each input's name, dtype, and
    PER-ROW shape (everything but the candidate axis), sorted by name —
    computed once per batch and folded into every row digest, so an int64
    id row can never collide with the same eight bytes read as weights."""
    parts = []
    for k in sorted(arrays):
        a = arrays[k]
        parts.append(f"{k}:{a.dtype.str}:{a.shape[1:]};")
    return "".join(parts).encode()


def digest_rows(
    blob: np.ndarray, header: bytes, rows=None
) -> list[bytes]:
    """16-byte blake2b digest per row of a canonical_rows blob (+ the
    structure header). `rows` restricts to a subset of row indices (the
    dedup-unique slots); None digests every row. ALWAYS blake2b, matching
    row_label_keys — the digest must not depend on whether the native
    host ops are built — but with the host ops present the whole batch
    hashes in ONE GIL-released native call (hostops.cc hash128_rows, the
    same RFC 7693 blake2b byte for byte) instead of a per-row python
    loop: at the armed-row-cache bucket sizes the loop was a measurable
    slice of every batch's host time."""
    from .. import native

    if native.available():
        if rows is None:
            sel = blob
        else:
            idx = np.fromiter(rows, dtype=np.int64)
            sel = blob[idx] if idx.size else blob[:0]
        digests = native.hash128_rows(sel, header)
        return [digests[i].tobytes() for i in range(digests.shape[0])]
    if rows is None:
        rows = range(blob.shape[0])
    out = []
    for i in rows:
        h = hashlib.blake2b(digest_size=16)
        h.update(header)
        h.update(blob[i].tobytes())
        out.append(h.digest())
    return out


class RowBatchPlan:
    """One batch's row-cache consultation: per-SLOT classification (a slot
    is one distinct row entering execution planning) into

    - hits[slot]   -> cached per-row output dict (serve it),
    - waiters[slot]-> Future another in-flight batch's fill resolves,
    - lead         -> slots THIS batch must execute (their flights, when
                      coalescing, are pinned in `flights` by identity —
                      the score_cache close-by-flight-identity contract).

    stale_slots marks hits served past TTL under the brownout window
    (responses touching them must be flagged degraded, never re-filled).
    """

    __slots__ = ("cache", "model", "gen", "keys", "hits", "stale_slots",
                 "waiters", "lead", "flights")

    def __init__(self, cache: "RowScoreCache", model: str, gen: int):
        self.cache = cache
        self.model = model
        self.gen = gen
        self.keys: list[tuple] = []
        self.hits: dict[int, dict] = {}
        self.stale_slots: set[int] = set()
        self.waiters: dict[int, Future] = {}
        self.lead: list[int] = []
        # Close idempotence lives in flights.pop(): a slot's flight is
        # popped exactly once whichever of complete_rows/abort_rows runs
        # first.
        self.flights: dict[int, _Flight] = {}


class RowScoreCache(ScoreCache):
    """Per-candidate-row score cache: the ScoreCache store/LRU/TTL/
    generation/single-flight machinery over (model, version,
    output-selection, row digest) keys. Values are per-row output dicts
    (each array is one row's slice of a post-readback, post-widen host
    output — f32, sidecars already consumed), so assembly from cache is
    bit-identical to a fresh execution."""

    # Row-plane extras next to the inherited hit/miss/... counters:
    # rows_requested counts every ORIGINAL row that entered cold-row
    # extraction (duplicates included), rows_executed the rows actually
    # dispatched to the device — the headline ratio of the plane.
    _COUNTER_KEYS = ScoreCache._COUNTER_KEYS + (
        "rows_requested", "rows_executed"
    )

    def __init__(
        self,
        max_entries: int = 131072,
        max_bytes: int = 32 << 20,
        ttl_s: float = 30.0,
        coalesce: bool = True,
        shards: int = 8,
        clock=None,
    ):
        import time

        super().__init__(
            max_entries=max_entries,
            max_bytes=max_bytes,
            ttl_s=ttl_s,
            coalesce=coalesce,
            shards=shards,
            clock=clock or time.monotonic,
        )

    @staticmethod
    def row_key(model: str, version, output_keys, digest: bytes) -> tuple:
        """(model, version, output-selection, row digest) — the same key
        shape ScoreCache uses, with the request digest replaced by one
        row's canonical digest. The output-selection axis matters: a row
        cached under a score-only fetch holds only the score output and
        must never answer an all-outputs request."""
        return (model, version, output_keys, digest)

    def note_rows(self, model: str, requested: int, executed: int) -> None:
        """Batcher accounting hook: `requested` original rows entered
        cold-row extraction, `executed` were actually dispatched."""
        if requested:
            self._count(model, "rows_requested", requested)
        if executed:
            self._count(model, "rows_executed", executed)

    # ----------------------------------------------------------- batch API

    def begin_rows(
        self, model: str, version, output_keys, digests: list[bytes],
        stale_s: float = 0.0,
    ) -> RowBatchPlan:
        """Consult the cache for every row digest of one batch (one slot
        per digest, in order). Duplicate digests within the batch resolve
        through the flight machinery: the first occurrence leads, later
        ones join as waiters the leader's own completion resolves — the
        intra-batch collapse falls out of single-flight for free.

        Atomic against partial failure: an exception mid-loop aborts
        every flight already registered before re-raising, so a planning
        error can never strand another batch's waiters."""
        plan = RowBatchPlan(self, model, self._gen_of(model))
        try:
            plan.keys = [
                self.row_key(model, version, output_keys, d) for d in digests
            ]
            # Batched store reads: slots grouped by shard, each shard lock
            # taken ONCE per batch instead of once per row — at 1.5k rows
            # per batch the per-row locking was the plane's dominant host
            # cost (the counter bumps are batched the same way below).
            by_shard: dict[int, list[int]] = {}
            for slot, key in enumerate(plan.keys):
                by_shard.setdefault(self._shard_of(key), []).append(slot)
            now = self._clock()
            expired = 0
            for idx, slots in by_shard.items():
                with self._locks[idx]:
                    shard = self._shards[idx]
                    for slot in slots:
                        key = plan.keys[slot]
                        entry = shard.get(key)
                        if entry is None:
                            continue
                        if entry.gen != plan.gen:
                            del shard[key]
                            self._bytes[idx] -= entry.nbytes
                        elif now >= entry.expires_t + stale_s:
                            del shard[key]
                            self._bytes[idx] -= entry.nbytes
                            expired += 1
                        elif now >= entry.expires_t:
                            # Expired but inside the brownout stale
                            # window: served WITHOUT LRU-promote/refresh
                            # (the _get_within stale-serve contract).
                            plan.hits[slot] = entry.value
                            plan.stale_slots.add(slot)
                        else:
                            shard.move_to_end(key)
                            plan.hits[slot] = entry.value
            misses = 0
            for slot, key in enumerate(plan.keys):
                if slot in plan.hits:
                    continue
                if self.coalesce:
                    with self._flight_lock:
                        existing = self._flights.get(key)
                        if existing is not None and existing.gen == plan.gen:
                            waiter: Future = Future()
                            existing.waiters.append(waiter)
                            plan.waiters[slot] = waiter
                            continue
                        flight = _Flight(plan.gen)
                        self._flights[key] = flight
                        plan.flights[slot] = flight
                plan.lead.append(slot)
                misses += 1
            fresh_hits = len(plan.hits) - len(plan.stale_slots)
            if fresh_hits:
                self._count(model, "hits", fresh_hits)
            if plan.stale_slots:
                self._count(model, "stale_serves", len(plan.stale_slots))
            if plan.waiters:
                self._count(model, "coalesced", len(plan.waiters))
            if misses:
                self._count(model, "misses", misses)
            if expired:
                self._count(model, "expirations", expired)
        except BaseException as exc:
            self.abort_rows(plan, exc)
            raise
        return plan

    def _pop_row_waiters(self, plan: RowBatchPlan, slot: int) -> list[Future]:
        """Close one lead slot's flight by identity (the score_cache
        contract: a stale-generation leader replaced in the map must
        never pop — and resolve — the newer flight's waiters)."""
        flight = plan.flights.pop(slot, None)
        if flight is None:
            return []
        key = plan.keys[slot]
        with self._flight_lock:
            if self._flights.get(key) is flight:
                del self._flights[key]
        return flight.waiters

    def complete_rows(
        self, plan: RowBatchPlan, values: dict[int, dict],
        exc: BaseException | None = None,
    ) -> None:
        """Close a batch's lead flights from its executed rows: slots
        present in `values` fill the store (same-generation only, batched
        per shard — one lock per shard per batch, not per row) and
        resolve their waiters with the value; slots absent fail their
        waiters with `exc` (or a RuntimeError). Never raises — cache
        bookkeeping must not cost the batch its own delivery."""
        try:
            fills: list[tuple[tuple, dict]] = []
            resolve: list[tuple[list, object, BaseException | None]] = []
            for slot in list(plan.lead):
                waiters = self._pop_row_waiters(plan, slot)
                value = values.get(slot)
                if value is not None:
                    # The value is fill_from_host's private per-row copy
                    # (shared with the waiters) — stored as-is, never a
                    # second copy per row.
                    fills.append((plan.keys[slot], value))
                if waiters:
                    err = (
                        None if value is not None
                        else (exc or RuntimeError(
                            "row execution produced no value"
                        ))
                    )
                    resolve.append((waiters, value, err))
            if fills:
                self._fill_many(plan.model, fills, plan.gen)
            for waiters, value, err in resolve:
                for w in waiters:
                    if w.cancelled():
                        continue
                    try:
                        if err is None:
                            w.set_result(value)
                        else:
                            w.set_exception(err)
                    except InvalidStateError:
                        pass
        except Exception:  # noqa: BLE001 — bookkeeping must not cost a request
            logging.getLogger("dts_torch.cache").exception(
                "row cache complete failed"
            )

    def _fill_many(
        self, model: str, items: list[tuple[tuple, dict]], gen: int
    ) -> int:
        """Batched fill: insert every (key, value) minted under `gen`
        with ONE lock acquisition per touched shard (fill()'s semantics
        otherwise — generation-refused after a swap, per-shard byte/entry
        eviction, counter accounting batched). Values must already be
        private copies."""
        if gen != self._gen_of(model):
            return 0
        expires = self._clock() + self.ttl_s
        by_shard: dict[int, list] = {}
        for key, value in items:
            by_shard.setdefault(self._shard_of(key), []).append((key, value))
        filled = 0
        evicted = 0
        for idx, batch in by_shard.items():
            with self._locks[idx]:
                shard = self._shards[idx]
                for key, value in batch:
                    nbytes = sum(v.nbytes for v in value.values())
                    if nbytes > self._shard_bytes:
                        continue
                    prev = shard.get(key)
                    if prev is not None:
                        self._bytes[idx] -= prev.nbytes
                    shard[key] = _Entry(value, expires, gen, nbytes)
                    shard.move_to_end(key)
                    self._bytes[idx] += nbytes
                    filled += 1
                while len(shard) > self._shard_entries or (
                    self._bytes[idx] > self._shard_bytes and len(shard) > 1
                ):
                    _, old = shard.popitem(last=False)
                    self._bytes[idx] -= old.nbytes
                    evicted += 1
        if filled:
            self._count(model, "fills", filled)
        if evicted:
            self._count(model, "evictions", evicted)
        return filled

    def abort_rows(self, plan: RowBatchPlan, exc: BaseException) -> None:
        """A batch that never completed its cold rows (shed while staged,
        device-stage failure, recovery capture): close every lead flight
        by failing the waiters that joined, so no foreign batch hangs on
        a fill that will never land. Idempotent after complete_rows (the
        flights are already popped)."""
        for slot in list(plan.lead):
            for w in self._pop_row_waiters(plan, slot):
                if not w.cancelled():
                    try:
                        w.set_exception(exc)
                    except InvalidStateError:
                        pass

    def snapshot(self) -> dict:
        snap = super().snapshot()
        snap["row_granular"] = True
        req = snap.get("rows_requested", 0)
        snap["rows_executed_fraction"] = (
            round(snap.get("rows_executed", 0) / req, 4) if req else 0.0
        )
        return snap
