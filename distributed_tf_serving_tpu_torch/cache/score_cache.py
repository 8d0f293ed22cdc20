"""Exact-match prediction score cache + single-flight coalescing.

CTR candidate traffic is heavily zipfian: the same hot (user-bucket,
candidate-set) request recurs across requests within seconds, yet every
duplicate rides the full pad/pack/H2D/jit/D2H pipeline. The cheapest
inference is the one never run — this cache short-circuits EXACT repeats
at `batcher.submit`, before the queue, the device, or a dispatch slot is
touched.

Design:

- **Exact match only.** Keys are (model, version, output-selection,
  canonical-feature-bytes digest) — cache/digest.py's canonicalization, so
  two protobuf encodings of the same features hit the same entry while the
  compact and wide wires (different decoded bytes) stay apart. Cached
  scores are BIT-IDENTICAL to a fresh computation because they ARE a prior
  computation's outputs.
- **Sharded-lock LRU + TTL.** N independent (OrderedDict, Lock) shards
  keyed by digest hash: submit-path lookups from many RPC handler threads
  never serialize on one cache-wide lock. Capacity is bounded by entry
  count AND value bytes (split per shard); entries expire ttl_s after
  fill — CTR scores go stale with features not in the request (user state,
  budget pacing), so a bounded shelf life is part of the contract.
- **Generation invalidation.** Each model name carries a generation;
  `invalidate_model` (wired to the version watcher's on_servable_change
  hook) bumps it and drops that model's entries — a version swap can never
  serve the old version's scores even inside the TTL window. The version
  in the key already isolates entries; the generation makes the swap
  RECLAIM memory and kill in-flight fills that started under the old
  generation.
- **Single-flight coalescing.** Concurrent identical misses register on an
  in-flight map: one leader computes, every waiter's Future is resolved
  from the leader's result — N simultaneous hot-key misses cost one device
  pass, not N. A leader that fails fans its failure out (waiters would
  otherwise hang); a leader whose future is CANCELLED (service deadline)
  fails waiters with CoalescedLeaderCancelled (a TimeoutError, so the
  service maps it to DEADLINE_EXCEEDED).
- **Never filled from degraded/faulted/partial results.** fill() is only
  reached from a fully-successful completion (the batcher's completer
  success path; the client's non-degraded merge); failures and
  cancellations resolve waiters without touching the store, and a fill
  whose generation went stale mid-flight is dropped.

Thread-safe throughout; everything is plain Python + numpy.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from concurrent.futures import Future, InvalidStateError

import numpy as np

from .digest import features_digest


class CoalescedLeaderCancelled(TimeoutError):
    """The coalesced leader request was cancelled (its waiter's deadline
    expired) before producing a result: followers fail with a
    TimeoutError so the RPC layer answers DEADLINE_EXCEEDED — the shared
    computation timed out for everyone riding it."""


class _Entry:
    __slots__ = ("value", "expires_t", "gen", "nbytes")

    def __init__(self, value, expires_t, gen, nbytes):
        self.value = value
        self.expires_t = expires_t
        self.gen = gen
        self.nbytes = nbytes


class _Flight:
    __slots__ = ("gen", "waiters")

    def __init__(self, gen: int):
        self.gen = gen
        self.waiters: list[Future] = []


class CacheHandle:
    """One submit's cache context: the computed key, the generation it was
    minted under, and the role the caller drew (hit / coalesced waiter /
    leader). Leaders pass this back to complete()/abort(); a leader handle
    also pins ITS _Flight object, so closing the flight can never pop (and
    resolve) a DIFFERENT flight that replaced it in the map after a
    generation bump. `stale` marks a hit served PAST its TTL under the
    brownout stale-window (serving/overload.py): the caller must flag the
    response degraded and must never re-fill from it."""

    __slots__ = ("key", "model", "gen", "hit", "waiter", "leader", "flight",
                 "stale")

    def __init__(self, key, model, gen, hit=None, waiter=None, leader=False,
                 flight=None, stale=False):
        self.key = key
        self.model = model
        self.gen = gen
        self.hit = hit
        self.waiter = waiter
        self.leader = leader
        self.flight = flight
        self.stale = stale


class ScoreCache:
    """Sharded-lock LRU+TTL exact-match score cache with single-flight."""

    def __init__(
        self,
        max_entries: int = 8192,
        max_bytes: int = 64 << 20,
        ttl_s: float = 30.0,
        coalesce: bool = True,
        shards: int = 8,
        clock=time.monotonic,
    ):
        if max_entries <= 0:
            raise ValueError(f"max_entries must be positive, got {max_entries}")
        self.max_entries = int(max_entries)
        self.max_bytes = int(max_bytes)
        self.ttl_s = float(ttl_s)
        self.coalesce = bool(coalesce)
        self._clock = clock
        self._nshards = max(1, int(shards))
        # Per-shard capacity: independent shards cannot share a global
        # counter without a global lock, which is exactly what sharding
        # exists to avoid. The digest is uniform, so the split is fair.
        self._shard_entries = max(1, self.max_entries // self._nshards)
        self._shard_bytes = max(1, self.max_bytes // self._nshards)
        self._shards: list[OrderedDict] = [OrderedDict() for _ in range(self._nshards)]
        self._locks = [threading.Lock() for _ in range(self._nshards)]
        # Running value-byte total per shard (kept under the shard lock) so
        # fill's byte-budget eviction is O(evictions), not O(entries).
        self._bytes = [0] * self._nshards
        # model name -> generation; bumped by invalidate_model.
        self._gens: dict[str, int] = {}
        self._gen_lock = threading.Lock()
        # Single-flight: key -> _Flight, one map (misses are the slow path
        # and already heading for the device; a per-shard split buys
        # nothing measurable there).
        self._flights: dict = {}
        self._flight_lock = threading.Lock()
        # Per-model counters, one small lock (counter bumps are nanoseconds
        # next to the digest the lookup already paid).
        self._stats_lock = threading.Lock()
        self._per_model: dict[str, dict[str, int]] = {}

    # ------------------------------------------------------------- plumbing

    def _shard_of(self, key) -> int:
        # key[-1] is the 16-byte feature digest — already uniform.
        return key[-1][0] % self._nshards

    def _gen_of(self, model: str) -> int:
        with self._gen_lock:
            return self._gens.get(model, 0)

    _COUNTER_KEYS = ("hits", "misses", "coalesced", "evictions",
                     "expirations", "invalidations", "fills", "stale_serves")

    def _count(self, model: str, field: str, n: int = 1) -> None:
        with self._stats_lock:
            m = self._per_model.setdefault(
                model, {k: 0 for k in self._COUNTER_KEYS}
            )
            m[field] += n

    @staticmethod
    def make_key(
        model: str, version, output_keys, arrays: dict, salt: bytes = b""
    ) -> tuple:
        """(model, version, output-selection, canonical digest). version and
        output_keys are any hashables the caller resolves requests by (the
        batcher uses servable.version + the fetch-key tuple; the client its
        version label + output key). `salt` rides the digest fold — the
        cascade prune mode keys apart from full-vector runs there (see
        features_digest) — and the digest stays the LAST tuple element
        (_shard_of addresses key[-1])."""
        return (model, version, output_keys, features_digest(arrays, salt=salt))

    # ------------------------------------------------------------ hot path

    def lookup(self, key: tuple):
        """Cached value for `key`, or None. TTL-expired and stale-generation
        entries are dropped on sight (and counted)."""
        value = self._get(key)
        self._count(key[0], "hits" if value is not None else "misses")
        return value

    def _get(self, key: tuple):
        """Store read without hit/miss accounting (begin() attributes the
        outcome itself, so a coalesced join counts as coalesced — not as
        a miss on top)."""
        return self._get_within(key, 0.0)[0]

    def _get_within(self, key: tuple, stale_s: float):
        """(value, stale) store read: a FRESH entry reads as (value,
        False); an entry past its TTL but within `stale_s` of it reads as
        (value, True) WITHOUT being dropped or LRU-promoted — the brownout
        stale-serve path (serving/overload.py) borrows it, it does not
        revalidate it. Past the stale window (or on a stale generation)
        the entry is dropped on sight exactly as before."""
        model = key[0]
        gen = self._gen_of(model)
        idx = self._shard_of(key)
        now = self._clock()
        stale = False
        with self._locks[idx]:
            shard = self._shards[idx]
            entry = shard.get(key)
            if entry is not None:
                if entry.gen != gen:
                    del shard[key]
                    self._bytes[idx] -= entry.nbytes
                    entry = None
                elif now >= entry.expires_t + stale_s:
                    del shard[key]
                    self._bytes[idx] -= entry.nbytes
                    self._count(model, "expirations")
                    entry = None
                elif now >= entry.expires_t:
                    stale = True  # expired but inside the stale window
                else:
                    shard.move_to_end(key)
        return (entry.value if entry is not None else None), stale

    def begin(
        self, model: str, version, output_keys, arrays: dict,
        stale_s: float = 0.0, salt: bytes = b"",
    ) -> CacheHandle:
        """One-stop submit-path entry: digest + lookup + single-flight join.
        Returns a handle where exactly one of these holds:
        - handle.hit is the cached outputs (serve it, done) — with
          handle.stale True when `stale_s` > 0 allowed an expired entry
          (brownout: mark the response degraded, never re-fill);
        - handle.waiter is a Future another in-flight identical request
          will resolve (hand it to the caller, done);
        - handle.leader is True: compute, then complete(handle, future).
        """
        key = self.make_key(model, version, output_keys, arrays, salt=salt)
        gen = self._gen_of(model)
        hit, stale = self._get_within(key, stale_s)
        if hit is not None:
            self._count(model, "stale_serves" if stale else "hits")
            return CacheHandle(key, model, gen, hit=hit, stale=stale)
        flight = None
        if self.coalesce:
            with self._flight_lock:
                existing = self._flights.get(key)
                if existing is not None and existing.gen == gen:
                    waiter: Future = Future()
                    existing.waiters.append(waiter)
                    self._count(model, "coalesced")
                    return CacheHandle(key, model, gen, waiter=waiter)
                # Either no flight, or a STALE-generation one (its leader
                # started before an invalidation): replace it in the map —
                # the old leader still resolves its own waiters through
                # the flight object pinned on its handle.
                flight = _Flight(gen)
                self._flights[key] = flight
        self._count(model, "misses")
        return CacheHandle(key, model, gen, leader=True, flight=flight)

    def fill(self, key: tuple, value: dict, gen: int | None = None) -> bool:
        """Store `value` (dict[str, np.ndarray], COPIED so a cached entry
        never pins a whole batch buffer via a slice view). Refused — False —
        when the model's generation moved past `gen` (a version swap landed
        while this result was in flight) or the value alone exceeds a
        shard's byte budget."""
        model = key[0]
        if gen is None:
            gen = self._gen_of(model)
        elif gen != self._gen_of(model):
            return False
        value = {k: np.array(v, copy=True) for k, v in value.items()}
        nbytes = sum(v.nbytes for v in value.values())
        if nbytes > self._shard_bytes:
            return False
        entry = _Entry(value, self._clock() + self.ttl_s, gen, nbytes)
        idx = self._shard_of(key)
        evicted = 0
        with self._locks[idx]:
            shard = self._shards[idx]
            prev = shard.get(key)
            if prev is not None:
                self._bytes[idx] -= prev.nbytes
            shard[key] = entry
            shard.move_to_end(key)
            self._bytes[idx] += nbytes
            while len(shard) > self._shard_entries or (
                self._bytes[idx] > self._shard_bytes and len(shard) > 1
            ):
                _, old = shard.popitem(last=False)
                self._bytes[idx] -= old.nbytes
                evicted += 1
        self._count(model, "fills")
        if evicted:
            self._count(model, "evictions", evicted)
        return True

    # ------------------------------------------------- single-flight close

    def _pop_waiters(self, handle: CacheHandle) -> list[Future]:
        """Close the LEADER'S OWN flight: its waiters come from the flight
        object the handle pinned, and the map entry is removed only when
        it still holds that same flight (a stale-generation leader whose
        slot was replaced must not pop — and resolve — the newer flight's
        waiters with old-generation results)."""
        if handle.flight is None:
            return []
        with self._flight_lock:
            if self._flights.get(handle.key) is handle.flight:
                del self._flights[handle.key]
        return handle.flight.waiters

    def take_waiters(self, handle: CacheHandle) -> list[Future]:
        """Close a leader's flight WITHOUT resolving its waiters — the
        caller assumes responsibility for every returned Future (the
        batcher's deadline-retry path re-dispatches the computation for
        them instead of handing them the leader's deadline fate)."""
        return self._pop_waiters(handle)

    def complete(self, handle: CacheHandle, fut: Future) -> None:
        """Close a leader's flight from its finished Future: fill on
        success (same-generation only), fan result/failure out to every
        coalesced waiter. Safe to call from any thread (the batcher calls
        it via add_done_callback on a completer thread). Never raises —
        a cache bookkeeping failure must not poison the leader's own
        already-delivered result."""
        try:
            waiters = self._pop_waiters(handle)
            if fut.cancelled():
                result, exc = None, CoalescedLeaderCancelled(
                    "coalesced leader request was cancelled before completing"
                )
            else:
                exc = fut.exception()
                result = fut.result() if exc is None else None
            if exc is None:
                self.fill(handle.key, result, gen=handle.gen)
            for w in waiters:
                if w.cancelled():
                    continue
                try:
                    if exc is None:
                        w.set_result(result)
                    else:
                        w.set_exception(exc)
                except InvalidStateError:
                    pass  # waiter withdrawn concurrently; it is gone
        except Exception:  # noqa: BLE001 — bookkeeping must not cost a request
            import logging

            logging.getLogger("dts_torch.cache").exception("cache complete failed")

    def abort(self, handle: CacheHandle, exc: BaseException) -> None:
        """A leader that never got its computation enqueued (admission
        refused, prepare failed): close the flight by failing any waiters
        that joined in the window."""
        for w in self._pop_waiters(handle):
            if not w.cancelled():
                try:
                    w.set_exception(exc)
                except InvalidStateError:
                    pass

    def fail_flights(self, exc: BaseException) -> int:
        """Pop EVERY registered in-flight map entry and fail its waiters
        with `exc` — the quarantine-capture hook (serving/recovery.py):
        when the device is torn down for rebuild, the leaders of these
        flights may be stranded in wedged threads that never unwind, so
        nothing else would ever close them; a foreign (or future) request
        joining a zombie flight would hang to its deadline. Stranded
        leaders that DO eventually complete resolve only their own
        plan/handle waiter lists — already failed here, InvalidStateError
        guarded. Returns the number of waiters failed."""
        with self._flight_lock:
            flights = list(self._flights.values())
            self._flights.clear()
        failed = 0
        for fl in flights:
            for w in fl.waiters:
                if w.cancelled():
                    continue
                try:
                    w.set_exception(exc)
                    failed += 1
                except InvalidStateError:
                    pass
        return failed

    # -------------------------------------------------------- invalidation

    def invalidate_model(self, model: str) -> int:
        """Generation bump + eager purge of `model`'s entries (the version-
        watcher hook: a swap must drop the old generation's scores NOW, not
        at TTL). Returns the number of entries dropped."""
        with self._gen_lock:
            self._gens[model] = self._gens.get(model, 0) + 1
        dropped = 0
        for idx in range(self._nshards):
            with self._locks[idx]:
                shard = self._shards[idx]
                stale = [k for k in shard if k[0] == model]
                for k in stale:
                    self._bytes[idx] -= shard.pop(k).nbytes
                dropped += len(stale)
        if dropped:
            self._count(model, "invalidations", dropped)
        return dropped

    def flush(self, model: str | None = None) -> int:
        """Operator flush control (/cachez): drop everything, or one
        model's entries (generation-bumped, so in-flight fills die too)."""
        if model is not None:
            return self.invalidate_model(model)
        dropped = 0
        with self._gen_lock:
            models = set(self._gens)
        with self._flight_lock:
            # A model whose ONLY activity is an in-flight leader (no
            # entries yet, never invalidated) must still be bumped, or
            # that fill would land after the flush.
            models.update(k[0] for k in self._flights)
        per_model: dict[str, int] = {}
        for idx in range(self._nshards):
            with self._locks[idx]:
                shard = self._shards[idx]
                for k in shard:
                    per_model[k[0]] = per_model.get(k[0], 0) + 1
                models.update(k[0] for k in shard)
                dropped += len(shard)
                shard.clear()
                self._bytes[idx] = 0
        with self._gen_lock:
            for m in models:
                self._gens[m] = self._gens.get(m, 0) + 1
        # Same accounting as the per-model flush form: a full flush must
        # move the invalidation counters too, or dashboards watching
        # dts_tpu_cache_invalidations_total miss it entirely.
        for m, c in per_model.items():
            self._count(m, "invalidations", c)
        return dropped

    # ----------------------------------------------------------- telemetry

    def entry_count(self) -> int:
        return sum(len(s) for s in self._shards)

    def value_bytes(self) -> int:
        return sum(self._bytes)

    def snapshot(self) -> dict:
        """The /cachez + /monitoring block: aggregate and per-model
        hit/miss/coalesced/eviction counters, occupancy, config."""
        with self._stats_lock:
            per_model = {m: dict(c) for m, c in sorted(self._per_model.items())}
        totals = {
            k: sum(c.get(k, 0) for c in per_model.values())
            for k in self._COUNTER_KEYS
        } if per_model else {k: 0 for k in self._COUNTER_KEYS}
        looked = totals["hits"] + totals["misses"]
        return {
            "enabled": True,
            **totals,
            "hit_rate": round(totals["hits"] / looked, 4) if looked else 0.0,
            "entries": self.entry_count(),
            "value_bytes": self.value_bytes(),
            "config": {
                "max_entries": self.max_entries,
                "max_bytes": self.max_bytes,
                "ttl_s": self.ttl_s,
                "coalesce": self.coalesce,
                "shards": self._nshards,
            },
            "models": per_model,
        }
