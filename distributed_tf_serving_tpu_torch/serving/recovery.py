"""Device-failure recovery plane (the JAX package's serving/recovery.py):
executor quarantine, replay of the accepted work, poisoned-input
bisection, with REINIT defined for a CUDA context.

With the pipeline k batches deep, one device fault strands every batch in
flight and everything queued behind them. Without this plane the only
exits are failing them all (DeviceWedgedError) or killing the process.
The plane turns a device failure into a bounded, observable cycle:

    SERVING -> QUARANTINED -> REINIT -> REPLAY -> SERVING

- **Triggers.** A batch failure that is device-fatal (`device_fatal`: the
  `device_lost` / `executor_abort` fault sites, an integrity verdict, a
  sticky CUDA error) reaches `take_group` from the batcher; the watchdog
  escalates the batcher's wedge clock (`wedge_age`, the breaker's clock)
  past `wedge_quarantine_s`; a dead batcher thread reaches
  `note_thread_death`. Any other failure keeps the fail-the-group path.
- **QUARANTINED.** Health "" answers NOT_SERVING (reason `quarantined`),
  new submits are refused fast (DeviceQuarantinedError, UNAVAILABLE), the
  lifecycle controller's ticks pause, and every accepted, unanswered item
  is captured out of the batcher (`capture_for_recovery`: queued, staged,
  in the device stage, in flight). On a wedge or a thread death the
  dispatch thread and the completion pool are replaced.
- **REINIT** (below), then the bucket ladder re-warms through the queue
  (warmup is exempt from the gate and the wedge clock).
- **REPLAY.** Captured items go back to the queue's front with their host
  arrays and a replay budget. A batch that kills the executor again is
  BISECTED: its requests split in halves with distinct `bisect_key`s (the
  coalescer merges only equal keys) until a single request is isolated;
  it alone fails with PoisonedInputError (INVALID_ARGUMENT, do not retry)
  while its batchmates answer. A failed batch's buffers are never reused
  while a copy may read them (the batcher's rings wait on its events; a
  context that can no longer answer drops them).

**What REINIT means on an H100.** The JAX REINIT rebuilds the executables
in process (`jax.clear_caches()`, optionally `jax.clear_backends()`). A
CUDA context has no such rebuild: a sticky error (an illegal address, a
device-side assert, an uncorrectable ECC error) fails every later launch
of the process. Where the context survives — an injected fault, an
integrity verdict, a wedge, a dead thread — REINIT does what the JAX one
does, in torch terms:

- it clears the batcher's per-servable device steps (`_entries`), the
  cross-stack weight cache (`ops/cross_kernel.py cross_cache`, the device
  copies of the prepared weights) and the DeviceInputCache (its tensors
  belong to the context that failed);
- it revives a dead batching or dispatch thread (the completion pool and
  the dispatch thread are replaced on a wedge or a thread death, as the
  JAX pools are);
- `torch.cuda.empty_cache()` takes the place of `jax.clear_caches()`;
- the kernels are `ctypes` libraries (ops/cuda_build.py) and stay loaded:
  a context needs no rebuild of them.

REINIT ends with a probe of the context that cannot hang: a CUDA event
recorded on the serving stream, its `query()` polled until a deadline
(`wedge_quarantine_s`), never a blocking `synchronize()`. A dead context
raises from the record or the query (a sticky error); a stream that does
not drain by the deadline holds a kernel that never ends. Either way the
context is lost, and a dead context must convict no one: after a sticky
error every launch fails, so the bisection would find every request
"poisoned". The round then replays nothing, the captured items fail with
the retryable DeviceWedgedError (UNAVAILABLE), the controller holds
QUARANTINED (health NOT_SERVING, submits refused) until the process
restarts, and `last_cycle` carries `context_lost`. A poison verdict, too,
is given only after a probe finds the context alive. The drain still ends
the process (`shutdown_for_drain`). `[recovery] reinit_clear_backend =
true`, the JAX escape hatch for a lost TPU, is refused by load_config:
restart the process instead.

Off by default ([recovery] enabled / --recovery): each batcher hook then
reads one attribute. Surfaces: GET /recoveryz, the `recovery` block of
/monitoring and the dts_tpu_recovery_* series.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from collections import deque
from concurrent.futures import InvalidStateError
from concurrent.futures import wait as fut_wait

import torch

from .. import faults as faults_mod
from ..ops import cross_kernel
from .batcher import DeviceWedgedError, PoisonedInputError

log = logging.getLogger("dts_torch.recovery")

# States (the wire / JSON encoding, lowercase for labels).
SERVING = "serving"
QUARANTINED = "quarantined"
REINIT = "reinit"
REPLAY = "replay"
STATES = (SERVING, QUARANTINED, REINIT, REPLAY)

# Fault sites classified device-fatal, and the text of a device's death:
# the JAX package's markers, and CUDA's sticky errors as they arrive from
# the launch wrapper ("<what> kernel launch failed: <cudaGetErrorString>",
# ops/cross_kernel.py) and from torch at an event or a copy. Kept narrow:
# "out of memory", "too many resources requested for launch" and "invalid
# argument" are not a dead device and keep the fail-the-group path.
_FATAL_SITES = ("device_lost", "executor_abort")
_FATAL_MARKERS = (
    "DEVICE_LOST", "device lost", "Device lost", "DATA_LOSS", "executor aborted",
    "an illegal memory access was encountered", "unspecified launch failure",
    "device-side assert triggered", "misaligned address", "illegal instruction",
    "uncorrectable ECC error encountered",
)


def device_fatal(exc: BaseException) -> bool:
    """True when `exc` means the device executor is gone (quarantine and
    replay), False for everything else (the fail-the-group path)."""
    if isinstance(exc, faults_mod.InjectedFaultError):
        return exc.site in _FATAL_SITES
    if getattr(exc, "integrity_corrupt", False):
        # Integrity verdicts (a shadow mismatch, a screen-trip burst): the
        # executor's outputs can no longer be trusted.
        return True
    msg = str(exc)
    return any(m in msg for m in _FATAL_MARKERS)


def probe_context(device, timeout_s: float) -> str | None:
    """None when `device`'s context answers; else why not. A CUDA event is
    recorded on the device's current (serving) stream and polled until
    `timeout_s`: a sticky error raises from the record or the query, and a
    stream that has not drained by then holds a kernel that never ends. No
    call here blocks on the device. Any other device answers."""
    if device is None or getattr(device, "type", "cpu") != "cuda":
        return None
    try:
        with torch.cuda.device(device):
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
            deadline = time.monotonic() + timeout_s
            while not event.query():
                if time.monotonic() >= deadline:
                    return f"the serving stream did not drain within {timeout_s:g} s"
                time.sleep(0.001)
    except RuntimeError as exc:  # torch's AcceleratorError is a RuntimeError
        return str(exc).strip().splitlines()[0] if str(exc).strip() else type(exc).__name__
    return None


class RecoveryController:
    """The quarantine -> REINIT -> replay state machine over one batcher.

    Collaborators are injected — `batcher` (the capture / requeue / reinit
    surface; the controller attaches itself as `batcher.recovery`),
    `registry` (the servables to re-warm; None skips the re-warm), `impl`
    or `lifecycle` (the canary ticks pause during a cycle), `probe` (the
    context probe, `probe_context` on the batcher's device by default) —
    so the machine runs under a fake clock and a fake batcher with no
    thread: `run_cycle()` is a whole cycle, `check()` one watchdog pass;
    `start()` adds the background watchdog."""

    def __init__(self, config, batcher, registry=None, impl=None, lifecycle=None,
                 clock=time.monotonic, probe=None):
        self.config = config
        self.batcher = batcher
        self.registry = registry
        self.impl = impl
        self.lifecycle = lifecycle
        self._clock = clock
        self._probe_fn = probe
        self._lock = threading.Lock()
        # One cycle at a time: a failure arriving mid-cycle lands in
        # _pending and the running cycle's rounds absorb it.
        self._cycle_mutex = threading.Lock()
        self._state = SERVING
        self._state_since = clock()
        # Replay units: lists of _WorkItems dispatched together (a
        # bisection half is one unit with one bisect_key).
        self._pending: list[list] = []
        self._pending_ids: set[int] = set()
        self._bisect_seq = 0
        self._trigger: str | None = None
        # The probe's verdict once the context is lost: the controller then
        # holds QUARANTINED.
        self._context_lost: str | None = None
        # Spawn a one-shot cycle thread when no watchdog runs; tests that
        # drive run_cycle() themselves set this False.
        self.auto_cycle = True
        # Counters (monotonic; the Prometheus series read snapshot()).
        self.quarantines = 0
        self.reinits = 0
        self.cycles_completed = 0
        self.device_failures = 0
        self.replayed_items = 0
        self.replay_budget_exhausted = 0
        self.poisoned_requests = 0
        self.bisections = 0
        self.watchdog_wedge_trips = 0
        self.thread_deaths = 0
        self._last_cycle: dict | None = None
        keep = max(int(getattr(config, "history_events", 64)), 8)
        self._events: deque[dict] = deque(maxlen=keep)
        # One record per completed cycle: the MTTR history /recoveryz serves.
        self._mttr_ring: deque[dict] = deque(maxlen=keep)
        self._stop_evt = threading.Event()
        self._wake = threading.Event()
        self._worker: threading.Thread | None = None
        batcher.recovery = self
        ring = getattr(batcher, "ring", None)
        if ring is not None:
            # The replica must outlive a sticky error: its pinned buffers
            # are never freed (batcher._HostBufferRing).
            ring.keep = True

    # ---------------------------------------------------------- fast reads
    # Single-attribute reads, no lock: they run inside batcher.submit
    # (under its condition variable) and in future done-callbacks, where
    # taking _lock could deadlock against a cycle resolving futures.

    def state(self) -> str:
        return self._state

    def refusing(self) -> bool:
        """New (non-warmup) submits are refused while the executor is down
        or rebuilt; REPLAY accepts again (replayed items go first)."""
        return self._state in (QUARANTINED, REINIT)

    def not_serving(self) -> bool:
        """Health answers NOT_SERVING through the whole cycle."""
        return self._state != SERVING

    def context_lost(self) -> str | None:
        """The probe's verdict once the CUDA context is lost (the controller
        then holds QUARANTINED until the process restarts), else None."""
        return self._context_lost

    def cycle_active(self) -> bool:
        """A cycle runs, or work is captured or a cycle requested:
        batcher.drain() observes it."""
        return self._state != SERVING or bool(self._pending) or self._trigger is not None

    # ------------------------------------------------------------ triggers

    def take_group(self, group: list, exc: BaseException) -> bool:
        """The batcher's failure hook. True: the failure is device-fatal and
        the controller owns the group's outcome (a replay, or the poison /
        budget verdict); False: fail the group as before."""
        if self._stop_evt.is_set():
            return False  # a drain stopped the controller: nobody would replay it
        if not device_fatal(exc):
            return False
        self.device_failures += 1
        log.warning("recovery: device-fatal failure of a batch of %d requests: %s: %s",
                    len(group), type(exc).__name__, exc)
        # Warmup is re-run whole by REINIT: its items fail, not replay.
        self._apply_fails([(it, exc) for it in group if it.warmup and not it.future.done()])
        self._absorb([it for it in group if not it.warmup], exc)
        self._request_cycle(
            "output_corrupt" if getattr(exc, "integrity_corrupt", False) else "device_fatal")
        return True

    def note_thread_death(self, err: BaseException) -> bool:
        """The batcher's thread-death hook: a cycle revives the thread and
        replays. False once stopped (a drain): the batcher then fails its
        queue itself."""
        if self._stop_evt.is_set():
            return False
        self.thread_deaths += 1
        self._request_cycle("thread_death")
        return True

    def check(self) -> str:
        """One watchdog pass: escalate the wedge clock into a quarantine,
        then run any requested cycle. Returns the state after it."""
        if self._stop_evt.is_set():
            return self._state
        with self._lock:
            trig = self._trigger
        if trig is None and self._state == SERVING:
            age = self._safe(self.batcher.wedge_age, 0.0) or 0.0
            if age >= max(self.config.wedge_quarantine_s, 0.1):
                self.watchdog_wedge_trips += 1
                with self._lock:
                    self._trigger = trig = "wedge"
        if trig is not None:
            self.run_cycle(trig)
        return self._state

    def _request_cycle(self, trigger: str) -> None:
        with self._lock:
            if self._trigger is None:
                self._trigger = trigger
        if self._stop_evt.is_set():
            return
        if self._worker is not None and self._worker.is_alive():
            self._wake.set()
        elif self.auto_cycle:
            threading.Thread(target=self.run_cycle, args=(trigger,), name="recovery-cycle",
                             daemon=True).start()

    # --------------------------------------------------- failure absorption

    def _absorb(self, group: list, exc: BaseException | None) -> None:
        """Sort one failed (or captured) batch's live items into replay
        units: kill accounting, the poison verdict, the replay budget, the
        bisection split. Futures resolve outside the lock (done-callbacks
        re-enter the batcher). exc None: a wedge's capture."""
        cfg = self.config
        fails: list[tuple] = []
        suspect = None
        with self._lock:
            live = [it for it in group
                    if not it.future.done() and id(it) not in self._pending_ids]
            if not live:
                return
            for it in live:
                it.device_kills += 1
            kills = max(it.device_kills for it in live)
            if len(live) == 1 and exc is not None and kills >= max(cfg.poison_kills, 1):
                # The poison verdict needs an actual kill error on a solo
                # batch (a wedging device never convicts) and a live context
                # (probed below, outside the lock).
                suspect = live[0]
            else:
                keep = []
                for it in live:
                    if it.replays >= max(cfg.replay_budget, 1):
                        self.replay_budget_exhausted += 1
                        fails.append((it, exc if exc is not None else DeviceWedgedError(
                            "batch abandoned by recovery quarantine and replay budget "
                            "exhausted")))
                    else:
                        keep.append(it)
                if keep:
                    if len(keep) > 1 and kills >= max(cfg.bisect_after_kills, 1):
                        # A deterministic killer: halves, each its own unit.
                        self.bisections += 1
                        mid = (len(keep) + 1) // 2
                        for half in (keep[:mid], keep[mid:]):
                            if half:
                                self._bisect_seq += 1
                                for it in half:
                                    it.bisect_key = self._bisect_seq
                                self._stash_locked(half)
                    else:
                        self._stash_locked(keep)
        if suspect is not None:
            lost = self._probe()
            with self._lock:
                if lost is None:
                    self.poisoned_requests += 1
                    err = PoisonedInputError(
                        "poisoned input isolated by recovery bisection: this request's batch "
                        f"deterministically killed the device executor {suspect.device_kills}x "
                        f"(last failure: {type(exc).__name__}); failing it alone — do not "
                        "retry these bytes")
                    err.__cause__ = exc
                    fails.append((suspect, err))
                else:
                    # A dead context kills every batch: no verdict, the
                    # cycle's probe fails it retryably.
                    self._stash_locked([suspect])
        self._apply_fails(fails)

    def _stash_locked(self, unit: list) -> None:
        self._pending.append(unit)
        self._pending_ids.update(id(it) for it in unit)

    def _drain_pending(self) -> list[list]:
        with self._lock:
            units, self._pending = self._pending, []
            self._pending_ids.clear()
        return units

    @staticmethod
    def _apply_fails(fails: list) -> None:
        for it, err in fails:
            try:
                if not it.future.done():
                    it.future.set_exception(err)
            except InvalidStateError:
                pass

    # ------------------------------------------------------------ the cycle

    def run_cycle(self, trigger: str = "manual") -> bool:
        """One QUARANTINED -> REINIT -> REPLAY -> SERVING pass, looping
        REINIT + replay rounds until the replay drains clean (a replayed
        batch that kills the executor again refills _pending through
        take_group: that is how a bisection converges in one cycle), or
        until the probe finds the context lost (the controller then holds
        QUARANTINED). False when another cycle holds the mutex."""
        if not self._cycle_mutex.acquire(blocking=False):
            return False
        try:
            t0 = self._clock()
            with self._lock:
                trig = self._trigger or trigger
                self._trigger = None
            self.quarantines += 1
            self._enter(QUARANTINED, trigger=trig)
            lc = self._lifecycle()
            if lc is not None:
                # A rollout must not judge a canary against a dying device.
                self._safe(lambda: lc.pause())
            queued, inflight = self._safe(self.batcher.capture_for_recovery, ([], [])) or ([], [])
            if queued:
                with self._lock:
                    self._stash_locked(list(queued))
            for group in inflight:
                # In a device call when the device was declared gone: the
                # wedge is their kill evidence.
                self._absorb(group, None)
            if trig in ("wedge", "thread_death"):
                # A thread stuck in a native call cannot be preempted; the
                # workers around it can be replaced.
                self._safe(self.batcher.replace_workers_for_recovery)
            rounds = replayed = failed = 0
            poisoned_before = self.poisoned_requests
            lost = None
            while not self._stop_evt.is_set():
                rounds += 1
                self._enter(REINIT, round=rounds)
                self.reinits += 1
                self._reinit_executors()
                lost = self._probe()
                if lost is not None:
                    err = DeviceWedgedError(
                        f"device context lost ({lost}); this replica stays quarantined until "
                        "its process restarts: retry against another backend")
                    with self._lock:
                        self._trigger = None
                    for unit in self._drain_pending():
                        failed += len(unit)
                        self._apply_fails([(it, err) for it in unit])
                    break
                if getattr(self.config, "reinit_warmup", True):
                    self._rewarm(rounds)
                # Drain and clear the trigger in one lock hold: a take_group
                # stashing work between the two would be stranded.
                with self._lock:
                    units, self._pending = self._pending, []
                    self._pending_ids.clear()
                    if not units:
                        self._trigger = None
                if not units:
                    break
                self._enter(REPLAY, round=rounds, units=len(units))
                futs = []
                for unit in units:
                    for it in unit:
                        it.replays += 1
                    self.replayed_items += len(unit)
                    replayed += len(unit)
                    self._safe(lambda u=unit: self.batcher.requeue_for_replay(u))
                    futs.extend(it.future for it in unit)
                self._wait_replay(futs)
                with self._lock:
                    still_pending = bool(self._pending)
                    retriggered = self._trigger is not None
                    if not still_pending:
                        self._trigger = None
                if not still_pending:
                    if retriggered:
                        # A kill landed during this replay but resolved every
                        # item it touched (a poison verdict): one more REINIT.
                        continue
                    break
                if rounds >= max(int(self.config.max_cycle_rounds), 1):
                    err = DeviceWedgedError(
                        f"recovery gave up after {rounds} reinit/replay rounds; the device "
                        "keeps failing")
                    for unit in self._drain_pending():
                        failed += len(unit)
                        self._apply_fails([(it, err) for it in unit])
                    break
            if lc is not None and lost is None:
                self._safe(lambda: lc.resume())
            duration = self._clock() - t0
            with self._lock:
                self.cycles_completed += 1
                self._last_cycle = {
                    "trigger": trig,
                    "rounds": rounds,
                    "duration_s": round(duration, 4),
                    "replayed_items": replayed,
                    "poisoned": self.poisoned_requests - poisoned_before,
                    "gave_up_items": failed,
                }
                if lost is None:
                    self._mttr_ring.append({
                        "t": round(t0, 3), "trigger": trig, "mttr_s": round(duration, 4),
                        "rounds": rounds, "replayed_items": replayed,
                    })
                else:
                    self._last_cycle["context_lost"] = lost
                    self._context_lost = lost
            if lost is not None:
                log.error("recovery: the device context is lost (%s); holding QUARANTINED "
                          "until the process restarts", lost)
                self._enter(QUARANTINED, trigger=trig, context_lost=lost)
            else:
                self._enter(SERVING, trigger=trig, duration_s=round(duration, 4))
            return True
        finally:
            self._cycle_mutex.release()

    def _probe(self) -> str | None:
        """The context probe's verdict: None = alive."""
        if self._probe_fn is not None:
            return self._probe_fn()
        return probe_context(getattr(self.batcher, "device", None),
                             max(float(self.config.wedge_quarantine_s), 0.1))

    def _reinit_executors(self) -> None:
        """The in-process REINIT (module docstring): the device steps, the
        cross-stack weight cache and the input cache cleared, a dead thread
        revived, the allocator's cache emptied."""
        b = self.batcher
        entries = getattr(b, "_entries", None)
        if entries is not None:
            with b._entry_lock:
                entries.clear()
        self._safe(cross_kernel.cross_cache.clear)
        cache = getattr(b, "input_cache", None)
        if cache is not None:
            self._safe(cache.clear)
        self._safe(b.revive_batching_thread)
        if getattr(getattr(b, "device", None), "type", None) == "cuda":
            self._safe(torch.cuda.empty_cache)

    def _rewarm(self, round_no: int = 1) -> None:
        """Re-warm every registered servable's bucket ladder THROUGH the
        queue (_warmup=True keeps the gate, the wedge clock and the
        occupancy ledger out of it), bounded by rewarm_timeout_s and by a
        drain stopping the controller; failures log and never wedge the
        cycle. Logs the kernel launches it made."""
        reg, b = self.registry, self.batcher
        if reg is None:
            return
        try:
            names = sorted(reg.models() or {})
        except Exception:  # noqa: BLE001 — registry quirks never wedge a cycle
            return
        before = dict(cross_kernel.launches)
        t0 = time.perf_counter()
        futs = []
        for name in names:
            try:
                sv = reg.resolve(name)
            except Exception:  # noqa: BLE001 — vanished mid-cycle
                continue
            for bucket in b.buckets:
                try:
                    futs.append(b.submit(sv, b.warmup_arrays(sv, bucket), _warmup=True))
                except Exception:  # noqa: BLE001 — keep warming the rest
                    log.exception("recovery re-warm submit failed (%s/%d)", name, bucket)
        deadline = time.monotonic() + max(getattr(self.config, "rewarm_timeout_s", 120.0), 1.0)
        remaining = futs
        while remaining and not self._stop_evt.is_set():
            left = deadline - time.monotonic()
            if left <= 0:
                break
            remaining = list(fut_wait(remaining, timeout=min(left, 0.1)).not_done)
        moved = {f"{k}/{d}": n - before.get((k, d), 0)
                 for (k, d), n in sorted(cross_kernel.launches.items())
                 if n != before.get((k, d), 0)}
        log.info("recovery re-warm (round %d): %d batches in %.3f s, kernel launches %s",
                 round_no, len(futs), time.perf_counter() - t0, json.dumps(moved))

    def _wait_replay(self, futs: list) -> None:
        """Bounded wait for the replayed futures: ends early when a replayed
        batch fails device-fatally again (the next round takes it) or a
        drain stops the controller. On the wall clock, whatever the state
        machine's clock."""
        deadline = time.monotonic() + max(getattr(self.config, "replay_drain_s", 30.0), 0.0)
        remaining = list(futs)
        while remaining and not self._stop_evt.is_set():
            left = deadline - time.monotonic()
            if left <= 0:
                break
            remaining = list(fut_wait(remaining, timeout=min(left, 0.1)).not_done)
            with self._lock:
                if self._pending:
                    return

    # ------------------------------------------------------------- watchdog

    def start(self) -> "RecoveryController":
        """The background watchdog: check() every watchdog_interval_s, woken
        early by a trigger."""
        if self._worker is None or not self._worker.is_alive():
            self._stop_evt = threading.Event()
            self._worker = threading.Thread(target=self._watchdog_loop,
                                            args=(self._stop_evt, self._wake),
                                            name="recovery-watchdog", daemon=True)
            self._worker.start()
        return self

    def _watchdog_loop(self, stop_evt, wake) -> None:
        interval = max(self.config.watchdog_interval_s, 0.05)
        while not stop_evt.is_set():
            wake.wait(interval)
            wake.clear()
            if stop_evt.is_set():
                return
            try:
                self.check()
            except Exception:  # noqa: BLE001 — the watchdog must survive
                log.exception("recovery watchdog pass failed")

    def stop(self) -> None:
        self.shutdown_for_drain(2.0)

    def shutdown_for_drain(self, grace_s: float = 2.0) -> None:
        """Called by GracefulShutdown BEFORE batcher.drain(), so a SIGTERM
        during a cycle cannot hold the drain on a replay: the watchdog
        stops, the running cycle ends at its next phase boundary, and what
        is still captured fails UNAVAILABLE (this replica is leaving).
        Bounded by min(grace, 2 s)."""
        self._stop_evt.set()
        self._wake.set()
        bound = min(max(grace_s, 0.0), 2.0)
        if self._worker is not None:
            self._worker.join(timeout=bound)
            self._worker = None
        t_end = time.monotonic() + bound
        while self._cycle_mutex.locked() and time.monotonic() < t_end:
            time.sleep(0.02)
        err = DeviceWedgedError("server draining during device recovery; retry against "
                                "another backend")
        for unit in self._drain_pending():
            self._apply_fails([(it, err) for it in unit])
        with self._lock:
            self._trigger = None
        if self._state != SERVING:
            self._enter(SERVING, trigger="drain_abort")

    # ------------------------------------------------------------- plumbing

    def _lifecycle(self):
        if self.lifecycle is not None:
            return self.lifecycle
        return getattr(self.impl, "lifecycle", None)

    def _enter(self, state: str, **detail) -> None:
        now = self._clock()
        with self._lock:
            self._state = state
            self._state_since = now
            self._events.append({"t": round(now, 3), "state": state, **detail})
        log.info("recovery -> %s %s", state, detail or "")

    @staticmethod
    def _safe(fn, default=None):
        try:
            return fn()
        except Exception:  # noqa: BLE001 — a collaborator's fault must not kill a cycle
            log.exception("recovery collaborator call failed")
            return default

    # ------------------------------------------------------------- surfaces

    def _mttr_block_locked(self) -> dict:
        hist = list(self._mttr_ring)
        vals = [h["mttr_s"] for h in hist]
        return {
            "cycles": len(hist),
            "last_s": vals[-1] if vals else None,
            "mean_s": round(sum(vals) / len(vals), 4) if vals else None,
            "max_s": max(vals) if vals else None,
            "history": hist,
        }

    def snapshot(self) -> dict:
        """The /recoveryz body, the /monitoring `recovery` block and the
        source of the dts_tpu_recovery_* series: the JAX package's fields."""
        now = self._clock()
        cfg = self.config
        with self._lock:
            return {
                "enabled": True,
                "state": self._state,
                "state_age_s": round(now - self._state_since, 3),
                "pending_replay_units": len(self._pending),
                "pending_replay_items": sum(len(u) for u in self._pending),
                "counters": {
                    "quarantines": self.quarantines,
                    "reinits": self.reinits,
                    "cycles_completed": self.cycles_completed,
                    "device_failures": self.device_failures,
                    "replayed_items": self.replayed_items,
                    "replay_budget_exhausted": self.replay_budget_exhausted,
                    "poisoned_requests": self.poisoned_requests,
                    "bisections": self.bisections,
                    "watchdog_wedge_trips": self.watchdog_wedge_trips,
                    "thread_deaths": self.thread_deaths,
                },
                "last_cycle": self._last_cycle,
                "mttr": self._mttr_block_locked(),
                "events": list(self._events),
                "config": {
                    "watchdog_interval_s": cfg.watchdog_interval_s,
                    "wedge_quarantine_s": cfg.wedge_quarantine_s,
                    "replay_budget": cfg.replay_budget,
                    "poison_kills": cfg.poison_kills,
                    "bisect_after_kills": cfg.bisect_after_kills,
                    "reinit_warmup": cfg.reinit_warmup,
                    "reinit_clear_backend": cfg.reinit_clear_backend,
                    "replay_drain_s": cfg.replay_drain_s,
                    "max_cycle_rounds": cfg.max_cycle_rounds,
                },
            }
