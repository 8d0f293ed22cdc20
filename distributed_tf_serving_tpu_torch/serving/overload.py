"""Adaptive overload control and graceful degradation (the JAX package's
serving/overload.py, the same behaviour line for line): the closed loop
that replaces the batcher's fixed queue_capacity_candidates bound.

- **Self-tuning admission limit.** The batcher feeds every dispatched
  item's queue wait into a sliding window; an AIMD controller compares the
  windowed p99 against `target_queue_wait_ms` on a fixed tick: under
  target the candidate limit grows by `increase_candidates`, over it
  shrinks by `decrease_factor`, clamped to [min_limit, max_limit].
- **Doomed-work refusal.** The batcher also feeds each batch's service
  time (stage start to the readback's event); the EWMA per-candidate
  estimate prices the backlog, and a request whose remaining deadline is
  already shorter than the estimated wait is refused at submit.
- **Criticality lanes.** Each request carries a lane (metadata
  `x-dts-criticality`, default "default"); each lane may fill a fraction
  of the limit, so sheddable traffic is refused first as backlog builds
  and warmup (the probe lane) before it. Under SHED (only SHED: brownout
  keeps admitting warmup) sheddable and probe traffic are refused
  outright.
- **Pressure state machine** NOMINAL -> BROWNOUT -> SHED, advanced by
  consecutive over- or under-target ticks. Past NOMINAL the batcher
  serves score-cache and row-cache entries up to
  `stale_while_overloaded_s` past their TTL, marked degraded (trailing
  metadata `x-dts-degraded` / header `X-DTS-Degraded`) and never refilled.
- **Client pushback.** Every refusal carries a `retry-after-ms` hint
  (trailing metadata on RESOURCE_EXHAUSTED, Retry-After on HTTP 429),
  half the backlog's estimated drain time, clamped.

Deterministic: an injectable clock, no background thread (the controller
ticks from the submit path and the feeds), and the `pressure` fault site
(faults.py) that pins the state machine with no real load. Off by default
([overload] enabled = false): the batcher then reads one attribute per
submit.
"""

from __future__ import annotations

import contextvars
import dataclasses
import threading
import time
from collections import deque

from .. import faults

# Pressure states, in escalation order.
NOMINAL, BROWNOUT, SHED = "nominal", "brownout", "shed"
_STATE_ORDER = (NOMINAL, BROWNOUT, SHED)

# Criticality lanes, most- to least-important. The client sends the lane in
# gRPC/HTTP metadata (CRITICALITY_KEY); warmup/probe traffic is assigned
# PROBE by the batcher itself.
CRITICAL, DEFAULT, SHEDDABLE, PROBE = "critical", "default", "sheddable", "probe"
LANES = (CRITICAL, DEFAULT, SHEDDABLE, PROBE)

# Fraction of the current limit each lane may fill: sheddable traffic hits
# its ceiling first as backlog builds, probe/warmup first of all. A single
# request on an EMPTY queue always admits regardless (warming the largest
# bucket must never be refused by its own lane fraction on an idle server).
_LANE_FRACTION = {CRITICAL: 1.0, DEFAULT: 0.9, SHEDDABLE: 0.7, PROBE: 0.5}

# Wire metadata keys (the JAX package's: one client speaks to both servers).
CRITICALITY_KEY = "x-dts-criticality"
RETRY_AFTER_KEY = "retry-after-ms"
DEGRADED_KEY = "x-dts-degraded"


def normalize_criticality(value) -> str:
    """Map a wire criticality value onto a known lane; unknown/absent is
    DEFAULT (a typo'd criticality must not grant CRITICAL treatment — nor
    accidentally mark traffic sheddable)."""
    v = str(value or "").strip().lower()
    return v if v in LANES else DEFAULT


# --------------------------------------------------------- degraded marker
#
# The brownout stale-serve happens deep inside batcher.submit, but the
# "this response is degraded" marker must reach the TRANSPORT (trailing
# metadata / HTTP header). submit runs synchronously inside the RPC's
# thread (sync server) or coroutine task (aio/REST), so a contextvar
# carries the flag out without threading a return channel through every
# layer. Transports clear at entry and consume after success.

_DEGRADED: contextvars.ContextVar = contextvars.ContextVar(
    "dts_tpu_degraded", default=None
)

_ACTIVE = False  # fast-path gate: one bool read when no controller exists


def active() -> bool:
    return _ACTIVE


def _set_active(value: bool) -> None:
    global _ACTIVE
    _ACTIVE = value


def deactivate() -> None:
    """Clear the fast-path gate after a temporarily-armed controller is
    discarded (benches/tests that attach one for a phase, then detach).
    Server processes never call this — an armed stack stays armed for its
    lifetime; without the clear, every later request in the process keeps
    paying the metadata scans the gate exists to skip."""
    _set_active(False)


def mark_degraded(kind: str = "stale") -> None:
    _DEGRADED.set(kind)


def consume_degraded():
    """Read-and-clear the current request's degraded marker (None when the
    response is a full-fidelity answer)."""
    value = _DEGRADED.get()
    if value is not None:
        _DEGRADED.set(None)
    return value


# ------------------------------------------------------------- controller


@dataclasses.dataclass(frozen=True)
class Decision:
    """One admit() outcome. When refused, `reason` is "shed" (capacity /
    lane pressure) or "doomed" (estimated wait exceeds the request's
    remaining deadline budget) and `retry_after_ms` is the pushback hint
    the RPC layer forwards in trailing metadata."""

    admitted: bool
    reason: str | None = None
    message: str = ""
    retry_after_ms: int | None = None


class AdmissionController:
    """The closed loop: windowed queue-wait p99 vs. target drives an AIMD
    candidate limit; EWMA per-candidate service time prices the backlog
    for doomed-work refusal and retry-after hints; consecutive over/under
    ticks drive the NOMINAL/BROWNOUT/SHED pressure state.

    Thread-safe; everything rides one small lock (admission is already
    serialized under the batcher's condition variable, and the feed paths
    are the batcher's own threads). No background thread: `admit` and the
    note_* feeds tick the controller when `adjust_interval_s` elapsed, so
    a fake clock makes every trajectory deterministic under test.
    """

    # Bounded sample memory: at most this many queue-wait samples are held
    # regardless of traffic rate (~100 KB; the p99 of a 4096-sample window
    # is plenty stable for a control loop).
    MAX_WAIT_SAMPLES = 4096

    def __init__(self, cfg, clock=time.monotonic):
        self.cfg = cfg
        self._clock = clock
        self._lock = threading.Lock()
        # Limits resolve in bind() (the batcher knows the bucket ladder);
        # until then a conservative default keeps a detached controller
        # (unit tests) usable.
        self._min = max(int(getattr(cfg, "min_limit_candidates", 0)) or 1, 1)
        self._max = max(int(getattr(cfg, "max_limit_candidates", 0)) or self._min, self._min)
        self.limit = self._max
        self._bound = False
        self._ewma_per_cand_s: float | None = None
        # Window entries are (t, wait_s, over_target); the running
        # over-target count makes the tick's "is p99 over target?" test
        # O(1) — admit() runs under the batcher's condition variable, so
        # the tick must never sort the window there (the exact numeric
        # p99 is only computed lazily, in snapshot(), for telemetry).
        self._waits: deque = deque()
        self._over_count = 0
        self._last_tick = clock()
        self._state = NOMINAL
        self._over = 0
        self._under = 0
        # Telemetry (names are the acceptance-criteria vocabulary).
        self.queue_wait_p99_ms = 0.0
        self.admitted = 0
        self.sheds = 0
        self.sheds_by_lane = {lane: 0 for lane in LANES}
        self.doomed_refusals = 0
        self.brownout_serves = 0
        self.limit_increases = 0
        self.limit_decreases = 0
        self.state_changes = 0
        self.ticks = 0
        _set_active(True)

    # -------------------------------------------------------------- wiring

    def bind(self, largest_bucket: int, queue_capacity: int) -> None:
        """Resolve the auto (0) limit knobs against the batcher's actual
        geometry: min defaults to one largest bucket (a full-size request
        must always admit on an idle queue), max to the static capacity
        the controller replaces (never looser than the operator's old
        bound), and the limit STARTS at max — the controller only ratchets
        down from observed queue wait, so an unloaded server behaves
        exactly like the static bound until pressure teaches it better."""
        with self._lock:
            cfg = self.cfg
            self._min = int(getattr(cfg, "min_limit_candidates", 0)) or largest_bucket
            self._max = int(getattr(cfg, "max_limit_candidates", 0)) or max(
                queue_capacity, self._min
            )
            self._max = max(self._max, self._min)
            self.limit = self._max
            self._bound = True

    @property
    def min_limit(self) -> int:
        return self._min

    @property
    def max_limit(self) -> int:
        return self._max

    # --------------------------------------------------------------- feeds

    def note_queue_wait(self, wait_s: float) -> None:
        with self._lock:
            self._note_wait_locked(wait_s)

    def note_queue_waits(self, waits_s) -> None:
        """Batch form: one lock acquisition for a whole dispatch group."""
        with self._lock:
            for w in waits_s:
                self._note_wait_locked(w)

    def _note_wait_locked(self, wait_s: float) -> None:
        wait_s = float(wait_s)
        over = wait_s * 1e3 > float(self.cfg.target_queue_wait_ms)
        self._waits.append((self._clock(), wait_s, over))
        if over:
            self._over_count += 1
        while len(self._waits) > self.MAX_WAIT_SAMPLES:
            self._pop_oldest_locked()

    def _pop_oldest_locked(self) -> None:
        _, _, was_over = self._waits.popleft()
        if was_over:
            self._over_count -= 1

    def _prune_window_locked(self, now: float) -> None:
        horizon = now - float(getattr(self.cfg, "queue_wait_window_s", 10.0))
        while self._waits and self._waits[0][0] < horizon:
            self._pop_oldest_locked()

    def note_batch(self, candidates: int, service_s: float) -> None:
        """One completed batch's device-stage wall time (dispatch start ->
        readback done). Feeds the EWMA per-candidate service time that
        prices backlogs; overlapped pipeline batches make it a slightly
        conservative (high) estimate, which errs toward refusing doomed
        work early rather than queueing it."""
        if candidates <= 0 or service_s < 0:
            return
        per = service_s / candidates
        alpha = float(getattr(self.cfg, "service_ewma_alpha", 0.2))
        with self._lock:
            self._ewma_per_cand_s = (
                per
                if self._ewma_per_cand_s is None
                else (1 - alpha) * self._ewma_per_cand_s + alpha * per
            )
            self._maybe_tick_locked(self._clock())

    def note_brownout_serve(self) -> None:
        with self._lock:
            self.brownout_serves += 1

    # ---------------------------------------------------------- controller

    def _queue_wait_p99_locked(self, now: float) -> float:
        """Exact windowed p99 — telemetry only (snapshot()). The tick's
        control decision uses the O(1) over-target count instead; this
        sort must stay off the admission path, which runs under the
        batcher's condition variable."""
        self._prune_window_locked(now)
        if not self._waits:
            return 0.0
        vals = sorted(w for _, w, _ in self._waits)
        return vals[min(int(len(vals) * 0.99), len(vals) - 1)]

    def _enter_locked(self, state: str) -> None:
        if state != self._state:
            self._state = state
            self.state_changes += 1
            # Each transition re-earns the next one: shed_after_intervals /
            # recover_after_intervals count ticks AFTER the last change
            # (the documented "further ticks" semantics), not cumulatively
            # from NOMINAL.
            self._over = self._under = 0

    def _maybe_tick_locked(self, now: float) -> None:
        cfg = self.cfg
        if now - self._last_tick < float(getattr(cfg, "adjust_interval_s", 0.5)):
            return
        self._last_tick = now
        self.ticks += 1
        # Deterministic test hook: a `pressure` fault rule whose code names
        # a state ("BROWNOUT"/"SHED"/"NOMINAL") pins the machine there for
        # as long as the rule fires — no real load required.
        if faults.active():
            try:
                faults.fire("pressure")
            except faults.InjectedFaultError as e:
                forced = e.code_name.lower()
                if forced in _STATE_ORDER:
                    self._enter_locked(forced)
                    self._over = self._under = 0
                    return
        # "p99 over target" without sorting: the windowed p99 exceeds the
        # target iff at least (n - p99_index) samples individually do, and
        # the over-target count is maintained incrementally — the tick is
        # O(1) beyond amortized window pruning, cheap enough to run under
        # the batcher's condition variable (admit()'s caller).
        self._prune_window_locked(now)
        n = len(self._waits)
        over = False
        if n:
            over = self._over_count >= n - min(int(n * 0.99), n - 1)
        if over:
            self._over += 1
            self._under = 0
            shrunk = max(int(self.limit * float(cfg.decrease_factor)), self._min)
            if shrunk < self.limit:
                self.limit = shrunk
                self.limit_decreases += 1
        else:
            self._under += 1
            self._over = 0
            if self.limit < self._max:
                self.limit = min(
                    self.limit + int(cfg.increase_candidates), self._max
                )
                self.limit_increases += 1
        if self._state == NOMINAL:
            if self._over >= int(cfg.brownout_after_intervals):
                self._enter_locked(BROWNOUT)
        elif self._state == BROWNOUT:
            if self._over >= int(cfg.shed_after_intervals):
                self._enter_locked(SHED)
        if self._state != NOMINAL and self._under >= int(
            cfg.recover_after_intervals
        ):
            self._enter_locked(
                _STATE_ORDER[_STATE_ORDER.index(self._state) - 1]
            )

    def _retry_after_ms_locked(self, backlog: int) -> int:
        """Pushback hint: roughly half the backlog's estimated drain time —
        retries arriving as the queue crosses back under the limit, not
        after it fully empties (which would waste the freed capacity)."""
        per = self._ewma_per_cand_s if self._ewma_per_cand_s is not None else 1e-4
        ms = backlog * per * 1e3 / 2
        floor = int(getattr(self.cfg, "retry_after_floor_ms", 25))
        cap = int(getattr(self.cfg, "retry_after_cap_ms", 2000))
        return int(min(max(ms, floor), cap))

    # ----------------------------------------------------------- admission

    def admit(
        self,
        n: int,
        backlog: int,
        lane: str = DEFAULT,
        deadline_s: float | None = None,
    ) -> Decision:
        """Admission verdict for `n` candidates against `backlog` already
        queued+staged. Called by the batcher under its own lock (the
        reservation the caller makes on admit keeps concurrent submits
        from overshooting, exactly like the static bound it replaces)."""
        lane = lane if lane in _LANE_FRACTION else DEFAULT
        with self._lock:
            self._maybe_tick_locked(self._clock())
            state = self._state
            # Only full SHED refuses probe/sheddable outright. Brownout
            # must NOT: version-rollout warmup rides the probe lane
            # (warmup_via_queue), and a server sitting in brownout for
            # minutes would fail every hot-load attempt until the watcher
            # blacklists the new version — during exactly the overload a
            # rollout may be trying to fix. In brownout, probe traffic is
            # instead squeezed by its (lowest) lane fraction below.
            if state == SHED and lane in (PROBE, SHEDDABLE):
                return self._refuse_locked(
                    lane, "shed", self._retry_after_ms_locked(backlog),
                    f"{lane} traffic refused under shed pressure",
                )
            # Doomed-work refusal: if the backlog's estimated wait already
            # exceeds the request's remaining budget, queueing it only
            # manufactures a future DEADLINE_EXCEEDED that still costs a
            # dispatch slot to shed.
            if (
                bool(getattr(self.cfg, "deadline_refusal", True))
                and deadline_s is not None
                and backlog > 0
                and self._ewma_per_cand_s is not None
            ):
                est = backlog * self._ewma_per_cand_s
                if est > deadline_s:
                    self.doomed_refusals += 1
                    return self._refuse_locked(
                        lane, "doomed", self._retry_after_ms_locked(backlog),
                        f"estimated queue wait {est * 1e3:.0f}ms exceeds "
                        f"remaining deadline {deadline_s * 1e3:.0f}ms "
                        f"(backlog {backlog} candidates); refusing doomed "
                        "work at enqueue",
                    )
            # Lane-capped capacity. A request landing on an EMPTY queue is
            # always admitted: the lane fraction exists to decide who eats
            # the backlog, not to refuse work an idle device could start
            # immediately.
            cap = int(self.limit * _LANE_FRACTION[lane])
            if backlog > 0 and backlog + n > cap:
                return self._refuse_locked(
                    lane, "shed", self._retry_after_ms_locked(backlog),
                    f"queue holds {backlog} candidates; admitting {n} more "
                    f"would exceed the {lane}-lane limit {cap} "
                    f"(adaptive limit {self.limit})",
                )
            self.admitted += 1
            return Decision(admitted=True)

    def _refuse_locked(
        self, lane: str, reason: str, hint: int, message: str
    ) -> Decision:
        self.sheds += 1
        self.sheds_by_lane[lane] += 1
        return Decision(
            admitted=False, reason=reason, retry_after_ms=hint, message=message
        )

    # ----------------------------------------------------------- observers

    def state(self) -> str:
        with self._lock:
            self._maybe_tick_locked(self._clock())
            return self._state

    def stale_serve_active(self) -> bool:
        """True when brownout stale-serving applies: pressure is past
        NOMINAL and a stale window is configured. Called per submit when a
        cache is armed — INCLUDING on fresh cache hits, which makes this
        the tick that lets pressure recover under cache-hit-only traffic
        (hits bypass admit(), and an idle device dispatches no batches, so
        nothing else would ever advance the state machine: without this
        tick a controller left in BROWNOUT would keep answering expired
        hot keys stale+degraded for the whole stale window while the
        device sits idle). Fast path is a lock-free interval check; the
        tick itself is O(1)."""
        now = self._clock()
        if now - self._last_tick >= float(
            getattr(self.cfg, "adjust_interval_s", 0.5)
        ):
            with self._lock:
                self._maybe_tick_locked(now)
        return (
            self._state != NOMINAL
            and float(getattr(self.cfg, "stale_while_overloaded_s", 0.0)) > 0
        )

    @property
    def stale_window_s(self) -> float:
        return float(getattr(self.cfg, "stale_while_overloaded_s", 0.0))

    def snapshot(self) -> dict:
        with self._lock:
            # Tick + recompute the exact p99 here so /monitoring and the
            # Prometheus series never report a pressure state or p99 that
            # went stale because no admission-path traffic is ticking the
            # controller (idle server, cache-hit-only load).
            now = self._clock()
            self._maybe_tick_locked(now)
            self.queue_wait_p99_ms = self._queue_wait_p99_locked(now) * 1e3
            return {
                "enabled": True,
                "state": self._state,
                "limit": self.limit,
                "min_limit": self._min,
                "max_limit": self._max,
                "target_queue_wait_ms": float(self.cfg.target_queue_wait_ms),
                "queue_wait_p99_ms": round(self.queue_wait_p99_ms, 3),
                "ewma_service_us_per_candidate": (
                    round(self._ewma_per_cand_s * 1e6, 3)
                    if self._ewma_per_cand_s is not None
                    else None
                ),
                "admitted": self.admitted,
                "sheds": self.sheds,
                "sheds_by_lane": dict(self.sheds_by_lane),
                "doomed_refusals": self.doomed_refusals,
                "brownout_serves": self.brownout_serves,
                "limit_increases": self.limit_increases,
                "limit_decreases": self.limit_decreases,
                "state_changes": self.state_changes,
                "ticks": self.ticks,
            }
