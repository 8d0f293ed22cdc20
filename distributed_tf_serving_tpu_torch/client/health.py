"""Per-backend health scoreboard — health-aware shard placement + failover.

The reference printed a failed shard and dropped it (DCNClient.java:158-159);
a blind failover rotates to the next host — a wedged backend then
costs a full timeout per shard attempt, every request, until someone
restarts it. Production fan-out serving ("Scaling TensorFlow to 300 million
predictions per second") routes AROUND sick backends instead:

- **EWMA latency** per backend (observability + the hedge-target ranking);
- **consecutive-failure ejection**: after `failure_threshold` consecutive
  reroutable failures the backend is ejected for `ejection_s` (doubling per
  repeat up to `max_ejection_s`);
- **half-open probing**: once the ejection interval passes, exactly ONE
  in-flight request (or an explicit grpc.health.v1 Check, see
  client.ShardedPredictClient.health_probe) is allowed through; success
  recovers the backend, failure re-ejects it with a doubled interval;
- **pushback is "busy", not "dead"** (overload plane, serving/overload.py):
  a RESOURCE_EXHAUSTED shed is recorded with kind="pushback" — it proves
  the backend ALIVE (it answered), so it never consumes the consecutive-
  failure ejection budget. Instead the host is marked busy for the
  server's retry-after hint (or a configured default): steering prefers
  non-busy healthy hosts and hedges never target a busy one. Without this
  distinction a healthy-but-shedding backend gets ejected and its traffic
  piles onto the remaining hosts, overloading them next — the ejection
  cascade that turns one hot host into a fleet-wide brownout.

The scoreboard only STEERS (pick()); the client still owns retry/hedge
mechanics. Pure in-process bookkeeping: one lock, an injectable clock so
the ejection/half-open timeline is deterministic under test.
"""

from __future__ import annotations

import dataclasses
import threading
import time

HEALTHY, EJECTED, HALF_OPEN = "healthy", "ejected", "half_open"
# Draining: the host ANNOUNCED it is leaving
# (GracefulShutdown refusal detail / NOT_SERVING-with-reason health
# answer). Distinct from EJECTED (no ejection budget was spent, no
# doubling) and from the rebuilding busy-bias (a drain is not coming
# back within an MTTR): steering skips the host entirely until
# draining_probe_s passes, then half-open probing lets a RESTARTED
# process on the same address rejoin.
DRAINING = "draining"


@dataclasses.dataclass(frozen=True)
class ScoreboardConfig:
    # Consecutive reroutable failures before ejection. 1 would eject on any
    # single blip; 3 tolerates isolated packet-loss-shaped noise while still
    # reacting within one request burst to a genuinely down backend.
    failure_threshold: int = 3
    # First ejection interval; doubles on each half-open probe failure.
    ejection_s: float = 5.0
    max_ejection_s: float = 60.0
    # EWMA smoothing for per-backend latency (0 < alpha <= 1).
    ewma_alpha: float = 0.2
    # How long a pushback (kind="pushback" failure — an overload shed)
    # biases steering away from the busy host when the server sent no
    # retry-after hint. Short on purpose: overload drains in queue-wait
    # units, not ejection units.
    pushback_busy_s: float = 0.25
    # How long a rebuilding hint (kind="rebuilding" — a quarantined
    # replica's UNAVAILABLE refusal or a NOT_SERVING health answer
    # during its recovery cycle) biases steering away. Sized to the
    # measured recovery MTTR (~1-4s): long enough to skip the rebuild,
    # short enough that the recovered replica gets traffic back without
    # waiting out an ejection window it never earned.
    rebuilding_busy_s: float = 2.0
    # CONSECUTIVE rebuilding hints (no intervening success) a host may
    # accumulate before further ones count as ordinary failures again.
    # A genuine recovery cycle resolves within its MTTR — one or two
    # hints; a DRAINING replica (health also answers NOT_SERVING while
    # leaving) or a replica stuck in endless quarantine would otherwise
    # cycle healthy-busy forever with the ejection backoff zeroed each
    # round. Past the streak, the normal eject-with-doubling machinery
    # takes over.
    rebuilding_streak_limit: int = 3
    # How long a DRAINING host (kind="draining" — the backend announced
    # a graceful shutdown) is held out of steering before half-open
    # probing checks whether a restarted process took over the address.
    # Unlike the rebuilding window this is not an MTTR estimate — a
    # draining replica is leaving — it is the probe cadence for the
    # replacement process. Never consumes the ejection budget and never
    # cycles the rebuilding_busy_s retry window.
    draining_probe_s: float = 3.0
    # How long a corrupt-response verdict (kind="corrupt" — the
    # integrity plane's CRC verify caught a response whose score bytes
    # mismatch their stamped checksum) biases steering away.
    # Sized to the server's own shadow-verification / recovery reaction
    # window: long enough for the replica's self-check to run, short
    # enough that one cosmic-ray flip does not exile a healthy host.
    corrupt_busy_s: float = 2.0
    # CONSECUTIVE corrupt verdicts (no intervening clean success) before
    # further ones count as ordinary failures: a single flipped bit is
    # noise, a host that keeps serving mismatched bytes has a sick data
    # path and must walk the eject-with-doubling machinery — but never
    # on the first hit (the integrity contract).
    corrupt_streak_limit: int = 3


@dataclasses.dataclass
class _HostState:
    state: str = HEALTHY
    consecutive_failures: int = 0
    ejected_until: float = 0.0
    current_ejection_s: float = 0.0
    probe_inflight: bool = False
    ewma_ms: float | None = None
    successes: int = 0
    failures: int = 0
    # Overload pushback: the host is alive but shedding. Steering prefers
    # other healthy hosts until busy_until passes; the ejection machinery
    # never sees these.
    pushbacks: int = 0
    busy_until: float = 0.0
    # Recovery-plane rebuilds announced by the host itself: alive,
    # answering, temporarily refusing — shares the
    # busy_until steering bias, never the ejection budget. The
    # consecutive streak (reset by any success) bounds how long the
    # hint can defer ejection — see rebuilding_streak_limit.
    rebuilds: int = 0
    consecutive_rebuilds: int = 0
    # Drain hints: the host said it is shutting
    # down. State flips to DRAINING — skipped by steering outright —
    # with no ejection budget spent and no rebuilding streak cycled.
    drains: int = 0
    # Corrupt-response verdicts: the host ANSWERED but its
    # score bytes failed the integrity CRC verify. Busy-biased steering
    # like pushback; the consecutive streak (reset by any clean
    # success) bounds how long before ordinary ejection takes over.
    corruptions: int = 0
    consecutive_corruptions: int = 0


class BackendScoreboard:
    """Thread-safe (asyncio callbacks + any direct callers) per-backend
    scoreboard over a FIXED host list, indexed like the client's."""

    def __init__(
        self,
        hosts: list[str],
        config: ScoreboardConfig | None = None,
        clock=time.monotonic,
    ):
        if not hosts:
            raise ValueError("need at least one backend host")
        self.hosts = list(hosts)
        self.config = config or ScoreboardConfig()
        self._clock = clock
        self._lock = threading.Lock()
        self._states = [_HostState() for _ in self.hosts]
        # Event counters (load harnesses report them; names are the
        # acceptance-criteria vocabulary).
        self.ejections = 0
        self.probes = 0
        self.recoveries = 0
        self.pushbacks = 0
        # Rebuilding hints: quarantine refusals /
        # NOT_SERVING health answers recorded as kind="rebuilding".
        self.rebuilds = 0
        # Drain hints: "server is draining" refusals
        # / NOT_SERVING-while-draining health answers recorded as
        # kind="draining" — steered away from immediately, no ejection
        # budget spent, no rebuilding retry window cycled.
        self.drains = 0
        # Retry-budget trips: requests whose per-request
        # attempt cap (client max_attempts_total) ran dry — the
        # storm-suppression evidence next to the ejection counters it
        # guards against amplifying.
        self.retry_budget_exhausted = 0
        # Corrupt-response verdicts: integrity CRC verify
        # failures recorded as kind="corrupt" — busy-biased steering,
        # never ejection on the first hit.
        self.corruptions = 0

    # ------------------------------------------------------------ recording

    def record_success(self, idx: int, latency_s: float | None = None) -> None:
        with self._lock:
            st = self._states[idx]
            st.successes += 1
            st.consecutive_failures = 0
            st.consecutive_rebuilds = 0
            st.consecutive_corruptions = 0
            if latency_s is not None:
                ms = latency_s * 1e3
                a = self.config.ewma_alpha
                st.ewma_ms = ms if st.ewma_ms is None else (1 - a) * st.ewma_ms + a * ms
            if st.state != HEALTHY:
                # Half-open probe succeeded (or a raced request landed while
                # ejected): the backend is back.
                st.state = HEALTHY
                st.probe_inflight = False
                st.current_ejection_s = 0.0
                self.recoveries += 1

    def record_failure(
        self, idx: int, kind: str = "failure",
        retry_after_s: float | None = None,
    ) -> None:
        """One failed attempt on backend `idx`.

        kind="failure" (default): a reroutable failure — the backend may be
        dead; counts toward the consecutive-failure ejection budget.
        kind="rebuilding": the backend itself announced a recovery-cycle
        rebuild (a quarantine UNAVAILABLE refusal, or NOT_SERVING from
        its health service mid-cycle) — it is provably alive and will be
        back within its MTTR, so it is marked busy for rebuilding_busy_s
        (or the caller-provided window) and steered around WITHOUT
        touching the ejection budget; exactly the
        pushback-is-not-death pattern applied below the RPC layer.
        kind="pushback": an overload shed (RESOURCE_EXHAUSTED with the
        serving stack's retry-after hint) — the backend ANSWERED, so it is
        provably alive; it is marked busy for `retry_after_s` (or the
        configured pushback_busy_s) and steered around, but the ejection
        budget is untouched. A pushback landing on a half-open/ejected
        host is the probe succeeding at being alive: the host recovers to
        HEALTHY (busy) instead of re-ejecting with a doubled interval —
        without this, a fleet-wide overload turns into a fleet-wide
        ejection cascade and the survivors inherit ALL the traffic.
        kind="draining": the backend announced a graceful shutdown (the
        drain refusal detail, a NOT_SERVING health answer carrying the
        draining reason, or a fleet gossip record) — it is leaving, not
        recovering, so it flips to the DRAINING state: steering skips it
        outright from the FIRST hint (zero further routed requests while
        an alternative exists), the ejection budget is untouched, and
        the rebuilding busy window is never cycled. After
        draining_probe_s, half-open probing checks whether a restarted
        process took over the address.
        kind="corrupt": the backend ANSWERED but its response failed the
        integrity plane's CRC verify — alive with a suspect
        data path. Busy-biased steering for corrupt_busy_s (the
        pushback pattern: NEVER ejection on the first hit — one flipped
        bit must not exile a healthy host), while the consecutive
        streak (reset by any clean success) hands a host that KEEPS
        serving mismatched bytes to the ordinary eject-with-doubling
        machinery past corrupt_streak_limit."""
        with self._lock:
            st = self._states[idx]
            if kind == "draining":
                st.drains += 1
                self.drains += 1
                st.consecutive_failures = 0
                st.consecutive_rebuilds = 0
                st.state = DRAINING
                st.probe_inflight = False
                st.current_ejection_s = 0.0
                # Reuse the ejected_until timeline for the probe-again
                # horizon; repeated hints extend it (the replica is still
                # announcing its exit).
                st.ejected_until = self._clock() + self.config.draining_probe_s
                return
            if kind == "rebuilding" and \
                    st.consecutive_rebuilds >= self.config.rebuilding_streak_limit:
                # The host has announced "rebuilding" this many times in a
                # row without once answering a request: that is a draining
                # replica (its health also reads NOT_SERVING) or a
                # quarantine loop, not a bounded recovery cycle. Fall
                # through to the ordinary failure path so the
                # eject-with-doubling machinery bounds further probing.
                kind = "failure"
            if kind == "rebuilding":
                st.rebuilds += 1
                st.consecutive_rebuilds += 1
                self.rebuilds += 1
                busy = (
                    retry_after_s if retry_after_s is not None
                    else self.config.rebuilding_busy_s
                )
                st.busy_until = max(st.busy_until, self._clock() + busy)
                # The refusal PROVES the host answers (same reasoning as
                # the pushback branch): the failure streak is over, and
                # an ejected/half-open host that announced its rebuild
                # recovers to HEALTHY (busy) instead of re-ejecting with
                # a doubled interval.
                st.consecutive_failures = 0
                if st.state != HEALTHY:
                    st.state = HEALTHY
                    st.probe_inflight = False
                    st.current_ejection_s = 0.0
                    self.recoveries += 1
                return
            if kind == "corrupt":
                if st.consecutive_corruptions >= \
                        self.config.corrupt_streak_limit:
                    # The host keeps serving bytes that fail the CRC
                    # verify with no clean answer in between: a sick
                    # data path, not a cosmic ray. Fall through to the
                    # ordinary failure path so eject-with-doubling
                    # bounds further exposure.
                    kind = "failure"
                else:
                    st.corruptions += 1
                    st.consecutive_corruptions += 1
                    self.corruptions += 1
                    busy = (
                        retry_after_s if retry_after_s is not None
                        else self.config.corrupt_busy_s
                    )
                    st.busy_until = max(st.busy_until, self._clock() + busy)
                    # The mismatched answer still PROVES the host
                    # answers: the failure streak is over, and an
                    # ejected/half-open host recovers to HEALTHY (busy)
                    # — the integrity verdict steers, the ejection
                    # machinery only takes over past the streak limit.
                    st.consecutive_failures = 0
                    if st.state != HEALTHY:
                        st.state = HEALTHY
                        st.probe_inflight = False
                        st.current_ejection_s = 0.0
                        self.recoveries += 1
                    return
            if kind == "pushback":
                st.pushbacks += 1
                self.pushbacks += 1
                busy = (
                    retry_after_s
                    if retry_after_s is not None
                    else self.config.pushback_busy_s
                )
                st.busy_until = max(st.busy_until, self._clock() + busy)
                # A pushback PROVES the host answers, exactly like a
                # success does: the consecutive-failure streak is over.
                # Leaving it at/above the threshold would let ONE later
                # transient failure instantly re-eject a host that just
                # demonstrated it is alive — a hair-trigger version of the
                # very cascade this kind= split exists to prevent.
                st.consecutive_failures = 0
                if st.state != HEALTHY:
                    # Alive-but-busy beats ejected: recover, keep the bias.
                    st.state = HEALTHY
                    st.probe_inflight = False
                    st.current_ejection_s = 0.0
                    self.recoveries += 1
                return
            st.failures += 1
            st.consecutive_failures += 1
            if st.state == HALF_OPEN:
                # Probe failed: re-eject with a doubled interval.
                self._eject_locked(st, double=True)
            elif (
                st.state == HEALTHY
                and st.consecutive_failures >= self.config.failure_threshold
            ):
                self._eject_locked(st, double=False)
            elif st.state == EJECTED:
                st.probe_inflight = False  # raced request while ejected

    def _eject_locked(self, st: _HostState, double: bool) -> None:
        interval = (
            min(st.current_ejection_s * 2, self.config.max_ejection_s)
            if double and st.current_ejection_s
            else self.config.ejection_s
        )
        st.state = EJECTED
        st.current_ejection_s = interval
        st.ejected_until = self._clock() + interval
        st.probe_inflight = False
        self.ejections += 1

    # ------------------------------------------------------------- steering

    def _advance_locked(self, st: _HostState) -> None:
        if (
            st.state in (EJECTED, DRAINING)
            and self._clock() >= st.ejected_until
        ):
            st.state = HALF_OPEN
            st.probe_inflight = False

    def pick(self, preferred: int, exclude: tuple[int, ...] = ()) -> int | None:
        """Backend index for a shard homed at `preferred`: the home host
        when healthy — or HALF_OPEN with a free probe slot (the caller's
        request IS the probe; without home-priority a half-open host would
        be starved of probes forever while its healthy peers absorb the
        rotation, and never recover) — else the first HEALTHY host rotating
        from `preferred`, else any half-open host with a free slot, else —
        everything ejected — the rotation's first non-excluded host
        (sending somewhere beats failing without trying). None only when
        every host is excluded (failover exhausted the list).

        Pushback bias: among HEALTHY hosts, one the overload plane marked
        busy (a recent RESOURCE_EXHAUSTED shed) is passed over while a
        non-busy healthy peer exists — but when EVERY healthy host is
        busy the rotation applies unchanged (spreading load across busy
        hosts beats refusing to send)."""
        n = len(self.hosts)
        order = [(preferred + k) % n for k in range(n) if (preferred + k) % n not in exclude]
        if not order:
            return None
        with self._lock:
            now = self._clock()
            for i in order:
                self._advance_locked(self._states[i])
            home = self._states[order[0]]
            if (
                order[0] == preferred % n
                and home.state == HALF_OPEN
                and not home.probe_inflight
            ):
                home.probe_inflight = True
                self.probes += 1
                return order[0]
            for i in order:
                st = self._states[i]
                if st.state == HEALTHY and st.busy_until <= now:
                    return i
            for i in order:
                if self._states[i].state == HEALTHY:
                    return i  # every healthy host busy: rotation order
            for i in order:
                st = self._states[i]
                if st.state == HALF_OPEN and not st.probe_inflight:
                    st.probe_inflight = True
                    self.probes += 1
                    return i
            return order[0]

    def state(self, idx: int) -> str:
        with self._lock:
            self._advance_locked(self._states[idx])
            return self._states[idx].state

    def note_retry_budget_exhausted(self) -> None:
        """One request's attempt budget ran out (client retry-budget
        satellite): counted here so the scoreboard snapshot — the
        resilience surface load harnesses already read — carries it."""
        with self._lock:
            self.retry_budget_exhausted += 1

    def release_probe(self, idx: int) -> None:
        """Free a half-open probe slot whose request was CANCELLED (hedge
        loser) — neither success nor failure was observed, so the slot must
        not stay taken forever and starve future probes."""
        with self._lock:
            self._states[idx].probe_inflight = False

    def hedge_target(self, exclude: tuple[int, ...]) -> int | None:
        """Best extra host for a hedged attempt: healthy, lowest EWMA,
        not already in use. None = nowhere sensible to hedge. A host the
        overload plane marked busy is never hedged into — a hedge is
        OPTIONAL duplicate work, exactly what a shedding backend asked
        not to receive."""
        with self._lock:
            now = self._clock()
            best, best_ms = None, None
            for i, st in enumerate(self._states):
                if i in exclude:
                    continue
                self._advance_locked(st)
                if st.state != HEALTHY or st.busy_until > now:
                    continue
                ms = st.ewma_ms if st.ewma_ms is not None else float("inf")
                if best is None or ms < best_ms:
                    best, best_ms = i, ms
            return best

    # ---------------------------------------------------------- observation

    def snapshot(self) -> dict:
        with self._lock:
            now = self._clock()
            return {
                "ejections": self.ejections,
                "probes": self.probes,
                "recoveries": self.recoveries,
                "pushbacks": self.pushbacks,
                "rebuilds": self.rebuilds,
                "drains": self.drains,
                "corruptions": self.corruptions,
                "retry_budget_exhausted": self.retry_budget_exhausted,
                "backends": {
                    host: {
                        "state": st.state,
                        "ewma_ms": round(st.ewma_ms, 3) if st.ewma_ms is not None else None,
                        "consecutive_failures": st.consecutive_failures,
                        "successes": st.successes,
                        "failures": st.failures,
                        "pushbacks": st.pushbacks,
                        "rebuilds": st.rebuilds,
                        "drains": st.drains,
                        "corruptions": st.corruptions,
                        "busy": st.busy_until > now,
                    }
                    for host, st in zip(self.hosts, self._states)
                },
            }
