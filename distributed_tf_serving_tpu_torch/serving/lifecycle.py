"""Continuous-freshness lifecycle plane: online fine-tune publish, canary
admission, drift / AUC auto-rollback.

The serving process closes the loop train -> publish -> canary -> promote |
rollback itself, from pieces the stack already has: the trainer and
checkpoints (train/), atomic versioned publish (interop/export.py
publish_version), hot-swap under traffic (serving/version_watcher.py), the
probe criticality lane (serving/overload.py) and the quality plane's live
version-pair PSI / JS drift and label-feedback AUC (serving/quality.py).
One controller object, three parts:

- **Fine-tune publisher**: with `[lifecycle] fine_tune_interval_s > 0`
  and the controller IDLE, the background loop fine-tunes the CURRENT
  stable servable on fresh labeled rows (train/publisher.py: torch
  autograd on the servable's device, the synthetic stream by default) and
  lands the result in the watched base dir as the next numeric version
  through the tmp-dir + rename commit, so the watcher never sees a
  half-written dir. Versions published from outside through the same
  helper are treated the same way.

- **Canary admission**: when the watcher hot-loads a NEWER version beside
  the stable one, the controller enters CANARY and takes over DEFAULT
  version resolution (a request that pins a version or a label is never
  touched): probe-lane traffic (x-dts-criticality: probe) routes to the
  canary at once, then a time-driven ramp sends a deterministic share of
  default-lane traffic after it. A routed request runs under its
  version's own servable, so the quality plane's per-(model, version)
  sketches, and its version-pair drift, see real paired traffic.

- **Auto-rollback / promotion**: a tick loop (injectable clock; the
  background thread is optional, tests drive `tick()`) reads the quality
  plane's pair drift between the stable and canary windows and the
  per-version label AUC. A canary past `rollback_psi`, or losing at least
  `rollback_auc_drop` of AUC, is rolled back: routing drains at once and
  the watcher retires it AND blacklists it, so the next reconcile pass
  cannot reload it from disk. A canary that holds through the ramp for
  `promote_after_s` at the ceiling is promoted: the routing override
  drops and the registry's latest-version default serves it to everyone.

State machine: IDLE -> CANARY -> PROMOTING -> IDLE, and CANARY ->
ROLLED_BACK -> IDLE on regression. Surfaces: GET /lifecyclez, POST
/lifecyclez/rollback, a `lifecycle` block in /monitoring and the
dts_tpu_lifecycle_* series. Off by default ([lifecycle] enabled /
--lifecycle); off, a resolution reads one attribute.

Routing, ticks and the surfaces need no device; only the fine-tune
publisher (train/publisher.py, imported when it runs) does. The recovery
plane (serving/recovery.py) calls `pause` / `resume` around a cycle.
The fleet plane (fleet/replica.py) drives `set_fleet_fraction` and
`fleet_blacklist` from the rollout state it follows, and gossips
`fleet_record`.
"""

from __future__ import annotations

import json
import logging
import math
import threading
import time
from collections import deque

from . import overload as overload_mod

log = logging.getLogger("dts_torch.lifecycle")

# States (string values are the wire/JSON encoding, lowercase for labels).
IDLE = "idle"
CANARY = "canary"
PROMOTING = "promoting"
ROLLED_BACK = "rolled_back"
STATES = (IDLE, CANARY, PROMOTING, ROLLED_BACK)

# Fast-path gate mirroring overload.active(): the transport adapters scan
# criticality metadata only while SOME plane that consumes it is armed.
_ACTIVE = False


def active() -> bool:
    return _ACTIVE


def _activate() -> None:
    global _ACTIVE
    _ACTIVE = True


def deactivate() -> None:
    """Drop the module-level fast-path gate (bench/test teardown)."""
    global _ACTIVE
    _ACTIVE = False


class LifecycleController:
    """The freshness actuator: canary routing + promote/rollback ticks +
    the optional fine-tune publisher cadence.

    Collaborators are injected — `registry` (which versions are live),
    `watcher` (blacklist/pin/retire; None tolerated for embedded use,
    rollback then unloads through the registry directly), `quality` (the
    drift/AUC signal; None tolerated — promotion then rests on the dwell
    alone and rollback never fires, the bench's mechanics-cost mode) —
    so the state machine is testable with a fake clock and no threads.
    `publisher()` overrides the fine-tune publish step (soaks publish
    poisoned canaries through it).
    """

    def __init__(
        self,
        config,
        *,
        registry,
        model_name: str,
        watcher=None,
        quality=None,
        publisher=None,
        clock=time.monotonic,
    ):
        self.config = config
        self.registry = registry
        self.model = model_name
        self.watcher = watcher
        self.quality = quality
        self.publisher = publisher
        keep = getattr(getattr(watcher, "config", None), "keep_versions", 2)
        if keep < 2:
            # With keep_versions=1 the watcher's OWN poll pass retires
            # the stable version the instant it loads the canary —
            # before this controller's next tick can pin it — leaving no
            # rollback target and silently adopting the canary with no
            # judgment. Refuse at construction, not mid-rollout.
            raise ValueError(
                "the lifecycle plane needs keep_versions >= 2 on its "
                f"version watcher (got {keep}): stable and canary must "
                "be loadable side by side or there is no rollback target"
            )
        self._clock = clock
        self._lock = threading.Lock()
        # Tick serialization: ticks fire opportunistically from request
        # threads (route) AND from the optional background thread; two
        # concurrent evaluations of the same CANARY state would double-
        # fire its transition (two rollbacks counted, retire raced).
        # Non-blocking: a racer skips — the in-flight tick covers it.
        self._tick_mutex = threading.Lock()
        self._state = IDLE
        self._state_since = clock()
        # Recovery-plane interplay: while the serving replica
        # is quarantined/rebuilding its executor, canary ticks pause —
        # judging (or ramping) a canary against a dying device would
        # read device failure as model regression. Plain bool, flipped
        # by pause()/resume(); tick() no-ops while set.
        self._paused = False
        self._stable: int | None = None
        self._canary: int | None = None
        self._fraction = 0.0
        # Fleet-coordinated rollout: when the fleet plane sets
        # a fleet-global ramp fraction, it overrides the local ramp
        # schedule — every replica serves the SAME canary share, decided
        # once by the rollout coordinator. None = local schedule.
        self._fleet_fraction: float | None = None
        self._route_seq = 0
        self._next_tick = -math.inf
        # When the ramp first reached max_fraction (None below it): the
        # promote dwell is measured AT the ceiling, as the config knob
        # documents — ramp time is not full-share evidence.
        self._full_since: float | None = None
        # Counters (all monotonic; Prometheus reads them off snapshot()).
        self.ticks = 0
        self.promotes = 0
        self.rollbacks = 0
        self.publishes = 0
        self.publish_failures = 0
        self.routed_canary = 0
        self.routed_stable = 0
        self.routed_probe = 0
        self._last_publish_t = clock()
        self._last_judgment: dict | None = None
        self._last_rollback: dict | None = None
        self._promoted_version: int | None = None
        self._rolled_back_version: int | None = None
        self._events: deque[dict] = deque(
            maxlen=max(int(getattr(config, "history_events", 64)), 8)
        )
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        _activate()  # transports now scan the criticality lane for route()

    # ------------------------------------------------------------- routing

    def route(self, criticality: str | None = None) -> int | None:
        """Version override for one DEFAULT-resolution request of this
        controller's model (requests pinning a version or label never
        reach here). None = no override, serve the registry's latest.

        Probe-lane traffic goes to the canary from the moment CANARY is
        entered (the warmup lane is exactly the traffic a fresh version
        should absorb first); default-lane traffic follows a deterministic
        counter ramp — request k routes canary iff floor(k*f) advances,
        so a fraction f sends exactly that share with no RNG to seed.
        Ticks ride along opportunistically (one float compare per call),
        so an armed controller makes progress under pure traffic with no
        background thread."""
        now = self._clock()
        if now >= self._next_tick:
            self.tick(now)
        with self._lock:
            if self._state != CANARY:
                return None
            canary, stable = self._canary, self._stable
            lane = overload_mod.normalize_criticality(criticality)
            if lane == overload_mod.PROBE:
                self.routed_probe += 1
                self.routed_canary += 1
                return canary
            frac = self._fraction
            if frac >= 1.0:
                self.routed_canary += 1
                return canary
            if frac > 0.0:
                self._route_seq += 1
                k = self._route_seq
                if math.floor(k * frac) > math.floor((k - 1) * frac):
                    self.routed_canary += 1
                    return canary
            self.routed_stable += 1
            return stable

    # --------------------------------------------------------------- ticks

    def pause(self) -> None:
        """Suspend canary ticks (recovery quarantine): routing keeps its
        current answer but the state machine stops advancing — no ramp
        steps, no promote dwell credit accrual source, and critically no
        rollback judged against quarantine-corrupted evidence."""
        with self._lock:
            self._paused = True

    def resume(self) -> None:
        with self._lock:
            self._paused = False

    @property
    def paused(self) -> bool:
        return self._paused

    def tick(self, now: float | None = None) -> None:
        """One control-loop pass. Reentrancy-safe; quality reads happen
        OUTSIDE the controller lock (the monitor locks itself), then the
        transition re-checks state before applying."""
        if self._paused:
            return  # recovery quarantine in progress (see pause())
        now = self._clock() if now is None else now
        if not self._tick_mutex.acquire(blocking=False):
            return  # a concurrent tick is already evaluating this state
        try:
            with self._lock:
                self.ticks += 1
                self._next_tick = now + max(self.config.tick_interval_s, 0.05)
                state = self._state
            if state == IDLE:
                self._tick_idle(now)
            elif state == CANARY:
                self._tick_canary(now)
            elif state == PROMOTING:
                self._enter(IDLE, now, event="settled")
            elif state == ROLLED_BACK:
                if now - self._state_since >= self.config.rollback_hold_s:
                    self._enter(IDLE, now, event="rollback_hold_elapsed")
        finally:
            self._tick_mutex.release()

    def _versions(self) -> list[int]:
        return sorted(self.registry.models().get(self.model, ()))

    def _enter(self, state: str, now: float, event: str, **detail) -> None:
        with self._lock:
            self._state = state
            self._state_since = now
            self._events.append({
                "t": round(now, 3),
                "state": state,
                "event": event,
                **detail,
            })
        log.info("lifecycle %s -> %s (%s) %s", self.model, state, event,
                 detail or "")

    def _tick_idle(self, now: float) -> None:
        versions = self._versions()
        if not versions:
            return
        latest = versions[-1]
        with self._lock:
            stable = self._stable
        if stable is None or stable not in versions:
            # Adopt the current latest as stable WITHOUT a canary phase:
            # at controller start (or after an external retire) the
            # serving version is already carrying full traffic — routing
            # it back down to an older version would be a regression, not
            # a canary.
            with self._lock:
                self._stable = latest
                if stable != latest:
                    # Appended under the lock: snapshot() iterates the
                    # deque there, and a concurrent append would raise
                    # "deque mutated during iteration" mid-scrape.
                    self._events.append({
                        "t": round(now, 3), "state": IDLE,
                        "event": "adopted_stable", "version": latest,
                    })
            return
        if latest > stable:
            if self.watcher is not None and self._safe(
                lambda: self.watcher.is_blacklisted(latest), False
            ):
                return  # a blacklisted version must never re-enter canary
            with self._lock:
                self._canary = latest
                self._fraction = 0.0
                self._route_seq = 0
                self._full_since = None
            if self.watcher is not None:
                # Pin the stable version: retention must not retire the
                # rollback target out from under a live canary.
                self._safe(lambda: self.watcher.pin(stable))
            self._enter(CANARY, now, event="canary_started",
                        stable=stable, canary=latest)

    def _tick_canary(self, now: float) -> None:
        with self._lock:
            stable, canary = self._stable, self._canary
            since = self._state_since
        versions = self._versions()
        if canary not in versions:
            # Retired externally (operator, reload-config): drain routing
            # and fall back to IDLE; _tick_idle re-adopts whatever leads.
            self._clear_canary()
            self._enter(IDLE, now, event="canary_vanished", canary=canary)
            return
        if stable not in versions:
            # The rollback target is gone (external unload past the pin):
            # the canary is the only live version — promote by necessity.
            self._promote(now, reason="stable_vanished")
            return
        judgment = self._judge(stable, canary)
        with self._lock:
            self._last_judgment = judgment
        if judgment["verdict"] == "regressed":
            self._rollback(now, judgment)
            return
        cfg = self.config
        elapsed = now - since
        ramp_t = elapsed - cfg.canary_probe_only_s
        if ramp_t < 0:
            frac = 0.0
        else:
            steps = math.floor(ramp_t / max(cfg.canary_step_dwell_s, 1e-9))
            frac = min(
                cfg.canary_initial_fraction + steps * cfg.canary_ramp_step,
                cfg.canary_max_fraction,
            )
        fleet_frac = self._fleet_fraction
        if fleet_frac is not None:
            # Fleet override: the coordinator's fraction wins over the
            # local clock (still capped at the operator's ceiling — the
            # fleet can slow a replica down or catch it up, not push it
            # past its configured max).
            frac = min(max(float(fleet_frac), 0.0), cfg.canary_max_fraction)
        with self._lock:
            if frac != self._fraction:
                self._route_seq = 0  # restart the counter ramp per step
            self._fraction = frac
            if frac >= cfg.canary_max_fraction:
                if self._full_since is None:
                    self._full_since = now
            else:
                self._full_since = None
            full_since = self._full_since
        if (
            full_since is not None
            and now - full_since >= cfg.promote_after_s
            # The dwell is measured AT the ceiling (the knob's documented
            # semantics): ramp time is not full-share evidence. "ok"
            # requires quality evidence; "no_signal" (no quality monitor)
            # promotes on the dwell alone — the documented mechanics
            # mode; "insufficient" never does.
            and judgment["verdict"] in ("ok", "no_signal")
        ):
            self._promote(now, reason="healthy_dwell", judgment=judgment)

    # ----------------------------------------------------------- judgment

    def _judge(self, stable: int, canary: int) -> dict:
        """Read the quality plane's canary-vs-stable evidence. Verdicts:
        'regressed' (roll back now), 'ok' (evidence present and within
        thresholds), 'insufficient' (not enough canary data yet — keep
        ramping, never promote on it). Without a quality monitor the
        verdict is 'no_signal': promotion rests on the dwell alone and
        rollback never fires (document-level trade-off for embedded /
        bench use; the server build refuses to arm this plane without
        [quality])."""
        q = self.quality
        cfg = self.config
        if q is None:
            return {"verdict": "no_signal"}
        out: dict = {"verdict": "insufficient"}
        try:
            canary_scores = q.version_window_count(self.model, canary)
            out["canary_window_scores"] = canary_scores
            pair = q.pair_drift(
                self.model, stable, canary,
                min_count=cfg.min_canary_scores,
                # Decision-grade comparison: coarsened bins, so a small
                # fresh-canary window's sampling noise cannot impersonate
                # a shift (the raw fine-bin PSI stays on /qualityz).
                decision_bins=getattr(cfg, "rollback_compare_bins", 10),
            )
            out["pair"] = pair
            s_auc, s_n = q.version_auc(self.model, stable)
            c_auc, c_n = q.version_auc(self.model, canary)
            out["auc"] = {
                "stable": s_auc, "stable_pairs": s_n,
                "canary": c_auc, "canary_pairs": c_n,
            }
            if pair is not None and pair["psi"] >= cfg.rollback_psi:
                out["verdict"] = "regressed"
                out["reason"] = "psi"
                return out
            if (
                s_auc is not None and c_auc is not None
                and s_n >= cfg.min_auc_pairs and c_n >= cfg.min_auc_pairs
                and s_auc - c_auc >= cfg.rollback_auc_drop
            ):
                out["verdict"] = "regressed"
                out["reason"] = "auc"
                return out
            if pair is not None and canary_scores >= cfg.min_canary_scores:
                out["verdict"] = "ok"
            elif (
                pair is None
                and cfg.canary_max_fraction >= 0.95
                and canary_scores >= cfg.min_canary_scores
                and q.version_window_count(self.model, stable)
                < cfg.min_canary_scores
            ):
                # The STABLE side is starved BY CONSTRUCTION — only at a
                # ~1.0 ramp ceiling, where everything routes to the
                # canary, does the stable window drain with pair evidence
                # UNOBTAINABLE; waiting would wedge the rollout forever,
                # so promotion rests on the dwell + canary volume. At a
                # partial ceiling a starved stable just means low
                # traffic: the verdict stays "insufficient" — promoting
                # without the comparison would skip the one judgment this
                # plane exists to make.
                out["verdict"] = "ok"
                out["reason"] = "stable_starved"
        except Exception:  # noqa: BLE001 — a signal-plane bug must not
            log.exception("lifecycle judgment failed")  # wedge the rollout
        return out

    # -------------------------------------------------------- transitions

    def _clear_canary(self) -> None:
        with self._lock:
            stable, canary = self._stable, self._canary
            self._canary = None
            self._fraction = 0.0
            self._route_seq = 0
        if self.watcher is not None and stable is not None:
            self._safe(lambda: self.watcher.unpin(stable))
        return canary

    def _promote(self, now: float, reason: str, judgment=None) -> None:
        with self._lock:
            canary = self._canary
            self._promoted_version = canary
            self._canary = None
            self._fraction = 0.0
            self._route_seq = 0
            old_stable = self._stable
            self._stable = canary
            self.promotes += 1
        if self.watcher is not None and old_stable is not None:
            # Release the rollback pin: retention may now retire the old
            # stable on its normal newest-K schedule.
            self._safe(lambda: self.watcher.unpin(old_stable))
        self._enter(PROMOTING, now, event="promoted", version=canary,
                    reason=reason)

    def _rollback(self, now: float, judgment: dict) -> None:
        with self._lock:
            canary = self._canary
            self._rolled_back_version = canary
            self._last_rollback = {
                "version": canary,
                "t": round(now, 3),
                "reason": judgment.get("reason"),
                "pair": judgment.get("pair"),
                "auc": judgment.get("auc"),
            }
            self.rollbacks += 1
        self._clear_canary()
        retired = False
        if self.watcher is not None:
            # Retire THROUGH the watcher: unload from the registry now
            # (traffic snaps back to stable — resolve's latest-version
            # default) AND blacklist, so the next reconcile pass cannot
            # hot-load the same bad version straight back from disk.
            retired = self._safe(lambda: self.watcher.retire(canary), False)
        if not retired:
            try:
                self.registry.unload(self.model, canary)
            except KeyError:
                pass  # already gone
        self._enter(ROLLED_BACK, now, event="rolled_back", version=canary,
                    reason=judgment.get("reason"))

    @staticmethod
    def _safe(fn, default=None):
        try:
            return fn()
        except Exception:  # noqa: BLE001 — watcher quirks must not
            log.exception("lifecycle watcher call failed")  # kill the tick
            return default

    # --------------------------------------------------------- fleet hooks

    def set_fleet_fraction(self, fraction: float | None) -> None:
        """Adopt the fleet-global ramp fraction (rollout coordinator via
        gossip); None returns routing to the local ramp schedule."""
        with self._lock:
            self._fleet_fraction = (
                None if fraction is None else float(fraction)
            )

    def force_rollback(self, reason: str = "forced") -> bool:
        """Roll back the live canary NOW without waiting for local
        quality evidence — the fleet-coordinated rollback path (another
        replica's judge fired) and the POST /lifecyclez/rollback
        operator surface. Returns False when no canary is live."""
        now = self._clock()
        with self._tick_mutex:
            with self._lock:
                if self._state != CANARY or self._canary is None:
                    return False
            self._rollback(now, {"verdict": "regressed", "reason": reason})
        return True

    def fleet_blacklist(self, version: int) -> str:
        """Apply a fleet-wide version blacklist entry locally: the live
        canary rolls back; a merely-loaded version is retired
        (unload + blacklist); an unseen version is blacklisted so the
        watcher can never hot-load it. The stable version is REFUSED —
        the fleet must never talk a replica out of its only good
        version. Returns the action taken (for /fleetz and tests)."""
        with self._lock:
            canary, stable = self._canary, self._stable
        if version == stable:
            return "refused_stable"
        if version == canary:
            return (
                "rolled_back"
                if self.force_rollback(reason="fleet_blacklist")
                else "noop"
            )
        if self.watcher is not None:
            if self._safe(lambda: self.watcher.is_blacklisted(version), False):
                return "already_blacklisted"
            if version in self._versions():
                self._safe(lambda: self.watcher.retire(version))
                return "retired"
            self._safe(lambda: self.watcher.blacklist(version))
            return "blacklisted"
        try:
            self.registry.unload(self.model, version)
            return "unloaded"
        except KeyError:
            return "noop"

    # ----------------------------------------------------------- publisher

    def publish_once(self, stop_evt: threading.Event | None = None) -> dict | None:
        """Run one fine-tune + publish round (the injected `publisher`
        callable, else the default train/publisher.py path against the
        current stable servable). Returns the publish summary or None on
        failure; failures count, never raise — the background loop must
        survive a flaky trainer. `stop_evt` is the calling loop's OWN
        stop event (an orphaned loop must answer to the generation that
        spawned it, not a successor's fresh event)."""
        if (stop_evt or self._stop).is_set():
            # A stop raced the loop's due-check (shutdown in progress):
            # a version must not be published into a draining stack.
            return None
        try:
            fn = self.publisher or self._default_publish
            t0 = self._clock()
            summary = fn()
            # The round's span on the controller's clock beside the
            # publisher's summary (steps, wall_s, loss): when a fine-tune
            # ran, for readers of the server's log.
            log.info("lifecycle %s published: %s", self.model, json.dumps(
                {"t0": round(t0, 3), "t1": round(self._clock(), 3), **(summary or {})},
                default=str))
            with self._lock:
                self.publishes += 1
                self._last_publish_t = self._clock()
                # Under the lock: snapshot() iterates the deque there.
                self._events.append({
                    "t": round(self._clock(), 3), "state": self._state,
                    "event": "published",
                    "version": (summary or {}).get("version"),
                })
            return summary
        except Exception:  # noqa: BLE001
            with self._lock:
                self.publish_failures += 1
                self._last_publish_t = self._clock()  # back off a full interval
            log.exception("lifecycle publish failed")
            return None

    def _default_publish(self) -> dict:
        if self.watcher is None:
            raise RuntimeError(
                "fine-tune publishing needs a version watcher (the watched "
                "base dir is the publish target)"
            )
        from ..train.publisher import publish_finetuned

        cfg = self.config
        servable = self.registry.resolve(self.model)  # latest = stable
        return publish_finetuned(
            str(self.watcher.base_path),
            servable,
            kind=servable.model.kind,
            steps=cfg.fine_tune_steps,
            batch_size=cfg.fine_tune_batch_size,
            learning_rate=cfg.fine_tune_learning_rate,
            seed=self.publishes + 1,  # fresh rows each round
        )

    def _publish_due(self, now: float) -> bool:
        cfg = self.config
        return (
            cfg.fine_tune_interval_s > 0
            and self._state == IDLE
            and now - self._last_publish_t >= cfg.fine_tune_interval_s
        )

    # ------------------------------------------------------------- thread

    def start(self) -> "LifecycleController":
        """Optional background thread: ticks at tick_interval_s and runs
        the fine-tune publisher when due. Tests with a fake clock never
        call this — tick() is the whole machine.

        Each start mints a FRESH stop event captured by the new loop: a
        restart after a timed-out stop() (the old thread detached mid-
        fine-tune) must not revive the orphan — its captured event stays
        set, so it exits at its next wait instead of becoming a second
        concurrent tick/publish loop."""
        if self._thread is None or not self._thread.is_alive():
            stop_evt = threading.Event()
            self._stop = stop_evt
            self._thread = threading.Thread(
                target=self._loop, args=(stop_evt,), name="lifecycle",
                daemon=True,
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            # Short join: a thread mid-fine-tune can run for minutes and
            # must not eat the caller's drain grace (GracefulShutdown
            # stops this BEFORE the watcher). publish_once re-checks the
            # stop flag, so a detached daemon thread at worst finishes
            # its training and discards the result.
            self._thread.join(timeout=2)
            if self._thread.is_alive():
                log.warning(
                    "lifecycle thread still inside a fine-tune/publish; "
                    "detaching (daemon thread). An already-started publish "
                    "may still land its version dir, but THIS process's "
                    "watcher is stopping and will never load it — the "
                    "artifact waits for the next server start"
                )
            self._thread = None
        # Drop the module-level criticality-scan gate the constructor
        # armed: a stopped controller routes nothing, so transports must
        # not keep paying the metadata scan for it.
        deactivate()

    def _loop(self, stop_evt: threading.Event) -> None:
        interval = max(self.config.tick_interval_s, 0.05)
        while not stop_evt.wait(interval):
            try:
                now = self._clock()
                self.tick(now)
                if self._publish_due(now) and not stop_evt.is_set():
                    # Fine-tune runs ON this thread: publishing is rare
                    # and IDLE-only, and a second thread would just race
                    # the state machine it feeds.
                    self.publish_once(stop_evt)
            except Exception:  # noqa: BLE001 — the loop must survive
                log.exception("lifecycle tick failed; retrying next interval")

    # ------------------------------------------------------------ surfaces

    def fleet_record(self) -> dict:
        """The lifecycle slice of this replica's gossip record — cheap
        (no events copy, no watcher snapshot): published every gossip
        interval."""
        with self._lock:
            return {
                "canary": self._canary,
                "canary_fraction": round(self._fraction, 4),
                "rolled_back": self._rolled_back_version,
            }

    def snapshot(self) -> dict:
        """The /lifecyclez body, the `lifecycle` /monitoring block, and
        the dts_tpu_lifecycle_* Prometheus source."""
        now = self._clock()
        with self._lock:
            cfg = self.config
            out = {
                "enabled": True,
                "model": self.model,
                "paused": self._paused,
                "state": self._state,
                "state_age_s": round(now - self._state_since, 3),
                "stable_version": self._stable,
                "canary_version": self._canary,
                "canary_fraction": round(self._fraction, 4),
                "fleet_fraction": self._fleet_fraction,
                "promoted_version": self._promoted_version,
                "rolled_back_version": self._rolled_back_version,
                "counters": {
                    "ticks": self.ticks,
                    "promotes": self.promotes,
                    "rollbacks": self.rollbacks,
                    "publishes": self.publishes,
                    "publish_failures": self.publish_failures,
                    "routed_canary": self.routed_canary,
                    "routed_stable": self.routed_stable,
                    "routed_probe": self.routed_probe,
                },
                "last_judgment": self._last_judgment,
                "last_rollback": self._last_rollback,
                "events": list(self._events),
                "config": {
                    "tick_interval_s": cfg.tick_interval_s,
                    "canary_probe_only_s": cfg.canary_probe_only_s,
                    "canary_initial_fraction": cfg.canary_initial_fraction,
                    "canary_ramp_step": cfg.canary_ramp_step,
                    "canary_step_dwell_s": cfg.canary_step_dwell_s,
                    "canary_max_fraction": cfg.canary_max_fraction,
                    "promote_after_s": cfg.promote_after_s,
                    "min_canary_scores": cfg.min_canary_scores,
                    "rollback_psi": cfg.rollback_psi,
                    "rollback_auc_drop": cfg.rollback_auc_drop,
                    "rollback_hold_s": cfg.rollback_hold_s,
                    "fine_tune_interval_s": cfg.fine_tune_interval_s,
                },
            }
        out["versions_loaded"] = self._versions()
        if self.watcher is not None:
            out["watcher"] = self._safe(self.watcher.snapshot)
        return out
