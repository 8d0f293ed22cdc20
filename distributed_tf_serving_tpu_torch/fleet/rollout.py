"""Fleet-coordinated rollout.

The lifecycle plane ramps a canary PER REPLICA: each
LifecycleController walks its own fraction schedule and judges its own
quality window. Fine for one process; across a fleet it means replicas
disagree about the ramp (skewed start times) and — worse — a version one
replica's judge already rolled back keeps serving everywhere else until
each judge independently re-learns the lesson.

This module lifts that to shared rollout state with ONE writer:

- `RolloutCoordinator` (runs inside the router, `rollout_writer=true`):
  each tick it reads the gossip view, elects the RAMP LEADER — the
  lexicographically smallest replica currently reporting a canary
  (sticky while that replica keeps reporting it) — and copies the
  leader's (canary_version, fraction) into the shared state. Any replica
  reporting `rolled_back=v` gets v appended to the fleet blacklist and
  the ramp cleared IN THE SAME TICK. State carries a monotonic `seq`
  (bumped on every change) and is persisted by atomic rename so a
  restarted router resumes the rollout instead of re-running it.

- `RolloutFollower` (runs inside every replica): applies coordinator
  state as it arrives via gossip. Followers mirror the leader's fraction
  through `LifecycleController.set_fleet_fraction`; the leader itself
  keeps its LOCAL schedule (it is the clock the fleet mirrors — if it
  also followed, the ramp would freeze at its first adopted value).
  Blacklist entries apply through `fleet_blacklist`: the live canary
  rolls back, loaded versions retire, unseen versions pre-blacklist.

Distribution is free: the state dict rides the router's gossip record
(`rollout` field), so one gossip interval bounds fleet-wide propagation
— the acceptance criterion's "blacklisted on ALL replicas within one
gossip interval".
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time

log = logging.getLogger("dts_torch.fleet.rollout")


@dataclasses.dataclass
class RolloutState:
    """The fleet-global rollout picture. seq is bumped on every change;
    followers apply a state only when its seq advances past the last one
    they applied."""

    seq: int = 0
    canary_version: int | None = None
    fraction: float = 0.0
    leader: str = ""
    blacklist: tuple[int, ...] = ()
    wall_ts: float = 0.0

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["blacklist"] = list(self.blacklist)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "RolloutState":
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in (d or {}).items() if k in known}
        kwargs["blacklist"] = tuple(
            int(v) for v in kwargs.get("blacklist", ())
        )
        return cls(**kwargs)


class RolloutCoordinator:
    """The single writer. `tick(view)` folds the gossip view into the
    shared state; the caller (router) publishes `state().to_dict()` in
    its own gossip record."""

    def __init__(self, state_file: str = "", *, clock=time.time):
        self._clock = clock
        self._state_file = state_file
        self._state = RolloutState()
        # Counters (monotonic; /fleetz + dts_tpu_fleet_*).
        self.adoptions = 0
        self.blacklists = 0
        self.clears = 0
        if state_file and os.path.exists(state_file):
            try:
                with open(state_file, "r", encoding="utf-8") as f:
                    self._state = RolloutState.from_dict(json.load(f))
                log.info("rollout state resumed from %s (seq=%d)",
                         state_file, self._state.seq)
            except (OSError, ValueError):
                log.exception("rollout state file unreadable; starting "
                              "fresh (the gossip view re-derives it)")

    def state(self) -> RolloutState:
        return self._state

    def tick(self, view: dict) -> RolloutState:
        """One coordination pass over the gossip view (id ->
        HealthRecord). Blacklist first — a rollback anywhere beats a ramp
        anywhere — then leader election and fraction adoption."""
        st = self._state
        replicas = {
            mid: rec for mid, rec in view.items()
            if getattr(rec, "role", "replica") == "replica"
        }
        changed = False
        blacklist = list(st.blacklist)
        canary, fraction, leader = st.canary_version, st.fraction, st.leader
        for mid in sorted(replicas):
            rb = replicas[mid].rolled_back
            if rb is not None and int(rb) not in blacklist:
                # One replica's judgment is the FLEET's judgment: the
                # version is dead everywhere in this same tick.
                blacklist.append(int(rb))
                self.blacklists += 1
                changed = True
                log.info("fleet blacklist: v%s (rolled back on %s)", rb, mid)
        if canary is not None and canary in blacklist:
            canary, fraction, leader = None, 0.0, ""
            self.clears += 1
            changed = True
        # Leader: sticky while it still reports a (non-blacklisted)
        # canary; else the smallest replica id reporting one.
        def _reports_canary(mid: str) -> bool:
            rec = replicas.get(mid)
            return (
                rec is not None
                and rec.canary is not None
                and int(rec.canary) not in blacklist
            )

        if not (leader and _reports_canary(leader)):
            leader_new = next(
                (mid for mid in sorted(replicas) if _reports_canary(mid)), ""
            )
            if leader_new != leader:
                leader = leader_new
                changed = True
        if leader:
            rec = replicas[leader]
            new_canary = int(rec.canary)
            new_fraction = float(rec.canary_fraction or 0.0)
            if new_canary != canary or new_fraction != fraction:
                canary, fraction = new_canary, new_fraction
                self.adoptions += 1
                changed = True
        elif canary is not None:
            # No replica reports the canary anymore (promoted or
            # vanished): clear the fleet ramp.
            canary, fraction = None, 0.0
            self.clears += 1
            changed = True
        if changed:
            self._state = RolloutState(
                seq=st.seq + 1,
                canary_version=canary,
                fraction=fraction,
                leader=leader,
                blacklist=tuple(blacklist),
                wall_ts=round(self._clock(), 3),
            )
            self._persist()
        return self._state

    def _persist(self) -> None:
        if not self._state_file:
            return
        tmp = f"{self._state_file}.tmp"
        try:
            d = os.path.dirname(self._state_file)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(self._state.to_dict(), f)
            os.replace(tmp, self._state_file)  # atomic: readers never see
        except OSError:  # a torn write
            log.exception("rollout state persist failed (state is still "
                          "live in memory and gossip)")

    def snapshot(self) -> dict:
        return {
            "state": self._state.to_dict(),
            "counters": {
                "adoptions": self.adoptions,
                "blacklists": self.blacklists,
                "clears": self.clears,
            },
        }


class RolloutFollower:
    """Every replica's applier. Feed it rollout-state dicts as gossip
    delivers them (`GossipAgent.on_update` → record.rollout); it applies
    each NEW seq to the local LifecycleController exactly once."""

    def __init__(self, lifecycle, self_id: str):
        self.lifecycle = lifecycle
        self.self_id = self_id
        self.applied_seq = -1
        self._applied_blacklist: set[int] = set()
        # Monotonic counters + last actions (the /fleetz rollout block).
        self.applies = 0
        self.blacklists_applied = 0
        self.last_actions: dict = {}

    def apply(self, rollout) -> dict | None:
        """Apply one rollout-state payload; returns the actions taken or
        None when the payload is stale/absent."""
        if rollout is None:
            return None
        st = (
            rollout if isinstance(rollout, RolloutState)
            else RolloutState.from_dict(rollout)
        )
        if st.seq <= self.applied_seq:
            return None
        self.applied_seq = st.seq
        self.applies += 1
        actions: dict = {"seq": st.seq}
        lc = self.lifecycle
        for v in st.blacklist:
            if v in self._applied_blacklist:
                continue
            self._applied_blacklist.add(v)
            self.blacklists_applied += 1
            actions.setdefault("blacklist", {})[str(v)] = lc.fleet_blacklist(v)
        if st.leader == self.self_id or st.canary_version is None:
            # The leader keeps its LOCAL ramp schedule (it IS the fleet
            # clock); with no fleet canary everyone does.
            lc.set_fleet_fraction(None)
            actions["fraction"] = None
        else:
            lc.set_fleet_fraction(st.fraction)
            actions["fraction"] = st.fraction
        self.last_actions = actions
        return actions

    def snapshot(self) -> dict:
        return {
            "applied_seq": self.applied_seq,
            "applies": self.applies,
            "blacklists_applied": self.blacklists_applied,
            "last_actions": self.last_actions,
        }
