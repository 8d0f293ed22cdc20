"""Fleet robustness plane: the tier ABOVE one replica.

Three pieces, composing the per-replica planes into a fleet:

- `gossip.py` — cross-replica health gossip. Every member (replica or
  router) runs a `GossipAgent`: a tiny HTTP/UDS listener plus a push-pull
  exchange loop. Each member publishes a compact, versioned
  `HealthRecord` (serving/draining/quarantined state from the recovery
  plane, pressure from the overload plane, loaded versions, canary
  state); records merge by highest sequence number, so the fleet view
  converges through ANY live peer in common.
- `rollout.py` — fleet-coordinated rollout. The per-replica canary
  ramp lifted to shared state: a single writer (the router) adopts the
  ramp leader's fraction fleet-wide and turns any one replica's rollback
  into a fleet-wide version blacklist in the same tick. State rides the
  gossip records; followers apply it through
  `LifecycleController.set_fleet_fraction` / `fleet_blacklist`.
- `router.py` — the router process. Speaks the PredictionService wire
  protocol on both transports and embeds `ShardedPredictClient`
  server-side, so the scoreboard/hedging/failover/affinity machinery
  built for the fan-out client becomes the fleet's steering brain.
  Gossip folds into the scoreboard, so a replica's quarantine or drain
  steers the fleet BEFORE its first failed RPC.

Everything here is device-free and off by default: a replica without
`[fleet] enabled = true` pays one attribute read per hook, and scores
through the router are bit-identical to a direct backend call.
"""

from .gossip import GossipAgent, HealthRecord  # noqa: F401
from .rollout import RolloutCoordinator, RolloutFollower, RolloutState  # noqa: F401
