"""Replica-side fleet plane: the gossip agent a serving replica embeds
plus the rollout follower that applies the router's coordinated state.

The serving build (serving/server.py) constructs this with a `record_fn`
closure over the live stack — serving/draining/quarantined/starting from
the recovery plane + GracefulShutdown, pressure from the overload plane,
loaded versions from the registry, canary state from the lifecycle
controller — so this module stays device-free and testable with fakes.
"""

from __future__ import annotations

import time

from .gossip import GossipAgent
from .rollout import RolloutFollower


class ReplicaFleetPlane:
    """One replica's fleet membership. `record_fn()` returns the
    HealthRecord field dict for this replica's current state; rollout
    state arriving in ANY peer's record (the router's, usually) applies
    to `lifecycle` through a RolloutFollower exactly once per seq."""

    def __init__(
        self, cfg, *, record_fn, lifecycle=None, clock=time.time,
        extra_routes=None, query_routes=None, post_routes=None,
    ):
        self.config = cfg
        self_id = cfg.self_id or cfg.advertise_addr
        self.follower = (
            RolloutFollower(lifecycle, self_id) if lifecycle is not None
            else None
        )
        self.agent = GossipAgent(
            self_id or "replica",
            role="replica",
            host=cfg.gossip_host,
            port=cfg.gossip_port,
            uds_path=cfg.gossip_uds,
            peers=cfg.peers,
            interval_s=cfg.gossip_interval_s,
            ttl_s=cfg.record_ttl_s,
            record_fn=record_fn,
            on_update=self._on_update,
            # the serving build mounts its /monitoring wire +
            # /tracez/export surfaces on the gossip port so the router's
            # aggregator scrapes members without touching the REST tier.
            extra_routes=extra_routes,
            query_routes=query_routes,
            post_routes=post_routes,
            clock=clock,
        )

    def _on_update(self, rec) -> None:
        if self.follower is not None and rec.rollout:
            self.follower.apply(rec.rollout)

    def start(self) -> "ReplicaFleetPlane":
        self.agent.start()
        return self

    def stop(self) -> None:
        self.agent.stop()

    def announce(self) -> None:
        """One immediate push-pull round with every peer — called when
        state just changed in a way the fleet should hear NOW (drain
        start), instead of waiting out the interval."""
        for peer in self.agent.peers:
            self.agent.exchange_once(peer)

    # ----------------------------------------------------------- surfaces

    def snapshot(self) -> dict:
        """The replica's /fleetz body."""
        out = {"role": "replica", **self.agent.snapshot()}
        if self.follower is not None:
            out["rollout_follower"] = self.follower.snapshot()
        return out

    def fleet_stats(self) -> dict:
        """The shape utils.metrics._fleet_prometheus_lines consumes."""
        stats: dict = {"role": "replica", "gossip": self.agent.snapshot()}
        if self.follower is not None:
            stats["follower"] = self.follower.snapshot()
        return stats
