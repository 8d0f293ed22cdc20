"""The port's fleet robustness plane (fleet/gossip.py, rollout.py,
replica.py, router.py), case for case as the JAX package's
tests/test_fleet.py holds its own: cross-replica health gossip,
router-embedded scoreboard steering, fleet-coordinated rollout, the
scoreboard's DRAINING fast path, grpc.health.v1 Watch streams, and router
end-to-end bit-identity against a direct backend call — port servers on the
CPU at a small width (8 fields, embed 4, one cross layer, f32) with the JAX
package's weights, carried across by convert.py.

Below those cases, the port held to the JAX package: HealthRecord and
RolloutState JSON byte for byte, a JAX and a port GossipAgent converging in
one mesh, gossip's restart ordering under a fake clock, and a port router
over two port replicas within 1e-5 of the JAX server on the same weights."""

import asyncio
import dataclasses
import functools
import json
import threading
import time

import grpc
import jax
import numpy as np
import pytest

from distributed_tf_serving_tpu.models import ModelConfig as JaxConfig
from distributed_tf_serving_tpu.models import build_model as jax_build
from distributed_tf_serving_tpu_torch.convert import params_from_jax

from distributed_tf_serving_tpu_torch.client import (
    BackendScoreboard,
    ScoreboardConfig,
    ShardedPredictClient,
    build_predict_request,
)
from distributed_tf_serving_tpu_torch.client.health import (
    DRAINING,
    HALF_OPEN,
    HEALTHY,
)
from distributed_tf_serving_tpu_torch.fleet import gossip as gossip_mod
from distributed_tf_serving_tpu_torch.fleet.gossip import GossipAgent, HealthRecord
from distributed_tf_serving_tpu_torch.fleet.rollout import (
    RolloutCoordinator,
    RolloutFollower,
    RolloutState,
)
from distributed_tf_serving_tpu_torch.models import (
    ModelConfig,
    Servable,
    ServableRegistry,
    build_model,
    ctr_signatures,
)
from distributed_tf_serving_tpu_torch.proto import health as health_proto
from distributed_tf_serving_tpu_torch.proto import serving_apis_pb2 as apis
from distributed_tf_serving_tpu_torch.serving import (
    DynamicBatcher,
    PredictionServiceImpl,
    create_server,
)
from distributed_tf_serving_tpu_torch.utils.config import ClientConfig, ServerConfig

CFG = ModelConfig(
    num_fields=8, vocab_size=1009, embed_dim=4, mlp_dims=(16,),
    num_cross_layers=1, compute_dtype="float32",
)


@functools.lru_cache(maxsize=None)
def _jax_params(seed=0):
    """The JAX package's initial dcn_v2 weights for CFG (numpy leaves)."""
    jm = jax_build("dcn_v2", JaxConfig(**dataclasses.asdict(CFG)))
    return jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))


def _servable(version=1, seed=0):
    model = build_model("dcn_v2", CFG)
    return Servable(
        name="DCN", version=version, model=model,
        params=params_from_jax(_jax_params(seed), "cpu"),
        signatures=ctr_signatures(CFG.num_fields),
    )


def _arrays(n=9, seed=3):
    rng = np.random.RandomState(seed)
    return {
        "feat_ids": rng.randint(
            0, 1 << 40, size=(n, CFG.num_fields)
        ).astype(np.int64),
        "feat_wts": rng.rand(n, CFG.num_fields).astype(np.float32),
    }


@pytest.fixture()
def two_backends():
    servers, hosts, impls, batchers = [], [], [], []
    for _ in range(2):
        registry = ServableRegistry()
        registry.load(_servable(version=1, seed=0))
        batcher = DynamicBatcher(device="cpu", buckets=(32, 128), max_wait_us=0).start()
        impl = PredictionServiceImpl(registry, batcher)
        server, port = create_server(impl, "127.0.0.1:0")
        server.start()
        servers.append(server)
        batchers.append(batcher)
        impls.append(impl)
        hosts.append(f"127.0.0.1:{port}")
    yield hosts, impls
    for s in servers:
        s.stop(0)
    for b in batchers:
        b.stop()


# ------------------------------------------------------------------ gossip


def _agent(self_id, clock, seq, **kw):
    return GossipAgent(
        self_id, clock=lambda: clock[0], seq_fn=lambda: seq[0], **kw
    )


def test_gossip_merge_higher_seq_wins_and_own_id_ignored():
    clock, seq = [0.0], [1]
    a = _agent("self", clock, seq)
    accepted = a.merge([
        {"id": "peer", "seq": 5, "state": "serving"},
        {"id": "self", "seq": 99, "state": "draining"},  # own id: ignored
        {"id": "", "seq": 1},  # malformed: ignored
    ])
    assert [r.id for r in accepted] == ["peer"]
    # Lower seq for a held id is stale, higher seq replaces.
    assert a.merge([{"id": "peer", "seq": 3, "state": "draining"}]) == []
    assert a.records_stale == 1
    assert a.view()["peer"].state == "serving"
    changed = a.merge([{"id": "peer", "seq": 8, "state": "draining"}])
    assert changed[0].state == "draining"
    assert a.view(include_self=False).keys() == {"peer"}
    assert "self" in a.view(include_self=True)


def test_gossip_ttl_expiry_and_equal_seq_receipt_refresh():
    clock, seq = [0.0], [1]
    a = _agent("self", clock, seq, ttl_s=5.0)
    a.merge([{"id": "peer", "seq": 7, "state": "serving"}])
    # An equal-seq copy at t=4 proves the member spoke recently somewhere:
    # receipt refreshes even though the record itself is "stale".
    clock[0] = 4.0
    a.merge([{"id": "peer", "seq": 7, "state": "serving"}])
    clock[0] = 8.0  # 4s after refresh: still fresh
    assert "peer" in a.view(include_self=False)
    clock[0] = 9.5  # 5.5s after refresh: expired (SIGKILLed member fades)
    assert a.view(include_self=False) == {}
    assert a.records_expired == 1


def test_gossip_self_record_stamps_id_seq_and_fields():
    clock, seq = [12.0], [42]
    a = _agent(
        "r1", clock, seq,
        record_fn=lambda: {"state": "draining", "versions": [2, 1],
                           "canary": 3, "bogus_field": "dropped"},
    )
    rec = a.self_record()
    assert rec.id == "r1" and rec.seq == 42 and rec.wall_ts == 12.0
    assert rec.state == "draining" and rec.versions == (2, 1)
    assert rec.canary == 3


def test_gossip_exchange_tcp_push_pull_and_on_update():
    clock = [0.0]
    seen = []
    a = GossipAgent(
        "a", clock=lambda: clock[0],
        record_fn=lambda: {"state": "serving"},
    )
    b = GossipAgent(
        "b", clock=lambda: clock[0],
        record_fn=lambda: {"state": "draining"},
        on_update=seen.append,
    )
    a.start()
    try:
        addr = a.listen_addr
        # b pushes its view to a and pulls a's view back: both learn.
        assert b.exchange_once(addr)
        assert b.view(include_self=False)["a"].state == "serving"
        assert a.view(include_self=False)["b"].state == "draining"
        assert [r.id for r in seen] == ["a"]
        assert b.exchanges_ok == 1
    finally:
        a.stop()
    # Dead peer: failure is counted, never raised.
    assert not b.exchange_once(addr)
    assert b.exchanges_failed == 1


def test_gossip_uds_listener_and_extra_routes(tmp_path):
    path = str(tmp_path / "gossip.sock")
    a = GossipAgent(
        "a", uds_path=path, record_fn=lambda: {"state": "serving"},
        extra_routes={"/metrics": lambda: "metric_x 1\n"},
    )
    a.start()
    try:
        assert a.listen_addr == f"unix:{path}"
        b = GossipAgent("b", record_fn=lambda: {})
        assert b.exchange_once(f"unix:{path}")
        assert b.view(include_self=False)["a"].state == "serving"
        # The extra route answers text/plain on the same listener.
        conn = gossip_mod._open_connection(f"unix:{path}", 2.0)
        conn.request("GET", "/metrics")
        resp = conn.getresponse()
        assert resp.status == 200 and b"metric_x 1" in resp.read()
        conn.close()
        # Built-in /fleetz still serves the agent snapshot.
        conn = gossip_mod._open_connection(f"unix:{path}", 2.0)
        conn.request("GET", "/fleetz")
        body = json.loads(conn.getresponse().read())
        # View holds self + the peer b that just exchanged.
        assert body["self_id"] == "a" and body["member_count"] == 2
        conn.close()
    finally:
        a.stop()


def test_gossip_background_loop_converges():
    a = GossipAgent(
        "a", interval_s=0.05, record_fn=lambda: {"state": "serving"}
    ).start()
    try:
        b = GossipAgent(
            "b", interval_s=0.05, peers=(a.listen_addr,),
            record_fn=lambda: {"state": "serving"},
        ).start()
        try:
            deadline = time.time() + 5
            while time.time() < deadline:
                if "b" in a.view(include_self=False) and \
                        "a" in b.view(include_self=False):
                    break
                time.sleep(0.02)
            assert "b" in a.view(include_self=False)
            assert "a" in b.view(include_self=False)
        finally:
            b.stop()
    finally:
        a.stop()


# ----------------------------------------------------------------- rollout


def _rec(mid, **kw):
    return HealthRecord(id=mid, seq=1, **kw)


def test_coordinator_elects_smallest_replica_and_adopts_fraction():
    co = RolloutCoordinator(clock=lambda: 100.0)
    view = {
        "10.0.0.2:8500": _rec("10.0.0.2:8500", canary=3, canary_fraction=0.2),
        "10.0.0.1:8500": _rec("10.0.0.1:8500", canary=3, canary_fraction=0.1),
        "router": _rec("router", role="router"),
    }
    st = co.tick(view)
    assert st.leader == "10.0.0.1:8500"
    assert st.canary_version == 3 and st.fraction == 0.1
    assert st.seq == 1 and co.adoptions == 1
    # Leader sticky: the other replica's different fraction is ignored.
    view["10.0.0.2:8500"] = _rec(
        "10.0.0.2:8500", canary=3, canary_fraction=0.9
    )
    assert co.tick(view).fraction == 0.1
    # Leader advances its local ramp: the fleet fraction follows.
    view["10.0.0.1:8500"] = _rec(
        "10.0.0.1:8500", canary=3, canary_fraction=0.5
    )
    st = co.tick(view)
    assert st.fraction == 0.5 and st.seq == 2


def test_coordinator_blacklists_and_clears_ramp_same_tick():
    co = RolloutCoordinator(clock=lambda: 100.0)
    view = {
        "a": _rec("a", canary=3, canary_fraction=0.25),
        "b": _rec("b", canary=3, canary_fraction=0.25),
    }
    st = co.tick(view)
    assert st.canary_version == 3
    # ONE replica's judge fires: fleet blacklist + ramp cleared in the
    # SAME tick — no window where other replicas keep ramping v3.
    view["b"] = _rec("b", rolled_back=3)
    st = co.tick(view)
    assert st.blacklist == (3,)
    assert st.canary_version is None and st.fraction == 0.0
    assert st.leader == ""  # a's canary=3 is blacklisted: not electable
    assert co.blacklists == 1 and co.clears == 1
    # A later publish of a NEW version elects normally.
    view = {"a": _rec("a", canary=4, canary_fraction=0.05)}
    st = co.tick(view)
    assert st.canary_version == 4 and 3 in st.blacklist


def test_coordinator_clears_when_canary_vanishes():
    co = RolloutCoordinator(clock=lambda: 0.0)
    st = co.tick({"a": _rec("a", canary=2, canary_fraction=0.5)})
    assert st.canary_version == 2
    # Promotion: the replica stops reporting a canary.
    st = co.tick({"a": _rec("a")})
    assert st.canary_version is None and st.leader == ""


def test_coordinator_persists_and_resumes(tmp_path):
    f = str(tmp_path / "rollout.json")
    co = RolloutCoordinator(f, clock=lambda: 1.0)
    co.tick({"a": _rec("a", rolled_back=7)})
    resumed = RolloutCoordinator(f, clock=lambda: 2.0)
    assert resumed.state().blacklist == (7,)
    assert resumed.state().seq == co.state().seq


class _FakeLifecycle:
    def __init__(self):
        self.fractions = []
        self.blacklisted = []

    def set_fleet_fraction(self, f):
        self.fractions.append(f)

    def fleet_blacklist(self, v):
        self.blacklisted.append(v)
        return "blacklisted"


def test_follower_applies_each_seq_once_and_leader_keeps_local_ramp():
    lc = _FakeLifecycle()
    fo = RolloutFollower(lc, "replica-b")
    st = RolloutState(seq=1, canary_version=3, fraction=0.2,
                      leader="replica-a")
    assert fo.apply(st.to_dict())["fraction"] == 0.2
    assert fo.apply(st.to_dict()) is None  # same seq: exactly once
    assert lc.fractions == [0.2]
    # The LEADER must not follow its own mirrored fraction (the ramp
    # would freeze at its first adopted value): fleet override cleared.
    leader_fo = RolloutFollower(_FakeLifecycle(), "replica-a")
    actions = leader_fo.apply(st)
    assert actions["fraction"] is None
    assert leader_fo.lifecycle.fractions == [None]


def test_follower_applies_blacklist_once_and_clears_override():
    lc = _FakeLifecycle()
    fo = RolloutFollower(lc, "replica-b")
    fo.apply(RolloutState(seq=1, blacklist=(3,)))
    fo.apply(RolloutState(seq=2, blacklist=(3, 4)))
    assert lc.blacklisted == [3, 4]  # v3 applied exactly once
    assert fo.blacklists_applied == 2
    # No fleet canary: local schedule resumes.
    assert lc.fractions[-1] is None


# -------------------------------------------- scoreboard draining fast path


def test_scoreboard_draining_hint_steers_immediately_without_ejection():
    """Regression: ONE draining hint flips the host
    to DRAINING — zero further routed requests while an alternative
    exists, no ejection-budget cycling, no rebuilding busy window."""
    clock = [0.0]
    sb = BackendScoreboard(
        ["a", "b", "c"],
        ScoreboardConfig(failure_threshold=3, ejection_s=5.0,
                         draining_probe_s=3.0),
        clock=lambda: clock[0],
    )
    sb.record_failure(1, kind="draining")
    assert sb.state(1) == DRAINING
    assert sb.ejections == 0 and sb.drains == 1
    # From the FIRST hint: shards homed at 1 never land on it again.
    for _ in range(50):
        assert sb.pick(1) != 1
    # Not the rebuilding path: no busy-window cycling, and further hints
    # only extend the probe horizon (still zero routed requests).
    clock[0] = 2.0
    sb.record_failure(1, kind="draining")
    assert sb.state(1) == DRAINING and sb.rebuilds == 0
    assert sb.pick(1) == 2
    # After draining_probe_s a RESTARTED process may own the address:
    # half-open probing applies (one probe slot, success recovers).
    clock[0] = 5.1
    assert sb.state(1) == HALF_OPEN
    assert sb.pick(1) == 1
    sb.record_success(1)
    assert sb.state(1) == HEALTHY


def test_client_drain_refusal_records_draining_not_ejection(two_backends):
    """The wire path: a draining backend's UNAVAILABLE refusal carries
    'server is draining' — the client flips it to DRAINING on the first
    hint and routes ZERO further requests to it."""
    hosts, impls = two_backends
    impls[1].draining = True
    sb = BackendScoreboard(
        hosts, ScoreboardConfig(failure_threshold=3, ejection_s=5.0)
    )

    async def go():
        async with ShardedPredictClient(
            hosts, "DCN", timeout_s=5.0, scoreboard=sb,
            failover_attempts=1, backoff_initial_s=0.0,
        ) as client:
            results = []
            for _ in range(6):
                results.append(await client.predict(_arrays(n=8)))
            return results, client.resilience_counters()

    results, counters = asyncio.run(go())
    assert all(np.asarray(r).shape == (8,) for r in results)
    assert sb.state(1) == DRAINING
    # Exactly ONE drain hint total: request 1 learned, requests 2..6
    # never touched the draining backend (zero routed requests).
    assert counters["draining_hints"] == 1
    assert sb.ejections == 0 and counters["scoreboard"]["drains"] == 1


# ------------------------------------------------------ grpc.health.v1 Watch


def _watch_collect(call, want: int, timeout_s: float = 10.0):
    out = []
    deadline = time.time() + timeout_s
    for resp in call:
        out.append(resp.status)
        if len(out) >= want or time.time() > deadline:
            break
    return out


def test_health_watch_sync_streams_changes(monkeypatch, two_backends):
    from distributed_tf_serving_tpu_torch.serving.server import GrpcHealthService

    monkeypatch.setattr(GrpcHealthService, "watch_poll_s", 0.05)
    hosts, impls = two_backends
    with grpc.insecure_channel(hosts[0]) as ch:
        stub = health_proto.HealthStub(ch)
        call = stub.Watch(health_proto.HealthCheckRequest(""), timeout=10)
        # Current status streams immediately...
        assert _watch_collect(call, 1) == [health_proto.SERVING]
        # ...and ONLY changes after that: flip to draining mid-stream.
        impls[0].draining = True
        try:
            assert _watch_collect(call, 1) == [health_proto.NOT_SERVING]
        finally:
            impls[0].draining = False
            call.cancel()


def test_health_watch_sync_unknown_service_streams_service_unknown(
    monkeypatch, two_backends
):
    from distributed_tf_serving_tpu_torch.serving.server import GrpcHealthService

    monkeypatch.setattr(GrpcHealthService, "watch_poll_s", 0.05)
    hosts, _ = two_backends
    with grpc.insecure_channel(hosts[0]) as ch:
        stub = health_proto.HealthStub(ch)
        # Per the health spec, Watch answers SERVICE_UNKNOWN in-band
        # (unlike Check's NOT_FOUND abort) and keeps the stream open.
        call = stub.Watch(health_proto.HealthCheckRequest("NOPE"), timeout=10)
        try:
            assert _watch_collect(call, 1) == [health_proto.SERVICE_UNKNOWN]
        finally:
            call.cancel()


def test_health_watch_aio_streams_changes():
    from distributed_tf_serving_tpu_torch.serving.server import (
        AioGrpcHealthService,
        create_server_async,
    )

    registry = ServableRegistry()
    registry.load(_servable())
    batcher = DynamicBatcher(device="cpu", buckets=(32,), max_wait_us=0).start()
    impl = PredictionServiceImpl(registry, batcher)

    async def go():
        import grpc.aio

        old = AioGrpcHealthService.watch_poll_s
        AioGrpcHealthService.watch_poll_s = 0.05
        server, port = create_server_async(impl, "127.0.0.1:0")
        await server.start()
        try:
            async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as ch:
                stub = health_proto.HealthStub(ch)
                call = stub.Watch(health_proto.HealthCheckRequest(""))
                first = (await call.read()).status
                impl.draining = True
                second = (await call.read()).status
                call.cancel()
                return first, second
        finally:
            AioGrpcHealthService.watch_poll_s = old
            await server.stop(0)

    first, second = asyncio.run(go())
    assert first == health_proto.SERVING
    assert second == health_proto.NOT_SERVING
    batcher.stop()


def test_check_not_serving_carries_draining_reason(two_backends):
    """The drain trailer: NOT_SERVING answers carry x-dts-health-reason
    so the client's health probe can distinguish draining (steer away,
    DRAINING state) from a recovery cycle (busy bias)."""
    from distributed_tf_serving_tpu_torch.serving.server import (
        HEALTH_REASON_METADATA_KEY,
    )

    hosts, impls = two_backends
    impls[0].draining = True
    try:
        with grpc.insecure_channel(hosts[0]) as ch:
            stub = health_proto.HealthStub(ch)
            call = stub.Check.with_call(
                health_proto.HealthCheckRequest(""), timeout=5
            )
            resp, rpc = call
            assert resp.status == health_proto.NOT_SERVING
            trailing = dict(rpc.trailing_metadata() or ())
            assert trailing.get(HEALTH_REASON_METADATA_KEY) == "draining"
    finally:
        impls[0].draining = False


# ------------------------------------------------------------------- router


def _router_cfgs(hosts, fleet=None):
    return {
        "server": ServerConfig(host="127.0.0.1", port=0),
        "client": ClientConfig(
            hosts=tuple(hosts), model_name="DCN", num_fields=CFG.num_fields,
            timeout_s=5.0, health_scoreboard=True, failover_attempts=1,
            backoff_initial_ms=0, placement="affinity",
        ),
        "fleet": fleet,
    }


def test_router_fold_gossip_steers_and_rejoins():
    from distributed_tf_serving_tpu_torch.fleet.router import Router

    async def go():
        router = Router(_router_cfgs(["127.0.0.1:1", "127.0.0.1:2"]))
        try:
            sb = router.client.scoreboard
            # A draining announcement steers BEFORE any failed RPC.
            router.fold_gossip(
                HealthRecord(id="127.0.0.1:2", seq=1, state="draining")
            )
            assert sb.state(1) == DRAINING
            assert router.gossip_steers == 1
            # Unknown id: ignored (a replica not in [client] hosts).
            router.fold_gossip(
                HealthRecord(id="10.9.9.9:1", seq=1, state="draining")
            )
            assert router.gossip_steers == 1
            # The restarted replica re-admits itself by speaking.
            router.fold_gossip(
                HealthRecord(id="127.0.0.1:2", seq=2, state="serving")
            )
            assert sb.state(1) == HEALTHY
            assert router.gossip_rejoins == 1
            # Quarantine: steer-around bias, not ejection.
            router.fold_gossip(
                HealthRecord(id="127.0.0.1:1", seq=1, state="quarantined")
            )
            assert sb.ejections == 0 and sb.rebuilds == 1
            assert router.healthy_backends() == 2  # rebuilding stays HEALTHY
        finally:
            await router.client.close()

    asyncio.run(go())


def test_router_end_to_end_bit_identical_scores(two_backends):
    """Acceptance: scores THROUGH the router are bit-identical to a
    direct backend call — same codec both hops, float32 round-trips
    exactly — and edge metadata (criticality/deadline/budget) is
    accepted on the hop."""
    from distributed_tf_serving_tpu_torch.fleet.router import (
        Router,
        RouterHealthService,
        RouterPredictionService,
    )
    from distributed_tf_serving_tpu_torch.proto.service_grpc import (
        PredictionServiceStub,
        add_PredictionServiceServicer_to_server,
    )

    hosts, _ = two_backends
    arrays = _arrays(n=16, seed=11)
    request = build_predict_request(arrays, "DCN", use_tensor_content=True)

    async def go():
        import grpc.aio

        router = Router(_router_cfgs(hosts))
        server = grpc.aio.server()
        add_PredictionServiceServicer_to_server(
            RouterPredictionService(router), server
        )
        health_proto.add_HealthServicer_to_server(
            RouterHealthService(router), server
        )
        port = server.add_insecure_port("127.0.0.1:0")
        await server.start()
        try:
            async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as ch:
                stub = PredictionServiceStub(ch)
                routed = await stub.Predict(
                    request, timeout=10,
                    metadata=(("x-dts-criticality", "sheddable"),
                              ("x-dts-retry-budget", "4")),
                )
                health = await health_proto.HealthStub(ch).Check(
                    health_proto.HealthCheckRequest(""), timeout=5
                )
                wrong = None
                bad = apis.PredictRequest()
                bad.CopyFrom(request)
                bad.model_spec.name = "OTHER"
                try:
                    await stub.Predict(bad, timeout=5)
                except grpc.aio.AioRpcError as e:
                    wrong = e.code()
            async with grpc.aio.insecure_channel(hosts[0]) as ch:
                direct = await PredictionServiceStub(ch).Predict(
                    request, timeout=10
                )
            return routed, direct, health.status, wrong
        finally:
            await server.stop(0)
            await router.client.close()

    routed, direct, health_status, wrong = asyncio.run(go())
    assert health_status == health_proto.SERVING
    assert wrong == grpc.StatusCode.NOT_FOUND
    from distributed_tf_serving_tpu_torch import codec

    got = codec.to_ndarray(routed.outputs["prediction_node"])
    want = codec.to_ndarray(direct.outputs["prediction_node"])
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()  # bit-identical through the hop
    assert routed.model_spec.name == "DCN"


def test_router_gossip_record_carries_rollout_state(tmp_path):
    """The coordinator's state rides the router's own gossip record —
    distribution is the gossip plane itself, no second channel."""
    from distributed_tf_serving_tpu_torch.fleet.router import Router
    from distributed_tf_serving_tpu_torch.utils.config import FleetConfig

    async def go():
        fleet = FleetConfig(
            enabled=True, self_id="router", rollout_writer=True,
            rollout_state_file=str(tmp_path / "rollout.json"),
        )
        router = Router(_router_cfgs(["127.0.0.1:1"], fleet=fleet))
        try:
            router.gossip.merge([{
                "id": "127.0.0.1:1", "seq": 1, "role": "replica",
                "state": "serving", "canary": 5, "canary_fraction": 0.1,
            }])
            rec = router.gossip.self_record()
            assert rec.role == "router"
            assert rec.rollout["canary_version"] == 5
            assert rec.rollout["fraction"] == 0.1
            assert rec.rollout["leader"] == "127.0.0.1:1"
        finally:
            await router.client.close()

    asyncio.run(go())


# ------------------------------------------------------------- replica plane


def test_replica_plane_announce_and_follower_apply():
    from distributed_tf_serving_tpu_torch.fleet.replica import ReplicaFleetPlane
    from distributed_tf_serving_tpu_torch.utils.config import FleetConfig

    hub = GossipAgent("hub", record_fn=lambda: {
        "state": "serving",
        "rollout": RolloutState(
            seq=3, canary_version=2, fraction=0.4, leader="other"
        ).to_dict(),
    }).start()
    try:
        lc = _FakeLifecycle()
        plane = ReplicaFleetPlane(
            FleetConfig(enabled=True, self_id="replica-1",
                        peers=(hub.listen_addr,)),
            record_fn=lambda: {"state": "draining"},
            lifecycle=lc,
        )
        # announce() pushes one round NOW (drain propagation) and pulls
        # the hub's record back — whose rollout state applies through
        # the follower.
        plane.announce()
        assert hub.view(include_self=False)["replica-1"].state == "draining"
        assert lc.fractions == [0.4]
        assert plane.follower.applied_seq == 3
        snap = plane.snapshot()
        assert snap["role"] == "replica"
        assert snap["rollout_follower"]["applied_seq"] == 3
        stats = plane.fleet_stats()
        assert stats["role"] == "replica" and "gossip" in stats
    finally:
        hub.stop()


# ------------------------------------------- the port against the JAX package

from distributed_tf_serving_tpu.fleet import gossip as jax_gossip  # noqa: E402
from distributed_tf_serving_tpu.fleet import rollout as jax_rollout  # noqa: E402

_RECORDS = [
    dict(id="127.0.0.1:9001", seq=1_700_000_000_123_456_789, role="replica", state="serving",
         pressure="BROWNOUT", versions=(3, 2), canary=3, canary_fraction=0.25, rolled_back=None,
         rollout={"seq": 4, "canary_version": 3, "fraction": 0.25, "blacklist": [1]},
         obs={"addr": "127.0.0.1:7001", "qps": 12.5, "p50_ms": 1.25, "p99_ms": 9.0,
              "requests": 40, "errors": 1, "trace_export": True},
         suspect=True, wall_ts=1234.5),
    dict(id="router", seq=7, role="router"),
    dict(id="r2", seq=9, state="draining", versions=(1,), rolled_back=2),
]


@pytest.mark.parametrize("fields", _RECORDS, ids=["full", "router", "draining"])
def test_health_record_json_equals_the_jax_package_s(fields):
    ours = HealthRecord(**fields)
    theirs = jax_gossip.HealthRecord(**fields)
    assert json.dumps(ours.to_dict()) == json.dumps(theirs.to_dict())
    back = HealthRecord.from_dict(json.loads(json.dumps(theirs.to_dict())))
    assert json.dumps(back.to_dict()) == json.dumps(ours.to_dict())


def test_rollout_state_json_and_coordinator_equal_the_jax_package_s(tmp_path):
    st = dict(seq=5, canary_version=4, fraction=0.3, leader="127.0.0.1:1", blacklist=(2, 3))
    assert json.dumps(RolloutState(**st).to_dict()) == \
        json.dumps(jax_rollout.RolloutState(**st).to_dict())
    clock = [100.0]
    ours = RolloutCoordinator(str(tmp_path / "ours.json"), clock=lambda: clock[0])
    theirs = jax_rollout.RolloutCoordinator(str(tmp_path / "theirs.json"),
                                            clock=lambda: clock[0])
    views = [
        {"a": _rec("a", canary=4, canary_fraction=0.1), "b": _rec("b")},
        {"a": _rec("a", canary=4, canary_fraction=0.3), "b": _rec("b", canary=4,
                                                                  canary_fraction=0.2)},
        {"a": _rec("a", rolled_back=4), "b": _rec("b", canary=4, canary_fraction=0.3)},
        {"a": _rec("a"), "b": _rec("b")},
    ]
    for view in views:
        clock[0] += 1.0
        jview = {k: jax_gossip.HealthRecord(**dataclasses.asdict(v)) for k, v in view.items()}
        assert json.dumps(ours.tick(view).to_dict()) == json.dumps(theirs.tick(jview).to_dict())
        assert (tmp_path / "ours.json").read_text() == (tmp_path / "theirs.json").read_text()
    assert ours.snapshot() == theirs.snapshot()


def test_a_jax_and_a_port_agent_converge_in_one_mesh():
    """A mixed fleet: a JAX package agent, and two port agents that list
    only it as a peer, all learn every member's record through it."""
    hub = jax_gossip.GossipAgent("jax-hub", interval_s=0.05,
                                 record_fn=lambda: {"state": "serving"}).start()
    members = []
    try:
        for name, state in (("port-a", "serving"), ("port-b", "draining")):
            members.append(GossipAgent(name, interval_s=0.05, peers=(hub.listen_addr,),
                                       record_fn=lambda s=state: {"state": s}).start())
        want = {"jax-hub", "port-a", "port-b"}
        deadline = time.time() + 10
        while time.time() < deadline:
            views = [set(a.view(include_self=True)) for a in (hub, *members)]
            if all(v == want for v in views):
                break
            time.sleep(0.02)
        assert set(hub.view(include_self=True)) == want
        for a in members:
            view = a.view(include_self=True)
            assert set(view) == want
            assert view["port-b"].state == "draining"
            assert view["jax-hub"].state == "serving"
    finally:
        for a in members:
            a.stop()
        hub.stop()


def test_a_restarted_replica_s_first_record_wins_over_the_killed_one_s(monkeypatch):
    """`seq` is time.time_ns at publish: a replica restarted under the same
    id publishes a higher seq than anything its killed predecessor sent, so
    its first record replaces the old one everywhere (fake clock)."""
    now = [1_000_000_000]
    monkeypatch.setattr(gossip_mod.time, "time_ns", lambda: now[0])
    fake = lambda: now[0] / 1e9  # noqa: E731
    router = GossipAgent("router", clock=fake)
    old = GossipAgent("127.0.0.1:9001", clock=fake, record_fn=lambda: {"state": "serving"})
    router.merge([old.self_record().to_dict()])
    now[0] += 5_000_000  # the old process is SIGKILLed 5 ms later, mid-interval
    assert router.view(include_self=False)["127.0.0.1:9001"].state == "serving"
    now[0] += 2_000_000_000  # the restart comes up 2 s later, same id
    new = GossipAgent("127.0.0.1:9001", clock=fake, record_fn=lambda: {"state": "starting"})
    first = new.self_record()
    assert first.seq > router.view(include_self=False)["127.0.0.1:9001"].seq
    assert [r.state for r in router.merge([first.to_dict()])] == ["starting"]
    # A late copy of the killed process's last record is stale now.
    assert router.merge([old.self_record().to_dict() | {"seq": first.seq - 1}]) == []
    assert router.view(include_self=False)["127.0.0.1:9001"].state == "starting"


def test_port_router_over_port_replicas_holds_to_the_jax_server(two_backends):
    """The slice as a whole on the CPU: a port router over two port
    replicas answers within 1e-5 (f32) of the JAX server on the same
    weights, carried across by convert.py."""
    from distributed_tf_serving_tpu.models import Servable as JaxServable
    from distributed_tf_serving_tpu.models import ServableRegistry as JaxRegistry
    from distributed_tf_serving_tpu.models import ctr_signatures as jax_signatures
    from distributed_tf_serving_tpu.serving import DynamicBatcher as JaxBatcher
    from distributed_tf_serving_tpu.serving import PredictionServiceImpl as JaxImpl
    from distributed_tf_serving_tpu.serving import create_server as jax_create_server
    from distributed_tf_serving_tpu_torch import codec
    from distributed_tf_serving_tpu_torch.fleet.router import Router, RouterPredictionService
    from distributed_tf_serving_tpu_torch.proto.service_grpc import (
        PredictionServiceStub,
        add_PredictionServiceServicer_to_server,
    )

    hosts, _ = two_backends
    registry = JaxRegistry()
    registry.load(JaxServable(
        name="DCN", version=1,
        model=jax_build("dcn_v2", JaxConfig(**dataclasses.asdict(CFG))),
        params=jax.tree.map(jax.numpy.asarray, _jax_params(0)),
        signatures=jax_signatures(CFG.num_fields)))
    jbatcher = JaxBatcher(buckets=(32, 128), max_wait_us=0).start()
    jserver, jport = jax_create_server(JaxImpl(registry, jbatcher), "127.0.0.1:0")
    jserver.start()
    request = build_predict_request(_arrays(n=40, seed=19), "DCN", use_tensor_content=True)

    async def go():
        import grpc.aio

        router = Router(_router_cfgs(hosts))
        server = grpc.aio.server()
        add_PredictionServiceServicer_to_server(RouterPredictionService(router), server)
        port = server.add_insecure_port("127.0.0.1:0")
        await server.start()
        try:
            async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as ch:
                routed = await PredictionServiceStub(ch).Predict(request, timeout=10)
            async with grpc.aio.insecure_channel(f"127.0.0.1:{jport}") as ch:
                ref = await PredictionServiceStub(ch).Predict(request, timeout=10)
            return routed, ref
        finally:
            await server.stop(0)
            await router.client.close()

    try:
        routed, ref = asyncio.run(go())
    finally:
        jserver.stop(0)
        jbatcher.stop()
    got = codec.to_ndarray(routed.outputs["prediction_node"])
    want = codec.to_ndarray(ref.outputs["prediction_node"])
    assert got.shape == want.shape == (40,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
