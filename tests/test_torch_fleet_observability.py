"""The port's fleet observability plane (fleet/observability.py and the
metrics' fleet wire), case for case as the JAX package's
tests/test_fleet_observability.py holds its own: mergeable latency wires,
the incremental trace-export cursor, cross-process trace stitching and the
hop waterfall, the multi-pid Chrome export, the SLO burn-rate monitor, the
gossip query/POST routes the surfaces mount on, and the router's
/monitoring parity. Below those cases, the same collector, waterfall, SLO
script and fleet exposition fed to the JAX package's give the same
answers."""

import asyncio
import json
import threading
import urllib.request

import pytest

from distributed_tf_serving_tpu_torch.fleet.gossip import GossipAgent, HealthRecord
from distributed_tf_serving_tpu_torch.fleet import observability as obs_mod
from distributed_tf_serving_tpu_torch.fleet.observability import (
    WATERFALL_COMPONENTS,
    FleetObservabilityPlane,
    SloMonitor,
    TraceCollector,
    hop_waterfall,
)
from distributed_tf_serving_tpu_torch.utils import tracing
from distributed_tf_serving_tpu_torch.utils.config import (
    ClientConfig,
    ServerConfig,
    SloConfig,
)
from distributed_tf_serving_tpu_torch.utils.metrics import (
    ServerMetrics,
    WindowedLatency,
)


# ------------------------------------------------------- latency wires


def test_windowed_latency_wire_roundtrip_and_merge():
    a = WindowedLatency(window_s=60.0)
    b = WindowedLatency(window_s=60.0)
    for ms in (1, 2, 5, 10):
        a.record(ms / 1e3)
    for ms in (20, 50):
        b.record(ms / 1e3)
    wa, wb = a.to_dict(), b.to_dict()
    counts, total, sum_us, min_us, max_us = WindowedLatency.from_dict(wa)
    assert total == 4 and sum(counts) == 4
    assert min_us == pytest.approx(1000, rel=0.2)
    merged = WindowedLatency.merge_dicts([wa, wb])
    stats = WindowedLatency.wire_stats(merged)
    assert stats["count"] == 6
    # Merged rate = sum of member rates (each total/effective-window).
    ra = WindowedLatency.wire_stats(wa)["qps"]
    rb = WindowedLatency.wire_stats(wb)["qps"]
    assert stats["qps"] == pytest.approx(ra + rb, rel=0.01)
    # Percentiles live inside the merged sample range.
    assert 1.0 <= stats["p50_ms"] <= 50.0 * 1.2
    assert stats["p99_ms"] >= stats["p50_ms"]


def test_empty_wire_merges_clean():
    merged = WindowedLatency.merge_dicts([])
    stats = WindowedLatency.wire_stats(merged)
    assert stats["count"] == 0 and stats["qps"] == 0.0


def test_server_metrics_fleet_wire_and_summary():
    m = ServerMetrics(window_s=60.0)
    m.observe("Predict", 0.002, ok=True)
    m.observe("Predict", 0.004, ok=True)
    m.observe("Predict", 0.008, ok=False)
    wire = m.fleet_wire()
    assert wire["ok"] == 2 and wire["errors"] == 1
    assert wire["lifetime"]["total"] == 3
    summary = m.fleet_summary()
    assert summary["requests"] == 3 and summary["errors"] == 1
    assert summary["qps"] > 0


# ------------------------------------------------- export ring / cursor


def test_export_since_cursor_semantics():
    tracing.enable(buffer_size=16, sample_rate=1.0)
    try:
        with tracing.start_root("r1"):
            pass
        first = tracing.recorder().export_since(0)
        assert first["enabled"] and len(first["spans"]) == 1
        assert {"perf_us", "unix_us", "pid"} <= set(first["clock"])
        cursor = first["cursor"]
        assert tracing.recorder().export_since(cursor)["spans"] == []
        with tracing.start_root("r2"):
            pass
        second = tracing.recorder().export_since(cursor)
        assert [s["name"] for s in second["spans"]] == ["r2"]
        # A cursor from a PREVIOUS recorder incarnation (ahead of the
        # ring) replays from the start instead of silently skipping.
        stale = tracing.recorder().export_since(cursor + 10_000)
        assert len(stale["spans"]) == 2
    finally:
        tracing.disable()


# -------------------------------------------------- stitch + waterfall


def _span(name, trace_id, span_id, start_us, dur_us, parent=None,
          children=(), attrs=None):
    return {
        "name": name, "trace_id": trace_id, "span_id": span_id,
        "parent_id": parent, "start_us": int(start_us),
        "duration_us": int(dur_us), "status": "ok",
        "attrs": dict(attrs or {}), "annotations": [],
        "children": [dict(c) for c in children],
    }


def _payload(spans, perf_us, unix_us, pid):
    return {
        "enabled": True,
        "clock": {"perf_us": perf_us, "unix_us": unix_us, "pid": pid},
        "cursor": 1,
        "spans": spans,
    }


def _three_source_collector():
    """Client -> router -> replica, each on its OWN perf clock with a
    distinct wall anchor, replica skewed +2ms off true wall."""
    tid = "t" * 32
    # Client clock: perf 0 == wall 1_000_000us.
    rpc = _span("client.rpc", tid, "c-rpc", 100, 9_800)
    merge = _span("client.merge", tid, "c-merge", 9_930, 50)
    client_root = _span(
        "client.predict", tid, "c-root", 0, 10_000,
        children=[rpc, merge],
    )
    # Router clock: perf 5_000_000 == wall 1_000_000us (so raw start_us
    # values are totally disjoint from the client's until anchored).
    r_rpc = _span("client.rpc", tid, "r-rpc", 5_001_000, 7_000)
    r_embed = _span(
        "client.predict", tid, "r-embed", 5_000_900, 7_300,
        parent="r-root", children=[r_rpc],
    )
    router_root = _span(
        "router.route", tid, "r-root", 5_000_500, 8_000, parent="c-rpc",
    )
    # Replica clock: perf 0 == wall 1_002_000us — a +2ms skew the NTP
    # pairing must measure and remove.
    qw = _span("batch.queue_wait", tid, "s-qw", 1_300, 1_000)
    dev = _span("batch.dispatch", tid, "s-dev", 2_300, 3_000)
    rb = _span("readback.wait", tid, "s-rb", 5_300, 800)
    server_root = _span(
        "server.predict", tid, "s-root", 1_200, 5_500, parent="r-rpc",
        children=[qw, dev, rb],
    )
    col = TraceCollector()
    col.ingest("client", _payload([client_root], 0, 1_000_000, 101))
    col.ingest("router", _payload([router_root, r_embed],
                                  5_000_000, 1_000_000, 202))
    col.ingest("replica-0", _payload([server_root], 0, 1_002_000, 303))
    return col, tid


def test_collector_stitches_three_sources_into_one_tree():
    col, tid = _three_source_collector()
    traces = col.stitched()
    assert len(traces) == 1
    tr = traces[0]
    assert tr["trace_id"] == tid
    assert tr["num_processes"] == 3
    assert sorted(tr["processes"]) == ["client", "replica-0", "router"]
    # ONE tree: every hop attached under the edge client's root.
    assert len(tr["spans"]) == 1
    top = tr["spans"][0]
    assert top["name"] == "client.predict"
    assert tr["stitched_hops"] == 3  # router<-client, embed, server<-rpc
    by_id = {n["span_id"]: n for n in obs_mod._walk(top)}
    assert by_id["r-root"]["stitched"] and by_id["s-root"]["stitched"]
    # The replica's +2ms anchor skew was measured and removed: its
    # shifted start lands INSIDE the router rpc span that carried it.
    rpc = by_id["r-rpc"]
    srv = by_id["s-root"]
    assert rpc["start_us"] <= srv["start_us"]
    assert (srv["start_us"] + srv["duration_us"]
            <= rpc["start_us"] + rpc["duration_us"] + 1)


def test_hop_waterfall_components_close_exactly():
    col, _ = _three_source_collector()
    tr = col.stitched()[0]
    wf = tr["waterfall"]
    assert wf is not None
    assert set(wf["components_us"]) == set(WATERFALL_COMPONENTS)
    # The decomposition partitions the root: components + other == total
    # EXACTLY (other may be negative on hop overlap — reported, never
    # clamped away).
    assert sum(wf["components_us"].values()) + wf["other_us"] \
        == wf["total_us"]
    assert wf["total_us"] == 10_000
    c = wf["components_us"]
    assert c["client_send"] > 0       # router started after the client
    assert c["replica_queue_wait"] == 1_000
    assert c["device"] == 3_000
    assert c["readback_wait"] == 800
    assert c["merge"] == 50
    assert all(v >= 0 for v in c.values())
    # The windowed aggregate saw this trace.
    win = col.waterfall_window()
    assert win["traces"] == 1
    assert win["mean_total_us"] == pytest.approx(10_000)


def test_hop_waterfall_none_without_duration():
    assert hop_waterfall({"name": "x", "start_us": 0,
                          "duration_us": 0}) is None


def test_chrome_export_is_multi_pid_and_sorted():
    col, tid = _three_source_collector()
    doc = col.chrome_trace()
    events = doc["traceEvents"]
    pids = {e["pid"] for e in events if e["ph"] == "X"}
    assert len(pids) == 3  # one pid per fleet process
    names = {
        (e["args"] or {}).get("name")
        for e in events if e["ph"] == "M" and e["name"] == "process_name"
    }
    assert {"client", "router", "replica-0"} <= names
    xs = [e for e in events if e["ph"] == "X"]
    assert all(e["args"]["trace_id"] == tid for e in xs)
    assert [e["ts"] for e in xs] == sorted(e["ts"] for e in xs)
    # The root event carries the hop waterfall as wf_* args that close
    # against its own dur within the checker's 2% tolerance.
    root = next(e for e in xs if e["name"] == "client.predict")
    wf_sum = sum(v for k, v in root["args"].items()
                 if k.startswith("wf_"))
    assert abs(wf_sum - root["dur"]) <= max(0.02 * root["dur"], 1)
    # Single-process traces are omitted from the fleet export.
    col.ingest("client", _payload(
        [_span("client.predict", "u" * 32, "solo", 0, 100)],
        0, 1_000_000, 101,
    ))
    doc2 = col.chrome_trace()
    assert not any(
        e["ph"] == "X" and e["args"].get("trace_id") == "u" * 32
        for e in doc2["traceEvents"]
    )


def test_collector_ignores_payload_without_anchor():
    col = TraceCollector()
    assert col.ingest("x", {"spans": [
        _span("a", "v" * 32, "s1", 0, 10)
    ]}) == 0


# --------------------------------------------------------- SLO monitor


def _slo_cfg(**kw):
    base = dict(
        enabled=True, latency_target_ms=50.0, latency_objective=0.99,
        availability_objective=0.999, short_window_s=10.0,
        long_window_s=60.0, burn_threshold_fast=14.4,
        burn_threshold_slow=6.0,
    )
    base.update(kw)
    return SloConfig(**base)


def test_slo_monitor_burn_rates_and_breach_edge():
    t = [0.0]
    mon = SloMonitor(_slo_cfg(), clock=lambda: t[0])
    # Clean traffic: zero burn.
    mon.ingest(requests=1000, errors=0, lat_total=1000, lat_over=0)
    t[0] = 5.0
    mon.ingest(requests=2000, errors=0, lat_total=2000, lat_over=0)
    burn = mon.burn_rates()
    assert burn["availability"]["short"] == 0.0
    assert burn["latency"]["long"] == 0.0
    assert not mon.breached and mon.breaches == 0
    # 10% errors in-window: availability burn = 0.10 / 0.001 = 100x ≫
    # fast on BOTH windows (the whole history fits the long window).
    t[0] = 8.0
    breached = mon.ingest(
        requests=3000, errors=100, lat_total=3000, lat_over=0
    )
    assert breached and mon.breached and mon.breaches == 1
    assert mon.burn_rates()["availability"]["short"] >= 14.4
    # Still breached: the edge counter must NOT increment again.
    t[0] = 9.0
    mon.ingest(requests=3100, errors=110, lat_total=3100, lat_over=0)
    assert mon.breaches == 1
    snap = mon.snapshot()
    assert snap["enabled"] and snap["breached"]
    assert snap["totals"]["errors"] == 110
    assert snap["budget_remaining"]["availability"] == 0.0
    assert 0.0 <= snap["budget_remaining"]["latency"] <= 1.0


def test_slo_short_burn_alone_does_not_page():
    """Multi-window: a short-window spike with a quiet long window must
    not breach (that is the whole point of the two-window shape)."""
    t = [0.0]
    mon = SloMonitor(_slo_cfg(short_window_s=5.0, long_window_s=200.0),
                     clock=lambda: t[0])
    # A long clean history dilutes the long window.
    for i in range(10):
        t[0] = i * 10.0
        mon.ingest(requests=(i + 1) * 10_000, errors=0,
                   lat_total=(i + 1) * 10_000, lat_over=0)
    # A clean sample inside the short window anchors its far edge...
    t[0] = 98.0
    mon.ingest(requests=100_000, errors=0, lat_total=100_000, lat_over=0)
    # ...then a spike: 100% errors over the last 100 requests.
    t[0] = 101.0
    mon.ingest(requests=100_100, errors=100, lat_total=100_100,
               lat_over=0)
    burn = mon.burn_rates()
    assert burn["availability"]["short"] >= 14.4
    assert burn["availability"]["long"] < 14.4
    assert not mon.breached


def test_slo_config_validation():
    with pytest.raises(ValueError):
        SloConfig(latency_objective=1.0)
    with pytest.raises(ValueError):
        SloConfig(short_window_s=60.0, long_window_s=60.0)
    with pytest.raises(ValueError):
        SloConfig(burn_threshold_fast=0)


# ----------------------------------------------- plane aggregation tick


class _Rec:
    def __init__(self, role="replica", obs=None):
        self.role = role
        self.obs = obs


def test_plane_aggregates_scraped_and_degraded_members(monkeypatch):
    scraped = ServerMetrics(window_s=60.0)
    for _ in range(10):
        scraped.observe("Predict", 0.002, ok=True)
    scraped.observe("Predict", 0.2, ok=False)  # over the 50ms target
    wire = scraped.fleet_wire()

    def fake_get(addr, path, timeout):
        assert path == "/monitoring"
        if addr == "127.0.0.1:7001":
            return wire
        raise OSError("unreachable")

    monkeypatch.setattr(obs_mod, "_http_get_json", fake_get)
    t = [100.0]
    members = {
        "m-up": _Rec(obs={"addr": "127.0.0.1:7001",
                          "trace_export": False}),
        "m-down": _Rec(obs={"addr": "127.0.0.1:7002", "qps": 5.0,
                            "p50_ms": 3.0, "p99_ms": 9.0,
                            "requests": 500, "errors": 2}),
        "router-peer": _Rec(role="router"),
    }
    plane = FleetObservabilityPlane(
        members_fn=lambda: members, slo_cfg=_slo_cfg(),
        clock=lambda: t[0],
    )
    plane.tick()
    agg = plane.agg_block()
    assert agg["members"] == 2 and agg["members_degraded"] == 1
    assert agg["requests"] == 11 + 500
    assert agg["errors"] == 1 + 2
    member_qps = agg["member_qps"]
    assert member_qps["m-down"] == 5.0
    assert agg["qps"] == pytest.approx(sum(member_qps.values()), rel=0.01)
    assert plane.scrape_failures == 1
    snap = plane.aggregate_snapshot()
    assert snap["members"]["m-up"]["scraped"] is True
    assert snap["members"]["m-down"]["scraped"] is False
    # The SLO stream folded both members' counters cumulatively; the
    # scraped member's slow request registered against the 50ms target.
    slo = plane.slo_snapshot()
    assert slo["totals"]["requests"] == 511
    assert slo["totals"]["errors"] == 3
    assert slo["totals"]["lat_over_target"] >= 1
    # A member restart (counters reset) must never subtract: deltas
    # clamp at zero.
    t[0] = 101.0
    fresh = ServerMetrics(window_s=60.0)
    fresh.observe("Predict", 0.001, ok=True)
    wire = fresh.fleet_wire()
    plane.tick()
    assert plane.slo_snapshot()["totals"]["requests"] >= 511


def test_plane_ingest_push_and_slo_breached_property():
    plane = FleetObservabilityPlane(members_fn=dict)
    assert plane.slo_breached is False  # slo off -> one attribute read
    out = plane.ingest_push({
        "source": "client",
        "clock": {"perf_us": 0, "unix_us": 1_000_000, "pid": 1},
        "spans": [_span("client.predict", "w" * 32, "p1", 0, 10)],
    })
    assert out == {"accepted": 1}
    assert plane.collector.counters()["traces_retained"] == 1


# --------------------------------------- gossip query/POST route mounts


def test_gossip_query_and_post_routes_over_http():
    seen = {}

    def q_route(query):
        seen["q"] = query
        return {"echo": query.get("since")}

    def p_route(payload):
        seen["p"] = payload
        return {"accepted": len(payload.get("spans") or [])}

    agent = GossipAgent(
        "n1", host="127.0.0.1", port=0, peers=[],
        record_fn=lambda: {"state": "serving"},
        query_routes={"/tracez/export": q_route},
        post_routes={"/tracez/ingest": p_route},
    )
    agent.start()
    try:
        base = f"http://{agent.listen_addr}"
        with urllib.request.urlopen(
            f"{base}/tracez/export?since=42", timeout=5
        ) as r:
            assert json.loads(r.read()) == {"echo": "42"}
        assert seen["q"]["since"] == "42"
        req = urllib.request.Request(
            f"{base}/tracez/ingest",
            data=json.dumps({"spans": [1, 2]}).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=5) as r:
            assert json.loads(r.read()) == {"accepted": 2}
    finally:
        agent.stop()


def test_health_record_obs_roundtrip():
    rec = HealthRecord(
        id="r0", seq=7, state="serving",
        obs={"addr": "127.0.0.1:9", "qps": 12.5, "p50_ms": 2.0,
             "p99_ms": 8.0, "requests": 100, "errors": 1,
             "trace_export": True},
    )
    back = HealthRecord.from_dict(
        json.loads(json.dumps(rec.to_dict()))
    )
    assert back.obs == rec.obs


# ------------------------------------------------- router /monitoring


def _router_cfgs(hosts):
    return {
        "server": ServerConfig(host="127.0.0.1", port=0),
        "client": ClientConfig(
            hosts=tuple(hosts), model_name="DCN", num_fields=8,
            timeout_s=5.0, health_scoreboard=True, failover_attempts=1,
            backoff_initial_ms=0, placement="affinity",
        ),
        "fleet": None,
    }


def test_router_monitoring_parity_surface():
    from distributed_tf_serving_tpu_torch.fleet.router import Router

    async def go():
        router = Router(_router_cfgs(["127.0.0.1:1", "127.0.0.1:2"]))
        try:
            router.window.record(0.003)
            router.window.record(0.005)
            mon = router.monitoring()
            assert mon["role"] == "router"
            assert mon["window"]["count"] == 2
            assert mon["window"]["p50_ms"] >= 3.0
            assert mon["counters"]["requests"] == 0
            assert mon["healthy_backends"] == 2
            assert "scoreboard" in mon
            # Per-backend windows armed at construction, idle so far.
            bw = mon["backend_windows"]
            assert set(bw) == {"127.0.0.1:1", "127.0.0.1:2"}
            assert all(s["count"] == 0 for s in bw.values())
            # Fleet-plane blocks absent without [fleet] — and so is the
            # plane itself (zero threads on a plain router).
            assert router.plane is None
            assert "fleet_aggregate" not in mon
            assert "slo" not in mon
        finally:
            await router.client.close()

    asyncio.run(go())


def test_client_backend_windows_record_per_host():
    from distributed_tf_serving_tpu_torch.client import ShardedPredictClient

    async def go():
        c = ShardedPredictClient(["127.0.0.1:1", "127.0.0.1:2"], "DCN")
        try:
            assert c.backend_window_snapshots() == {}
            c.enable_backend_windows(window_s=30.0)
            c._backend_windows["127.0.0.1:1"].record(0.004)
            snaps = c.backend_window_snapshots()
            assert snaps["127.0.0.1:1"]["count"] == 1
            assert snaps["127.0.0.1:2"]["count"] == 0
        finally:
            await c.close()

    asyncio.run(go())


# ------------------------------------------- the port against the JAX package

from distributed_tf_serving_tpu.fleet import observability as jax_obs  # noqa: E402
from distributed_tf_serving_tpu.utils import config as jax_config  # noqa: E402
from distributed_tf_serving_tpu.utils import metrics as jax_metrics  # noqa: E402
from distributed_tf_serving_tpu_torch.utils import metrics as port_metrics  # noqa: E402


def _collector_of(mod):
    """The three-source payloads of _three_source_collector, ingested by
    `mod`'s TraceCollector."""
    tid = "t" * 32
    rpc = _span("client.rpc", tid, "c-rpc", 100, 9_800)
    merge = _span("client.merge", tid, "c-merge", 9_930, 50)
    client_root = _span("client.predict", tid, "c-root", 0, 10_000, children=[rpc, merge])
    r_rpc = _span("client.rpc", tid, "r-rpc", 5_001_000, 7_000)
    r_embed = _span("client.predict", tid, "r-embed", 5_000_900, 7_300, parent="r-root",
                    children=[r_rpc])
    router_root = _span("router.route", tid, "r-root", 5_000_500, 8_000, parent="c-rpc")
    qw = _span("batch.queue_wait", tid, "s-qw", 1_300, 1_000)
    dev = _span("batch.dispatch", tid, "s-dev", 2_300, 3_000)
    rb = _span("readback.wait", tid, "s-rb", 5_300, 800)
    server_root = _span("server.predict", tid, "s-root", 1_200, 5_500, parent="r-rpc",
                        children=[qw, dev, rb])
    col = mod.TraceCollector()
    col.ingest("client", _payload([client_root], 0, 1_000_000, 101))
    col.ingest("router", _payload([router_root, r_embed], 5_000_000, 1_000_000, 202))
    col.ingest("replica-0", _payload([server_root], 0, 1_002_000, 303))
    return col


def test_stitching_waterfall_and_chrome_export_equal_the_jax_package_s():
    ours, theirs = _collector_of(obs_mod), _collector_of(jax_obs)
    assert json.dumps(ours.stitched(), sort_keys=True) == \
        json.dumps(theirs.stitched(), sort_keys=True)
    assert ours.waterfall_window() == theirs.waterfall_window()
    got, want = ours.chrome_trace(), theirs.chrome_trace()
    # The metadata names the producing package; everything else is equal.
    assert got["otherData"].pop("producer") == "distributed_tf_serving_tpu_torch.fleet"
    assert want["otherData"].pop("producer") == "distributed_tf_serving_tpu.fleet"
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    root = ours.stitched()[0]["spans"][0]
    assert obs_mod.hop_waterfall(root) == jax_obs.hop_waterfall(root)


def test_slo_monitor_equals_the_jax_package_s_under_one_script():
    kw = dict(enabled=True, latency_target_ms=50.0, latency_objective=0.99,
              availability_objective=0.999, short_window_s=5.0, long_window_s=30.0)
    t = [0.0]
    ours = SloMonitor(SloConfig(**kw), clock=lambda: t[0])
    theirs = jax_obs.SloMonitor(jax_config.SloConfig(**kw), clock=lambda: t[0])
    req = err = over = 0
    rng = __import__("random").Random(3)
    for step in range(40):
        t[0] = step * 1.0
        req += 500
        err += rng.choice((0, 0, 0, 1, 20))
        over += rng.choice((0, 2, 30))
        a = ours.ingest(requests=req, errors=err, lat_total=req, lat_over=over)
        b = theirs.ingest(requests=req, errors=err, lat_total=req, lat_over=over)
        assert a == b
        assert ours.burn_rates() == theirs.burn_rates()
    assert ours.snapshot() == theirs.snapshot()


def test_fleet_wire_summary_and_expositions_equal_the_jax_package_s():
    t = [0.0]
    ours = ServerMetrics(window_s=10.0, clock=lambda: t[0])
    theirs = jax_metrics.ServerMetrics(window_s=10.0, clock=lambda: t[0])
    for i in range(200):
        t[0] = i * 0.01
        for m in (ours, theirs):
            m.observe("Predict", 0.0005 * (1 + i % 17), i % 23 != 0, model="DCN")
            if i % 5 == 0:
                m.observe("GetModelMetadata", 0.0001, True)
    t[0] = 2.5
    assert ours.fleet_wire() == theirs.fleet_wire()
    assert ours.fleet_summary() == theirs.fleet_summary()
    stats = {
        "role": "router",
        "gossip": {"member_count": 3, "members": {"a": {"state": "serving"},
                                                   "b": {"state": "draining"}},
                   "counters": {"exchanges_ok": 9, "exchanges_failed": 1, "records_accepted": 4,
                                "records_stale": 2, "records_expired": 1}},
        "rollout": {"state": {"seq": 3, "fraction": 0.2, "canary_version": 4, "blacklist": [2]},
                    "counters": {"adoptions": 2, "blacklists": 1, "clears": 0}},
        "router": {"requests": 10, "errors": 1, "degraded": 0, "gossip_steers": 2,
                   "gossip_rejoins": 1, "watch_updates": 5, "suspect_steers": 0,
                   "integrity_audits": 3, "audit_disagreements": 0,
                   "audit_suspects_marked": 0, "healthy_backends": 2, "backends": 3},
        "agg": {"qps": 12.5, "p50_ms": 1.0, "p99_ms": 4.0, "requests": 99, "errors": 1,
                "members": 3, "members_degraded": 1, "member_qps": {"a": 6.0, "b": 6.5}},
        "slo": {"latency_target_ms": 50.0, "objectives": {"latency": 0.99},
                "burn": {"latency": {"short": 1.5, "long": 0.5}},
                "budget_remaining": {"latency": 0.7}, "breached": False, "breaches": 0},
    }
    replica = {"role": "replica", "gossip": stats["gossip"],
               "follower": {"applied_seq": 3, "applies": 2, "blacklists_applied": 1}}
    for s in (stats, replica):
        assert port_metrics.fleet_prometheus_text(s) == jax_metrics.fleet_prometheus_text(s)
    assert ours.prometheus_text(fleet=replica).endswith(
        "\n".join(port_metrics._fleet_prometheus_lines(replica)) + "\n")
    resilience = {"hedges_fired": 2, "hedges_won": 1, "failovers": 3, "backoff_sleeps": 1,
                  "partial_responses": 0,
                  "scoreboard": {"ejections": 1, "probes": 2, "recoveries": 1,
                                 "backends": {"h:1": {"state": "healthy", "ewma_ms": 1.5,
                                                      "successes": 4, "failures": 1}}}}
    assert port_metrics.resilience_prometheus_text(resilience) == \
        jax_metrics.resilience_prometheus_text(resilience)
