"""Fleet-wide observability plane.

Three router-side pieces, all device-free and stdlib-only:

- **TraceCollector**: ingests `Span.to_dict` trees exported by every
  process in a request's path — the router's own recorder, each
  replica's `/tracez/export?since=` pull surface, and edge clients
  pushing to `/tracez/ingest` — and STITCHES the local trees sharing a
  trace_id into one cross-process tree. Every exported payload carries a
  clock anchor (tracing.clock_anchor), so spans land on a shared
  wall-clock timeline first; the residual per-hop skew is then solved
  NTP-style from the RPC send/recv pair (the parent `client.rpc` span in
  one process and the remote-parented server root in the next bracket
  the same wire exchange), and the child tree is shifted so it nests
  inside its parent. `/tracez` on the router serves the stitched trees
  and a multi-pid Chrome export Perfetto loads with one process track
  per fleet member.

- **Hop waterfall**: each stitched tree is decomposed into the fleet
  hops — client_send, router_queue, replica_queue_wait, device,
  readback_wait, merge — with the unattributed remainder reported as
  `other`, never hidden (the waterfall invariant at fleet scope);
  a windowed ring aggregates the per-trace decompositions.

- **FleetObservabilityPlane + SloMonitor**: a periodic tick scrapes each
  member's `/monitoring` wire (utils.metrics fleet_wire) off the gossip
  port and merges the windowed histograms into one fleet aggregate
  (`GET /fleet/monitoring`, dts_tpu_fleet_agg_*); members that fail the
  scrape degrade to the cheap summary piggybacked on their gossip
  records instead of vanishing. The same tick feeds monotonic
  (restart-clamped) request/error/over-latency-target counters into the
  SLO monitor, which computes multi-window error-budget burn rates for
  the configured latency and availability objectives (`GET /sloz`,
  dts_tpu_slo_*). While both burn windows exceed the fast threshold the
  router annotates in-flight `router.route` spans with `slo.burn`, so
  the tail sampler force-keeps exactly the traces that explain the
  breach.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from collections import OrderedDict, deque

from ..utils.metrics import _EDGES_US, WindowedLatency
from ..utils import tracing
from .gossip import _open_connection

log = logging.getLogger("dts_torch.fleet.observability")

# Hop components in pipeline order. Extraction is by span/phase NAME —
# the names are the tracing plane's stable vocabulary (client/client.py,
# serving/batcher.py); a hop whose spans are absent contributes 0 and its
# time lands in `other`.
WATERFALL_COMPONENTS = (
    "client_send", "router_queue", "replica_queue_wait",
    "device", "readback_wait", "merge",
)


def _http_get_json(addr: str, path: str, timeout: float):
    """GET a JSON body from a gossip-style endpoint ("host:port" or
    "unix:/path")."""
    conn = _open_connection(addr, timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        data = resp.read()
        if resp.status != 200:
            raise OSError(f"{addr}{path} answered {resp.status}")
    finally:
        conn.close()
    return json.loads(data)


def _walk(node: dict):
    yield node
    for c in node.get("children") or ():
        yield from _walk(c)


def _copy_tree(node: dict) -> dict:
    out = dict(node)
    out["attrs"] = dict(node.get("attrs") or {})
    out["children"] = [_copy_tree(c) for c in node.get("children") or ()]
    return out


def _shift_tree(node: dict, delta_us: int) -> None:
    for n in _walk(node):
        n["start_us"] = int(n["start_us"]) + delta_us
        if n.get("annotations"):
            n["annotations"] = [
                {**a, "t": int(a.get("t", 0)) + delta_us}
                for a in n["annotations"]
            ]


def _find_all(node: dict, names: tuple) -> list[dict]:
    return [n for n in _walk(node) if n.get("name") in names]


def _earliest(nodes: list[dict]) -> dict | None:
    return min(nodes, key=lambda n: n["start_us"]) if nodes else None


def hop_waterfall(top: dict) -> dict | None:
    """Decompose one stitched tree into the fleet hop components.

    The components partition the ROOT's duration by construction:
    sum(components) + other == total exactly (`other` may dip slightly
    negative when hops overlap — reported, never clamped away silently;
    individual components clamp at 0 so a skew-misordered pair cannot
    produce a negative hop)."""
    total = int(top.get("duration_us") or 0)
    if total <= 0:
        return None
    t0 = int(top["start_us"])

    routers = _find_all(top, ("router.route",))
    router = _earliest([r for r in routers if r is not top]) or (
        top if top.get("name") == "router.route" else None
    )
    scope = router or top

    # The RPC hop that carried the request to a replica: prefer an
    # attempt with a stitched server-side tree under it.
    rpcs = _find_all(scope, ("client.rpc",))
    server = None
    rpc = None
    for cand in sorted(rpcs, key=lambda n: n["start_us"]):
        srv = _earliest([
            c for c in cand.get("children") or ()
            if str(c.get("name", "")).startswith("server.")
        ])
        if srv is not None:
            rpc, server = cand, srv
            break
    if rpc is None:
        rpc = _earliest(rpcs)

    comps = dict.fromkeys(WATERFALL_COMPONENTS, 0)
    if router is not None and router is not top:
        comps["client_send"] = int(router["start_us"]) - t0
    if rpc is not None:
        base = router if router is not None else top
        comps["router_queue"] = (
            int(rpc["start_us"]) - int(base["start_us"])
        )
    if server is not None:
        comps["replica_queue_wait"] = sum(
            int(n.get("duration_us") or 0)
            for n in _find_all(server, ("batch.queue_wait",))
        )
        device = _find_all(server, ("batch.dispatch",)) or _find_all(
            server, ("batch.jitcall", "predict.execute")
        )
        comps["device"] = sum(int(n.get("duration_us") or 0) for n in device)
        comps["readback_wait"] = sum(
            int(n.get("duration_us") or 0)
            for n in _find_all(server, ("readback.wait", "batch.readback"))
        )
    own_source = top.get("source")
    merges = [
        n for n in _find_all(top, ("client.merge",))
        if n.get("source") == own_source
    ]
    comps["merge"] = sum(int(n.get("duration_us") or 0) for n in merges)

    comps = {k: max(0, int(v)) for k, v in comps.items()}
    other = total - sum(comps.values())
    return {
        "total_us": total,
        "components_us": comps,
        "other_us": int(other),
    }


class TraceCollector:
    """Bounded store of exported span trees keyed by trace_id, with
    cross-process stitching, the windowed hop waterfall, and the
    multi-pid Chrome export. Thread-safe: gossip handler threads push,
    the plane tick pulls, and operator requests read concurrently."""

    def __init__(
        self,
        *,
        max_traces: int = 512,
        waterfall_window_s: float = 120.0,
        clock=time.time,
    ):
        self.max_traces = max(1, int(max_traces))
        self.waterfall_window_s = float(waterfall_window_s)
        self._clock = clock
        self._lock = threading.Lock()
        # trace_id -> {"roots": {span_id: node}, "t": last ingest wall}
        self._traces: "OrderedDict[str, dict]" = OrderedDict()
        # source -> {"pid": anchor pid, "t": last ingest}
        self._sources: dict[str, dict] = {}
        # trace_id -> (wall t, waterfall dict) — latest decomposition per
        # stitched trace; the windowed aggregate reads values in-window.
        self._waterfalls: "OrderedDict[str, tuple[float, dict]]" = OrderedDict()
        self.ingested_spans = 0
        self.ingested_payloads = 0
        self.stitch_attached = 0

    # ------------------------------------------------------------- ingest

    def ingest(self, source: str, payload: dict) -> int:
        """Fold one export payload (tracing.TraceRecorder.export_since
        shape) into the store. Every node is shifted onto the wall clock
        via the payload's anchor and tagged with its source."""
        clock = payload.get("clock") or {}
        try:
            wall_off = int(clock["unix_us"]) - int(clock["perf_us"])
        except (KeyError, TypeError, ValueError):
            return 0  # no anchor -> cannot place on the shared timeline
        pid = clock.get("pid")
        now = self._clock()
        accepted = 0
        with self._lock:
            self._sources[source] = {"pid": pid, "t": now}
            for tree in payload.get("spans") or ():
                if not isinstance(tree, dict) or "span_id" not in tree:
                    continue
                root = _copy_tree(tree)
                _shift_tree(root, wall_off)
                for n in _walk(root):
                    n["source"] = source
                trace_id = str(root.get("trace_id") or "")
                if not trace_id:
                    continue
                entry = self._traces.get(trace_id)
                if entry is None:
                    entry = {"roots": OrderedDict(), "t": now}
                    self._traces[trace_id] = entry
                    while len(self._traces) > self.max_traces:
                        dropped_id, _ = self._traces.popitem(last=False)
                        self._waterfalls.pop(dropped_id, None)
                entry["roots"][root["span_id"]] = root
                entry["t"] = now
                self._traces.move_to_end(trace_id)
                accepted += 1
                self.ingested_spans += 1
            self.ingested_payloads += 1
        return accepted

    # -------------------------------------------------------- stitching

    @staticmethod
    def _stitch(roots: list[dict]) -> tuple[list[dict], int]:
        """Stitch one trace's local roots (fresh copies) into as few
        trees as possible. Returns (top-level trees, hops attached).

        Shifts are resolved top-down BEFORE attachment: a child root's
        total shift is its parent root's total shift minus the locally
        measured skew, so chains (edge client -> router -> replica) never
        double-shift."""
        roots = [_copy_tree(r) for r in roots]
        nodes: dict[str, dict] = {}
        owner: dict[str, dict] = {}
        for r in roots:
            for n in _walk(r):
                nodes[n["span_id"]] = n
                owner[n["span_id"]] = r
        edges: dict[int, tuple[dict, dict, float]] = {}  # id(child root)
        children_of: dict[int, list[dict]] = {}
        tops: list[dict] = []
        for r in roots:
            parent = nodes.get(r.get("parent_id") or "")
            if parent is None or owner[parent["span_id"]] is r:
                tops.append(r)
                continue
            skew = 0.0
            if r.get("source") != parent.get("source"):
                c0 = int(r["start_us"])
                c1 = c0 + int(r.get("duration_us") or 0)
                p0 = int(parent["start_us"])
                p1 = p0 + int(parent.get("duration_us") or 0)
                # NTP pair: the parent span brackets the child span's
                # wire exchange; half the sum of the edge offsets is the
                # child clock's residual lead over the parent clock.
                skew = ((c0 - p0) + (c1 - p1)) / 2.0
            edges[id(r)] = (parent, owner[parent["span_id"]], skew)
            children_of.setdefault(id(owner[parent["span_id"]]), []).append(r)
        # Total shift per root, walked from the tops down.
        shift: dict[int, int] = {}
        stack = [(t, 0) for t in tops]
        while stack:
            root, total = stack.pop()
            if id(root) in shift:
                continue  # cycle guard (corrupt parent links)
            shift[id(root)] = total
            for child in children_of.get(id(root), ()):
                _parent, _powner, skew = edges[id(child)]
                stack.append((child, total - int(round(skew))))
        attached = 0
        for r in roots:
            if id(r) not in shift:  # unreachable from any top: keep as top
                shift[id(r)] = 0
                tops.append(r)
        for r in roots:
            delta = shift[id(r)]
            if delta:
                _shift_tree(r, delta)
            edge = edges.get(id(r))
            if edge is not None:
                parent, _powner, skew = edge
                r["stitched"] = True
                if skew:
                    r["clock_skew_us"] = int(round(skew))
                parent.setdefault("children", []).append(r)
                attached += 1
        tops.sort(key=lambda n: n["start_us"])
        return tops, attached

    def stitched(self, limit: int = 50) -> list[dict]:
        """The newest `limit` traces, stitched. Also refreshes the
        windowed waterfall ring for every multi-process trace seen."""
        with self._lock:
            items = list(self._traces.items())[-max(1, int(limit)):]
        now = self._clock()
        out = []
        for trace_id, entry in reversed(items):
            tops, attached = self._stitch(list(entry["roots"].values()))
            sources = sorted({
                n.get("source") or "?" for t in tops for n in _walk(t)
            })
            wf = hop_waterfall(tops[0]) if len(tops) == 1 else None
            tr = {
                "trace_id": trace_id,
                "processes": sources,
                "num_processes": len(sources),
                "stitched_hops": attached,
                "duration_us": (
                    int(tops[0].get("duration_us") or 0)
                    if len(tops) == 1 else int(
                        max(
                            int(t["start_us"]) + int(t.get("duration_us") or 0)
                            for t in tops
                        ) - min(int(t["start_us"]) for t in tops)
                    )
                ),
                "waterfall": wf,
                "spans": tops,
            }
            out.append(tr)
            if wf is not None and len(sources) >= 2:
                with self._lock:
                    self._waterfalls[trace_id] = (entry["t"], wf)
                    self._waterfalls.move_to_end(trace_id)
                    while len(self._waterfalls) > self.max_traces:
                        self._waterfalls.popitem(last=False)
        if attached_total := sum(t["stitched_hops"] for t in out):
            self.stitch_attached = max(self.stitch_attached, attached_total)
        _ = now
        return out

    # -------------------------------------------------------- waterfall

    def waterfall_window(self) -> dict:
        """Windowed mean of the per-trace hop decompositions."""
        now = self._clock()
        with self._lock:
            recent = [
                wf for (t, wf) in self._waterfalls.values()
                if now - t <= self.waterfall_window_s
            ]
        n = len(recent)
        means = dict.fromkeys(WATERFALL_COMPONENTS, 0.0)
        other = total = 0.0
        for wf in recent:
            for k in WATERFALL_COMPONENTS:
                means[k] += wf["components_us"].get(k, 0)
            other += wf["other_us"]
            total += wf["total_us"]
        if n:
            means = {k: round(v / n, 1) for k, v in means.items()}
            other, total = round(other / n, 1), round(total / n, 1)
        return {
            "window_s": self.waterfall_window_s,
            "traces": n,
            "mean_components_us": means,
            "mean_other_us": other,
            "mean_total_us": total,
        }

    # --------------------------------------------------------- surfaces

    def counters(self) -> dict:
        with self._lock:
            multi = sum(
                1 for e in self._traces.values()
                if len({
                    n.get("source") for r in e["roots"].values()
                    for n in _walk(r)
                }) >= 2
            )
            return {
                "traces_retained": len(self._traces),
                "multi_process_traces": multi,
                "ingested_spans": self.ingested_spans,
                "ingested_payloads": self.ingested_payloads,
                "sources": {
                    s: dict(meta) for s, meta in self._sources.items()
                },
            }

    def tracez(self, limit: int = 50) -> dict:
        """The router's /tracez body: stitched cross-process trees plus
        collector counters and the windowed waterfall."""
        traces = self.stitched(limit)
        return {
            "enabled": True,
            "role": "collector",
            **self.counters(),
            "waterfall": self.waterfall_window(),
            "traces": traces,
        }

    def chrome_trace(self, limit: int = 100) -> dict:
        """Multi-pid Chrome trace-event export of the STITCHED traces
        (single-process traces are omitted — the member's own /tracez
        already serves those): one pid per fleet process (the exporter's
        real OS pid when known), one tid per trace, hop-waterfall
        components as `wf_*_us` args on each root event."""
        stitched = [
            t for t in self.stitched(limit) if t["num_processes"] >= 2
        ]
        pid_map: dict[str, int] = {}
        with self._lock:
            known = {s: m.get("pid") for s, m in self._sources.items()}
        used: set[int] = set()
        for tr in stitched:
            for src in tr["processes"]:
                if src in pid_map:
                    continue
                pid = known.get(src)
                if not isinstance(pid, int) or pid in used:
                    pid = 100000 + len(pid_map)
                    while pid in used:
                        pid += 1
                pid_map[src] = pid
                used.add(pid)
        events: list[dict] = []
        for src, pid in pid_map.items():
            events.append({
                "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                "args": {"name": src},
            })
        starts = [
            int(n["start_us"])
            for tr in stitched for top in tr["spans"] for n in _walk(top)
        ]
        t_base = min(starts, default=0)
        span_events: list[dict] = []
        for tid, tr in enumerate(stitched):
            for top in tr["spans"]:
                for sp in _walk(top):
                    args = {
                        "trace_id": sp.get("trace_id"),
                        "span_id": sp.get("span_id"),
                        "parent_id": sp.get("parent_id"),
                        "status": sp.get("status"),
                        "source": sp.get("source"),
                        **(sp.get("attrs") or {}),
                    }
                    if sp.get("stitched"):
                        args["stitched"] = True
                        args["clock_skew_us"] = sp.get("clock_skew_us", 0)
                    if sp is top and tr.get("waterfall"):
                        wf = tr["waterfall"]
                        for k, v in wf["components_us"].items():
                            args[f"wf_{k}_us"] = int(v)
                        args["wf_other_us"] = int(wf["other_us"])
                    span_events.append({
                        "ph": "X",
                        "name": sp.get("name", "span"),
                        "cat": "span" if sp is top else "phase",
                        "pid": pid_map.get(sp.get("source"), 0),
                        "tid": tid,
                        "ts": max(0, int(sp["start_us"]) - t_base),
                        "dur": max(0, int(sp.get("duration_us") or 0)),
                        "args": args,
                    })
        # Non-decreasing ts within every (pid, tid) track — sorted
        # globally, which subsumes the per-track requirement.
        span_events.sort(key=lambda e: e["ts"])
        events.extend(span_events)
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "producer": "distributed_tf_serving_tpu_torch.fleet",
                "stitched_traces": len(stitched),
            },
        }


class SloMonitor:
    """Multi-window error-budget burn rates over the aggregated fleet
    counter stream (the SRE-workbook alerting shape: page when BOTH a
    short and a long window burn faster than the fast threshold).

    Ingests CUMULATIVE fleet counters (the plane clamps per-member deltas
    at >= 0 across member restarts, so these only grow): request/error
    totals for the availability SLI, lifetime-latency totals and
    over-target counts for the latency SLI. Burn rate over a window =
    (bad fraction in the window) / (1 - objective)."""

    def __init__(self, cfg, clock=time.time):
        self.cfg = cfg
        self._clock = clock
        self._lock = threading.Lock()
        # (t, requests, errors, lat_total, lat_over) cumulative samples.
        self._samples: deque[tuple] = deque(maxlen=8192)
        self.breached = False
        self.warn = False
        self.breaches = 0

    def ingest(
        self, *, requests: int, errors: int, lat_total: int, lat_over: int
    ) -> bool:
        """Append one cumulative sample; re-evaluates and returns the
        breach state."""
        now = self._clock()
        with self._lock:
            self._samples.append(
                (now, int(requests), int(errors), int(lat_total),
                 int(lat_over))
            )
        burn = self.burn_rates()
        fast, slow = self.cfg.burn_threshold_fast, self.cfg.burn_threshold_slow
        breached = any(
            w["short"] >= fast and w["long"] >= fast for w in burn.values()
        )
        self.warn = any(
            w["short"] >= slow and w["long"] >= slow for w in burn.values()
        )
        if breached and not self.breached:
            self.breaches += 1
        self.breached = breached
        return breached

    def _window_deltas(self, window_s: float) -> tuple[int, int, int, int]:
        """Clamped deltas between now and the sample nearest the window's
        far edge."""
        now = self._clock()
        with self._lock:
            if not self._samples:
                return 0, 0, 0, 0
            cur = self._samples[-1]
            base = None
            for s in self._samples:
                if s[0] >= now - window_s:
                    base = s
                    break
            if base is None or base is cur:
                # Window older than retention, or a single sample: no
                # measurable delta yet.
                base = self._samples[0]
        return tuple(
            max(0, cur[i] - base[i]) for i in range(1, 5)
        )  # type: ignore[return-value]

    def burn_rates(self) -> dict:
        out = {}
        lat_budget = max(1e-9, 1.0 - self.cfg.latency_objective)
        avail_budget = max(1e-9, 1.0 - self.cfg.availability_objective)
        for name, window_s in (
            ("short", self.cfg.short_window_s),
            ("long", self.cfg.long_window_s),
        ):
            d_req, d_err, d_lat_total, d_lat_over = self._window_deltas(
                window_s
            )
            avail_bad = d_err / d_req if d_req else 0.0
            lat_bad = d_lat_over / d_lat_total if d_lat_total else 0.0
            out.setdefault("availability", {})[name] = round(
                avail_bad / avail_budget, 4
            )
            out.setdefault("latency", {})[name] = round(
                lat_bad / lat_budget, 4
            )
        return out

    def snapshot(self) -> dict:
        burn = self.burn_rates()
        with self._lock:
            last = self._samples[-1] if self._samples else (0, 0, 0, 0, 0)
            n = len(self._samples)
        return {
            "enabled": True,
            "latency_target_ms": self.cfg.latency_target_ms,
            "objectives": {
                "latency": self.cfg.latency_objective,
                "availability": self.cfg.availability_objective,
            },
            "windows": {
                "short_s": self.cfg.short_window_s,
                "long_s": self.cfg.long_window_s,
            },
            "thresholds": {
                "fast": self.cfg.burn_threshold_fast,
                "slow": self.cfg.burn_threshold_slow,
            },
            "burn": burn,
            # Long-window budget view: burn 1.0 over the long window
            # consumes exactly that window's share of the budget.
            "budget_remaining": {
                slo: round(max(0.0, 1.0 - w["long"]), 4)
                for slo, w in burn.items()
            },
            "breached": self.breached,
            "warn": self.warn,
            "breaches": self.breaches,
            "samples": n,
            "totals": {
                "requests": last[1],
                "errors": last[2],
                "lat_total": last[3],
                "lat_over_target": last[4],
            },
        }


def _over_target(lifetime: dict, target_us: float) -> int:
    """Requests in a lifetime wire histogram slower than the target.
    Bucket-resolution approximate (a request counts as good only when
    its bucket's upper edge is under the target — 12.5% edge growth)."""
    total = int(lifetime.get("total") or 0)
    good = 0
    for k, c in (lifetime.get("buckets") or {}).items():
        i = int(k)
        if 0 <= i < len(_EDGES_US) and _EDGES_US[i] <= target_us:
            good += int(c)
    return max(0, total - good)


class FleetObservabilityPlane:
    """The router's aggregation half: one daemon thread ticks every
    `interval_s`, scraping member wires + pulling member trace exports,
    folding the results into the aggregate, the SLO monitor, and the
    trace collector. All member discovery rides the gossip view (the
    piggybacked `obs` digest names each member's scrape address)."""

    def __init__(
        self,
        *,
        members_fn,
        self_source: str = "router",
        local_export=None,
        slo_cfg=None,
        interval_s: float = 1.0,
        dial_timeout_s: float = 1.0,
        clock=time.time,
    ):
        self.members_fn = members_fn
        self.self_source = self_source
        self.local_export = local_export
        self.interval_s = max(0.05, float(interval_s))
        self.dial_timeout_s = float(dial_timeout_s)
        self._clock = clock
        self.collector = TraceCollector(clock=clock)
        self.slo = (
            SloMonitor(slo_cfg, clock=clock)
            if slo_cfg is not None and slo_cfg.enabled else None
        )
        self._lock = threading.Lock()
        self._agg: dict = {}
        self._member_stats: dict = {}
        self._trace_cursors: dict[str, int] = {}
        self._local_cursor = 0
        # Per-member cumulative baselines for the SLO stream (clamped so
        # a member restart never subtracts from the fleet counters).
        self._member_last: dict[str, tuple[int, int, int, int]] = {}
        self._cum = [0, 0, 0, 0]  # requests, errors, lat_total, lat_over
        self.ticks = 0
        self.scrape_failures = 0
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    # The router's forward() hot path reads this one attribute per
    # request when deciding whether to annotate — no lock, no call.
    @property
    def slo_breached(self) -> bool:
        return self.slo is not None and self.slo.breached

    # --------------------------------------------------------------- tick

    def tick(self) -> None:
        members = {}
        try:
            members = dict(self.members_fn() or {})
        except Exception:  # noqa: BLE001 — discovery must not kill the loop
            log.exception("fleet obs: members_fn failed")
        tracing_on = tracing.enabled()
        wires: dict[str, dict] = {}
        summaries: dict[str, dict] = {}
        for mid, rec in members.items():
            role = getattr(rec, "role", None) or (rec or {}).get("role")
            if role != "replica":
                continue
            obs = getattr(rec, "obs", None)
            if obs is None and isinstance(rec, dict):
                obs = rec.get("obs")
            obs = obs or {}
            summaries[mid] = obs
            addr = obs.get("addr")
            if addr:
                try:
                    wires[mid] = _http_get_json(
                        addr, "/monitoring", self.dial_timeout_s
                    )
                except Exception:  # noqa: BLE001 — scrape-unreachable is
                    self.scrape_failures += 1  # the designed degradation
                if tracing_on and obs.get("trace_export"):
                    self._pull_traces(mid, addr)
        if tracing_on and self.local_export is not None:
            try:
                payload = self.local_export(self._local_cursor)
                self.collector.ingest(self.self_source, payload)
                self._local_cursor = int(payload.get("cursor") or 0)
            except Exception:  # noqa: BLE001
                log.exception("fleet obs: local trace export failed")
        self._aggregate(wires, summaries)
        if tracing_on:
            # Refresh stitching so the waterfall window fills even when
            # nobody is hitting /tracez.
            self.collector.stitched(limit=25)
        self.ticks += 1

    def _pull_traces(self, mid: str, addr: str) -> None:
        since = self._trace_cursors.get(mid, 0)
        try:
            payload = _http_get_json(
                addr, f"/tracez/export?since={since}", self.dial_timeout_s
            )
        except Exception:  # noqa: BLE001
            return
        if not payload.get("enabled", True):
            return
        self.collector.ingest(mid, payload)
        try:
            self._trace_cursors[mid] = int(payload.get("cursor") or 0)
        except (TypeError, ValueError):
            pass

    def _aggregate(self, wires: dict, summaries: dict) -> None:
        member_stats: dict[str, dict] = {}
        member_qps: dict[str, float] = {}
        win_wires: list[dict] = []
        tick_counts: dict[str, tuple[int, int, int, int]] = {}
        for mid, summary in summaries.items():
            wire = wires.get(mid)
            if wire is not None:
                try:
                    stats = WindowedLatency.wire_stats(wire["window"])
                    requests = int(wire.get("ok", 0)) + int(
                        wire.get("errors", 0)
                    )
                    errors = int(wire.get("errors", 0))
                    lifetime = wire.get("lifetime") or {}
                    lat_total = int(lifetime.get("total") or 0)
                    lat_over = (
                        _over_target(
                            lifetime,
                            self.slo.cfg.latency_target_ms * 1e3,
                        ) if self.slo is not None else 0
                    )
                    member_stats[mid] = {
                        "scraped": True,
                        "requests": requests,
                        "errors": errors,
                        **stats,
                    }
                    member_qps[mid] = stats["qps"]
                    win_wires.append(wire["window"])
                    tick_counts[mid] = (requests, errors, lat_total, lat_over)
                    continue
                except (KeyError, TypeError, ValueError):
                    pass  # malformed wire -> gossip fallback below
            if "qps" in summary:
                requests = int(summary.get("requests") or 0)
                errors = int(summary.get("errors") or 0)
                member_stats[mid] = {
                    "scraped": False,
                    "requests": requests,
                    "errors": errors,
                    "qps": float(summary.get("qps") or 0.0),
                    "p50_ms": summary.get("p50_ms"),
                    "p99_ms": summary.get("p99_ms"),
                }
                member_qps[mid] = float(summary.get("qps") or 0.0)
                # No lifetime histogram on the gossip digest: carry the
                # availability counters, hold the latency stream flat.
                tick_counts[mid] = (requests, errors, 0, 0)
        # Fleet cumulative counters with per-member restart clamping.
        for mid, counts in tick_counts.items():
            last = self._member_last.get(mid)
            if last is not None:
                for i in range(4):
                    self._cum[i] += max(0, counts[i] - last[i])
            else:
                for i in range(4):
                    self._cum[i] += counts[i]
            self._member_last[mid] = counts
        for gone in set(self._member_last) - set(tick_counts):
            # TTL-expired member: drop the baseline so a rejoin re-counts
            # from its fresh totals instead of clamping against history.
            del self._member_last[gone]
        merged = WindowedLatency.merge_dicts(win_wires)
        merged_stats = WindowedLatency.wire_stats(merged)
        degraded = [
            m for m, st in member_stats.items() if not st["scraped"]
        ]
        agg = {
            "qps": round(sum(member_qps.values()), 3),
            "p50_ms": merged_stats["p50_ms"],
            "p99_ms": merged_stats["p99_ms"],
            "requests": sum(st["requests"] for st in member_stats.values()),
            "errors": sum(st["errors"] for st in member_stats.values()),
            "members": len(member_stats),
            "members_degraded": len(degraded),
            "member_qps": member_qps,
        }
        with self._lock:
            self._agg = agg
            self._member_stats = member_stats
        if self.slo is not None:
            self.slo.ingest(
                requests=self._cum[0], errors=self._cum[1],
                lat_total=self._cum[2], lat_over=self._cum[3],
            )

    def _loop(self, stop: threading.Event) -> None:
        while not stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the plane must outlive a
                log.exception("fleet obs tick failed")  # bad tick

    def start(self) -> "FleetObservabilityPlane":
        if self._thread is None or not self._thread.is_alive():
            self._stop = threading.Event()
            self._thread = threading.Thread(
                target=self._loop, args=(self._stop,),
                name="fleet-obs", daemon=True,
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    # ----------------------------------------------------------- surfaces

    def ingest_push(self, payload: dict) -> dict:
        """POST /tracez/ingest body: an export_since payload plus a
        `source` name — edge clients push their span trees here so
        stitched traces include the first hop."""
        source = str((payload or {}).get("source") or "client")
        accepted = self.collector.ingest(source, payload or {})
        return {"accepted": accepted}

    def aggregate_snapshot(self) -> dict:
        """The GET /fleet/monitoring body."""
        with self._lock:
            agg = dict(self._agg)
            member_stats = {
                m: dict(st) for m, st in self._member_stats.items()
            }
        out = {
            "interval_s": self.interval_s,
            "ticks": self.ticks,
            "scrape_failures": self.scrape_failures,
            "aggregate": agg,
            "members": member_stats,
            "waterfall": self.collector.waterfall_window(),
            "traces": self.collector.counters(),
        }
        if self.slo is not None:
            out["slo"] = self.slo.snapshot()
        return out

    def slo_snapshot(self) -> dict:
        """The GET /sloz body."""
        if self.slo is None:
            return {"enabled": False}
        return self.slo.snapshot()

    def agg_block(self) -> dict:
        """The `agg` block fleet_stats() feeds dts_tpu_fleet_agg_*."""
        with self._lock:
            return dict(self._agg)

    def slo_block(self) -> dict | None:
        """The `slo` block fleet_stats() feeds dts_tpu_slo_*."""
        return None if self.slo is None else self.slo.snapshot()
