"""Cross-replica health gossip.

Every fleet member — replica or router — runs one `GossipAgent`: a tiny
stdlib HTTP (or Unix-domain-socket) listener plus a push-pull exchange
loop. Each interval the agent POSTs its full view (its own fresh
`HealthRecord` + everything it has heard) to every configured peer; the
peer merges, then answers with ITS full view, which the caller merges
back. One round therefore moves information BOTH ways, so the fleet
converges through any live peer in common — no seed ordering, no leader.

Records are versioned and monotonic: each carries a `seq` stamped from
`time.time_ns()` at publish, and a member's record is replaced only by a
HIGHER seq for the same member id. A restarted process (fresh memory,
same id) keeps winning because wall-clock nanoseconds outrun any seq it
could have published before dying — the classic gossip resurrection
guard without persisted epochs. Records unheard for `ttl_s` expire from
the view: a SIGKILLed member says no goodbye, it just goes silent.

The record is deliberately compact — the fleet's steering inputs only:

    {"id": "r1", "seq": 173..., "role": "replica",
     "state": "serving" | "draining" | "quarantined" | "starting",
     "pressure": "ok" | "overloaded" | "",
     "versions": [1, 2], "canary": 2, "canary_fraction": 0.25,
     "rolled_back": null, "rollout": {...} | null, "wall_ts": 173...}

`rollout` piggybacks the shared rollout state (fleet/rollout.py) on the
same exchange, so rollout distribution needs no second protocol.

Everything here is device-free and thread-based (the listener is a
ThreadingHTTPServer; the exchange loop is one daemon thread), so a
replica embeds it next to the grpc server without touching the event
loop, and tests drive `exchange_once()` with no threads at all.
"""

from __future__ import annotations

import dataclasses
import http.client
import http.server
import json
import logging
import socket
import threading
import time

log = logging.getLogger("dts_torch.fleet.gossip")

# Health-record states (what the router folds into scoreboard steering).
SERVING = "serving"
DRAINING = "draining"
QUARANTINED = "quarantined"
STARTING = "starting"


@dataclasses.dataclass
class HealthRecord:
    """One member's published health, versioned by `seq` (time_ns at
    publish — monotonic across process restarts of the same id)."""

    id: str
    seq: int
    role: str = "replica"  # "replica" | "router"
    state: str = STARTING
    pressure: str = ""
    versions: tuple[int, ...] = ()
    canary: int | None = None
    canary_fraction: float = 0.0
    rolled_back: int | None = None
    rollout: dict | None = None
    # Cheap observability digest: {"addr": gossip listen addr,
    # "qps", "p50_ms", "p99_ms", "requests", "errors", "trace_export"} —
    # the router's fleet aggregator falls back to these self-reported
    # numbers when a member's /monitoring scrape fails, and learns where
    # (and whether) to pull the member's span-tree export.
    obs: dict | None = None
    # Data-integrity verdict: True while the member's
    # integrity plane holds itself suspect (shadow mismatch / screen-trip
    # escalation not yet rehabilitated). Routers steer around suspect
    # replicas; older peers' from_dict drops the key harmlessly
    # (wire-compatible, the obs-field precedent).
    suspect: bool = False
    wall_ts: float = 0.0

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["versions"] = list(self.versions)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "HealthRecord":
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in d.items() if k in known}
        kwargs["versions"] = tuple(int(v) for v in kwargs.get("versions", ()))
        return cls(**kwargs)


class _UdsHTTPServer(http.server.ThreadingHTTPServer):
    """ThreadingHTTPServer over AF_UNIX (gossip_uds: co-located fleets
    skip the TCP stack, the transport-floor precedent)."""

    address_family = socket.AF_UNIX

    def server_bind(self):
        import os

        try:
            if os.path.exists(self.server_address):
                os.unlink(self.server_address)
        except OSError:
            pass  # bind below gives the actionable error
        self.socket.bind(self.server_address)

    def server_close(self):
        import os

        super().server_close()
        try:
            os.unlink(self.server_address)
        except OSError:
            pass


class _UdsHTTPConnection(http.client.HTTPConnection):
    def __init__(self, path: str, timeout: float):
        super().__init__("localhost", timeout=timeout)
        self._uds_path = path

    def connect(self):
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(self.timeout)
        sock.connect(self._uds_path)
        self.sock = sock


def _open_connection(peer: str, timeout: float) -> http.client.HTTPConnection:
    """Dial a peer endpoint: "host:port" (TCP) or "unix:/path"."""
    if peer.startswith("unix:"):
        return _UdsHTTPConnection(peer[len("unix:"):], timeout)
    host, _, port = peer.rpartition(":")
    return http.client.HTTPConnection(host, int(port), timeout=timeout)


class GossipAgent:
    """One fleet member's gossip half: listener + push-pull exchanger.

    `record_fn()` returns the member's CURRENT health as a dict of
    HealthRecord fields (sans id/seq/wall_ts — the agent stamps those at
    publish). `on_update(record)` fires for every accepted REMOTE record
    change (the router folds these into its scoreboard; a replica's
    rollout follower applies coordinator state). `extra_routes` maps GET
    paths to zero-arg callables returning a JSON-able body — the router
    mounts /metrics there so one port serves gossip and scrape.
    `query_routes` is the same for routes that take URL query parameters
    (called with a {key: first value} dict — the trace-export pull's
    `?since=` cursor), and `post_routes` maps POST paths to callables
    taking the decoded JSON body (the router's /tracez/ingest push).
    """

    def __init__(
        self,
        self_id: str,
        *,
        role: str = "replica",
        host: str = "127.0.0.1",
        port: int = 0,
        uds_path: str = "",
        peers: tuple[str, ...] = (),
        interval_s: float = 0.5,
        ttl_s: float = 5.0,
        record_fn=None,
        on_update=None,
        extra_routes: dict | None = None,
        query_routes: dict | None = None,
        post_routes: dict | None = None,
        clock=time.time,
        seq_fn=time.time_ns,
        dial_timeout_s: float = 2.0,
    ):
        self.self_id = self_id
        self.role = role
        self.peers = tuple(peers)
        self.interval_s = interval_s
        self.ttl_s = ttl_s
        self.record_fn = record_fn or (lambda: {})
        self.on_update = on_update
        self.extra_routes = dict(extra_routes or {})
        self.query_routes = dict(query_routes or {})
        self.post_routes = dict(post_routes or {})
        self._clock = clock
        self._seq = seq_fn
        self._dial_timeout_s = dial_timeout_s
        self._lock = threading.Lock()
        # id -> (HealthRecord, local receipt time) — receipt time drives
        # TTL expiry (a peer's wall clock never gates ITS liveness here).
        self._view: dict[str, tuple[HealthRecord, float]] = {}
        # Counters (all monotonic; /fleetz + dts_tpu_fleet_*).
        self.exchanges_ok = 0
        self.exchanges_failed = 0
        self.records_accepted = 0
        self.records_stale = 0
        self.records_expired = 0
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._server: http.server.ThreadingHTTPServer | None = None
        self._server_thread: threading.Thread | None = None
        self._uds_path = uds_path
        self._host, self._port = host, port

    # ------------------------------------------------------------ records

    def self_record(self) -> HealthRecord:
        """Stamp the member's current health as a fresh record."""
        fields = dict(self.record_fn() or {})
        fields.pop("id", None)
        fields.pop("seq", None)
        fields.setdefault("role", self.role)
        rec = HealthRecord(
            id=self.self_id,
            seq=self._seq(),
            wall_ts=round(self._clock(), 3),
            **{k: v for k, v in fields.items()
               if k in {f.name for f in dataclasses.fields(HealthRecord)}},
        )
        if isinstance(rec.versions, list):
            rec.versions = tuple(rec.versions)
        return rec

    def merge(self, records) -> list[HealthRecord]:
        """Fold remote records into the view (higher seq per id wins; own
        id ignored — a member is the sole authority on itself). Returns
        the accepted changes; fires on_update for each."""
        now = self._clock()
        changed: list[HealthRecord] = []
        with self._lock:
            for raw in records or ():
                try:
                    rec = (
                        raw if isinstance(raw, HealthRecord)
                        else HealthRecord.from_dict(raw)
                    )
                except (TypeError, ValueError, KeyError):
                    continue  # malformed record: skip, never poison a round
                if not rec.id or rec.id == self.self_id:
                    continue
                held = self._view.get(rec.id)
                if held is not None and held[0].seq >= rec.seq:
                    self.records_stale += 1
                    # Still a liveness signal: ANY heartbeat-fresh copy
                    # of the same record proves the member spoke
                    # recently somewhere in the fleet — refresh receipt.
                    if held[0].seq == rec.seq:
                        self._view[rec.id] = (held[0], now)
                    continue
                self._view[rec.id] = (rec, now)
                self.records_accepted += 1
                changed.append(rec)
        if self.on_update is not None:
            for rec in changed:
                try:
                    self.on_update(rec)
                except Exception:  # noqa: BLE001 — a fold bug must not
                    log.exception("gossip on_update failed")  # kill gossip
        return changed

    def _expire_locked(self, now: float) -> None:
        dead = [
            mid for mid, (_, seen) in self._view.items()
            if now - seen > self.ttl_s
        ]
        for mid in dead:
            del self._view[mid]
            self.records_expired += 1

    def view(self, include_self: bool = True) -> dict[str, HealthRecord]:
        """Fresh records by member id (TTL-expired members dropped)."""
        now = self._clock()
        with self._lock:
            self._expire_locked(now)
            out = {mid: rec for mid, (rec, _) in self._view.items()}
        if include_self:
            out[self.self_id] = self.self_record()
        return out

    def wire_view(self) -> dict:
        return {
            "records": [r.to_dict() for r in self.view().values()],
        }

    # ----------------------------------------------------------- exchange

    def exchange_once(self, peer: str) -> bool:
        """One push-pull round with one peer: POST our view, merge the
        response view. Returns success (for tests and the loop's
        counters)."""
        body = json.dumps(self.wire_view()).encode("utf-8")
        try:
            conn = _open_connection(peer, self._dial_timeout_s)
            try:
                conn.request(
                    "POST", "/gossip", body=body,
                    headers={"Content-Type": "application/json"},
                )
                resp = conn.getresponse()
                data = resp.read()
                if resp.status != 200:
                    raise OSError(f"gossip peer answered {resp.status}")
            finally:
                conn.close()
            self.merge(json.loads(data).get("records"))
        except Exception:  # noqa: BLE001 — a dead peer is the NORMAL case
            self.exchanges_failed += 1
            return False
        self.exchanges_ok += 1
        return True

    def _loop(self, stop: threading.Event) -> None:
        while not stop.wait(self.interval_s):
            for peer in self.peers:
                if stop.is_set():
                    return
                self.exchange_once(peer)

    # ----------------------------------------------------------- listener

    def _make_handler(self):
        agent = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _json(self, status: int, payload) -> None:
                body = json.dumps(payload).encode("utf-8")
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):  # noqa: N802 — BaseHTTPRequestHandler API
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    payload = json.loads(self.rfile.read(n) or b"{}")
                except ValueError:
                    self._json(400, {"error": "bad payload"})
                    return
                if self.path == "/gossip":
                    try:
                        agent.merge(payload.get("records"))
                    except (ValueError, KeyError, AttributeError):
                        self._json(400, {"error": "bad gossip payload"})
                        return
                    self._json(200, agent.wire_view())
                    return
                route = agent.post_routes.get(self.path)
                if route is None:
                    self._json(404, {"error": "not found"})
                    return
                try:
                    self._json(200, route(payload) or {})
                except Exception:  # noqa: BLE001 — a sick route must not
                    log.exception("gossip post route %s failed", self.path)
                    self._json(500, {"error": "route failed"})

            def do_GET(self):  # noqa: N802
                # Extra routes first: the router overrides /fleetz with
                # its richer fleet snapshot on the same port. Query
                # strings are split off so `/route?k=v` matches the
                # `/route` key; query_routes receive the parsed params.
                path, _, qs = self.path.partition("?")
                route = agent.query_routes.get(path)
                if route is not None:
                    import urllib.parse

                    query = {
                        k: v[0]
                        for k, v in urllib.parse.parse_qs(qs).items()
                    }
                    try:
                        self._json(200, route(query))
                    except Exception:  # noqa: BLE001
                        log.exception("gossip query route %s failed", path)
                        self._json(500, {"error": "route failed"})
                    return
                route = agent.extra_routes.get(path)
                if route is None and path == "/gossip":
                    self._json(200, agent.wire_view())
                    return
                if route is None and path == "/fleetz":
                    self._json(200, agent.snapshot())
                    return
                if route is not None:
                    try:
                        payload = route()
                    except Exception:  # noqa: BLE001
                        log.exception("gossip extra route %s failed",
                                      self.path)
                        self._json(500, {"error": "route failed"})
                        return
                    if isinstance(payload, (bytes, str)):
                        body = (
                            payload.encode("utf-8")
                            if isinstance(payload, str) else payload
                        )
                        self.send_response(200)
                        self.send_header(
                            "Content-Type", "text/plain; charset=utf-8"
                        )
                        self.send_header("Content-Length", str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                    else:
                        self._json(200, payload)
                    return
                self._json(404, {"error": "not found"})

            def log_message(self, fmt, *args):  # quiet: gossip is chatty
                log.debug("gossip http: " + fmt, *args)

        return Handler

    def start(self) -> "GossipAgent":
        """Bind the listener and start the exchange loop. Idempotent."""
        if self._server is None:
            handler = self._make_handler()
            if self._uds_path:
                self._server = _UdsHTTPServer(self._uds_path, handler)
            else:
                self._server = http.server.ThreadingHTTPServer(
                    (self._host, self._port), handler
                )
                self._port = self._server.server_address[1]
            self._server.daemon_threads = True
            self._server_thread = threading.Thread(
                target=self._server.serve_forever,
                kwargs={"poll_interval": 0.1},
                name="gossip-http", daemon=True,
            )
            self._server_thread.start()
        if self._thread is None or not self._thread.is_alive():
            stop = threading.Event()
            self._stop = stop
            self._thread = threading.Thread(
                target=self._loop, args=(stop,), name="gossip", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            if self._server_thread is not None:
                self._server_thread.join(timeout=2)
                self._server_thread = None
            self._server = None

    @property
    def listen_addr(self) -> str:
        """How peers reach this member ("host:port" or "unix:/path")."""
        if self._uds_path:
            return f"unix:{self._uds_path}"
        return f"{self._host}:{self._port}"

    # ----------------------------------------------------------- surfaces

    def snapshot(self) -> dict:
        """The /fleetz body and the dts_tpu_fleet_* Prometheus source."""
        view = self.view()
        return {
            "enabled": True,
            "self_id": self.self_id,
            "role": self.role,
            "listen": self.listen_addr,
            "peers": list(self.peers),
            "members": {mid: rec.to_dict() for mid, rec in view.items()},
            "member_count": len(view),
            "counters": {
                "exchanges_ok": self.exchanges_ok,
                "exchanges_failed": self.exchanges_failed,
                "records_accepted": self.records_accepted,
                "records_stale": self.records_stale,
                "records_expired": self.records_expired,
            },
        }
