"""The load generator: one child process, a few threads, the benchmark's own
wire. It imports neither torch nor the program, but for a fan-out cell,
whose entry is the program's own `ShardedPredictClient` (client/client.py):
each request is split contiguously over the replicas and merged in order by
it, on one asyncio loop.

Protocol over the connection to its parent (harness/child.py): the child
warms its channels, sends ("ready", {}), waits for "go", runs the window,
waits up to LATE_S for every answer still due, and sends ("done", result).
"""

from __future__ import annotations

import threading
import time

import numpy as np

from . import imports, wire
from .traffic import Traffic

# How long past the window's close an answer may still come (it is then
# late, and its latency counts the wait, but not wrong).
LATE_S = 60.0
_CHANNEL_OPTIONS = (
    ("grpc.max_receive_message_length", 64 * 1024 * 1024),
    ("grpc.max_send_message_length", 64 * 1024 * 1024),
    ("grpc.http2.max_frame_size", 1024 * 1024),
)


class _Record:
    """One request: when it was due and sent, when it answered, its size,
    and its raw answer (decoded after the window)."""

    __slots__ = ("stream", "k", "n", "due", "sent", "done", "raw", "error")

    def __init__(self, stream: int, k: int, n: int, due: float):
        self.stream, self.k, self.n, self.due = stream, k, n, due
        self.sent = self.done = None
        self.raw = None
        self.error = None


class _Unary:
    """A Predict call over raw bytes on one channel."""

    def __init__(self, address: str):
        import grpc

        self.grpc = grpc
        self.channel = grpc.insecure_channel(address, options=_CHANNEL_OPTIONS)
        self.call = self.channel.unary_unary(wire.PREDICT_METHOD)

    def start(self, payload: bytes, rec: _Record, on_done=None):
        fut = self.call.future(payload, timeout=LATE_S + 30.0)

        def done(f):
            rec.done = time.perf_counter()
            try:
                rec.raw = f.result()
            except self.grpc.RpcError as exc:
                rec.error = f"{exc.code().name}: {exc.details()}"
            if on_done is not None:
                on_done()

        rec.sent = time.perf_counter()
        fut.add_done_callback(done)
        return fut

    def close(self):
        self.channel.close()


def _scores(rec: _Record) -> np.ndarray | None:
    """The request's scores if its answer is well-formed, else None."""
    if rec.error is not None or rec.raw is None:
        return None
    if isinstance(rec.raw, np.ndarray):  # merged by the fan-out client
        s = rec.raw
    else:
        try:
            s = wire.decode_predict_response(rec.raw).get("prediction_node")
        except (ValueError, IndexError) as exc:
            rec.error = f"malformed response: {exc}"
            return None
    if s is None or s.shape != (rec.n,) or not np.all(np.isfinite(s)):
        rec.error = "wrong answer shape or a non-finite score"
        return None
    return s


class Job:
    """What one load-generator process does (picklable)."""

    def __init__(self, *, addresses: list[str], model_name: str, traffic: dict,
                 traffic_name: str, num_fields: int, num_dense: int, seed: int,
                 seconds: float, fanout: bool = False):
        self.addresses = addresses
        self.model_name = model_name
        self.traffic = traffic
        self.traffic_name = traffic_name
        self.num_fields = num_fields
        self.num_dense = num_dense
        self.seed = seed
        self.seconds = seconds
        self.fanout = fanout


def _inputs(job: Job, t: Traffic, stream: int, k: int, n: int) -> dict:
    return t.request(job.seed, stream, k, n, job.num_fields, job.num_dense)


def _payload(job: Job, inputs: dict) -> bytes:
    return wire.encode_predict(job.model_name, inputs, ("prediction_node",))


def _warm(job: Job, t: Traffic, clients) -> None:
    """Two requests per client before the window, on streams the window
    never uses: connections up, every path of the server touched once."""
    low, high = t.size_range()
    for i, cl in enumerate(clients):
        for j, n in enumerate((high, low)):
            rec = _Record(10_000 + i, j, n, 0.0)
            cl.start(_payload(job, _inputs(job, t, rec.stream, j, n)), rec).result()
            if _scores(rec) is None:
                raise RuntimeError(f"warm-up request failed: {rec.error}")


def _closed(job: Job, t: Traffic, clients, t0: float, seconds: float) -> list[_Record]:
    """Each client on its own stream until t0 + seconds."""
    end = t0 + seconds
    per_stream: list[list[_Record]] = [[] for _ in clients]

    def client(i: int) -> None:
        stream = i
        sizes = t.stream_sizes(job.seed, stream)
        cl = clients[i]
        k = 0
        n = int(sizes[0])
        nxt = _payload(job, _inputs(job, t, stream, 0, n))
        while True:
            now = time.perf_counter()
            if now >= end:
                return
            rec = _Record(stream, k, n, now)
            per_stream[i].append(rec)
            k += 1
            n_next = int(sizes[k % len(sizes)])
            done = threading.Event()
            fut = cl.start(nxt, rec, done.set)
            # The next request is built while this one is in flight.
            nxt = _payload(job, _inputs(job, t, stream, k, n_next))
            if not done.wait(LATE_S + 60.0):
                fut.cancel()
                rec.error = rec.error or "no answer"
            n = n_next

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(len(clients))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(seconds + LATE_S + 90.0)
    return [r for recs in per_stream for r in recs]


def _open_payloads(job: Job, t: Traffic) -> tuple[np.ndarray, np.ndarray, list[bytes]]:
    """The window's open-loop schedule on stream 0, its requests built and
    serialized before it starts (set-up), so the senders only wait and
    send."""
    due, sizes = t.schedule(job.seed, job.seconds)
    payloads = [_payload(job, _inputs(job, t, 0, k, int(sizes[k]))) for k in range(len(due))]
    return due, sizes, payloads


def _open(job: Job, t: Traffic, clients, t0: float, planned) -> tuple[list[_Record], np.ndarray]:
    due, sizes, payloads = planned
    senders = len(clients)
    recs = [_Record(0, k, int(sizes[k]), t0 + float(due[k])) for k in range(len(due))]
    late = np.zeros(len(recs))
    pending = threading.Semaphore(0)

    def sender(s: int) -> None:
        cl = clients[s]
        for k in range(s, len(recs), senders):
            rec = recs[k]
            wait = rec.due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            cl.start(payloads[k], rec, pending.release)
            payloads[k] = None
            late[k] = rec.sent - rec.due

    threads = [threading.Thread(target=sender, args=(s,), daemon=True) for s in range(senders)]
    for th in threads:
        th.start()
    length = float(due[-1]) if len(due) else 0.0
    for th in threads:
        th.join(length + LATE_S)
    deadline = t0 + length + LATE_S
    for _ in recs:
        if not pending.acquire(timeout=max(deadline - time.perf_counter(), 0.0)):
            break
    return recs, late


def _fanout(job: Job, t: Traffic, t0: float | None) -> list[_Record]:
    """Closed-loop callers through the program's ShardedPredictClient, all
    on one asyncio loop; with t0 None, only the warm-up requests."""
    import asyncio

    from distributed_tf_serving_tpu_torch.client.client import ShardedPredictClient

    async def one(client, inputs: dict, rec: _Record) -> None:
        rec.sent = time.perf_counter()
        try:
            rec.raw = np.asarray(await client.predict(inputs), np.float32)
        except Exception as exc:  # noqa: BLE001 — a failed request is counted, not fatal
            rec.error = f"{type(exc).__name__}: {exc}"
        rec.done = time.perf_counter()

    async def caller(client, i: int, end: float, recs: list) -> None:
        sizes = t.stream_sizes(job.seed, i)
        k = 0
        while time.perf_counter() < end:
            n = int(sizes[k % len(sizes)])
            inputs = _inputs(job, t, i, k, n)
            rec = _Record(i, k, n, time.perf_counter())
            recs.append(rec)
            await asyncio.wait_for(one(client, inputs, rec), LATE_S + 60.0)
            k += 1

    async def drive() -> list[_Record]:
        client = ShardedPredictClient(job.addresses, model_name=job.model_name,
                                      timeout_s=LATE_S + 30.0)
        try:
            if t0 is None:
                low, high = t.size_range()
                for j, n in enumerate((high, low)):
                    rec = _Record(10_000, j, n, 0.0)
                    await one(client, _inputs(job, t, rec.stream, j, n), rec)
                    if _scores(rec) is None:
                        raise RuntimeError(f"warm-up request failed: {rec.error}")
                return []
            recs: list[_Record] = []
            end = t0 + job.seconds
            await asyncio.gather(*[caller(client, i, end, recs)
                                   for i in range(int(t.spec.get("clients", 1)))])
            return recs
        finally:
            await client.close()

    return asyncio.run(drive())


def _sample(job: Job, t: Traffic, answered: list[_Record]) -> list[_Record]:
    """The requests the comparison checks: a seeded draw of
    `sample_requests` answered requests, always with the longest."""
    if not answered:
        return []
    want = int(t.spec.get("sample_requests", 32))
    rng = np.random.default_rng([int(job.seed) % (1 << 32), 99])
    order = sorted(answered, key=lambda r: (r.stream, r.k))
    longest = max(range(len(order)), key=lambda i: (order[i].n, -i))
    pick = set(rng.choice(len(order), size=min(want, len(order)), replace=False).tolist())
    pick.add(longest)
    return [order[i] for i in sorted(pick)]


def main(conn, job: Job) -> None:
    """The child process's entry."""
    t = Traffic(job.traffic_name, job.traffic)
    want = int(t.spec.get("clients", 1)) if t.loop == "closed" else int(t.spec.get("senders", 2))
    clients = [] if job.fanout else [_Unary(job.addresses[0]) for _ in range(want)]
    try:
        planned = _open_payloads(job, t) if t.loop == "open" else None
        if job.fanout:
            _fanout(job, t, None)
        else:
            _warm(job, t, clients)
        conn.send(("ready", {}))
        if conn.recv() != "go":
            return
        t0 = time.perf_counter()
        late = None
        if job.fanout:
            recs = _fanout(job, t, t0)
        elif t.loop == "closed":
            recs = _closed(job, t, clients, t0, job.seconds)
        else:
            recs, late = _open(job, t, clients, t0, planned)
        end = t0 + job.seconds
        answered = []
        failed = []
        for r in recs:
            s = _scores(r) if r.done is not None else None
            if s is None:
                failed.append(f"stream {r.stream} request {r.k}: {r.error or 'no answer'}")
                continue
            answered.append(r)
            r.raw = s
        sample = _sample(job, t, answered)
        result = {
            "attempted": len(recs),
            "failed": len(failed),
            "failures": failed[:5],
            "latency_s": np.array([r.done - r.due for r in answered]),
            "done_s": np.array([r.done - t0 for r in answered]),
            "n": np.array([r.n for r in answered], np.int64),
            "done_in_window": np.array([r.done <= end for r in answered]),
            "late_s": late,
            "sample": [(r.stream, r.k, r.n, r.raw) for r in sample],
            "forbidden": imports.forbidden_loaded(),
        }
        conn.send(("done", result))
    finally:
        for cl in clients:
            cl.close()
