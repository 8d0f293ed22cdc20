"""Closed-loop gRPC load against the PyTorch port's CLI server, to compare
trees of this repo (for example a change and its parent) on one card.

Each `--run LABEL=TREE:DEPTH` starts, from the checkout TREE,

    python -m distributed_tf_serving_tpu_torch.serving.server --config C --port P

where C is TREE's configs/latency.toml with `[batching] pipeline_depth`
set to DEPTH, on a free localhost port. Once the server answers it drives
the [client] point of that config: 4 client threads, each sending 250
Predicts of n = 1000 candidates back to back on its own channel (seeded
payloads, the same for every run). It prints one JSON line per run (p50,
p99, QPS over the wall time), stops the server with SIGTERM and goes on to
the next run, in the order given. A tree whose server does not read
`[batching] pipeline_depth` serves at its own setting; the line keeps the
depth asked for. The server's log goes to chiprun_out/closed_loop_LABEL.log
of the tree holding this script.

    python tools/torch_closed_loop.py --run parent=/path/to/parent:2 \\
        --run change=.:1 --run change=.:2 --run parent=/path/to/parent:2

Serves on the card unless `--device cpu` is given (a dry run of the script).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import signal
import socket
import statistics
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CLIENTS = 4
PER_CLIENT = 250  # --per-client
N = 1000
FIELDS = 43
SEED = 1000


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _config(tree: str, depth: int, path: str) -> None:
    with open(os.path.join(tree, "configs", "latency.toml")) as f:
        text = f.read()
    text, k = re.subn(r"(?m)^(\[batching\]\s*\n(?:#.*\n|\s*\n)*)pipeline_depth\s*=\s*\d+",
                      rf"\g<1>pipeline_depth = {depth}", text)
    if k != 1:
        raise SystemExit(f"{tree}/configs/latency.toml: no [batching] pipeline_depth line")
    with open(path, "w") as f:
        f.write(text)


def _request(ids, wts):
    from distributed_tf_serving_tpu_torch import codec
    from distributed_tf_serving_tpu_torch.proto import serving_apis_pb2 as apis

    req = apis.PredictRequest()
    req.model_spec.name = "DCN"
    req.model_spec.signature_name = "serving_default"
    codec.from_ndarray(ids, out=req.inputs["feat_ids"])
    codec.from_ndarray(wts, out=req.inputs["feat_wts"])
    req.output_filter.append("prediction_node")
    return req


def _wait_ready(port: int, proc: subprocess.Popen, timeout_s: float) -> None:
    import grpc

    from distributed_tf_serving_tpu_torch.proto import PredictionServiceStub
    from distributed_tf_serving_tpu_torch.proto import serving_apis_pb2 as apis

    end = time.perf_counter() + timeout_s
    with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
        stub = PredictionServiceStub(ch)
        while True:
            if proc.poll() is not None:
                raise SystemExit(f"server exited with {proc.returncode} before it answered")
            try:
                stub.GetModelMetadata(apis.GetModelMetadataRequest(
                    model_spec=apis.ModelSpec(name="DCN")), timeout=2)
                return
            except grpc.RpcError:
                if time.perf_counter() > end:
                    raise SystemExit(f"server did not answer within {timeout_s} s") from None
                time.sleep(0.5)


def closed_loop(port: int, per_client: int) -> dict:
    import grpc
    import numpy as np

    from distributed_tf_serving_tpu_torch.proto import PredictionServiceStub
    from distributed_tf_serving_tpu_torch.proto.service_grpc import LARGE_MESSAGE_CHANNEL_OPTIONS

    rng = np.random.RandomState(SEED)
    reqs = [_request(rng.randint(0, 1 << 40, size=(N, FIELDS)).astype(np.int64),
                     rng.rand(N, FIELDS).astype(np.float32)) for _ in range(CLIENTS)]
    lat: list[list[float]] = [[] for _ in reqs]
    errors = []
    chans = [grpc.insecure_channel(f"127.0.0.1:{port}", options=LARGE_MESSAGE_CHANNEL_OPTIONS)
             for _ in reqs]
    barrier = threading.Barrier(CLIENTS + 1)

    def client(k):
        stub = PredictionServiceStub(chans[k])
        try:
            stub.Predict(reqs[k], timeout=60)  # channel up before the clock starts
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)
        barrier.wait(timeout=120)
        try:
            for _ in range(per_client):
                t0 = time.perf_counter()
                stub.Predict(reqs[k], timeout=60)
                lat[k].append((time.perf_counter() - t0) * 1e3)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(k,)) for k in range(CLIENTS)]
    try:
        for t in threads:
            t.start()
        barrier.wait(timeout=120)
        t0 = time.perf_counter()
        for t in threads:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
    finally:
        for ch in chans:
            ch.close()
    if errors or any(t.is_alive() for t in threads):
        raise SystemExit(f"closed loop: client errors {errors[:3]}")
    flat = sorted(v for ls in lat for v in ls)
    return {"requests": len(flat), "clients": CLIENTS, "n": N, "wall_s": wall,
            "p50_ms": statistics.median(flat), "p99_ms": flat[int(0.99 * (len(flat) - 1))],
            "qps": len(flat) / wall}


def run(label: str, tree: str, depth: int, args) -> dict:
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    cfg = os.path.join(out_dir, f"closed_loop_{label}_d{depth}.toml")
    _config(tree, depth, cfg)
    port = _free_port()
    with open(os.path.join(out_dir, f"closed_loop_{label}.log"), "a") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "distributed_tf_serving_tpu_torch.serving.server",
             "--config", cfg, "--port", str(port), "--device", args.device],
            cwd=tree, stdout=log, stderr=subprocess.STDOUT)
        try:
            t0 = time.perf_counter()
            _wait_ready(port, proc, args.ready_timeout)
            r = {"label": label, "tree": tree, "pipeline_depth": depth,
                 "startup_s": time.perf_counter() - t0, **closed_loop(port, args.per_client)}
        finally:
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
    return r


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--run", action="append", required=True, metavar="LABEL=TREE:DEPTH")
    p.add_argument("--ready-timeout", type=float, default=600.0,
                   help="seconds a server may take to build, warm and answer")
    p.add_argument("--per-client", type=int, default=PER_CLIENT)
    p.add_argument("--device", default="cuda", help="the servers' device (cpu: a dry run)")
    args = p.parse_args()
    runs = []
    for spec in args.run:
        label, _, rest = spec.partition("=")
        tree, _, depth = rest.rpartition(":")
        if not label or not tree or not depth.isdigit() or int(depth) < 1:
            raise SystemExit(f"--run {spec!r}: want LABEL=TREE:DEPTH")
        runs.append((label, os.path.abspath(tree), int(depth)))
    for label, tree, depth in runs:
        r = run(label, tree, depth, args)
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
