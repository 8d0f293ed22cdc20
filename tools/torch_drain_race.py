"""Repeat chip_smoke.py's SIGTERM-under-traffic check of the PyTorch port's
CLI server, to count the calls a shutdown answers with a code other than
OK or UNAVAILABLE.

Each run starts the CLI server of the tree at --root (default: this
checkout) on --config (default configs/latency.toml: the seeded dcn_v2
demo at its full width), sends Predicts of n = 1000 from 4 client threads
for --seconds (a refused client waits 10 ms before its next call, as
chip_smoke.py's models phase does), sends SIGTERM, and counts the codes
of the calls that ended after it. One JSON line per run, then one summary
line per root with the card's name and power limit. Exits 1 if any run saw
another code, or a server did not exit 0 with `drained=True` in its log.

    python tools/torch_drain_race.py [--runs 10] [--root DIR ...] [--device cpu]

With several --root the runs go round-robin over them (A, B, B, A, ...),
so that two trees are compared on one card in one call. Server logs go to
--out (default chiprun_out/drain_race/ of this checkout).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "distributed_tf_serving_tpu_torch"
CLIENTS = 4
N = 1000
START_S = 600.0
EXIT_S = 120.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip() or "not measured"
    except (OSError, subprocess.SubprocessError):
        return "not measured"


def _order(roots: list[str], runs: int) -> list[str]:
    """A, B, B, A, A, B, ... over the roots."""
    out = []
    for i in range(runs):
        turn = roots if (i // len(roots)) % 2 == 0 else roots[::-1]
        out.append(turn[i % len(roots)])
    return out


def one_run(root: str, config: str, device: str | None, seconds: float, log_path: str,
            model_name: str, payload) -> dict:
    import grpc

    from distributed_tf_serving_tpu_torch import codec
    from distributed_tf_serving_tpu_torch.proto import PredictionServiceStub
    from distributed_tf_serving_tpu_torch.proto import serving_apis_pb2 as apis
    from distributed_tf_serving_tpu_torch.proto.service_grpc import (
        LARGE_MESSAGE_CHANNEL_OPTIONS,
    )

    port = _free_port()
    cmd = [sys.executable, "-m", f"{PKG}.serving.server", "--host", "127.0.0.1",
           "--port", str(port), "--config", config]
    if device:
        cmd += ["--device", device]
    env = dict(os.environ, PYTHONPATH=root)
    req = apis.PredictRequest()
    req.model_spec.name = model_name
    codec.from_ndarray(payload[0], out=req.inputs["feat_ids"])
    codec.from_ndarray(payload[1], out=req.inputs["feat_wts"])
    with open(log_path, "w") as logf:
        proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=logf, stderr=subprocess.STDOUT)
        try:
            end = time.perf_counter() + START_S
            with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
                stub = PredictionServiceStub(ch)
                while True:
                    if proc.poll() is not None or time.perf_counter() > end:
                        raise RuntimeError(f"server did not start (rc {proc.poll()}, "
                                           f"log {log_path})")
                    try:
                        stub.GetModelMetadata(apis.GetModelMetadataRequest(
                            model_spec=apis.ModelSpec(name=model_name)), timeout=2)
                        break
                    except grpc.RpcError:
                        time.sleep(0.2)
            rows, lock, stop = [], threading.Lock(), threading.Event()
            sigterm_at = [None]
            chans = [grpc.insecure_channel(f"127.0.0.1:{port}",
                                           options=LARGE_MESSAGE_CHANNEL_OPTIONS)
                     for _ in range(CLIENTS)]

            def client(i: int) -> None:
                stub = PredictionServiceStub(chans[i])
                while not stop.is_set():
                    try:
                        stub.Predict(req, timeout=60)
                        code = "OK"
                    except grpc.RpcError as e:
                        code = e.code().name
                    with lock:
                        rows.append((time.perf_counter(), code))
                    if code != "OK" and sigterm_at[0] is not None:
                        time.sleep(0.01)

            threads = [threading.Thread(target=client, args=(i,)) for i in range(CLIENTS)]
            try:
                for t in threads:
                    t.start()
                time.sleep(seconds)
                sigterm_at[0] = time.perf_counter()
                proc.send_signal(signal.SIGTERM)
                rc = proc.wait(timeout=EXIT_S)
                exited = time.perf_counter()
            finally:
                stop.set()
                for t in threads:
                    t.join(timeout=120)
                for ch in chans:
                    ch.close()
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    with open(log_path) as f:
        d = re.search(r"shutdown complete \(drained=(\w+), ([\d.]+)s\)", f.read())
    after = collections.Counter(code for t, code in rows if t >= sigterm_at[0])
    return {"root": root, "rc": rc, "drained": d and d.group(1) == "True",
            "shutdown_s": float(d.group(2)) if d else None,
            "sigterm_to_exit_s": exited - sigterm_at[0],
            "ok_before_sigterm": sum(1 for t, code in rows
                                     if t < sigterm_at[0] and code == "OK"),
            "after_sigterm": dict(after),
            "other": sorted(set(after) - {"OK", "UNAVAILABLE"})}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--root", action="append", help="a tree whose server to run "
                    "(repeatable; default this checkout)")
    ap.add_argument("--config", default=os.path.join(ROOT, "configs", "latency.toml"))
    ap.add_argument("--device", help="the server's --device (default: its own, cuda)")
    ap.add_argument("--seconds", type=float, default=3.0, help="traffic before SIGTERM")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "drain_race"),
                    help="directory for the servers' logs")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np

    from distributed_tf_serving_tpu_torch.utils.config import load_config

    loaded = load_config(args.config)
    cfg, mc = loaded["server"], loaded["model"]
    rng = np.random.RandomState(0)
    payload = (rng.randint(0, 1 << 40, size=(N, mc.num_fields)).astype(np.int64),
               rng.rand(N, mc.num_fields).astype(np.float32))
    roots = [os.path.abspath(r) for r in (args.root or [ROOT])]
    out_dir = args.out
    os.makedirs(out_dir, exist_ok=True)
    card = _card()
    print(card, flush=True)
    results = []
    for i, root in enumerate(_order(roots, args.runs)):
        res = one_run(root, os.path.abspath(args.config), args.device, args.seconds,
                      os.path.join(out_dir, f"server_{i}.log"), cfg.model_name, payload)
        res["run"] = i
        results.append(res)
        print(json.dumps(res), flush=True)
    bad = False
    for root in roots:
        mine = [r for r in results if r["root"] == root]
        codes = collections.Counter()
        for r in mine:
            codes.update(r["after_sigterm"])
        summary = {"root": root, "runs": len(mine),
                   "runs_with_other_codes": sum(1 for r in mine if r["other"]),
                   "after_sigterm": dict(codes),
                   "not_clean_exit": sum(1 for r in mine if r["rc"] != 0 or not r["drained"]),
                   "shutdown_s": [r["shutdown_s"] for r in mine],
                   "sigterm_to_exit_s": [round(r["sigterm_to_exit_s"], 4) for r in mine],
                   "card": card}
        print(json.dumps({"summary": summary}), flush=True)
        bad |= summary["runs_with_other_codes"] > 0 or summary["not_clean_exit"] > 0
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
