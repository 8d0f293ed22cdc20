#!/usr/bin/env python3
"""A fine-tune beside serving on one card: does a request wait behind the
training kernels on the shared default stream, or for the GIL?

Builds the bf16 fused-serve stack of configs/latency.toml in process
(seed-0 weights; build_stack, no transport), then sends one Predict-sized
request at a time (n = 1000 rows through DynamicBatcher.submit) while
another thread runs train/publisher.py `fine_tune` on the same servable in
rounds of 20 steps of 256 rows: with no fine-tune, with it on the default
stream (as the lifecycle thread runs it), and with it on a side stream
(`torch.cuda.Stream`), in the order none / default / side / side / default
/ none. `default - side` is what the shared stream costs a request; `side -
none` is what the GIL and the shared card cost. Prints one JSON line per
run and a summary; everything lands in chiprun_out/finetune_stream_ab.json.

    python3 tools/torch_finetune_stream_ab.py [--requests 300]

It needs a card (about a minute of command time after the build).
"""

import argparse
import json
import os
import statistics
import sys
import threading
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
import chip_smoke as cs  # noqa: E402

ORDER = ("none", "default", "side", "side", "default", "none")
N = 1000  # rows per request ([client] candidate_num of configs/latency.toml)
ROUND = (20, 256)  # fine-tune steps per round, rows per step (the publisher's batch)


def main() -> None:
    import numpy as np
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--requests", type=int, default=300)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False")
    from distributed_tf_serving_tpu_torch import native
    from distributed_tf_serving_tpu_torch.ops import cuda_build
    from distributed_tf_serving_tpu_torch.serving.server import build_stack
    from distributed_tf_serving_tpu_torch.train.publisher import fine_tune
    from distributed_tf_serving_tpu_torch.utils.config import load_config

    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi()
    if not native.ensure():
        cs.fail("the native host-ops library (native/hostops.cc) did not build with g++")
    cuda_build.build_all()
    loaded = load_config(os.path.join(HERE, "configs", "latency.toml"))
    cfg, model_cfg = loaded["server"], loaded["model"]
    impl, batcher, sv = build_stack(cfg, model_cfg, dev)
    rng = np.random.RandomState(cs.SEED + 31)
    payloads = [{"feat_ids": rng.randint(0, 1 << 40, size=(N, model_cfg.num_fields)),
                 "feat_wts": rng.rand(N, model_cfg.num_fields).astype(np.float32)}
                for _ in range(7)]
    side = torch.cuda.Stream(dev)
    runs = []
    try:
        fine_tune(sv, steps=2, batch_size=ROUND[1])  # first-call costs out of the runs
        for i, mode in enumerate(ORDER):
            stop = threading.Event()
            done = {"steps": 0}

            def train(mode=mode, stop=stop, done=done):
                t_start = time.perf_counter()
                while not stop.is_set():
                    if mode == "side":
                        with torch.cuda.stream(side):
                            fine_tune(sv, steps=ROUND[0], batch_size=ROUND[1], seed=i)
                    else:
                        fine_tune(sv, steps=ROUND[0], batch_size=ROUND[1], seed=i)
                    done["steps"] += ROUND[0]
                done["wall_s"] = time.perf_counter() - t_start

            th = threading.Thread(target=train) if mode != "none" else None
            if th is not None:
                th.start()
                time.sleep(1.0)  # the fine-tune under way before the first request
            lat = []
            t0 = time.perf_counter()
            for k in range(args.requests):
                t1 = time.perf_counter()
                batcher.submit(sv, payloads[k % len(payloads)]).result(timeout=60)
                lat.append((time.perf_counter() - t1) * 1e3)
            wall = time.perf_counter() - t0
            stop.set()
            if th is not None:
                th.join(120)
            lat.sort()
            run = {"mode": mode, "requests": len(lat), "p50_ms": statistics.median(lat),
                   "p99_ms": lat[int(0.99 * (len(lat) - 1))], "wall_s": wall,
                   "finetune_steps": done["steps"],
                   "finetune_steps_per_s": done["steps"] / done["wall_s"] if th else None}
            runs.append(run)
            print(json.dumps(run), flush=True)
    finally:
        batcher.stop()
    summary = {m: {"p50_ms": statistics.mean(r["p50_ms"] for r in runs if r["mode"] == m),
                   "p99_ms": statistics.mean(r["p99_ms"] for r in runs if r["mode"] == m)}
               for m in ("none", "default", "side")}
    out = {"card": smi, "n": N, "round": ROUND, "runs": runs, "mean": summary}
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "finetune_stream_ab.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"card": smi, "mean": summary}), flush=True)


if __name__ == "__main__":
    main()
