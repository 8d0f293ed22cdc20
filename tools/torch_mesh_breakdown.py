"""Where a Predict's time goes on the [mesh] path against the single-device
path, in one process on one card with nothing else running.

Builds two stacks from one checkpoint of configs/latency.toml's dcn_v2 with
`use_pallas_cross` (both run model.apply, so both launch the cross-stack
kernel): the plain batcher (fused serve kernel off) and the [mesh] batcher
over a 1 x 1 mesh of the card. Then, in turns (plain, mesh, three rounds of
`--repeats` each), DynamicBatcher.submit of one n = 1000 request to its
result; and, on the 1024-row bucket that request pads to, the median of
`--repeats` synchronized calls of each stage of the mesh path (the
executor's whole call; its host pack, ops/transfer.py pack_host; its row
scatter, parallel/mesh.py scatter_rows; model.apply alone) beside each
batcher's whole device stage (_execute: pack, upload, step, readback).
Prints one JSON line with every number, the card's name and power limit.

    python tools/torch_mesh_breakdown.py [--repeats 20] [--device cpu]

Serves on the card unless `--device cpu` is given (a dry run of the script).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--repeats", type=int, default=20)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from distributed_tf_serving_tpu_torch.client import make_payload
    from distributed_tf_serving_tpu_torch.models import Servable, build_model, ctr_signatures
    from distributed_tf_serving_tpu_torch.ops.transfer import pack_host, transfer_spec
    from distributed_tf_serving_tpu_torch.parallel.mesh import scatter_rows
    from distributed_tf_serving_tpu_torch.serving.batcher import fold_ids_host
    from distributed_tf_serving_tpu_torch.serving.server import build_stack
    from distributed_tf_serving_tpu_torch.train.checkpoint import save_servable
    from distributed_tf_serving_tpu_torch.utils.config import MeshConfig, load_config

    dev = torch.device(args.device)
    card = "cpu"
    if dev.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(ROOT, "configs", "latency.toml")) as f:
            text = f.read().replace("[model]\n", "[model]\nuse_pallas_cross = true\n", 1)
        with open(os.path.join(tmp, "c.toml"), "w") as f:
            f.write(text)
        cfgs = load_config(os.path.join(tmp, "c.toml"))
        cfg, mc = cfgs["server"], cfgs["model"]
        model = build_model("dcn_v2", mc)
        save_servable(os.path.join(tmp, "1"), Servable(
            "DCN", 1, model, model.init(0, "cpu"), ctr_signatures(mc.num_fields)), "dcn_v2")
        stacks = {
            "plain": build_stack(cfg, mc, args.device, fused_kernel=False,
                                 checkpoint=os.path.join(tmp, "1")),
            "mesh": build_stack(cfg, mc, args.device, checkpoint=os.path.join(tmp, "1"),
                                mesh_config=MeshConfig(enabled=True, devices=1)),
        }
    try:
        payload = make_payload(1000, mc.num_fields, seed=5)
        keys = ("prediction_node",)
        submit = {k: [] for k in stacks}
        for _round in range(3):
            for label, (_impl, batcher, sv) in stacks.items():
                for _ in range(args.repeats):
                    t0 = time.perf_counter()
                    batcher.submit(sv, payload, output_keys=keys).result(timeout=60)
                    submit[label].append((time.perf_counter() - t0) * 1e3)

        def median_ms(fn) -> float:
            fn()
            sync()
            ms = []
            for _ in range(args.repeats):
                t0 = time.perf_counter()
                fn()
                sync()
                ms.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(ms)

        rows = 1024  # the bucket a 1000-row request pads to
        arrays = {"feat_ids": np.zeros((rows, mc.num_fields), np.int32),
                  "feat_wts": np.zeros((rows, mc.num_fields), np.float32)}
        arrays["feat_ids"][:1000] = fold_ids_host(payload["feat_ids"], mc.vocab_size)
        arrays["feat_wts"][:1000] = payload["feat_wts"]
        _mi, mesh_batcher, sv = stacks["mesh"]
        _pi, plain_batcher, plain_sv = stacks["plain"]
        ex = mesh_batcher.run_fn
        spec = transfer_spec(sv.model)
        packed = pack_host(arrays, spec)
        with torch.inference_mode():
            batch = {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}
            stages = {
                "executor_call": median_ms(lambda: ex(sv, arrays, out_keys=keys)),
                "pack_host": median_ms(lambda: pack_host(arrays, spec)),
                "scatter_rows": median_ms(lambda: scatter_rows(packed, ex.mesh)),
                "model_apply": median_ms(lambda: sv.model.apply(sv.params, batch)),
            }
        stages["plain_execute"] = median_ms(lambda: plain_batcher._execute(plain_sv, arrays, keys))
        stages["mesh_execute"] = median_ms(lambda: mesh_batcher._execute(sv, arrays, keys))
        print(json.dumps({
            "card": card, "device": str(dev), "repeats": args.repeats,
            "submit_p50_ms": {k: statistics.median(v) for k, v in submit.items()},
            "submit_min_ms": {k: min(v) for k, v in submit.items()},
            "stage_ms_1024_rows": stages,
        }), flush=True)
    finally:
        for _impl, batcher, _sv in stacks.values():
            batcher.stop()


if __name__ == "__main__":
    main()
