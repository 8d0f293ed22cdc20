"""Repeat chip_smoke.py's retire-memory check of the PyTorch port on one card,
to tell memory a retired version keeps from a read that raced its free.

Writes version 1 of the dcn_v2 servable at the full width of
configs/latency.toml (seed-0 weights) into a temporary base path, twice:
once for the `fused_serve` stack and once with `use_pallas_cross` for the
`cross_stack` stack. Then, ITERS times, runs chip_smoke.retire_memory on
each (a VersionWatcher loads v1 through a new DynamicBatcher, one request
of n = 1000 is served, v1 is retired) and prints one JSON line per run:
the card's memory before the load, loaded and after the retire, the bytes
retained, when the version died after the retire (`drain_s`) and when its
bytes were freed after that (`settle_s`). Exits 1 if any run retained more
than 1 MiB or kept the version alive, as chip_smoke.py would fail.

    python tools/torch_retire_memory.py [--iters 15]

Needs a CUDA card; builds the kernels and the native host ops first.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=15)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np

    import chip_smoke as cs
    from distributed_tf_serving_tpu_torch import native
    from distributed_tf_serving_tpu_torch.models import Servable, build_model, ctr_signatures
    from distributed_tf_serving_tpu_torch.ops import cuda_build
    from distributed_tf_serving_tpu_torch.train.checkpoint import save_servable
    from distributed_tf_serving_tpu_torch.utils.config import load_config

    cuda_build.build_all()
    if not native.ensure():
        cs.fail("the native host-ops library did not build")
    loaded = load_config(os.path.join(ROOT, "configs", "latency.toml"))
    cfg, mc = loaded["server"], loaded["model"]
    params = build_model("dcn_v2", mc).init(0, "cpu")
    base = tempfile.mkdtemp(prefix="dts_retire_")
    stacks = (("cross_stack", False, dataclasses.replace(mc, use_pallas_cross=True)),
              ("fused_serve", True, mc))
    for label, _, c in stacks:
        save_servable(os.path.join(base, label, "1"), Servable(
            name="DCN", version=1, model=build_model("dcn_v2", c), params=params,
            signatures=ctr_signatures(mc.num_fields)), "dcn_v2")
    rng = np.random.RandomState(cs.SEED + 3000)
    payload = {"feat_ids": rng.randint(0, 1 << 40, size=(1000, mc.num_fields)).astype(np.int64),
               "feat_wts": rng.rand(1000, mc.num_fields).astype(np.float32)}
    bad = 0
    for i in range(args.iters):
        for label, fused, _ in stacks:
            m = cs.retire_memory(os.path.join(base, label), cfg.buckets, fused, payload)
            bad += m["retained_bytes"] > (1 << 20) or not m["servable_collected"]
            print(json.dumps({"iter": i, "stack": label, **{k: m[k] for k in (
                "before_load", "loaded", "after_retire", "retained_bytes", "drain_s",
                "settle_s", "servable_collected", "cross_cache_entries")}}), flush=True)
    print(json.dumps({"runs": 2 * args.iters, "failed": bad}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
