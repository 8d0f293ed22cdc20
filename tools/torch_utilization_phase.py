#!/usr/bin/env python3
"""Run chip_smoke.py's `utilization` phase alone on one card: build the
kernels and the native host ops, time the serving breakdown on a bf16
fused-serve stack of configs/latency.toml (seed-0 weights), write its
synchronized device step per bucket to chiprun_out/device_step_us.json,
then drive the phase against that table. The phase's checks fail the run
as they do in chip_smoke.py; its results land in
chiprun_out/utilization_phase.json.

    python3 tools/torch_utilization_phase.py

It needs a card (about 1.5 min of command time).
"""

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
import chip_smoke as cs  # noqa: E402


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False")
    from distributed_tf_serving_tpu_torch import native
    from distributed_tf_serving_tpu_torch.ops import cuda_build
    from distributed_tf_serving_tpu_torch.serving.server import build_stack
    from distributed_tf_serving_tpu_torch.utils.config import load_config

    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi()
    cs.log(f"nvidia-smi: {smi}")
    t0 = time.perf_counter()
    if not native.ensure():
        cs.fail("the native host-ops library (native/hostops.cc) did not build with g++")
    cuda_build.build_all()
    cs.log(f"build {time.perf_counter() - t0:.1f} s")
    loaded = load_config(os.path.join(HERE, "configs", "latency.toml"))
    impl, batcher, sv = build_stack(loaded["server"], loaded["model"], "cuda", seed=cs.SEED)
    try:
        stages = cs.breakdown(dev, batcher, sv)
    finally:
        batcher.stop()
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    table = os.path.join(HERE, "chiprun_out", "device_step_us.json")
    with open(table, "w") as f:
        json.dump({str(b): v["device_step"] * 1e3 for b, v in stages.items()}, f)
    cs.log(f"device step table (breakdown device_step, us): {open(table).read()}")
    t0 = time.perf_counter()
    out = cs.phase_utilization(dev, f"{torch.cuda.get_device_name(0)} ({smi})", table)
    cs.log(f"utilization: phase {time.perf_counter() - t0:.1f} s")
    with open(os.path.join(HERE, "chiprun_out", "utilization_phase.json"), "w") as f:
        json.dump(out, f, indent=1, default=str)


if __name__ == "__main__":
    main()
