"""Measurements that set a cell's fixed numbers; the benchmark's runs never
call this. On the card:

    python3 ctrbench/calibrate.py sweep --workload <cell> --rates 200,400,800 \
        --seconds 8 --seed <n>
        The knee of an open-loop cell: one replica, one window per offered
        rate (the traffic file's other parameters as they are). One JSON
        line per rate: offered and achieved rates, p50 / p95 / p99, the
        sender's lateness, and the backlog (p50 of the window's last
        quarter of arrivals over its first quarter's).

    python3 ctrbench/calibrate.py control --workload <cell> --seeds 1,2,3
        The precision control's readings at the cell's size: the plain
        reference computed with float8 (e4m3) operands in the program's
        place, against the float32 reference, over the requests a run's
        sample would hold (as many, as long, with the longest); the number
        the check compares, per seed.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def sweep(args) -> None:
    import numpy as np

    from ctrbench.harness import replica, runner, spec
    from ctrbench.harness.traffic import Traffic

    bench = spec.Bench()
    cell = bench.cell(args.workload)
    runner.require_cards(cell.chips)
    base = Traffic(cell.traffic_name, cell.traffic)
    rep = replica.Replica(cell.config, base, args.seed, "cuda:0")
    try:
        for rate in [float(r) for r in args.rates.split(",")]:
            traffic = Traffic(base.name, {**base.spec, "rate_per_s": rate})
            ctx = runner.drive_window(rep, cell, traffic, args.seed, args.seconds, False,
                                      time.time())
            load = ctx.load
            lat = np.asarray(load["latency_s"]) * 1e3
            q = max(len(lat) // 4, 1)
            late = np.asarray(load["late_s"]) * 1e3 if load["late_s"] is not None else np.zeros(1)
            print(json.dumps({
                "rate_offered": rate,
                "attempted": load["attempted"], "failed": load["failed"],
                "rate_achieved": float(np.sum(load["done_in_window"]) / args.seconds),
                "p50_ms": float(np.percentile(lat, 50)), "p95_ms": float(np.percentile(lat, 95)),
                "p99_ms": float(np.percentile(lat, 99)),
                "late_p95_ms": float(np.percentile(late, 95)),
                "backlog": float(np.median(lat[-q:]) / np.median(lat[:q])),
            }), flush=True)
            time.sleep(2.0)
    finally:
        rep.stop()


def control(args) -> None:
    import torch

    from ctrbench.harness import check, runner, spec
    from ctrbench.harness.traffic import Traffic

    bench = spec.Bench()
    cell = bench.cell(args.workload)
    runner.require_cards(cell.chips)
    traffic = Traffic(cell.traffic_name, cell.traffic)
    want = int(traffic.spec.get("sample_requests", 32))
    low, high = traffic.size_range()
    for seed in [int(s) for s in args.seeds.split(",")]:
        sizes = (traffic.stream_sizes(seed, 0) if traffic.loop == "closed"
                 else traffic.schedule(seed, 60.0)[1])
        sample = [(0, k, int(sizes[k]), None) for k in range(want)] + [(0, want, high, None)]
        t0 = time.perf_counter()
        ref = check.reference_scores(cell.config, traffic, seed, sample, "cuda:0")
        low_p = check.reference_scores(cell.config, traffic, seed, sample, "cuda:0",
                                       precision="fp8")
        gap = check.score_gap(low_p, ref)
        print(json.dumps({"seed": seed, "control": "fp8", "score_max_abs_err": gap,
                          "rows": sum(n for _, _, n, _ in sample),
                          "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="mode", required=True)
    s = sub.add_parser("sweep")
    s.add_argument("--workload", required=True)
    s.add_argument("--rates", required=True)
    s.add_argument("--seconds", type=float, default=8.0)
    s.add_argument("--seed", type=int, default=1)
    c = sub.add_parser("control")
    c.add_argument("--workload", required=True)
    c.add_argument("--seeds", required=True)
    args = p.parse_args()
    {"sweep": sweep, "control": control}[args.mode](args)


if __name__ == "__main__":
    main()
