"""Which eager product of the dcn_v2 forward gives a row bits that depend on
the row count of its call, and whether a product in fixed row tiles holds
a row's bits at every row count.

At configs/latency.toml's width (43 fields x 16, vocab 2^20, 3 cross
layers, MLP 256/128/64), on the seed-0 demo weights and 2048 seeded rows,
for each compute dtype: the input of every product of the forward (the
three full-rank cross layers as cross_apply computes them with
use_pallas_cross off, the three MLP layers, the head) is computed once;
then each product runs over the 2048 rows in contiguous calls of 2048,
1024, 1000, 512, 500, 256 and 250 rows (the last call of a split takes
the remainder, as a data shard's would), and every row is compared with
the same row of the one 2048-row call. Methods:

- `mm`: one `x @ w` over the call's rows (matmul_f32 before the fix);
- `tiled`: models/base.py `matmul_f32`, the product in fixed tiles of
  ROW_TILE rows (the last tile zero-padded), one library call per tile;
- `tiled<T>` / `bmm<T>`: tiles of T rows in separate calls / in one
  batched call, for the choice of the tile.

It also scores the whole forward (model.apply, use_pallas_cross off and
on) at each row count against the 2048-row call, and times each method
on each product at 2048 and 1000 rows (CUDA events, median of 20).
Prints one JSON line with the card's name and power limit.

    python tools/torch_row_count.py [--device cpu --small] [--out FILE]

Runs on the card unless `--device cpu` is given; `--small` is a dry run
of the script at a narrow width.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SIZES = (2048, 1024, 1000, 512, 500, 256, 250)
ROWS = 2048
TILES = (128, 256, 512, 2048)


def _splits(rows: int, n: int) -> list[tuple[int, int]]:
    return [(lo, min(lo + n, rows)) for lo in range(0, rows, n)]


def _methods(compute_dtype, names=None):
    import torch

    from distributed_tf_serving_tpu_torch.models.base import matmul_f32

    def cast(x, w):
        return x.to(compute_dtype).float(), w.to(compute_dtype).float()

    def mm(x, w):
        x, w = cast(x, w)
        return x @ w

    def tiled_loop(t):
        def f(x, w):
            x, w = cast(x, w)
            n = x.shape[0]
            pad = (-n) % t
            if pad:
                x = torch.cat([x, x.new_zeros((pad, x.shape[1]))])
            return torch.cat([x[i:i + t] @ w for i in range(0, n + pad, t)])[:n]
        return f

    def tiled_bmm(t):
        def f(x, w):
            x, w = cast(x, w)
            n = x.shape[0]
            pad = (-n) % t
            if pad:
                x = torch.cat([x, x.new_zeros((pad, x.shape[1]))])
            m = x.shape[0] // t
            return torch.bmm(x.view(m, t, -1), w.expand(m, *w.shape)).reshape(-1, w.shape[1])[:n]
        return f

    out = {"mm": mm, "tiled": lambda x, w: matmul_f32(x, w, compute_dtype)}
    for t in TILES:
        out[f"tiled{t}"] = tiled_loop(t)
        out[f"bmm{t}"] = tiled_bmm(t)
    return {k: v for k, v in out.items() if names is None or k in names}


def probe(dev, cds=("bfloat16", "float32"), timed: bool = True, small: bool = False,
          methods=None) -> dict:
    """{compute dtype: {"products": {product: {method: {n: {max_abs_diff,
    rows_moved}}}}, "forward": {...}, "ms": {...}}} on `dev`; `methods`
    picks the product methods (default: all)."""
    import torch

    from distributed_tf_serving_tpu_torch.client import make_payload
    from distributed_tf_serving_tpu_torch.models import build_model
    from distributed_tf_serving_tpu_torch.models.embeddings import field_embed
    from distributed_tf_serving_tpu_torch.serving.batcher import fold_ids_host
    from distributed_tf_serving_tpu_torch.utils.config import load_config

    mc = load_config(os.path.join(ROOT, "configs", "latency.toml"))["model"]
    if small:  # a dry run of the script at a small width
        mc = dataclasses.replace(mc, num_fields=8, embed_dim=8, vocab_size=1 << 12,
                                 mlp_dims=(16, 8), num_cross_layers=2)
    F, V = mc.num_fields, mc.vocab_size
    pay = make_payload(ROWS, F, seed=4242)
    ids = torch.from_numpy(fold_ids_host(pay["feat_ids"], V)).to(dev)
    wts = torch.from_numpy(pay["feat_wts"]).to(dev)
    res: dict = {}
    for cdn in cds:
        mcd = dataclasses.replace(mc, compute_dtype=cdn, use_pallas_cross=False)
        model = build_model("dcn_v2", mcd)
        params = model.init(0, dev)
        cd = mcd.cdtype
        fns = _methods(cd, methods)
        with torch.inference_mode():
            x0 = field_embed(params["embedding"], ids, wts, cd).reshape(ROWS, -1)
            inputs = {}
            x, x0f = x0, x0.float()
            for l, p in enumerate(params["cross"]):
                inputs[f"cross{l}"] = (x, p["w"])
                xw = x.to(cd).float() @ p["w"].to(cd).float()
                x = (x0f * (xw + p["b"].float()) + x.float()).to(cd)
            h = x0
            for l, p in enumerate(params["mlp"]):
                inputs[f"mlp{l}"] = (h, p["w"])
                h = torch.relu(h.to(cd).float() @ p["w"].to(cd).float() + p["b"].float())
            inputs["head"] = (torch.cat([x.float(), h.float()], dim=-1), params["out"]["w"])
            products: dict = {}
            for pname, (xin, w) in inputs.items():
                products[pname] = {}
                for mname, fn in fns.items():
                    whole = fn(xin, w)
                    per = {}
                    for n in SIZES:
                        got = torch.cat([fn(xin[lo:hi], w) for lo, hi in _splits(ROWS, n)])
                        moved = (got != whole).any(dim=-1)
                        per[n] = {"max_abs_diff": float((got - whole).abs().max()),
                                  "rows_moved": int(moved.sum())}
                    products[pname][mname] = per
            forward: dict = {}
            for pallas in (False, True):
                if pallas and dev.type != "cuda":
                    continue
                m = build_model("dcn_v2", dataclasses.replace(mcd, use_pallas_cross=pallas))
                whole = m.apply(params, {"feat_ids": ids, "feat_wts": wts})["prediction_node"]
                per = {}
                for n in SIZES:
                    got = torch.cat([m.apply(params, {"feat_ids": ids[lo:hi],
                                                       "feat_wts": wts[lo:hi]})["prediction_node"]
                                     for lo, hi in _splits(ROWS, n)])
                    per[n] = {"max_abs_diff": float((got - whole).abs().max()),
                              "rows_moved": int((got != whole).sum())}
                forward["pallas_cross" if pallas else "plain"] = per
            ms: dict = {}
            if timed:
                for pname, (xin, w) in inputs.items():
                    ms[pname] = {}
                    for mname, fn in fns.items():
                        ms[pname][mname] = {n: _time(dev, lambda: fn(xin[:n], w))
                                            for n in (2048, 1000)}
                for pallas in (False, True) if dev.type == "cuda" else (False,):
                    m = build_model("dcn_v2", dataclasses.replace(mcd, use_pallas_cross=pallas))
                    ms["forward_pallas_cross" if pallas else "forward_plain"] = {
                        n: _time(dev, lambda: m.apply(
                            params, {"feat_ids": ids[:n], "feat_wts": wts[:n]}))
                        for n in (2048, 1000)}
        res[cdn] = {"products": products, "forward": forward, "ms": ms}
        del params
    return res


def _time(dev, fn, iters: int = 20) -> float:
    import torch

    for _ in range(3):
        fn()
    out = []
    for _ in range(iters):
        if dev.type == "cuda":
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            out.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def moved_products(res: dict, method: str) -> dict:
    """{dtype/product: {n: max_abs_diff}} of the rows `method` moved."""
    out = {}
    for cdn, r in res.items():
        for pname, per_m in r["products"].items():
            moved = {n: v["max_abs_diff"] for n, v in per_m[method].items() if v["rows_moved"]}
            if moved:
                out[f"{cdn}/{pname}"] = moved
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--small", action="store_true", help="a dry run at a small width")
    p.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "row_count.json"))
    args = p.parse_args(argv)
    import torch

    from distributed_tf_serving_tpu_torch.models.base import resolve_device

    dev = resolve_device(args.device)
    card = "cpu"
    if dev.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    res = probe(dev, timed=True, small=args.small)
    summary = {"card": card, "torch": torch.__version__,
               "moved": {m: moved_products(res, m)
                         for m in next(iter(res.values()))["products"]["head"]},
               "forward_moved": {cdn: {k: {n: v["max_abs_diff"] for n, v in per.items()
                                           if v["rows_moved"]}
                                       for k, per in r["forward"].items()}
                                 for cdn, r in res.items()},
               "ms": {cdn: r["ms"] for cdn, r in res.items()}}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({**summary, "detail": res}, f, indent=1)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
