"""Walk against packed: the port's codec decoding one repeated-field tensor
(`int64_val` ids U[0, 2^40), `float_val` weights) at several sizes, on the
host CPU, with and without the native scan.

    python tools/torch_decode_bench.py [--sizes 1,64,1500,64500] [--reps 200]
        [--threads 6]

For each size and dtype it prints the median and best microseconds of one
`codec.to_ndarray` call by each route ("walked": protobuf's container, one
Python object per element; "packed": the serialized bytes through
native.repeated_field). At the largest size it also decodes from `--threads`
threads at once, the way concurrent Predicts do, and reports the wall time
per tensor. One JSON line on standard output. Imports neither JAX nor the
JAX package.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import threading
import time
from pathlib import Path
from unittest import mock

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from distributed_tf_serving_tpu_torch import codec, native  # noqa: E402
from distributed_tf_serving_tpu_torch.proto import tf_framework_pb2 as fw  # noqa: E402


def _tensor(dtype, n: int, rng) -> fw.TensorProto:
    arr = (rng.integers(0, 2**40, n, dtype=np.int64) if dtype == np.int64
           else rng.random(n, dtype=np.float32))
    raw = codec.from_ndarray(arr, use_tensor_content=False).SerializeToString()
    return fw.TensorProto.FromString(raw)  # as a request carries it: parsed


def _times(tp, reps: int) -> list[float]:
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        codec.to_ndarray(tp)
        out.append((time.perf_counter() - t0) * 1e6)
    return out


def _threaded_us(tp, threads: int, per_thread: int) -> float:
    """Wall microseconds per tensor with `threads` threads decoding at once."""
    barrier = threading.Barrier(threads + 1)

    def work():
        barrier.wait()
        for _ in range(per_thread):
            codec.to_ndarray(tp)

    pool = [threading.Thread(target=work) for _ in range(threads)]
    for t in pool:
        t.start()
    barrier.wait()
    t0 = time.perf_counter()
    for t in pool:
        t.join()
    return (time.perf_counter() - t0) * 1e6 / (threads * per_thread)


def _route(packed: bool):
    return mock.patch.object(native, "available", lambda: packed)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--sizes", default="1,64,1500,64500")
    p.add_argument("--reps", type=int, default=200)
    p.add_argument("--threads", type=int, default=6)
    args = p.parse_args(argv)
    if not native.ensure():
        print("the native host ops did not build", file=sys.stderr)
        return 1
    rng = np.random.default_rng(0)
    sizes = [int(s) for s in args.sizes.split(",")]
    rows = []
    for dtype, name in ((np.int64, "int64_val"), (np.float32, "float_val")):
        for n in sizes:
            tp = _tensor(dtype, n, rng)
            row = {"field": name, "n": n}
            for label, packed in (("walked", False), ("packed", True)):
                with _route(packed):
                    codec.to_ndarray(tp)  # warm
                    reps = max(5, args.reps * 1500 // max(n, 1500))
                    ts = _times(tp, reps)
                    row[f"{label}_us"] = statistics.median(ts)
                    row[f"{label}_best_us"] = min(ts)
                    if n == max(sizes):
                        row[f"{label}_threads_us"] = _threaded_us(tp, args.threads, 5)
            rows.append(row)
    print(json.dumps({"threads": args.threads, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
