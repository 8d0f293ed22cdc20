"""The benchmark of distributed_tf_serving_tpu_torch, one run of one cell:

    python3 ctrbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON line (correct, attempted, failed, metrics, device[,
breakdown], check) as the last line of standard output, and the numbers the
check compared, each beside its limit, as the last lines of standard error.
Exits nonzero with no result line when there is no card (or fewer than the
cell asks for), when a process of the run loaded JAX or the JAX package, or
when the program is not beside it.
"""

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# Kernel and extension caches at fixed paths inside the checkout, so only a
# checkout's first run builds.
_CACHE = ROOT / ".ctrbench_cache"
os.environ["TRITON_CACHE_DIR"] = str(_CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(_CACHE / "torch_extensions")
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

if __name__ == "__main__":
    from ctrbench.harness import runner

    sys.exit(runner.main())
