"""run.py's run of one cell with the program's per-request span plane on:

    python3 ctrbench/spans.py --workload <cell> --seed <n> --seconds <s> [--plane slice|window]

`--plane slice` (the default): run.py's traced run (`--trace 1`), the plane
on over its profiled slice; the result line adds ctrbench/harness/spans.py's
five readings to the per-layer metrics, and its idle gaps name the program's
spans. `--plane window`: run.py's untraced run (`--trace 0`) with the plane
on over all of it, which prices the plane. Standard error adds the slice's
CPU seconds per thread role and the program clock's offset from the trace's.
"""

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# The same kernel and extension caches as run.py's.
_CACHE = ROOT / ".ctrbench_cache"
os.environ["TRITON_CACHE_DIR"] = str(_CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(_CACHE / "torch_extensions")
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

if __name__ == "__main__":
    from ctrbench.harness import spans

    sys.exit(spans.main())
