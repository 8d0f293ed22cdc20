"""Build and load the package's CUDA kernels (nvcc -> shared library with a
plain C interface -> ctypes).

Sources live in `csrc/`; each builds at its first use (`library`) into
`build/` (git-ignored), keyed by a hash of its source text and flags, so an
edited source rebuilds and an unchanged one is reused; a source no caller
uses is never built (the DLRM kernel builds when a DLRM servable first runs
on the card, not for a dcn_v2 one). `build_all` compiles every source, one
nvcc process each, all started together. Nothing here runs at import time:
the CPU-only test environment imports this module without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
SOURCES = ("cross_kernel.cu", "dlrm_kernel.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# Per source: {"seconds": wall time of its nvcc (0.0 when reused),
# "log": nvcc/ptxas output (kept beside a reused library), "path": the
# shared library}.
build_info: dict[str, dict] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _target(source: str) -> Path:
    text = (CSRC_DIR / source).read_bytes()
    key = hashlib.sha1(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{Path(source).stem}-{key}.so"


def build_all() -> dict[str, ctypes.CDLL]:
    """Compile every source that has no up-to-date library (one nvcc per
    source, in parallel) and load all of them. Raises with nvcc's output
    when a build fails."""
    return build(SOURCES)


def build(sources) -> dict[str, ctypes.CDLL]:
    """build_all over `sources` alone; returns every library loaded so
    far."""
    with _lock:
        missing = [s for s in sources if s not in _libs]
        if not missing:
            return dict(_libs)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for src in missing:
            out = _target(src)
            if out.exists():
                log = out.with_suffix(".log")
                build_info[src] = {
                    "seconds": 0.0, "log": log.read_text() if log.exists() else "",
                    "path": str(out), "reused": True,
                }
                continue
            tmp = out.with_suffix(f".tmp{os.getpid()}.so")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / src)]
            procs[src] = (
                subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
                ),
                tmp, out, time.perf_counter(),
            )
        for src, (proc, tmp, out, t0) in procs.items():
            log, _ = proc.communicate()
            secs = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {src} (rc {proc.returncode}):\n{log}")
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)
            build_info[src] = {
                "seconds": secs, "log": log, "path": str(out), "reused": False,
            }
        for src in missing:
            _libs[src] = ctypes.CDLL(build_info[src]["path"])
        return dict(_libs)


def library(source: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if need be."""
    libs = _libs if source in _libs else build((source,))
    return libs[source]
