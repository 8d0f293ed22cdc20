"""DLRM's dot interaction (CUDA C++ for sm_90a, csrc/dlrm_kernel.cu) and its
plain PyTorch version.

`dlrm_interact` (kernel wrapper) / `dlrm_interact_reference`: per candidate
row, the weighted gather of the F fields' table rows, stacked under the
bottom MLP's output as Z [F + 1, D], and the dot products of every pair
i < j of Z's rows (row-major upper triangle), returned after the bottom
output as the top MLP's input [n, D + (F + 1) F / 2] in the compute dtype
(bfloat16). The kernel keeps models/dlrm.py's rounding points: rows and
weights rounded to bf16, their product rounded to bf16, the bottom output
rounded to bf16, each dot an f32 sum of exact products. It sums each dot in
an order fixed by D (row-count independent), which is not the eager bmm's,
so a dot may land on the neighbouring bf16 value of the plain version's.

models/dlrm.py routes every bf16 interaction on the card here, outside
autograd; float32 compute and training keep the eager interaction. The
wrapper runs the plain version only for tensors on the CPU; a CUDA tensor
launches the kernel or raises (`unsupported` says why), never the plain
version. The batcher calls `serving_route` when a DLRM servable loads on
the card: it raises there for a model the kernel cannot take, logs the
route, and builds the library (ops/cuda_build.py), so a process that never
serves DLRM on the card never builds it. Each launch adds one to
ops/cross_kernel.py `launches["dlrm_interact", "bfloat16"]` and runs under
the `batch.interact` span (utils/tracing.py).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..models.embeddings import field_embed, fold_ids
from ..utils.tracing import request_trace
from .cross_kernel import SMEM_LIMIT_BYTES, _cd, _count, _require, _stream

SOURCE = "dlrm_kernel.cu"
WARPS = 4           # csrc/dlrm_kernel.cu WARPS: candidate rows per block
MAX_FEATURES = 64   # csrc/dlrm_kernel.cu MAX_FEATURES: F + 1
INT32_MAX = (1 << 31) - 1


def _pad16(x: int) -> int:
    return (x + 15) // 16 * 16


def smem_bytes(num_feat: int, d: int) -> int:
    """Shared memory of one block: each warp's Z, pad16(F + 1) bf16 rows of
    stride pad16(d) + 8 (csrc smem_bytes)."""
    return WARPS * _pad16(num_feat) * (_pad16(d) + 8) * 2


def interact_width(num_fields: int, d: int) -> int:
    """Width of the top MLP's input: the bottom output and the pairs."""
    nf = num_fields + 1
    return d + nf * (nf - 1) // 2


def unsupported(table: torch.Tensor, num_fields: int, compute_dtype) -> str | None:
    """Why the kernel cannot take this table and field count in this
    compute dtype, or None: it takes bf16 compute, an f32 or bf16 [V, D]
    table of V < 2^31 rows with D % 4 == 0, F + 1 <= MAX_FEATURES and Z
    within one block's shared memory."""
    cd = _cd(compute_dtype)
    if cd != torch.bfloat16:
        return f"{cd} compute (the kernel computes in bfloat16)"
    if table.dtype not in (torch.float32, torch.bfloat16) or table.ndim != 2:
        return (f"a {table.dtype} table of {table.ndim} dimensions (it takes a float32 or "
                "bfloat16 [V, D] table)")
    vocab, d = table.shape
    if not 1 <= vocab <= INT32_MAX:
        return f"{vocab} table rows (int32 ids address at most 2^31 - 1)"
    if d < 4 or d % 4:
        return f"embed_dim {d} (it loads rows 4 elements at a time)"
    if num_fields + 1 > MAX_FEATURES:
        return f"{num_fields} fields (at most {MAX_FEATURES - 1})"
    if smem_bytes(num_fields + 1, d) > SMEM_LIMIT_BYTES:
        return (f"{smem_bytes(num_fields + 1, d)} bytes of shared memory a block "
                f"(over {SMEM_LIMIT_BYTES})")
    return None


def serving_route(table: torch.Tensor, num_fields: int, compute_dtype) -> str:
    """The interaction a DLRM servable on the card runs, decided once when
    it loads: "kernel" for bf16 compute (the library is built here, not on
    the dispatch thread), "eager" for float32 compute. Raises ValueError
    for a bf16 model the kernel cannot take."""
    if _cd(compute_dtype) != torch.bfloat16:
        return "eager"
    why = unsupported(table, num_fields, compute_dtype)
    if why is not None:
        raise ValueError(f"the DLRM interaction kernel does not take {why}")
    _lib()
    return "kernel"


# ------------------------------------------------------------- plain version

_pairs_on: dict[tuple[int, torch.device], torch.Tensor] = {}


def _pairs(num_feat: int, device: torch.device) -> torch.Tensor:
    """Flat [i * num_feat + j] positions of the upper triangle (k = 1), in
    row-major order like jnp.triu_indices; one tensor per device."""
    idx = _pairs_on.get((num_feat, device))
    if idx is None:
        iu, ju = np.triu_indices(num_feat, k=1)
        idx = _pairs_on[num_feat, device] = torch.from_numpy(
            (iu * num_feat + ju).astype(np.int64)).to(device)
    return idx


def interact_eager(ids: torch.Tensor, wts: torch.Tensor, table: torch.Tensor,
                   bottom: torch.Tensor, compute_dtype) -> torch.Tensor:
    """The eager interaction of models/dlrm.py: [bottom ++ interactions]
    [n, D + P] in float32 (the f32 bottom output, the f32 dots of the
    compute-dtype Z)."""
    cd = _cd(compute_dtype)
    n = ids.shape[0]
    emb = field_embed(table, ids, wts, cd)
    z = torch.cat([bottom[:, None, :].to(cd), emb], dim=1).float()  # [n, F+1, D]
    zzt = torch.bmm(z, z.transpose(1, 2))  # [n, F+1, F+1] f32
    nf = z.shape[1]
    inter = zzt.reshape(n, nf * nf)[:, _pairs(nf, zzt.device)]
    return torch.cat([bottom, inter], dim=-1)


def dlrm_interact_reference(ids: torch.Tensor, wts: torch.Tensor, table: torch.Tensor,
                            bottom: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version of the kernel: the eager interaction, rounded to the
    compute dtype (as the top MLP's first product rounds it)."""
    return interact_eager(ids, wts, table, bottom, compute_dtype).to(_cd(compute_dtype))


# ------------------------------------------------------------------ kernel


def _lib() -> ctypes.CDLL:
    from .cuda_build import library

    lib = library(SOURCE)
    if not getattr(lib, "_dts_bound", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.dts_dlrm_interact.argtypes = [vp, vp, vp, ci, ci, vp, vp, ci, ci, ci, vp]
        lib.dts_dlrm_interact.restype = ci
        lib.dts_dlrm_error_string.argtypes = [ci]
        lib.dts_dlrm_error_string.restype = ctypes.c_char_p
        lib.dts_dlrm_warps.restype = lib.dts_dlrm_max_features.restype = ci
        lib.dts_dlrm_smem_bytes.argtypes = [ci, ci]
        lib.dts_dlrm_smem_bytes.restype = ctypes.c_size_t
        # The sizes this module computes must be the kernel's.
        agree = (lib.dts_dlrm_warps(), lib.dts_dlrm_max_features()) == (WARPS, MAX_FEATURES)
        for nf in (2, 16, 17, 27, 44, 64):
            for d in (4, 16, 20, 128, 256):
                agree &= lib.dts_dlrm_smem_bytes(nf, d) == smem_bytes(nf, d)
        if not agree:
            raise RuntimeError("csrc/dlrm_kernel.cu sizes disagree with ops/dlrm_kernel.py")
        lib._dts_bound = True
    return lib


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous and 16-byte aligned (the kernel's vector loads). A
    tensor the serving path hands over is its own allocation, contiguous
    and aligned, and passes through unchanged."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def dlrm_interact(ids: torch.Tensor, wts: torch.Tensor, table: torch.Tensor,
                  bottom: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The top MLP's input [bottom ++ interactions] [n, D + P] in the
    compute dtype, from ids [n, F] (int32 of any value, folded by the
    kernel as torch.remainder folds; int64 ids are folded first), weights
    [n, F] (rounded to bf16 first), the f32 or bf16 table [V, D] and the
    bottom MLP's f32 output [n, D]. CPU tensors take the plain version; on
    the card it launches the kernel or raises ValueError."""
    cd = _cd(compute_dtype)
    if ids.device.type == "cpu":
        return dlrm_interact_reference(ids, wts, table, bottom, cd)
    if ids.device.type != "cuda":
        raise ValueError(f"unsupported device {ids.device}")
    n, F = ids.shape
    dev = table.device
    why = unsupported(table, F, cd)
    if why is not None:
        raise ValueError(f"the DLRM interaction kernel does not take {why}")
    vocab, d = table.shape
    table = _aligned(table)
    if ids.dtype != torch.int32:
        ids = fold_ids(ids, vocab)
    ids = ids.contiguous()
    wts = wts.to(torch.bfloat16).contiguous()
    bottom = _aligned(bottom)
    _require(ids, "feat_ids", torch.int32, (n, F), dev)
    _require(wts, "feat_wts", torch.bfloat16, (n, F), dev)
    _require(bottom, "bottom", torch.float32, (n, d), dev)
    out = torch.empty((n, interact_width(F, d)), dtype=cd, device=dev)
    if n == 0:
        return out
    lib = _lib()
    with request_trace.span("batch.interact"), torch.cuda.device(dev):
        rc = lib.dts_dlrm_interact(
            ids.data_ptr(), wts.data_ptr(), table.data_ptr(), int(table.dtype == torch.bfloat16),
            vocab, bottom.data_ptr(), out.data_ptr(), n, F, d, _stream(dev),
        )
    if rc != 0:
        raise RuntimeError(f"dlrm-interact kernel launch failed: "
                           f"{lib.dts_dlrm_error_string(rc).decode()}")
    _count("dlrm_interact", cd)
    return out
