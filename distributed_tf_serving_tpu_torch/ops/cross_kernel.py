"""The DCN-v2 serving kernels (CUDA C++ for sm_90a, csrc/cross_kernel.cu)
and their plain PyTorch versions.

Two functions, each with a kernel wrapper and a plain version beside it:

- `fused_cross_apply` (kernel wrapper `cross_stack`) /
  `cross_stack_reference`: the cross stack alone, x = x0 * (x @ W_l + b_l)
  + x over L layers, returning [n, d] in the compute dtype. Its weight
  operands (W stacked in the compute dtype, its mma_layout on the card, b in
  f32) are prepared once per weight set and kept in `cross_cache`
  (`CrossWeights`), so a warm call launches the kernel alone.
- `build_fused_serve` (kernel wrapper `fused_serve`) /
  `fused_serve_reference`: the whole per-candidate serving step — weighted
  embedding gather, cross stack, ReLU MLP, f32 head, sigmoid — over float
  weights or the int8 {qw, qscale} weights of ops/quantize.py (the scale
  folds into the f32 matmul result; the head is dequantized to f32 once).

The plain versions follow the KERNELS' rounding, which differs from
`model.apply` in two places: the gather multiplies in f32 (model.apply
casts the rows and the weights to the compute dtype first), and the head is
f32 (model.apply runs it in the compute dtype). In bf16 the two therefore
agree to ~1e-3 on scores, not bit for bit.

The fused serve kernels (bf16 and f32) serve each 16-row tile with a
thread-block cluster of C in CLUSTER_SIZES blocks that split every layer's
output columns (csrc/cross_kernel.cu). C is chosen here (`serve_cluster`,
fed by the card's `serve_capacity` for the servable's kernel) and passed to
the launch. The cross stacks take the same split and R in ROW_TILES rows
per tile; (R, C) comes from `cross_plan`, fed by `cross_capacity`. The
f32 kernels multiply in split TF32 on the tensor cores. Every kernel reads
its weights as `mma_layout`. This module mirrors the kernels' column
partition (`tile_begin`, `tile_owner`) and shared-memory sizes; `_lib()`
holds the mirror to the kernel's own functions.

A wrapper runs the plain version only for tensors on the CPU; a CUDA tensor
always launches the kernel or raises. The kernels have no backward (nor do
the JAX package's Pallas kernels: `jax.grad` through them raises), so the
cross stack refuses, on either device, to run where autograd would record
it (`NoBackwardError`): training through it raises instead of leaving the
cross weights without a gradient. Each kernel launch adds one to
`launches[name, compute dtype]`, the dtype named "bfloat16" or "float32":
the fused serve step counts under "fused_serve" for float weights and
"fused_serve_int8" for int8 weights, the cross stack under
"fused_cross_apply", and DLRM's interaction (ops/dlrm_kernel.py) under
"dlrm_interact".
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import threading
import weakref

import torch

from ..models.base import torch_dtype

# Shared memory one block may opt into on sm_90 (227 KB).
SMEM_LIMIT_BYTES = 232448
ROWS_PER_BLOCK = 16  # csrc/cross_kernel.cu ROWS: the fused serve kernels' tile
ROW_TILES = (16, 32)  # rows per block the cross-stack kernels take
MAX_MLP_LAYERS = 4   # csrc/cross_kernel.cu MAX_MLP
WARPS = 16           # csrc/cross_kernel.cu THREADS / 32 (every kernel's block)

SOURCE = "cross_kernel.cu"

KERNELS = ("fused_serve", "fused_serve_int8", "fused_cross_apply", "dlrm_interact")
COMPUTE_DTYPES = ("bfloat16", "float32")
launches = {(k, cd): 0 for k in KERNELS for cd in COMPUTE_DTYPES}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _count(name: str, compute_dtype: torch.dtype) -> None:
    launches[name, str(compute_dtype).removeprefix("torch.")] += 1


def _cd(compute_dtype) -> torch.dtype:
    return torch_dtype(compute_dtype) if isinstance(compute_dtype, str) else compute_dtype


def _esize(compute_dtype) -> int:
    cd = _cd(compute_dtype)
    if cd not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported compute dtype {cd}")
    return torch.tensor([], dtype=cd).element_size()


def _pad_k(k: int) -> int:
    return (k + 31) // 32 * 32


def _pad_n(n: int) -> int:
    return (n + 7) // 8 * 8


def _lda(k: int) -> int:
    """Row stride of a bf16 activation tile (csrc lda_of)."""
    kp = _pad_k(k)
    return kp + 32 if kp % 64 == 0 else kp


def _ldf(k: int) -> int:
    """Row stride (floats) of an f32 activation tile (csrc ldf_of)."""
    return _pad_k(k) + 4


def cross_smem_bytes(d: int, compute_dtype=torch.bfloat16, rows: int = ROWS_PER_BLOCK) -> int:
    """Shared memory of one cross-stack block of `rows` rows: x0 (f32) + two
    bf16 x buffers (row-major with a padded stride), or two row-major f32 x
    buffers of stride _ldf(d) (the f32 kernel reads x0 from global memory)."""
    if _esize(compute_dtype) == 2:
        return rows * d * 4 + 2 * rows * _lda(d) * 2
    return rows * 8 * _ldf(d)


def cross_row_tiles(d: int, compute_dtype=torch.bfloat16) -> tuple[int, ...]:
    """The rows per block (of ROW_TILES) whose cross-stack tile in this
    compute dtype fits one block's shared memory at width d: R = 32 up to
    d = 888 in bf16, d = 896 in f32."""
    return tuple(r for r in ROW_TILES
                 if cross_smem_bytes(d, compute_dtype, r) <= SMEM_LIMIT_BYTES)


def serve_smem_bytes(d: int, mlp_dims, compute_dtype=torch.bfloat16) -> int:
    """Shared memory of one fused-serve block: x0 (f32), two x buffers,
    two MLP activation buffers, and the head partials (bf16: two per row;
    f32: one per row and 8-column tile of the last cross and MLP layers)."""
    mmax = max(mlp_dims)
    if _esize(compute_dtype) == 2:
        return (ROWS_PER_BLOCK * d * 4 + 2 * ROWS_PER_BLOCK * _lda(d) * 2
                + 2 * ROWS_PER_BLOCK * _lda(mmax) * 2 + 2 * ROWS_PER_BLOCK * 4)
    return ROWS_PER_BLOCK * 4 * (3 * _ldf(d) + 2 * _ldf(mmax)
                                 + _pad_n(d) // 8 + _pad_n(mmax) // 8)


CLUSTER_SIZES = (1, 2, 4, 8)  # up to 8 blocks, the portable cluster size limit


def serve_cluster(n: int, capacity) -> int:
    """Blocks per 16-row tile of a fused serve kernel: the largest C
    in (8, 4, 2) such that the card holds all ceil(n / 16) clusters of C
    blocks at once, else 1 (a second wave costs more than a smaller C).
    `capacity[i]`: how many clusters of CLUSTER_SIZES[i] blocks the card
    holds at once (`serve_capacity`). Not the SM count over C: a cluster
    must fit one GPC, and an H100 SXM holds 15 clusters of 8 serving
    blocks, not 132 / 8."""
    tiles = -(-n // ROWS_PER_BLOCK)
    for i in (3, 2, 1):
        if tiles <= capacity[i]:
            return CLUSTER_SIZES[i]
    return 1


def cross_plan(n: int, capacity: dict, d: int) -> tuple[int, int]:
    """(R, C) of a cross-stack kernel for n rows of width d: R rows
    per tile, a cluster of C blocks per tile. Among the plans whose
    ceil(n / R) clusters of C all fit one wave, the one with the most
    blocks; on a tie, the fewest rounds of 8-column tile pairs per warp on
    the busiest rank (a tile's time is its warps' serial chain), then the
    smaller R (a 32-row round issues twice the mmas of a 16-row one, so
    R = 32 pays where it removes a round). When none fits one wave, the
    largest R with C = 1 (fewest tiles re-reading the weights).
    `capacity[(R, C)]`: how many clusters of C blocks of R rows the card
    holds at once (`cross_capacity`), for the R that fit the width. The
    same rule plans the f32 kernel from its own capacity.

    Set from chip_smoke.py's grid of every forced (R, C) at d = 688 on an
    H100 (PERF.md): it picks the fastest plan at 256, 512, 1024 and 2048
    rows, (16, 4), (32, 4), (16, 2) and (32, 2)."""
    nt = _pad_n(d) // 8
    best = None
    for (r, c), clusters in capacity.items():
        tiles = -(-n // r)
        own = -(-nt // c)  # the busiest rank's column tiles
        rounds = -(-own // (2 * WARPS))  # its warps' turns at a pair of tiles
        key = (tiles * c, -rounds, -r)
        if tiles <= clusters and (best is None or key > best[0]):
            best = (key, (r, c))
    if best is not None:
        return best[1]
    return max(r for r, _ in capacity), 1


def tile_begin(ntiles: int, c: int, r: int) -> int:
    """First 8-column output tile of a layer with `ntiles` tiles that rank r
    of a cluster of c owns (csrc tile_begin); rank r owns
    [tile_begin(r), tile_begin(r + 1))."""
    return r * ntiles // c


def tile_owner(t: int, ntiles: int, c: int) -> int:
    """The rank that owns tile t (csrc tile_owner), the inverse of tile_begin."""
    return ((t + 1) * c - 1) // ntiles


def mma_layout(w: torch.Tensor) -> torch.Tensor:
    """[..., K, N] weights (bf16, f32 or int8) -> the kernels' operand
    layout W^T [..., pad8(N), pad32(K)], zero-padded and contiguous."""
    k, n = w.shape[-2:]
    out = torch.zeros((*w.shape[:-2], _pad_n(n), _pad_k(k)), dtype=w.dtype, device=w.device)
    out[..., :n, :k] = w.transpose(-1, -2)
    return out


def fits_smem(d: int, compute_dtype=torch.bfloat16) -> bool:
    """Whether the cross-stack kernel's per-block tile fits shared memory
    (the port's counterpart of the JAX fits_vmem guard). Weights stream
    from L2, so unlike on the TPU the layer count does not enter."""
    return cross_smem_bytes(d, compute_dtype) <= SMEM_LIMIT_BYTES


def serve_fits_smem(d: int, mlp_dims, compute_dtype=torch.bfloat16) -> bool:
    """Whether the fused serve kernel takes this width and MLP."""
    return (
        1 <= len(mlp_dims) <= MAX_MLP_LAYERS
        and serve_smem_bytes(d, mlp_dims, compute_dtype) <= SMEM_LIMIT_BYTES
    )


class NoBackwardError(RuntimeError):
    """A kernel without a backward was asked to run under autograd."""


def refuse_grad(*tensors: torch.Tensor) -> None:
    """Raise NoBackwardError when grad mode is on and any of `tensors`
    requires grad: autograd would record the kernel's output as a leaf and
    the weights before it would silently get no gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NoBackwardError(
            "the cross-stack kernel has no backward: it cannot be trained through "
            "(use_pallas_cross is a serving option; train with it off, or run the "
            "forward under torch.no_grad() / torch.inference_mode())")


def cross_params_to_stacked(cross_layers: list) -> tuple[torch.Tensor, torch.Tensor]:
    """Stack [{'w': [d,d], 'b': [d]}] into W [L,d,d], b [L,d]. Only
    full-matrix (DCN-v2) layers qualify."""
    if not cross_layers or "w" not in cross_layers[0] or cross_layers[0]["w"].ndim != 2:
        raise ValueError("fused cross kernel requires DCN-v2 (full-matrix) layers")
    w = torch.stack([p["w"] for p in cross_layers])
    b = torch.stack([p["b"] for p in cross_layers])
    return w, b


@dataclasses.dataclass
class CrossWeights:
    """One weight set's operands for the cross-stack kernel, prepared once:
    W stacked in the compute dtype, on the card its mma_layout (the
    kernel's operand), and b in f32."""

    w: torch.Tensor                  # [L, d, d] compute dtype
    b: torch.Tensor                  # [L, d] f32, on w's device
    wt: torch.Tensor | None = None   # on CUDA: mma_layout(w)
    # cross_capacity(), queried at the first launch.
    _capacity: dict | None = None

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.w.dtype

    @property
    def d(self) -> int:
        return self.w.shape[-1]


def prepare_cross_weights(w: torch.Tensor, b: torch.Tensor, compute_dtype) -> CrossWeights:
    """Cast (and on the card, lay out) stacked W [L, d, d] and
    b [L, d] for the cross-stack kernel, on their own device. Refuses a
    width whose tile does not fit one block's shared memory."""
    cd = _cd(compute_dtype)
    L, d = w.shape[0], w.shape[-1]
    if tuple(w.shape) != (L, d, d) or tuple(b.shape) != (L, d):
        raise ValueError(f"cross weights of shapes {tuple(w.shape)}, {tuple(b.shape)}: "
                         "expected [L, d, d] and [L, d]")
    if not fits_smem(d, cd):
        raise ValueError(
            f"cross-stack kernel (d={d}) needs {cross_smem_bytes(d, cd)} bytes of "
            f"shared memory per block, over the {SMEM_LIMIT_BYTES} a block may use; "
            "use cross_apply (models/dcn.py falls back via fits_smem)"
        )
    wc = w.to(cd).contiguous()
    wt = mma_layout(wc) if wc.device.type == "cuda" else None
    return CrossWeights(wc, b.to(device=wc.device, dtype=torch.float32).contiguous(), wt)


class CrossWeightCache:
    """Prepared cross-stack operands per source weight set, at most
    `maxsize` of them, the least recently used evicted first.

    Never stale: an entry is keyed on its source tensors' ids and is taken
    only while its weak references still give the very tensors looked up
    and every source has the same `_version` counter, device, dtype and
    storage address; an in-place update or a swapped tree builds anew. An
    entry never keeps its sources alive, and goes the moment one of them
    dies (a weak-reference callback): a retired servable's prepared
    operands leave the card with its params, once its last in-flight batch
    lets go of them. Inference tensors keep no version counter, so sources
    that are inference tensors are prepared on every call and never stored.
    Entries are built outside inference mode, so they serve callers in and
    out of it alike."""

    def __init__(self, maxsize: int = 4):
        self.maxsize = maxsize
        self.builds = 0
        self._entries: collections.OrderedDict = collections.OrderedDict()
        # Reentrant: a source may die, and its callback run, while this
        # thread holds the lock (an evicted entry releasing its operands).
        self._lock = threading.RLock()

    @staticmethod
    def _state(sources) -> tuple:
        return tuple((t._version, t.device, t.dtype, t.data_ptr()) for t in sources)

    def get(self, sources: tuple, compute_dtype: torch.dtype, build) -> CrossWeights:
        """The entry for `sources` in this compute dtype, built by
        `build()` when there is none or it is stale."""
        with self._lock:
            cacheable = not any(t.is_inference() for t in sources)
            if cacheable:
                key = (compute_dtype, tuple(id(t) for t in sources))
                state = self._state(sources)
                hit = self._entries.get(key)
                if hit is not None and hit[1] == state and all(
                        r() is t for r, t in zip(hit[0], sources)):
                    self._entries.move_to_end(key)
                    return hit[2]
            with torch.inference_mode(False):
                cw = build()
            self.builds += 1
            if cacheable:
                refs = tuple(weakref.ref(t, lambda r, key=key: self._drop(key, r))
                             for t in sources)
                self._entries[key] = (refs, state, cw)
                self._entries.move_to_end(key)
                while len(self._entries) > self.maxsize:
                    self._entries.popitem(last=False)
            return cw

    def _drop(self, key, ref) -> None:
        """A source of entry `key` died: drop the entry, unless `key` names
        a newer entry by now."""
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None and any(r is ref for r in hit[0]):
                del self._entries[key]

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.builds = 0

    def __len__(self) -> int:
        return len(self._entries)


cross_cache = CrossWeightCache()


def cross_weights(cross_layers: list, compute_dtype) -> CrossWeights:
    """The cached CrossWeights of a params["cross"] list of DCN-v2
    {'w': [d, d], 'b': [d]} layers: stacked, cast and laid out once per
    weight set (cross_cache)."""
    cd = _cd(compute_dtype)
    sources = tuple(t for p in cross_layers for t in (p["w"], p["b"]))
    return cross_cache.get(sources, cd, lambda: prepare_cross_weights(
        *cross_params_to_stacked(cross_layers), cd))


def cached_cross_weights(w: torch.Tensor, b: torch.Tensor, compute_dtype) -> CrossWeights:
    """The cached CrossWeights of stacked W [L, d, d] and b [L, d]."""
    cd = _cd(compute_dtype)
    return cross_cache.get((w, b), cd, lambda: prepare_cross_weights(w, b, cd))


# ------------------------------------------------------------- plain versions


def _cross_layers(x: torch.Tensor, x0f: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  cd: torch.dtype, s: torch.Tensor | None = None) -> torch.Tensor:
    """L cross layers; `s` [L, d] are the scales of int8 weights `w`."""
    for l in range(w.shape[0]):
        xw = x.float() @ w[l].to(cd).float()
        if s is not None:
            xw = xw * s[l]
        x = (x0f * (xw + b[l].float()) + x.float()).to(cd)
    return x


def cross_stack_reference(x0: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                          compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version of the cross-stack kernel: x0 is rounded to the compute
    dtype first, the update runs in f32, x is recast per layer."""
    cd = _cd(compute_dtype)
    x = x0.to(cd)
    return _cross_layers(x, x.float(), w, b, cd)


@dataclasses.dataclass
class ServeWeights:
    """A servable's operands prepared once for the fused serve step: weights
    cast to the compute dtype (or kept int8 with f32 per-output-channel
    scales) and stacked, biases and the head in f32."""

    compute_dtype: torch.dtype
    num_fields: int
    embed_dim: int
    table: torch.Tensor                     # [V, D] f32
    wc: torch.Tensor                        # [L, d, d] compute dtype or int8
    bc: torch.Tensor                        # [L, d] f32
    mlp: list[tuple[torch.Tensor, torch.Tensor]]  # ([K, M] cd or int8, [M] f32)
    wo: torch.Tensor                        # [d + M_last] f32
    bo: torch.Tensor                        # [1] f32
    sc: torch.Tensor | None = None          # [L, d] f32 scales of an int8 wc
    ms: list[torch.Tensor] | None = None    # [M] f32 scales of int8 MLP weights
    # The kernel's operands (weights in mma_layout) and their ctypes pointer
    # arrays, built at first launch.
    _kernel_args: tuple | None = None
    # serve_capacity(), queried at the first launch.
    _capacity: tuple | None = None

    @property
    def quantized(self) -> bool:
        return self.sc is not None

    @property
    def d(self) -> int:
        return self.num_fields * self.embed_dim

    @property
    def device(self) -> torch.device:
        return self.table.device


def fused_serve_reference(ids: torch.Tensor, wts: torch.Tensor,
                          sw: ServeWeights) -> dict[str, torch.Tensor]:
    """Plain version of the fused serve kernel: f32 gather, x0 recast to the
    compute dtype for the matmuls, cross update with the UNROUNDED f32 x0,
    f32 head. int8 weights: xw = (x @ qw) * s, then + b, on the same
    rounding points."""
    cd = sw.compute_dtype
    n = ids.shape[0]
    x0f = (sw.table[ids.long()] * wts.float()[..., None]).reshape(n, sw.d)
    x0 = x0f.to(cd)
    h = x0
    for m, (w, b) in enumerate(sw.mlp):
        y = h.float() @ w.to(cd).float()
        if sw.ms is not None:
            y = y * sw.ms[m]
        h = torch.relu(y + b).to(cd)
    xc = _cross_layers(x0, x0f, sw.wc, sw.bc, cd, sw.sc)
    d = sw.d
    lo = (xc.float() @ sw.wo[:d] + h.float() @ sw.wo[d:]) + sw.bo[0]
    return {"prediction_node": torch.sigmoid(lo), "logits": lo}


# ------------------------------------------------------------------ kernels


def _lib() -> ctypes.CDLL:
    from .cuda_build import library

    lib = library(SOURCE)
    if not getattr(lib, "_dts_bound", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.dts_fused_serve.argtypes = [
            vp, vp, ci, vp, vp, vp, ci,
            ctypes.POINTER(vp), ctypes.POINTER(vp), ctypes.POINTER(ci), ci,
            vp, vp, vp, vp, ci, ci, ci, ci, ci, vp, ctypes.POINTER(vp), ci, vp,
        ]
        lib.dts_fused_serve.restype = ci
        lib.dts_serve_max_active_clusters.argtypes = [ci, ci, ci, ci, ci, ctypes.POINTER(ci)]
        lib.dts_serve_max_active_clusters.restype = ci
        lib.dts_tile_begin.restype = lib.dts_tile_owner.restype = ci
        lib.dts_tile_begin.argtypes = lib.dts_tile_owner.argtypes = [ci, ci, ci]
        lib.dts_cross_stack.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp]
        lib.dts_cross_stack.restype = ci
        lib.dts_cross_max_active_clusters.argtypes = [ci, ci, ci, ci, ctypes.POINTER(ci)]
        lib.dts_cross_max_active_clusters.restype = ci
        lib.dts_error_string.argtypes = [ci]
        lib.dts_error_string.restype = ctypes.c_char_p
        lib.dts_rows_per_block.restype = ci
        lib.dts_max_mlp_layers.restype = ci
        lib.dts_warps.restype = ci
        lib.dts_serve_smem_bytes.argtypes = [ci, ci, ci]
        lib.dts_serve_smem_bytes.restype = ctypes.c_size_t
        lib.dts_cross_smem_bytes.argtypes = [ci, ci, ci]
        lib.dts_cross_smem_bytes.restype = ctypes.c_size_t
        lib.dts_bf16_pad_k.argtypes = lib.dts_bf16_pad_n.argtypes = lib.dts_f32_ld.argtypes = [ci]
        lib.dts_bf16_pad_k.restype = lib.dts_bf16_pad_n.restype = lib.dts_f32_ld.restype = ci
        # The layouts and sizes this module computes must be the kernel's.
        agree = (lib.dts_rows_per_block(), lib.dts_max_mlp_layers(), lib.dts_warps()) == (
            ROWS_PER_BLOCK, MAX_MLP_LAYERS, WARPS,
        )
        for d, m in ((688, 256), (80, 32), (100, 7), (2816, 64)):
            for cd in (torch.bfloat16, torch.float32):
                bf = int(cd == torch.bfloat16)
                agree &= lib.dts_serve_smem_bytes(d, m, bf) == serve_smem_bytes(d, (m,), cd)
                agree &= all(lib.dts_cross_smem_bytes(d, bf, r) == cross_smem_bytes(d, cd, r)
                             for r in ROW_TILES)
            agree &= (lib.dts_bf16_pad_k(d), lib.dts_bf16_pad_n(d), lib.dts_f32_ld(d)) == (
                _pad_k(d), _pad_n(d), _ldf(d))
        for nt in (1, 2, 11, 32, 86, 352):
            for c in (1, 2, 3, 4, 8):
                agree &= all(lib.dts_tile_begin(nt, c, r) == tile_begin(nt, c, r)
                             for r in range(c + 1))
                agree &= all(lib.dts_tile_owner(t, nt, c) == tile_owner(t, nt, c)
                             for t in range(nt))
        if not agree:
            raise RuntimeError("csrc/cross_kernel.cu layouts disagree with ops/cross_kernel.py")
        lib._dts_bound = True
    return lib


def _check(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: {lib.dts_error_string(rc).decode()}")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _require(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if dtype is not None and t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def cross_max_active_clusters(cluster: int, d: int, rows: int,
                              compute_dtype=torch.bfloat16) -> int:
    """How many clusters of `cluster` cross-stack blocks of `rows` rows the
    current card holds at once (cudaOccupancyMaxActiveClusters of the
    compute dtype's cross kernel itself, at its shared memory for width d)."""
    lib = _lib()
    out = ctypes.c_int(0)
    rc = lib.dts_cross_max_active_clusters(cluster, d, rows, int(_esize(compute_dtype) == 2),
                                           ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: "
                           f"{lib.dts_error_string(rc).decode()}")
    return out.value


def cross_capacity(cw: CrossWeights) -> dict[tuple[int, int], int]:
    """{(R, C): clusters the card holds at once} of the cross-stack kernel
    of this weight set's compute dtype at its width, for every R that
    kernel takes (cross_row_tiles) and C in CLUSTER_SIZES; queried once on
    its device."""
    if cw._capacity is None:
        cd = cw.compute_dtype
        with torch.cuda.device(cw.w.device):
            cw._capacity = {(r, c): cross_max_active_clusters(c, cw.d, r, cd)
                            for r in cross_row_tiles(cw.d, cd) for c in CLUSTER_SIZES}
    return cw._capacity


def cross_stack(x0: torch.Tensor, cw: CrossWeights, *,
                _plan: tuple[int, int] | None = None) -> torch.Tensor:
    """The cross-stack kernel on prepared weights; returns [n, d] in the
    compute dtype. CPU tensors take the plain version.

    The kernel runs tiles of R rows, each served by a cluster of C blocks,
    (R, C) = cross_plan(n, cross_capacity(cw), d). `_plan` forces (R, C)
    (for tests and chip_smoke.py only); a plan the launch refuses raises,
    never retried with another. Under autograd with an input that requires
    grad it raises NoBackwardError (refuse_grad), on either device."""
    refuse_grad(x0, cw.w, cw.b)
    cd = cw.compute_dtype
    if _plan is not None and (_plan[0] not in ROW_TILES or _plan[1] < 1):
        raise ValueError(f"_plan={_plan}: the kernels take R in {ROW_TILES}, C >= 1")
    if x0.device.type == "cpu":
        return cross_stack_reference(x0, cw.w, cw.b, cd)
    if x0.device.type != "cuda":
        raise ValueError(f"unsupported device {x0.device}")
    dev = x0.device
    n, d = x0.shape
    L = cw.w.shape[0]
    _require(cw.w, "w", cd, (L, d, d), dev)
    x0c = x0.to(cd).contiguous()
    rows, cluster = _plan or cross_plan(n, cross_capacity(cw), d)
    out = torch.empty((n, d), dtype=cd, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.dts_cross_stack(
            x0c.data_ptr(), cw.wt.data_ptr(), cw.b.data_ptr(), out.data_ptr(),
            n, d, L, int(cd == torch.bfloat16), rows, cluster, _stream(dev),
        )
    _check(lib, rc, "cross-stack")
    _count("fused_cross_apply", cd)
    return out


def fused_cross_apply(x0: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                      compute_dtype=torch.bfloat16,
                      _plan: tuple[int, int] | None = None) -> torch.Tensor:
    """Apply the full DCN-v2 cross stack (W [L, d, d], b [L, d] on x0's
    device) in one kernel; returns [n, d] in the compute dtype. The
    weights are prepared once per weight set (cross_cache); CPU tensors
    take the plain version. `_plan`: as for cross_stack."""
    return cross_stack(x0, cached_cross_weights(w, b, compute_dtype), _plan=_plan)


def max_active_clusters(cluster: int, d: int, mlp_dims, quantized: bool = False,
                        compute_dtype=torch.bfloat16) -> int:
    """How many clusters of `cluster` fused-serve blocks of the compute
    dtype's kernel the current card holds at once
    (cudaOccupancyMaxActiveClusters) at the shared memory of width d and
    these MLP dims."""
    lib = _lib()
    out = ctypes.c_int(0)
    rc = lib.dts_serve_max_active_clusters(cluster, d, max(mlp_dims),
                                           int(_esize(compute_dtype) == 2), int(quantized),
                                           ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: "
                           f"{lib.dts_error_string(rc).decode()}")
    return out.value


def serve_capacity(sw: ServeWeights) -> tuple[int, ...]:
    """How many clusters of each of CLUSTER_SIZES blocks the card holds at
    once for this servable's kernel, queried once on its device."""
    if sw._capacity is None:
        dims = [w.shape[1] for w, _ in sw.mlp]
        with torch.cuda.device(sw.device):
            sw._capacity = tuple(max_active_clusters(c, sw.d, dims, sw.quantized,
                                                     sw.compute_dtype)
                                 for c in CLUSTER_SIZES)
    return sw._capacity


def fused_serve(ids: torch.Tensor, wts: torch.Tensor, sw: ServeWeights, *,
                _cluster: int | None = None) -> dict[str, torch.Tensor]:
    """The fused serve step on one padded batch: ids int32 [n, F] (host-
    folded into [0, V)), wts bf16 or f32 [n, F]. Float or int8 weights, as
    `sw` holds them. CPU tensors take the plain version.

    The kernel serves each 16-row tile with a cluster of C blocks,
    C = serve_cluster(n, serve_capacity(sw)). `_cluster` forces C (for
    tests and chip_smoke.py only); a C the launch refuses raises, never
    retried at another C."""
    if _cluster is not None and _cluster < 1:
        raise ValueError(f"_cluster={_cluster}: the kernels take a cluster size >= 1")
    if ids.device.type == "cpu":
        return fused_serve_reference(ids, wts, sw)
    if ids.device.type != "cuda":
        raise ValueError(f"unsupported device {ids.device}")
    dev = sw.device
    n, F = ids.shape
    _require(ids, "feat_ids", torch.int32, (n, sw.num_fields), dev)
    _require(wts, "feat_wts", (torch.bfloat16, torch.float32), (n, sw.num_fields), dev)
    if sw._kernel_args is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        wc = mma_layout(sw.wc)
        wm = [mma_layout(w) for w, _ in sw.mlp]
        k = len(sw.mlp)
        sw._kernel_args = (
            wc, wm,  # keep the operands alive while their pointers are used
            (vp * k)(*[w.data_ptr() for w in wm]),
            (vp * k)(*[b.data_ptr() for _, b in sw.mlp]),
            (ci * k)(*[w.shape[1] for w, _ in sw.mlp]),
            (vp * k)(*[s.data_ptr() for s in sw.ms]) if sw.quantized else None,
        )
    wc, _, wm, bm, mdims, sm = sw._kernel_args
    pred = torch.empty((n,), dtype=torch.float32, device=dev)
    logit = torch.empty((n,), dtype=torch.float32, device=dev)
    lib = _lib()
    cluster = _cluster or serve_cluster(n, serve_capacity(sw))
    with torch.cuda.device(dev):
        rc = lib.dts_fused_serve(
            ids.data_ptr(), wts.data_ptr(), int(wts.dtype == torch.bfloat16),
            sw.table.data_ptr(), wc.data_ptr(), sw.bc.data_ptr(), sw.wc.shape[0],
            wm, bm, mdims, len(sw.mlp),
            sw.wo.data_ptr(), sw.bo.data_ptr(), pred.data_ptr(), logit.data_ptr(),
            n, F, sw.embed_dim, int(sw.compute_dtype == torch.bfloat16),
            int(sw.quantized), sw.sc.data_ptr() if sw.quantized else None, sm,
            cluster, _stream(dev),
        )
    _check(lib, rc, "fused-serve")
    _count("fused_serve_int8" if sw.quantized else "fused_serve", sw.compute_dtype)
    return {"prediction_node": pred, "logits": logit}


# ------------------------------------------------------------ servable glue


def _dense_w(p):
    """A dense layer's weight in either form: int8 "qw" or float "w"."""
    return p.get("qw", p.get("w"))


def serve_params_supported(params) -> bool:
    """True when a param tree has the dcn_v2 shape the fused serve kernel
    takes: an embedding table, a full-matrix cross stack, an MLP list and a
    1-wide output head, in either the float {"w"} or the ops/quantize.py
    {"qw"} form."""
    try:
        emb = params["embedding"]
        cross, mlp, out = params["cross"], params["mlp"], params["out"]
    except (KeyError, TypeError):
        return False

    def dense_ok(p, out_dim=None):
        w = _dense_w(p)
        if w is None or w.ndim != 2:
            return False
        return out_dim is None or w.shape[1] == out_dim

    if getattr(emb, "ndim", 0) != 2 or not cross or not mlp:
        return False
    return (
        all(dense_ok(p) for p in cross)
        and all(dense_ok(p) for p in mlp)
        and dense_ok(out, out_dim=1)
    )


def prepare_serve_weights(params, config) -> ServeWeights:
    """Cast, stack and lay out a dcn_v2 servable's params (float, or int8
    from ops/quantize.py) for the fused serve step, on the params' own
    device."""
    if not serve_params_supported(params):
        raise ValueError("fused serving kernel requires a dcn_v2 param tree")
    cd = config.cdtype
    F, D = config.num_fields, config.embed_dim
    d = F * D
    L = len(params["cross"])
    mlp_dims = tuple(_dense_w(p).shape[1] for p in params["mlp"])
    forms = {"qw" in p for p in params["cross"] + params["mlp"]}
    if len(forms) != 1:
        raise ValueError("fused serving kernel takes all-float or all-int8 cross and MLP layers")
    quantized = forms == {True}
    if not serve_fits_smem(d, mlp_dims, cd):
        raise ValueError(
            f"fused serving kernel (d={d}, L={L}, mlp={mlp_dims}) exceeds the "
            f"{SMEM_LIMIT_BYTES}-byte shared-memory budget of one block"
        )
    f32 = torch.float32
    out = params["out"]
    if "qw" in out:  # dequantized once: the head is one f32 matvec
        wo = out["qw"].to(f32) * out["qscale"].to(f32)[None, :]
    else:
        wo = out["w"].to(f32)
    if quantized:
        wc = torch.stack([p["qw"] for p in params["cross"]])
        bc = torch.stack([p["b"] for p in params["cross"]])
        sc = torch.stack([p["qscale"] for p in params["cross"]]).to(f32).contiguous()
        ms = [p["qscale"].to(f32).contiguous() for p in params["mlp"]]
    else:
        wc, bc = cross_params_to_stacked(params["cross"])
        wc, sc, ms = wc.to(cd), None, None
    return ServeWeights(
        compute_dtype=cd,
        num_fields=F,
        embed_dim=D,
        table=params["embedding"].to(f32).contiguous(),
        wc=wc.contiguous(),
        bc=bc.to(f32).contiguous(),
        mlp=[(_dense_w(p).to(torch.int8 if quantized else cd).contiguous(),
              p["b"].to(f32).contiguous()) for p in params["mlp"]],
        wo=wo[:, 0].contiguous(),
        bo=out["b"].to(f32).reshape(1).contiguous(),
        sc=sc,
        ms=ms,
    )


def build_fused_serve(params, config):
    """The fused serving callable for ONE servable's params (float or
    int8): apply_fn(params, batch) -> {"prediction_node", "logits"}, the
    model.apply contract. The weight operands are prepared here, once; the
    `params` argument of apply_fn is accepted for signature compatibility
    and unused. `batch` carries host-folded int32 feat_ids and bf16/f32
    feat_wts."""
    sw = prepare_serve_weights(params, config)

    def apply_fn(_params, batch):
        return fused_serve(batch["feat_ids"], batch["feat_wts"], sw)

    apply_fn.serve_weights = sw
    return apply_fn
