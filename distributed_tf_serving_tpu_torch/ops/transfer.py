"""Host->device transfer compression for the serving hot path.

Two transforms that are lossless under the model:
- feat_ids: folded ids are < vocab_size; when vocab_size <= 2^24 the int32
  rows travel as 3 little-endian bytes each (u24), -25% id bytes. The device
  undoes it with three byte loads, shifts and ors.
- feat_wts: when the compute dtype is bfloat16 and the model consumes the
  weights only through that cast, they are cast on the host (round to
  nearest even) and travel as bf16, -50% weight bytes, with identical
  scores. numpy has no bf16 dtype, so the host side carries the bf16 bit
  patterns as uint16.

The serving path uploads a batch as ONE combined uint8 buffer
(`pack_host_combined` / `unpack_device_combined`): every input's packed
bytes back to back in sorted key order, described by `combined_layout`. The
per-key path (`pack_host` / `to_device` / `unpack_device`, one copy per
input) stays for inputs `combined_supported` refuses.

The output half (the readback wire) shapes what comes back: float32
outputs are downcast on the device to the wire dtype (bf16, f16, or int8
with a per-tensor (scale, min) sidecar pair) by `compact_outputs_device`,
or reduced to the top-k (score, index) pairs of one request by
`topk_compact_device`, and widened back to float32 on the host by
`restore_outputs_host` / `topk_restore_host` before anything user-visible
sees them. The cascade's stage-1 prune (`cascade_prune_device` /
`cascade_restore_host`) reads back one request's top-k pairs beside its
whole score vector. All are plain torch ops on their tensors' own device.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import codec
from ..models.base import Model
from ..utils.config import OUTPUT_WIRE_DTYPES

U24_MAX = 1 << 24


def transfer_spec(model: Model) -> dict[str, str]:
    """Per-input packing spec for a model; keys absent = pass-through."""
    config = model.config
    spec: dict[str, str] = {}
    if config.vocab_size <= U24_MAX and model.folds_ids_on_host:
        spec["feat_ids"] = "u24"
    if config.compute_dtype == "bfloat16" and model.wts_in_compute_dtype:
        spec["feat_wts"] = "bf16"
    return spec


def f32_to_bf16_bits(arr: np.ndarray) -> np.ndarray:
    """float32 -> bf16 bit patterns (uint16), round to nearest even; a NaN
    keeps its sign and top payload bits and is made quiet: codec.bf16_bits,
    the rule of native/hostops.cc bf16_bits, so the numpy and native packs
    agree bit for bit (torch's own cast turns every NaN into 0xffff)."""
    return codec.bf16_bits(arr).view(np.ndarray)


def pack_host(arrays: dict[str, np.ndarray], spec: dict[str, str]) -> dict[str, np.ndarray]:
    """Apply the spec on host numpy arrays (post-fold, post-pad)."""
    out = {}
    for key, arr in arrays.items():
        how = spec.get(key)
        if how == "u24":
            if arr.dtype != np.int32:
                raise ValueError(f"u24 packing expects folded int32 ids, got {arr.dtype}")
            b = np.ascontiguousarray(arr).view(np.uint8).reshape(*arr.shape, 4)
            out[key] = np.ascontiguousarray(b[..., :3])  # LE low 3 bytes
        elif how == "bf16":
            out[key] = f32_to_bf16_bits(arr)
        else:
            out[key] = arr
    return out


def to_device(packed: dict[str, np.ndarray], device) -> dict[str, torch.Tensor]:
    """Upload packed host arrays (uint16 bf16 bits ride as int16)."""
    out = {}
    for key, arr in packed.items():
        if arr.dtype == np.uint16:
            arr = arr.view(np.int16)
        out[key] = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    return out


def unpack_device(packed: dict[str, torch.Tensor], spec: dict[str, str]) -> dict[str, torch.Tensor]:
    """Inverse of pack_host on device tensors."""
    out = {}
    for key, arr in packed.items():
        how = spec.get(key)
        if how == "u24":
            b = arr.to(torch.int32)
            out[key] = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16)
        elif how == "bf16":
            out[key] = arr.view(torch.bfloat16)
        else:
            out[key] = arr
    return out


def combined_supported(arrays: dict[str, np.ndarray]) -> bool:
    """True when every array can be rebuilt on the device by a bitcast of
    its bytes: fixed-width numerics of 1, 2 or 4 bytes. bf16 bit patterns
    (uint16) qualify. Excluded, so the per-key path carries them: bool,
    8-byte dtypes (raw int64 ids of a model that does not fold on the
    host), strings and objects."""
    return all(a.dtype.kind in "iuf" and a.dtype.itemsize in (1, 2, 4) for a in arrays.values())


def combined_layout(arrays: dict[str, np.ndarray], spec: dict[str, str]) -> tuple:
    """Metadata of the combined buffer, computed without packing: a hashable
    tuple of per-input entries (key, kind, trailing_shape,
    per_candidate_bytes, packed_dtype_str), key-sorted. bf16-packed inputs
    name their dtype "bfloat16" (the host carries their bits as uint16)."""
    layout = []
    for key in sorted(arrays):
        arr = arrays[key]
        kind = spec.get(key, "raw")
        trailing = tuple(int(t) for t in arr.shape[1:])
        inner = int(np.prod(trailing)) if trailing else 1
        if kind == "u24":
            layout.append((key, "u24", trailing, inner * 3, "u24"))
        elif kind == "bf16":
            layout.append((key, "raw", trailing, inner * 2, "bfloat16"))
        else:
            layout.append((key, "raw", trailing, inner * arr.dtype.itemsize, arr.dtype.name))
    return tuple(layout)


def pack_host_combined(arrays: dict[str, np.ndarray], spec: dict[str, str],
                       out: np.ndarray | None = None) -> np.ndarray:
    """Spec-pack each input, then lay the raw bytes end to end in one uint8
    buffer (the sorted key order of combined_layout). `out`, when given, is
    written instead of a new buffer: a C-contiguous uint8 array of exactly
    the packed size (the batcher passes the numpy view of a pinned
    tensor)."""
    packed = pack_host(arrays, spec)
    segs = [np.ascontiguousarray(packed[key]).reshape(-1).view(np.uint8) for key in sorted(packed)]
    if out is None:
        return np.concatenate(segs) if len(segs) > 1 else segs[0].copy()
    total = sum(s.size for s in segs)
    if out.dtype != np.uint8 or out.size != total or not out.flags.c_contiguous:
        raise ValueError(f"out must be a C-contiguous uint8 array of {total} bytes, "
                         f"got {out.dtype} {out.shape}")
    off = 0
    for s in segs:
        out[off:off + s.size] = s
        off += s.size
    return out


def combined_nbytes(layout: tuple, rows: int) -> int:
    """Bytes of the combined buffer of `rows` candidates."""
    return rows * sum(e[3] for e in layout)


def _torch_dtype(name: str) -> torch.dtype:
    if name == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, np.dtype(name))).dtype


def unpack_device_combined(buf: torch.Tensor, layout: tuple) -> dict[str, torch.Tensor]:
    """Inverse of pack_host_combined on a 1-D uint8 tensor (on the card
    after its one upload, or on the CPU). u24 segments decode to int32 with
    three byte loads, shifts and ors; raw segments are views of the buffer
    in their dtype. A view needs its byte offset to be a multiple of the
    item size: the weights segment starts at rows * F * 3, odd for odd
    rows * F, so a misaligned segment is copied to fresh (aligned) memory
    first."""
    total_pcb = sum(e[3] for e in layout)
    n = buf.shape[0] // total_pcb
    out = {}
    off = 0
    for key, kind, trailing, per_cand, dtype_str in layout:
        nb = n * per_cand
        seg = buf[off:off + nb]
        off += nb
        if kind == "u24":
            b = seg.reshape(n, *trailing, 3).to(torch.int32)
            out[key] = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16)
            continue
        dt = _torch_dtype(dtype_str)
        if seg.storage_offset() % dt.itemsize:
            seg = seg.clone()
        out[key] = seg.view(dt).reshape(n, *trailing)
    return out


# ------------------------------------------------------- output compaction
#
# The readback wire: the device step's float32 outputs cross the D2H copy
# at the wire dtype and are widened back to float32 on the host by the
# completion worker. Same names, keys and arithmetic as the JAX package's
# ops/transfer.py, so either side's wire decodes the other's.

_WIRE_DTYPES = dict(zip(OUTPUT_WIRE_DTYPES, (None, torch.bfloat16, torch.float16, torch.int8)))

# int8 readback wire: affine int8 over the tensor's live range (254 levels,
# worst-case error range/508), the per-tensor scale and min riding as two
# 1-element float32 sidecar outputs that restore_outputs_host consumes.
Q8_LEVELS = 254.0
Q8_SCALE_SUFFIX = "::q8scale"
Q8_MIN_SUFFIX = "::q8min"
# float32(1 / 254): the JAX package runs quantize_output_device under
# jax.jit, where XLA turns the division by the constant 254 into a
# multiplication by this reciprocal. Multiplying here keeps the scale
# bit-identical to the reference's (a true division differs by one ulp for
# some inputs).
_Q8_INV_LEVELS = float(np.float32(1.0) / np.float32(Q8_LEVELS))


def is_wire_sidecar(key: str) -> bool:
    """True for the scale / min sidecar keys the int8 wire adds: they ride
    the readback with their output and are stripped by
    restore_outputs_host."""
    return key.endswith(Q8_SCALE_SUFFIX) or key.endswith(Q8_MIN_SUFFIX)


def output_wire_dtype(name: str) -> torch.dtype | None:
    """The torch dtype of an output wire-dtype name; None for float32 (no
    downcast). An unknown name is refused."""
    if name not in _WIRE_DTYPES:
        raise ValueError(f"unknown output wire dtype {name!r}; have {sorted(_WIRE_DTYPES)}")
    return _WIRE_DTYPES[name]


def quantize_output_device(v: torch.Tensor):
    """Affine int8 quantization of one float32 output on its device:
    (q int8, scale [1] f32, min [1] f32), all device tensors (no host
    sync). A constant tensor gets the 1e-8 scale and round-trips exactly."""
    v32 = v.float()
    mn = v32.min()
    # An f32 product whether taken in f32 or in double (exact there), so
    # the card and the CPU round it alike.
    scale = torch.clamp_min((v32.max() - mn) * _Q8_INV_LEVELS, 1e-8)
    q = torch.clamp(torch.round((v32 - mn) / scale), 0.0, Q8_LEVELS) - 127.0
    return q.to(torch.int8), scale.reshape(1), mn.reshape(1)


def compact_outputs_device(outputs: dict[str, torch.Tensor],
                           wire_dt: torch.dtype | None) -> dict[str, torch.Tensor]:
    """Downcast the float32 outputs to the wire dtype on their device, so
    only the compact bytes are read back. Other dtypes pass through (the
    transform must stay invertible by restore_outputs_host). The int8 wire
    adds each quantized output's (scale, min) sidecar pair."""
    if wire_dt is None:
        return dict(outputs)
    out: dict[str, torch.Tensor] = {}
    for k, v in outputs.items():
        if v.dtype != torch.float32:
            out[k] = v
        elif wire_dt == torch.int8:
            out[k], out[k + Q8_SCALE_SUFFIX], out[k + Q8_MIN_SUFFIX] = quantize_output_device(v)
        else:
            out[k] = v.to(wire_dt)
    return out


def _host_numpy(v) -> np.ndarray:
    """A host tensor or array as an owned numpy array; bf16, which numpy
    lacks, widened to float32 (exact)."""
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            return v.float().numpy()
        return v.numpy().copy()
    return np.array(v)


def restore_outputs_host(host: dict) -> dict[str, np.ndarray]:
    """Host inverse of compact_outputs_device: host tensors (or arrays) in,
    owned numpy arrays out. bf16 / f16 outputs widen to float32; an int8
    output with its two sidecars is dequantized through
    codec.dequantize_scores (the one dequantization the response wire
    uses too); the sidecars are dropped. An int8 output without sidecars
    is a genuine int8 output and passes through."""
    from ..codec import dequantize_scores  # codec pulls the proto bindings

    out = {}
    for k, v in host.items():
        if is_wire_sidecar(k):
            continue
        scale, mn = host.get(k + Q8_SCALE_SUFFIX), host.get(k + Q8_MIN_SUFFIX)
        arr = _host_numpy(v)
        if arr.dtype == np.float16:
            arr = arr.astype(np.float32)
        elif arr.dtype == np.int8 and scale is not None and mn is not None:
            arr = dequantize_scores(arr, float(scale[0]), float(mn[0]))
        out[k] = arr
    return out


def topk_compact_device(scores: torch.Tensor, n_valid: int, k: int,
                        wire_dt: torch.dtype | None) -> dict[str, torch.Tensor]:
    """Top-k output compaction on the device: the k best (score, index)
    pairs of the first `n_valid` rows (padding rows masked to -inf, so they
    never outrank a candidate). Selected on the float32 scores by a stable
    descending sort, which orders ties by index as jax.lax.top_k does
    (torch.topk does not). The values go out at the wire dtype; the int8
    wire sends them as bf16, as the JAX package does. `n_valid` is a
    Python int: nothing here waits for the device."""
    vals, idx = _masked_top(scores.float(), n_valid, k)
    if wire_dt is not None:
        vals = vals.to(_pair_wire(wire_dt))
    return {"topk_scores": vals, "topk_indices": idx.to(torch.int32)}


def _masked_top(s32: torch.Tensor, n_valid: int, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k best (value, index) of the first n_valid rows, padding masked
    to -inf, by the stable descending sort (ties in index order)."""
    pad = torch.arange(s32.shape[0], device=s32.device) >= n_valid
    vals, idx = torch.sort(s32.masked_fill(pad, float("-inf")), descending=True, stable=True)
    return vals[:k], idx[:k]


def _pair_wire(wire_dt: torch.dtype) -> torch.dtype:
    """The dtype (score, index) pairs go out at: the wire dtype, except that
    the int8 wire sends bf16 (a handful of pairs needs no sidecars), as the
    JAX package does."""
    return torch.bfloat16 if wire_dt == torch.int8 else wire_dt


def cascade_prune_device(scores: torch.Tensor, n_valid: int, k: int,
                         wire_dt: torch.dtype | None) -> dict[str, torch.Tensor]:
    """The cascade's stage-1 prune on the device: the k best (score, index)
    survivor pairs of the first `n_valid` rows, selected as
    topk_compact_device selects them, and the whole stage-1 score vector,
    both at the wire dtype (bf16 on the int8 wire). The vector comes back
    too because the answer fills every pruned row with its stage-1 score;
    it is not masked (the host trims it to the request's rows)."""
    s32 = scores.float()
    vals, idx = _masked_top(s32, n_valid, k)
    full = s32
    if wire_dt is not None:
        vals, full = vals.to(_pair_wire(wire_dt)), full.to(_pair_wire(wire_dt))
    return {"survivor_scores": vals, "survivor_indices": idx.to(torch.int32),
            "stage1_scores": full}


def cascade_restore_host(host: dict, n: int) -> dict[str, np.ndarray]:
    """Host side of cascade_prune_device: owned arrays, the scores widened
    to float32, the stage-1 vector trimmed to the request's n rows."""
    return {"survivor_scores": _host_numpy(host["survivor_scores"]).astype(np.float32, copy=False),
            "survivor_indices": _host_numpy(host["survivor_indices"]),
            "stage1_scores": _host_numpy(host["stage1_scores"])[:n].astype(np.float32, copy=False)}


def topk_restore_host(vals, idx, n: int, score_key: str) -> dict[str, np.ndarray]:
    """Host inverse of topk_compact_device: the k pairs scattered into a
    float32 vector of n with 0.0 off the head (sigmoid scores are positive,
    so a ranking consumer sees the same head; the tail is unranked)."""
    scores = np.zeros(n, np.float32)
    scores[_host_numpy(idx)] = _host_numpy(vals).astype(np.float32)
    return {score_key: scores}
