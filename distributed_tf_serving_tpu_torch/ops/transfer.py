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
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.base import Model

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
    keeps its sign and top payload bits and is made quiet. The rule of
    native/hostops.cc bf16_bits, so the numpy and native packs agree bit
    for bit (torch's own cast turns every NaN into 0xffff)."""
    u = np.ascontiguousarray(arr, dtype=np.float32).view(np.uint32)
    rounded = (u + (np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1)))) >> 16
    nan = (u & np.uint32(0x7FFFFFFF)) > np.uint32(0x7F800000)
    return np.where(nan, (u >> 16) | np.uint32(0x40), rounded).astype(np.uint16)


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
