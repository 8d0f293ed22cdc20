"""ctypes bindings for the native host-ops library (hostops.cc), built on
first use.

The library builds from hostops.cc with `g++ -O3 -shared -fPIC` into
native/build/ (git-ignored) the first time `ensure()` is called; the
serving stack calls it while it builds and warms a servable, so no request
waits on the compiler. Nothing here builds on the serving path: `available()`
only reports whether the library is loaded.

The batcher packs each bf16 batch with `pack_batch_u24_bf16`, which folds,
u24-packs, bf16-casts and pads a whole coalesced batch in one pass, straight
into the caller's (pinned) host buffer. A stack on the card whose servable
needs it refuses to start when the library cannot be built. The warmup
replay checks its TFRecord framing with `crc32c`, and the integrity plane's
wire checksums (codec.crc_sidecar) run through it. The cache plane digests
with `hash128` (the device-input cache's batch key and the score cache's
feature digest) and `hash128_rows` (blake2b-128 per row: the row cache's
keys, byte-identical to hashlib's). The codec reads the repeated numeric
fields of a TensorProto (`int64_val`, `float_val`, ...) from its serialized
bytes with `repeated_field`, one call outside the GIL in place of a walk
over protobuf's container.
"""

from __future__ import annotations

import ctypes
import logging
import os
import pathlib
import subprocess
import threading

import numpy as np

log = logging.getLogger("dts_torch.native")

_DIR = pathlib.Path(__file__).resolve().parent
_SRC = _DIR / "hostops.cc"
_SO = _DIR / "build" / "libhostops.so"

_lib: ctypes.CDLL | None = None
_tried = False
_lock = threading.Lock()


def _build() -> bool:
    _SO.parent.mkdir(exist_ok=True)
    # Build to a temp path + atomic rename: a killed or failed compile must
    # never leave a partial .so that later passes the staleness check, and
    # processes building at once each rename a whole file.
    tmp = _SO.with_suffix(f".tmp{os.getpid()}.so")
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-o", str(tmp), str(_SRC)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
        return True
    except (OSError, subprocess.SubprocessError) as e:
        log.warning("native hostops build failed (%s)", e)
        tmp.unlink(missing_ok=True)
        return False


def _load() -> ctypes.CDLL | None:
    global _lib, _tried
    if _tried:
        return _lib
    with _lock:
        if _tried:
            return _lib
        # _tried flips only after the outcome is final, under the lock, so
        # concurrent first callers cannot race the compile or load a
        # half-written file.
        _lib = _load_locked()
        _tried = True
        return _lib


def _load_locked() -> ctypes.CDLL | None:
    if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
        if not _build():
            return None
    try:
        lib = ctypes.CDLL(str(_SO))
    except OSError as e:
        log.warning("native hostops load failed (%s)", e)
        # A cached .so that will not load is useless; drop it so the next
        # process builds afresh instead of failing forever.
        _SO.unlink(missing_ok=True)
        return None
    lib.fold_i32.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
    ]
    lib.fold_i32.restype = None
    lib.pack_batch_u24_bf16.restype = None
    lib.pack_batch_u24_bf16.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
    ]
    lib.dts_crc32c.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32]
    lib.dts_crc32c.restype = ctypes.c_uint32
    lib.hash128.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    lib.hash128.restype = None
    lib.hash128_rows.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
    ]
    lib.hash128_rows.restype = None
    lib.dts_repeated_field.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.dts_repeated_field.restype = ctypes.c_int64
    return lib


def available() -> bool:
    """True once the library is loaded. Never builds."""
    return _lib is not None


def ensure() -> bool:
    """Build (seconds of g++, once per checkout) and load the library if
    needed; True when it is loaded. For stack build and tests, never for
    the serving path."""
    return _load() is not None


def _ptr(arr: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(arr.ctypes.data)


def fold_i32(ids: np.ndarray, vocab: int) -> np.ndarray:
    """int64 ids -> int32 ids mod vocab (one pass)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native hostops library unavailable")
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    out = np.empty(ids.shape, np.int32)
    lib.fold_i32(_ptr(ids), ids.size, vocab, _ptr(out))
    return out


def fold_ids(ids: np.ndarray, vocab: int) -> np.ndarray:
    """The exact host fold (int64 -> int32 mod vocab): the native one-pass
    kernel when the library is loaded, numpy remainder + astype otherwise;
    bit-identical either way."""
    if ids.dtype == np.int64 and available():
        return fold_i32(ids, vocab)
    return np.remainder(ids, np.int64(vocab)).astype(np.int32)


def pack_batch_u24_bf16(
    ids_parts: list[np.ndarray],
    wts_parts: list[np.ndarray],
    fields: int,
    bucket: int,
    vocab: int,
    out: np.ndarray | None = None,
) -> np.ndarray:
    """Fused batch assembly (see hostops.cc): per-request [n_p, F] id and
    weight arrays -> the padded combined uint8 buffer
    [bucket*F*3 u24 | bucket*F*2 bf16] in one pass per input, zero padding
    included. int64 ids are folded mod vocab; int32 ids (pre-folded) pass
    through. float32 weights are cast to bf16 (round to nearest even);
    uint16 weights are bf16 bit patterns and are copied. `out`, when given,
    is the buffer written: a C-contiguous uint8 array of bucket*F*5 bytes
    (the batcher passes the numpy view of a pinned tensor); every byte of it
    is overwritten."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native hostops library unavailable")
    nparts = len(ids_parts)
    if nparts == 0 or nparts != len(wts_parts):
        raise ValueError(f"part-count mismatch: {nparts} ids vs {len(wts_parts)} wts")
    ids_c = [np.ascontiguousarray(a) for a in ids_parts]
    wts_c = [np.ascontiguousarray(a) for a in wts_parts]
    # Real raises, not asserts: these are the only guards between a caller's
    # mistake and an out-of-bounds write in C (asserts vanish under -O).
    for i, (a, w) in enumerate(zip(ids_c, wts_c)):
        if a.dtype not in (np.int64, np.int32):
            raise ValueError(f"ids part {i}: dtype {a.dtype} not int64/int32")
        if w.dtype not in (np.float32, np.uint16):
            raise ValueError(f"wts part {i}: dtype {w.dtype} not float32/uint16 (bf16 bits)")
        if a.ndim != 2 or a.shape[1] != fields or w.shape != a.shape:
            raise ValueError(
                f"part {i}: shapes ids {a.shape} / wts {w.shape} do not "
                f"match [n, {fields}]"
            )
    ns = np.fromiter((a.shape[0] for a in ids_c), np.int64, nparts)
    if int(ns.sum()) > bucket:
        raise ValueError(f"{int(ns.sum())} rows exceed bucket {bucket}")
    nbytes = bucket * fields * 5  # 3 (u24) + 2 (bf16)
    if out is None:
        out = np.empty(nbytes, np.uint8)
    elif out.dtype != np.uint8 or out.size != nbytes or not out.flags.c_contiguous:
        raise ValueError(
            f"out must be a C-contiguous uint8 array of {nbytes} bytes, got "
            f"{out.dtype} {out.shape}"
        )
    ids_ptrs = (ctypes.c_void_p * nparts)(*(a.ctypes.data for a in ids_c))
    wts_ptrs = (ctypes.c_void_p * nparts)(*(a.ctypes.data for a in wts_c))
    ids_is64 = np.fromiter((a.dtype == np.int64 for a in ids_c), np.uint8, nparts)
    wts_isf32 = np.fromiter((w.dtype == np.float32 for w in wts_c), np.uint8, nparts)
    lib.pack_batch_u24_bf16(
        ids_ptrs, _ptr(ids_is64), wts_ptrs, _ptr(wts_isf32),
        _ptr(ns), nparts, fields, bucket, vocab, _ptr(out),
    )
    return out


def hash128(arr: np.ndarray) -> bytes:
    """16-byte content digest of a contiguous array's bytes (one pass)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native hostops library unavailable")
    arr = np.ascontiguousarray(arr)
    out = np.empty(2, np.uint64)
    lib.hash128(_ptr(arr), arr.nbytes, _ptr(out))
    return out.tobytes()


def hash128_rows(blob: np.ndarray, header: bytes = b"") -> np.ndarray:
    """Batched per-row blake2b-128: a [n, B] uint8 row matrix -> [n, 16]
    uint8 digests, row i = blake2b(header + blob[i].tobytes(),
    digest_size=16), byte-identical to hashlib's blake2b (RFC 7693 in
    hostops.cc): the row-cache keys must not depend on whether the host
    ops are built. One GIL-released call hashes the whole batch."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native hostops library unavailable")
    blob = np.ascontiguousarray(blob, dtype=np.uint8)
    if blob.ndim != 2:
        raise ValueError(f"hash128_rows wants [n, B] uint8, got {blob.shape}")
    header = bytes(header)
    out = np.empty((blob.shape[0], 16), np.uint8)
    lib.hash128_rows(header, len(header), _ptr(blob), blob.shape[0], blob.shape[1], _ptr(out))
    return out


# Value kinds of `repeated_field` (hostops.cc ScanKind) and the item size
# each writes.
SCAN_VARINT64 = 0  # int64_val, uint64_val
SCAN_VARINT32 = 1  # int_val (int32), uint32_val: the varint's low 32 bits
SCAN_FIXED32 = 2  # float_val
SCAN_FIXED64 = 3  # double_val
_SCAN_ITEMSIZE = {SCAN_VARINT64: 8, SCAN_VARINT32: 4, SCAN_FIXED32: 4, SCAN_FIXED64: 8}


def repeated_field(msg: bytes, field: int, kind: int, dtype, n: int) -> np.ndarray | None:
    """The n values of repeated numeric field number `field` of the
    serialized message `msg`, read from its bytes (packed or not) into a
    fresh [n] array of `dtype`; None when the bytes do not read as exactly
    n values of `kind` (the caller then takes its own path). One call,
    outside the GIL; `msg` is passed in place. A float_val NaN comes back
    quiet, as protobuf's Python floats return it."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native hostops library unavailable")
    out = np.empty(n, dtype)
    if _SCAN_ITEMSIZE.get(kind) != out.itemsize:
        raise ValueError(f"scan kind {kind} does not write {out.dtype} elements")
    msg = bytes(msg)
    got = lib.dts_repeated_field(msg, len(msg), field, kind, _ptr(out), n)
    return out if got == n else None


def crc32c(data, crc: int = 0) -> int:
    """CRC32C (Castagnoli) of `data`, continuing from `crc`. A numpy array
    is read in place through its buffer pointer (made contiguous first),
    any other bytes-like is copied to bytes."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native hostops library unavailable")
    if isinstance(data, np.ndarray):
        arr = np.ascontiguousarray(data)
        return lib.dts_crc32c(arr.ctypes.data, arr.nbytes, crc)
    data = bytes(data)
    return lib.dts_crc32c(data, len(data), crc)
