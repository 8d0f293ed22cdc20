"""TensorProto <-> numpy array codec (the port's own copy).

Both wire encodings of the TF-Serving tensor data plane: the raw
little-endian `tensor_content` fast path (zero-copy via np.frombuffer) and
the per-dtype repeated fields (what grpc-java clients emit — int64_val /
float_val). Element counts are validated against the declared shape. When
the native host ops are loaded, a repeated int64 / int32 / uint32 / uint64
/ float / double field is read from the tensor's serialized bytes in one
call outside the GIL (native.repeated_field), bit for bit the values the
walk over protobuf's container gives; `decode_counts()` says how many
tensors took that route ("packed") and how many the walk ("walked").

Differences from the JAX package's codec, both because this package needs
nothing beyond numpy: DT_BFLOAT16 has no numpy dtype here, so a bf16 tensor
decodes WIDENED to float32 (exact: every bf16 value is an f32 value), and
a DT_BFLOAT16 tensor is encoded from `BF16Bits` (uint16 bit patterns, made
by `bf16_bits`), byte for byte the tensor an ml_dtypes bfloat16 array
gives there. The int8 score response wire
(`quantize_scores`, `dequantize_response_output`) is the JAX package's, in
numpy, bit for bit. The CRC32C sidecars of the integrity plane's wire
layer (`crc_sidecar` and its inverse) are the JAX package's, over the same
canonical form, so a stamp made by either package verifies in the other;
the checksum runs through the native slicing-by-8 `dts_crc32c`
(native/hostops.cc) when the host ops are loaded, and through a table loop
(the plain version, bit-identical) otherwise. A bf16 input decodes widened
to float32 here, so a stamp made over bf16 bytes does not verify against
it.
"""

from __future__ import annotations

import threading

import numpy as np

from . import native
from .proto import tf_framework_pb2 as fw

DataType = fw.DataType


class CodecError(ValueError):
    """Raised for malformed, inconsistent, or unsupported TensorProtos."""


# DataType -> (numpy dtype, repeated-field name). Quantized dtypes decode to
# their underlying integer layout; DT_STRING is handled separately.
_DTYPES: dict[int, tuple[np.dtype, str]] = {
    DataType.DT_FLOAT: (np.dtype(np.float32), "float_val"),
    DataType.DT_DOUBLE: (np.dtype(np.float64), "double_val"),
    DataType.DT_INT32: (np.dtype(np.int32), "int_val"),
    DataType.DT_UINT8: (np.dtype(np.uint8), "int_val"),
    DataType.DT_INT16: (np.dtype(np.int16), "int_val"),
    DataType.DT_INT8: (np.dtype(np.int8), "int_val"),
    DataType.DT_COMPLEX64: (np.dtype(np.complex64), "scomplex_val"),
    DataType.DT_INT64: (np.dtype(np.int64), "int64_val"),
    DataType.DT_BOOL: (np.dtype(np.bool_), "bool_val"),
    DataType.DT_QINT8: (np.dtype(np.int8), "int_val"),
    DataType.DT_QUINT8: (np.dtype(np.uint8), "int_val"),
    DataType.DT_QINT32: (np.dtype(np.int32), "int_val"),
    # bf16 travels as uint16 bit patterns; to_ndarray widens them to f32.
    DataType.DT_BFLOAT16: (np.dtype(np.uint16), "half_val"),
    DataType.DT_QINT16: (np.dtype(np.int16), "int_val"),
    DataType.DT_QUINT16: (np.dtype(np.uint16), "int_val"),
    DataType.DT_UINT16: (np.dtype(np.uint16), "int_val"),
    DataType.DT_COMPLEX128: (np.dtype(np.complex128), "dcomplex_val"),
    DataType.DT_HALF: (np.dtype(np.float16), "half_val"),
    DataType.DT_UINT32: (np.dtype(np.uint32), "uint32_val"),
    DataType.DT_UINT64: (np.dtype(np.uint64), "uint64_val"),
}

# numpy dtype -> DataType, for encoding.
_NP_TO_DT: dict[np.dtype, int] = {
    np.dtype(np.float32): DataType.DT_FLOAT,
    np.dtype(np.float64): DataType.DT_DOUBLE,
    np.dtype(np.float16): DataType.DT_HALF,
    np.dtype(np.int64): DataType.DT_INT64,
    np.dtype(np.int32): DataType.DT_INT32,
    np.dtype(np.int16): DataType.DT_INT16,
    np.dtype(np.int8): DataType.DT_INT8,
    np.dtype(np.uint64): DataType.DT_UINT64,
    np.dtype(np.uint32): DataType.DT_UINT32,
    np.dtype(np.uint16): DataType.DT_UINT16,
    np.dtype(np.uint8): DataType.DT_UINT8,
    np.dtype(np.bool_): DataType.DT_BOOL,
    np.dtype(np.complex64): DataType.DT_COMPLEX64,
    np.dtype(np.complex128): DataType.DT_COMPLEX128,
}

_DTYPES_LE: dict[int, np.dtype] = {
    dt: np_dtype.newbyteorder("<") for dt, (np_dtype, _f) in _DTYPES.items()
}


class BF16Bits(np.ndarray):
    """bfloat16 values held as their uint16 bit patterns. `from_ndarray`
    encodes one as DT_BFLOAT16 and `ndarray_crc` checksums it under the
    header of numpy's bfloat16 extension dtype, so the client's compact
    wire matches the JAX package's byte for byte. Slices and fancy indexing
    keep the type; arithmetic on it is meaningless."""


def bf16_bits(arr: np.ndarray) -> BF16Bits:
    """float32 -> BF16Bits, round to nearest even; a NaN keeps its sign and
    top payload bits and is made quiet (the rule of native/hostops.cc
    bf16_bits; ops/transfer.py f32_to_bf16_bits is this, as plain uint16).
    A DT_BFLOAT16 tensor that `to_ndarray` widened narrows back exactly."""
    u = np.ascontiguousarray(arr, dtype=np.float32).view(np.uint32)
    rounded = (u + (np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1)))) >> 16
    nan = (u & np.uint32(0x7FFFFFFF)) > np.uint32(0x7F800000)
    bits = np.where(nan, (u >> 16) | np.uint32(0x40), rounded).astype(np.uint16)
    return bits.view(BF16Bits)


def dtype_to_numpy(dt: int) -> np.dtype:
    """The numpy dtype `to_ndarray` returns for a DataType (float32 for
    DT_BFLOAT16, which decodes widened)."""
    if dt not in _DTYPES:
        raise CodecError(f"unsupported DataType: {DataType.Name(dt) if dt in DataType.values() else dt}")
    if dt == DataType.DT_BFLOAT16:
        return np.dtype(np.float32)
    return _DTYPES[dt][0]


def numpy_to_dtype(dtype: np.dtype) -> int:
    dtype = np.dtype(dtype)
    if dtype not in _NP_TO_DT:
        raise CodecError(f"no DataType mapping for numpy dtype {dtype}")
    return _NP_TO_DT[dtype]


def shape_from_proto(shape: fw.TensorShapeProto) -> tuple[int, ...]:
    if shape.unknown_rank:
        raise CodecError("unknown_rank shapes are not servable")
    dims = tuple(d.size for d in shape.dim)
    if any(d < 0 for d in dims):
        raise CodecError(f"negative dimension in shape {dims}")
    return dims


def shape_to_proto(shape: tuple[int, ...]) -> fw.TensorShapeProto:
    return fw.TensorShapeProto(dim=[fw.TensorShapeProto.Dim(size=int(s)) for s in shape])


def _num_elements(dims: tuple[int, ...]) -> int:
    n = 1
    for d in dims:
        n *= d
    return n


def _bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


# DataType -> (field number, native scan kind) of the repeated fields read
# from the serialized tensor. Left out: the narrow integers carried in
# int_val (numpy raises on an out-of-range value, a native cast would wrap
# it), bool_val, half_val and the complex pairs.
_SCANNED: dict[int, tuple[int, int]] = {
    dt: (fw.TensorProto.DESCRIPTOR.fields_by_name[_DTYPES[dt][1]].number, kind)
    for dt, kind in (
        (DataType.DT_INT64, native.SCAN_VARINT64),
        (DataType.DT_UINT64, native.SCAN_VARINT64),
        (DataType.DT_INT32, native.SCAN_VARINT32),
        (DataType.DT_UINT32, native.SCAN_VARINT32),
        (DataType.DT_FLOAT, native.SCAN_FIXED32),
        (DataType.DT_DOUBLE, native.SCAN_FIXED64),
    )
}

# Repeated-field tensors decoded by each route, process-wide.
_decode_lock = threading.Lock()
_decode_counts = {"packed": 0, "walked": 0}


def _count(route: str) -> None:
    with _decode_lock:
        _decode_counts[route] += 1


def decode_counts() -> dict[str, int]:
    """Tensors `to_ndarray` decoded from a repeated field, by route:
    "packed" read from the serialized bytes, "walked" through protobuf's
    container element by element. The `decode` block of /monitoring."""
    with _decode_lock:
        return dict(_decode_counts)


def to_ndarray(tp: fw.TensorProto) -> np.ndarray:
    """Decode a TensorProto to a numpy array, validating shape vs payload."""
    dt = tp.dtype
    dims = shape_from_proto(tp.tensor_shape)
    n = _num_elements(dims)

    if dt == DataType.DT_STRING:
        vals = list(tp.string_val)
        if len(vals) != n:
            raise CodecError(f"DT_STRING: {len(vals)} values for shape {dims} ({n} elements)")
        out = np.empty(n, dtype=object)
        out[:] = vals
        return out.reshape(dims)

    np_dtype, field = _DTYPES.get(dt, (None, None))
    if np_dtype is None:
        raise CodecError(
            f"unsupported DataType: {DataType.Name(dt) if dt in DataType.values() else dt}"
        )
    bf16 = dt == DataType.DT_BFLOAT16

    content = tp.tensor_content
    if content:
        buf = np.frombuffer(content, dtype=_DTYPES_LE[dt])
        if buf.size != n:
            raise CodecError(
                f"tensor_content holds {buf.size} {np_dtype} elements, shape {dims} needs {n}"
            )
        if bf16:
            return _bf16_bits_to_f32(buf).reshape(dims)
        return buf.astype(np_dtype, copy=False).reshape(dims)

    vals = getattr(tp, field)
    nvals = len(vals)
    scan = _SCANNED.get(dt)
    if scan is not None and nvals == n and native.available():
        out = native.repeated_field(tp.SerializeToString(), *scan, np_dtype, n)
        if out is not None:
            _count("packed")
            return out.reshape(dims)
    out = _walk(vals, nvals, field, bf16, np_dtype, dims, n)
    _count("walked")
    return out


def _walk(vals, nvals: int, field: str, bf16: bool, np_dtype: np.dtype,
          dims: tuple[int, ...], n: int) -> np.ndarray:
    """A repeated field's values through protobuf's container, one Python
    object per element."""
    if field == "half_val":
        # uint16 bit patterns widened to int32 on the wire.
        if nvals != n:
            raise CodecError(f"half_val holds {nvals} elements, shape {dims} needs {n}")
        bits = np.asarray(vals, dtype=np.int32).astype(np.uint16)
        if bf16:
            return _bf16_bits_to_f32(bits).reshape(dims)
        return bits.view(np_dtype).reshape(dims)

    if field in ("scomplex_val", "dcomplex_val"):
        if nvals != 2 * n:
            raise CodecError(f"{field} holds {nvals} floats, shape {dims} needs {2 * n}")
        real_dtype = np.float32 if field == "scomplex_val" else np.float64
        flat = np.asarray(vals, dtype=real_dtype)
        return flat.view(np_dtype).reshape(dims)

    if nvals == n:
        return np.asarray(vals, dtype=np_dtype).reshape(dims)
    if nvals == 1 and n >= 1:
        # Proto3 scalar-broadcast convention: a single value fills the tensor.
        return np.full(dims, np.asarray(vals[0], dtype=np_dtype), dtype=np_dtype)
    raise CodecError(f"{field} holds {nvals} elements, shape {dims} needs {n}")


class EncodeArena:
    """Reusable encode scratch ([transport] response_arena): the
    contiguity copy of a strided tensor, a float32 widen, and the dense
    (n, num_fields) batches the Example decoder builds reuse one backing
    allocation per dtype, grown geometrically, instead of a fresh one per
    call.

    Not thread-safe by design: hold one arena per thread (the service keeps
    a threading.local). Scratch returned by ndarray() / contiguous() /
    widen_f32() is valid only until the next call for the same dtype, so a
    caller finishes with it (protobuf copies on field assignment; the
    batcher's prepare_inputs copies an array that is not bytes-backed)
    before the next call — on a coroutine server, with no await between."""

    def __init__(self):
        self._bufs: dict[str, bytearray] = {}
        self.reuses = 0
        self.grows = 0

    def ndarray(self, shape: tuple, dtype) -> np.ndarray:
        """A writable scratch array of `shape` over reused storage (contents
        undefined: callers overwrite it fully)."""
        dt = np.dtype(dtype)
        count = int(np.prod(shape))
        nbytes = count * dt.itemsize
        buf = self._bufs.get(dt.str)
        if buf is None or len(buf) < nbytes:
            # Geometric growth: sizes within 2x of each other share one
            # allocation instead of reallocating at each high-water mark.
            buf = bytearray(max(nbytes, 2 * len(buf) if buf else 0, 1024))
            self._bufs[dt.str] = buf
            self.grows += 1
        else:
            self.reuses += 1
        return np.frombuffer(buf, dtype=dt, count=count).reshape(shape)

    def contiguous(self, arr: np.ndarray) -> np.ndarray:
        """`arr` when C-contiguous, else a copy of it in scratch (what
        np.ascontiguousarray would allocate)."""
        if arr.flags.c_contiguous:
            return arr
        out = self.ndarray(arr.shape, arr.dtype)
        np.copyto(out, arr)
        return out

    def widen_f32(self, arr: np.ndarray) -> np.ndarray:
        """`arr.astype(np.float32)` into scratch."""
        out = self.ndarray(arr.shape, np.float32)
        np.copyto(out, arr, casting="unsafe")
        return out


def from_ndarray(
    arr: np.ndarray,
    *,
    use_tensor_content: bool = True,
    out: fw.TensorProto | None = None,
    arena: EncodeArena | None = None,
) -> fw.TensorProto:
    """Encode a numpy array as a TensorProto.

    use_tensor_content=True emits the raw-bytes fast path; False emits the
    per-dtype repeated fields. `out` fills an existing (empty) message in
    place, e.g. a response's map entry. `arena` (EncodeArena) takes the
    contiguity copy a strided array needs instead of a fresh allocation.
    A `BF16Bits` array encodes as DT_BFLOAT16."""
    bf16 = isinstance(arr, BF16Bits)
    arr = np.asarray(arr)
    if not arr.flags.c_contiguous:
        arr = arena.contiguous(arr) if arena is not None else np.ascontiguousarray(arr)

    if arr.dtype == object or arr.dtype.kind in ("S", "U"):
        tp = out if out is not None else fw.TensorProto()
        tp.dtype = DataType.DT_STRING
        tp.tensor_shape.CopyFrom(shape_to_proto(arr.shape))
        for v in arr.ravel():
            tp.string_val.append(v.encode() if isinstance(v, str) else bytes(v))
        return tp

    dt = DataType.DT_BFLOAT16 if bf16 else numpy_to_dtype(arr.dtype)
    np_dtype, field = _DTYPES[dt]

    tp = out if out is not None else fw.TensorProto()
    tp.dtype = dt
    tp.tensor_shape.CopyFrom(shape_to_proto(arr.shape))
    if use_tensor_content:
        tp.tensor_content = arr.astype(_DTYPES_LE[dt], copy=False).tobytes()
        return tp

    flat = arr.ravel()
    if field == "half_val":
        tp.half_val.extend(flat.view(np.uint16).astype(np.int32).tolist())
    elif field in ("scomplex_val", "dcomplex_val"):
        real_dtype = np.float32 if field == "scomplex_val" else np.float64
        getattr(tp, field).extend(flat.view(real_dtype).tolist())
    else:
        getattr(tp, field).extend(flat.tolist())
    return tp


# ------------------------------------------------- int8 score response wire
#
# A client that opts in (x-dts-score-wire: int8 metadata, against a server
# whose [kernels] plane has int8_score_wire = true) receives the score
# tensor as DT_INT8 plus two 1-element DT_FLOAT sidecar outputs carrying the
# affine (scale, min) pair, and dequantizes locally: 4x fewer response bytes
# per score than f32. The 254-level scheme of ops/transfer.py's readback
# wire, here in numpy (a true division by 254, as the JAX package's codec
# does, so the two wires agree with their own references bit for bit).

Q8_WIRE_LEVELS = 254.0
Q8_WIRE_SCALE_SUFFIX = "/q8_scale"
Q8_WIRE_MIN_SUFFIX = "/q8_min"


def quantize_scores(arr: np.ndarray) -> tuple[np.ndarray, float, float]:
    """Affine int8 quantization of a float score array on the host:
    (q int8, scale, min). Worst-case dequantization error is range/508."""
    v = np.asarray(arr, np.float32)
    mn = float(v.min()) if v.size else 0.0
    mx = float(v.max()) if v.size else 0.0
    scale = max((mx - mn) / Q8_WIRE_LEVELS, 1e-8)
    q = np.clip(np.rint((v - mn) / scale), 0.0, Q8_WIRE_LEVELS) - 127.0
    return q.astype(np.int8), scale, mn


def dequantize_scores(q: np.ndarray, scale: float, mn: float) -> np.ndarray:
    """Inverse of quantize_scores (float32)."""
    return (np.asarray(q, np.float32) + 127.0) * float(scale) + float(mn)


def dequantize_response_output(outputs_map, key: str) -> np.ndarray:
    """Client-side decode of one response output that may ride the int8
    score wire: a DT_INT8 tensor with both sidecar outputs present is
    dequantized to float32; anything else decodes normally. `outputs_map`
    is a PredictResponse.outputs map."""
    tp = outputs_map[key]
    skey, mkey = key + Q8_WIRE_SCALE_SUFFIX, key + Q8_WIRE_MIN_SUFFIX
    if tp.dtype == DataType.DT_INT8 and skey in outputs_map and mkey in outputs_map:
        scale = float(to_ndarray(outputs_map[skey])[0])
        mn = float(to_ndarray(outputs_map[mkey])[0])
        return dequantize_scores(to_ndarray(tp), scale, mn)
    return to_ndarray(tp)


# ---------------------------------------------------- wire integrity (CRC)
#
# CRC32C (Castagnoli) sidecars over tensor bytes, carried in gRPC metadata
# both ways. Both ends checksum the DECODED ndarray's canonical form — a
# "{dtype.str}:{shape}" header chained with the contiguous payload — so the
# check does not depend on the encoding (tensor_content, repeated fields,
# the int8 score wire).

_CRC32C_POLY = 0x82F63B78
_CRC32C_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ (_CRC32C_POLY if _c & 1 else 0)
    _CRC32C_TABLE.append(_c)
del _i, _c

CRC_INPUT_MD = "x-dts-input-crc"
CRC_SCORE_MD = "x-dts-score-crc"


def crc32c_table(data, crc: int = 0) -> int:
    """CRC32C by the byte-at-a-time table loop: the plain version of the
    native checksum, and the one used when the host ops are not loaded."""
    crc ^= 0xFFFFFFFF
    table = _CRC32C_TABLE
    for b in bytes(data):
        crc = (crc >> 8) ^ table[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def crc32c(data, crc: int = 0) -> int:
    """CRC32C over a bytes-like or a numpy array; pass a prior value to
    chain. Native (an array read in place) when the host ops are loaded."""
    if native.available():
        return native.crc32c(data, crc)
    return crc32c_table(data, crc)


def ndarray_crc(arr: np.ndarray, wire_bf16: bool = False) -> int:
    """Canonical tensor checksum: the dtype/shape header chained with the
    contiguous payload bytes, so a flipped shape dim is as detectable as a
    flipped payload bit. `wire_bf16`: `arr` is a DT_BFLOAT16 tensor that
    to_ndarray widened to float32; the checksum is over the bits the wire
    carried (the widening narrows back exactly) under the header of
    numpy's bfloat16 extension dtype ("<V2"), as its sender computed it.
    A `BF16Bits` array is checksummed the same way over its own bits."""
    if isinstance(arr, BF16Bits):
        a = np.ascontiguousarray(arr)
        head = f"<V2:{a.shape}".encode()
    elif wire_bf16:
        a = np.ascontiguousarray(arr)
        a = (a.view(np.uint32) >> 16).astype(np.uint16)
        head = f"<V2:{a.shape}".encode()
    else:
        a = np.ascontiguousarray(arr)
        head = f"{a.dtype.str}:{a.shape}".encode()
    payload = a.tobytes() if a.dtype.hasobject else a.reshape(-1).view(np.uint8)
    return crc32c(payload, crc32c(head))


def crc_sidecar(arrays: dict) -> str:
    """Per-tensor checksums as one metadata value: ``name=%08x`` pairs
    joined by commas, in sorted name order."""
    return ",".join(f"{name}={ndarray_crc(arrays[name]):08x}" for name in sorted(arrays))


def parse_crc_sidecar(value: str) -> dict[str, int]:
    """Inverse of crc_sidecar. A malformed entry raises CodecError: a
    corrupted sidecar must fail the check, not pass it."""
    out: dict[str, int] = {}
    for pair in filter(None, (p.strip() for p in value.split(","))):
        name, sep, hexcrc = pair.rpartition("=")
        if not sep or not name:
            raise CodecError(f"malformed crc sidecar entry {pair!r}")
        try:
            out[name] = int(hexcrc, 16)
        except ValueError as e:
            raise CodecError(f"malformed crc sidecar entry {pair!r}") from e
    return out


def verify_crc_sidecar(arrays: dict, sidecar: str, bf16=()) -> list[str]:
    """Names whose decoded bytes mismatch their stamped checksum, sorted.
    A name stamped but absent from `arrays` is reported (a dropped tensor
    is corruption); a name present but unstamped is not (the sidecar may
    cover a subset). The names in `bf16` were decoded from DT_BFLOAT16 and
    are checked over their wire bits (ndarray_crc's wire_bf16)."""
    stamped = parse_crc_sidecar(sidecar)
    return sorted(name for name, want in stamped.items()
                  if name not in arrays or ndarray_crc(arrays[name], name in bf16) != want)
