"""The port's codec reads repeated numeric fields from the tensor's bytes
(native.repeated_field) and must give, bit for bit, what the JAX codec's
walk over protobuf's container gives: every dtype the route covers, the
edge values of each, and every case it hands back to the walk."""

import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from distributed_tf_serving_tpu import codec as jax_codec
from distributed_tf_serving_tpu.proto import tf_framework_pb2 as jax_fw
from distributed_tf_serving_tpu_torch import codec, native
from distributed_tf_serving_tpu_torch.proto import tf_framework_pb2 as fw

DT = fw.DataType


@pytest.fixture(autouse=True)
def _native():
    if not native.ensure():
        pytest.fail("the native host ops did not build")


def _bits(*words, dtype):
    """Values of `dtype` from their raw bit patterns."""
    width = np.dtype(dtype).itemsize
    return np.array(words, np.uint32 if width == 4 else np.uint64).view(dtype)


# The edge values of each covered dtype.
EDGES = {
    np.int64: np.array([0, 1, 2**40 - 1, 2**63 - 1, -(2**63), -1, -5, -(2**40)], np.int64),
    np.int32: np.array([0, 1, -1, 2**31 - 1, -(2**31), -12345], np.int32),
    np.uint32: np.array([0, 1, 127, 128, 2**32 - 1, 2**31], np.uint32),
    np.uint64: np.array([0, 1, 2**63, 2**64 - 1, 2**40 - 1], np.uint64),
    # +-0, +-inf, subnormals, a quiet NaN, a signalling NaN and a payload NaN.
    np.float32: _bits(0x00000000, 0x80000000, 0x7F800000, 0xFF800000, 0x00000001, 0x807FFFFF,
                      0x7FC00000, 0x7F800001, 0xFFA12345, dtype=np.float32),
    np.float64: _bits(0x0000000000000000, 0x8000000000000000, 0x7FF0000000000000,
                      0xFFF0000000000000, 0x0000000000000001, 0x800FFFFFFFFFFFFF,
                      0x7FF8000000000000, 0x7FF0000000000001, 0xFFF8000000000123,
                      dtype=np.float64),
}


def _values(dtype, shape, seed=0):
    """Edge values first, then random ones: ids U[0, 2^40) and negative ids
    for int64, the full range for the other integers, normals for floats."""
    n = int(np.prod(shape))
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    if dt == np.int64:
        rand = np.where(rng.random(n) < 0.1, -rng.integers(1, 2**62, n),
                        rng.integers(0, 2**40, n)).astype(np.int64)
    elif dt.kind in "iu":
        info = np.iinfo(dt)
        rand = rng.integers(info.min, info.max, n, dtype=dt, endpoint=True)
    else:
        rand = rng.standard_normal(n).astype(dt)
    edges = EDGES[dtype][:n]
    return np.concatenate([edges, rand[edges.size:]]).reshape(shape)


def _varint(v):
    v &= (1 << 64) - 1
    out = bytearray()
    while True:
        b, v = v & 0x7F, v >> 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def _key(number, wire):
    return _varint(number << 3 | wire)


def _repeated(arr):
    """The port's TensorProto of `arr` on the repeated-field wire, as it
    arrives: parsed from its serialized bytes. Floats are packed from their
    own bytes, so a signalling NaN reaches the wire as it is (appending a
    Python float would quiet it first)."""
    if arr.dtype not in (np.float32, np.float64):
        raw = codec.from_ndarray(arr, use_tensor_content=False).SerializeToString()
        return fw.TensorProto.FromString(raw)
    field = "float_val" if arr.dtype == np.float32 else "double_val"
    number = fw.TensorProto.DESCRIPTOR.fields_by_name[field].number
    head = fw.TensorProto(dtype=codec.numpy_to_dtype(arr.dtype),
                          tensor_shape=codec.shape_to_proto(arr.shape)).SerializeToString()
    payload = np.ascontiguousarray(arr, arr.dtype.newbyteorder("<")).tobytes()
    return fw.TensorProto.FromString(head + _key(number, 2) + _varint(len(payload)) + payload)


def _jax_decode(tp):
    return jax_codec.to_ndarray(jax_fw.TensorProto.FromString(tp.SerializeToString()))


def _same_bits(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(np.ascontiguousarray(got).view(np.uint8),
                          np.ascontiguousarray(want).view(np.uint8))


def _delta(before):
    after = codec.decode_counts()
    return {k: after[k] - before[k] for k in after}


@pytest.mark.parametrize("shape", [(1,), (1500, 43), (0, 43)], ids=str)
@pytest.mark.parametrize("dtype", list(EDGES), ids=lambda d: np.dtype(d).name)
def test_the_packed_route_is_the_jax_walk_bit_for_bit(dtype, shape):
    arr = _values(dtype, shape)
    tp = _repeated(arr)
    before = codec.decode_counts()
    got = codec.to_ndarray(tp)
    assert _delta(before) == {"packed": 1, "walked": 0}
    _same_bits(got, _jax_decode(tp))
    assert got.flags.writeable and got.flags.c_contiguous
    if np.dtype(dtype).kind != "f":
        _same_bits(got, arr)


def test_every_edge_value_takes_the_packed_route():
    for dtype, edges in EDGES.items():
        tp = _repeated(edges)
        before = codec.decode_counts()
        _same_bits(codec.to_ndarray(tp), _jax_decode(tp))
        assert _delta(before) == {"packed": 1, "walked": 0}, dtype


def test_the_grpc_java_request_decodes_packed():
    """The two tensors of DCNClient.java's request: 1500 x 43 ids U[0, 2^40)
    and weights."""
    rng = np.random.default_rng(7)
    ids = rng.integers(0, 2**40, (1500, 43), dtype=np.int64)
    wts = rng.random((1500, 43), dtype=np.float32)
    before = codec.decode_counts()
    for arr in (ids, wts):
        got = codec.to_ndarray(_repeated(arr))
        _same_bits(got, arr)
    assert _delta(before) == {"packed": 2, "walked": 0}


@pytest.mark.parametrize("dtype", [np.int8, np.uint8, np.int16, np.uint16, np.bool_,
                                   np.float16, np.complex64, np.complex128],
                         ids=lambda d: np.dtype(d).name)
def test_dtypes_outside_the_route_walk_as_before(dtype):
    arr = np.arange(12).reshape(3, 4).astype(dtype)
    tp = _repeated(arr)
    before = codec.decode_counts()
    _same_bits(codec.to_ndarray(tp), _jax_decode(tp))
    assert _delta(before) == {"packed": 0, "walked": 1}


def test_tensor_content_takes_neither_route():
    tp = codec.from_ndarray(np.arange(6, dtype=np.int64))
    before = codec.decode_counts()
    _same_bits(codec.to_ndarray(tp), np.arange(6, dtype=np.int64))
    assert _delta(before) == {"packed": 0, "walked": 0}


def test_a_scalar_broadcast_takes_the_walk():
    tp = fw.TensorProto(dtype=DT.DT_INT64, tensor_shape=codec.shape_to_proto((4, 3)),
                        int64_val=[-7])
    before = codec.decode_counts()
    got = codec.to_ndarray(tp)
    assert _delta(before) == {"packed": 0, "walked": 1}
    _same_bits(got, np.full((4, 3), -7, np.int64))
    _same_bits(got, _jax_decode(tp))


@pytest.mark.parametrize("field,dt", [("int64_val", DT.DT_INT64), ("float_val", DT.DT_FLOAT),
                                      ("int_val", DT.DT_INT32), ("double_val", DT.DT_DOUBLE)])
def test_a_count_mismatch_keeps_the_walk_s_error(field, dt):
    tp = fw.TensorProto(dtype=dt, tensor_shape=codec.shape_to_proto((2, 3)),
                        **{field: [1, 2, 3, 4, 5]})
    before = codec.decode_counts()
    with pytest.raises(codec.CodecError) as got:
        codec.to_ndarray(tp)
    with pytest.raises(jax_codec.CodecError) as want:
        _jax_decode(tp)
    assert str(got.value) == str(want.value) == f"{field} holds 5 elements, shape (2, 3) needs 6"
    assert _delta(before) == {"packed": 0, "walked": 0}


INT64_VAL = fw.TensorProto.DESCRIPTOR.fields_by_name["int64_val"].number
HEAD = _key(1, 0) + _varint(DT.DT_INT64)  # dtype only: the scan skips it
PACKED_3 = _key(INT64_VAL, 2) + _varint(3) + _varint(1) + _varint(2) + _varint(3)


@pytest.mark.parametrize("msg,n", [
    (HEAD + _key(INT64_VAL, 2) + _varint(2) + bytes([0x81]), 1),  # varint cut short
    (HEAD + _key(INT64_VAL, 0) + bytes([0xFF] * 10 + [0x01]), 1),  # 11-byte varint
    (HEAD + _key(INT64_VAL, 2) + _varint(50) + _varint(1), 1),  # length past the end
    (HEAD + _key(9, 2) + _varint(50) + b"x", 3),  # another field's length past the end
    (HEAD + PACKED_3, 2),  # 3 values for 2: never written past n
    (HEAD + PACKED_3, 4),  # 3 values for 4
    (HEAD + _key(99, 3) + _key(99, 4) + PACKED_3, 3),  # a group
    (HEAD + _key(INT64_VAL, 5) + b"\0\0\0\0", 1),  # int64_val as fixed32
    (HEAD + bytes([0x80]), 0),  # a tag cut short
], ids=["truncated", "11_bytes", "past_end", "skip_past_end", "too_many", "too_few", "group",
        "wrong_wire_type", "truncated_tag"])
def test_the_scan_refuses_bytes_it_cannot_read(msg, n):
    out = np.full(n + 1, 7, np.int64)  # one guard element past n
    got = native._load().dts_repeated_field(msg, len(msg), INT64_VAL, native.SCAN_VARINT64,
                                            out.ctypes.data, n)
    assert got == -1 and out[n] == 7
    assert native.repeated_field(msg, INT64_VAL, native.SCAN_VARINT64, np.int64, n) is None


def test_a_refused_scan_falls_back_to_the_walk(monkeypatch):
    """The bytes protobuf serializes cannot make the scan refuse, so cut
    them short on the way in: the walk answers, counted `walked`."""
    arr = _values(np.int64, (1500, 43))
    tp = _repeated(arr)
    scan = native.repeated_field
    monkeypatch.setattr(native, "repeated_field",
                        lambda msg, *a: scan(msg[:-1], *a))
    before = codec.decode_counts()
    _same_bits(codec.to_ndarray(tp), arr)
    assert _delta(before) == {"packed": 0, "walked": 1}


def test_an_unknown_group_field_falls_back_to_the_walk():
    """protobuf keeps an unknown group and serializes it again; the scan
    reads no groups, so the walk decodes."""
    arr = np.arange(-3, 3, dtype=np.int64).reshape(2, 3)
    raw = codec.from_ndarray(arr, use_tensor_content=False).SerializeToString()
    tp = fw.TensorProto.FromString(raw + _key(99, 3) + _key(1, 0) + _varint(5) + _key(99, 4))
    before = codec.decode_counts()
    _same_bits(codec.to_ndarray(tp), arr)
    assert _delta(before) == {"packed": 0, "walked": 1}


def test_unpacked_and_split_int64_val_decode_equal():
    """int64_val one value at a time (wire type 0), and in two packed runs
    around them: protobuf parses both, and the scan reads both forms."""
    vals = [5, -1, 2**63 - 1, -(2**63), 0, 2**40 - 1]
    dim = _key(1, 0) + _varint(6)  # Dim { size: 6 }
    shape = _key(2, 2) + _varint(len(dim)) + dim  # TensorShapeProto { dim }
    unpacked = b"".join(_key(INT64_VAL, 0) + _varint(v) for v in vals)
    split = (_key(INT64_VAL, 2) + _varint(len(b"".join(map(_varint, vals[:2]))))
             + b"".join(map(_varint, vals[:2]))
             + b"".join(_key(INT64_VAL, 0) + _varint(v) for v in vals[2:4])
             + _key(INT64_VAL, 2) + _varint(len(b"".join(map(_varint, vals[4:]))))
             + b"".join(map(_varint, vals[4:])))
    want = np.array(vals, np.int64)
    for body in (unpacked, split):
        msg = HEAD + _key(2, 2) + _varint(len(shape)) + shape + body
        _same_bits(native.repeated_field(msg, INT64_VAL, native.SCAN_VARINT64, np.int64, 6),
                   want)
        tp = fw.TensorProto.FromString(msg)
        before = codec.decode_counts()
        _same_bits(codec.to_ndarray(tp), want)
        assert _delta(before) == {"packed": 1, "walked": 0}


def test_unpacked_fixed_width_values_scan():
    """float_val and double_val one value at a time (wire types 5 and 1)."""
    for name, kind, dtype, wire in (("float_val", native.SCAN_FIXED32, np.float32, 5),
                                    ("double_val", native.SCAN_FIXED64, np.float64, 1)):
        number = fw.TensorProto.DESCRIPTOR.fields_by_name[name].number
        vals = EDGES[dtype]
        msg = b"".join(_key(number, wire) + v.tobytes() for v in vals)
        want = _jax_decode(_repeated(vals))
        _same_bits(native.repeated_field(msg, number, kind, dtype, vals.size), want)


def test_the_scan_checks_the_dtype_against_the_kind():
    with pytest.raises(ValueError, match="does not write"):
        native.repeated_field(PACKED_3, INT64_VAL, native.SCAN_VARINT64, np.int32, 3)


def test_without_the_native_library_the_walk_gives_the_same_arrays(monkeypatch):
    tps = [_repeated(_values(dtype, (1500, 43))) for dtype in EDGES]
    packed = [codec.to_ndarray(tp) for tp in tps]
    monkeypatch.setattr(native, "available", lambda: False)
    before = codec.decode_counts()
    for tp, want in zip(tps, packed):
        _same_bits(codec.to_ndarray(tp), want)
    assert _delta(before) == {"packed": 0, "walked": len(tps)}


def test_six_threads_decode_the_same_arrays():
    rng = np.random.default_rng(3)
    arrays = [rng.integers(0, 2**40, (1500, 43), dtype=np.int64),
              rng.random((1500, 43), dtype=np.float32)]
    tps = [_repeated(a) for a in arrays]
    rounds = 8
    barrier = threading.Barrier(6, timeout=60)

    def decode(_):
        barrier.wait()
        return [codec.to_ndarray(tps[i % 2]) for i in range(2 * rounds)]

    before = codec.decode_counts()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(6) as pool:
            results = list(pool.map(decode, range(6), timeout=120))
    finally:
        sys.setswitchinterval(interval)
    for got in results:
        for i, arr in enumerate(got):
            _same_bits(arr, arrays[i % 2])
    # No count lost between threads.
    assert _delta(before) == {"packed": 6 * 2 * rounds, "walked": 0}

