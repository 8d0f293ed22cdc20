"""The TF-Serving Predict wire, written by hand: the benchmark's own copy.

Encodes a `tensorflow.serving.PredictRequest` as the reference's grpc-java
client sends it (DCNClient.java: `int64_val` ids and `float_val` weights,
proto3 packed repeated fields), and decodes a `PredictResponse`. Field numbers
are those of `tensorflow_serving/apis/predict.proto`, `model.proto` and
`tensorflow/core/framework/tensor.proto` / `tensor_shape.proto`. Nothing here
imports the program or a generated module, so a load-generator process
registers no protobuf descriptors of its own.
"""

from __future__ import annotations

import numpy as np

PREDICT_METHOD = "/tensorflow.serving.PredictionService/Predict"

DT_FLOAT = 1
DT_INT64 = 9

_DTYPES = {DT_FLOAT: np.dtype("<f4"), DT_INT64: np.dtype("<i8")}


def _varint(value: int) -> bytes:
    out = bytearray()
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def varints(values: np.ndarray) -> bytes:
    """Base-128 varints of non-negative int64 values, canonical (shortest)
    form, concatenated: numpy over 7-bit columns, no Python loop over the
    elements."""
    v = np.ascontiguousarray(values, dtype=np.int64).reshape(-1).view(np.uint64)
    if v.size == 0:
        return b""
    cols = []
    rest = v
    nbytes = np.ones(v.shape, np.uint8)
    while True:
        cols.append((rest & np.uint64(0x7F)).astype(np.uint8))
        rest = rest >> np.uint64(7)
        more = rest != 0
        if not more.any():
            break
        cols[-1] |= more.view(np.uint8) << 7  # the continuation bit
        nbytes += more
    grid = np.stack(cols, axis=1)
    if int(nbytes.min()) == len(cols):
        return grid.tobytes()
    keep = np.arange(len(cols), dtype=np.uint8)[None, :] < nbytes[:, None]
    return grid[keep].tobytes()


def _field(number: int, payload: bytes) -> bytes:
    """A length-delimited field (wire type 2)."""
    return _varint(number << 3 | 2) + _varint(len(payload)) + payload


def _tensor(arr: np.ndarray) -> bytes:
    dims = b"".join(_field(2, _varint(1 << 3) + _varint(int(d))) for d in arr.shape)
    integer = arr.dtype.kind == "i"
    head = _varint(1 << 3) + _varint(DT_INT64 if integer else DT_FLOAT)
    head += _field(2, dims)
    if integer:
        if arr.size and int(arr.min()) < 0:
            raise ValueError("the wire copy encodes non-negative ids only")
        return head + _field(10, varints(arr))
    return head + _field(5, np.ascontiguousarray(arr, dtype="<f4").tobytes())


def encode_predict(model_name: str, inputs: dict[str, np.ndarray],
                   output_filter: tuple[str, ...] = ()) -> bytes:
    """A serialized PredictRequest, inputs in sorted key order: int64 inputs
    as packed `int64_val` and float inputs as packed `float_val` (the
    reference's grpc-java client)."""
    spec = _field(1, model_name.encode())
    body = _field(1, spec)
    for key in sorted(inputs):
        entry = _field(1, key.encode()) + _field(2, _tensor(np.asarray(inputs[key])))
        body += _field(2, entry)
    for key in output_filter:
        body += _field(3, key.encode())
    return body


def _read_varint(buf: memoryview, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        byte = buf[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return result, pos
        shift += 7


def _fields(buf: memoryview):
    """(field number, wire type, value) of each field of one message; a
    length-delimited value is a memoryview, a varint an int."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        number, wtype = key >> 3, key & 7
        if wtype == 0:
            value, pos = _read_varint(buf, pos)
        elif wtype == 2:
            n, pos = _read_varint(buf, pos)
            value = buf[pos:pos + n]
            pos += n
        elif wtype == 5:
            value = buf[pos:pos + 4]
            pos += 4
        elif wtype == 1:
            value = buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        yield number, wtype, value


def _decode_tensor(buf: memoryview) -> np.ndarray:
    dtype = None
    shape: list[int] = []
    content = None
    floats: list = []
    for number, wtype, value in _fields(buf):
        if number == 1:
            dtype = value
        elif number == 2:
            for dn, _, dim in _fields(value):
                if dn == 2:
                    size = 0
                    for sn, _, sv in _fields(dim):
                        if sn == 1:
                            size = sv
                    shape.append(size)
        elif number == 4:
            content = bytes(value)
        elif number == 5:
            floats.append(bytes(value))  # packed (wire type 2) or one fixed32
    if dtype not in _DTYPES:
        raise ValueError(f"unsupported response dtype {dtype}")
    if content is not None:
        arr = np.frombuffer(content, dtype=_DTYPES[dtype])
    elif dtype == DT_FLOAT:
        arr = np.frombuffer(b"".join(floats), dtype="<f4")
    else:
        raise ValueError("int64 response tensors are not read by the benchmark")
    return arr.reshape(shape) if shape else arr


def decode_predict_response(data: bytes) -> dict[str, np.ndarray]:
    """The outputs map of a serialized PredictResponse."""
    out = {}
    for number, _, value in _fields(memoryview(data)):
        if number != 1:
            continue
        key = tensor = None
        for en, _, ev in _fields(value):
            if en == 1:
                key = bytes(ev).decode()
            elif en == 2:
                tensor = ev
        if key is not None and tensor is not None:
            out[key] = _decode_tensor(tensor)
    return out
