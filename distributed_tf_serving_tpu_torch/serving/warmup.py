"""Model-warmup request replay (TF-Serving's assets.extra convention).

`tensorflow_model_server` warms a newly loaded version by replaying the
PredictionLog records in `<version>/assets.extra/tf_serving_warmup_requests`
(a TFRecord file) before the version starts serving — so the first real
request never pays a cold cost, using the PRODUCER'S OWN representative
requests rather than synthetic shapes. The version watcher replays the file
through the real service implementation against the real batcher, before
the version's registry flip.

File format: standard TFRecord framing — per record, a little-endian
uint64 length, the masked CRC32C of those 8 length bytes, the payload,
and the payload's masked CRC32C. CRC32C (Castagnoli) runs in the native
host-ops library (native/hostops.cc), outside the GIL, or table-driven in
pure Python where that library is not built (about 0.2 s a MiB, all of it
holding the GIL against the serving threads). Validating the checksums
catches truncated writers — TF-Serving fails the load on a corrupt warmup
file, and so does this package (WarmupError names the record).

Replay semantics match upstream: every log type replays through its RPC's
code path; the record's model_spec is OVERRIDDEN to target the version
being loaded. A response embedded in the log is ignored — warmup is about
execution, not assertion. Upstream caps the file at 1000 records; same cap
here, same error.
"""

from __future__ import annotations

import pathlib
import struct

from .. import native
from ..models.registry import Servable, ServableRegistry

WARMUP_DIRNAME = "assets.extra"
WARMUP_FILENAME = "tf_serving_warmup_requests"
MAX_WARMUP_RECORDS = 1000  # upstream WarmupConsts::kMaxNumRecords


class WarmupError(RuntimeError):
    """Corrupt/oversized warmup file or a failing warmup request."""


# ------------------------------------------------------------------ crc32c


def _build_crc_table() -> list[int]:
    poly = 0x82F63B78  # Castagnoli, reflected
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return table


# Built at import, fully, before any caller can see it.
_CRC_TABLE: list[int] = _build_crc_table()


def crc32c(data: bytes) -> int:
    if native.available():
        return native.crc32c(data)
    table = _CRC_TABLE
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord's masked CRC (avoids CRC-of-CRC pathologies)."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ----------------------------------------------------------------- tfrecord


def read_tfrecords(path):
    """Yield record payloads, validating framing and checksums."""
    native.ensure()  # the native CRC (a load-time build, never per request)
    raw = pathlib.Path(path).read_bytes()
    off, index = 0, 0
    while off < len(raw):
        if off + 12 > len(raw):
            raise WarmupError(f"{path}: truncated header at record {index}")
        (length,) = struct.unpack_from("<Q", raw, off)
        (len_crc,) = struct.unpack_from("<I", raw, off + 8)
        if masked_crc32c(raw[off:off + 8]) != len_crc:
            raise WarmupError(f"{path}: length checksum mismatch at record {index}")
        off += 12
        if off + length + 4 > len(raw):
            raise WarmupError(f"{path}: truncated payload at record {index}")
        data = raw[off:off + length]
        (data_crc,) = struct.unpack_from("<I", raw, off + length)
        if masked_crc32c(data) != data_crc:
            raise WarmupError(f"{path}: data checksum mismatch at record {index}")
        off += length + 4
        index += 1
        yield data


def frame_tfrecord(data: bytes) -> bytes:
    """One record's full framing as a single bytes object (one write, so a
    crash can truncate at most the final record)."""
    header = struct.pack("<Q", len(data))
    return b"".join((
        header,
        struct.pack("<I", masked_crc32c(header)),
        data,
        struct.pack("<I", masked_crc32c(data)),
    ))


def write_tfrecords(path, payloads) -> None:
    """Write TFRecord framing (producer util for tests and export)."""
    with open(path, "wb") as f:
        for data in payloads:
            f.write(frame_tfrecord(data))


# ------------------------------------------------------------------- replay


def warmup_file_for(version_path) -> pathlib.Path | None:
    p = pathlib.Path(version_path) / WARMUP_DIRNAME / WARMUP_FILENAME
    return p if p.is_file() else None


def replay_warmup_file(path, servable: Servable, batcher) -> int:
    """Replay every PredictionLog in `path` against `servable` through the
    real service implementation + `batcher`. Returns the record count.

    The servable rides a THROWAWAY registry: at replay time the version is
    not yet publicly loaded (warmup precedes the registry flip, so live
    traffic never observes a cold version), and the record's own
    model_spec must not route anywhere else anyway.
    """
    from ..proto import serving_apis_pb2 as apis
    from .service import PredictionServiceImpl, ServiceError

    registry = ServableRegistry()
    registry.load(servable)
    impl = PredictionServiceImpl(registry, batcher)

    count = 0
    for index, payload in enumerate(read_tfrecords(path)):
        if index >= MAX_WARMUP_RECORDS:
            raise WarmupError(
                f"{path}: more than {MAX_WARMUP_RECORDS} warmup records "
                "(upstream cap; trim the file)"
            )
        log = apis.PredictionLog()
        try:
            log.ParseFromString(payload)
        except Exception as e:  # noqa: BLE001 — corrupt record, named index
            raise WarmupError(f"{path}: record {index} is not a PredictionLog: {e}") from e
        kind = log.WhichOneof("log_type")
        if kind is None:
            raise WarmupError(f"{path}: record {index} carries no log_type")
        request = getattr(log, kind).request

        # Target the version being loaded, whatever the producer recorded.
        # (MultiInferenceRequest carries specs per TASK, not at the top.)
        def retarget(spec) -> None:
            spec.name = servable.name
            spec.ClearField("version")
            spec.ClearField("version_label")

        try:
            if kind == "predict_log":
                retarget(request.model_spec)
                impl.predict(request)
            elif kind == "classify_log":
                retarget(request.model_spec)
                impl.classify(request)
            elif kind == "regress_log":
                retarget(request.model_spec)
                impl.regress(request)
            else:  # multi_inference_log
                for task in request.tasks:
                    retarget(task.model_spec)
                impl.multi_inference(request)
        except ServiceError as e:
            raise WarmupError(
                f"{path}: warmup record {index} ({kind}) failed: {e}"
            ) from e
        count += 1
    return count


def make_warmup_record(arrays: dict, model_name: str = "") -> bytes:
    """Serialize one predict-log warmup record (producer util)."""
    from .. import codec
    from ..proto import serving_apis_pb2 as apis

    log = apis.PredictionLog()
    req = log.predict_log.request
    req.model_spec.name = model_name
    for key, arr in arrays.items():
        codec.from_ndarray(arr, use_tensor_content=True, out=req.inputs[key])
    return log.SerializeToString()
