"""The port's model-warmup replay (serving/warmup.py): TFRecord framing and
CRC32C against known vectors and the JAX package's writer, PredictionLog
replay through the port's service and batcher, the failure taxonomy, the
1000-record cap, and the watcher integration — ports of the JAX package's
tests/test_warmup.py."""

import concurrent.futures

import numpy as np
import pytest

from distributed_tf_serving_tpu.serving import warmup as jax_warmup
from distributed_tf_serving_tpu_torch import codec
from distributed_tf_serving_tpu_torch.models import (
    ModelConfig,
    Servable,
    ServableRegistry,
    build_model,
    ctr_signatures,
)
from distributed_tf_serving_tpu_torch.proto import serving_apis_pb2 as apis
from distributed_tf_serving_tpu_torch.serving.batcher import DynamicBatcher
from distributed_tf_serving_tpu_torch.serving.example_codec import make_example
from distributed_tf_serving_tpu_torch.serving.version_watcher import (
    VersionWatcher,
    VersionWatcherConfig,
)
from distributed_tf_serving_tpu_torch.serving.warmup import (
    MAX_WARMUP_RECORDS,
    WARMUP_DIRNAME,
    WARMUP_FILENAME,
    WarmupError,
    crc32c,
    frame_tfrecord,
    make_warmup_record,
    masked_crc32c,
    read_tfrecords,
    replay_warmup_file,
    warmup_file_for,
    write_tfrecords,
)
from distributed_tf_serving_tpu_torch.train.checkpoint import save_servable

F = 6
CFG = ModelConfig(name="DCN", num_fields=F, vocab_size=1 << 12, embed_dim=8,
                  mlp_dims=(16,), num_cross_layers=1, compute_dtype="float32")


def _servable(version=1):
    model = build_model("dcn_v2", CFG)
    return Servable(name="DCN", version=version, model=model, params=model.init(0, "cpu"),
                    signatures=ctr_signatures(F))


def _arrays(n=4, seed=0):
    rng = np.random.RandomState(seed)
    return {
        "feat_ids": rng.randint(0, 1 << 40, size=(n, F)).astype(np.int64),
        "feat_wts": rng.rand(n, F).astype(np.float32),
    }


@pytest.fixture
def batcher():
    b = DynamicBatcher(buckets=(32,), max_wait_us=0, device="cpu").start()
    try:
        yield b
    finally:
        b.stop()


def test_crc32c_known_vectors():
    # RFC 3720 / Castagnoli check value.
    assert crc32c(b"") == 0
    assert crc32c(b"123456789") == 0xE3069283
    assert crc32c(b"\x00" * 32) == 0x8A9136AA  # iSCSI test vector


@pytest.mark.parametrize("data", [b"", b"a", b"123456789", bytes(range(256)) * 3])
def test_crc_and_framing_match_the_jax_package(data):
    assert crc32c(data) == jax_warmup.crc32c(data)
    assert masked_crc32c(data) == jax_warmup.masked_crc32c(data)
    assert frame_tfrecord(data) == jax_warmup.frame_tfrecord(data)


@pytest.mark.parametrize("size", [0, 1, 7, 8, 9, 63, 1000, 65537])
def test_native_crc32c_matches_the_pure_python_table_and_the_jax_package(size, monkeypatch):
    from distributed_tf_serving_tpu_torch import native

    data = np.random.RandomState(size).randint(0, 256, size=size).astype(np.uint8).tobytes()
    assert native.ensure()
    fast = crc32c(data)
    assert fast == native.crc32c(data) == jax_warmup.crc32c(data)
    half = size // 2
    assert native.crc32c(data[half:], native.crc32c(data[:half])) == fast
    monkeypatch.setattr(native, "available", lambda: False)  # the pure-Python table
    assert crc32c(data) == fast


def test_tfrecord_roundtrip_and_corruption(tmp_path):
    p = tmp_path / "records"
    payloads = [b"alpha", b"", b"x" * 1000]
    write_tfrecords(p, payloads)
    assert list(read_tfrecords(p)) == payloads
    assert list(jax_warmup.read_tfrecords(p)) == payloads  # the JAX reader agrees

    raw = bytearray(p.read_bytes())
    raw[14] ^= 0xFF  # flip a payload byte of record 0
    (tmp_path / "bad").write_bytes(bytes(raw))
    with pytest.raises(WarmupError, match="data checksum mismatch at record 0"):
        list(read_tfrecords(tmp_path / "bad"))

    raw = bytearray(p.read_bytes())
    raw[2] ^= 0xFF  # the length field of record 0
    (tmp_path / "badlen").write_bytes(bytes(raw))
    with pytest.raises(WarmupError, match="length checksum mismatch at record 0"):
        list(read_tfrecords(tmp_path / "badlen"))

    (tmp_path / "trunc").write_bytes(p.read_bytes()[:-2])
    with pytest.raises(WarmupError, match="truncated payload at record 2"):
        list(read_tfrecords(tmp_path / "trunc"))
    (tmp_path / "trunc_head").write_bytes(p.read_bytes() + b"\x01\x02")
    with pytest.raises(WarmupError, match="truncated header at record 3"):
        list(read_tfrecords(tmp_path / "trunc_head"))


def test_records_written_by_the_jax_package_read_back(tmp_path):
    p = tmp_path / "jax_written"
    rec = jax_warmup.make_warmup_record(_arrays(3, 1), "DCN")
    jax_warmup.write_tfrecords(p, [rec, b"\x00\x01\x02" * 100])
    assert list(read_tfrecords(p)) == [rec, b"\x00\x01\x02" * 100]
    assert make_warmup_record(_arrays(3, 1), "DCN") == rec


def test_replay_warms_and_counts(tmp_path, batcher):
    sv = _servable()
    # Two predict records (one under a WRONG model name — upstream ignores
    # the recorded spec and targets the loading version) and one classify
    # record.
    classify = apis.PredictionLog()
    req = classify.classify_log.request
    req.model_spec.name = "whatever"
    req.model_spec.version.value = 99
    arrays = _arrays(3, seed=2)
    for i in range(3):
        req.input.example_list.examples.append(
            make_example(arrays["feat_ids"][i], arrays["feat_wts"][i]))
    regress = apis.PredictionLog()
    regress.regress_log.request.model_spec.version_label = "gone"
    regress.regress_log.request.input.example_list.examples.append(
        make_example(arrays["feat_ids"][0]))
    p = tmp_path / WARMUP_FILENAME
    write_tfrecords(p, [
        make_warmup_record(_arrays(4, seed=0), "DCN"),
        make_warmup_record(_arrays(2, seed=1), "SOME_OTHER_NAME"),
        classify.SerializeToString(),
        regress.SerializeToString(),
    ])
    before = batcher.stats.batches
    assert replay_warmup_file(p, sv, batcher) == 4
    assert batcher.stats.batches - before == 4  # every record executed

    # MultiInference records replay too (specs live per TASK there).
    mi = apis.PredictionLog()
    mreq = mi.multi_inference_log.request
    for method in ("classify", "regress"):
        task = mreq.tasks.add()
        task.model_spec.name = "recorded-name"
        task.method_name = f"tensorflow/serving/{method}"
    arrays = _arrays(2, seed=3)
    for i in range(2):
        mreq.input.example_list.examples.append(
            make_example(arrays["feat_ids"][i], arrays["feat_wts"][i]))
    write_tfrecords(p, [mi.SerializeToString()])
    before = batcher.stats.batches
    assert replay_warmup_file(p, sv, batcher) == 1
    assert batcher.stats.batches - before == 2  # one per task


def test_replay_failure_names_record(tmp_path, batcher):
    sv = _servable()
    bad = apis.PredictionLog()
    bad.predict_log.request.model_spec.name = "DCN"
    # Unknown input key -> INVALID_ARGUMENT -> WarmupError at index 1.
    codec.from_ndarray(np.zeros((2, F), np.int64), out=bad.predict_log.request.inputs["nope"])
    p = tmp_path / "w"
    write_tfrecords(p, [make_warmup_record(_arrays(), "DCN"), bad.SerializeToString()])
    with pytest.raises(WarmupError, match="record 1 .*failed"):
        replay_warmup_file(p, sv, batcher)

    write_tfrecords(p, [apis.PredictionLog().SerializeToString()])
    with pytest.raises(WarmupError, match="no log_type"):
        replay_warmup_file(p, sv, batcher)

    write_tfrecords(p, [b"\xff\xff\xff"])
    with pytest.raises(WarmupError, match="record 0 is not a PredictionLog"):
        replay_warmup_file(p, sv, batcher)


class _InstantBatcher:
    """Answers every submit at once: the cap test needs 1000 fast records."""

    def __init__(self):
        self.calls = 0

    def submit(self, servable, arrays, output_keys=None, deadline_s=None):
        self.calls += 1
        n = next(iter(arrays.values())).shape[0]
        fut = concurrent.futures.Future()
        fut.set_result({"prediction_node": np.zeros(n, np.float32),
                        "logits": np.zeros(n, np.float32)})
        return fut


def test_replay_caps_the_file_at_1000_records(tmp_path):
    record = make_warmup_record(_arrays(1), "DCN")
    p = tmp_path / "w"
    write_tfrecords(p, [record] * MAX_WARMUP_RECORDS)
    b = _InstantBatcher()
    assert replay_warmup_file(p, _servable(), b) == MAX_WARMUP_RECORDS
    assert b.calls == MAX_WARMUP_RECORDS
    write_tfrecords(p, [record] * (MAX_WARMUP_RECORDS + 1))
    with pytest.raises(WarmupError, match="more than 1000 warmup records"):
        replay_warmup_file(p, _servable(), _InstantBatcher())


def test_warmup_file_for(tmp_path):
    assert warmup_file_for(tmp_path) is None
    (tmp_path / WARMUP_DIRNAME / WARMUP_FILENAME).mkdir(parents=True)
    assert warmup_file_for(tmp_path) is None  # a directory is not the file
    (tmp_path / WARMUP_DIRNAME / WARMUP_FILENAME).rmdir()
    (tmp_path / WARMUP_DIRNAME / WARMUP_FILENAME).write_bytes(b"")
    assert warmup_file_for(tmp_path) == tmp_path / WARMUP_DIRNAME / WARMUP_FILENAME


def test_watcher_corrupt_warmup_fails_load_bounded(tmp_path):
    """A corrupt warmup file fails the version load: the version never
    flips into the registry, retries are bounded, and the failure is the
    named WarmupError."""
    save_servable(tmp_path / "1", _servable(version=1), kind="dcn_v2")
    extra = tmp_path / "1" / WARMUP_DIRNAME
    extra.mkdir()
    (extra / WARMUP_FILENAME).write_bytes(b"not a tfrecord at all")
    calls, errors = [], []

    def failing_replay(servable, wf):
        calls.append(wf)
        try:
            return replay_warmup_file(wf, servable, None)  # raises before batcher use
        except WarmupError as e:
            errors.append(e)
            raise

    registry = ServableRegistry()
    w = VersionWatcher(
        tmp_path, registry,
        VersionWatcherConfig(poll_interval_s=3600, model_name="DCN", max_load_attempts=2),
        warmup_replay=failing_replay, device="cpu",
    )
    for _ in range(4):
        w.poll_once()
    assert registry.models() == {}  # never flipped
    assert len(calls) == 2  # bounded by max_load_attempts
    assert len(errors) == 2 and all("checksum mismatch at record 0" in str(e) for e in errors)


def test_watcher_replays_warmup_file_through_the_batcher(tmp_path, batcher):
    save_servable(tmp_path / "1", _servable(version=1), kind="dcn_v2")
    extra = tmp_path / "1" / WARMUP_DIRNAME
    extra.mkdir()
    write_tfrecords(extra / WARMUP_FILENAME,
                    [make_warmup_record(_arrays(n, n), "DCN") for n in (7, 20, 32)])
    registry = ServableRegistry()
    order = []
    w = VersionWatcher(
        tmp_path, registry,
        VersionWatcherConfig(poll_interval_s=3600, model_name="DCN"),
        warmup=lambda sv: order.append(("warmup", registry.models())),
        warmup_replay=lambda sv, wf: (order.append(("replay", registry.models())),
                                      replay_warmup_file(wf, sv, batcher))[1],
        device="cpu",
    )
    before = batcher.stats.requests
    w.poll_once()
    assert registry.models() == {"DCN": [1]}
    assert order == [("warmup", {}), ("replay", {})]  # both before the flip
    assert batcher.stats.requests - before == 3
    assert w.load_timings[1]["replay_records"] == 3
    assert w.load_timings[1]["replay_s"] > 0 and "warmup_s" in w.load_timings[1]
