"""The port's serving slice on the CPU: transfer packing and batcher helpers
against the JAX package's, the batcher itself, and the whole gRPC server
driven by the JAX package's client, scores held to JAX `model.apply`."""

import asyncio
import dataclasses
import os
import socket
import subprocess
import sys
import time

import grpc
import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from distributed_tf_serving_tpu.client import ShardedPredictClient
from distributed_tf_serving_tpu.client.client import compact_payload
from distributed_tf_serving_tpu.models import ModelConfig as JaxConfig
from distributed_tf_serving_tpu.models import build_model as jax_build
from distributed_tf_serving_tpu.ops import transfer as jax_transfer
from distributed_tf_serving_tpu.serving.batcher import fold_ids_host as jax_fold
from distributed_tf_serving_tpu.train.data import auc
from distributed_tf_serving_tpu_torch import codec
from distributed_tf_serving_tpu_torch.convert import params_from_jax
from distributed_tf_serving_tpu_torch.models import (
    ModelConfig,
    Servable,
    ServableRegistry,
    build_model,
    ctr_signatures,
)
from distributed_tf_serving_tpu_torch.ops.transfer import (
    pack_host,
    to_device,
    transfer_spec,
    unpack_device,
)
from distributed_tf_serving_tpu_torch.proto import (
    HealthCheckRequest,
    HealthStub,
    ModelServiceStub,
    PredictionServiceStub,
)
from distributed_tf_serving_tpu_torch.proto import health as health_proto
from distributed_tf_serving_tpu_torch.proto import serving_apis_pb2 as apis
from distributed_tf_serving_tpu_torch.serving.batcher import (
    BatchTooLargeError,
    DynamicBatcher,
    QueueOverloadError,
    RequestDeadlineError,
    bucket_for,
    fold_ids_host,
)
from distributed_tf_serving_tpu_torch.serving.server import create_server
from distributed_tf_serving_tpu_torch.serving.service import PredictionServiceImpl
from distributed_tf_serving_tpu_torch.utils.config import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F = 12
KW = dict(num_fields=F, vocab_size=1 << 14, embed_dim=8, mlp_dims=(32, 16), num_cross_layers=3)


def _servable(compute_dtype="float32", seed=0):
    kw = {**KW, "compute_dtype": compute_dtype}
    jm = jax_build("dcn_v2", JaxConfig(**kw))
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    sv = Servable(name="DCN", version=1, model=build_model("dcn_v2", ModelConfig(**kw)),
                  params=params_from_jax(jp, "cpu"), signatures=ctr_signatures(F))
    return sv, jm, jp


def _payload(n, seed):
    rng = np.random.RandomState(seed)
    return {
        "feat_ids": rng.randint(0, 1 << 40, size=(n, F)).astype(np.int64),
        "feat_wts": rng.rand(n, F).astype(np.float32),
    }


def _jax_scores(jm, jp, arrays):
    return np.asarray(jm.apply(jp, {
        "feat_ids": jax_fold(arrays["feat_ids"], KW["vocab_size"]),
        "feat_wts": arrays["feat_wts"],
    })["prediction_node"])


# --------------------------------------------------- transfer + helpers


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_pack_host_bytes_match_jax_and_round_trip(compute_dtype):
    kw = {**KW, "compute_dtype": compute_dtype}
    jm, tm = jax_build("dcn_v2", JaxConfig(**kw)), build_model("dcn_v2", ModelConfig(**kw))
    spec = transfer_spec(tm)
    assert spec == jax_transfer.transfer_spec(jm)
    rng = np.random.RandomState(1)
    arrays = {
        "feat_ids": rng.randint(0, 1 << 24, size=(33, F)).astype(np.int32),
        "feat_wts": np.concatenate([rng.randn(32, F), [[np.inf, -np.inf, 0.0, -0.0,
                                                        1e-40, 3.4e38] * 2]]).astype(np.float32),
    }
    ours = pack_host(arrays, spec)
    theirs = jax_transfer.pack_host(arrays, spec)
    np.testing.assert_array_equal(ours["feat_ids"], theirs["feat_ids"])
    if compute_dtype == "bfloat16":
        assert theirs["feat_wts"].dtype == ml_dtypes.bfloat16
        np.testing.assert_array_equal(ours["feat_wts"], theirs["feat_wts"].view(np.uint16))
    back = unpack_device(to_device(ours, "cpu"), spec)
    np.testing.assert_array_equal(back["feat_ids"].numpy(), arrays["feat_ids"])
    want_wts = torch.from_numpy(arrays["feat_wts"]).to(ModelConfig(**kw).cdtype)
    assert back["feat_wts"].dtype == want_wts.dtype
    assert torch.equal(back["feat_wts"].view(torch.int16) if compute_dtype == "bfloat16"
                       else back["feat_wts"],
                       want_wts.view(torch.int16) if compute_dtype == "bfloat16" else want_wts)


def test_fold_ids_host_matches_jax():
    rng = np.random.RandomState(2)
    ids = np.concatenate([
        rng.randint(0, 1 << 40, size=(64, F)),
        -rng.randint(1, 1 << 40, size=(8, F)),
    ]).astype(np.int64)
    for vocab in (1 << 14, 1 << 20, 1000003):
        got = fold_ids_host(ids, vocab)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, jax_fold(ids, vocab))


def test_bucket_for():
    assert bucket_for(1, (8, 16)) == 8
    assert bucket_for(9, (8, 16)) == 16
    with pytest.raises(BatchTooLargeError):
        bucket_for(17, (8, 16))


# ---------------------------------------------------------------- batcher


def test_batcher_coalesces_and_slices_per_request():
    sv, jm, jp = _servable()
    batcher = DynamicBatcher(buckets=(16, 64), max_wait_us=200_000, device="cpu")
    payloads = [_payload(n, seed=n) for n in (5, 20, 7)]
    futs = [batcher.submit(sv, p) for p in payloads]  # queued before start
    batcher.start()
    try:
        outs = [f.result(30) for f in futs]
    finally:
        batcher.stop()
    assert batcher.stats.batches == 1 and batcher.stats.requests == 3
    assert batcher.stats.padded_candidates == 64
    for p, o in zip(payloads, outs):
        assert set(o) == {"prediction_node", "logits"}
        np.testing.assert_allclose(o["prediction_node"], _jax_scores(jm, jp, p),
                                   rtol=1e-5, atol=1e-5)


def test_batcher_output_keys_and_warmup():
    sv, _, _ = _servable("bfloat16")
    batcher = DynamicBatcher(buckets=(8, 16), max_wait_us=0, device="cpu")
    batcher.warmup(sv)
    batcher.start()
    try:
        out = batcher.submit(sv, _payload(3, 4), output_keys=("prediction_node",)).result(30)
    finally:
        batcher.stop()
    assert set(out) == {"prediction_node"} and out["prediction_node"].shape == (3,)
    assert batcher.stats.fused_batches == 0  # the CPU runs model.apply


def test_batcher_refuses_overload_oversize_and_sheds_expired():
    sv, _, _ = _servable()
    batcher = DynamicBatcher(buckets=(8,), max_wait_us=0, device="cpu",
                             queue_capacity_candidates=8)
    with pytest.raises(BatchTooLargeError):
        batcher.submit(sv, _payload(9, 0))
    expired = batcher.submit(sv, _payload(5, 0), deadline_s=0.0)
    with pytest.raises(QueueOverloadError):
        batcher.submit(sv, _payload(5, 1))
    batcher.start()
    try:
        with pytest.raises(RequestDeadlineError):
            expired.result(30)
    finally:
        batcher.stop()
    assert batcher.stats.deadline_sheds == 1


# ------------------------------------------------------- the whole slice


@pytest.fixture
def served():
    """The port's gRPC server on the CPU, 127.0.0.1:0, with a small dcn_v2
    servable whose params are carried over from JAX."""
    sv, jm, jp = _servable("float32")
    registry = ServableRegistry()
    registry.load(sv)
    batcher = DynamicBatcher(buckets=(16, 64), max_wait_us=0, device="cpu")
    batcher.warmup(sv)
    batcher.start()
    impl = PredictionServiceImpl(registry, batcher)
    server, port = create_server(impl, "127.0.0.1:0")
    server.start()
    try:
        yield f"127.0.0.1:{port}", jm, jp
    finally:
        server.stop(0)
        batcher.stop()


def test_jax_client_scores_through_port_server(served):
    host, jm, jp = served
    payloads = [_payload(n, seed=10 + n) for n in (7, 33, 50)]

    async def go():
        async with ShardedPredictClient([host], "DCN") as client:
            return [await client.predict(p) for p in payloads]

    outs = asyncio.run(go())
    got = np.concatenate(outs)
    want = np.concatenate([_jax_scores(jm, jp, p) for p in payloads])
    assert [len(o) for o in outs] == [7, 33, 50]
    assert np.max(np.abs(got - want)) < 1e-5
    labels = (np.random.RandomState(0).rand(len(want)) < want).astype(np.float32)
    assert abs(auc(labels, got) - auc(labels, want)) < 1e-6


def _req(arrays, name="DCN", content=True):
    req = apis.PredictRequest()
    req.model_spec.name = name
    for k, v in arrays.items():
        codec.from_ndarray(v, use_tensor_content=content, out=req.inputs[k])
    return req


def test_wire_metadata_status_health_and_errors(served):
    host, jm, jp = served
    with grpc.insecure_channel(host) as ch:
        stub = PredictionServiceStub(ch)
        md = stub.GetModelMetadata(apis.GetModelMetadataRequest(
            model_spec=apis.ModelSpec(name="DCN"), metadata_field=["signature_def"]))
        sig_map = apis.SignatureDefMap()
        md.metadata["signature_def"].Unpack(sig_map)
        sd = sig_map.signature_def["serving_default"]
        assert set(sd.inputs) == {"feat_ids", "feat_wts"}
        assert [d.size for d in sd.inputs["feat_ids"].tensor_shape.dim] == [-1, F]
        assert md.model_spec.version.value == 1

        st = ModelServiceStub(ch).GetModelStatus(
            apis.GetModelStatusRequest(model_spec=apis.ModelSpec(name="DCN")))
        assert [(s.version, s.state) for s in st.model_version_status] == [
            (1, apis.ModelVersionStatus.AVAILABLE)]
        assert HealthStub(ch).Check(HealthCheckRequest(service="")).status == health_proto.SERVING

        with pytest.raises(grpc.RpcError) as e:
            stub.Predict(_req(_payload(3, 0), name="nope"))
        assert e.value.code() == grpc.StatusCode.NOT_FOUND
        bad = _payload(3, 0)
        bad["feat_wts"] = bad["feat_wts"][:, :5].copy()
        with pytest.raises(grpc.RpcError) as e:
            stub.Predict(_req(bad))
        assert e.value.code() == grpc.StatusCode.INVALID_ARGUMENT
        with pytest.raises(grpc.RpcError) as e:
            stub.Predict(_req(_payload(65, 0)))
        assert e.value.code() == grpc.StatusCode.RESOURCE_EXHAUSTED

        # Repeated-field request (the grpc-java encoding): mirrored reply.
        p = _payload(4, 5)
        resp = stub.Predict(_req(p, content=False))
        assert len(resp.outputs["prediction_node"].float_val) == 4
        np.testing.assert_allclose(codec.to_ndarray(resp.outputs["prediction_node"]),
                                   _jax_scores(jm, jp, p), rtol=1e-5, atol=1e-5)


def test_compact_wire_bf16_is_bit_identical_to_wide():
    """A JAX-client compact payload (int32 folded ids, bf16 weights) scores
    bit-identically to the wide encoding on a bf16 model; bf16 weights are
    refused for an f32 model, as the JAX service refuses them."""
    from distributed_tf_serving_tpu_torch.serving.service import ServiceError

    for compute_dtype in ("bfloat16", "float32"):
        sv, _, _ = _servable(compute_dtype)
        registry = ServableRegistry()
        registry.load(sv)
        batcher = DynamicBatcher(buckets=(16,), max_wait_us=0, device="cpu").start()
        impl = PredictionServiceImpl(registry, batcher)
        try:
            wide = _payload(9, 3)
            compact = compact_payload(wide, KW["vocab_size"])
            creq = _req({"feat_ids": compact["feat_ids"],
                         "feat_wts": compact["feat_wts"].view(np.uint16)})
            creq.inputs["feat_wts"].dtype = 14  # DT_BFLOAT16
            if compute_dtype == "float32":
                with pytest.raises(ServiceError) as e:
                    impl.predict(creq)
                assert e.value.code == "INVALID_ARGUMENT"
                continue
            a = codec.to_ndarray(impl.predict(_req(wide)).outputs["prediction_node"])
            b = codec.to_ndarray(impl.predict(creq).outputs["prediction_node"])
            np.testing.assert_array_equal(a, b)
        finally:
            batcher.stop()


def test_config_reads_server_and_model_sections(tmp_path):
    loaded = load_config(os.path.join(REPO, "configs", "latency.toml"))
    assert loaded["server"].buckets == (256, 512, 1024, 2048)
    assert loaded["server"].max_wait_us == 200 and loaded["server"].model_kind == "dcn_v2"
    m = loaded["model"]
    assert (m.num_fields, m.embed_dim, m.mlp_dims, m.num_cross_layers, m.vocab_size,
            m.compute_dtype) == (43, 16, (256, 128, 64), 3, 1 << 20, "bfloat16")
    bad = tmp_path / "bad.toml"
    bad.write_text("[model]\nnot_a_knob = 1\n")
    with pytest.raises(ValueError, match="not_a_knob"):
        load_config(bad)


def test_cli_serves_on_cpu_and_stops_on_sigterm(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cfg = tmp_path / "tiny.toml"
    cfg.write_text(
        "[server]\nmodel_kind = \"dcn_v2\"\nnum_fields = 6\nbuckets = [8, 32]\n"
        "max_wait_us = 0\n[model]\nnum_fields = 6\nvocab_size = 4096\nembed_dim = 4\n"
        "mlp_dims = [16]\nnum_cross_layers = 2\ncompute_dtype = \"float32\"\n"
        f"[kernels]\nenabled = true\ntable_file = \"{tmp_path / 'table.json'}\"\n"
        "[mesh]\ndevices = 4\n"
    )
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_tf_serving_tpu_torch.serving.server",
         "--config", str(cfg), "--host", "127.0.0.1", "--port", str(port), "--device", "cpu"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
            grpc.channel_ready_future(ch).result(timeout=60)
            deadline = time.time() + 60
            while HealthStub(ch).Check(HealthCheckRequest(service="")).status != health_proto.SERVING:
                assert time.time() < deadline
                time.sleep(0.1)
            rng = np.random.RandomState(0)
            resp = PredictionServiceStub(ch).Predict(_req({
                "feat_ids": rng.randint(0, 1 << 40, size=(5, 6)).astype(np.int64),
                "feat_wts": rng.rand(5, 6).astype(np.float32),
            }), timeout=30)
            scores = codec.to_ndarray(resp.outputs["prediction_node"])
            assert scores.shape == (5,) and np.all((scores > 0) & (scores < 1))
        proc.terminate()
        out, _ = proc.communicate(timeout=30)
        assert proc.returncode == 0, out
        assert "ignoring config sections" in out and "shutdown complete" in out
        assert "['mesh']" in out and "kernel autotune DCN v1: {8: " in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_servable_registry_labels_and_versions():
    sv1, _, _ = _servable()
    sv2 = dataclasses.replace(sv1, version=2)
    reg = ServableRegistry()
    reg.load(sv1)
    reg.load(sv2)
    assert reg.resolve("DCN") is sv2
    reg.set_label("DCN", "stable", 1)
    assert reg.resolve("DCN", label="stable") is sv1
    reg.unload("DCN", 1)
    assert reg.labels("DCN") == {}
    assert reg.models() == {"DCN": [2]}
