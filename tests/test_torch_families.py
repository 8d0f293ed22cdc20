"""The port's other model families (wide_deep, deepfm, generic, two_tower,
dlrm) against the JAX package, on the CPU at small widths.

The same params (carried over with convert.params_from_jax) and the same
numpy inputs go through JAX `model.apply` and the port's `model.apply`, in
f32, bf16 and the xla_int8 form (ops/quantize.py on both sides); then each
family serves its BASELINE.json size through the port's batcher and gRPC
server (scored by the JAX package's client), round-trips through a port
checkpoint, and runs the [kernels] autotune.

Tolerances are the JAX package's parity gates (tests/test_parity.py):
f32 scores rtol 1e-5 / atol 1e-6 with AUC within 1e-6; bf16 max |dscore|
5e-3 with AUC within 1e-3.
"""

import asyncio
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
from distributed_tf_serving_tpu.models import ModelConfig as JaxConfig
from distributed_tf_serving_tpu.models import Servable as JaxServable
from distributed_tf_serving_tpu.models import ServableRegistry as JaxRegistry
from distributed_tf_serving_tpu.models import build_model as jax_build
from distributed_tf_serving_tpu.models import ctr_signatures as jax_signatures
from distributed_tf_serving_tpu.models import model_kinds as jax_model_kinds
from distributed_tf_serving_tpu.models.deepfm import fm_second_order as jax_fm
from distributed_tf_serving_tpu.models.embeddings import sparse_linear as jax_sparse_linear
from distributed_tf_serving_tpu.ops import autotune as jax_autotune
from distributed_tf_serving_tpu.ops import quantize as jq
from distributed_tf_serving_tpu.serving import DynamicBatcher as JaxBatcher
from distributed_tf_serving_tpu.serving import PredictionServiceImpl as JaxImpl
from distributed_tf_serving_tpu.serving import server as jax_server
from distributed_tf_serving_tpu.serving.batcher import fold_ids_host as jax_fold
from distributed_tf_serving_tpu.serving.service import ServiceError as JaxServiceError
from distributed_tf_serving_tpu.train import checkpoint as jax_ckpt
from distributed_tf_serving_tpu.train.data import auc
from distributed_tf_serving_tpu.utils.config import KernelsConfig as JaxKernelsConfig
from distributed_tf_serving_tpu_torch import codec
from distributed_tf_serving_tpu_torch.convert import params_from_jax
from distributed_tf_serving_tpu_torch.models import (
    ModelConfig,
    Servable,
    ServableRegistry,
    build_model,
    ctr_signatures,
    model_kinds,
)
from distributed_tf_serving_tpu_torch.models.deepfm import fm_second_order
from distributed_tf_serving_tpu_torch.models.embeddings import sparse_linear
from distributed_tf_serving_tpu_torch.ops.autotune import (
    BASELINE,
    XLA_INT8,
    KernelManager,
)
from distributed_tf_serving_tpu_torch.ops.quantize import count_quantized, quantize_params
from distributed_tf_serving_tpu_torch.ops.transfer import transfer_spec
from distributed_tf_serving_tpu_torch.proto import PredictionServiceStub
from distributed_tf_serving_tpu_torch.proto import serving_apis_pb2 as apis
from distributed_tf_serving_tpu_torch.serving import batcher as batcher_mod
from distributed_tf_serving_tpu_torch.serving.batcher import DynamicBatcher
from distributed_tf_serving_tpu_torch.serving.server import (
    build_stack,
    create_server,
    load_demo_servable,
)
from distributed_tf_serving_tpu_torch.serving.service import PredictionServiceImpl, ServiceError
from distributed_tf_serving_tpu_torch.train import checkpoint as ckpt
from distributed_tf_serving_tpu_torch.utils.config import KernelsConfig, ServerConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ["wide_deep", "deepfm", "generic", "two_tower", "dlrm"]
# tests/test_baseline_configs.py's small widths; DLRM's bottom MLP ends at
# embed_dim.
F = 8
SMALL = dict(num_fields=F, vocab_size=2048, embed_dim=4, mlp_dims=(16, 8), num_user_fields=3,
             bottom_mlp_dims=(8, 4))
DENSE = 13  # ModelConfig().num_dense_features
# BASELINE.json's candidate counts (generic has no BASELINE point: the
# [client] candidate_num of configs/latency.toml), and the bucket ladder.
BASELINE_N = {"wide_deep": 128, "deepfm": 512, "generic": 1000, "two_tower": 10_000,
              "dlrm": 4096}
LADDER = (128, 512, 1024, 2048, 4096, 16384)
# (dense layers an xla_int8 tree quantizes) at SMALL.
QUANTIZED_LAYERS = {"wide_deep": 3, "deepfm": 3, "generic": 3, "two_tower": 4, "dlrm": 5}
# Leaves that pass through quantization untouched.
PASS_THROUGH = {"wide_deep": ("wide", "wide_bias", "embedding"),
                "deepfm": ("linear", "bias", "embedding"),
                "generic": ("embedding",), "two_tower": ("embedding", "temperature"),
                "dlrm": ("embedding",)}


def _pair(kind, compute_dtype="float32", seed=1, **over):
    kw = {**SMALL, "compute_dtype": compute_dtype, **over}
    jm = jax_build(kind, JaxConfig(**kw))
    tm = build_model(kind, ModelConfig(**kw))
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    return jm, tm, jp, params_from_jax(jp, "cpu")


def _servable(kind, compute_dtype="float32", seed=1, name=None, **over):
    jm, tm, jp, tp = _pair(kind, compute_dtype, seed, **over)
    dense = DENSE if kind == "dlrm" else None
    sv = Servable(name=name or kind.upper(), version=1, model=tm, params=tp,
                  signatures=ctr_signatures(F, with_dense=dense))
    return sv, jm, jp


def _arrays(kind, n, seed=0, dense=True):
    rng = np.random.RandomState(seed)
    out = {"feat_ids": rng.randint(0, 1 << 40, size=(n, F)).astype(np.int64),
           "feat_wts": rng.rand(n, F).astype(np.float32)}
    if kind == "dlrm" and dense:
        out["dense_features"] = rng.randn(n, DENSE).astype(np.float32)
    return out


def _jax_scores(jm, jp, arrays):
    batch = dict(arrays, feat_ids=jax_fold(arrays["feat_ids"], SMALL["vocab_size"]))
    return np.asarray(jm.apply(jp, batch)["prediction_node"], np.float32)


def _port_scores(tm, tp, arrays):
    with torch.inference_mode():
        out = tm.apply(tp, {k: torch.from_numpy(v) for k, v in arrays.items()})
    return out["prediction_node"].float().numpy()


def _labels(scores, seed=0):
    return (np.random.RandomState(seed).rand(len(scores)) < scores).astype(np.float32)


def _assert_parity(got, want, compute_dtype):
    labels = _labels(want)
    d_auc = abs(auc(labels, got) - auc(labels, want))
    if compute_dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        assert d_auc <= 1e-6, d_auc
    else:
        assert np.max(np.abs(got - want)) <= 5e-3
        assert d_auc <= 1e-3, d_auc


def _padded(arrays, bucket):
    return {k: np.concatenate([v, np.zeros((bucket - len(v),) + v.shape[1:], v.dtype)])
            for k, v in arrays.items()}


# ------------------------------------------------------------ the families


def test_model_kinds_equal_the_jax_packages():
    assert model_kinds() == jax_model_kinds()


@pytest.mark.parametrize("kind", FAMILIES)
def test_forward_matches_jax_f32(kind):
    jm, tm, jp, tp = _pair(kind)
    arrays = _arrays(kind, 1024, seed=2)
    got = _port_scores(tm, tp, arrays)
    assert got.shape == (1024,) and np.all(np.isfinite(got))
    _assert_parity(got, _jax_scores(jm, jp, arrays), "float32")


@pytest.mark.parametrize("kind", FAMILIES)
def test_forward_matches_jax_bf16(kind):
    jm, tm, jp, tp = _pair(kind, "bfloat16")
    arrays = _arrays(kind, 1024, seed=3)
    _assert_parity(_port_scores(tm, tp, arrays), _jax_scores(jm, jp, arrays), "bfloat16")


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", FAMILIES)
def test_int8_form_matches_jax_quantize_params(kind, compute_dtype):
    """The xla_int8 tree: the port's quantizer mints JAX's (qw, qscale) bit
    for bit, passes the 1-D tables and 0-d leaves through by reference, and
    the port's apply on it matches JAX's apply on JAX's tree."""
    jm, tm, jp, tp = _pair(kind, compute_dtype)
    tq, jqp = quantize_params(tp), jq.quantize_params(jp)
    assert count_quantized(tq) == jq.count_quantized(jqp) == QUANTIZED_LAYERS[kind]
    for key in PASS_THROUGH[kind]:
        assert tq[key] is tp[key]
    fj = ckpt.flatten_params(jqp)
    ft = ckpt.flatten_params(tq)
    assert list(ft) == list(fj)
    for k, v in ft.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(fj[k]), err_msg=k)
    arrays = _arrays(kind, 1024, seed=4)
    _assert_parity(_port_scores(tm, tq, arrays), _jax_scores(jm, jqp, arrays), compute_dtype)


def test_sparse_linear_keeps_the_raw_f32_weights():
    """The wide / first-order term reads the weights in f32, never rounded
    to the compute dtype: weights with bits below bf16's mantissa give JAX's
    f32 sum, not the sum over their bf16 roundings."""
    rng = np.random.RandomState(5)
    table = rng.randn(97).astype(np.float32)
    ids = rng.randint(-50, 1 << 30, size=(33, 7)).astype(np.int64)
    wts = (1.0 + rng.rand(33, 7) * 2.0 ** -10).astype(np.float32)  # below bf16 resolution
    got = sparse_linear(torch.from_numpy(table), torch.from_numpy(ids), torch.from_numpy(wts))
    assert got.dtype == torch.float32 and got.shape == (33,)
    want = np.asarray(jax_sparse_linear(table, ids, wts))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    bf = torch.from_numpy(wts).to(torch.bfloat16).float()
    rounded = sparse_linear(torch.from_numpy(table), torch.from_numpy(ids), bf)
    assert not torch.equal(got, rounded)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_fm_second_order_matches_jax(compute_dtype):
    """The bag goes to f32 before 0.5 * ((sum e)^2 - sum e^2) over D."""
    emb = np.random.RandomState(6).randn(17, 9, 5).astype(np.float32)
    t = torch.from_numpy(emb).to(getattr(torch, compute_dtype))
    j = jax.numpy.asarray(emb).astype(jax.numpy.dtype(compute_dtype))
    got = fm_second_order(t)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_fm(j)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_generic_without_mlp_puts_the_head_on_x0(compute_dtype):
    jm, tm, jp, tp = _pair("generic", compute_dtype, mlp_dims=())
    assert tp["mlp"] == [] and tuple(tp["out"]["w"].shape) == (F * SMALL["embed_dim"], 1)
    assert ckpt.flatten_params(tm.shapes()).keys() == ckpt.flatten_params(tp).keys()
    arrays = _arrays("generic", 512, seed=7)
    _assert_parity(_port_scores(tm, tp, arrays), _jax_scores(jm, jp, arrays), compute_dtype)


@pytest.mark.parametrize("kind,over,match", [
    ("dlrm", {"bottom_mlp_dims": (8, 6)}, "bottom_mlp_dims"),
    ("two_tower", {"num_user_fields": F}, "num_user_fields"),
    ("two_tower", {"num_user_fields": F + 2}, "num_user_fields"),
])
def test_config_errors_match_jax(kind, over, match):
    kw = {**SMALL, **over}
    with pytest.raises(ValueError, match=match) as theirs:
        jax_build(kind, JaxConfig(**kw))
    with pytest.raises(ValueError, match=match) as ours:
        build_model(kind, ModelConfig(**kw))
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("kind", FAMILIES)
def test_shapes_init_and_jax_tree_agree(kind):
    """shapes() is init's tree on the meta device, and both are the JAX
    package's tree: names, shapes (0-d leaves stay 0-d) and dtypes."""
    jm, tm, jp, tp = _pair(kind)
    want = {k: (tuple(np.shape(v)), str(np.asarray(v).dtype))
            for k, v in ckpt.flatten_params(jp).items()}
    for tree in (tm.shapes(), tm.init(3, "cpu"), tp):
        got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
               for k, v in ckpt.flatten_params(tree).items()}
        assert got == want
    assert all(t.device.type == "meta" for t in ckpt.flatten_params(tm.shapes()).values())
    p1, p2 = tm.init(3, "cpu"), tm.init(3, "cpu")
    for k, v in ckpt.flatten_params(p1).items():
        assert torch.equal(v, ckpt.flatten_params(p2)[k]), k


def test_dlrm_dense_features_are_optional_and_matter():
    jm, tm, jp, tp = _pair("dlrm")
    arrays = _arrays("dlrm", 64, seed=8)
    no_dense = {k: v for k, v in arrays.items() if k != "dense_features"}
    zeros = dict(no_dense, dense_features=np.zeros((64, DENSE), np.float32))
    absent = _port_scores(tm, tp, no_dense)
    np.testing.assert_array_equal(absent, _port_scores(tm, tp, zeros))
    _assert_parity(absent, _jax_scores(jm, jp, no_dense), "float32")
    with_dense = _port_scores(tm, tp, arrays)
    assert np.max(np.abs(with_dense - absent)) > 1e-3
    _assert_parity(with_dense, _jax_scores(jm, jp, arrays), "float32")


# ------------------------------------------------------ serving the families


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", FAMILIES)
def test_baseline_size_through_the_batcher(kind, compute_dtype):
    """Each family at its BASELINE.json size through the port's batcher
    (two_tower's 10 000 candidates in bucket 16384, DLRM's 4096 with
    dense_features), against the JAX golden."""
    sv, jm, jp = _servable(kind, compute_dtype)
    n = BASELINE_N[kind]
    arrays = _arrays(kind, n, seed=9)
    batcher = DynamicBatcher(buckets=LADDER, max_wait_us=0, device="cpu").start()
    try:
        got = batcher.submit(sv, arrays).result(120)
    finally:
        batcher.stop()
    assert set(got) == {"prediction_node", "logits"} and got["prediction_node"].shape == (n,)
    assert batcher.stats.batches == 1
    _assert_parity(got["prediction_node"], _jax_scores(jm, jp, arrays), compute_dtype)


@pytest.fixture(scope="module")
def family_servers():
    """One port gRPC server per family (f32), on the BASELINE ladder."""
    out = {}
    try:
        for kind in FAMILIES:
            sv, jm, jp = _servable(kind, name="DCN")
            registry = ServableRegistry()
            registry.load(sv)
            batcher = DynamicBatcher(buckets=LADDER, max_wait_us=0, device="cpu").start()
            server, port = create_server(PredictionServiceImpl(registry, batcher), "127.0.0.1:0")
            server.start()
            out[kind] = (f"127.0.0.1:{port}", server, batcher, jm, jp)
        yield out
    finally:
        for _, server, batcher, _, _ in out.values():
            server.stop(0)
            batcher.stop()


@pytest.mark.parametrize("kind", FAMILIES)
def test_jax_client_scores_through_the_port_server(family_servers, kind):
    """The JAX package's ShardedPredictClient against the port's server at
    the family's BASELINE size, f32: scores within 1e-5 and AUC within 1e-6
    of JAX model.apply."""
    host, _, _, jm, jp = family_servers[kind]
    arrays = _arrays(kind, BASELINE_N[kind], seed=10)

    async def go():
        async with ShardedPredictClient([host], "DCN") as client:
            return await client.predict(arrays)

    got = asyncio.run(go())
    assert got.shape == (BASELINE_N[kind],)
    _assert_parity(got, _jax_scores(jm, jp, arrays), "float32")


def test_dlrm_metadata_lists_dense_features(family_servers):
    host = family_servers["dlrm"][0]
    with grpc.insecure_channel(host) as ch:
        md = PredictionServiceStub(ch).GetModelMetadata(apis.GetModelMetadataRequest(
            model_spec=apis.ModelSpec(name="DCN"), metadata_field=["signature_def"]))
    sig_map = apis.SignatureDefMap()
    md.metadata["signature_def"].Unpack(sig_map)
    sd = sig_map.signature_def["serving_default"]
    assert set(sd.inputs) == {"feat_ids", "feat_wts", "dense_features"}
    assert [d.size for d in sd.inputs["dense_features"].tensor_shape.dim] == [-1, DENSE]


def _predict_request(arrays, name="DCN"):
    req = apis.PredictRequest()
    req.model_spec.name = name
    for k, v in arrays.items():
        codec.from_ndarray(v, out=req.inputs[k])
    return req


@pytest.mark.parametrize("bad", ["rows", "dtype", "width"])
def test_dlrm_dense_features_validated_like_jax(bad):
    """dense_features must be float32 [n, 13] with the request's n: the
    port's service and the JAX service both answer INVALID_ARGUMENT."""
    sv, jm, jp = _servable("dlrm")
    arrays = _arrays("dlrm", 6, seed=11)
    d = arrays["dense_features"]
    arrays["dense_features"] = {"rows": d[:5], "dtype": d.astype(np.float64),
                                "width": d[:, :7]}[bad].copy()
    registry = ServableRegistry()
    registry.load(sv)
    impl = PredictionServiceImpl(registry, DynamicBatcher(buckets=(8,), device="cpu"))
    with pytest.raises(ServiceError) as ours:
        impl.predict(_predict_request(arrays, sv.name))
    jsv = JaxServable(name=sv.name, version=1, model=jm, params=jp,
                      signatures=jax_signatures(F, with_dense=DENSE))
    jreg = JaxRegistry()
    jreg.load(jsv)
    jimpl = JaxImpl(jreg, JaxBatcher(buckets=(8,)))
    with pytest.raises(JaxServiceError) as theirs:
        jimpl.predict(_predict_request(arrays, sv.name))
    assert ours.value.code == theirs.value.code == "INVALID_ARGUMENT"


def test_dlrm_requests_with_and_without_dense_never_share_a_batch():
    """A queue of [dense, plain, dense] runs as three batches (keys differ),
    each request scored as if alone; two dense requests do coalesce."""
    sv, jm, jp = _servable("dlrm")
    payloads = [_arrays("dlrm", 5, seed=12), _arrays("dlrm", 7, seed=13, dense=False),
                _arrays("dlrm", 6, seed=14)]
    batcher = DynamicBatcher(buckets=(16, 64), max_wait_us=200_000, device="cpu")
    futs = [batcher.submit(sv, p) for p in payloads]  # queued before start
    batcher.start()
    try:
        outs = [f.result(30)["prediction_node"] for f in futs]
        assert batcher.stats.batches == 3 and batcher.stats.requests == 3
        for p, got in zip(payloads, outs):
            _assert_parity(got, _jax_scores(jm, jp, p), "float32")
    finally:
        batcher.stop()
    control = DynamicBatcher(buckets=(16, 64), max_wait_us=200_000, device="cpu")
    futs = [control.submit(sv, payloads[0]), control.submit(sv, payloads[2])]
    control.start()
    try:
        for f in futs:
            f.result(30)
        assert control.stats.batches == 1 and control.stats.requests == 2
    finally:
        control.stop()


def test_warmup_arrays_carry_dense_features():
    sv, _, _ = _servable("dlrm")
    arrays = DynamicBatcher.warmup_arrays(sv, 16)
    assert {k: (v.shape, v.dtype) for k, v in arrays.items()} == {
        "feat_ids": ((16, F), np.int64), "feat_wts": ((16, F), np.float32),
        "dense_features": ((16, DENSE), np.float32)}


@pytest.mark.parametrize("kind", ["wide_deep", "deepfm"])
def test_bf16_feat_wts_wire_refused_like_jax(kind):
    """wide_deep and deepfm read the raw f32 weights, so a bf16 feat_wts
    wire is refused with INVALID_ARGUMENT even in bf16, as the JAX server
    refuses it; a dcn_v2 bf16 model takes the same request."""
    sv, jm, jp = _servable(kind, "bfloat16", name="DCN")
    arrays = _arrays(kind, 5, seed=15)
    req = _predict_request({"feat_ids": arrays["feat_ids"],
                            "feat_wts": arrays["feat_wts"].astype(ml_dtypes.bfloat16)
                            .view(np.uint16)})
    req.inputs["feat_wts"].dtype = 14  # DT_BFLOAT16
    registry = ServableRegistry()
    registry.load(sv)
    impl = PredictionServiceImpl(registry, DynamicBatcher(buckets=(8,), device="cpu"))
    with pytest.raises(ServiceError) as ours:
        impl.predict(req)
    jreg = JaxRegistry()
    jreg.load(JaxServable(name="DCN", version=1, model=jm, params=jp,
                          signatures=jax_signatures(F)))
    with pytest.raises(JaxServiceError) as theirs:
        JaxImpl(jreg, JaxBatcher(buckets=(8,))).predict(req)
    assert ours.value.code == theirs.value.code == "INVALID_ARGUMENT"
    assert "DT_BFLOAT16" in str(ours.value)
    dcn = load_demo_servable(ServableRegistry(), kind="dcn_v2", config=ModelConfig(
        num_fields=F, vocab_size=2048, embed_dim=4, mlp_dims=(8,)), device="cpu")
    registry = ServableRegistry()
    registry.load(dcn)
    batcher = DynamicBatcher(buckets=(8,), max_wait_us=0, device="cpu").start()
    try:
        resp = PredictionServiceImpl(registry, batcher).predict(req)
        assert codec.to_ndarray(resp.outputs["prediction_node"]).shape == (5,)
    finally:
        batcher.stop()


@pytest.mark.parametrize("kind", ["wide_deep", "deepfm"])
def test_f32_weight_families_take_the_numpy_pack(kind, monkeypatch):
    """In bf16, wide_deep and deepfm keep their f32 weights on the way to
    the card: no bf16 layout for feat_wts, no native bf16 pack,
    pack_host_combined for every batch."""
    sv, jm, jp = _servable(kind, "bfloat16")
    assert transfer_spec(sv.model) == {"feat_ids": "u24"}
    calls = []
    real = batcher_mod.pack_host_combined
    monkeypatch.setattr(batcher_mod, "pack_host_combined",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    batcher = DynamicBatcher(buckets=(16, 64), max_wait_us=0, device="cpu").start()
    try:
        assert batcher.step_for(sv).native_pack is False
        arrays = _arrays(kind, 20, seed=16)
        got = batcher.submit(sv, arrays).result(30)["prediction_node"]
    finally:
        batcher.stop()
    assert batcher.stats.native_packs == 0 and len(calls) == batcher.stats.batches == 1
    _assert_parity(got, _jax_scores(jm, jp, arrays), "bfloat16")


def test_two_tower_top_k_head_is_a_stable_sort():
    """two_tower at 10 000 candidates with output_top_k = 100: the head is
    the stable descending sort of the full scores, zeros elsewhere."""
    sv, _, _ = _servable("two_tower")
    arrays = _arrays("two_tower", 10_000, seed=17)
    plain = DynamicBatcher(buckets=LADDER, device="cpu")
    want = plain._execute(sv, _padded(arrays, 16384), None)["prediction_node"][:10_000]
    batcher = DynamicBatcher(buckets=LADDER, max_wait_us=0, device="cpu",
                             output_top_k=100).start()
    try:
        got = batcher.submit(sv, arrays, output_keys=("prediction_node",)).result(120)
    finally:
        batcher.stop()
    got = got["prediction_node"]
    top = np.argsort(-want, kind="stable")[:100]
    np.testing.assert_array_equal(got[top], want[top])
    assert np.all(got[np.setdiff1d(np.arange(10_000), top)] == 0.0)
    assert batcher.stats.topk_batches == 1


# ------------------------------------------------------------- checkpoints


@pytest.mark.parametrize("kind", FAMILIES)
def test_checkpoint_round_trip(tmp_path, kind):
    """save_servable -> load_servable keeps every leaf's bits, shape (0-d
    included) and dtype; the kind comes from the manifest; DLRM's
    signatures take dense_features."""
    sv, _, _ = _servable(kind)
    ckpt.save_servable(tmp_path / "3", sv, kind)
    got = ckpt.load_servable(tmp_path / "3", device="cpu")
    assert got.model.kind == kind and got.model.config == sv.model.config
    want, have = ckpt.flatten_params(sv.params), ckpt.flatten_params(got.params)
    assert set(have) == set(want)
    for k, v in want.items():
        assert have[k].shape == v.shape and have[k].dtype == v.dtype, k
        assert torch.equal(have[k], v), k
    inputs = [s.name for s in got.signature("").inputs]
    assert ("dense_features" in inputs) == (kind == "dlrm")
    arrays = _arrays(kind, 9, seed=18)
    np.testing.assert_array_equal(_port_scores(got.model, got.params, arrays),
                                  _port_scores(sv.model, sv.params, arrays))


@pytest.mark.parametrize("kind", ["deepfm", "two_tower"])
def test_jax_checkpoint_of_a_family_converts_and_scores(tmp_path, kind):
    """A JAX-package checkpoint (Orbax params/) of a non-DCN family gains
    params.safetensors from tools/jax_checkpoint_to_torch.py and scores
    through the port like the JAX servable."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "jax_checkpoint_to_torch", os.path.join(REPO, "tools", "jax_checkpoint_to_torch.py"))
    conv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(conv)
    jm = jax_build(kind, JaxConfig(**SMALL, compute_dtype="float32"))
    jsv = JaxServable(name="FAM", version=2, model=jm, params=jm.init(jax.random.PRNGKey(4)),
                      signatures=jax_signatures(F))
    jax_ckpt.save_servable(tmp_path / "2", jsv, kind)
    conv.convert(tmp_path / "2")
    sv = ckpt.load_servable(tmp_path / "2", device="cpu")
    assert (sv.name, sv.version, sv.model.kind) == ("FAM", 2, kind)
    arrays = _arrays(kind, 256, seed=19)
    _assert_parity(_port_scores(sv.model, sv.params, arrays),
                   _jax_scores(jm, jax.tree.map(np.asarray, jsv.params), arrays), "float32")


# ---------------------------------------------------------------- autotune


@pytest.mark.parametrize("kind", FAMILIES)
def test_autotune_measures_xla_int8_and_records_the_jax_reason(kind):
    """[kernels] on a family: xla_int8 is measured per bucket through
    ops/quantize.py (speedup, max |dscore|, decision), the fused variants
    are recorded ineligible with the JAX package's reason for the same
    servable and batch (DLRM's tune batch carries dense_features), and
    live traffic then serves through the int8 tree."""
    sv, jm, jp = _servable(kind)
    batcher = DynamicBatcher(buckets=(16, 32), max_wait_us=0, device="cpu")
    km = KernelManager(KernelsConfig(enabled=True, table_file="", measure_iters=2,
                                     min_speedup=0.01))
    batcher.kernels = km
    batcher.start()
    try:
        table = km.autotune(batcher, sv)
        jsv = JaxServable(name=sv.name, version=1, model=jm, params=jp,
                          signatures=jax_signatures(F, with_dense=DENSE if kind == "dlrm"
                                                    else None))
        sample = km._tune_arrays(batcher, sv, 16)
        jkm = jax_autotune.KernelManager(JaxKernelsConfig(enabled=True, table_file=""))
        ok, why = jkm._pallas_eligible(jsv, sample)
        assert not ok and table["pallas_eligible"] is False
        assert table["pallas_ineligible_reason"] == why
        want_why = ("inputs beyond feat_ids/feat_wts" if kind == "dlrm"
                    else "param tree is not dcn_v2-shaped")
        assert why == want_why
        for bucket in ("16", "32"):
            row = table["buckets"][bucket]
            assert set(row) == {BASELINE, XLA_INT8, "decision"}
            entry = row[XLA_INT8]
            assert {"step_us", "speedup", "max_abs_delta", "enabled"} <= set(entry)
            # min_speedup sits at the floor: the |dscore| gate decides.
            assert entry["enabled"] == (entry["max_abs_delta"] <= km.config.max_abs_delta)
            assert row["decision"] == (XLA_INT8 if entry["enabled"] else BASELINE)
        arrays = _arrays(kind, 20, seed=20)
        got = batcher.submit(sv, arrays).result(30)["prediction_node"]
        int8 = table["buckets"]["32"]["decision"] == XLA_INT8
        assert km.quantized_batches == int(int8) and km.pallas_batches == 0
        np.testing.assert_allclose(
            got, _port_scores(sv.model, km.params_for(sv, int8), arrays), rtol=1e-6, atol=1e-6)
    finally:
        batcher.stop()


# ---------------------------------------------------------- entry points


def test_load_demo_servable_gives_dlrm_its_dense_signature():
    cfg = ModelConfig(**SMALL)
    ours = load_demo_servable(ServableRegistry(), kind="dlrm", config=cfg, device="cpu")
    theirs = jax_server.load_demo_servable(JaxRegistry(), kind="dlrm",
                                           config=JaxConfig(**SMALL))
    assert set(ours.signatures) == set(theirs.signatures)
    for name, sig in theirs.signatures.items():
        assert [(s.name, s.dtype, s.shape) for s in ours.signatures[name].inputs] == \
            [(s.name, s.dtype, s.shape) for s in sig.inputs], name
    assert ours.signature("").input_specs["dense_features"].shape == (None, DENSE)
    impl, batcher, sv = build_stack(
        ServerConfig(model_kind="dlrm", model_name="DLRM", num_fields=F, buckets=(16,),
                     max_wait_us=0), cfg, "cpu")
    try:
        assert sv.model.kind == "dlrm" and sv.name == "DLRM"
        md = impl.get_model_metadata(apis.GetModelMetadataRequest(
            model_spec=apis.ModelSpec(name="DLRM"), metadata_field=["signature_def"]))
        sig_map = apis.SignatureDefMap()
        md.metadata["signature_def"].Unpack(sig_map)
        assert "dense_features" in sig_map.signature_def["serving_default"].inputs
    finally:
        batcher.stop()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_cli(args, tmp_path, drive):
    """Start the port's CLI server on the CPU with a tiny [model], call
    drive(stub) once it is SERVING, SIGTERM it; returns its log."""
    from distributed_tf_serving_tpu_torch.proto import HealthCheckRequest, HealthStub
    from distributed_tf_serving_tpu_torch.proto import health as health_proto

    port = _free_port()
    cfg = tmp_path / "tiny.toml"
    cfg.write_text(
        f"[server]\nnum_fields = {F}\nbuckets = [16, 64]\nmax_wait_us = 0\n"
        f"[model]\nnum_fields = {F}\nvocab_size = 2048\nembed_dim = 4\nmlp_dims = [16, 8]\n"
        "num_user_fields = 3\nbottom_mlp_dims = [8, 4]\ncompute_dtype = \"float32\"\n")
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_tf_serving_tpu_torch.serving.server",
         "--config", str(cfg), "--host", "127.0.0.1", "--port", str(port), "--device", "cpu",
         *args], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
            grpc.channel_ready_future(ch).result(timeout=60)
            deadline = time.time() + 60
            while HealthStub(ch).Check(HealthCheckRequest(service="")).status != \
                    health_proto.SERVING:
                assert time.time() < deadline
                time.sleep(0.1)
            drive(PredictionServiceStub(ch))
        proc.terminate()
        out, _ = proc.communicate(timeout=30)
        assert proc.returncode == 0, out
        return out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_cli_model_kind_and_model_name_flags(tmp_path):
    """--model-kind / --model-name override [server] model_kind /
    model_name: the demo servable is a deepfm named FM, scored like the
    same seed-0 demo built in this process."""
    arrays = _arrays("deepfm", 5, seed=21)
    seen = {}

    def drive(stub):
        resp = stub.Predict(_predict_request(arrays, "FM"), timeout=30)
        seen["scores"] = codec.to_ndarray(resp.outputs["prediction_node"])
        seen["spec"] = (resp.model_spec.name, resp.model_spec.version.value)

    out = _run_cli(["--model-kind", "deepfm", "--model-name", "FM"], tmp_path, drive)
    assert "serving FM v1 (deepfm)" in out
    sv = load_demo_servable(ServableRegistry(), kind="deepfm", name="FM",
                            config=ModelConfig(**SMALL, compute_dtype="float32", name="FM"),
                            device="cpu")
    assert seen["spec"] == ("FM", 1)
    np.testing.assert_allclose(seen["scores"], _port_scores(sv.model, sv.params, arrays),
                               rtol=1e-6, atol=1e-6)


def test_cli_serves_a_dlrm_checkpoint_with_dense_features(tmp_path):
    """--checkpoint of a port checkpoint of another family: the kind comes
    from the manifest, GetModelMetadata lists dense_features and a Predict
    carrying them is scored like the checkpoint's own forward."""
    sv, _, _ = _servable("dlrm", name="DLRM")
    ckpt.save_servable(tmp_path / "ck", sv, "dlrm")
    arrays = _arrays("dlrm", 7, seed=22)
    seen = {}

    def drive(stub):
        md = stub.GetModelMetadata(apis.GetModelMetadataRequest(
            model_spec=apis.ModelSpec(name="DLRM"), metadata_field=["signature_def"]))
        sig_map = apis.SignatureDefMap()
        md.metadata["signature_def"].Unpack(sig_map)
        seen["inputs"] = set(sig_map.signature_def["serving_default"].inputs)
        resp = stub.Predict(_predict_request(arrays, "DLRM"), timeout=30)
        seen["scores"] = codec.to_ndarray(resp.outputs["prediction_node"])

    out = _run_cli(["--checkpoint", str(tmp_path / "ck")], tmp_path, drive)
    assert "serving DLRM v1 (dlrm)" in out
    assert seen["inputs"] == {"feat_ids", "feat_wts", "dense_features"}
    np.testing.assert_allclose(seen["scores"], _port_scores(sv.model, sv.params, arrays),
                               rtol=1e-6, atol=1e-6)
