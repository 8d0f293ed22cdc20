"""The port's response path on the CPU, held to the JAX package: the
readback wire (float32 / bf16 / f16 / int8 downcast on the device, widened
back on the host), top-k output compaction, the int8 score response wire
over gRPC, `Model.score_output`, and the new [server] / [transport] /
[kernels] keys. Mirrors tests/test_output_compaction.py case by case where
the feature is ported.

Tolerances: the float32 wire is bit-identical to no wire; the bf16 / f16 /
int8 wires are bit-identical to the JAX package's compact + restore pair on
the same float32 scores (int8 against the jitted quantize_output_device,
which XLA compiles with a multiplication by 1/254); top-k indices equal
jax.lax.top_k's, ties included; the int8 response wire is bit-identical to
the JAX codec's and within range/508 of the float response."""

import asyncio
import dataclasses
import os
import time
from concurrent.futures import Future

import grpc
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from distributed_tf_serving_tpu import codec as jax_codec
from distributed_tf_serving_tpu.client import ShardedPredictClient
from distributed_tf_serving_tpu.models import ModelConfig as JaxConfig
from distributed_tf_serving_tpu.models import build_model as jax_build
from distributed_tf_serving_tpu.ops import transfer as jt
from distributed_tf_serving_tpu.proto import serving_apis_pb2 as jax_apis
from distributed_tf_serving_tpu.serving.batcher import fold_ids_host as jax_fold
from distributed_tf_serving_tpu.utils.config import load_config as jax_load_config
from distributed_tf_serving_tpu_torch import codec
from distributed_tf_serving_tpu_torch.convert import params_from_jax
from distributed_tf_serving_tpu_torch.models import (
    ModelConfig,
    Servable,
    ServableRegistry,
    build_model,
    ctr_signatures,
)
from distributed_tf_serving_tpu_torch.ops import transfer as pt
from distributed_tf_serving_tpu_torch.ops.autotune import KernelManager
from distributed_tf_serving_tpu_torch.proto import PredictionServiceStub
from distributed_tf_serving_tpu_torch.proto import serving_apis_pb2 as apis
from distributed_tf_serving_tpu_torch.proto import tf_framework_pb2 as fw
from distributed_tf_serving_tpu_torch.serving import batcher as batcher_mod
from distributed_tf_serving_tpu_torch.serving.batcher import DynamicBatcher, _WorkItem
from distributed_tf_serving_tpu_torch.serving.server import build_stack, create_server
from distributed_tf_serving_tpu_torch.serving.service import PredictionServiceImpl
from distributed_tf_serving_tpu_torch.utils.config import (
    BatchingConfig,
    KernelsConfig,
    ServerConfig,
    TransportConfig,
    load_config,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F = 8
KW = dict(num_fields=F, vocab_size=1009, embed_dim=4, mlp_dims=(16,), num_cross_layers=1,
          compute_dtype="float32")
WAIT = 30
JAX_WIRE = {"float32": None, "bfloat16": np.dtype(ml_dtypes.bfloat16),
            "float16": np.dtype(np.float16), "int8": np.dtype(np.int8)}


@pytest.fixture(scope="module")
def pair():
    jm = jax_build("dcn_v2", JaxConfig(**KW))
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    sv = Servable(name="DCN", version=1, model=build_model("dcn_v2", ModelConfig(**KW)),
                  params=params_from_jax(jp, "cpu"), signatures=ctr_signatures(F))
    return sv, jm, jp


def make_arrays(n, seed=0):
    rng = np.random.RandomState(seed)
    return {
        "feat_ids": rng.randint(0, 1 << 40, size=(n, F)).astype(np.int64),
        "feat_wts": rng.rand(n, F).astype(np.float32),
    }


def golden(jm, jp, arrays):
    return np.asarray(jm.apply(jp, {"feat_ids": jax_fold(arrays["feat_ids"], KW["vocab_size"]),
                                    "feat_wts": arrays["feat_wts"]})["prediction_node"])


def _batcher(**kw):
    return DynamicBatcher(**{"buckets": (32, 64), "max_wait_us": 0, "device": "cpu", **kw})


def _padded(arrays, bucket):
    return {k: np.concatenate([v, np.zeros((bucket - len(v),) + v.shape[1:], v.dtype)])
            for k, v in arrays.items()}


def _score_vectors():
    """Score vectors the wire must carry: sigmoid-like, logits, a constant
    (the 1e-8 scale), a bucket with zero padding rows, one element, ties."""
    rng = np.random.RandomState(7)
    live = rng.rand(37).astype(np.float32) * 0.9 + 0.05
    return {
        "sigmoid": rng.rand(256).astype(np.float32),
        "logits": (rng.randn(512) * 4).astype(np.float32),
        "constant": np.full(64, 0.3125, np.float32),
        "padded": np.concatenate([live, np.zeros(64 - 37, np.float32)]),
        "single": np.array([0.75], np.float32),
        "ties": np.round(rng.rand(128), 1).astype(np.float32),
        # A range whose true division by 254 is one ulp off its product
        # with float32(1 / 254): only the latter matches the jitted JAX.
        "reciprocal": np.random.RandomState(16).rand(100).astype(np.float32),
    }


VECTORS = _score_vectors()


# ------------------------------------------------------------ the wire pair


def test_wire_names_and_constants_match_jax():
    assert pt.Q8_LEVELS == jt.Q8_LEVELS
    assert (pt.Q8_SCALE_SUFFIX, pt.Q8_MIN_SUFFIX) == (jt.Q8_SCALE_SUFFIX, jt.Q8_MIN_SUFFIX)
    assert sorted(pt._WIRE_DTYPES) == sorted(jt._WIRE_DTYPES)
    for key in ("p", "p::q8scale", "p::q8min", "p/q8_scale"):
        assert pt.is_wire_sidecar(key) == jt.is_wire_sidecar(key)
    with pytest.raises(ValueError, match="wire dtype") as ours:
        pt.output_wire_dtype("float8")
    with pytest.raises(ValueError) as theirs:
        jt.output_wire_dtype("float8")
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="wire dtype"):
        DynamicBatcher(buckets=(32,), device="cpu", output_wire_dtype="float8")


@pytest.mark.parametrize("name", sorted(VECTORS))
@pytest.mark.parametrize("wire", ["float32", "bfloat16", "float16"])
def test_float_wires_restore_bit_identical_to_jax(wire, name):
    v = VECTORS[name]
    outs = {"prediction_node": v, "logits": v * 3, "ids": np.arange(len(v), dtype=np.int32)}
    ours = pt.restore_outputs_host(pt.compact_outputs_device(
        {k: torch.from_numpy(a) for k, a in outs.items()}, pt.output_wire_dtype(wire)))
    theirs = jt.restore_outputs_host({k: np.asarray(a) for k, a in jt.compact_outputs_device(
        {k: jnp.asarray(a) for k, a in outs.items()}, JAX_WIRE[wire]).items()})
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype
        np.testing.assert_array_equal(ours[k], theirs[k])
    if wire == "float32":
        np.testing.assert_array_equal(ours["prediction_node"], v)


@pytest.mark.parametrize("name", sorted(VECTORS))
def test_int8_wire_bit_identical_to_jitted_jax(name):
    v = VECTORS[name]
    q, scale, mn = pt.quantize_output_device(torch.from_numpy(v))
    jq, jscale, jmn = (np.asarray(a) for a in jax.jit(jt.quantize_output_device)(v))
    np.testing.assert_array_equal(q.numpy(), jq)
    assert scale.numpy().tobytes() == jscale.tobytes()
    assert mn.numpy().tobytes() == jmn.tobytes()
    if name == "reciprocal":
        spread = np.float32(v.max() - v.min())
        assert np.float32(spread / np.float32(254)) != jscale[0]
    if name == "constant":
        assert float(scale[0]) == np.float32(1e-8)
        np.testing.assert_array_equal(pt.restore_outputs_host(
            pt.compact_outputs_device({"p": torch.from_numpy(v)}, torch.int8))["p"], v)
    # The full pair: the sidecars ride along and are consumed by restore.
    wire = pt.compact_outputs_device({"p": torch.from_numpy(v)}, torch.int8)
    assert sorted(wire) == ["p", "p::q8min", "p::q8scale"]
    ours = pt.restore_outputs_host(wire)
    jwire = jax.jit(lambda o: jt.compact_outputs_device(o, np.dtype(np.int8)))({"p": v})
    theirs = jt.restore_outputs_host({k: np.asarray(a) for k, a in jwire.items()})
    assert list(ours) == ["p"] and ours["p"].dtype == np.float32
    np.testing.assert_array_equal(ours["p"], theirs["p"])
    rng = float(v.max() - v.min())
    assert np.max(np.abs(ours["p"] - v)) <= rng / 508 * 1.001 + 1e-6


def test_int8_without_sidecars_is_a_genuine_int8_output():
    q = np.arange(-5, 5, dtype=np.int8)
    out = pt.restore_outputs_host({"q": torch.from_numpy(q)})
    assert out["q"].dtype == np.int8
    np.testing.assert_array_equal(out["q"], q)


# ----------------------------------------------------------------- top-k


TIE_CASES = [
    (np.array([.5, .7, .7, .1, .7, .5], np.float32), 6, 4),
    (np.array([.5, .7, .7, .1, .7, .5], np.float32), 5, 3),
    (np.full(16, 0.25, np.float32), 16, 5),
    (np.full(16, 0.25, np.float32), 9, 8),
    (VECTORS["ties"], 128, 17),
    (VECTORS["ties"], 100, 64),
    (VECTORS["padded"], 37, 10),
    (VECTORS["sigmoid"], 200, 100),
]


@pytest.mark.parametrize("wire", ["float32", "bfloat16", "float16", "int8"])
@pytest.mark.parametrize("case", range(len(TIE_CASES)))
def test_topk_matches_jax_top_k_on_ties(case, wire):
    scores, n_valid, k = TIE_CASES[case]
    ours = pt.topk_compact_device(torch.from_numpy(scores), n_valid, k, pt.output_wire_dtype(wire))
    theirs = jt.topk_compact_device(jnp.asarray(scores), n_valid, k, JAX_WIRE[wire])
    masked = np.where(np.arange(len(scores)) < n_valid, scores, -np.inf)
    np.testing.assert_array_equal(ours["topk_indices"].numpy(),
                                  np.asarray(jax.lax.top_k(masked, k)[1]))
    np.testing.assert_array_equal(ours["topk_indices"].numpy(),
                                  np.asarray(theirs["topk_indices"]))
    assert ours["topk_indices"].dtype == torch.int32
    got = pt.topk_restore_host(ours["topk_scores"], ours["topk_indices"], n_valid, "p")["p"]
    want = jt.topk_restore_host(np.asarray(theirs["topk_scores"]),
                                np.asarray(theirs["topk_indices"]), n_valid, "p")["p"]
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if wire == "int8":  # the top-k values of the int8 wire travel as bf16
        assert ours["topk_scores"].dtype == torch.bfloat16


# ------------------------------------------------------------ the batcher


def test_f32_wire_is_exact(pair):
    sv, _, _ = pair
    arrays = make_arrays(19, seed=3)
    plain, wired = _batcher().start(), _batcher(output_wire_dtype="float32").start()
    try:
        a = plain.submit(sv, arrays).result(WAIT)
        b = wired.submit(sv, arrays).result(WAIT)
        assert sorted(a) == sorted(b) == ["logits", "prediction_node"]
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    finally:
        plain.stop()
        wired.stop()


@pytest.mark.parametrize("wire", ["bfloat16", "float16", "int8"])
@pytest.mark.parametrize("n", [7, 32, 50])
def test_wire_batcher_matches_the_jax_pair_on_its_f32_output(pair, wire, n):
    """A wired batcher's scores are the JAX pair's restore of the f32
    batcher's padded output (int8 quantizes the whole padded bucket, zero
    rows included), and within the wire's rounding of JAX model.apply."""
    sv, jm, jp = pair
    arrays = make_arrays(n, seed=40 + n)
    bucket = 32 if n <= 32 else 64
    plain, wired = _batcher(), _batcher(output_wire_dtype=wire).start()
    try:
        full = plain._execute(sv, _padded(arrays, bucket), None)
        got = wired.submit(sv, arrays).result(WAIT)
        assert sorted(got) == ["logits", "prediction_node"]  # no sidecar reaches a result
        jwire = jax.jit(lambda o: jt.compact_outputs_device(o, JAX_WIRE[wire]))(full)
        want = jt.restore_outputs_host({k: np.asarray(v) for k, v in jwire.items()})
        for k in got:
            assert got[k].dtype == np.float32 and got[k].shape == (n,)
            np.testing.assert_array_equal(got[k], want[k][:n])
        ref = golden(jm, jp, arrays)
        tol = {"bfloat16": 1e-2, "float16": 1e-3}.get(wire)
        if tol:
            np.testing.assert_allclose(got["prediction_node"], ref, rtol=tol)
        else:
            spread = float(full["prediction_node"].max() - full["prediction_node"].min())
            assert np.max(np.abs(got["prediction_node"] - ref)) <= spread / 508 * 1.001 + 1e-6
    finally:
        wired.stop()


def test_bf16_wire_byte_reduction(pair):
    """Score-only bf16 readback: 2 B per padded row against the f32
    baseline of both outputs, 8 B per row (mirrors the JAX test)."""
    sv, jm, jp = pair
    batcher = _batcher(buckets=(32,), output_wire_dtype="bfloat16").start()
    try:
        arrays = make_arrays(32)
        got = batcher.submit(sv, arrays, output_keys=("prediction_node",)).result(WAIT)
        assert got["prediction_node"].dtype == np.float32
        np.testing.assert_allclose(got["prediction_node"], golden(jm, jp, arrays), rtol=1e-2)
        st = batcher.stats
        assert st.bytes_download_full_f32 == 32 * 2 * 4
        assert st.bytes_downloaded == 32 * 2
    finally:
        batcher.stop()


@pytest.mark.parametrize("wire,per_row", [("float32", 4), ("int8", 1)])
def test_output_selection_bytes(pair, wire, per_row):
    """A score-only fetch reads back the one output; the baseline charges
    both. The int8 wire adds its two 4-byte sidecars."""
    sv, _, _ = pair
    batcher = _batcher(buckets=(32,), output_wire_dtype=wire).start()
    try:
        batcher.submit(sv, make_arrays(32), output_keys=("prediction_node",)).result(WAIT)
        sidecars = 8 if wire == "int8" else 0
        assert batcher.stats.bytes_downloaded == 32 * per_row + sidecars
        assert batcher.stats.bytes_download_full_f32 == 32 * 8
    finally:
        batcher.stop()


@pytest.mark.parametrize("wire", ["float32", "bfloat16", "int8"])
def test_topk_compaction_exact_head(pair, wire):
    """A score-only single request returns its exact top-k at their own
    indices (the wire's rounding of them for bf16 / int8), zeros elsewhere,
    and reads back the k pairs, not the score vector."""
    sv, _, _ = pair
    k = 4
    arrays = make_arrays(48, seed=9)
    plain = _batcher()
    batcher = _batcher(buckets=(64,), output_top_k=k, output_wire_dtype=wire).start()
    try:
        got = batcher.submit(sv, arrays, output_keys=("prediction_node",)).result(WAIT)
        want = plain._execute(sv, _padded(arrays, 64), None)["prediction_node"][:48]
        assert sorted(got) == ["prediction_node"] and got["prediction_node"].shape == (48,)
        got = got["prediction_node"]
        top = np.argsort(-want, kind="stable")[:k]
        head = want[top]
        if wire != "float32":  # int8 sends the k values as bf16
            head = torch.from_numpy(head).to(torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(got[top], head)
        assert np.all(got[np.setdiff1d(np.arange(48), top)] == 0.0)
        assert batcher.stats.topk_batches == 1
        value_bytes = 4 if wire == "float32" else 2
        assert batcher.stats.bytes_downloaded == k * value_bytes + k * 4
    finally:
        batcher.stop()


def test_topk_skips_coalesced_groups(pair):
    """Top-k over a coalesced group would mix requests' candidates: a
    two-request group reads back full vectors and each request gets its own
    slice. The group is assembled by hand, so coalescing is deterministic."""
    sv, jm, jp = pair
    batcher = _batcher(buckets=(64,), output_top_k=4)
    try:
        arrays = [make_arrays(8, seed=20 + s) for s in range(2)]
        group = [_WorkItem(servable=sv, arrays=a, n=8, output_keys=("prediction_node",),
                           future=Future(), enqueue_t=time.perf_counter()) for a in arrays]
        staged = batcher._assemble(group, 16)
        assert staged.topk == 0
        batcher._run_stage(staged)
        for it, a in zip(group, arrays):
            got = it.future.result(WAIT)["prediction_node"]
            np.testing.assert_allclose(got, golden(jm, jp, a), rtol=1e-5)
            assert np.all(got > 0)  # full vector: no zeroed tail
        assert batcher.stats.topk_batches == 0 and batcher.stats.batches == 1
    finally:
        batcher.stop()


@pytest.mark.parametrize("case", ["unfiltered", "logits_too", "k_not_below_n"])
def test_topk_skips_requests_that_are_not_score_only(pair, case):
    sv, jm, jp = pair
    k = 10 if case == "k_not_below_n" else 4
    n = 10 if case == "k_not_below_n" else 20
    keys = {"unfiltered": None, "logits_too": ("prediction_node", "logits"),
            "k_not_below_n": ("prediction_node",)}[case]
    batcher = _batcher(output_top_k=k).start()
    try:
        arrays = make_arrays(n, seed=31)
        got = batcher.submit(sv, arrays, output_keys=keys).result(WAIT)["prediction_node"]
        np.testing.assert_allclose(got, golden(jm, jp, arrays), rtol=1e-5)
        assert batcher.stats.topk_batches == 0
    finally:
        batcher.stop()


def test_a_failing_wire_transform_fails_only_its_batch(pair, monkeypatch):
    sv, jm, jp = pair
    batcher = _batcher(output_wire_dtype="bfloat16").start()
    real = batcher_mod.compact_outputs_device
    calls = []

    def flaky(out, wire_dt):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("wire transform failed")
        return real(out, wire_dt)

    monkeypatch.setattr(batcher_mod, "compact_outputs_device", flaky)
    try:
        with pytest.raises(RuntimeError, match="wire transform failed"):
            batcher.submit(sv, make_arrays(5, seed=1)).result(WAIT)
        arrays = make_arrays(6, seed=2)
        got = batcher.submit(sv, arrays).result(WAIT)["prediction_node"]
        np.testing.assert_allclose(got, golden(jm, jp, arrays), rtol=1e-2)
    finally:
        batcher.stop()


def test_warmup_and_autotune_through_a_wired_batcher(pair):
    """The warmup runs every bucket through the wire, and the autotune's
    |dscore| gate compares restored float32 scores."""
    sv, _, _ = pair
    batcher = _batcher(output_wire_dtype="int8")
    batcher.warmup(sv)
    batcher.start()
    try:
        arrays = _padded(make_arrays(20, seed=4), 32)
        scores = KernelManager._scores_of(batcher, sv, arrays, (False, False))
        assert scores.dtype == np.float32 and scores.shape == (32,)
        plain = _batcher()._execute(sv, arrays, None)["prediction_node"]
        spread = float(plain.max() - plain.min())
        assert np.max(np.abs(scores - plain)) <= spread / 508 * 1.001 + 1e-6
        km = KernelManager(KernelsConfig(enabled=True, table_file="", measure_iters=1,
                                         min_speedup=0.01))
        batcher.kernels = km
        table = km.autotune(batcher, sv)
        assert all("error" not in row for row in table["buckets"].values())
    finally:
        batcher.stop()


# ------------------------------------------------------ Model.score_output


def test_score_output_default_matches_jax():
    assert build_model("dcn_v2", ModelConfig(**KW)).score_output == \
        jax_build("dcn_v2", JaxConfig(**KW)).score_output == "prediction_node"


def _example_request(kind, arrays):
    from distributed_tf_serving_tpu_torch.serving.example_codec import make_example

    req = (apis.ClassificationRequest if kind == "classify" else apis.RegressionRequest)()
    req.model_spec.name = "DCN"
    for ids, wts in zip(arrays["feat_ids"], arrays["feat_wts"]):
        req.input.example_list.examples.append(make_example(ids, wts))
    return req


@pytest.mark.parametrize("renamed", [False, True])
def test_classify_and_regress_read_the_score_output(pair, renamed):
    """Classify / Regress answer as before (the scores of Predict), and
    read the model's score_output: a model whose score tensor has another
    name is classified by it."""
    sv, _, _ = pair
    model = sv.model
    if renamed:
        apply = model.apply
        model = dataclasses.replace(
            model, score_output="ctr",
            apply=lambda p, b: {"ctr": apply(p, b)["prediction_node"]})
    served = dataclasses.replace(sv, model=model)
    registry = ServableRegistry()
    registry.load(served)
    batcher = _batcher().start()
    impl = PredictionServiceImpl(registry, batcher)
    try:
        arrays = make_arrays(9, seed=12)
        want = _batcher()._execute(sv, _padded(arrays, 32), None)["prediction_node"][:9]
        cls = impl.classify(_example_request("classify", arrays))
        reg = impl.regress(_example_request("regress", arrays))
        p1 = np.array([c.classes[1].score for c in cls.result.classifications], np.float32)
        p0 = np.array([c.classes[0].score for c in cls.result.classifications], np.float32)
        np.testing.assert_array_equal(p1, want)
        np.testing.assert_array_equal(p0, (1.0 - want.astype(np.float64)).astype(np.float32))
        np.testing.assert_array_equal(
            np.array([r.value for r in reg.result.regressions], np.float32), want)
    finally:
        batcher.stop()


# ----------------------------------------------------- int8 response wire


def test_response_wire_constants_match_jax():
    assert codec.Q8_WIRE_LEVELS == jax_codec.Q8_WIRE_LEVELS
    assert codec.Q8_WIRE_SCALE_SUFFIX == jax_codec.Q8_WIRE_SCALE_SUFFIX
    assert codec.Q8_WIRE_MIN_SUFFIX == jax_codec.Q8_WIRE_MIN_SUFFIX


@pytest.mark.parametrize("name", sorted(VECTORS))
def test_quantize_scores_bit_identical_to_jax_codec(name):
    v = VECTORS[name]
    q, scale, mn = codec.quantize_scores(v)
    jq, jscale, jmn = jax_codec.quantize_scores(v)
    np.testing.assert_array_equal(q, jq)
    assert (scale, mn) == (jscale, jmn)
    back = codec.dequantize_scores(q, scale, mn)
    np.testing.assert_array_equal(back, jax_codec.dequantize_scores(jq, jscale, jmn))
    assert np.max(np.abs(back - v)) <= float(v.max() - v.min()) / 508 * 1.001 + 1e-6


@pytest.mark.parametrize("content", [True, False])
def test_dequantize_response_output_bit_identical_to_jax_codec(content):
    v = VECTORS["sigmoid"]
    q, scale, mn = codec.quantize_scores(v)
    resp = apis.PredictResponse()
    codec.from_ndarray(q, use_tensor_content=content, out=resp.outputs["p"])
    codec.from_ndarray(np.asarray([scale], np.float32), use_tensor_content=content,
                       out=resp.outputs["p/q8_scale"])
    codec.from_ndarray(np.asarray([mn], np.float32), use_tensor_content=content,
                       out=resp.outputs["p/q8_min"])
    codec.from_ndarray(v, use_tensor_content=content, out=resp.outputs["plain"])
    assert resp.outputs["p"].dtype == fw.DataType.DT_INT8
    theirs = jax_apis.PredictResponse.FromString(resp.SerializeToString())
    for key in ("p", "plain"):
        np.testing.assert_array_equal(codec.dequantize_response_output(resp.outputs, key),
                                      jax_codec.dequantize_response_output(theirs.outputs, key))
    np.testing.assert_array_equal(codec.dequantize_response_output(resp.outputs, "plain"), v)


def _wire_stack(tmp_path, int8_score_wire: bool, enabled: bool = True):
    cfg = ServerConfig(num_fields=F, buckets=(16, 64), max_wait_us=0)
    kcfg = KernelsConfig(enabled=enabled, autotune=False, int8_score_wire=int8_score_wire,
                         table_file=str(tmp_path / "table.json"))
    impl, batcher, _ = build_stack(cfg, ModelConfig(**KW), "cpu", kernels_config=kcfg)
    server, port = create_server(impl, "127.0.0.1:0")
    server.start()
    return impl, batcher, server, port


def _predict_raw(port, arrays, metadata=None):
    req = apis.PredictRequest()
    req.model_spec.name = "DCN"
    for k, v in arrays.items():
        codec.from_ndarray(v, out=req.inputs[k])
    req.output_filter.append("prediction_node")
    with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
        return PredictionServiceStub(ch).Predict(req, timeout=WAIT, metadata=metadata)


def test_int8_response_wire_over_grpc_with_the_reference_client(tmp_path):
    """A server with [kernels] enabled and int8_score_wire: the reference
    client with score_wire_int8 receives DT_INT8 plus both sidecars, and
    its decoded scores are within range/508 of the float response; without
    the metadata the same server answers float32."""
    impl, batcher, server, port = _wire_stack(tmp_path, True)
    try:
        assert impl.int8_score_wire
        arrays = make_arrays(50, seed=5)
        resp = _predict_raw(port, arrays, (("x-dts-score-wire", "int8"),))
        assert resp.outputs["prediction_node"].dtype == fw.DataType.DT_INT8
        assert sorted(resp.outputs) == ["prediction_node", "prediction_node/q8_min",
                                        "prediction_node/q8_scale"]
        plain = _predict_raw(port, arrays)
        assert sorted(plain.outputs) == ["prediction_node"]
        assert plain.outputs["prediction_node"].dtype == fw.DataType.DT_FLOAT
        want = codec.to_ndarray(plain.outputs["prediction_node"])
        q, scale, mn = codec.quantize_scores(want)
        np.testing.assert_array_equal(codec.to_ndarray(resp.outputs["prediction_node"]), q)

        async def go(int8):
            async with ShardedPredictClient([f"127.0.0.1:{port}"], "DCN",
                                            score_wire_int8=int8) as client:
                got = await client.predict(arrays)
                return got, client.counters.int8_responses

        got, n_int8 = asyncio.run(go(True))
        assert n_int8 == 1
        spread = float(want.max() - want.min())
        assert np.max(np.abs(got - want)) <= spread / 508 * 1.001 + 1e-7
        got_plain, n_plain = asyncio.run(go(False))
        assert n_plain == 0
        np.testing.assert_array_equal(got_plain, want)
    finally:
        server.stop(0)
        batcher.stop()


@pytest.mark.parametrize("enabled", [True, False])
def test_server_without_the_wire_answers_float32(tmp_path, enabled):
    """int8_score_wire off (or the plane disabled): the metadata is
    ignored and the score answers as DT_FLOAT."""
    impl, batcher, server, port = _wire_stack(tmp_path, not enabled, enabled=enabled)
    try:
        assert not impl.int8_score_wire
        resp = _predict_raw(port, make_arrays(7, seed=6), (("x-dts-score-wire", "int8"),))
        assert sorted(resp.outputs) == ["prediction_node"]
        assert resp.outputs["prediction_node"].dtype == fw.DataType.DT_FLOAT
    finally:
        server.stop(0)
        batcher.stop()


def test_arming_one_server_leaves_the_next_unarmed(tmp_path):
    """The gate is state of each server, not of the process."""
    armed = _wire_stack(tmp_path, True)
    plain = _wire_stack(tmp_path, False)
    try:
        assert armed[0].int8_score_wire and not plain[0].int8_score_wire
        resp = _predict_raw(plain[3], make_arrays(7, seed=8), (("x-dts-score-wire", "int8"),))
        assert resp.outputs["prediction_node"].dtype == fw.DataType.DT_FLOAT
    finally:
        for _, b, s, _ in (armed, plain):
            s.stop(0)
            b.stop()


def test_wired_server_serves_the_reference_client(tmp_path, pair):
    """build_stack honours [server] output_wire_dtype / output_top_k: a
    bf16 readback wire and top-k behind the gRPC server, scored by the
    reference client."""
    _, jm, jp = pair
    cfg = ServerConfig(num_fields=F, buckets=(16, 64), max_wait_us=0,
                       output_wire_dtype="bfloat16", output_top_k=5)
    impl, batcher, sv = build_stack(cfg, ModelConfig(**KW), "cpu")
    server, port = create_server(impl, "127.0.0.1:0")
    server.start()
    try:
        assert batcher.output_wire_dtype == "bfloat16" and batcher.output_top_k == 5
        arrays = make_arrays(40, seed=13)

        async def go():
            async with ShardedPredictClient([f"127.0.0.1:{port}"], "DCN") as client:
                return await client.predict(arrays)

        got = asyncio.run(go())
        want = torch.from_numpy(batcher._execute(sv, _padded(arrays, 64), None)[
            "prediction_node"][:40]).to(torch.bfloat16).float().numpy()
        top = np.argsort(-want, kind="stable")[:5]
        np.testing.assert_array_equal(got[top], want[top])
        assert np.count_nonzero(got) == 5 and batcher.stats.topk_batches >= 1
    finally:
        server.stop(0)
        batcher.stop()


# ------------------------------------------------------------------ config


def _toml(tmp_path, text):
    p = tmp_path / "c.toml"
    p.write_text(text)
    return p


def test_new_keys_parse_like_jax(tmp_path):
    path = _toml(tmp_path, (
        "[server]\noutput_wire_dtype = \"int8\"\noutput_top_k = 100\n"
        "[batching]\nstream_chunk_candidates = 256\n"
        "[transport]\nuds_path = \"/tmp/dts.sock\"\n"
        "[kernels]\nenabled = true\nint8_score_wire = true\n"))
    ours, theirs = load_config(path), jax_load_config(path)
    for key in ("output_wire_dtype", "output_top_k"):
        assert getattr(ours["server"], key) == getattr(theirs["server"], key)
    assert ours["batching"].stream_chunk_candidates == \
        theirs["batching"].stream_chunk_candidates == 256
    assert ours["transport"].uds_path == theirs["transport"].uds_path == "/tmp/dts.sock"
    assert ours["kernels"].int8_score_wire and theirs["kernels"].int8_score_wire


def test_new_keys_default_like_jax():
    from distributed_tf_serving_tpu.utils.config import BatchingConfig as JB
    from distributed_tf_serving_tpu.utils.config import ServerConfig as JS
    from distributed_tf_serving_tpu.utils.config import TransportConfig as JT

    assert (ServerConfig().output_wire_dtype, ServerConfig().output_top_k) == \
        (JS().output_wire_dtype, JS().output_top_k)
    assert BatchingConfig().stream_chunk_candidates == JB().stream_chunk_candidates == 0
    assert TransportConfig().uds_path == JT().uds_path == ""


@pytest.mark.parametrize("text,match", [
    ("[server]\noutput_wire_dtype = \"float8\"\n", "unknown output wire dtype"),
    ("[server]\noutput_top_k = -1\n", "output_top_k"),
    ("[batching]\nstream_chunk_candidates = -1\n", "non-negative"),
    ("[transport]\nuds_path = \"localhost:9999\"\n", "host:port"),
    ("[transport]\nuds_path = \"/" + "x" * 200 + "\"\n", "AF_UNIX"),
    ("[transport]\nnot_a_knob = 1\n", "not_a_knob"),
])
def test_bad_values_are_refused(tmp_path, text, match):
    with pytest.raises(ValueError, match=match):
        load_config(_toml(tmp_path, text))


@pytest.mark.parametrize("text", ["[transport]\nresponse_arena = true\n"])
def test_response_arena_loads_like_jax(tmp_path, text):
    path = _toml(tmp_path, text)
    assert load_config(path)["transport"].response_arena is \
        jax_load_config(path)["transport"].response_arena is True


@pytest.mark.parametrize("text", [
    "[batching]\nstream_chunk_candidates = -1\n",
    "[transport]\nuds_path = \"localhost:9999\"\n",
    "[transport]\nuds_path = \"/" + "x" * 200 + "\"\n",
])
def test_refusals_carry_the_jax_message(tmp_path, text):
    path = _toml(tmp_path, text)
    with pytest.raises(ValueError) as ours:
        load_config(path)
    with pytest.raises(ValueError) as theirs:
        jax_load_config(path)
    assert str(ours.value) == str(theirs.value)


def test_repo_configs_still_load_unchanged():
    for name in ("latency.toml", "throughput.toml"):
        path = os.path.join(REPO, "configs", name)
        ours, theirs = load_config(path), jax_load_config(path)
        assert ours["server"].output_wire_dtype == theirs["server"].output_wire_dtype
        assert ours["server"].output_top_k == theirs["server"].output_top_k
        assert ours["batching"].stream_chunk_candidates == \
            theirs["batching"].stream_chunk_candidates
        assert ours["transport"] == TransportConfig()
        assert ours["server"].model_kind == "dcn_v2"
