"""The port's int8 weight quantization against the JAX package's, on the
same numpy-seeded weights: the quantizer bit for bit, the quantized
model.apply, the int8 fused serve step's plain version against the JAX
Pallas kernel in interpret mode, and the tree checks around them.

Tolerances: quantizer bit-identical; int8 model.apply 1e-5 (f32) and 1e-3
on scores plus 1e-3 on AUC (bf16); int8 fused serve 2e-5 (f32, as
tests/test_quantize.py) and 1e-3 (bf16, as the float kernel's bf16 test).
"""

import jax
import numpy as np
import pytest
import torch

from distributed_tf_serving_tpu.models import ModelConfig as JaxConfig
from distributed_tf_serving_tpu.models import build_model as jax_build
from distributed_tf_serving_tpu.ops import autotune as jax_autotune
from distributed_tf_serving_tpu.ops import cross_kernel as jck
from distributed_tf_serving_tpu.ops import quantize as jq
from distributed_tf_serving_tpu.serving.batcher import fold_ids_host as jax_fold
from distributed_tf_serving_tpu.train.data import auc as jax_auc
from distributed_tf_serving_tpu_torch.convert import params_from_jax
from distributed_tf_serving_tpu_torch.models import ModelConfig, build_model
from distributed_tf_serving_tpu_torch.ops import autotune, quantize
from distributed_tf_serving_tpu_torch.ops import cross_kernel as ck
from distributed_tf_serving_tpu_torch.train.data import auc

KW = dict(num_fields=10, vocab_size=1 << 12, embed_dim=8, mlp_dims=(32, 16),
          num_cross_layers=2)


def _pair(compute_dtype="float32", kind="dcn_v2", seed=0):
    kw = {**KW, "compute_dtype": compute_dtype}
    jcfg, tcfg = JaxConfig(**kw), ModelConfig(**kw)
    jm = jax_build(kind, jcfg)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    return jm, jcfg, jp, build_model(kind, tcfg), tcfg, params_from_jax(jp)


def _batch(n, seed):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 1 << 40, size=(n, KW["num_fields"])).astype(np.int64)
    wts = rng.rand(n, KW["num_fields"]).astype(np.float32)
    return jax_fold(ids, KW["vocab_size"]), wts


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def _assert_trees_equal(torch_tree, numpy_tree):
    ours, theirs = dict(_leaves(torch_tree)), dict(_leaves(numpy_tree))
    assert ours.keys() == theirs.keys()
    for path, t in ours.items():
        want = np.asarray(theirs[path])
        got = t.numpy()
        assert got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)


# ------------------------------------------------------------- quantizer


@pytest.mark.parametrize("kind", ["dcn_v2", "dcn"])
def test_quantize_params_bit_identical_to_jax(kind):
    """Port quantize_params of the carried-over float tree == JAX
    quantize_params of the JAX tree, leaf for leaf; and the JAX-quantized
    tree carried over equals it too (params_from_jax keeps int8)."""
    _, _, jp, _, _, tp = _pair(kind=kind)
    ours = quantize.quantize_params(tp)
    theirs = jq.quantize_params(jp)
    _assert_trees_equal(ours, theirs)
    carried = params_from_jax(theirs)
    _assert_trees_equal(carried, theirs)
    assert carried["out"]["qw"].dtype == torch.int8
    # Dense layers only: v2 cross (2) + mlp (2) + out (1); v1 vectors stay.
    assert quantize.count_quantized(ours) == jq.count_quantized(theirs) == (
        5 if kind == "dcn_v2" else 3)
    assert quantize.quantized_param_bytes(ours) == jq.quantized_param_bytes(theirs)
    assert ours["embedding"] is tp["embedding"]  # passed through by reference
    assert "w" in tp["cross"][0]  # the float tree is untouched


def test_channelwise_matches_jax_including_ties_and_zero_channels():
    rng = np.random.RandomState(0)
    w = (rng.randn(64, 24) * rng.rand(24)[None, :] * 3).astype(np.float32)
    w[:, 3] = 0.0                       # all-zero channel: scale 1.0
    w[:5, 7] = [127.0, 0.5, -0.5, 1.5, -2.5]  # exact halves: round half to even
    for axis in (-1, 0):
        q, s = quantize.quantize_channelwise(torch.from_numpy(w), axis=axis)
        jqw, js = jq.quantize_channelwise(w, axis=axis)
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), jqw)
        np.testing.assert_array_equal(s.numpy(), js)
        np.testing.assert_array_equal(quantize.dequantize_channelwise(q, s, axis).numpy(),
                                      jq.dequantize_channelwise(jqw, js, axis))
    assert int(q.abs().max()) <= quantize.Q8_MAX
    assert quantize.is_quantized_dense({"qw": q}) and not quantize.is_quantized_dense({"w": q})


def test_quantized_tree_keeps_device_and_bias_reference():
    _, _, _, _, _, tp = _pair()
    qp = quantize.quantize_params(tp)
    assert qp["mlp"][0]["b"] is tp["mlp"][0]["b"]
    assert qp["cross"][1]["qw"].device == tp["cross"][1]["w"].device
    assert qp["cross"][1]["qscale"].shape == (KW["num_fields"] * KW["embed_dim"],)


# ------------------------------------------------------------- model.apply


def test_int8_model_apply_matches_jax_f32():
    jm, _, jp, tm, _, tp = _pair("float32")
    ids, wts = _batch(64, seed=1)
    want = np.asarray(jm.apply(jq.quantize_params(jp),
                               {"feat_ids": ids, "feat_wts": wts})["prediction_node"])
    got = tm.apply(quantize.quantize_params(tp),
                   {"feat_ids": torch.from_numpy(ids),
                    "feat_wts": torch.from_numpy(wts)})["prediction_node"].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # It genuinely quantized: within the 0.01 budget of the float scores, not equal.
    f32 = tm.apply(tp, {"feat_ids": torch.from_numpy(ids),
                        "feat_wts": torch.from_numpy(wts)})["prediction_node"].numpy()
    assert np.max(np.abs(got - f32)) < 0.01 and not np.array_equal(got, f32)


def test_int8_model_apply_matches_jax_bf16_scores_and_auc():
    jm, _, jp, tm, _, tp = _pair("bfloat16")
    ids, wts = _batch(512, seed=2)
    want = np.asarray(jm.apply(jq.quantize_params(jp),
                               {"feat_ids": ids, "feat_wts": wts})["prediction_node"],
                      np.float32)
    got = tm.apply(quantize.quantize_params(tp),
                   {"feat_ids": torch.from_numpy(ids),
                    "feat_wts": torch.from_numpy(wts)})["prediction_node"].float().numpy()
    assert np.max(np.abs(got - want)) <= 1e-3
    labels = (np.random.RandomState(3).rand(len(want)) < want).astype(np.float32)
    assert abs(auc(labels, got) - auc(labels, want)) <= 1e-3


def test_auc_copy_matches_jax():
    rng = np.random.RandomState(4)
    labels = (rng.rand(300) < 0.4).astype(np.float32)
    scores = np.round(rng.rand(300), 2)  # ties
    assert auc(labels, scores) == jax_auc(labels, scores)
    with pytest.raises(ValueError, match="single-class"):
        auc(np.ones(4), np.arange(4.0))


# ------------------------------------------------------ int8 fused serve


@pytest.mark.parametrize("n", [13, 40])
def test_int8_fused_serve_plain_matches_jax_interpret_f32(n):
    _, jcfg, jp, _, tcfg, tp = _pair("float32")
    ids, wts = _batch(n, seed=6)
    want = jck.build_fused_serve(jq.quantize_params(jp), jcfg, interpret=True)(
        None, {"feat_ids": ids, "feat_wts": wts})
    fn = ck.build_fused_serve(quantize.quantize_params(tp), tcfg)
    assert fn.serve_weights.quantized and fn.serve_weights.wc.dtype == torch.int8
    got = fn(None, {"feat_ids": torch.from_numpy(ids), "feat_wts": torch.from_numpy(wts)})
    np.testing.assert_allclose(got["prediction_node"].numpy(),
                               np.asarray(want["prediction_node"]), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]),
                               rtol=2e-5, atol=2e-5)


def test_int8_fused_serve_plain_matches_jax_interpret_bf16():
    _, jcfg, jp, tm, tcfg, tp = _pair("bfloat16")
    ids, wts = _batch(64, seed=9)
    wts_bf16 = torch.from_numpy(wts).to(torch.bfloat16)  # the bf16 transfer spec
    qp = quantize.quantize_params(tp)
    got = ck.build_fused_serve(qp, tcfg)(
        None, {"feat_ids": torch.from_numpy(ids), "feat_wts": wts_bf16})["prediction_node"]
    want = np.asarray(jck.build_fused_serve(jq.quantize_params(jp), jcfg, interpret=True)(
        None, {"feat_ids": ids, "feat_wts": wts_bf16.float().numpy()})["prediction_node"])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)
    # And within the 0.005 autotune gate of the quantized model.apply.
    app = tm.apply(qp, {"feat_ids": torch.from_numpy(ids), "feat_wts": wts_bf16})
    assert (got - app["prediction_node"].float()).abs().max().item() <= 5e-3


def test_int8_serve_weights_layout():
    """int8 operands stay int8 (1 byte per weight) with f32 scales; the head
    is dequantized to f32 once, as the JAX kernel's build does; the bf16
    kernels' operand layout pads int8 W^T like float weights."""
    _, jcfg, jp, _, tcfg, tp = _pair("bfloat16")
    qp = quantize.quantize_params(tp)
    sw = ck.prepare_serve_weights(qp, tcfg)
    d = KW["num_fields"] * KW["embed_dim"]
    assert sw.wc.dtype == torch.int8 and tuple(sw.wc.shape) == (2, d, d)
    assert tuple(sw.sc.shape) == (2, d) and sw.sc.dtype == torch.float32
    assert [w.dtype for w, _ in sw.mlp] == [torch.int8, torch.int8]
    assert [tuple(s.shape) for s in sw.ms] == [(32,), (16,)]
    jqp = jq.quantize_params(jp)
    want_head = (jqp["out"]["qw"].astype(np.float32) * jqp["out"]["qscale"][None, :])[:, 0]
    np.testing.assert_array_equal(sw.wo.numpy(), want_head)
    t = ck.mma_layout(sw.wc)
    assert t.dtype == torch.int8 and tuple(t.shape) == (2, ck._pad_n(d), ck._pad_k(d))
    assert t[0].numel() * t.element_size() == ck._pad_n(d) * ck._pad_k(d)  # 1 byte per weight
    assert ck._pad_k(d) % 8 == 0  # 8-byte int8 fragment loads stay aligned
    assert not ck.prepare_serve_weights(tp, tcfg).quantized


def test_int8_fused_serve_refuses_mixed_trees():
    _, _, _, _, tcfg, tp = _pair()
    qp = quantize.quantize_params(tp)
    mixed = {**qp, "mlp": tp["mlp"]}
    with pytest.raises(ValueError, match="all-float or all-int8"):
        ck.prepare_serve_weights(mixed, tcfg)


def test_cpu_int8_wrapper_counts_no_launches():
    _, _, _, _, tcfg, tp = _pair()
    ids, wts = _batch(5, seed=1)
    fn = ck.build_fused_serve(quantize.quantize_params(tp), tcfg)
    ck.reset_launches()
    fn(None, {"feat_ids": torch.from_numpy(ids), "feat_wts": torch.from_numpy(wts)})
    assert not any(ck.launches.values())


@pytest.mark.parametrize("kind,quantized", [("dcn_v2", False), ("dcn_v2", True),
                                             ("dcn", False), ("dcn", True)])
def test_serve_params_supported_agrees_with_jax(kind, quantized):
    _, _, jp, _, _, tp = _pair(kind=kind)
    if quantized:
        jp, tp = jq.quantize_params(jp), quantize.quantize_params(tp)
    assert ck.serve_params_supported(tp) == jck.serve_params_supported(jp) == (kind == "dcn_v2")


@pytest.mark.parametrize("quantized", [False, True])
def test_params_digest_equal_in_both_packages(quantized):
    _, _, jp, _, _, tp = _pair()
    if quantized:
        jp, tp = jq.quantize_params(jp), quantize.quantize_params(tp)
    assert autotune.params_digest(tp) == jax_autotune.params_digest(jp)
    _, _, jp2, _, _, _ = _pair(seed=1)
    assert autotune.params_digest(tp) != jax_autotune.params_digest(jp2)
