"""Port models vs the JAX package: the same params (carried over with
convert.params_from_jax) and the same numpy inputs through JAX
`model.apply` and the port's `model.apply`, on the CPU.

Tolerances are the JAX package's own parity gates: f32 scores within 1e-5
and AUC within 1e-6, bf16 AUC within 1e-3 (tests/test_parity.py)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from distributed_tf_serving_tpu.models import ModelConfig as JaxConfig
from distributed_tf_serving_tpu.models import build_model as jax_build
from distributed_tf_serving_tpu.models.embeddings import field_embed as jax_field_embed
from distributed_tf_serving_tpu.serving.batcher import fold_ids_host as jax_fold
from distributed_tf_serving_tpu.train.data import auc
from distributed_tf_serving_tpu_torch.convert import params_from_jax
from distributed_tf_serving_tpu_torch.models import ModelConfig, build_model, model_kinds
from distributed_tf_serving_tpu_torch.models.base import dense_apply, mlp_apply
from distributed_tf_serving_tpu_torch.models.embeddings import field_embed, fold_ids

SMALL = dict(num_fields=12, vocab_size=1 << 14, embed_dim=8, mlp_dims=(32, 16),
             num_cross_layers=3)


def _pair(kind, compute_dtype, seed=1, **over):
    kw = {**SMALL, "compute_dtype": compute_dtype, **over}
    jm = jax_build(kind, JaxConfig(**kw))
    tm = build_model(kind, ModelConfig(**kw))
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    return jm, tm, jp, params_from_jax(jp, "cpu")


def _inputs(n, fields=SMALL["num_fields"], seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 1 << 40, size=(n, fields)).astype(np.int64)
    wts = rng.rand(n, fields).astype(np.float32)
    return ids, wts, rng


def _scores(jm, tm, jp, tp, ids, wts):
    want = np.asarray(
        jm.apply(jp, {"feat_ids": jax_fold(ids, jm.config.vocab_size), "feat_wts": wts})
        ["prediction_node"]
    )
    with torch.inference_mode():
        got = tm.apply(tp, {"feat_ids": torch.from_numpy(ids),
                            "feat_wts": torch.from_numpy(wts)})["prediction_node"]
    return got.float().numpy(), want


@pytest.mark.parametrize("kind", ["dcn_v2", "dcn"])
def test_forward_matches_jax_f32(kind):
    jm, tm, jp, tp = _pair(kind, "float32")
    ids, wts, rng = _inputs(1024)
    got, want = _scores(jm, tm, jp, tp, ids, wts)
    assert got.shape == (1024,)
    assert np.max(np.abs(got - want)) < 1e-5
    labels = (rng.rand(len(want)) < want).astype(np.float32)
    assert abs(auc(labels, got) - auc(labels, want)) < 1e-6


@pytest.mark.parametrize("kind", ["dcn_v2", "dcn"])
def test_forward_matches_jax_bf16_auc(kind):
    jm, tm, jp, tp = _pair(kind, "bfloat16")
    ids, wts, rng = _inputs(1024, seed=3)
    got, want = _scores(jm, tm, jp, tp, ids, wts)
    labels = (rng.rand(len(want)) < want).astype(np.float32)
    assert abs(auc(labels, got) - auc(labels, want)) < 1e-3
    # Same rounding points as the JAX path, so scores agree far tighter
    # than the AUC gate needs.
    assert np.max(np.abs(got - want)) < 1e-3


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_field_embed_rounds_like_jax(compute_dtype):
    """Rows AND weights are cast to the compute dtype before the product."""
    rng = np.random.RandomState(4)
    table = rng.randn(64, 8).astype(np.float32)
    ids = rng.randint(-100, 1000, size=(9, 5)).astype(np.int64)
    wts = rng.rand(9, 5).astype(np.float32)
    cd_j = jax.numpy.dtype(compute_dtype)
    want = np.asarray(jax_field_embed(table, ids, wts, cd_j).astype(np.float32))
    got = field_embed(torch.from_numpy(table), torch.from_numpy(ids),
                      torch.from_numpy(wts), getattr(torch, compute_dtype))
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_fold_ids_matches_jax_on_negative_and_huge_ids():
    ids = np.array([[-1, -(1 << 40), 0, (1 << 40) - 1, 12345678901]], np.int64)
    got = fold_ids(torch.from_numpy(ids), 1 << 14).numpy()
    np.testing.assert_array_equal(got, jax_fold(ids, 1 << 14))


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_dense_and_mlp_keep_f32_accumulation(compute_dtype):
    """bf16 operands, f32 result: the JAX preferred_element_type contract
    (a bf16 torch.matmul would round the output to bf16)."""
    from distributed_tf_serving_tpu.models.base import dense_apply as jdense
    from distributed_tf_serving_tpu.models.base import mlp_apply as jmlp

    rng = np.random.RandomState(5)
    layers = [{"w": rng.randn(24, 16).astype(np.float32), "b": rng.randn(16).astype(np.float32)},
              {"w": rng.randn(16, 4).astype(np.float32), "b": rng.randn(4).astype(np.float32)}]
    x = rng.randn(7, 24).astype(np.float32)
    cd_j, cd_t = jax.numpy.dtype(compute_dtype), getattr(torch, compute_dtype)
    tl = params_from_jax(layers)
    got = dense_apply(tl[0], torch.from_numpy(x), cd_t)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jdense(layers[0], x, cd_j)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        mlp_apply(tl, torch.from_numpy(x), cd_t, final_relu=False).numpy(),
        np.asarray(jmlp(layers, x, cd_j, final_relu=False)), rtol=1e-5, atol=1e-5,
    )


def test_model_config_mirrors_jax_fields_and_defaults():
    jf = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(ModelConfig)}
    assert jf == tf
    from distributed_tf_serving_tpu.models import model_kinds as jax_model_kinds

    assert model_kinds() == jax_model_kinds()


def test_params_from_jax_keeps_names_layouts_and_values():
    jm = jax_build("dcn_v2", JaxConfig(**SMALL))
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tp = params_from_jax(jp, "cpu")
    assert set(tp) == {"embedding", "cross", "mlp", "out"}
    assert tp["cross"][0]["w"].shape == (96, 96)
    assert tp["mlp"][0]["w"].shape == (96, 32)  # [in, out]
    flat_j, tree_j = jax.tree.flatten(jp)
    flat_t, tree_t = jax.tree.flatten(jax.tree.map(lambda t: t.numpy(), tp))
    assert tree_j == tree_t
    for a, b in zip(flat_j, flat_t):
        np.testing.assert_array_equal(a, b)


def test_demo_init_is_seeded_and_shaped():
    cfg = ModelConfig(**SMALL, compute_dtype="float32")
    m = build_model("dcn_v2", cfg)
    p1, p2 = m.init(7, "cpu"), m.init(7, "cpu")
    assert torch.equal(p1["embedding"], p2["embedding"])
    assert p1["embedding"].shape == (1 << 14, 8)
    assert p1["out"]["w"].shape == (96 + 16, 1)
    out = m.apply(p1, {"feat_ids": torch.zeros((3, 12), dtype=torch.int64),
                       "feat_wts": torch.ones((3, 12))})
    assert out["prediction_node"].shape == (3,)
    assert torch.isfinite(out["logits"]).all()


def test_use_pallas_cross_matches_jax_interpret():
    """use_pallas_cross routes the cross stack through fused_cross_apply;
    on CPU tensors that is its plain version, held to the JAX model with
    its Pallas kernel in interpret mode."""
    jm, tm, jp, tp = _pair("dcn_v2", "float32", use_pallas_cross=True)
    ids, wts, _ = _inputs(20, seed=8)
    got, want = _scores(jm, tm, jp, tp, ids, wts)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
