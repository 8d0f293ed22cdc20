"""The port's two kernel modules (ops/cross_kernel.py) against the JAX
package's Pallas kernels run in interpret mode on the CPU.

On CPU tensors the wrappers run their plain PyTorch versions, which follow
the CUDA kernels' rounding; the kernels themselves are held to those plain
versions on the card (tests/test_torch_cuda.py, and chip_smoke.py).

Tolerances: cross stack 1e-5 (f32) / 2e-2 (bf16) as tests/test_cross_kernel.py;
fused serve 2e-5 (f32) as tests/test_quantize.py, and the 0.005 autotune gate
against model.apply in bf16."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tf_serving_tpu.models import ModelConfig as JaxConfig
from distributed_tf_serving_tpu.models import build_model as jax_build
from distributed_tf_serving_tpu.models.dcn import _cross_init, cross_apply as jax_cross_apply
from distributed_tf_serving_tpu.ops import cross_kernel as jck
from distributed_tf_serving_tpu.serving.batcher import fold_ids_host as jax_fold
from distributed_tf_serving_tpu_torch.convert import params_from_jax
from distributed_tf_serving_tpu_torch.models import ModelConfig, build_model
from distributed_tf_serving_tpu_torch.ops import cross_kernel as ck

SERVE_KW = dict(num_fields=10, vocab_size=1 << 12, embed_dim=8, mlp_dims=(32, 16),
                num_cross_layers=2)


def _setup(n, d, L, seed=0):
    layers = _cross_init(jax.random.PRNGKey(seed), L, d, True, jnp.float32)
    rng = np.random.RandomState(seed)
    x0 = rng.randn(n, d).astype(np.float32)
    w, b = jck.cross_params_to_stacked(layers)
    return x0, layers, np.array(w), np.array(b)  # writable copies for torch


def _port_cross(x0, w, b, cd):
    return ck.fused_cross_apply(torch.from_numpy(x0), torch.from_numpy(w),
                                torch.from_numpy(b), compute_dtype=cd)


# ----------------------------------------------------------- cross stack


@pytest.mark.parametrize("n,d,L", [(32, 128, 3), (100, 688, 2), (7, 96, 1)])
def test_cross_matches_jax_kernel_and_xla_path_f32(n, d, L):
    x0, layers, w, b = _setup(n, d, L)
    got = _port_cross(x0, w, b, torch.float32).numpy()
    want_kernel = np.asarray(jck.fused_cross_apply(
        jnp.asarray(x0), jnp.asarray(w), jnp.asarray(b), compute_dtype=jnp.float32,
        interpret=True))
    want_xla = np.asarray(jax_cross_apply(layers, jnp.asarray(x0), jnp.float32))
    np.testing.assert_allclose(got, want_kernel, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want_xla, rtol=1e-5, atol=1e-5)


def test_cross_matches_jax_bf16():
    x0, layers, w, b = _setup(64, 128, 3)
    got = _port_cross(x0, w, b, torch.bfloat16).float().numpy()
    want = np.asarray(jck.fused_cross_apply(
        jnp.asarray(x0), jnp.asarray(w), jnp.asarray(b), compute_dtype=jnp.bfloat16,
        interpret=True)).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
    want_xla = np.asarray(jax_cross_apply(
        layers, jnp.asarray(x0).astype(jnp.bfloat16), jnp.bfloat16)).astype(np.float32)
    np.testing.assert_allclose(got, want_xla, rtol=2e-2, atol=2e-2)


def test_cross_ragged_shapes_are_neutral():
    """d=100 and n=13: the JAX kernel pads both; the port pads neither and
    masks the ragged edge. Outputs keep the caller's shape."""
    x0, layers, w, b = _setup(13, 100, 2)
    got = _port_cross(x0, w, b, torch.float32)
    assert tuple(got.shape) == (13, 100)
    want = np.asarray(jax_cross_apply(layers, jnp.asarray(x0), jnp.float32))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_cross_rejects_v1_layers():
    layers = params_from_jax(jax.tree.map(
        np.asarray, _cross_init(jax.random.PRNGKey(0), 2, 64, False, jnp.float32)))
    with pytest.raises(ValueError, match="full-matrix"):
        ck.cross_params_to_stacked(layers)


def test_fits_smem_guard():
    """The x0 tile and two x buffers of one block must fit shared memory;
    an oversized width is refused up front."""
    assert ck.fits_smem(688, torch.bfloat16)       # serving width
    assert ck.fits_smem(688, torch.float32)
    assert not ck.fits_smem(2816, torch.bfloat16)  # 43 fields x 64
    d = 2816
    with pytest.raises(ValueError, match="shared memory"):
        ck.fused_cross_apply(torch.zeros((8, d), dtype=torch.bfloat16),
                             torch.zeros((3, d, d), dtype=torch.bfloat16),
                             torch.zeros((3, d)))


def test_model_falls_back_when_over_smem():
    """use_pallas_cross on an oversized config still scores (through
    cross_apply), and matches the JAX model's own fallback."""
    kw = dict(num_fields=43, vocab_size=4096, embed_dim=64, mlp_dims=(32,),
              num_cross_layers=3, compute_dtype="bfloat16", use_pallas_cross=True)
    jm = jax_build("dcn_v2", JaxConfig(**kw))
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tm = build_model("dcn_v2", ModelConfig(**kw))
    batch = {"feat_ids": np.zeros((4, 43), np.int32), "feat_wts": np.ones((4, 43), np.float32)}
    got = tm.apply(params_from_jax(jp), {k: torch.from_numpy(v) for k, v in batch.items()})
    out = got["prediction_node"].numpy()
    assert out.shape == (4,) and np.all(np.isfinite(out))
    want = np.asarray(jm.apply(jp, batch)["prediction_node"])
    np.testing.assert_allclose(out, want, atol=1e-3)


def test_cpu_wrappers_do_not_count_launches():
    x0, _, w, b = _setup(5, 32, 2)
    ck.reset_launches()
    _port_cross(x0, w, b, torch.float32)
    assert not any(ck.launches.values())


# ----------------------------------------------------------- fused serve


def _serve_pair(compute_dtype, kind="dcn_v2", seed=0):
    kw = {**SERVE_KW, "compute_dtype": compute_dtype}
    jcfg, tcfg = JaxConfig(**kw), ModelConfig(**kw)
    jm = jax_build(kind, jcfg)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    return jm, jcfg, jp, build_model(kind, tcfg), tcfg, params_from_jax(jp)


def _serve_batch(n, seed):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 1 << 40, size=(n, SERVE_KW["num_fields"])).astype(np.int64)
    wts = rng.rand(n, SERVE_KW["num_fields"]).astype(np.float32)
    return jax_fold(ids, SERVE_KW["vocab_size"]), wts


@pytest.mark.parametrize("n", [13, 40])
def test_fused_serve_plain_matches_jax_interpret_f32(n):
    jm, jcfg, jp, tm, tcfg, tp = _serve_pair("float32")
    ids, wts = _serve_batch(n, seed=6)
    want = jck.build_fused_serve(jp, jcfg, interpret=True)(
        jp, {"feat_ids": ids, "feat_wts": wts})
    got = ck.build_fused_serve(tp, tcfg)(tp, {"feat_ids": torch.from_numpy(ids),
                                              "feat_wts": torch.from_numpy(wts)})
    assert got["prediction_node"].shape == (n,)
    np.testing.assert_allclose(got["prediction_node"].numpy(),
                               np.asarray(want["prediction_node"]), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]),
                               rtol=2e-5, atol=2e-5)


def test_fused_serve_plain_bf16_within_autotune_gate_of_model_apply():
    """The kernel's rounding differs from model.apply in bf16 (f32 gather,
    f32 head), so the two agree within the 0.005 autotune gate — and the
    port's plain version agrees with JAX's interpret-mode kernel far more
    tightly, since both round at the same points."""
    jm, jcfg, jp, tm, tcfg, tp = _serve_pair("bfloat16")
    ids, wts = _serve_batch(64, seed=9)
    wts_bf16 = torch.from_numpy(wts).to(torch.bfloat16)  # the bf16 transfer spec
    got = ck.build_fused_serve(tp, tcfg)(
        tp, {"feat_ids": torch.from_numpy(ids), "feat_wts": wts_bf16})["prediction_node"].numpy()
    want_apply = np.asarray(jm.apply(jp, {"feat_ids": ids, "feat_wts": wts})["prediction_node"])
    assert np.max(np.abs(got - want_apply)) <= 0.005
    want_kernel = np.asarray(jck.build_fused_serve(jp, jcfg, interpret=True)(
        jp, {"feat_ids": ids, "feat_wts": wts_bf16.float().numpy()})["prediction_node"])
    np.testing.assert_allclose(got, want_kernel, atol=1e-3)


def test_fused_serve_refuses_what_jax_refuses():
    jm, jcfg, jp, tm, tcfg, tp = _serve_pair("float32", kind="dcn")  # v1 rank-1 cross
    assert not jck.serve_params_supported(jp)
    assert not ck.serve_params_supported(tp)
    with pytest.raises(ValueError, match="dcn_v2"):
        ck.build_fused_serve(tp, tcfg)
    assert not ck.serve_params_supported({"embedding": torch.zeros(4, 2)})
    assert not ck.serve_params_supported(None)


def test_serve_fits_smem():
    assert ck.serve_fits_smem(688, (256, 128, 64), torch.bfloat16)
    assert ck.serve_fits_smem(688, (256, 128, 64), torch.float32)
    assert not ck.serve_fits_smem(2816, (256,), torch.bfloat16)
    assert not ck.serve_fits_smem(688, (), torch.bfloat16)
    assert not ck.serve_fits_smem(688, (8,) * 5, torch.bfloat16)


def test_fused_serve_raw_ids_past_2_31_fold_on_host():
    """Ids are host-folded before the kernel; raw ids >= 2^31 fold exactly
    and score like the same rows given directly."""
    from distributed_tf_serving_tpu_torch.serving.batcher import fold_ids_host

    jm, jcfg, jp, tm, tcfg, tp = _serve_pair("float32")
    base = np.arange(30, dtype=np.int64).reshape(3, 10)
    raw = base + (np.int64(7) << 36) * SERVE_KW["vocab_size"]
    assert raw.min() >= 1 << 31
    fn = ck.build_fused_serve(tp, tcfg)
    wts = torch.ones((3, 10))
    a = fn(tp, {"feat_ids": torch.from_numpy(fold_ids_host(raw, 1 << 12)), "feat_wts": wts})
    b = fn(tp, {"feat_ids": torch.from_numpy(base.astype(np.int32)), "feat_wts": wts})
    assert torch.equal(a["logits"], b["logits"])


def test_bf16_operand_layout_and_smem_budget():
    """The bf16 kernels take W^T padded to [pad8(N), pad32(K)] with zeros;
    the serving width fits one block in both dtypes."""
    w = torch.arange(2 * 5 * 6, dtype=torch.float32).reshape(2, 5, 6)
    t = ck.mma_layout(w)
    assert tuple(t.shape) == (2, 8, 32) and t.is_contiguous()
    assert torch.equal(t[:, :6, :5], w.transpose(1, 2))
    assert t[:, 6:].abs().sum() == 0 and t[:, :, 5:].abs().sum() == 0
    for cd in (torch.bfloat16, torch.float32):
        assert ck.serve_smem_bytes(688, (256, 128, 64), cd) <= ck.SMEM_LIMIT_BYTES
        assert ck.cross_smem_bytes(688, cd) <= ck.SMEM_LIMIT_BYTES
