"""A row's score must not depend on the row count of its call.

The sharded executor scores each data shard's rows in a call of their own,
and the JAX package holds its mesh path to a single device's bits
(tests/test_mesh_serving.py:172-190). A library product (MKL on the CPU,
cuBLAS on the card) picks its algorithm by the problem's row count, and
the CPU's vectorized sigmoid rounds a call's tail differently, so the port
runs every product of the forward in fixed tiles of `ROW_TILE` rows and
the sigmoid over a buffer padded to that tile (models/base.py).

Here the same 2048 seeded rows are scored in contiguous calls of 1, 7,
250, 256, 500, 512, 1000, 1024 and 2048 rows (the last call of a split
takes the remainder, as a data shard's would), and every output row must
be the bits of the same row in the one 2048-row call: for every family in
both compute dtypes on the CPU, for dcn_v2 with and without the
cross-stack kernel on the card, and for DLRM at the MLPerf widths through
its interaction kernel on the card in calls of 100, 700 and 2048 rows
(`cuda` marker)."""

import numpy as np
import pytest
import torch

from distributed_tf_serving_tpu_torch.models import ModelConfig, build_model
from distributed_tf_serving_tpu_torch.models.base import ROW_TILE, matmul_f32

ROWS = 2048
SIZES = (1, 7, 250, 256, 500, 512, 1000, 1024, 2048)
KINDS = ("dcn", "dcn_v2", "wide_deep", "deepfm", "two_tower", "dlrm", "generic")
KW = dict(num_fields=8, vocab_size=1 << 12, embed_dim=8, mlp_dims=(16, 8), num_cross_layers=2,
          num_user_fields=4, num_dense_features=4, bottom_mlp_dims=(16, 8))


def _batch(kind, fields, seed=1, device="cpu"):
    rng = np.random.RandomState(seed)
    b = {"feat_ids": rng.randint(0, 1 << 12, (ROWS, fields)).astype(np.int32),
         "feat_wts": rng.rand(ROWS, fields).astype(np.float32)}
    if kind == "dlrm":
        b["dense_features"] = rng.rand(ROWS, KW["num_dense_features"]).astype(np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


def _moved(model, params, batch, sizes=SIZES) -> dict:
    """{output: [row counts whose calls moved a row's bits]}."""
    with torch.inference_mode():
        whole = model.apply(params, batch)
        moved: dict = {}
        for n in sizes:
            parts = [model.apply(params, {k: v[lo:lo + n] for k, v in batch.items()})
                     for lo in range(0, ROWS, n)]
            for k, v in whole.items():
                if v.ndim == 0:
                    continue
                got = torch.cat([p[k] for p in parts])
                if got.shape != v.shape or not torch.equal(got, v):
                    moved.setdefault(k, []).append(n)
    return moved


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", KINDS)
def test_a_rows_bits_do_not_move_with_its_calls_row_count(kind, compute_dtype):
    model = build_model(kind, ModelConfig(**KW, compute_dtype=compute_dtype))
    params = model.init(0, "cpu")
    assert _moved(model, params, _batch(kind, KW["num_fields"])) == {}


@pytest.mark.parametrize("k,n_out", [(688, 256), (752, 1), (48, 1), (32, 16)])
@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
def test_matmul_f32_gives_a_row_the_same_bits_at_every_row_count(k, n_out, compute_dtype):
    """The product alone, at the serving widths' shapes (the first cross /
    MLP layer, the head) and the tests' narrow ones; also with the rows of
    one call starting off the tile grid."""
    g = torch.Generator().manual_seed(k + n_out)
    x = torch.randn(ROWS, k, generator=g)
    w = torch.randn(k, n_out, generator=g)
    whole = matmul_f32(x, w, compute_dtype)
    ref = x.to(compute_dtype).float() @ w.to(compute_dtype).float()
    torch.testing.assert_close(whole, ref, rtol=1e-5, atol=1e-5)  # the same product
    for n in SIZES:
        for lo in sorted({0, 3, ROWS - n}):
            got = matmul_f32(x[lo:lo + n], w, compute_dtype)
            assert torch.equal(got, whole[lo:lo + n]), (n, lo)
    assert matmul_f32(x[:0], w, compute_dtype).shape == (0, n_out)
    assert ROWS % ROW_TILE == 0


@pytest.mark.cuda
@pytest.mark.parametrize("use_pallas_cross", [False, True])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_a_rows_bits_do_not_move_with_its_calls_row_count_on_card(compute_dtype,
                                                                   use_pallas_cross):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    cfg = ModelConfig(num_fields=43, vocab_size=1 << 20, embed_dim=16,
                      mlp_dims=(256, 128, 64), num_cross_layers=3,
                      compute_dtype=compute_dtype, use_pallas_cross=use_pallas_cross)
    model = build_model("dcn_v2", cfg)
    params = model.init(0, dev)
    rng = np.random.RandomState(5)
    batch = {"feat_ids": torch.from_numpy(rng.randint(0, 1 << 20, (ROWS, 43))
                                          .astype(np.int32)).to(dev),
             "feat_wts": torch.from_numpy(rng.rand(ROWS, 43).astype(np.float32)).to(dev)}
    assert _moved(model, params, batch) == {}


@pytest.mark.cuda
def test_a_dlrm_rows_bits_do_not_move_with_its_calls_row_count_on_card():
    """The interaction kernel sums each dot in an order fixed by the width,
    and the MLPs run in ROW_TILE tiles, so a row's score has the same bits
    in a call of 100, 700 or 2048 rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    from distributed_tf_serving_tpu_torch.ops import cross_kernel as ck

    dev = torch.device("cuda")
    cfg = ModelConfig(name="DLRM", num_fields=26, vocab_size=1 << 20, embed_dim=128,
                      num_dense_features=13, bottom_mlp_dims=(512, 256, 128),
                      mlp_dims=(1024, 1024, 512, 256), compute_dtype="bfloat16")
    model = build_model("dlrm", cfg)
    params = model.init(0, dev)
    rng = np.random.RandomState(6)
    batch = {"feat_ids": torch.from_numpy(rng.randint(0, 1 << 20, (ROWS, 26))
                                          .astype(np.int32)).to(dev),
             "feat_wts": torch.from_numpy(rng.rand(ROWS, 26).astype(np.float32)).to(dev),
             "dense_features": torch.from_numpy(np.log1p(rng.lognormal(1.0, 1.5, (ROWS, 13)))
                                                .astype(np.float32)).to(dev)}
    ck.reset_launches()
    assert _moved(model, params, batch, sizes=(100, 700, 2048)) == {}
    assert ck.launches["dlrm_interact", "bfloat16"] == 1 + 21 + 3 + 1
