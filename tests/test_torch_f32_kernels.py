"""The f32 (AUC-parity) kernels' arithmetic, plan and layout, on the CPU.

csrc/cross_kernel.cu runs the f32 fused serve and cross-stack kernels on the
tensor cores in split TF32: every f32 operand a is split into hi = a rounded
to TF32 (round half away from zero, cvt.rna.tf32.f32) and lo = a - hi, and
each 8-deep k step of mma.sync m16n8k8 adds lo_a * hi_b, hi_a * lo_b and
hi_a * hi_b to an f32 accumulator (an int8 weight is exact in TF32: lo_a * b
and hi_a * b). The mma reads the top 19 bits of lo (TF32 truncation). The
kernels themselves run only on the card; here a plain emulation of that
arithmetic (bit operations on f32 tensors) is held to the JAX package's f32
path at the full serving width, and the f32 cluster rule, shared-memory
sizes and row-major f32 layout with its owner pull are checked alone.

Tolerances: cross stack allclose rtol = atol = 1e-5 (tests/test_cross_kernel.py),
fused serve scores 2e-5 (tests/test_quantize.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tf_serving_tpu.models import ModelConfig as JaxConfig
from distributed_tf_serving_tpu.models import build_model as jax_build
from distributed_tf_serving_tpu.ops import cross_kernel as jck
from distributed_tf_serving_tpu.ops import quantize as jq
from distributed_tf_serving_tpu.serving.batcher import fold_ids_host as jax_fold
from distributed_tf_serving_tpu_torch.convert import params_from_jax
from distributed_tf_serving_tpu_torch.models import ModelConfig
from distributed_tf_serving_tpu_torch.ops import cross_kernel as ck

CLUSTERS = (1, 2, 4, 8)
# cudaOccupancyMaxActiveClusters of a 512-thread block per SM on an H100
# SXM: a cluster must fit one GPC, so 15 clusters of 8, not 132 / 8.
H100_CLUSTERS = (132, 66, 30, 15)
# The serving width: 43 fields x 16, 3 cross layers, MLP 256/128/64.
SERVING = dict(num_fields=43, embed_dim=16, mlp_dims=(256, 128, 64), num_cross_layers=3,
               vocab_size=1 << 12, compute_dtype="float32")

# --------------------------------------------------- the emulation

_LOW13 = ~0x1FFF  # TF32 keeps the top 19 bits of an f32


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32, half away from zero (the kernel's split_tf32)."""
    return ((x.view(torch.int32) + 0x1000) & _LOW13).view(torch.float32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """x truncated to TF32: what the mma reads of an f32 register."""
    return (x.view(torch.int32) & _LOW13).view(torch.float32)


def _kernel_k_order(k: int) -> list[list[torch.Tensor]]:
    """Per 32-deep chunk, the k indices of each 8-deep mma step in the
    kernel's order: step s takes k = 8t + 2s and 8t + 2s + 1 for t = 0..3."""
    kp = -(-k // 32) * 32
    return [[torch.tensor([c + 8 * t + 2 * s + e for t in range(4) for e in (0, 1)])
             for s in range(4)] for c in range(0, kp, 32)]


def split_matmul(a: torch.Tensor, w: torch.Tensor, exact_w: bool = False,
                 lo=tf32_trunc) -> torch.Tensor:
    """a [n, K] @ w [K, N] as the f32 kernels compute it: per 32-deep chunk
    fresh accumulators take, per 8-deep k step in the kernel's order, the
    small products lo_a @ hi_w and hi_a @ lo_w (one accumulator) and hi_a @
    hi_w (the other) in f32 (with exact_w, a widened int8: lo_a @ w and
    hi_a @ w); their sum adds to the total."""
    k = a.shape[1]
    kp = -(-k // 32) * 32
    a = torch.nn.functional.pad(a, (0, kp - k))
    w = torch.nn.functional.pad(w, (0, 0, 0, kp - k))
    a_hi = tf32_rna(a)
    a_lo = lo(a - a_hi)
    if exact_w:
        small, big = ((a_lo, w),), (a_hi, w)
    else:
        w_hi = tf32_rna(w)
        small, big = ((a_lo, w_hi), (a_hi, lo(w - w_hi))), (a_hi, w_hi)
    total = torch.zeros((a.shape[0], w.shape[1]), dtype=torch.float32)
    for chunk in _kernel_k_order(k):
        acc_small, acc_big = torch.zeros_like(total), torch.zeros_like(total)
        for ks in chunk:
            for x, y in small:
                acc_small = acc_small + x[:, ks] @ y[ks]
            acc_big = acc_big + big[0][:, ks] @ big[1][ks]
        total = total + (acc_small + acc_big)
    return total


def emulated_cross(x0, w, b, s=None, mm=split_matmul):
    """The f32 cross stack on split-TF32 products: w [L, d, d] f32, or int8
    with scales s [L, d]; the update rounds where the kernel does."""
    x = x0
    for l in range(w.shape[0]):
        xw = mm(x, w[l].to(x.dtype), exact_w=s is not None)
        if s is not None:
            xw = xw * s[l]
        x = x0 * (xw + b[l]) + x
    return x


def emulated_serve(ids, wts, sw: ck.ServeWeights) -> dict[str, torch.Tensor]:
    """ck.fused_serve_reference in f32 with every matmul of the kernel (cross
    and MLP; the head is an f32 row dot in the kernel too) as split TF32."""
    n = ids.shape[0]
    x0 = (sw.table[ids.long()] * wts.float()[..., None]).reshape(n, sw.d)
    h = x0
    for m, (w, b) in enumerate(sw.mlp):
        y = split_matmul(h, w.float(), exact_w=sw.quantized)
        if sw.quantized:
            y = y * sw.ms[m]
        h = torch.relu(y + b)
    xc = emulated_cross(x0, sw.wc, sw.bc, sw.sc)
    lo = (xc @ sw.wo[:sw.d] + h @ sw.wo[sw.d:]) + sw.bo[0]
    return {"prediction_node": torch.sigmoid(lo), "logits": lo}


# ------------------------------------------------------ the split itself


@pytest.mark.parametrize("scale", [1e-6, 1e-2, 1.0, 3e4])
def test_tf32_split_is_exact_and_rounds_to_nearest(scale):
    rng = np.random.RandomState(int(scale * 1e6) % 997)
    x = torch.from_numpy((rng.randn(4096) * scale).astype(np.float32))
    hi = tf32_rna(x)
    lo = x - hi
    assert torch.all(hi.view(torch.int32) & 0x1FFF == 0)  # hi is a TF32 value
    assert torch.equal(hi + lo, x)  # lo = x - hi is exact in f32
    assert torch.equal(hi.double() + lo.double(), x.double())
    # Nearest: within half a TF32 ulp (2^-11 of the binade) of x.
    half_ulp = torch.ldexp(torch.ones_like(x), torch.frexp(x).exponent - 12)
    assert torch.all((x - hi).abs() <= half_ulp)
    assert torch.all(lo.abs() <= x.abs() * 2.0 ** -11)


def test_widened_int8_weights_are_exact_in_tf32():
    q = torch.arange(-127, 128, dtype=torch.int8).float()
    assert torch.equal(tf32_rna(q), q) and torch.equal(tf32_trunc(q), q)


# ------------------------------------------- against the JAX package


@functools.lru_cache(maxsize=None)
def _serving_model(seed: int = 0):
    jcfg = JaxConfig(**SERVING)
    jp = jax.tree.map(np.asarray, jax_build("dcn_v2", jcfg).init(jax.random.PRNGKey(seed)))
    return jcfg, jp


def _serving_batch(n: int, seed: int):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 1 << 40, size=(n, SERVING["num_fields"])).astype(np.int64)
    wts = rng.rand(n, SERVING["num_fields"]).astype(np.float32)
    return jax_fold(ids, SERVING["vocab_size"]), wts


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_tf32_cross_matches_jax_interpret_at_serving_width(seed):
    """The cross stack on what the serving path hands it (the weighted
    gather of the table, 32 rows of width 688, L = 3): the emulation against
    the JAX Pallas kernel in interpret mode and the port's plain version,
    at 1e-5. Plain TF32 (hi parts alone) misses by orders of magnitude."""
    _, jp = _serving_model()
    ids, wts = _serving_batch(32, seed)
    x0 = (jp["embedding"][ids] * wts[..., None]).reshape(32, -1).astype(np.float32)
    w, b = (np.array(v) for v in jck.cross_params_to_stacked(jp["cross"]))
    want = np.asarray(jck.fused_cross_apply(jnp.asarray(x0), jnp.asarray(w), jnp.asarray(b),
                                            compute_dtype=jnp.float32, interpret=True))
    X0, W, B = (torch.from_numpy(v) for v in (x0, w, b))
    got = emulated_cross(X0, W, B).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    plain = ck.cross_stack_reference(X0, W, B, torch.float32).numpy()
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-5)
    tf32_only = emulated_cross(X0, W, B, mm=lambda a, m, exact_w: tf32_rna(a) @ tf32_rna(m))
    assert np.max(np.abs(tf32_only.numpy() - want)) > 100 * np.max(np.abs(got - want))


@pytest.mark.parametrize("quantized", [False, True])
def test_split_tf32_serve_matches_jax_interpret_at_serving_width(quantized):
    """The whole fused serve step (gather, 3 cross layers, MLP 256/128/64,
    f32 head, sigmoid) at the serving width, float and int8 weights: the
    emulation against build_fused_serve(interpret=True) at 2e-5."""
    jcfg, jp = _serving_model()
    tree = jq.quantize_params(jp) if quantized else jp
    ids, wts = _serving_batch(32, seed=5)
    want = jck.build_fused_serve(tree, jcfg, interpret=True)(
        tree, {"feat_ids": ids, "feat_wts": wts})
    sw = ck.prepare_serve_weights(params_from_jax(tree), ModelConfig(**SERVING))
    assert sw.quantized == quantized
    got = emulated_serve(torch.from_numpy(ids), torch.from_numpy(wts), sw)
    for key in ("prediction_node", "logits"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_tf32_error_is_f32_level_on_unit_normal_inputs(seed):
    """A harder input than serving's: unit-normal x0 (|x_L| up to ~25). There
    an f32 sum is itself ~1e-5 from a float64 truth, so the 1e-5 parity
    measures summation order, not the split; the split's error stays within
    twice the f32 matmul's, whichever way lo is rounded."""
    d, L = 688, 3
    rng = np.random.RandomState(seed)
    x0 = torch.from_numpy(rng.randn(32, d).astype(np.float32))
    w = torch.from_numpy((rng.randn(L, d, d) / np.sqrt(d)).astype(np.float32))
    b = torch.from_numpy((rng.randn(L, d) * 0.1).astype(np.float32))
    truth = emulated_cross(x0.double(), w.double(), b.double(),
                           mm=lambda a, m, exact_w: a @ m).numpy()
    f32_err = np.max(np.abs(ck.cross_stack_reference(x0, w, b, torch.float32).numpy() - truth))
    for lo in (tf32_trunc, tf32_rna):
        got = emulated_cross(x0, w, b, mm=lambda a, m, exact_w, lo=lo: split_matmul(a, m, lo=lo))
        assert np.max(np.abs(got.numpy() - truth)) <= 2 * f32_err


# -------------------------------------------------- plan and layout


@pytest.mark.parametrize("n,want", [(256, 4), (512, 2), (1024, 2), (2048, 1), (7, 8),
                                    (300, 4), (4096, 1)])
def test_f32_serve_cluster_rule_on_h100_capacity(n, want):
    """The f32 serve kernels hold one 512-thread block per SM like the bf16
    ones, so the same one-wave rule picks the same C."""
    assert ck.serve_cluster(n, H100_CLUSTERS) == want


@pytest.mark.parametrize("n,want", [(256, (16, 4)), (512, (32, 4)), (1024, (16, 2)),
                                    (2048, (32, 2)), (4096, (32, 1))])
def test_f32_cross_plan_on_h100_capacity(n, want):
    """Both f32 row tiles fit at the serving width and hold one block per
    SM, so cross_plan gives the f32 cross stack the bf16 plans."""
    capacity = {(r, c): k for r in ck.ROW_TILES for c, k in zip(CLUSTERS, H100_CLUSTERS)}
    assert ck.cross_plan(n, capacity, 688) == want


@pytest.mark.parametrize("d,want", [(688, (16, 32)), (896, (16, 32)), (897, (16,)),
                                    (1600, (16,))])
def test_f32_cross_row_tiles(d, want):
    """Two f32 x buffers and no x0 tile: R = 32 fits up to d = 896."""
    assert ck.cross_row_tiles(d, torch.float32) == want
    assert ck.fits_smem(d, torch.float32)


@pytest.mark.parametrize("d,mlp,serve,cross", [
    # x0 and two x tiles of stride 708, two h tiles of 260, 86 + 32 tile partials
    (688, (256, 128, 64), 176768, 90624),
    (80, (32, 16), 24704, 12800),
    (42, (24, 10, 5), 18240, 8704),
])
def test_f32_shared_memory(d, mlp, serve, cross):
    assert ck.serve_smem_bytes(d, mlp, torch.float32) == serve
    assert ck.cross_smem_bytes(d, torch.float32) == cross
    assert ck.cross_smem_bytes(d, torch.float32, 32) == 2 * cross
    assert ck.serve_fits_smem(d, mlp, torch.float32) and ck.fits_smem(d, torch.float32)


@pytest.mark.parametrize("d,fits", [(688, True), (960, True), (992, False)])
def test_f32_serve_width_limit(d, fits):
    assert ck.serve_fits_smem(d, (256,), torch.float32) == fits


@pytest.mark.parametrize("k", [688, 256, 128, 64, 42, 24, 10])
def test_f32_row_stride_keeps_fragment_loads_on_distinct_banks(k):
    """Lane (g, t) loads 16 bytes at row g, float 8t (+4) of a row-major f32
    tile of stride _ldf(k); each phase of 8 lanes (rows 2p, 2p + 1, t =
    0..3) must touch 8 distinct 16-byte bank groups, for rows g and g + 8."""
    ld = ck._ldf(k)
    assert ld % 4 == 0 and ld >= ck._pad_k(k)
    for row0 in (0, 8):
        for p in range(4):
            for half in (0, 1):
                groups = {((row0 + 2 * p + q) * ld + 8 * t + 4 * half) // 4 % 8
                          for q in (0, 1) for t in range(4)}
                assert len(groups) == 8


@pytest.mark.parametrize("c", CLUSTERS)
@pytest.mark.parametrize("width,rows", [(688, 16), (688, 32), (256, 16), (128, 16), (64, 16),
                                        (80, 32), (42, 32), (10, 16), (5, 16)])
def test_f32_owner_pull_rebuilds_the_layer(width, rows, c):
    """The f32 exchange: every rank writes its own 8-column tiles of an
    R-row tile of stride _ldf(width), then pulls each other tile from its
    owner as 16-byte pieces (i over 2 x R x the other tiles, as the
    kernel's pull_peers_f32<R>), and ends with the whole layer; the padded
    columns stay zero."""
    nt = ck._pad_n(width) // 8
    ld = ck._ldf(width)
    rng = np.random.RandomState(width + c)
    layer = np.zeros((rows, ld), np.float32)
    layer[:, :width] = rng.rand(rows, width)
    bufs = [np.zeros((rows, ld), np.float32) for _ in range(c)]
    for r in range(c):
        j0, j1 = 8 * ck.tile_begin(nt, c, r), 8 * ck.tile_begin(nt, c, r + 1)
        bufs[r][:, j0:j1] = layer[:, j0:j1]
    for me in range(c):
        t0 = ck.tile_begin(nt, c, me)
        own = ck.tile_begin(nt, c, me + 1) - t0
        other = nt - own
        for i in range(2 * rows * other):
            q = i >> 1
            t = q % other
            if t >= t0:
                t += own
            row, col = q // other, 8 * t + 4 * (i & 1)
            owner = ck.tile_owner(t, nt, c)
            assert owner != me
            bufs[me][row, col:col + 4] = bufs[owner][row, col:col + 4]
    for r in range(c):
        np.testing.assert_array_equal(bufs[r], layer)


@pytest.mark.parametrize("c", CLUSTERS)
@pytest.mark.parametrize("width", [688, 64, 5])
def test_f32_head_sums_tile_partials_from_their_owners(width, c):
    """The f32 head: each rank stores the dot of its own 8-column tiles with
    wo (one partial per row and tile), and rank 0 reads every tile's
    partial from its owner, lane-strided over the tiles then a butterfly
    over 32 lanes: the same terms in the same order at every C, so the
    bits of C = 1."""
    nt = ck._pad_n(width) // 8
    rng = np.random.RandomState(width)
    v = rng.randn(16, width).astype(np.float32)
    w = rng.randn(width).astype(np.float32)

    def head(c):
        parts = [np.full((16, nt), np.nan, np.float32) for _ in range(c)]
        for r in range(c):
            for t in range(ck.tile_begin(nt, c, r), ck.tile_begin(nt, c, r + 1)):
                acc = np.zeros(16, np.float32)
                for j in range(8 * t, min(8 * t + 8, width)):
                    acc = (acc + v[:, j] * w[j]).astype(np.float32)
                parts[r][:, t] = acc
        lanes = np.zeros((16, 32), np.float32)
        for lane in range(32):
            for t in range(lane, nt, 32):
                lanes[:, lane] += parts[ck.tile_owner(t, nt, c)][:, t]
        for off in (16, 8, 4, 2, 1):
            lanes = lanes + lanes[:, np.arange(32) ^ off]
        return lanes[:, 0]

    got = head(c)
    assert np.all(np.isfinite(got))
    np.testing.assert_array_equal(got, head(1))
    np.testing.assert_allclose(got, v @ w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
def test_f32_kernel_weights_take_the_mma_layout(dtype):
    """The f32 kernels read float and int8 weights as W^T [pad8(N),
    pad32(K)], like the bf16 kernels; on the CPU no layout is made."""
    w = torch.arange(3 * 42 * 10).reshape(3, 42, 10).to(dtype)
    t = ck.mma_layout(w)
    assert t.dtype == dtype and tuple(t.shape) == (3, 16, 64)
    assert torch.equal(t[:, :10, :42], w.transpose(1, 2)) and t[:, 10:].abs().sum() == 0
    cw = ck.prepare_cross_weights(torch.zeros(2, 8, 8), torch.zeros(2, 8), torch.float32)
    assert cw.wt is None


@pytest.mark.parametrize("r", ck.ROW_TILES)
@pytest.mark.parametrize("c", CLUSTERS)
def test_f32_forced_plan_on_cpu_tensors_takes_the_plain_version(c, r):
    rng = np.random.RandomState(c)
    x0 = torch.from_numpy(rng.randn(5, 16).astype(np.float32))
    cw = ck.prepare_cross_weights(torch.from_numpy(rng.randn(2, 16, 16).astype(np.float32)),
                                  torch.zeros(2, 16), torch.float32)
    ck.reset_launches()
    assert torch.equal(ck.cross_stack(x0, cw, _plan=(r, c)), ck.cross_stack(x0, cw))
    assert not any(ck.launches.values())
