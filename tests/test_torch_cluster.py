"""The cluster split of the fused serve kernels, on the CPU.

csrc/cross_kernel.cu serves each 16-row tile with a cluster of C blocks
(bf16 and, with split-TF32 products, f32; tests/test_torch_f32_kernels.py
checks the f32 sizes and layout):
rank r owns the 8-column output tiles [tile_begin(r), tile_begin(r + 1)) of
every layer, pulls the other columns from their owners after each layer
but the last, and adds a partial head over its own columns; rank 0 sums
the partials. ops/cross_kernel.py picks C (`serve_cluster`) and mirrors the
partition (its `_lib()` holds the mirror to the kernel's own functions on
the card). Here the rule and the mirror are checked alone.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from distributed_tf_serving_tpu.models import ModelConfig as JaxConfig
from distributed_tf_serving_tpu.models import build_model as jax_build
from distributed_tf_serving_tpu.serving.batcher import fold_ids_host as jax_fold
from distributed_tf_serving_tpu_torch.convert import params_from_jax
from distributed_tf_serving_tpu_torch.models import ModelConfig
from distributed_tf_serving_tpu_torch.ops import cross_kernel as ck

CLUSTERS = (1, 2, 4, 8)
# Cross widths (43x16 serving, 10x8, 7x6, 43x64) and MLP widths.
WIDTHS = (688, 80, 42, 2816, 256, 128, 64, 32, 16, 10, 5)
H100_SMS = 132


def _ntiles(width: int) -> int:
    return ck._pad_n(width) // 8


def _ideal_capacity(sms: int) -> tuple[int, ...]:
    """Clusters of each size a card of `sms` SMs would hold at one block per
    SM if any C blocks could form a cluster (a real card holds fewer
    clusters of 8: a cluster must fit one GPC)."""
    return tuple(sms // c for c in CLUSTERS)


@pytest.mark.parametrize("c", CLUSTERS)
@pytest.mark.parametrize("width", WIDTHS)
def test_every_tile_is_owned_exactly_once(width, c):
    nt = _ntiles(width)
    owned = []
    for r in range(c):
        t0, t1 = ck.tile_begin(nt, c, r), ck.tile_begin(nt, c, r + 1)
        assert 0 <= t0 <= t1 <= nt
        owned.extend(range(t0, t1))
        assert all(ck.tile_owner(t, nt, c) == r for t in range(t0, t1))
    assert sorted(owned) == list(range(nt))
    # Balanced: the ranks' shares differ by at most one tile.
    shares = [ck.tile_begin(nt, c, r + 1) - ck.tile_begin(nt, c, r) for r in range(c)]
    assert max(shares) - min(shares) <= 1
    # The exchange and the partial head: every rank writes only its own
    # tiles, then pulls each other tile from tile_owner, and ends with the
    # whole layer; the ranks' sums over their own columns add up to the row.
    rng = np.random.RandomState(width + c)
    layer, wo = rng.rand(3, 8 * nt), rng.rand(8 * nt)
    copies = [np.full_like(layer, np.nan) for _ in range(c)]
    for r in range(c):
        j0, j1 = 8 * ck.tile_begin(nt, c, r), 8 * ck.tile_begin(nt, c, r + 1)
        copies[r][:, j0:j1] = layer[:, j0:j1]
    for r in range(c):
        for t in range(nt):
            q = ck.tile_owner(t, nt, c)
            if q != r:
                copies[r][:, 8 * t:8 * t + 8] = copies[q][:, 8 * t:8 * t + 8]
        np.testing.assert_array_equal(copies[r], layer)
    parts = [layer[:, 8 * ck.tile_begin(nt, c, r):8 * ck.tile_begin(nt, c, r + 1)]
             @ wo[8 * ck.tile_begin(nt, c, r):8 * ck.tile_begin(nt, c, r + 1)]
             for r in range(c)]
    np.testing.assert_allclose(sum(parts), layer @ wo, rtol=1e-12)


@pytest.mark.parametrize("n,want", [(256, 8), (512, 4), (1024, 2), (2048, 1),
                                    (7, 8), (300, 4), (4096, 1)])
def test_cluster_rule_at_the_serving_buckets(n, want):
    assert ck.serve_cluster(n, _ideal_capacity(H100_SMS)) == want


@pytest.mark.parametrize("n,want", [(7, 8), (240, 8), (256, 4), (512, 2), (1024, 2),
                                    (2048, 1)])
def test_cluster_rule_steps_down_where_the_clusters_do_not_fit(n, want):
    """On an H100 SXM only 15 clusters of 8 serving blocks fit at once (a
    cluster must sit in one GPC), so 16 tiles take clusters of 4 rather
    than a second wave of 8."""
    assert ck.serve_cluster(n, (132, 66, 30, 15)) == want


@pytest.mark.parametrize("sms", [1, 16, 114, 132])
def test_cluster_is_the_largest_that_fits_and_one_once_tiles_fill_the_sms(sms):
    cap = _ideal_capacity(sms)
    for n in range(1, 16 * 2 * sms + 40, 7):
        tiles = -(-n // ck.ROWS_PER_BLOCK)
        c = ck.serve_cluster(n, cap)
        assert c in CLUSTERS
        if tiles >= sms:
            assert c == 1
        else:
            assert tiles * c <= sms
            assert c == CLUSTERS[-1] or tiles * 2 * c > sms


@pytest.mark.parametrize("d,mlp,want", [(688, (256, 128, 64), 109696), (1600, (256,), 225408)])
def test_serve_block_shared_memory_fits_the_serving_widths(d, mlp, want):
    """A bf16 block holds x0 (f32), two x and two h buffers and two head
    partials, nothing per cluster rank: d = 1600 with MLP 256 still fits."""
    assert ck.serve_smem_bytes(d, mlp, torch.bfloat16) == want
    assert ck.serve_fits_smem(d, mlp, torch.bfloat16)


# ------------------------------------------------------- the wrapper


SERVE_KW = dict(num_fields=10, vocab_size=1 << 12, embed_dim=8, mlp_dims=(32, 10),
                num_cross_layers=2, compute_dtype="float32")


@functools.lru_cache(maxsize=None)
def _case(n=21, seed=4):
    jcfg, tcfg = JaxConfig(**SERVE_KW), ModelConfig(**SERVE_KW)
    jm = jax_build("dcn_v2", jcfg)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    rng = np.random.RandomState(seed)
    ids = jax_fold(rng.randint(0, 1 << 40, size=(n, SERVE_KW["num_fields"])).astype(np.int64),
                   SERVE_KW["vocab_size"])
    wts = rng.rand(n, SERVE_KW["num_fields"]).astype(np.float32)
    sw = ck.prepare_serve_weights(params_from_jax(jp), tcfg)
    return sw, torch.from_numpy(ids), torch.from_numpy(wts)


@pytest.mark.parametrize("c", CLUSTERS)
def test_forced_cluster_on_cpu_tensors_takes_the_plain_version(c):
    kw = {**SERVE_KW, "compute_dtype": "bfloat16"}
    jp = jax.tree.map(np.asarray, jax_build("dcn_v2", JaxConfig(**kw)).init(
        jax.random.PRNGKey(4)))
    sw = ck.prepare_serve_weights(params_from_jax(jp), ModelConfig(**kw))
    _, ids, wts = _case()
    wts = wts.to(torch.bfloat16)
    ck.reset_launches()
    got = ck.fused_serve(ids, wts, sw, _cluster=c)
    assert torch.equal(got["logits"], ck.fused_serve_reference(ids, wts, sw)["logits"])
    assert not any(ck.launches.values())


@pytest.mark.parametrize("bad", [0, -1])
def test_forced_cluster_below_one_is_refused(bad):
    sw, ids, wts = _case()
    with pytest.raises(ValueError, match="_cluster"):
        ck.fused_serve(ids, wts, sw, _cluster=bad)


def test_forced_cluster_is_refused_for_the_f32_kernels():
    """The f32 kernels refuse what the bf16 ones refuse: a C below one."""
    sw, ids, wts = _case()
    assert sw.compute_dtype == torch.float32
    ck.reset_launches()
    for bad in (0, -2):
        with pytest.raises(ValueError, match="_cluster"):
            ck.fused_serve(ids, wts, sw, _cluster=bad)
    assert not any(ck.launches.values())


@pytest.mark.parametrize("c", CLUSTERS)
def test_forced_cluster_is_accepted_for_the_f32_kernels(c):
    """The f32 kernels take the cluster split too: a forced C >= 1 is
    accepted (CPU tensors take the plain version, nothing is launched)."""
    sw, ids, wts = _case()
    assert sw.compute_dtype == torch.float32
    ck.reset_launches()
    got = ck.fused_serve(ids, wts, sw, _cluster=c)
    assert torch.equal(got["logits"], ck.fused_serve_reference(ids, wts, sw)["logits"])
    assert not any(ck.launches.values())
