"""The bf16 cross-stack kernel's (rows per block, cluster) rule and its
cached weight operands, on the CPU.

csrc/cross_kernel.cu runs the bf16 cross stack in tiles of R in (16, 32)
rows, each served by a cluster of C blocks; ops/cross_kernel.py picks
(R, C) (`cross_plan`, from the card's `cross_capacity`) and prepares the
weight operands once per weight set (`cross_cache`). Here the rule, the
shared-memory sizes and the cache are checked alone, and the
`use_pallas_cross` model, whose cross stack goes through that cache, is
held to the JAX model running its Pallas kernel in interpret mode.

Tolerances: f32 scores 1e-5, bf16 scores 2e-2 (the JAX package's cross
kernel gates, tests/test_cross_kernel.py); the cache itself changes no
arithmetic, so a cached result equals an uncached one bit for bit.
"""

import dataclasses
import weakref

import jax
import numpy as np
import pytest
import torch

from distributed_tf_serving_tpu.models import ModelConfig as JaxConfig
from distributed_tf_serving_tpu.models import build_model as jax_build
from distributed_tf_serving_tpu.serving.batcher import fold_ids_host as jax_fold
from distributed_tf_serving_tpu_torch.convert import params_from_jax
from distributed_tf_serving_tpu_torch.models import ModelConfig, build_model
from distributed_tf_serving_tpu_torch.ops import cross_kernel as ck

CLUSTERS = (1, 2, 4, 8)
H100_SMS = 132
# cudaOccupancyMaxActiveClusters of a 512-thread block per SM on an H100
# SXM: a cluster must fit one GPC, so 15 clusters of 8, not 132 / 8.
H100_CLUSTERS = (132, 66, 30, 15)


def _capacity(per_c, rows=ck.ROW_TILES):
    return {(r, c): k for r in rows for c, k in zip(CLUSTERS, per_c)}


def _ideal(sms, rows=ck.ROW_TILES):
    """Any C blocks could form a cluster, one block per SM."""
    return _capacity([sms // c for c in CLUSTERS], rows)


@pytest.fixture(autouse=True)
def _empty_cache():
    ck.cross_cache.clear()
    yield
    ck.cross_cache.clear()


# ------------------------------------------------------------- the rule


D = 688  # the serving width: 86 column tiles


def _rounds(r, c, d=D):
    """Rounds of 8-column tile pairs a warp of the busiest rank runs."""
    own = -(-(ck._pad_n(d) // 8) // c)
    return -(-own // (2 * ck.WARPS))


@pytest.mark.parametrize("n,want", [(256, (16, 4)), (512, (32, 4)), (1024, (16, 2)),
                                    (2048, (32, 2)), (7, (16, 8)), (300, (32, 8)),
                                    (1000, (16, 2)), (4096, (32, 1)), (8192, (32, 1))])
def test_cross_plan_on_h100_capacity(n, want):
    """The serving buckets on the H100's cluster capacity (the fastest
    forced plan at each of 256 / 512 / 1024 / 2048 rows on the card): one
    wave, the most blocks, then the fewest rounds of tile pairs per warp,
    then the smaller R; past one wave, R = 32 alone."""
    assert ck.cross_plan(n, _capacity(H100_CLUSTERS), D) == want


@pytest.mark.parametrize("plan,rounds", [((16, 1), 3), ((16, 2), 2), ((16, 4), 1),
                                         ((16, 8), 1), ((32, 2), 2), ((32, 4), 1)])
def test_rounds_of_tile_pairs_at_the_serving_width(plan, rounds):
    """86 tiles over C ranks, two tiles per warp turn, 16 warps: the chain
    the rule compares on a tie of blocks (R does not change it)."""
    assert _rounds(*plan) == rounds


@pytest.mark.parametrize("n,want", [(256, (16, 8)), (512, (16, 4)), (1024, (32, 4)),
                                    (2048, (32, 2)), (4096, (32, 1))])
def test_cross_plan_on_ideal_capacity(n, want):
    assert ck.cross_plan(n, _ideal(H100_SMS), D) == want


@pytest.mark.parametrize("n,want", [(256, (16, 4)), (1024, (16, 2)), (2048, (16, 1)),
                                    (4096, (16, 1))])
def test_cross_plan_where_only_16_rows_fit(n, want):
    """At a width whose 32-row tile does not fit (cross_capacity then holds
    no R = 32 entry), the rule plans 16-row tiles only."""
    assert ck.cross_plan(n, _capacity(H100_CLUSTERS, rows=(16,)), 1600) == want


@pytest.mark.parametrize("d", [42, 80, 688])
@pytest.mark.parametrize("sms", [16, 114, 132])
def test_cross_plan_fills_one_wave_with_the_most_blocks(sms, d):
    cap = _ideal(sms)
    for n in range(1, 40 * sms, 37):
        r, c = ck.cross_plan(n, cap, d)
        fitting = {(rr, cc): (-(-n // rr) * cc, -_rounds(rr, cc, d), -rr)
                   for (rr, cc), k in cap.items() if -(-n // rr) <= k}
        if fitting:
            assert (r, c) in fitting
            assert fitting[(r, c)] == max(fitting.values())
        else:
            assert (r, c) == (32, 1)


# ---------------------------------------------------- shared memory


@pytest.mark.parametrize("rows,want", [(16, 91136), (32, 182272)])
def test_cross_block_shared_memory_at_the_serving_width(rows, want):
    """x0 (f32) and two bf16 x buffers of stride 736 per row at d = 688."""
    assert ck.cross_smem_bytes(688, torch.bfloat16, rows) == want
    assert want <= ck.SMEM_LIMIT_BYTES


@pytest.mark.parametrize("d,want", [(42, (16, 32)), (688, (16, 32)), (888, (16, 32)),
                                    (889, (16,)), (1600, (16,))])
def test_32_row_tiles_stop_fitting_past_d_888(d, want):
    assert ck.cross_row_tiles(d) == want
    assert ck.fits_smem(d, torch.bfloat16)  # the 16-row tile fits at all of them


# ------------------------------------------------------------ the cache


KW = dict(num_fields=6, vocab_size=1 << 10, embed_dim=4, mlp_dims=(8,), num_cross_layers=2,
          use_pallas_cross=True)


def _model(compute_dtype="float32", seed=0):
    model = build_model("dcn_v2", ModelConfig(**KW, compute_dtype=compute_dtype))
    return model, model.init(seed, "cpu")


def _batch(n=9, seed=0):
    rng = np.random.RandomState(seed)
    return {"feat_ids": torch.from_numpy(rng.randint(0, 1 << 40, size=(n, 6)).astype(np.int64)),
            "feat_wts": torch.from_numpy(rng.rand(n, 6).astype(np.float32))}


def _plain(model, params, batch):
    """The same forward with the cross stack off the kernel path."""
    plain = build_model("dcn_v2", dataclasses.replace(model.config, use_pallas_cross=False))
    return plain.apply(params, batch)["logits"]


def test_cache_builds_once_for_repeated_model_apply():
    model, params = _model()
    batch = _batch()
    outs = [model.apply(params, batch)["logits"] for _ in range(4)]
    assert ck.cross_cache.builds == 1 and len(ck.cross_cache) == 1
    assert all(torch.equal(o, outs[0]) for o in outs)
    torch.testing.assert_close(outs[0], _plain(model, params, batch), rtol=1e-5, atol=1e-5)


def test_cache_rebuilds_after_an_in_place_update():
    model, params = _model()
    batch = _batch()
    before = model.apply(params, batch)["logits"]
    params["cross"][1]["w"].add_(0.25)
    after = model.apply(params, batch)["logits"]
    assert ck.cross_cache.builds == 2
    assert not torch.equal(after, before)
    torch.testing.assert_close(after, _plain(model, params, batch), rtol=1e-5, atol=1e-5)
    params["cross"][0]["b"].mul_(2.0)  # a bias counts too
    model.apply(params, batch)
    assert ck.cross_cache.builds == 3


def test_cache_rebuilds_after_a_swapped_tensor_or_tree():
    model, params = _model()
    batch = _batch()
    model.apply(params, batch)
    other = model.init(5, "cpu")
    got = model.apply(other, batch)["logits"]
    assert ck.cross_cache.builds == 2
    torch.testing.assert_close(got, _plain(model, other, batch), rtol=1e-5, atol=1e-5)
    model.apply(params, batch)  # the first tree is still cached
    assert ck.cross_cache.builds == 2
    w = params["cross"][0]["w"]
    w.data = w.data * 0.5  # same tensor object, new storage
    got = model.apply(params, batch)["logits"]
    assert ck.cross_cache.builds == 3
    torch.testing.assert_close(got, _plain(model, params, batch), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("first_inside", [True, False])
def test_cache_serves_calls_in_and_out_of_inference_mode(first_inside):
    """The server's first call runs inside torch.inference_mode, tests and
    chip_smoke.py call outside it: either order builds once, and the entry
    holds normal tensors."""
    model, params = _model("bfloat16")
    batch = _batch()
    outs = []
    for inside in (first_inside, not first_inside, first_inside):
        if inside:
            with torch.inference_mode():
                outs.append(model.apply(params, batch)["logits"])
        else:
            outs.append(model.apply(params, batch)["logits"])
    assert ck.cross_cache.builds == 1
    assert all(torch.equal(o, outs[0]) for o in outs)
    cw = ck.cross_weights(params["cross"], torch.bfloat16)
    assert not cw.w.is_inference() and not cw.b.is_inference()
    with torch.inference_mode():
        params["cross"][0]["w"].add_(0.25)  # a normal tensor still counts the update
    model.apply(params, batch)
    assert ck.cross_cache.builds == 2


def test_inference_tensor_sources_are_prepared_every_call_and_never_stored():
    """Inference tensors keep no version counter, so an update could not be
    seen: such weights are never cached."""
    model = build_model("dcn_v2", ModelConfig(**KW, compute_dtype="float32"))
    with torch.inference_mode():
        params = model.init(0, "cpu")
    assert params["cross"][0]["w"].is_inference()
    batch = _batch()
    a = model.apply(params, batch)["logits"]
    b = model.apply(params, batch)["logits"]
    assert ck.cross_cache.builds == 2 and len(ck.cross_cache) == 0
    assert torch.equal(a, b)


def test_cache_is_bounded_least_recently_used_first_out():
    model, _ = _model()
    batch = _batch()
    trees = [model.init(s, "cpu") for s in range(ck.cross_cache.maxsize + 2)]
    for t in trees:
        model.apply(t, batch)
    assert len(ck.cross_cache) == ck.cross_cache.maxsize
    builds = ck.cross_cache.builds
    model.apply(trees[-1], batch)  # still cached
    assert ck.cross_cache.builds == builds
    model.apply(trees[0], batch)  # evicted first
    assert ck.cross_cache.builds == builds + 1
    assert len(ck.cross_cache) == ck.cross_cache.maxsize


def test_fused_cross_apply_goes_through_the_same_cache():
    rng = np.random.RandomState(3)
    x0 = torch.from_numpy(rng.randn(11, 24).astype(np.float32))
    w = torch.from_numpy(rng.randn(2, 24, 24).astype(np.float32) / 5)
    b = torch.from_numpy(rng.randn(2, 24).astype(np.float32))
    got = [ck.fused_cross_apply(x0, w, b, compute_dtype=torch.bfloat16) for _ in range(3)]
    assert ck.cross_cache.builds == 1
    cw = ck.cached_cross_weights(w, b, torch.bfloat16)
    assert cw.w.dtype == torch.bfloat16 and cw.b.dtype == torch.float32
    assert cw.wt is None  # the kernel's layout is made on the card only
    assert ck.cross_cache.builds == 1
    want = ck.cross_stack_reference(x0, w, b, torch.bfloat16)
    assert all(torch.equal(g, want) for g in got)
    ck.fused_cross_apply(x0, w, b, compute_dtype=torch.float32)  # its own entry
    assert ck.cross_cache.builds == 2


def test_prepare_refuses_misshapen_weights():
    with pytest.raises(ValueError, match="expected"):
        ck.prepare_cross_weights(torch.zeros(2, 8, 6), torch.zeros(2, 6), torch.float32)
    with pytest.raises(ValueError, match="expected"):
        ck.prepare_cross_weights(torch.zeros(2, 8, 8), torch.zeros(3, 8), torch.float32)


# ---------------------------------------------------------- forced plans


@pytest.mark.parametrize("plan", [(r, c) for r in ck.ROW_TILES for c in CLUSTERS])
def test_forced_plan_on_cpu_tensors_takes_the_plain_version(plan):
    rng = np.random.RandomState(1)
    x0 = torch.from_numpy(rng.randn(5, 16).astype(np.float32)).to(torch.bfloat16)
    cw = ck.prepare_cross_weights(torch.from_numpy(rng.randn(2, 16, 16).astype(np.float32)),
                                  torch.zeros(2, 16), torch.bfloat16)
    ck.reset_launches()
    got = ck.cross_stack(x0, cw, _plan=plan)
    assert torch.equal(got, ck.cross_stack(x0, cw))
    assert not any(ck.launches.values())


@pytest.mark.parametrize("plan,dtype", [((16, 0), torch.bfloat16), ((24, 1), torch.bfloat16),
                                        ((64, 2), torch.bfloat16), ((24, 1), torch.float32)])
def test_forced_plan_outside_what_the_kernels_take_is_refused(plan, dtype):
    cw = ck.prepare_cross_weights(torch.zeros(1, 8, 8), torch.zeros(1, 8), dtype)
    with pytest.raises(ValueError, match="_plan"):
        ck.cross_stack(torch.zeros(3, 8, dtype=dtype), cw, _plan=plan)


# ------------------------------------------- the model against JAX


@pytest.mark.parametrize("compute_dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_use_pallas_cross_model_matches_jax_interpret(compute_dtype, tol):
    """The port's use_pallas_cross model.apply (cross stack through the
    cached weights) against the JAX model with its Pallas cross kernel in
    interpret mode, twice over the same weights: the second call is a
    cache hit and scores the same."""
    kw = {**KW, "compute_dtype": compute_dtype}
    jm = jax_build("dcn_v2", JaxConfig(**kw))
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(2)))
    tm = build_model("dcn_v2", ModelConfig(**kw))
    tp = params_from_jax(jp, "cpu")
    batch = _batch(n=20, seed=4)
    ids, wts = batch["feat_ids"].numpy(), batch["feat_wts"].numpy()
    want = np.asarray(jm.apply(jp, {"feat_ids": jax_fold(ids, kw["vocab_size"]),
                                    "feat_wts": wts})["prediction_node"]).astype(np.float32)
    for _ in range(2):
        with torch.inference_mode():
            got = tm.apply(tp, batch)["prediction_node"].float().numpy()
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    assert ck.cross_cache.builds == 1


def test_cache_drops_an_entry_when_its_sources_die():
    """An entry never keeps its weights alive: when a tree's tensors go,
    its prepared operands go with them, with no further call."""
    model, _ = _model()
    batch = _batch()
    keep = model.init(1, "cpu")
    gone = model.init(2, "cpu")
    model.apply(keep, batch)
    model.apply(gone, batch)
    assert len(ck.cross_cache) == 2
    src = weakref.ref(gone["cross"][0]["w"])
    del gone
    assert src() is None and len(ck.cross_cache) == 1
    builds = ck.cross_cache.builds
    model.apply(keep, batch)  # the survivor is still served from the cache
    assert ck.cross_cache.builds == builds
