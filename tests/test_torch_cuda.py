"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Marked `cuda`: without an NVIDIA card every test here skips (the kernels
have no CPU mode; their plain versions are held to the JAX package in
tests/test_torch_cross_kernel.py). This file imports nothing of JAX, so on a
machine with the card and without JAX it runs alone:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: fused serve scores (float and int8 weights) 2e-5 (f32) / 5e-3
(bf16), and in f32 bit for bit across cluster sizes; cross stack allclose
rtol = atol = 1e-5 (f32) / 2e-2 (bf16), and bit for bit across its (rows
per block, cluster) plans; the f32 kernels on unit-normal inputs within
twice the plain f32 version's error from float64; the int8 kernel through the batcher 5e-3 against
the quantized model.apply; the readback wire's top-k selection and int8
quantization on the card bit for bit those of the CPU; the other model
families through a batcher on the card 1e-5 from the card's own forward and
2e-5 (f32) / 5e-3 (bf16) from the CPU's, with neither DCN kernel launched
(a bf16 dlrm launches its interaction kernel once); DLRM's interaction
kernel against its plain version (the eager interaction on the card) bit
for bit but where the other order of a dot's f32 sum flips its bf16
rounding (1 bf16 ulp, or within that sum's f32 rounding of zero), its
scores 5e-3 from the CPU forward, one launch per served batch; three
f32 train steps on the card within 1e-5 of the CPU's losses, and a train
step through the cross-stack kernel (no backward) refused before any
launch.
"""

import dataclasses

import numpy as np
import pytest
import torch

from distributed_tf_serving_tpu_torch.models import (
    ModelConfig,
    Servable,
    build_model,
    ctr_signatures,
)
from distributed_tf_serving_tpu_torch.models.embeddings import field_embed
from distributed_tf_serving_tpu_torch.ops import cross_kernel as ck
from distributed_tf_serving_tpu_torch.ops.quantize import quantize_params
from distributed_tf_serving_tpu_torch.serving.batcher import DynamicBatcher
from distributed_tf_serving_tpu_torch.utils.config import KernelsConfig

SERVE_TOL = {"float32": 2e-5, "bfloat16": 5e-3}
CROSS_TOL = {"float32": 1e-5, "bfloat16": 2e-2}

# (fields, embed, mlp): the serving width, a small one, and one whose width,
# embed size and MLP dims are all off the kernels' tile multiples.
SHAPES = [
    (43, 16, (256, 128, 64)),
    (10, 8, (32, 16)),
    (7, 6, (24, 10, 5)),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _setup(dev, compute_dtype, fields, embed, mlp, seed=3):
    cfg = ModelConfig(num_fields=fields, embed_dim=embed, mlp_dims=mlp, vocab_size=1 << 14,
                      num_cross_layers=3, compute_dtype=compute_dtype)
    model = build_model("dcn_v2", cfg)
    params = model.init(seed, dev)
    return cfg, model, params


def _inputs(cfg, n, dev, seed):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, cfg.vocab_size, (n, cfg.num_fields), generator=g,
                        dtype=torch.int32).to(dev)
    wts = torch.rand((n, cfg.num_fields), generator=g).to(dev).to(cfg.cdtype)
    return ids, wts


def _launched() -> dict:
    """The launch counts since the last reset that are not zero, by (wrapper,
    compute dtype)."""
    return {k: v for k, v in ck.launches.items() if v}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 17, 300])
def test_kernels_match_plain_versions_on_card(cuda_device, shape, compute_dtype, n):
    cfg, model, params = _setup(cuda_device, compute_dtype, *shape)
    sw = ck.build_fused_serve(params, cfg).serve_weights
    ids, wts = _inputs(cfg, n, cuda_device, seed=n)
    # The cross stack gets what model.apply hands it: the weighted gather.
    x0 = field_embed(params["embedding"], ids, wts, cfg.cdtype).reshape(n, sw.d)
    ck.reset_launches()
    out = ck.fused_serve(ids, wts, sw)
    xc = ck.fused_cross_apply(x0, sw.wc, sw.bc, compute_dtype=cfg.cdtype)
    torch.cuda.synchronize()
    assert _launched() == {("fused_serve", compute_dtype): 1,
                           ("fused_cross_apply", compute_dtype): 1}
    ref = ck.fused_serve_reference(ids, wts, sw)
    tol = SERVE_TOL[compute_dtype]
    torch.testing.assert_close(out["prediction_node"], ref["prediction_node"], rtol=0, atol=tol)
    assert torch.isfinite(out["logits"]).all()
    ctol = CROSS_TOL[compute_dtype]
    torch.testing.assert_close(xc.float(), ck.cross_stack_reference(
        x0, sw.wc, sw.bc, cfg.cdtype).float(), rtol=ctol, atol=ctol)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 17, 300])
def test_int8_kernel_matches_plain_version_on_card(cuda_device, shape, compute_dtype, n):
    cfg, _, params = _setup(cuda_device, compute_dtype, *shape)
    sw = ck.build_fused_serve(quantize_params(params), cfg).serve_weights
    assert sw.quantized and sw.wc.dtype == torch.int8
    ids, wts = _inputs(cfg, n, cuda_device, seed=n)
    ck.reset_launches()
    out = ck.fused_serve(ids, wts, sw)
    torch.cuda.synchronize()
    assert _launched() == {("fused_serve_int8", compute_dtype): 1}
    ref = ck.fused_serve_reference(ids, wts, sw)
    torch.testing.assert_close(out["prediction_node"], ref["prediction_node"], rtol=0,
                               atol=SERVE_TOL[compute_dtype])
    assert torch.isfinite(out["logits"]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("n", [1, 17, 300])
@pytest.mark.parametrize("quantized", [False, True])
def test_forced_cluster_matches_plain_version_on_card(cuda_device, cluster, shape, n, quantized):
    """The bf16 kernel with each cluster size forced, float and int8
    weights, at widths whose layers leave some ranks no column tile: the
    bits of C = 1 (rank 0 sums the head whole, in C = 1's order), and within
    the bf16 tolerance of the plain version."""
    cfg, _, params = _setup(cuda_device, "bfloat16", *shape)
    sw = ck.build_fused_serve(quantize_params(params) if quantized else params, cfg).serve_weights
    ids, wts = _inputs(cfg, n, cuda_device, seed=n + cluster)
    base = ck.fused_serve(ids, wts, sw, _cluster=1)
    ck.reset_launches()
    out = ck.fused_serve(ids, wts, sw, _cluster=cluster)
    torch.cuda.synchronize()
    assert _launched() == {("fused_serve_int8" if quantized else "fused_serve", "bfloat16"): 1}
    assert torch.equal(out["logits"], base["logits"])
    assert torch.equal(out["prediction_node"], base["prediction_node"])
    ref = ck.fused_serve_reference(ids, wts, sw)
    torch.testing.assert_close(out["prediction_node"], ref["prediction_node"], rtol=0,
                               atol=SERVE_TOL["bfloat16"])
    assert torch.isfinite(out["logits"]).all()


@pytest.mark.cuda
def test_cluster_the_launch_refuses_raises(cuda_device):
    """16 blocks per cluster is over the portable limit the kernel asks for:
    the launch refuses it, the wrapper raises, nothing is counted, and the
    next call (at the rule's size) is unaffected."""
    cfg, _, params = _setup(cuda_device, "bfloat16", 10, 8, (32, 16))
    sw = ck.build_fused_serve(params, cfg).serve_weights
    ids, wts = _inputs(cfg, 40, cuda_device, seed=2)
    ck.reset_launches()
    with pytest.raises(RuntimeError, match="fused-serve kernel launch failed"):
        ck.fused_serve(ids, wts, sw, _cluster=16)
    assert not _launched()
    out = ck.fused_serve(ids, wts, sw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out["prediction_node"],
                               ck.fused_serve_reference(ids, wts, sw)["prediction_node"],
                               rtol=0, atol=SERVE_TOL["bfloat16"])


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [None, 1, 8])
def test_launch_counter_counts_one_per_call_at_any_cluster(cuda_device, cluster):
    cfg, _, params = _setup(cuda_device, "bfloat16", 10, 8, (32, 16))
    sw = ck.build_fused_serve(params, cfg).serve_weights
    ids, wts = _inputs(cfg, 64, cuda_device, seed=3)
    ck.reset_launches()
    for _ in range(3):
        ck.fused_serve(ids, wts, sw, _cluster=cluster)
    torch.cuda.synchronize()
    assert _launched() == {("fused_serve", "bfloat16"): 3}


@pytest.mark.cuda
def test_cluster_rule_and_occupancy_on_card(cuda_device):
    """The card holds one serving block per SM and clusters of 8 of them,
    and the rule on this card's capacity never asks for a second wave."""
    cfg, _, params = _setup(cuda_device, "bfloat16", 43, 16, (256, 128, 64))
    sw = ck.build_fused_serve(params, cfg).serve_weights
    cap = ck.serve_capacity(sw)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert cap[0] >= sms and cap[3] >= 1
    assert list(cap) == sorted(cap, reverse=True)
    for n in (1, 256, 512, 1024, 2048):
        c = ck.serve_cluster(n, cap)
        assert c == 1 or -(-n // ck.ROWS_PER_BLOCK) <= cap[ck.CLUSTER_SIZES.index(c)]


PLANS = [(r, c) for r in ck.ROW_TILES for c in (1, 2, 4, 8)]


def _cross_case(dev, fields, embed, n, seed):
    """The cross stack's inputs as model.apply hands them over: the seeded
    demo weights (cached operands) and the bf16 weighted field gather."""
    cfg, _, params = _setup(dev, "bfloat16", fields, embed, (16,), seed=seed)
    cw = ck.cross_weights(params["cross"], cfg.cdtype)
    ids, wts = _inputs(cfg, n, dev, seed=seed + n)
    x0 = field_embed(params["embedding"], ids, wts, cfg.cdtype).reshape(n, cw.d)
    return cw, x0


@pytest.mark.cuda
@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("n", [1, 17, 300])
def test_forced_cross_plan_is_bit_identical_on_card(cuda_device, plan, shape, n):
    """The bf16 cross stack at every forced (R, C), at widths where some
    ranks own no column tile (d = 42: 6 tiles for up to 8 ranks): the same
    bits as (16, 1), since every element's k order is the same, and within
    2e-2 of the plain version."""
    cw, x0 = _cross_case(cuda_device, shape[0], shape[1], n, seed=7)
    base = ck.cross_stack(x0, cw, _plan=(16, 1))
    ck.reset_launches()
    got = ck.cross_stack(x0, cw, _plan=plan)
    torch.cuda.synchronize()
    assert _launched() == {("fused_cross_apply", "bfloat16"): 1}
    assert torch.equal(got, base)
    tol = CROSS_TOL["bfloat16"]
    torch.testing.assert_close(got.float(), ck.cross_stack_reference(
        x0, cw.w, cw.b, torch.bfloat16).float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_cross_cluster_the_launch_refuses_raises(cuda_device):
    """A cluster of 16 cross-stack blocks is over the portable limit: the
    launch refuses it, the wrapper raises and counts nothing, and the next
    call at the rule's plan is unaffected."""
    cw, x0 = _cross_case(cuda_device, 10, 8, 40, seed=2)
    ck.reset_launches()
    with pytest.raises(RuntimeError, match="cross-stack kernel launch failed"):
        ck.cross_stack(x0, cw, _plan=(16, 16))
    assert not _launched()
    got = ck.cross_stack(x0, cw)
    torch.cuda.synchronize()
    assert torch.equal(got, ck.cross_stack(x0, cw, _plan=(16, 1)))


@pytest.mark.cuda
def test_cross_plan_never_takes_a_second_wave_on_card(cuda_device):
    """At the serving width both row tiles fit and the card holds one
    cross-stack block per SM; the rule's plan at every bucket fits one wave."""
    cw, _ = _cross_case(cuda_device, 43, 16, 1, seed=0)
    cap = ck.cross_capacity(cw)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert set(cap) == {(r, c) for r in (16, 32) for c in (1, 2, 4, 8)}
    assert cap[(16, 1)] >= sms and cap[(32, 1)] >= sms and cap[(32, 8)] >= 1
    for n in (1, 7, 256, 300, 512, 1000, 1024, 2048):
        r, c = ck.cross_plan(n, cap, cw.d)
        assert -(-n // r) <= cap[(r, c)], (n, r, c)


@pytest.mark.cuda
@pytest.mark.parametrize("plan", [None, (16, 1), (32, 8)])
def test_cross_launch_counter_counts_one_per_call(cuda_device, plan):
    cw, x0 = _cross_case(cuda_device, 10, 8, 64, seed=3)
    ck.reset_launches()
    for _ in range(3):
        ck.cross_stack(x0, cw, _plan=plan)
    torch.cuda.synchronize()
    assert _launched() == {("fused_cross_apply", "bfloat16"): 3}


@pytest.mark.cuda
def test_warm_cross_call_launches_the_kernel_alone(cuda_device):
    """With the weight operands cached, one fused_cross_apply call runs one
    device kernel: no stack, cast, zero-fill or copy kernels."""
    from torch.profiler import ProfilerActivity, profile

    cfg, _, params = _setup(cuda_device, "bfloat16", 43, 16, (256, 128, 64))
    sw = ck.build_fused_serve(params, cfg).serve_weights
    ids, wts = _inputs(cfg, 256, cuda_device, seed=1)
    x0 = field_embed(params["embedding"], ids, wts, cfg.cdtype).reshape(256, sw.d)
    builds = ck.cross_cache.builds
    ck.fused_cross_apply(x0, sw.wc, sw.bc, compute_dtype=cfg.cdtype)  # warm
    torch.cuda.synchronize()
    calls = 5
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            ck.fused_cross_apply(x0, sw.wc, sw.bc, compute_dtype=cfg.cdtype)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    # The tracer may drop events of a window, never add any: every device
    # event is the kernel, at most one per call.
    assert 1 <= len(names) <= calls, names
    assert all("cross_stack_bf16_kernel" in nm for nm in names), names
    assert ck.cross_cache.builds == builds + 1


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("n", [1, 17, 300])
@pytest.mark.parametrize("quantized", [False, True])
def test_forced_f32_cluster_is_bit_identical_on_card(cuda_device, cluster, shape, n, quantized):
    """The f32 (split-TF32) fused serve kernel with each cluster size
    forced, float and int8 weights: the bits of C = 1 (every element's k
    order is the same at any C), and within 2e-5 of the plain version."""
    cfg, _, params = _setup(cuda_device, "float32", *shape)
    sw = ck.build_fused_serve(quantize_params(params) if quantized else params, cfg).serve_weights
    ids, wts = _inputs(cfg, n, cuda_device, seed=n + cluster)
    base = ck.fused_serve(ids, wts, sw, _cluster=1)
    ck.reset_launches()
    out = ck.fused_serve(ids, wts, sw, _cluster=cluster)
    torch.cuda.synchronize()
    assert _launched() == {("fused_serve_int8" if quantized else "fused_serve", "float32"): 1}
    assert torch.equal(out["logits"], base["logits"])
    assert torch.equal(out["prediction_node"], base["prediction_node"])
    ref = ck.fused_serve_reference(ids, wts, sw)
    torch.testing.assert_close(out["prediction_node"], ref["prediction_node"], rtol=0,
                               atol=SERVE_TOL["float32"])


def _f32_cross_case(dev, fields, embed, n, seed):
    cfg, _, params = _setup(dev, "float32", fields, embed, (16,), seed=seed)
    cw = ck.cross_weights(params["cross"], cfg.cdtype)
    ids, wts = _inputs(cfg, n, dev, seed=seed + n)
    x0 = field_embed(params["embedding"], ids, wts, cfg.cdtype).reshape(n, cw.d)
    return cw, x0


@pytest.mark.cuda
@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("n", [1, 17, 300])
def test_forced_f32_cross_plan_is_bit_identical_on_card(cuda_device, plan, shape, n):
    """The f32 cross stack at every forced (R, C): the bits of (16, 1) and
    within 1e-5 of the plain version."""
    cw, x0 = _f32_cross_case(cuda_device, shape[0], shape[1], n, seed=7)
    base = ck.cross_stack(x0, cw, _plan=(16, 1))
    ck.reset_launches()
    got = ck.cross_stack(x0, cw, _plan=plan)
    torch.cuda.synchronize()
    assert _launched() == {("fused_cross_apply", "float32"): 1}
    assert torch.equal(got, base)
    tol = CROSS_TOL["float32"]
    torch.testing.assert_close(got, ck.cross_stack_reference(x0, cw.w, cw.b, torch.float32),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["fused_serve", "fused_cross_apply"])
def test_f32_cluster_the_launch_refuses_raises(cuda_device, kernel):
    """A cluster of 16 f32 blocks is over the portable limit: the launch
    refuses it, the wrapper raises and counts nothing, as for bf16."""
    cfg, _, params = _setup(cuda_device, "float32", 10, 8, (32, 16))
    ids, wts = _inputs(cfg, 40, cuda_device, seed=2)
    ck.reset_launches()
    if kernel == "fused_serve":
        sw = ck.build_fused_serve(params, cfg).serve_weights
        with pytest.raises(RuntimeError, match="fused-serve kernel launch failed"):
            ck.fused_serve(ids, wts, sw, _cluster=16)
    else:
        cw, x0 = _f32_cross_case(cuda_device, 10, 8, 40, seed=2)
        with pytest.raises(RuntimeError, match="cross-stack kernel launch failed"):
            ck.cross_stack(x0, cw, _plan=(16, 16))
    assert not _launched()


def _cross_f64(x0, w, b, s=None):
    x0 = x0.double()
    x = x0
    for l in range(w.shape[0]):
        xw = x @ w[l].double()
        if s is not None:
            xw = xw * s[l].double()
        x = x0 * (xw + b[l].double()) + x
    return x


def _serve_f64(ids, wts, sw):
    n = ids.shape[0]
    x0 = (sw.table[ids.long()].double() * wts.double()[..., None]).reshape(n, sw.d)
    h = x0
    for m, (w, b) in enumerate(sw.mlp):
        y = h @ w.double()
        if sw.ms is not None:
            y = y * sw.ms[m].double()
        h = torch.relu(y + b.double())
    xc = _cross_f64(x0, sw.wc, sw.bc, sw.sc)
    return xc @ sw.wo[:sw.d].double() + h @ sw.wo[sw.d:].double() + sw.bo[0].double()


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["fused_cross_apply", "fused_serve", "fused_serve_int8"])
@pytest.mark.parametrize("n", [256, 2048])
def test_f32_kernels_keep_f32_accuracy_on_unit_normal_inputs(cuda_device, kernel, n):
    """At the serving width on unit-normal inputs (x0, or the embedding
    table), where an f32 sum is itself far from the truth, the split-TF32
    kernel's max error from float64 is at most twice the plain f32
    version's (cuBLAS in full f32), the rule the CPU emulation is held to.
    The plain version with TF32 matmuls misses that rule, so it tells a
    kernel that lost the split's accuracy from one that kept it."""
    cfg, _, params = _setup(cuda_device, "float32", 43, 16, (256, 128, 64))
    g = torch.Generator().manual_seed(n)
    if kernel == "fused_cross_apply":
        cw = ck.cross_weights(params["cross"], torch.float32)
        x0 = torch.randn((n, cw.d), generator=g).to(cuda_device)
        truth = _cross_f64(x0, cw.w, cw.b)
        run = lambda: ck.cross_stack(x0, cw)  # noqa: E731
        plain = lambda: ck.cross_stack_reference(x0, cw.w, cw.b, torch.float32)  # noqa: E731
    else:
        tree = quantize_params(params) if kernel == "fused_serve_int8" else params
        sw = ck.build_fused_serve(tree, cfg).serve_weights
        sw = dataclasses.replace(sw, table=torch.randn(sw.table.shape, generator=g).to(cuda_device))
        ids, wts = _inputs(cfg, n, cuda_device, seed=n)
        truth = _serve_f64(ids, wts, sw)
        run = lambda: ck.fused_serve(ids, wts, sw)["logits"]  # noqa: E731
        plain = lambda: ck.fused_serve_reference(ids, wts, sw)["logits"]  # noqa: E731
    mm = torch.backends.cuda.matmul
    prev = mm.allow_tf32
    try:
        mm.allow_tf32 = False
        err = (run().double() - truth).abs().max().item()
        plain_err = (plain().double() - truth).abs().max().item()
        mm.allow_tf32 = True
        tf32_err = (plain().double() - truth).abs().max().item()
    finally:
        mm.allow_tf32 = prev
    assert err <= 2 * plain_err, (err, plain_err)
    assert tf32_err > 2 * plain_err, (tf32_err, plain_err)


@pytest.mark.cuda
def test_f32_cluster_rule_and_occupancy_on_card(cuda_device):
    """The f32 kernels hold one block per SM and clusters of 8 of them, and
    their rules on this card's capacity never ask for a second wave."""
    cfg, _, params = _setup(cuda_device, "float32", 43, 16, (256, 128, 64))
    sw = ck.build_fused_serve(params, cfg).serve_weights
    cw = ck.cross_weights(params["cross"], cfg.cdtype)
    cap, ccap = ck.serve_capacity(sw), ck.cross_capacity(cw)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert cap[0] >= sms and cap[3] >= 1 and set(ccap) == set(PLANS)
    assert ccap[(16, 1)] >= sms and ccap[(32, 1)] >= sms
    for n in (1, 256, 512, 1024, 2048):
        c = ck.serve_cluster(n, cap)
        assert c == 1 or -(-n // ck.ROWS_PER_BLOCK) <= cap[ck.CLUSTER_SIZES.index(c)]
        r, cc = ck.cross_plan(n, ccap, cw.d)
        assert -(-n // r) <= ccap[(r, cc)]


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    cfg, _, params = _setup(cuda_device, "bfloat16", 10, 8, (32, 16))
    sw = ck.build_fused_serve(params, cfg).serve_weights
    ids, wts = _inputs(cfg, 4, cuda_device, seed=0)
    with pytest.raises(ValueError, match="dtype"):
        ck.fused_serve(ids.long(), wts, sw)
    with pytest.raises(ValueError, match="shape"):
        ck.fused_serve(ids[:, :5].contiguous(), wts[:, :5].contiguous(), sw)
    with pytest.raises(ValueError, match="contiguous"):
        ck.fused_serve(ids.t().contiguous().t(), wts, sw)


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_batcher_serves_dcn_v2_through_the_fused_kernel(cuda_device, compute_dtype):
    cfg, model, params = _setup(cuda_device, compute_dtype, 10, 8, (32, 16))
    sv = Servable(name="DCN", version=1, model=model, params=params,
                  signatures=ctr_signatures(cfg.num_fields))
    batcher = DynamicBatcher(buckets=(16, 64), max_wait_us=0, device=cuda_device)
    batcher.warmup(sv)
    batcher.start()
    rng = np.random.RandomState(0)
    arrays = {"feat_ids": rng.randint(0, 1 << 40, size=(37, 10)).astype(np.int64),
              "feat_wts": rng.rand(37, 10).astype(np.float32)}
    try:
        ck.reset_launches()
        got = batcher.submit(sv, arrays).result(60)["prediction_node"]
    finally:
        batcher.stop()
    assert ck.launches["fused_serve", compute_dtype] == 1 and batcher.stats.fused_batches >= 1
    want = model.apply(params, {k: torch.from_numpy(v).to(cuda_device)
                                for k, v in arrays.items()})["prediction_node"].cpu().numpy()
    assert got.shape == (37,)
    assert np.max(np.abs(got - want)) <= SERVE_TOL[compute_dtype]


@pytest.mark.cuda
def test_use_pallas_cross_model_runs_the_cross_kernel(cuda_device):
    cfg, model, params = _setup(cuda_device, "bfloat16", 43, 16, (256, 128, 64))
    fused = build_model("dcn_v2", dataclasses.replace(cfg, use_pallas_cross=True))
    ids, wts = _inputs(cfg, 50, cuda_device, seed=5)
    batch = {"feat_ids": ids, "feat_wts": wts}
    ck.reset_launches()
    got = fused.apply(params, batch)["prediction_node"]
    torch.cuda.synchronize()
    assert ck.launches["fused_cross_apply", "bfloat16"] == 1
    want = model.apply(params, batch)["prediction_node"]
    torch.testing.assert_close(got, want, rtol=0, atol=5e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_kernels_plane_batcher_launches_the_int8_kernel(cuda_device, compute_dtype):
    """An armed plane's pallas_int8 entry (the override the autotune and
    chip_smoke.py use) launches the int8 kernel and scores within 5e-3 of
    model.apply on the quantized tree."""
    cfg, model, params = _setup(cuda_device, compute_dtype, 10, 8, (32, 16))
    sv = Servable(name="DCN", version=1, model=model, params=params,
                  signatures=ctr_signatures(cfg.num_fields))
    batcher = DynamicBatcher(buckets=(16, 64), max_wait_us=0, device=cuda_device)
    batcher.kernels = KernelsConfig(enabled=True, table_file="").build()
    rng = np.random.RandomState(1)
    arrays = {"feat_ids": rng.randint(0, 1 << 40, size=(64, 10)).astype(np.int64),
              "feat_wts": rng.rand(64, 10).astype(np.float32)}
    ck.reset_launches()
    got = batcher._execute(sv, arrays, ("prediction_node",),
                           _kernel_override=(True, True))["prediction_node"]
    assert _launched() == {("fused_serve_int8", compute_dtype): 1}
    want = model.apply(quantize_params(params), {
        k: torch.from_numpy(v).to(cuda_device) for k, v in arrays.items()
    })["prediction_node"].float().cpu().numpy()
    assert got.shape == (64,)
    assert np.max(np.abs(got - want)) <= 5e-3


@pytest.mark.cuda
def test_failing_kernel_stops_build_stack_on_card(cuda_device, monkeypatch):
    """A fused variant that fails in the load-time autotune makes
    build_stack raise on the card: the server does not start on a quiet
    fallback to model.apply."""
    from distributed_tf_serving_tpu_torch.ops.autotune import KernelManager
    from distributed_tf_serving_tpu_torch.serving.server import build_stack
    from distributed_tf_serving_tpu_torch.utils.config import ServerConfig

    def boom(params, batch):
        raise RuntimeError("kernel launch failed")

    real = KernelManager.pallas_apply_for
    monkeypatch.setattr(KernelManager, "pallas_apply_for",
                        lambda self, sv, quantized: boom if quantized else real(self, sv, quantized))
    cfg = ServerConfig(num_fields=10, buckets=(16,), max_wait_us=0)
    mc = ModelConfig(num_fields=10, embed_dim=8, mlp_dims=(32, 16), vocab_size=1 << 14,
                     num_cross_layers=3)
    with pytest.raises(RuntimeError, match="kernel variant pallas_int8 failed"):
        build_stack(cfg, mc, "cuda", kernels_config=KernelsConfig(enabled=True, table_file=""))


@pytest.mark.cuda
@pytest.mark.parametrize("fused_kernel", [True, False])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_pipelined_pinned_ring_is_bit_identical_to_the_per_key_path(cuda_device, compute_dtype,
                                                                    fused_kernel):
    """64 distinct batches back to back through a depth-2 pipeline whose
    ring keeps two pinned buffers per size: each result must have the bits
    of the same batch on the per-key synchronous path. A pinned buffer
    rewritten while its copy is in flight would hand a batch another's
    inputs. One request fills the one bucket, so no batch coalesces and
    each is the per-key batch exactly. fused_kernel=False serves through
    model.apply instead of the fused serve kernel. The device input cache
    is off: the test is about the pack and the pinned ring themselves."""
    cfg, model, params = _setup(cuda_device, compute_dtype, 43, 16, (256, 128, 64))
    sv = Servable(name="DCN", version=1, model=model, params=params,
                  signatures=ctr_signatures(cfg.num_fields))
    n = 256
    batcher = DynamicBatcher(buckets=(n,), max_wait_us=0, device=cuda_device, pipeline_depth=2,
                             completion_workers=4, fused_kernel=fused_kernel,
                             queue_capacity_candidates=64 * n, input_cache_entries=0)
    batcher.ring.per_size = 2
    batcher.warmup(sv)
    rng = np.random.RandomState(7)
    payloads = [{"feat_ids": rng.randint(0, 1 << 40, size=(n, 43)).astype(np.int64),
                 "feat_wts": rng.rand(n, 43).astype(np.float32)} for _ in range(64)]
    want = [batcher._execute(sv, p, ("prediction_node",), _per_key=True)["prediction_node"]
            for p in payloads]
    before = dataclasses.replace(batcher.stats)
    batcher.start()
    try:
        futs = [batcher.submit(sv, p, output_keys=("prediction_node",)) for p in payloads]
        got = [f.result(120)["prediction_node"] for f in futs]
    finally:
        batcher.stop()
    bad = [i for i, (g, w) in enumerate(zip(got, want)) if not np.array_equal(g, w)]
    assert not bad, f"batches {bad} differ from the per-key path"
    s = batcher.stats
    assert s.batches == 64 and s.h2d_copies - before.h2d_copies == 64
    assert s.native_packs - before.native_packs == (64 if compute_dtype == "bfloat16" else 0)
    assert batcher.ring.snapshot()["reuses"] > 0
    assert s.readback_overlap_fraction > 0


# -------------------------------------------------------- the readback wire

# (scores, n_valid, k), ties included: on the CPU the port's top-k indices
# equal jax.lax.top_k's (tests/test_torch_outputs.py); here the card's must
# equal the CPU's.
_TOPK_CASES = [
    (np.array([.5, .7, .7, .1, .7, .5], np.float32), 6, 4),
    (np.full(2048, 0.25, np.float32), 2000, 100),
    (np.round(np.random.RandomState(1).rand(2048), 2).astype(np.float32), 2048, 100),
    (np.random.RandomState(2).rand(256).astype(np.float32), 200, 100),
]


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("case", range(len(_TOPK_CASES)))
def test_topk_on_the_card_selects_as_on_the_cpu(cuda_device, case, wire):
    from distributed_tf_serving_tpu_torch.ops.transfer import output_wire_dtype, topk_compact_device

    scores, n_valid, k = _TOPK_CASES[case]
    wdt = output_wire_dtype(wire)
    cpu = topk_compact_device(torch.from_numpy(scores), n_valid, k, wdt)
    card = topk_compact_device(torch.from_numpy(scores).to(cuda_device), n_valid, k, wdt)
    assert torch.equal(card["topk_indices"].cpu(), cpu["topk_indices"])
    assert torch.equal(card["topk_scores"].cpu(), cpu["topk_scores"])
    want = np.argsort(-np.where(np.arange(len(scores)) < n_valid, scores, -np.inf),
                      kind="stable")[:k]
    np.testing.assert_array_equal(card["topk_indices"].cpu().numpy(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 256, 2048])
def test_int8_wire_on_the_card_is_bit_identical_to_the_cpu(cuda_device, n):
    from distributed_tf_serving_tpu_torch.ops.transfer import quantize_output_device

    rng = np.random.RandomState(n)
    for v in (rng.rand(n).astype(np.float32), (rng.randn(n) * 4).astype(np.float32),
              np.full(n, 0.375, np.float32)):
        cpu = quantize_output_device(torch.from_numpy(v))
        card = quantize_output_device(torch.from_numpy(v).to(cuda_device))
        for a, b in zip(card, cpu):
            assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["wide_deep", "deepfm", "generic", "two_tower", "dlrm"])
def test_family_on_the_card_matches_the_cpu_forward(cuda_device, kind, compute_dtype):
    """The other families at the serving width (43 x 16, MLP 256/128/64)
    through a batcher on the card: scores within 1e-5 of the card's own
    model.apply on the same padded batch (the batcher adds no arithmetic),
    within 2e-5 (f32) / 5e-3 (bf16) of the CPU forward of the same params,
    and neither DCN kernel launched (they serve dcn_v2 alone); a bf16 dlrm
    runs its interaction kernel, once for the one batch."""
    cfg = ModelConfig(num_fields=43, embed_dim=16, mlp_dims=(256, 128, 64), vocab_size=1 << 14,
                      compute_dtype=compute_dtype)
    model = build_model(kind, cfg)
    params = model.init(3, "cpu")  # the seed's numpy draws: the same values on either device
    dense = cfg.num_dense_features if kind == "dlrm" else None
    sv = Servable(name="FAM", version=1, model=model, params=model.init(3, cuda_device),
                  signatures=ctr_signatures(cfg.num_fields, with_dense=dense))
    rng = np.random.RandomState(4)
    arrays = {"feat_ids": rng.randint(0, 1 << 40, size=(300, 43)).astype(np.int64),
              "feat_wts": rng.rand(300, 43).astype(np.float32)}
    if dense:
        arrays["dense_features"] = rng.randn(300, dense).astype(np.float32)
    batcher = DynamicBatcher(buckets=(64, 512), max_wait_us=0, device=cuda_device)
    batcher.warmup(sv)
    batcher.start()
    try:
        ck.reset_launches()
        got = batcher.submit(sv, arrays).result(60)["prediction_node"]
        launched = _launched()
    finally:
        batcher.stop()
    want = ({("dlrm_interact", "bfloat16"): 1}
            if kind == "dlrm" and compute_dtype == "bfloat16" else {})
    assert launched == want and batcher.stats.fused_batches == 0
    padded = {k: np.concatenate([v, np.zeros((512 - 300,) + v.shape[1:], v.dtype)])
              for k, v in arrays.items()}
    with torch.inference_mode():
        card = model.apply(sv.params, {k: torch.from_numpy(v).to(cuda_device)
                                       for k, v in padded.items()})["prediction_node"]
        cpu = model.apply(params, {k: torch.from_numpy(v) for k, v in arrays.items()})
    card = card.float().cpu().numpy()[:300]
    assert got.shape == (300,) and np.all(np.isfinite(got))
    assert np.max(np.abs(got - card)) <= 1e-5
    tol = 2e-5 if compute_dtype == "float32" else 5e-3
    assert np.max(np.abs(got - cpu["prediction_node"].float().numpy())) <= tol


# --------------------------------------------------- DLRM's interaction

DLRM_SHAPES = [(26, 128), (43, 16), (5, 12)]  # MLPerf, the families' width, off the tiles


def _dlrm_operands(dev, fields, embed, n, seed, id_dtype, wts_dtype,
                   table_dtype=torch.float32):
    """A table of 2^16 rows, ids of either dtype (int32 of any sign: the
    kernel folds them; int64 over [0, 2^40)), weights, a bottom output."""
    g = torch.Generator().manual_seed(seed)
    table = (torch.randn((1 << 16, embed), generator=g) / embed ** 0.5).to(table_dtype).to(dev)
    if id_dtype == torch.int32:
        ids = torch.randint(-(1 << 31), (1 << 31) - 1, (n, fields), generator=g,
                            dtype=torch.int32)
    else:
        ids = torch.randint(0, 1 << 40, (n, fields), generator=g, dtype=torch.int64)
    wts = torch.rand((n, fields), generator=g).to(wts_dtype)
    bottom = torch.relu(torch.randn((n, embed), generator=g))
    return ids.to(dev), wts.to(dev), table, bottom.to(dev)


def _ordered(bits: torch.Tensor) -> torch.Tensor:
    """bf16 bit patterns as integers that count ulps across zero."""
    b = bits.to(torch.int32) & 0xFFFF
    return torch.where(b >= 0x8000, 0x8000 - b, b)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", DLRM_SHAPES)
@pytest.mark.parametrize("n", [1, 17, 2048])
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("wts_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16])
def test_dlrm_interaction_kernel_matches_its_plain_version_on_card(cuda_device, shape, n,
                                                                   id_dtype, wts_dtype,
                                                                   table_dtype):
    """For an f32 table and a bf16 one (bf16 params), and weights the
    wrapper rounds to bf16 or takes as they are, the top MLP's input: the
    bottom output's bf16 bits, and each pair's
    bits, except where the kernel's order of a dot's f32 sum (16-deep mma
    steps) and the eager bmm's round to neighbouring bf16 values: then 1
    bf16 ulp apart, or apart by less than two f32 orders of that sum can
    differ (D * 2^-23 * sum |z_i z_j|: a sum within its own rounding of
    zero has no ulp to keep)."""
    from distributed_tf_serving_tpu_torch.models.embeddings import field_embed
    from distributed_tf_serving_tpu_torch.ops import dlrm_kernel as dk

    fields, embed = shape
    ids, wts, table, bottom = _dlrm_operands(cuda_device, fields, embed, n, n + fields,
                                             id_dtype, wts_dtype, table_dtype)
    ck.reset_launches()
    got = dk.dlrm_interact(ids, wts, table, bottom)
    assert _launched() == {("dlrm_interact", "bfloat16"): 1}
    want = dk.dlrm_interact_reference(ids, wts, table, bottom)
    assert got.dtype == want.dtype == torch.bfloat16
    assert got.shape == want.shape == (n, dk.interact_width(fields, embed))
    assert torch.equal(got[:, :embed], want[:, :embed])
    z = torch.cat([bottom[:, None, :].to(torch.bfloat16),
                   field_embed(table, ids, wts, torch.bfloat16)], dim=1).float().abs()
    nf = fields + 1
    mass = torch.bmm(z, z.transpose(1, 2)).reshape(n, nf * nf)[:, dk._pairs(nf, z.device)]
    a, b = got[:, embed:], want[:, embed:]
    ulps = (_ordered(a.view(torch.int16)) - _ordered(b.view(torch.int16))).abs()
    near_zero = (a.float() - b.float()).abs() <= embed * 2.0 ** -23 * mass
    assert bool(((ulps <= 1) | near_zero).all()), int(ulps.max())
    assert int((ulps != 0).sum()) <= max(1, a.numel() // 100)  # flips are rare


@pytest.mark.cuda
def test_dlrm_model_on_the_card_routes_its_interaction_to_the_kernel(cuda_device):
    """A bf16 DLRM at the MLPerf widths: model.apply on the card launches
    the interaction kernel once and scores within 5e-3 of the CPU's eager
    forward (bf16 operands; the dots' and the products' f32 sums in other
    orders); in f32, or where autograd records, the eager interaction runs
    (no launch)."""
    cfg = ModelConfig(name="DLRM", num_fields=26, embed_dim=128, vocab_size=1 << 16,
                      num_dense_features=13, bottom_mlp_dims=(512, 256, 128),
                      mlp_dims=(1024, 1024, 512, 256), compute_dtype="bfloat16")
    model = build_model("dlrm", cfg)
    rng = np.random.RandomState(9)
    batch = {"feat_ids": rng.randint(0, 1 << 40, size=(300, 26)).astype(np.int64),
             "feat_wts": np.ones((300, 26), np.float32),
             "dense_features": np.log1p(rng.lognormal(1.0, 1.5, (300, 13))).astype(np.float32)}
    params = model.init(3, cuda_device)  # outside inference mode: trained below
    with torch.inference_mode():
        cpu = model.apply(model.init(3, "cpu"), {k: torch.from_numpy(v) for k, v in batch.items()})
        ck.reset_launches()
        card = model.apply(params, {k: torch.from_numpy(v).to(cuda_device)
                                    for k, v in batch.items()})
        assert _launched() == {("dlrm_interact", "bfloat16"): 1}
    diff = (card["prediction_node"].cpu() - cpu["prediction_node"]).abs().max()
    assert float(diff) <= 5e-3
    ck.reset_launches()
    f32 = build_model("dlrm", dataclasses.replace(cfg, compute_dtype="float32"))
    with torch.inference_mode():
        f32.apply(params, {k: torch.from_numpy(v).to(cuda_device) for k, v in batch.items()})
    trained = {"embedding": params["embedding"].clone().requires_grad_(True),
               **{k: v for k, v in params.items() if k != "embedding"}}
    out = model.apply(trained, {k: torch.from_numpy(v).to(cuda_device) for k, v in batch.items()})
    out["prediction_node"].sum().backward()
    assert _launched() == {} and trained["embedding"].grad is not None


@pytest.mark.cuda
def test_served_dlrm_batches_launch_the_interaction_kernel_once_each(cuda_device, monkeypatch):
    """DLRM at the MLPerf widths on a table of 2^24 + 1 rows (int32 ids in
    the combined buffer) through a batcher on the card: one interaction
    launch per served batch, the eager interaction never called, no native
    pack, and each request's scores the card's own model.apply's on its
    padded batch."""
    from distributed_tf_serving_tpu_torch.ops import dlrm_kernel as dk
    from distributed_tf_serving_tpu_torch.ops.transfer import U24_MAX

    cfg = ModelConfig(name="DLRM", num_fields=26, embed_dim=128, vocab_size=U24_MAX + 1,
                      num_dense_features=13, bottom_mlp_dims=(512, 256, 128),
                      mlp_dims=(1024, 1024, 512, 256), compute_dtype="bfloat16")
    model = build_model("dlrm", cfg)
    small = build_model("dlrm", dataclasses.replace(cfg, vocab_size=16)).init(3, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    table = torch.randn((cfg.vocab_size, 128), generator=g, device=cuda_device) / 128 ** 0.5
    params = dict(small, embedding=table)
    sv = Servable(name="DLRM", version=1, model=model, params=params,
                  signatures=ctr_signatures(26, with_dense=13))
    batcher = DynamicBatcher(buckets=(256, 512, 1024), max_wait_us=0, device=cuda_device)
    batcher.warmup(sv)
    batcher.start()
    rng = np.random.RandomState(5)
    requests = []
    for n in (100, 300, 700):
        requests.append({
            "feat_ids": rng.randint(0, 1 << 40, size=(n, 26)).astype(np.int64),
            "feat_wts": np.ones((n, 26), np.float32),
            "dense_features": np.log1p(rng.lognormal(1.0, 1.5, (n, 13))).astype(np.float32)})
    requests[0]["feat_ids"][0, :2] = [U24_MAX, 2 * U24_MAX]  # the last row, and row 2^24 - 1

    def eager(*_a, **_k):
        raise AssertionError("the eager interaction ran on the card")

    monkeypatch.setattr(dk, "interact_eager", eager)
    try:
        ck.reset_launches()
        before = dataclasses.replace(batcher.stats)
        got = [batcher.submit(sv, r).result(120)["prediction_node"] for r in requests]
        launched = _launched()
        batches = batcher.stats.batches - before.batches
    finally:
        batcher.stop()
    assert batches == 3 and launched == {("dlrm_interact", "bfloat16"): 3}
    assert batcher.stats.native_packs == before.native_packs
    for r, scores in zip(requests, got):
        n = r["feat_ids"].shape[0]
        bucket = next(b for b in (256, 512, 1024) if b >= n)
        padded = {k: np.concatenate([v, np.zeros((bucket - n,) + v.shape[1:], v.dtype)])
                  for k, v in r.items()}
        padded["feat_ids"] = np.remainder(padded["feat_ids"], cfg.vocab_size).astype(np.int32)
        with torch.inference_mode():
            want = model.apply(params, {k: torch.from_numpy(v).to(cuda_device)
                                        for k, v in padded.items()})["prediction_node"]
        np.testing.assert_array_equal(scores, want.float().cpu().numpy()[:n])


@pytest.mark.cuda
def test_dlrm_interaction_route_is_fixed_when_the_servable_loads(cuda_device):
    """bf16 params (a bf16 table) serve through the kernel, one launch a
    batch; a bf16 model the kernel cannot take (64 fields) is refused when
    it loads, and its model.apply on the card raises rather than running
    the eager interaction."""
    cfg = ModelConfig(name="DLRM", num_fields=8, embed_dim=16, vocab_size=1 << 12,
                      num_dense_features=13, bottom_mlp_dims=(32, 16), mlp_dims=(64, 32),
                      compute_dtype="bfloat16", param_dtype="bfloat16")
    model = build_model("dlrm", cfg)
    params = model.init(3, cuda_device)
    assert params["embedding"].dtype == torch.bfloat16
    sv = Servable(name="DLRM", version=1, model=model, params=params,
                  signatures=ctr_signatures(8, with_dense=13))
    batcher = DynamicBatcher(buckets=(64, 256), max_wait_us=0, device=cuda_device)
    batcher.warmup(sv)
    batcher.start()
    rng = np.random.RandomState(6)
    arrays = {"feat_ids": rng.randint(0, 1 << 40, size=(100, 8)).astype(np.int64),
              "feat_wts": rng.rand(100, 8).astype(np.float32),
              "dense_features": rng.randn(100, 13).astype(np.float32)}
    try:
        ck.reset_launches()
        got = batcher.submit(sv, arrays).result(60)["prediction_node"]
        assert _launched() == {("dlrm_interact", "bfloat16"): 1}
    finally:
        batcher.stop()
    with torch.inference_mode():
        cpu = model.apply(model.init(3, "cpu"), {k: torch.from_numpy(v) for k, v in arrays.items()})
    assert np.max(np.abs(got - cpu["prediction_node"].float().numpy())) <= 5e-3

    wide = dataclasses.replace(cfg, num_fields=64, param_dtype="float32")
    big = build_model("dlrm", wide)
    bparams = big.init(3, cuda_device)
    bsv = Servable(name="WIDE", version=1, model=big, params=bparams,
                   signatures=ctr_signatures(64, with_dense=13))
    with pytest.raises(ValueError, match="64 fields"):
        DynamicBatcher(buckets=(64,), max_wait_us=0, device=cuda_device).step_for(bsv)
    ids = torch.zeros((4, 64), dtype=torch.int64, device=cuda_device)
    ck.reset_launches()
    with torch.inference_mode(), pytest.raises(ValueError, match="64 fields"):
        big.apply(bparams, {"feat_ids": ids, "feat_wts": torch.ones((4, 64), device=cuda_device)})
    assert _launched() == {}


# ------------------------------------------------------------- training


@pytest.mark.cuda
def test_training_through_the_cross_kernel_raises_on_the_card(cuda_device):
    """The cross-stack kernel has no backward: a train step of a
    use_pallas_cross model raises (NoBackwardError) before any launch and
    trains nothing; the same forward without grad launches the kernel."""
    from distributed_tf_serving_tpu_torch.train.checkpoint import flatten_params
    from distributed_tf_serving_tpu_torch.train.trainer import (
        init_state,
        make_train_step,
        prepare_batch,
    )
    from distributed_tf_serving_tpu_torch.train.data import SyntheticCTRConfig, SyntheticCTRStream

    cfg = ModelConfig(num_fields=10, embed_dim=8, mlp_dims=(32, 16), vocab_size=1 << 12,
                      num_cross_layers=2, compute_dtype="bfloat16", use_pallas_cross=True)
    model = build_model("dcn_v2", cfg)
    state = init_state(model.init(0, cuda_device), 1e-3)
    raw = SyntheticCTRStream(SyntheticCTRConfig(num_fields=10, id_space=1 << 12)).batch(64, 0)
    batch = prepare_batch(raw, cfg.vocab_size, cuda_device)
    ck.reset_launches()
    with pytest.raises(ck.NoBackwardError):
        make_train_step(model)(state, batch)
    assert _launched() == {}
    assert all(t.grad is None for t in flatten_params(state.params).values())
    with torch.no_grad():
        out = model.apply(state.params, batch)["prediction_node"]
    assert _launched() == {("fused_cross_apply", "bfloat16"): 1}
    assert bool(torch.isfinite(out).all())


@pytest.mark.cuda
def test_train_steps_on_the_card_follow_the_cpu(cuda_device):
    """Three f32 train steps of a small dcn_v2 from the same params on the
    card and on the CPU: losses within 1e-5 (TF32 off; the card's kernels
    sum in another order)."""
    from distributed_tf_serving_tpu_torch.train.trainer import (
        init_state,
        make_train_step,
        prepare_batch,
    )
    from distributed_tf_serving_tpu_torch.train.data import SyntheticCTRConfig, SyntheticCTRStream

    cfg = ModelConfig(num_fields=10, embed_dim=8, mlp_dims=(32, 16), vocab_size=1 << 12,
                      num_cross_layers=2, compute_dtype="float32")
    model = build_model("dcn_v2", cfg)
    params = model.init(1)
    stream = SyntheticCTRStream(SyntheticCTRConfig(num_fields=10, id_space=1 << 12, seed=1))
    losses = {}
    for dev in (torch.device("cpu"), cuda_device):
        state = init_state(_to(params, dev), 1e-2)
        step = make_train_step(model)
        losses[dev.type] = []
        for i in range(3):
            state, m = step(state, prepare_batch(stream.batch(256, i), cfg.vocab_size, dev))
            losses[dev.type].append(float(m["loss"]))
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=0, atol=1e-5)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


@pytest.mark.cuda
def test_the_context_probe_answers_on_a_live_card(cuda_device):
    """serving/recovery.py probe_context: an event recorded on the serving
    stream behind a queued kernel, polled, answers within its deadline."""
    import time

    from distributed_tf_serving_tpu_torch.serving.recovery import probe_context

    torch.cuda._sleep(10_000_000)  # keep the stream busy a few ms
    t0 = time.monotonic()
    assert probe_context(cuda_device, 5.0) is None
    assert time.monotonic() - t0 < 5.0


@pytest.mark.cuda
def test_a_transient_device_lost_on_the_card_replays_through_the_fused_kernel(cuda_device):
    """A keyless device_lost count=1 on a bf16 dcn_v2 batcher on the card
    with the recovery plane: the request answers the bits of the same batch
    unfaulted, and the REINIT's re-warm launches the fused serve kernel."""
    import time

    from distributed_tf_serving_tpu_torch import faults
    from distributed_tf_serving_tpu_torch.models import ServableRegistry
    from distributed_tf_serving_tpu_torch.serving.recovery import RecoveryController
    from distributed_tf_serving_tpu_torch.serving.server import load_demo_servable
    from distributed_tf_serving_tpu_torch.utils.config import RecoveryConfig

    cfg = ModelConfig(num_fields=43, embed_dim=16, mlp_dims=(256, 128, 64),
                      vocab_size=1 << 20, num_cross_layers=3, compute_dtype="bfloat16")
    reg = ServableRegistry()
    sv = load_demo_servable(reg, kind="dcn_v2", config=cfg, device=cuda_device)
    b = DynamicBatcher(buckets=(256, 512), max_wait_us=0, device=cuda_device)
    b.warmup(sv)
    b.start()
    rec = RecoveryController(RecoveryConfig(enabled=True, replay_drain_s=30.0), b, registry=reg)
    rng = np.random.RandomState(3)
    arrays = {"feat_ids": rng.randint(0, 1 << 40, size=(300, 43)).astype(np.int64),
              "feat_wts": rng.rand(300, 43).astype(np.float32)}
    try:
        want = b.submit(sv, arrays).result(120)["prediction_node"]
        faults.reset(seed=0)
        faults.get().add("device_lost", "error", code="UNAVAILABLE", count=1)
        ck.reset_launches()
        got = b.submit(sv, arrays).result(120)["prediction_node"]
        end = time.monotonic() + 30
        while rec.cycle_active() and time.monotonic() < end:
            time.sleep(0.01)
        assert got.tobytes() == want.tobytes()
        snap = rec.snapshot()
        assert snap["counters"]["replayed_items"] == 1 and snap["state"] == "serving"
        # The re-warm (both buckets) and the replay ran the fused kernel.
        assert ck.launches[("fused_serve", "bfloat16")] >= 3
    finally:
        faults.reset(seed=0)
        rec.stop()
        b.stop()
