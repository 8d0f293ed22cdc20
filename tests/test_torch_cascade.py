"""The port's ranking cascade (serving/cascade.py, the batcher's prune, the
service's cascade branch, [cascade] in build_stack, /cascadez and the
dts_tpu_cascade_* series) against the JAX package on the CPU. Both stages
of both packages are built from the same numpy weights (convert.py
params_from_jax), at a small size: 6 fields x 8, vocab 2^10, buckets
(8, 16, 32).

The counterpart of every test of the JAX package's tests/test_cascade.py:
the eligibility gates and plan_k; provenance and bit identity (survivor
rows equal a cascade-off Predict of those rows alone, pruned rows a direct
stage-1 Predict); the async path; the bypass paths; zero survivors from the
threshold; the host prune against the device prune; the stage-1 fallbacks
(missing and failing); the salted cache key; build_stack's refusals and
wiring; a stage-1 hot swap mid-traffic through publish_stage1. Beyond it:
cascade_prune_device of both packages on vectors with deliberate ties (the
same indices: ties in index order), and the whole cascade of both packages
on the same requests: identical provenance and survivor indices, scores
within 1e-5 in f32, each case's stage-1 gap at rank k above that
tolerance (else the case's seed says the comparison cannot decide)."""

import asyncio
import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from distributed_tf_serving_tpu import codec as jax_codec
from distributed_tf_serving_tpu.cache import features_digest as jax_features_digest
from distributed_tf_serving_tpu.client import build_predict_request, cascade_stage
from distributed_tf_serving_tpu.models import ModelConfig as JaxConfig
from distributed_tf_serving_tpu.models import Servable as JaxServable
from distributed_tf_serving_tpu.models import ServableRegistry as JaxRegistry
from distributed_tf_serving_tpu.models import build_model as jax_build
from distributed_tf_serving_tpu.models import ctr_signatures as jax_signatures
from distributed_tf_serving_tpu.ops.transfer import cascade_prune_device as jax_prune
from distributed_tf_serving_tpu.serving import DynamicBatcher as JaxBatcher
from distributed_tf_serving_tpu.serving import PredictionServiceImpl as JaxImpl
from distributed_tf_serving_tpu.serving import cascade as jax_cascade
from distributed_tf_serving_tpu.utils import config as jax_config
from distributed_tf_serving_tpu.utils import metrics as jax_metrics
from distributed_tf_serving_tpu_torch import codec
from distributed_tf_serving_tpu_torch.cache import ScoreCache, features_digest
from distributed_tf_serving_tpu_torch.convert import params_from_jax
from distributed_tf_serving_tpu_torch.models import (
    ModelConfig,
    Servable,
    ServableRegistry,
    build_model,
    ctr_signatures,
)
from distributed_tf_serving_tpu_torch.ops.transfer import cascade_prune_device
from distributed_tf_serving_tpu_torch.proto import serving_apis_pb2 as apis
from distributed_tf_serving_tpu_torch.serving.batcher import DynamicBatcher
from distributed_tf_serving_tpu_torch.serving.cascade import (
    STAGE1,
    STAGE2,
    STAGE_OUTPUT,
    CascadeOrchestrator,
    publish_stage1,
)
from distributed_tf_serving_tpu_torch.serving.service import PredictionServiceImpl
from distributed_tf_serving_tpu_torch.serving.version_watcher import (
    VersionWatcher,
    VersionWatcherConfig,
)
from distributed_tf_serving_tpu_torch.utils import metrics as torch_metrics
from distributed_tf_serving_tpu_torch.utils.config import CascadeConfig, ServerConfig

F = 6
KW = dict(num_fields=F, vocab_size=1 << 10, embed_dim=8, mlp_dims=(8,), num_cross_layers=1,
          compute_dtype="float32", num_user_fields=3)
BUCKETS = (8, 16, 32)
SCORE = "prediction_node"
TOL = 1e-5  # f32 scores, the reference's tolerance
WAIT = 60


def make_arrays(n, seed=0):
    rng = np.random.RandomState(seed)
    return {"feat_ids": rng.randint(0, 1 << 40, size=(n, F)).astype(np.int64),
            "feat_wts": rng.rand(n, F).astype(np.float32)}


def _pair(kind: str, name: str, seed: int, version: int = 1):
    """(JAX servable, port servable) of one family from the same weights."""
    jm = jax_build(kind, JaxConfig(name=name, **KW))
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    jsv = JaxServable(name=name, version=version, model=jm, params=jp,
                      signatures=jax_signatures(F))
    tsv = Servable(name=name, version=version, model=build_model(kind, ModelConfig(name=name, **KW)),
                   params=params_from_jax(jp, "cpu"), signatures=ctr_signatures(F))
    return jsv, tsv


class _Stacks:
    pass


@pytest.fixture(scope="module")
def stacks():
    s = _Stacks()
    (s.jdcn, s.dcn), (s.js1, s.stage1) = _pair("dcn_v2", "DCN", 0), _pair("two_tower", "stage1", 3)
    s.jregistry, s.registry = JaxRegistry(), ServableRegistry()
    for sv in (s.jdcn, s.js1):
        s.jregistry.load(sv)
    for sv in (s.dcn, s.stage1):
        s.registry.load(sv)
    s.jbatcher = JaxBatcher(buckets=BUCKETS, max_wait_us=0).start()
    s.batcher = DynamicBatcher(buckets=BUCKETS, max_wait_us=0, device="cpu").start()
    s.jimpl = JaxImpl(s.jregistry, s.jbatcher)
    s.impl = PredictionServiceImpl(s.registry, s.batcher)
    yield s
    s.batcher.stop()
    s.jbatcher.stop()


@pytest.fixture()
def casc(stacks):
    """A fresh orchestrator per test, on both stacks."""
    c = CascadeOrchestrator(stacks.registry, stacks.batcher, stage1_model="stage1",
                            survivor_fraction=0.25)
    stacks.impl.cascade = c
    stacks.jimpl.cascade = jax_cascade.CascadeOrchestrator(
        stacks.jregistry, stacks.jbatcher, stage1_model="stage1", survivor_fraction=0.25)
    yield c
    stacks.impl.cascade = None
    stacks.jimpl.cascade = None


def _request(arrays, model="DCN", filt=(SCORE,)):
    req = apis.PredictRequest()
    req.model_spec.name = model
    for k, v in arrays.items():
        codec.from_ndarray(v, out=req.inputs[k])
    req.output_filter.extend(filt or ())
    return req


def _stage(resp):
    return codec.to_ndarray(resp.outputs[STAGE_OUTPUT]) if STAGE_OUTPUT in resp.outputs else None


def _predict(impl, arrays, model="DCN", filt=(SCORE,)):
    resp = impl.predict(_request(arrays, model, filt))
    return resp, codec.to_ndarray(resp.outputs[SCORE])


def _plain(stacks, servable, arrays):
    """The cascade-off batcher's scores of `arrays` alone (their own
    bucket, no cascade)."""
    return stacks.impl._run(servable, arrays, output_keys=(SCORE,))[SCORE]


# ------------------------------------------------------------ eligibility


def test_eligibility_gates(stacks, casc):
    jc = stacks.jimpl.cascade
    cases = [
        ((SCORE,), 32, True),
        # Unfiltered: mixed stages for the other outputs would mean nothing.
        (None, 32, False),
        (("logits",), 32, False),
        ((SCORE, "logits"), 32, False),
        # Below min_candidates two round trips cost more than one.
        ((SCORE,), casc.min_candidates - 1, False),
    ]
    for keys, n, want in cases:
        assert casc.eligible(stacks.dcn, keys, n) is want
        assert jc.eligible(stacks.jdcn, keys, n) is want
    # The stage-1 model never recurses into the cascade.
    assert not casc.eligible(stacks.stage1, (SCORE,), 32)
    assert not jc.eligible(stacks.js1, (SCORE,), 32)
    # A survivor budget that keeps everything prunes nothing.
    wide = CascadeOrchestrator(stacks.registry, stacks.batcher, survivor_k=100)
    assert not wide.eligible(stacks.dcn, (SCORE,), 32)


def test_plan_k(stacks, casc):
    jc = stacks.jimpl.cascade
    for n in (3, 8, 17, 32, 64, 1000):
        assert casc.plan_k(n) == jc.plan_k(n)
    assert casc.plan_k(32) == 8 and casc.plan_k(8) == 2 and casc.plan_k(3) == 1
    fixed = CascadeOrchestrator(stacks.registry, stacks.batcher, survivor_k=5)
    assert fixed.plan_k(64) == 5 and fixed.plan_k(1000) == 5


# ------------------------------------------- bit identity and provenance


def test_cascade_bit_identity_and_provenance(stacks, casc):
    impl = stacks.impl
    arrays = make_arrays(32, seed=1)
    b0 = dataclasses.replace(stacks.batcher.stats)
    resp, scores = _predict(impl, arrays)
    stage = _stage(resp)
    assert stage is not None and stage.shape == (32,) and stage.dtype == np.int32
    assert int((stage == STAGE2).sum()) == 8 and int((stage == STAGE1).sum()) == 24
    surv, pruned = np.where(stage == STAGE2)[0], np.where(stage == STAGE1)[0]
    s1 = _plain(stacks, stacks.stage1, arrays)
    # The survivor set is stage 1's stable top-k.
    assert set(surv.tolist()) == set(np.argsort(-s1, kind="stable")[:8].tolist())
    # Survivor rows: the bits of a cascade-off Predict of those rows alone
    # (the bucket stage 2 ran in); pruned rows: the bits of stage 1.
    np.testing.assert_array_equal(scores[surv], _plain(stacks, stacks.dcn,
                                                       {k: v[surv] for k, v in arrays.items()}))
    np.testing.assert_array_equal(scores[pruned], s1[pruned])
    # And within the f32 tolerance of a full pass over all 32 rows.
    np.testing.assert_allclose(scores[surv], _plain(stacks, stacks.dcn, arrays)[surv],
                               rtol=0, atol=TOL)
    snap = casc.snapshot()
    assert snap["requests"] == 1 and snap["host_prunes"] == 0 and snap["fallbacks"] == 0
    assert snap["rows_requested"] == 32 and snap["rows_ranked"] == 8
    assert snap["pruned_rows"] == 24 and snap["rank_fraction"] == pytest.approx(0.25)
    assert snap["survivor_buckets"] == {8: 1}  # 8 survivors ride the 8 bucket
    st = stacks.batcher.stats
    assert st.prune_batches - b0.prune_batches == 1
    assert st.prune_fallback_batches == b0.prune_fallback_batches
    assert st.topk_batches == b0.topk_batches


def _case_gap(s1: np.ndarray, k: int, seed) -> None:
    """The stage-1 gap at rank k must exceed the score tolerance, or the
    two packages' survivor sets could differ by a tie within it."""
    top = np.sort(s1)[::-1]
    gap = float(top[k - 1] - top[k])
    assert gap > TOL, (f"seed {seed}: stage-1 gap at rank {k} is {gap} <= {TOL}; "
                       "the comparison cannot decide the survivor set")


@pytest.mark.parametrize("n,seed", [(8, 21), (17, 22), (32, 23)])
def test_the_cascade_matches_the_jax_package(stacks, casc, n, seed):
    arrays = make_arrays(n, seed=seed)
    k = casc.plan_k(n)
    s1 = np.asarray(stacks.jimpl._run(stacks.js1, arrays, output_keys=(SCORE,))[SCORE],
                    np.float32)
    _case_gap(s1, k, seed)
    jresp = stacks.jimpl.predict(build_predict_request(arrays, "DCN", output_filter=(SCORE,)))
    resp, scores = _predict(stacks.impl, arrays)
    jstage, stage = cascade_stage(jresp), _stage(resp)
    np.testing.assert_array_equal(stage, jstage)
    assert int((stage == STAGE2).sum()) == k
    np.testing.assert_allclose(scores, jax_codec.to_ndarray(jresp.outputs[SCORE]), rtol=0,
                               atol=TOL)
    assert casc.snapshot() | {"stage1_seconds_total": 0, "prune_seconds_total": 0,
                              "stage2_seconds_total": 0} == \
        stacks.jimpl.cascade.snapshot() | {"stage1_seconds_total": 0, "prune_seconds_total": 0,
                                           "stage2_seconds_total": 0}


def test_async_predict_parity(stacks, casc):
    impl = stacks.impl
    arrays = make_arrays(32, seed=2)
    _, want = _predict(impl, arrays)
    resp = asyncio.run(impl.predict_async(_request(arrays)))
    np.testing.assert_array_equal(codec.to_ndarray(resp.outputs[SCORE]), want)
    st = _stage(resp)
    assert st is not None and int((st == STAGE2).sum()) == 8
    assert casc.snapshot()["requests"] == 2


def test_bypass_paths_carry_no_provenance(stacks, casc):
    impl = stacks.impl
    # Unfiltered: every signature output, no cascade.
    resp = impl.predict(_request(make_arrays(32), filt=None))
    assert STAGE_OUTPUT not in resp.outputs
    # Too small: the bits of the plane-off answer.
    small = make_arrays(4, seed=4)
    resp, got = _predict(impl, small)
    assert STAGE_OUTPUT not in resp.outputs
    np.testing.assert_array_equal(got, _plain(stacks, stacks.dcn, small))
    # Stage 1 scored directly stays a plain Predict.
    resp, _ = _predict(impl, make_arrays(16), model="stage1")
    assert STAGE_OUTPUT not in resp.outputs
    assert casc.snapshot()["requests"] == 0


# ----------------------------------------- threshold / zero survivors


def test_score_threshold_zero_survivors(stacks):
    impl, jimpl = stacks.impl, stacks.jimpl
    impl.cascade = CascadeOrchestrator(stacks.registry, stacks.batcher, survivor_fraction=0.25,
                                       score_threshold=1e9)
    jimpl.cascade = jax_cascade.CascadeOrchestrator(stacks.jregistry, stacks.jbatcher,
                                                    survivor_fraction=0.25, score_threshold=1e9)
    try:
        arrays = make_arrays(32, seed=5)
        resp, scores = _predict(impl, arrays)
        jresp = jimpl.predict(build_predict_request(arrays, "DCN", output_filter=(SCORE,)))
        stage = _stage(resp)
        # Nobody clears the bar: every row keeps its stage-1 score.
        assert stage is not None and (stage == STAGE1).all()
        np.testing.assert_array_equal(stage, cascade_stage(jresp))
        np.testing.assert_array_equal(scores, _plain(stacks, stacks.stage1, arrays))
        snap = impl.cascade.snapshot()
        assert snap["zero_survivor_requests"] == 1 and snap["rows_ranked"] == 0
        assert snap["survivor_buckets"] == {}
    finally:
        impl.cascade = jimpl.cascade = None


# ------------------------------------------------- host-prune fallback


def test_host_prune_matches_device_prune(stacks, casc):
    impl = stacks.impl
    arrays = make_arrays(32, seed=7)
    dev = impl._run(stacks.stage1, arrays, output_keys=(SCORE,), prune_k=8)
    # The prune armed: the survivor pairs and the stage-1 vector.
    assert set(dev) == {"survivor_scores", "survivor_indices", "stage1_scores"}
    assert dev["survivor_indices"].shape == (8,) and dev["survivor_indices"].dtype == np.int32
    assert dev["stage1_scores"].shape == (32,)
    full = impl._run(stacks.stage1, arrays, output_keys=(SCORE,))
    h_idx, h_full = casc._finalize_prune(full, stacks.stage1, 32, 8)
    d_idx, d_full = casc._finalize_prune(dev, stacks.stage1, 32, 8)
    assert set(h_idx.tolist()) == set(d_idx.tolist())
    np.testing.assert_array_equal(h_full, d_full)
    assert casc.stats.host_prunes == 1  # only the full-vector path counts


def test_a_prune_that_cannot_arm_reads_back_the_plain_outputs(stacks):
    """k >= n (and a request that asked for more than the score): the
    batch runs plain, counted in prune_fallback_batches, as in the JAX
    package."""
    b = stacks.batcher
    f0 = b.stats.prune_fallback_batches
    arrays = make_arrays(8, seed=8)
    out = stacks.impl._run(stacks.stage1, arrays, output_keys=(SCORE,), prune_k=8)
    assert set(out) == {SCORE}
    np.testing.assert_array_equal(out[SCORE], _plain(stacks, stacks.stage1, arrays))
    assert b.stats.prune_fallback_batches == f0 + 1


# --------------------------------------------------- full-pass fallbacks


def test_stage1_missing_full_fallback(stacks):
    impl = stacks.impl
    impl.cascade = CascadeOrchestrator(stacks.registry, stacks.batcher,
                                       stage1_model="absent-retriever")
    try:
        arrays = make_arrays(32, seed=8)
        resp, scores = _predict(impl, arrays)
        stage = _stage(resp)
        assert stage is not None and (stage == STAGE2).all()
        np.testing.assert_array_equal(scores, _plain(stacks, stacks.dcn, arrays))
        snap = impl.cascade.snapshot()
        assert snap["fallbacks"] == 1 and snap["stage1_failures"] == 0
    finally:
        impl.cascade = None


def test_stage1_failure_full_fallback(stacks, casc, monkeypatch):
    impl = stacks.impl
    orig = impl._run

    def boom(servable, arrays, **kw):
        if servable.name == "stage1":
            raise RuntimeError("injected stage-1 device failure")
        return orig(servable, arrays, **kw)

    monkeypatch.setattr(impl, "_run", boom)
    arrays = make_arrays(32, seed=9)
    resp, scores = _predict(impl, arrays)
    stage = _stage(resp)
    assert stage is not None and (stage == STAGE2).all()
    np.testing.assert_array_equal(scores, orig(stacks.dcn, arrays, output_keys=(SCORE,))[SCORE])
    snap = casc.snapshot()
    assert snap["fallbacks"] == 1 and snap["stage1_failures"] == 1


def test_async_stage1_failure_full_fallback(stacks, casc, monkeypatch):
    impl = stacks.impl
    orig = impl._run_async

    async def boom(servable, arrays, **kw):
        if servable.name == "stage1":
            raise RuntimeError("injected stage-1 device failure")
        return await orig(servable, arrays, **kw)

    monkeypatch.setattr(impl, "_run_async", boom)
    arrays = make_arrays(32, seed=10)
    resp = asyncio.run(impl.predict_async(_request(arrays)))
    assert (_stage(resp) == STAGE2).all()
    np.testing.assert_array_equal(codec.to_ndarray(resp.outputs[SCORE]),
                                  _plain(stacks, stacks.dcn, arrays))
    snap = casc.snapshot()
    assert snap["fallbacks"] == 1 and snap["stage1_failures"] == 1


# ------------------------------------------------------- cache-key salt


def test_prune_submits_salt_the_request_digest(stacks):
    """A prune result (survivor pairs) never answers a full request from
    the score cache: the k rides the digest, as in the JAX package."""
    arrays = make_arrays(16, seed=11)
    plain = features_digest(arrays)
    assert plain == jax_features_digest(arrays)
    for salt in (b"prune:4", b"prune:8"):
        assert features_digest(arrays, salt=salt) == jax_features_digest(arrays, salt=salt)
        assert features_digest(arrays, salt=salt) != plain
    assert features_digest(arrays, salt=b"prune:4") != features_digest(arrays, salt=b"prune:8")
    b = DynamicBatcher(buckets=BUCKETS, max_wait_us=0, device="cpu",
                       score_cache=ScoreCache(max_entries=64)).start()
    try:
        pruned = b.submit(stacks.stage1, arrays, output_keys=(SCORE,), _prune_k=4).result(WAIT)
        full = b.submit(stacks.stage1, arrays, output_keys=(SCORE,)).result(WAIT)
        again = b.submit(stacks.stage1, arrays, output_keys=(SCORE,), _prune_k=4).result(WAIT)
        assert set(pruned) == set(again) == {"survivor_scores", "survivor_indices",
                                              "stage1_scores"}
        assert set(full) == {SCORE}
        snap = b.score_cache.snapshot()
        assert snap["misses"] == 2 and snap["hits"] == 1
        assert b.stats.prune_batches == 1 and b.stats.batches == 2
    finally:
        b.stop()


# --------------------------------------------- cascade_prune_device, ties


@pytest.mark.parametrize("wire", [None, "bfloat16", "int8"])
def test_prune_device_orders_ties_by_index_as_the_jax_package(wire):
    """Deliberate ties, across the head's boundary and inside it, and
    padding rows past n_valid: the same survivor indices and scores as
    the JAX prune (jax.lax.top_k), and the stage-1 vector at the wire."""
    scores = np.array([0.5, 0.9, 0.5, 0.9, 0.1, 0.5, 0.7, 0.9, 0.5, 0.3, 0.99, 0.99],
                      np.float32)
    n_valid, k = 10, 6
    jwire = {None: None, "bfloat16": np.dtype(ml_dtypes.bfloat16),
             "int8": np.dtype(np.int8)}[wire]
    twire = {None: None, "bfloat16": torch.bfloat16, "int8": torch.int8}[wire]
    theirs = jax_prune(jnp.asarray(scores), n_valid, k, jwire)
    ours = cascade_prune_device(torch.from_numpy(scores), n_valid, k, twire)
    np.testing.assert_array_equal(ours["survivor_indices"].numpy(),
                                  np.asarray(theirs["survivor_indices"]))
    assert ours["survivor_indices"].tolist() == [1, 3, 7, 6, 0, 2]  # padding never survives
    for key in ("survivor_scores", "stage1_scores"):
        np.testing.assert_array_equal(ours[key].float().numpy(),
                                      np.asarray(theirs[key]).astype(np.float32))
    assert ours["stage1_scores"].shape == (12,)


# --------------------------------------------- build_stack wiring + refusals


def _server_cfg(**over):
    return ServerConfig(model_name="DCN", model_kind="dcn_v2", num_fields=F, buckets=(8, 16, 32),
                        warmup=False, max_wait_us=0, **over)


def test_build_stack_refuses_output_top_k():
    from distributed_tf_serving_tpu.serving.server import build_stack as jax_build_stack
    from distributed_tf_serving_tpu_torch.serving.server import build_stack

    with pytest.raises(ValueError, match="output_top_k") as ours:
        build_stack(_server_cfg(output_top_k=4), ModelConfig(name="DCN", **KW), device="cpu",
                    cascade_config=CascadeConfig(enabled=True))
    with pytest.raises(ValueError, match="output_top_k") as theirs:
        jax_build_stack(jax_config.ServerConfig(model_name="DCN", num_fields=F, buckets=BUCKETS,
                                                warmup=False, output_top_k=4),
                        model_config=JaxConfig(name="DCN", **KW),
                        cascade_config=jax_config.CascadeConfig(enabled=True))
    assert str(ours.value) == str(theirs.value)


def test_mesh_beside_the_cascade_is_refused_by_build_stack(tmp_path):
    """[mesh] (and [elastic]) beside [cascade]: both configs load, and
    build_stack refuses the pair in both packages, in the same words."""
    from distributed_tf_serving_tpu.serving.server import build_stack as jax_build_stack
    from distributed_tf_serving_tpu_torch.serving.server import build_stack
    from distributed_tf_serving_tpu_torch.utils.config import load_config

    p = tmp_path / "c.toml"
    p.write_text("[cascade]\nenabled = true\n[mesh]\nenabled = true\ndevices = 8\n"
                 "model_parallel = 2\n")
    loaded = load_config(p)
    with pytest.raises(ValueError, match=r"\[cascade\] enabled conflicts with \[mesh\]") as ours:
        build_stack(ServerConfig(model_name="DCN", num_fields=F, buckets=BUCKETS, warmup=False),
                    ModelConfig(name="DCN", **KW), "cpu", mesh_config=loaded["mesh"],
                    cascade_config=loaded["cascade"], mesh_device_list=["cpu"] * 8)
    with pytest.raises(ValueError, match=r"\[mesh\]") as theirs:
        jax_build_stack(jax_config.ServerConfig(model_name="DCN", num_fields=F, buckets=BUCKETS,
                                                warmup=False),
                        model_config=JaxConfig(name="DCN", **KW),
                        mesh_config=jax_config.MeshConfig(enabled=True, devices=8,
                                                          model_parallel=2),
                        cascade_config=jax_config.CascadeConfig(enabled=True))
    assert str(ours.value) == str(theirs.value)


def test_build_stack_cascade_wiring_and_disabled_mode():
    from distributed_tf_serving_tpu_torch.serving.server import build_stack

    impl, b, _ = build_stack(_server_cfg(), ModelConfig(name="DCN", **KW), device="cpu",
                             cascade_config=CascadeConfig())
    try:
        assert impl.cascade is None and impl.cascade_stats() is None
        resp, _ = _predict(impl, make_arrays(16))
        assert STAGE_OUTPUT not in resp.outputs
    finally:
        b.stop()
    impl, b, _ = build_stack(_server_cfg(), ModelConfig(name="DCN", **KW), device="cpu",
                             cascade_config=CascadeConfig(enabled=True, survivor_fraction=0.25))
    try:
        # The stage-1 servable is a normal registry entry under its name,
        # two_tower, keeping its 3 user fields.
        assert "stage1" in impl.registry.models()
        s1 = impl.registry.resolve("stage1")
        assert s1.model.kind == "two_tower" and s1.model.config.num_user_fields == 3
        snap = impl.cascade_stats()
        assert snap["stage1_model"] == "stage1"
        resp, _ = _predict(impl, make_arrays(16, seed=13))
        stage = _stage(resp)
        assert stage is not None and int((stage == STAGE2).sum()) == 4
        snap = impl.cascade_stats()
        assert snap["batcher"] == {"prune_batches": 1, "prune_fallback_batches": 0}
    finally:
        b.stop()


def test_build_stack_serves_stage1_from_a_base_path(tmp_path):
    """stage1_base_path: a VersionWatcher (impl.cascade_watcher) loads the
    published stage 1, and the drain stops it."""
    from distributed_tf_serving_tpu_torch.serving.server import GracefulShutdown, build_stack

    _, s1 = _pair("two_tower", "stage1", 3)
    v, _ = publish_stage1(str(tmp_path), s1, "two_tower")
    impl, b, _ = build_stack(
        _server_cfg(), ModelConfig(name="DCN", **KW), device="cpu",
        cascade_config=CascadeConfig(enabled=True, stage1_base_path=str(tmp_path)))
    shutdown = GracefulShutdown(impl, b, grace_s=5.0)
    try:
        assert impl.cascade_watcher is not None
        assert impl.registry.resolve("stage1").version == v == 1
        resp, _ = _predict(impl, make_arrays(32, seed=14))
        assert int((_stage(resp) == STAGE2).sum()) == 8
    finally:
        shutdown.shutdown()
    assert impl.cascade_watcher._stop.is_set()


# ------------------------------------------- stage-1 hot swap mid-traffic


def test_stage1_hot_swap_mid_traffic(tmp_path, stacks):
    """The rollout contract: stage 1 is served by a VersionWatcher like any
    model, a version flip lands mid-traffic without a failed request, and
    unloading stage 1 turns every cascade into a full ranking pass."""
    registry = ServableRegistry()
    registry.load(stacks.dcn)
    batcher = DynamicBatcher(buckets=BUCKETS, max_wait_us=0, device="cpu").start()
    impl = PredictionServiceImpl(registry, batcher)
    impl.cascade = CascadeOrchestrator(registry, batcher, survivor_fraction=0.25)
    v1, _ = publish_stage1(str(tmp_path), _pair("two_tower", "stage1", 3)[1], "two_tower")
    watcher = VersionWatcher(tmp_path, registry,
                             VersionWatcherConfig(poll_interval_s=3600, model_name="stage1"),
                             device="cpu")
    watcher.poll_once()
    assert registry.resolve("stage1").version == v1

    errors: list = []
    ranked: list = []
    stop = threading.Event()
    req = _request(make_arrays(32, seed=17))

    def traffic():
        while not stop.is_set():
            try:
                st = _stage(impl.predict(req))
                assert st is not None and st.shape == (32,)
                ranked.append(int((st == STAGE2).sum()))
            except Exception as exc:  # noqa: BLE001 — the test's verdict
                errors.append(exc)
                return

    threads = [threading.Thread(target=traffic) for _ in range(2)]
    for t in threads:
        t.start()

    def wait_more(n):
        target = len(ranked) + n
        end = time.time() + WAIT
        while len(ranked) < target and not errors and time.time() < end:
            time.sleep(0.005)
        assert not errors, errors
        assert len(ranked) >= target

    try:
        wait_more(5)
        v2, _ = publish_stage1(str(tmp_path), _pair("two_tower", "stage1", 4)[1], "two_tower")
        watcher.poll_once()
        assert registry.resolve("stage1").version == v2
        wait_more(5)
        registry.unload("stage1")
        wait_more(3)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=WAIT)
        batcher.stop()
    assert not errors, errors
    snap = impl.cascade.snapshot()
    assert snap["requests"] == len(ranked)
    assert 8 in ranked and 32 in ranked  # 8 of 32 before the unload, all 32 after
    assert snap["fallbacks"] >= 3 and snap["stage1_failures"] == 0


# ----------------------------------------------- /cascadez and the series


def test_cascadez_monitoring_and_series_carry_the_jax_fields(stacks, casc):
    from distributed_tf_serving_tpu_torch.serving.rest import start_rest_gateway

    for seed in (31, 32):
        arrays = make_arrays(32, seed=seed)
        stacks.impl.predict(_request(arrays))
        stacks.jimpl.predict(build_predict_request(arrays, "DCN", output_filter=(SCORE,)))
    ours, theirs = stacks.impl.cascade_stats(), stacks.jimpl.cascade_stats()
    assert ours.pop("batcher")["prune_batches"] >= 2
    times = ("stage1_seconds_total", "prune_seconds_total", "stage2_seconds_total")
    assert {k: v for k, v in ours.items() if k not in times} == \
        {k: v for k, v in theirs.items() if k not in times}
    # The exposition of one snapshot is the JAX package's text.
    assert torch_metrics._cascade_prometheus_lines(theirs) == \
        jax_metrics._cascade_prometheus_lines(theirs)
    for name in ("dts_tpu_cascade_requests_total", "dts_tpu_cascade_rows_total",
                 "dts_tpu_cascade_survivor_bucket_total"):
        assert torch_metrics._HELP[name] == jax_metrics._HELP[name]

    async def fetch():
        import aiohttp

        runner, port = await start_rest_gateway(stacks.impl, port=0)
        try:
            async with aiohttp.ClientSession(f"http://127.0.0.1:{port}") as s:
                out = []
                for path in ("/cascadez", "/monitoring?section=cascade",
                             "/monitoring/prometheus/metrics"):
                    async with s.get(path) as r:
                        out.append(await (r.text() if "prometheus" in path else r.json()))
                return out
        finally:
            await runner.cleanup()

    cascadez, section, prom = asyncio.run(fetch())
    assert cascadez["requests"] == 2 and cascadez["survivor_buckets"] == {"8": 2}
    assert set(cascadez) == set(theirs) | {"batcher"}
    assert section["cascade"]["requests"] == 2
    lines = [ln for ln in prom.splitlines() if ln.startswith("dts_tpu_cascade_")]
    assert "dts_tpu_cascade_requests_total 2" in lines
    assert 'dts_tpu_cascade_rows_total{disposition="survivor"} 16' in lines
    assert len(lines) >= 12
