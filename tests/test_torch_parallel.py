"""The port's parallel layer (mesh, shardings, the sharded executor, EP
lookups) against the JAX package, case for case with tests/test_parallel.py:
the JAX functions run on the 8 virtual CPU devices, the port's on eight
logical CPU shards, on the same seeded numpy inputs with the params carried
across by convert.params_from_jax.

Tolerances are the JAX tests' own: rtol 1e-6 against the JAX package for
the executor, EP and the annotation-vs-explicit cases, 1e-5 for TP. Beside
them the port's mesh output is held BIT-equal to the same rows scored in
one call on one device (`_single_golden`), as the JAX tests hold theirs:
the masked vocab gather, the TP weight all-gather, the pad and the ordered
gather are exact, and a row's bits do not depend on the row count of its
shard's call (models/base.py ROW_TILE; tests/test_torch_row_count.py).
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tf_serving_tpu.models import ModelConfig as JaxConfig
from distributed_tf_serving_tpu.models import Servable as JaxServable
from distributed_tf_serving_tpu.models import build_model as jax_build
from distributed_tf_serving_tpu.models import ctr_signatures as jax_signatures
from distributed_tf_serving_tpu.models.embeddings import field_embed as jax_field_embed
from distributed_tf_serving_tpu.parallel import ShardedExecutor as JaxExecutor
from distributed_tf_serving_tpu.parallel import make_mesh as jax_make_mesh
from distributed_tf_serving_tpu.parallel import param_shardings as jax_param_shardings
from distributed_tf_serving_tpu.parallel import place_params as jax_place_params
from distributed_tf_serving_tpu.parallel import shard_map_score as jax_shard_map_score
from distributed_tf_serving_tpu.parallel import sharded_field_embed as jax_sharded_field_embed
from distributed_tf_serving_tpu.parallel import tree_path_str as jax_tree_path_str
from distributed_tf_serving_tpu.serving import DynamicBatcher as JaxBatcher
from distributed_tf_serving_tpu.serving.batcher import fold_ids_host as jax_fold
from distributed_tf_serving_tpu_torch.convert import params_from_jax
from distributed_tf_serving_tpu_torch.models import ModelConfig, Servable, build_model
from distributed_tf_serving_tpu_torch.models import ctr_signatures
from distributed_tf_serving_tpu_torch.models.embeddings import field_embed
from distributed_tf_serving_tpu_torch.parallel import (
    DATA_AXIS,
    MODEL_AXIS,
    ShardedExecutor,
    make_mesh,
    param_shardings,
    place_params,
    shard_map_score,
    sharded_field_embed,
    vocab_sharding,
)
from distributed_tf_serving_tpu_torch.parallel.embedding_sharding import tree_map_with_path
from distributed_tf_serving_tpu_torch.parallel.mesh import P
from distributed_tf_serving_tpu_torch.parallel.sharding import put
from distributed_tf_serving_tpu_torch.serving.batcher import DynamicBatcher, fold_ids_host

KW = dict(num_fields=8, vocab_size=1024, embed_dim=4, mlp_dims=(16,), num_cross_layers=1,
          compute_dtype="float32")
CPU8 = [torch.device("cpu")] * 8


def _pair(seed=0, kind="dcn_v2", **over):
    """(JAX servable, port servable) of one family with the same params."""
    jcfg = JaxConfig(**{**KW, **over})
    jm = jax_build(kind, jcfg)
    jsv = JaxServable(name="DCN", version=1, model=jm, params=jm.init(jax.random.PRNGKey(seed)),
                      signatures=jax_signatures(jcfg.num_fields))
    m = build_model(kind, ModelConfig(**{**KW, **over}))
    sv = Servable(name="DCN", version=1, model=m,
                  params=params_from_jax(jax.tree.map(np.asarray, jsv.params)),
                  signatures=ctr_signatures(jcfg.num_fields))
    return jsv, sv


def _arrays(n, seed=0, fields=8):
    rng = np.random.RandomState(seed)
    return {
        "feat_ids": rng.randint(0, 1 << 40, size=(n, fields)).astype(np.int64),
        "feat_wts": rng.rand(n, fields).astype(np.float32),
    }


def _prepared(arrays, vocab=1024):
    return {"feat_ids": fold_ids_host(arrays["feat_ids"], vocab), "feat_wts": arrays["feat_wts"]}


def _jax_golden(jsv, arrays, vocab=1024):
    batch = {"feat_ids": jax_fold(arrays["feat_ids"], vocab), "feat_wts": arrays["feat_wts"]}
    return np.asarray(jax.jit(jsv.model.apply)(jsv.params, batch)["prediction_node"])


def _apply(sv, batch):
    with torch.inference_mode():
        out = sv.model.apply(sv.params, {k: torch.from_numpy(np.ascontiguousarray(v))
                                         for k, v in batch.items()})
    return out["prediction_node"].numpy()


def _golden(sv, arrays, vocab=1024):
    return _apply(sv, _prepared(arrays, vocab))


def _single_golden(sv, prepared, bucket=None):
    """The bits the mesh must give: the rows padded to `bucket` (the
    batcher's pad) scored in one call on one device."""
    n = next(iter(prepared.values())).shape[0]
    rows = bucket or n
    padded = {}
    for k, v in prepared.items():
        buf = np.zeros((rows,) + v.shape[1:], v.dtype)
        buf[:n] = v
        padded[k] = buf
    return _apply(sv, padded)[:n]


def _spec_map(tree, jax_tree=False):
    """{"cross/0/w": spec tuple} of a sharding tree of either package."""
    out = {}
    if jax_tree:
        for path, s in jax.tree_util.tree_flatten_with_path(tree)[0]:
            out[jax_tree_path_str(path)] = tuple(s.spec)
    else:
        tree_map_with_path(lambda path, s: out.__setitem__("/".join(map(str, path)),
                                                           tuple(s.spec)), tree)
    return out


def test_eight_logical_shards():
    """The port's mesh holds eight logical shards over one CPU device, as
    the JAX tests hold eight virtual devices; the mesh refuses what the JAX
    one refuses, in its words, and without a card asks for a device list."""
    assert len(jax.devices()) == 8
    mesh = make_mesh(8, devices=CPU8)
    assert mesh.size == 8 and mesh.device_names() == [f"cpu/{k}" for k in range(8)]
    with pytest.raises(ValueError, match="requested 16 devices, have 8"):
        make_mesh(16, devices=CPU8)
    with pytest.raises(ValueError, match="n_devices=8 not divisible by model_parallel=3"):
        make_mesh(8, model_parallel=3, devices=CPU8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()


@pytest.mark.parametrize("model_parallel", [1, 2, 4])
def test_mesh_shapes(model_parallel):
    mesh = make_mesh(8, model_parallel=model_parallel, devices=CPU8)
    assert mesh.shape[DATA_AXIS] == 8 // model_parallel
    assert mesh.shape[MODEL_AXIS] == model_parallel
    assert mesh.shape == dict(jax_make_mesh(8, model_parallel=model_parallel).shape)


def test_param_placement_shards_vocab_tables():
    mesh = make_mesh(8, model_parallel=4, devices=CPU8)
    jsv, sv = _pair()
    placed = place_params(sv.params, mesh)
    emb = placed["embedding"]
    # vocab rows split 4 ways over the model axis
    assert emb.sharding.spec == P(MODEL_AXIS, None)
    assert emb.addressable_shards[0].data.shape == (KW["vocab_size"] // 4, KW["embed_dim"])
    # the blocks are views of the one table on this device: no copy
    assert emb.blocks[0][1].untyped_storage().data_ptr() == \
        sv.params["embedding"].untyped_storage().data_ptr()
    # dense weights replicated
    assert placed["mlp"][0]["w"].sharding.spec == P()
    jplaced = jax_place_params(jsv.params, jax_make_mesh(8, model_parallel=4))
    assert _spec_map(tree_map_with_path(lambda _p, leaf: leaf.sharding, placed)) == \
        _spec_map(jax.tree.map(lambda a: a.sharding, jplaced), jax_tree=True)


@pytest.mark.parametrize("model_parallel", [1, 2])
def test_sharded_executor_matches_single_device(model_parallel):
    jsv, sv = _pair()
    arrays = _arrays(64, seed=3)
    want = np.asarray(JaxExecutor(jax_make_mesh(8, model_parallel=model_parallel))(
        jsv, _prepared(arrays))["prediction_node"])
    out = ShardedExecutor(make_mesh(8, model_parallel, devices=CPU8))(sv, _prepared(arrays))
    got = out["prediction_node"].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got, _jax_golden(jsv, arrays), rtol=1e-6)
    np.testing.assert_array_equal(got, _single_golden(sv, _prepared(arrays)))


def test_sharded_executor_behind_batcher():
    """Full integration: the batcher coalesces and pads, the mesh executes,
    per-request slices come back in order, in both packages."""
    jsv, sv = _pair()
    jb = JaxBatcher(buckets=(32, 64), max_wait_us=0, run_fn=JaxExecutor(jax_make_mesh(8))).start()
    b = DynamicBatcher(buckets=(32, 64), max_wait_us=0, device="cpu",
                       run_fn=ShardedExecutor(make_mesh(8, devices=CPU8))).start()
    try:
        for n, seed in [(19, 1), (40, 2)]:
            arrays = _arrays(n, seed)
            want = jb.submit(jsv, arrays).result(timeout=60)["prediction_node"]
            got = b.submit(sv, arrays).result(timeout=60)["prediction_node"]
            np.testing.assert_allclose(got, want, rtol=1e-6)
            np.testing.assert_allclose(got, _jax_golden(jsv, arrays), rtol=1e-6)
            bucket = 32 if n <= 32 else 64
            np.testing.assert_array_equal(got, _single_golden(sv, _prepared(arrays), bucket))
    finally:
        jb.stop()
        b.stop()


def test_shard_map_score_order_preserved():
    """The explicit scatter / score / gather returns scores in candidate
    order (the reference's host-order concat)."""
    jsv, sv = _pair()
    arrays = _arrays(64, seed=5)
    want = np.asarray(jax_shard_map_score(jsv, jax_make_mesh(8, model_parallel=1))(
        jsv.params, _prepared(arrays)))
    got = shard_map_score(sv, make_mesh(8, devices=CPU8))(sv.params, _prepared(arrays)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_array_equal(got, _golden(sv, arrays))


@pytest.mark.parametrize("model_parallel", [2, 4, 8])
def test_sharded_field_embed_exact(model_parallel):
    """The explicit EP lookup (masked local gather + model-axis sum) equals
    the single-device lookup exactly, from a table tensor and from a placed
    one, and the JAX package's sharded lookup within its rtol."""
    rng = np.random.RandomState(0)
    table = rng.randn(1024, 4).astype(np.float32)
    ids = rng.randint(0, 1024, size=(16, 8)).astype(np.int32)
    wts = rng.rand(16, 8).astype(np.float32)
    jmesh = jax_make_mesh(8, model_parallel=model_parallel)
    jtable = jax.device_put(jnp.asarray(table), jax.sharding.NamedSharding(
        jmesh, jax.sharding.PartitionSpec("model", None)))
    theirs = np.asarray(jax.jit(lambda t, i, w: jax_sharded_field_embed(
        t, i, w, jmesh, jnp.float32))(jtable, jnp.asarray(ids), jnp.asarray(wts)))
    mesh = make_mesh(8, model_parallel=model_parallel, devices=CPU8)
    t, i, w = map(torch.from_numpy, (table, ids, wts))
    want = field_embed(t, i, w, torch.float32)
    for src in (t, put(t, vocab_sharding(mesh))):
        got = sharded_field_embed(src, i, w, mesh, torch.float32)
        assert torch.equal(got, want)
        np.testing.assert_allclose(got.numpy(), theirs, rtol=1e-6)
    with pytest.raises(ValueError, match="not divisible by model-axis size"):
        sharded_field_embed(t[:1023], i, w, mesh, torch.float32)


def test_annotation_path_matches_explicit_path():
    """The executor's EP (compact tables of the masked gather) and the
    explicit sharded_field_embed agree with the single-device lookup, and
    the executor's scores with the JAX annotation path's."""
    jsv, sv = _pair()
    arrays = _arrays(32, seed=7)
    prepared = _prepared(arrays)
    mesh = make_mesh(8, model_parallel=4, devices=CPU8)
    annotated = ShardedExecutor(mesh)(sv, prepared)["prediction_node"].numpy()
    table = sv.params["embedding"]
    ids, wts = torch.from_numpy(prepared["feat_ids"]), torch.from_numpy(prepared["feat_wts"])
    explicit = sharded_field_embed(put(table, vocab_sharding(mesh)), ids, wts, mesh,
                                   torch.float32)
    assert torch.equal(explicit, field_embed(table, ids, wts, torch.float32))
    np.testing.assert_allclose(explicit.numpy(), np.asarray(jax_field_embed(
        jsv.params["embedding"], jnp.asarray(prepared["feat_ids"]),
        jnp.asarray(prepared["feat_wts"]), jnp.float32)), rtol=1e-6)
    np.testing.assert_allclose(annotated, _jax_golden(jsv, arrays), rtol=1e-6)
    want = np.asarray(JaxExecutor(jax_make_mesh(8, model_parallel=4))(
        jsv, prepared)["prediction_node"])
    np.testing.assert_allclose(annotated, want, rtol=1e-6)
    np.testing.assert_array_equal(annotated, _single_golden(sv, prepared))


def test_dlrm_on_mesh():
    """The embedding-heavy family on a (4, 2) mesh."""
    jsv, sv = _pair(kind="dlrm", bottom_mlp_dims=(8, 4))
    arrays = _arrays(64, seed=9)
    got = ShardedExecutor(make_mesh(8, model_parallel=2, devices=CPU8))(
        sv, _prepared(arrays))["prediction_node"].numpy()
    want = np.asarray(JaxExecutor(jax_make_mesh(8, model_parallel=2))(
        jsv, _prepared(arrays))["prediction_node"])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got, _jax_golden(jsv, arrays), rtol=1e-6)
    np.testing.assert_array_equal(got, _single_golden(sv, _prepared(arrays)))


def test_tensor_parallel_scores_match_replicated():
    """TP is a layout change only: the reassembled weights are the
    replicated ones, so the scores are the replicated layout's bits, and the
    JAX package's within its TP rtol."""
    jsv, sv = _pair(seed=3)
    arrays = _arrays(64, seed=4)
    mesh = make_mesh(8, model_parallel=2, devices=CPU8)
    tp = ShardedExecutor(mesh, tensor_parallel=True)(sv, _prepared(arrays))
    plain = ShardedExecutor(mesh)(sv, _prepared(arrays))
    got = tp["prediction_node"].numpy()
    np.testing.assert_array_equal(got, plain["prediction_node"].numpy())
    np.testing.assert_allclose(got, _jax_golden(jsv, arrays), rtol=1e-5)
    want = np.asarray(JaxExecutor(jax_make_mesh(8, model_parallel=2), tensor_parallel=True)(
        jsv, _prepared(arrays))["prediction_node"])
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_tensor_parallel_shardings_split_dense_weights():
    """The TP layout splits: 2-D dense weights get a model-axis component;
    non-divisible dims (the (d, 1) output head) stay replicated; the same
    spec per leaf as the JAX package."""
    jsv, sv = _pair()
    mesh = make_mesh(8, model_parallel=2, devices=CPU8)
    sh = param_shardings(sv.params, mesh, tensor_parallel=True)
    assert sh["mlp"][0]["w"].spec == P(None, MODEL_AXIS)
    assert sh["cross"][0]["w"].spec == P(None, MODEL_AXIS)
    assert sh["out"]["w"].spec in (P(MODEL_AXIS, None), P())
    assert sh["embedding"].spec == P(MODEL_AXIS, None)  # EP regardless of TP
    assert param_shardings(sv.params, mesh)["mlp"][0]["w"].spec == P()
    jmesh = jax_make_mesh(8, model_parallel=2)
    assert _spec_map(sh) == _spec_map(
        jax_param_shardings(jsv.params, jmesh, tensor_parallel=True), jax_tree=True)
    placed = place_params(sv.params, mesh, tensor_parallel=True)
    w = placed["mlp"][0]["w"]
    assert w.addressable_shards[1].data.shape == (32, 8)
    assert torch.equal(w.local(0), sv.params["mlp"][0]["w"])  # the weight all-gather


def test_tensor_parallel_training_step():
    """One sharded train step under dp + ep + tp on both packages: the
    loss finite, the params keep their TP layout after the update
    (tests/test_parallel.py:233-244); tests/test_torch_train_mesh.py holds
    the port's step to the JAX step."""
    from distributed_tf_serving_tpu.train import Trainer as JaxTrainer
    from distributed_tf_serving_tpu_torch.train.trainer import Trainer

    jtr = JaxTrainer(jax_build("dcn_v2", JaxConfig(**KW)), mesh=jax_make_mesh(8, model_parallel=2),
                     seed=0, tensor_parallel=True)
    assert np.isfinite(jtr.fit(steps=2, batch_size=32)["loss"])
    tr = Trainer(build_model("dcn_v2", ModelConfig(**KW)),
                 mesh=make_mesh(8, model_parallel=2, devices=CPU8), seed=0, tensor_parallel=True,
                 device="cpu")
    assert np.isfinite(tr.fit(steps=2, batch_size=32)["loss"])
    assert tr.state.params["mlp"][0]["w"].spec == P(None, MODEL_AXIS)
    assert jtr.state.params["mlp"][0]["w"].sharding.spec == jax.sharding.PartitionSpec(
        None, MODEL_AXIS)


def test_tp_bias_follows_sibling_weight_split():
    """A 1-D param rides the model axis only beside a column-split 2-D
    sibling of its length; 1-D params with no such sibling stay
    replicated, in both packages."""
    mesh = make_mesh(8, model_parallel=2, devices=CPU8)
    shapes = {"proj": {"w": (8, 4), "b": (4,)}, "gate": {"w": (4,), "b": (4,)}}
    params = {k: {n: torch.zeros(s) for n, s in v.items()} for k, v in shapes.items()}
    sh = param_shardings(params, mesh, tensor_parallel=True)
    assert sh["proj"]["w"].spec == P(None, MODEL_AXIS)
    assert sh["proj"]["b"].spec == P(MODEL_AXIS)
    assert sh["gate"]["w"].spec == P()
    assert sh["gate"]["b"].spec == P()
    jparams = {k: {n: np.zeros(s) for n, s in v.items()} for k, v in shapes.items()}
    assert _spec_map(sh) == _spec_map(jax_param_shardings(
        jparams, jax_make_mesh(8, model_parallel=2), tensor_parallel=True), jax_tree=True)


FAMILIES = [("dcn", {}), ("dcn_v2", {}), ("wide_deep", {}), ("deepfm", {}),
            ("two_tower", {"num_user_fields": 4}), ("dlrm", {"bottom_mlp_dims": (8, 4)}),
            ("generic", {})]


@pytest.mark.parametrize("kind,over", FAMILIES, ids=[k for k, _ in FAMILIES])
@pytest.mark.parametrize("tensor_parallel", [False, True], ids=["ep", "tp"])
def test_param_shardings_spec_per_leaf_equals_jax(kind, over, tensor_parallel):
    """param_shardings gives the JAX package's spec for every leaf of every
    family, with and without the family's rules, and the executor scores
    the family on a (2, 4) mesh within rtol 1e-6 of JAX (bit-equal to one
    device)."""
    jsv, sv = _pair(kind=kind, **over)
    mesh = make_mesh(8, model_parallel=4, devices=CPU8)
    jmesh = jax_make_mesh(8, model_parallel=4)
    for model_kind in (None, kind):
        assert _spec_map(param_shardings(sv.params, mesh, tensor_parallel, model_kind)) == \
            _spec_map(jax_param_shardings(jsv.params, jmesh, tensor_parallel, model_kind),
                      jax_tree=True)
    arrays = _arrays(24, seed=13)
    got = ShardedExecutor(mesh, tensor_parallel=tensor_parallel)(
        sv, _prepared(arrays))["prediction_node"].numpy()
    np.testing.assert_allclose(got, _jax_golden(jsv, arrays), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got, _single_golden(sv, _prepared(arrays)))


def test_client_full_async_mode_knob():
    """ClientConfig.full_async_mode reaches the port's client: sequential
    host-order shard issue (False) merges exactly as the concurrent fan-out
    would."""
    from distributed_tf_serving_tpu_torch.client import client_from_config
    from distributed_tf_serving_tpu_torch.utils.config import ClientConfig

    calls = []

    async def go():
        client = client_from_config(ClientConfig(hosts=("h1", "h2"), full_async_mode=False))
        assert client.full_async is False
        assert client.hosts == ["h1", "h2"]

        async def fake_shard(i, shard, rr, budget=None):
            calls.append(i)
            await asyncio.sleep(0.01 if i == 0 else 0)  # tempt reordering
            return np.full((shard["feat_ids"].shape[0],), float(i), np.float32)

        client._predict_shard = fake_shard
        merged = await client.predict({"feat_ids": np.zeros((6, 3), np.int64),
                                       "feat_wts": np.zeros((6, 3), np.float32)})
        await client.close()
        return merged

    merged = asyncio.run(go())
    assert calls == [0, 1]  # strictly sequential in host order
    np.testing.assert_array_equal(merged, [0, 0, 0, 1, 1, 1])

