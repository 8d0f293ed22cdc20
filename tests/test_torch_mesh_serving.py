"""The mesh serving mode of the port against the JAX package, case for case
with the mesh cases of tests/test_mesh_serving.py (its affinity cases are
the client's, tests/test_torch_partition.py): named partition rules, the
data-axis divisibility pad, output selection and the int8 wire over the
mesh, build_stack's wiring and refusals, the `mesh` monitoring / Prometheus
surfaces and per-device utilization attribution. The JAX package runs on
the 8 virtual CPU devices, the port on eight logical CPU shards, on the
same seeded numpy inputs with the params carried across by
convert.params_from_jax.

Tolerances against the JAX package are the JAX tests' own (rtol 1e-6;
1e-5 with TP). The JAX tests' bit-identity (filtered path, pad, int8 wire,
the mesh server against the single-device one) is held against the same
rows scored in one call on one device (`_single_golden`): a row's bits do
not depend on the row count of its shard's call (models/base.py ROW_TILE;
tests/test_torch_row_count.py)."""

import dataclasses
import os
import sys

import jax
import numpy as np
import pytest
import torch

from distributed_tf_serving_tpu.models import ModelConfig as JaxConfig
from distributed_tf_serving_tpu.models import Servable as JaxServable
from distributed_tf_serving_tpu.models import build_model as jax_build
from distributed_tf_serving_tpu.models import ctr_signatures as jax_signatures
from distributed_tf_serving_tpu.parallel import ShardedExecutor as JaxExecutor
from distributed_tf_serving_tpu.parallel import make_mesh as jax_make_mesh
from distributed_tf_serving_tpu.parallel import match_partition_rules as jax_match_rules
from distributed_tf_serving_tpu.parallel import param_shardings as jax_param_shardings
from distributed_tf_serving_tpu.parallel import partition_rules_for as jax_rules_for
from distributed_tf_serving_tpu.parallel import tree_path_str as jax_tree_path
from distributed_tf_serving_tpu.serving import DynamicBatcher as JaxBatcher
from distributed_tf_serving_tpu.serving.batcher import fold_ids_host as jax_fold
from distributed_tf_serving_tpu.serving.server import build_stack as jax_build_stack
from distributed_tf_serving_tpu.serving.utilization import OccupancyLedger as JaxLedger
from distributed_tf_serving_tpu.utils import config as jax_config
from distributed_tf_serving_tpu.utils.metrics import ServerMetrics as JaxMetrics
from distributed_tf_serving_tpu_torch import codec
from distributed_tf_serving_tpu_torch.convert import params_from_jax
from distributed_tf_serving_tpu_torch.models import ModelConfig, Servable, build_model
from distributed_tf_serving_tpu_torch.models import ctr_signatures
from distributed_tf_serving_tpu_torch.ops.transfer import restore_outputs_host
from distributed_tf_serving_tpu_torch.parallel import (
    MODEL_AXIS,
    ShardedExecutor,
    make_mesh,
    match_partition_rules,
    param_shardings,
    partition_rules_for,
    tree_path_str,
)
from distributed_tf_serving_tpu_torch.parallel.embedding_sharding import tree_map_with_path
from distributed_tf_serving_tpu_torch.parallel.mesh import P
from distributed_tf_serving_tpu_torch.serving.batcher import DynamicBatcher, fold_ids_host
from distributed_tf_serving_tpu_torch.serving.server import build_stack
from distributed_tf_serving_tpu_torch.serving.utilization import OccupancyLedger
from distributed_tf_serving_tpu_torch.train.checkpoint import save_servable
from distributed_tf_serving_tpu_torch.utils.config import (
    KernelsConfig,
    MeshConfig,
    RecoveryConfig,
    ServerConfig,
    load_config,
)
from distributed_tf_serving_tpu_torch.utils.metrics import ServerMetrics

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
from check_prom import lint_text  # noqa: E402

KW = dict(num_fields=8, vocab_size=1024, embed_dim=4, mlp_dims=(16,), num_cross_layers=1,
          compute_dtype="float32")
CFG = ModelConfig(**KW)
CPU8 = [torch.device("cpu")] * 8


def _pair(seed=0, kind="dcn_v2", **over):
    jcfg = JaxConfig(**{**KW, **over})
    jm = jax_build(kind, jcfg)
    jsv = JaxServable(name="DCN", version=1, model=jm, params=jm.init(jax.random.PRNGKey(seed)),
                      signatures=jax_signatures(jcfg.num_fields))
    m = build_model(kind, ModelConfig(**{**KW, **over}))
    sv = Servable(name="DCN", version=1, model=m,
                  params=params_from_jax(jax.tree.map(np.asarray, jsv.params)),
                  signatures=ctr_signatures(jcfg.num_fields))
    return jsv, sv


def _arrays(n, seed=0):
    rng = np.random.RandomState(seed)
    return {
        "feat_ids": rng.randint(0, 1 << 40, size=(n, 8)).astype(np.int64),
        "feat_wts": rng.rand(n, 8).astype(np.float32),
    }


def _prepared(arrays):
    return {"feat_ids": fold_ids_host(arrays["feat_ids"], 1024), "feat_wts": arrays["feat_wts"]}


def _jax_golden(jsv, arrays):
    batch = {"feat_ids": jax_fold(arrays["feat_ids"], 1024), "feat_wts": arrays["feat_wts"]}
    return np.asarray(jax.jit(jsv.model.apply)(jsv.params, batch)["prediction_node"])


def _apply(sv, batch):
    with torch.inference_mode():
        return sv.model.apply(sv.params, {k: torch.from_numpy(np.ascontiguousarray(v))
                                          for k, v in batch.items()})["prediction_node"].numpy()


def _single_golden(sv, prepared, bucket=None):
    """The same rows padded to `bucket` (the batcher's pad) scored in one
    call on one device."""
    n = next(iter(prepared.values())).shape[0]
    rows = bucket or n
    padded = {}
    for k, v in prepared.items():
        buf = np.zeros((rows,) + v.shape[1:], v.dtype)
        buf[:n] = v
        padded[k] = buf
    return _apply(sv, padded)[:n]


def _paths(tree):
    out = []
    tree_map_with_path(lambda p, _l: out.append(tree_path_str(p)), tree)
    return out


# ------------------------------------------------------- partition rules


def test_build_model_stamps_kind():
    assert build_model("dcn_v2", CFG).kind == jax_build("dcn_v2", JaxConfig(**KW)).kind == "dcn_v2"
    cfg = dataclasses.replace(CFG, bottom_mlp_dims=(8, 4))
    assert build_model("dlrm", cfg).kind == "dlrm"


def test_tree_path_str_handles_dicts_and_lists():
    params = {"cross": [{"w": np.zeros((4, 4))}]}
    assert _paths(params) == ["cross/0/w"]
    theirs = []
    jax.tree_util.tree_map_with_path(
        lambda p, _l: theirs.append(jax_tree_path(p)), params)
    assert theirs == ["cross/0/w"]


@pytest.mark.parametrize("kind", ["dcn_v2", "dlrm", "two_tower"])
def test_named_rules_pin_embedding_tables(kind):
    over = {"dlrm": {"bottom_mlp_dims": (8, 4)}, "two_tower": {"num_user_fields": 4}}.get(kind, {})
    jsv, sv = _pair(kind=kind, **over)
    rules = partition_rules_for(kind)
    assert rules is not None
    specs = match_partition_rules(rules, sv.params)
    assert specs["embedding"] == P(MODEL_AXIS, None)
    theirs = jax_match_rules(jax_rules_for(kind), jsv.params)
    assert tuple(theirs["embedding"]) == tuple(specs["embedding"])
    assert [(pat, tuple(spec)) for pat, spec in rules] == \
        [(pat, tuple(spec)) for pat, spec in jax_rules_for(kind)]


def test_two_tower_temperature_is_explicitly_replicated():
    _jsv, sv = _pair(kind="two_tower", num_user_fields=4)
    specs = match_partition_rules(partition_rules_for("two_tower"), sv.params)
    assert specs["temperature"] == P()


def test_rule_rank_mismatch_raises():
    with pytest.raises(ValueError, match="no longer matches"):
        match_partition_rules((("^embedding$", P(MODEL_AXIS, None)),),
                              {"embedding": torch.zeros((16,))})  # 1-D table vs 2-dim rule


def test_unmatched_leaf_none_or_strict_raises():
    rules = (("^embedding$", P(MODEL_AXIS, None)),)
    params = {"embedding": torch.zeros((16, 4)), "mlp": torch.zeros((4, 4))}
    assert match_partition_rules(rules, params)["mlp"] is None
    with pytest.raises(ValueError, match="no partition rule matched"):
        match_partition_rules(rules, params, strict=True)


def test_param_shardings_with_rules_match_generic_layout():
    """The named-rule path lands the generic walker's layout for the zoo,
    and the JAX package's."""
    jsv, sv = _pair()
    mesh = make_mesh(8, model_parallel=2, devices=CPU8)
    generic = param_shardings(sv.params, mesh, tensor_parallel=True)
    ruled = param_shardings(sv.params, mesh, tensor_parallel=True, model_kind="dcn_v2")
    flat = lambda t: [s.spec for s in _leaves(t)]  # noqa: E731
    assert flat(generic) == flat(ruled)
    theirs = jax_param_shardings(jsv.params, jax_make_mesh(8, model_parallel=2),
                                 tensor_parallel=True, model_kind="dcn_v2")
    ours = dict(zip(_paths(ruled), flat(ruled)))
    for path, s in jax.tree_util.tree_flatten_with_path(theirs)[0]:
        assert tuple(ours[jax_tree_path(path)]) == tuple(s.spec)


def _leaves(tree):
    out = []
    tree_map_with_path(lambda _p, leaf: out.append(leaf), tree)
    return out


# --------------------------------------------------- divisibility fix


@pytest.mark.parametrize("rows", [5, 10, 50, 63])
def test_executor_pads_non_divisible_batches(rows):
    """Any bucket size is padded to the data axis inside the executor and
    sliced back, never refused."""
    jsv, sv = _pair()
    ex = ShardedExecutor(make_mesh(8, model_parallel=2, devices=CPU8))  # data axis 4
    arrays = _arrays(rows, seed=11)
    out = ex(sv, _prepared(arrays))["prediction_node"].numpy()
    assert out.shape == (rows,)
    np.testing.assert_allclose(out, _jax_golden(jsv, arrays), rtol=1e-6)
    np.testing.assert_array_equal(out, _single_golden(sv, _prepared(arrays)))
    jex = JaxExecutor(jax_make_mesh(8, model_parallel=2))
    np.testing.assert_allclose(out, np.asarray(jex(jsv, _prepared(arrays))["prediction_node"]),
                               rtol=1e-6)
    snap, theirs = ex.snapshot()["executor"], jex.snapshot()["executor"]
    for key in ("batches", "rows", "pad_batches", "data_pad_rows", "placed_servables", "layout"):
        assert snap[key] == theirs[key], key
    if rows % 4:
        assert snap["pad_batches"] >= 1 and snap["data_pad_rows"] >= 1
    else:
        assert snap["pad_batches"] == 0


def test_batcher_arbitrary_buckets_over_mesh_bit_identical():
    """A ladder of non-mesh-shaped rungs serves over the mesh: filtered
    and unfiltered, the single-device bits, within rtol of the JAX mesh."""
    jsv, sv = _pair()
    ex = ShardedExecutor(make_mesh(8, model_parallel=2, devices=CPU8))
    b = DynamicBatcher(buckets=(10, 50), max_wait_us=0, device="cpu", run_fn=ex).start()
    jb = JaxBatcher(buckets=(10, 50), max_wait_us=0,
                    run_fn=JaxExecutor(jax_make_mesh(8, model_parallel=2))).start()
    try:
        for n, seed in [(7, 1), (33, 2), (50, 3)]:
            arrays = _arrays(n, seed)
            want = _single_golden(sv, _prepared(arrays), 10 if n <= 10 else 50)
            keys = ("prediction_node",)
            got = b.submit(sv, arrays, output_keys=keys).result(timeout=60)["prediction_node"]
            np.testing.assert_array_equal(got, want)
            unfiltered = b.submit(sv, arrays).result(timeout=60)
            np.testing.assert_array_equal(unfiltered["prediction_node"], want)
            theirs = jb.submit(jsv, arrays, output_keys=keys).result(timeout=60)
            np.testing.assert_allclose(got, theirs["prediction_node"], rtol=1e-6)
            np.testing.assert_allclose(got, _jax_golden(jsv, arrays), rtol=1e-6)
    finally:
        b.stop()
        jb.stop()
    assert ex.snapshot()["executor"]["pad_batches"] >= 1


def test_executor_out_keys_filter_and_sidecar_passthrough():
    """Output selection rides through the mesh executor: a score-only union
    fetches only the score tensor, with the all-outputs call's bits."""
    jsv, sv = _pair()
    ex = ShardedExecutor(make_mesh(8, devices=CPU8))
    arrays = _prepared(_arrays(16, seed=4))
    full = ex(sv, arrays)
    assert set(full) >= {"prediction_node", "logits"}
    only = ex(sv, arrays, out_keys=("prediction_node",))
    assert set(only) == {"prediction_node"}
    assert torch.equal(only["prediction_node"], full["prediction_node"])
    theirs = JaxExecutor(jax_make_mesh(8))(jsv, arrays, out_keys=("prediction_node",))
    assert set(theirs) == set(only)


def test_batcher_passes_out_keys_union_to_mesh_executor():
    jsv, sv = _pair()
    seen = []

    class Spy(ShardedExecutor):
        def __call__(self, servable, arrays, out_keys=None):
            seen.append(out_keys)
            return super().__call__(servable, arrays, out_keys=out_keys)

    b = DynamicBatcher(buckets=(32,), max_wait_us=0, device="cpu",
                       run_fn=Spy(make_mesh(8, devices=CPU8))).start()
    try:
        arrays = _arrays(8, seed=5)
        got = b.submit(sv, arrays, output_keys=("prediction_node",)).result(timeout=60)
        assert set(got) == {"prediction_node"}
        np.testing.assert_array_equal(got["prediction_node"],
                                      _single_golden(sv, _prepared(arrays), 32))
        np.testing.assert_allclose(got["prediction_node"], _jax_golden(jsv, arrays), rtol=1e-6)
    finally:
        b.stop()
    assert ("prediction_node",) in seen


def test_padded_precision_contract():
    """At a padded shape (7 rows on a data axis of 4) the filtered and the
    unfiltered outputs are the single-device bits; the JAX package
    holds its unfiltered variant to rtol 1e-6, and so does this test
    against it."""
    jsv, sv = _pair(seed=19)
    ex = ShardedExecutor(make_mesh(8, model_parallel=2, devices=CPU8))
    arrays = _arrays(7, seed=20)
    want = _single_golden(sv, _prepared(arrays))
    filtered = ex(sv, _prepared(arrays), out_keys=("prediction_node",))["prediction_node"]
    np.testing.assert_array_equal(filtered.numpy(), want)
    unfiltered = ex(sv, _prepared(arrays))["prediction_node"].numpy()
    np.testing.assert_array_equal(unfiltered, want)
    np.testing.assert_allclose(unfiltered, _jax_golden(jsv, arrays), rtol=1e-6)


def test_int8_wire_quantization_excludes_pad_rows():
    """The divisibility pad comes off BEFORE the int8 wire's per-tensor
    quantization: the restored output is exactly the codec round trip of
    the UNPADDED scores."""
    jsv, sv = _pair(seed=21)
    ex = ShardedExecutor(make_mesh(8, model_parallel=2, devices=CPU8), output_wire_dtype="int8")
    arrays = _arrays(10, seed=22)  # 10 % 4 != 0 -> 2 pad rows
    out = ex(sv, _prepared(arrays))
    assert out["prediction_node"].dtype == torch.int8
    got = restore_outputs_host({k: v.numpy() for k, v in out.items()})["prediction_node"]
    assert got.shape == (10,)
    q, scale, mn = codec.quantize_scores(_single_golden(sv, _prepared(arrays)))
    np.testing.assert_array_equal(got, codec.dequantize_scores(q, scale, mn))
    theirs = JaxExecutor(jax_make_mesh(8, model_parallel=2), output_wire_dtype="int8")(
        jsv, _prepared(arrays))
    from distributed_tf_serving_tpu.ops.transfer import restore_outputs_host as jax_restore

    want = jax_restore({k: np.asarray(v) for k, v in theirs.items()})["prediction_node"]
    np.testing.assert_allclose(got, want, atol=2 * scale)  # one int8 step of slack


# ------------------------------------------------- build_stack wiring


def _mesh_cfg(**kw):
    return MeshConfig(enabled=True, devices=8, model_parallel=2, **kw)


def _server_cfg(**kw):
    base = dict(model_kind="dcn_v2", model_name="DCN", num_fields=8, buckets=(10, 50),
                max_wait_us=0, warmup=False)
    base.update(kw)
    return ServerConfig(**base)


def _jax_server_cfg(**kw):
    base = dict(model_kind="dcn_v2", model_name="DCN", num_fields=8, buckets=(10, 50),
                max_wait_us=0, warmup=False)
    base.update(kw)
    return jax_config.ServerConfig(**base)


def test_build_stack_mesh_mode_serves_bit_identical(tmp_path):
    """build_stack with [mesh] builds the mesh, installs the executor and
    serves the single-device build's bits of the checkpoint's params, as
    the JAX tests hold theirs."""
    jsv, sv = _pair(seed=7)
    save_servable(str(tmp_path / "ckpt"), sv, kind="dcn_v2")
    impl1, batcher1, sv1 = build_stack(_server_cfg(), CFG, "cpu",
                                       checkpoint=str(tmp_path / "ckpt"))
    impl2, batcher2, sv2 = build_stack(_server_cfg(), CFG, "cpu",
                                       checkpoint=str(tmp_path / "ckpt"),
                                       mesh_config=_mesh_cfg(), mesh_device_list=CPU8)
    try:
        assert impl1.mesh_executor is None and impl2.mesh_executor is not None
        assert impl2.mesh_executor.mesh.shape == {"data": 4, "model": 2}
        for n, seed in [(9, 1), (41, 2)]:
            arrays = _arrays(n, seed)
            keys = ("prediction_node",)
            a = batcher1.submit(sv1, arrays, output_keys=keys).result(timeout=120)
            b = batcher2.submit(sv2, arrays, output_keys=keys).result(timeout=120)
            np.testing.assert_array_equal(
                b["prediction_node"],
                _single_golden(sv, _prepared(arrays), 10 if n <= 10 else 50))
            np.testing.assert_array_equal(b["prediction_node"], a["prediction_node"])
            np.testing.assert_allclose(b["prediction_node"], _jax_golden(jsv, arrays),
                                       rtol=1e-6)
        snap = impl2.mesh_stats()
        assert snap["shape"] == {"data": 4, "model": 2}
        assert len(snap["devices"]) == 8
        assert snap["executor"]["batches"] >= 2
        assert snap["executor"]["layout"]["DCN"] == "rules:dcn_v2"
        assert impl1.mesh_stats() is None
    finally:
        batcher1.stop()
        batcher2.stop()


def _refusals():
    return [
        (dict(kernels_config=KernelsConfig(enabled=True)),
         dict(kernels_config=jax_config.KernelsConfig(enabled=True)), "single-chip batcher path"),
        (dict(recovery_config=RecoveryConfig(enabled=True, scope="per_chip")),
         dict(recovery_config=jax_config.RecoveryConfig(enabled=True, scope="per_chip")),
         "per_chip"),
    ]


def test_build_stack_refusals():
    """Each combination the JAX build_stack refuses over a mesh, refused in
    its words; whole-executor recovery composes."""
    for ours_kw, theirs_kw, match in _refusals():
        with pytest.raises(ValueError, match=match) as ours:
            build_stack(_server_cfg(), CFG, "cpu", mesh_config=_mesh_cfg(),
                        mesh_device_list=CPU8, **ours_kw)
        with pytest.raises(ValueError, match=match) as theirs:
            jax_build_stack(_jax_server_cfg(), model_config=JaxConfig(**KW),
                            mesh_config=jax_config.MeshConfig(enabled=True, devices=8,
                                                              model_parallel=2), **theirs_kw)
        assert str(ours.value) == str(theirs.value)
    impl, b, _sv = build_stack(_server_cfg(), CFG, "cpu", mesh_config=_mesh_cfg(),
                               mesh_device_list=CPU8,
                               recovery_config=RecoveryConfig(enabled=True))
    try:
        assert impl.recovery is not None
    finally:
        b.stop()
    for legacy in ({"mesh_devices": 8}, {"model_parallel": 2}, {"tensor_parallel": True},
                   {"output_top_k": 4}):
        with pytest.raises(ValueError) as ours:
            build_stack(_server_cfg(**legacy), CFG, "cpu", mesh_config=_mesh_cfg(),
                        mesh_device_list=CPU8)
        with pytest.raises(ValueError) as theirs:
            jax_build_stack(_jax_server_cfg(**legacy), model_config=JaxConfig(**KW),
                            mesh_config=jax_config.MeshConfig(enabled=True, devices=8,
                                                              model_parallel=2))
        assert str(ours.value) == str(theirs.value)
        assert "legacy [server]" in str(ours.value) or "output_top_k" in str(ours.value)


def test_mesh_tensor_parallel_preplaces_loaded_params(tmp_path):
    """[mesh] tensor_parallel reaches the loader path: the checkpoint's
    params are placed in the model-axis-split layout before the first
    batch, and serve within the TP rtol."""
    jsv, sv = _pair(seed=8)
    save_servable(str(tmp_path / "ckpt"), sv, kind="dcn_v2")
    impl, batcher, loaded = build_stack(_server_cfg(), CFG, "cpu",
                                        checkpoint=str(tmp_path / "ckpt"),
                                        mesh_config=_mesh_cfg(tensor_parallel=True),
                                        mesh_device_list=CPU8)
    try:
        ex = impl.mesh_executor
        assert ex.tensor_parallel is True and ex.batches == 0
        # mlp[0].w is (32, 16): the output dim divides mp = 2 -> column split.
        assert ex._placed[loaded][1]["mlp"][0]["w"].spec == P(None, MODEL_AXIS)
        arrays = _arrays(20, seed=6)
        got = batcher.submit(loaded, arrays).result(timeout=120)
        np.testing.assert_allclose(got["prediction_node"], _jax_golden(jsv, arrays), rtol=1e-5)
    finally:
        batcher.stop()


def test_mesh_config_validation_and_parse(tmp_path):
    for bad, match in (({"enabled": True, "devices": 6, "model_parallel": 4}, "not divisible"),
                       ({"devices": -1}, "non-negative")):
        with pytest.raises(ValueError, match=match) as ours:
            MeshConfig(**bad)
        with pytest.raises(ValueError, match=match) as theirs:
            jax_config.MeshConfig(**bad)
        assert str(ours.value) == str(theirs.value)
    toml = tmp_path / "cfg.toml"
    toml.write_text("[mesh]\nenabled = true\ndevices = 8\nmodel_parallel = 2\n"
                    "tensor_parallel = false\n")
    mc = load_config(str(toml))["mesh"]
    assert mc.enabled and mc.devices == 8 and mc.model_parallel == 2
    assert dataclasses.asdict(mc) == dataclasses.asdict(jax_config.load_config(str(toml))["mesh"])
    # An absent section parses to the disabled default.
    plain = tmp_path / "plain.toml"
    plain.write_text("[server]\nport = 9999\n")
    assert load_config(str(plain))["mesh"].enabled is False


def test_mesh_prometheus_series():
    _jsv, sv = _pair()
    ex = ShardedExecutor(make_mesh(8, model_parallel=2, devices=CPU8))
    ex(sv, _prepared(_arrays(10, seed=3)))  # one padded batch
    snap = ex.snapshot()
    snap["per_device"] = {d: {"busy_fraction": 0.5} for d in snap["devices"]}
    text = ServerMetrics().prometheus_text(mesh=snap)
    assert lint_text(text) == []
    assert "dts_tpu_mesh_devices 8" in text
    assert "dts_tpu_mesh_data_parallel 4" in text
    assert "dts_tpu_mesh_model_parallel 2" in text
    assert "dts_tpu_mesh_pad_batches_total 1" in text
    assert text.count("dts_tpu_mesh_device_busy_fraction{") == 8
    # The samples are the JAX package's (the HELP texts speak of devices).
    mesh_lines = lambda t: [ln for ln in t.splitlines()  # noqa: E731
                            if ln.startswith("dts_tpu_mesh_")]
    assert mesh_lines(text) == mesh_lines(JaxMetrics().prometheus_text(mesh=snap))


def test_utilization_per_device_attribution():
    snaps = []
    for cls in (OccupancyLedger, JaxLedger):
        t = [0.0]
        ledger = cls(clock=lambda: t[0])
        ledger.devices = ["dev:0", "dev:1"]
        t[0] = 1.0
        ledger.note_batch(0.2, 0.8, 1.0, bucket=32, candidates=20, d2h_wait_s=0.1)
        snap = ledger.snapshot(window_s=2.0)
        assert snap["devices"] == ["dev:0", "dev:1"]
        assert set(snap["per_device"]) == {"dev:0", "dev:1"}
        assert snap["per_device"]["dev:0"]["busy_fraction"] > 0
        assert snap["occupancy_attribution"] == "spmd_uniform"
        events = ledger.chrome_counter_events(0.0, pid=1)
        names = {e["args"]["name"] for e in events if e["name"] == "thread_name"}
        assert names == {"dev:0", "dev:1"}
        for tid in (0, 1):
            ts = [e["ts"] for e in events if e.get("ph") == "C" and e["tid"] == tid]
            assert ts and ts == sorted(ts)
        snaps.append(snap)
    assert snaps[0]["per_device"] == snaps[1]["per_device"]


def test_build_stack_labels_the_ledger_with_the_mesh_devices():
    """build_stack names the utilization ledger after the mesh and gives it
    one device per shard (a logical shard keeps its own label), and
    mesh_stats lifts the per-device attribution from it."""
    from distributed_tf_serving_tpu_torch.utils.config import UtilizationConfig

    impl, b, sv = build_stack(_server_cfg(), CFG, "cpu", mesh_config=_mesh_cfg(),
                              mesh_device_list=CPU8,
                              utilization_config=UtilizationConfig(enabled=True))
    try:
        b.submit(sv, _arrays(7, 1)).result(timeout=60)
        assert b.utilization.device == "mesh{'data': 4, 'model': 2}"
        snap = impl.mesh_stats()
        assert sorted(snap["per_device"]) == sorted(f"cpu/{k}" for k in range(8))
        assert snap["occupancy_attribution"] == "spmd_uniform"
    finally:
        b.stop()
