"""The port's kernel/quantization plane on the CPU: the [kernels] config,
the KernelManager autotune driving a CPU batcher (gates, measure-only,
persistence, identity guard, the plane off), and the gRPC server with the
plane armed, scored by the JAX package's client and held to JAX
model.apply on the tree the decision picked.

On the CPU the fused variants are ineligible (the CUDA kernels have no CPU
mode), so the decisions here are between the float baseline and xla_int8;
the fused variants' own checks run on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import asyncio
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from distributed_tf_serving_tpu.client import ShardedPredictClient
from distributed_tf_serving_tpu.models import ModelConfig as JaxConfig
from distributed_tf_serving_tpu.models import build_model as jax_build
from distributed_tf_serving_tpu.ops import quantize as jq
from distributed_tf_serving_tpu.serving.batcher import fold_ids_host as jax_fold
from distributed_tf_serving_tpu.utils.config import KernelsConfig as JaxKernelsConfig
from distributed_tf_serving_tpu_torch.convert import params_from_jax
from distributed_tf_serving_tpu_torch.models import (
    ModelConfig,
    Servable,
    ServableRegistry,
    build_model,
    ctr_signatures,
)
from distributed_tf_serving_tpu_torch.ops import cross_kernel as ck
from distributed_tf_serving_tpu_torch.ops.autotune import (
    BASELINE,
    CPU_REASON,
    PALLAS_F32,
    PALLAS_INT8,
    VARIANT_FLAGS,
    XLA_INT8,
    KernelManager,
)
from distributed_tf_serving_tpu_torch.ops.quantize import quantize_params
from distributed_tf_serving_tpu_torch.serving.batcher import DynamicBatcher
from distributed_tf_serving_tpu_torch.serving.server import build_stack, create_server
from distributed_tf_serving_tpu_torch.utils.config import (
    KernelsConfig,
    ServerConfig,
    load_config,
)

F = 6
KW = dict(num_fields=F, vocab_size=1009, embed_dim=8, mlp_dims=(32, 16), num_cross_layers=2,
          compute_dtype="float32")


def _jax_pair(seed=0):
    jm = jax_build("dcn_v2", JaxConfig(**KW))
    return jm, jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))


def _servable(seed=0, version=1):
    _, jp = _jax_pair(seed)
    return Servable(name="DCN", version=version, model=build_model("dcn_v2", ModelConfig(**KW)),
                    params=params_from_jax(jp), signatures=ctr_signatures(F))


@pytest.fixture(scope="module")
def servable():
    return _servable()


def make_arrays(n, seed=0):
    rng = np.random.RandomState(seed)
    return {
        "feat_ids": rng.randint(0, 1 << 40, size=(n, F)).astype(np.int64),
        "feat_wts": rng.rand(n, F).astype(np.float32),
    }


def golden(sv, arrays, params=None):
    batch = {"feat_ids": torch.from_numpy(arrays["feat_ids"]),
             "feat_wts": torch.from_numpy(arrays["feat_wts"])}
    return sv.model.apply(params or sv.params, batch)["prediction_node"].numpy()


def _manager(tmp_path=None, **over):
    kw = dict(enabled=True, table_file="", measure_iters=2, min_speedup=0.01)
    if tmp_path is not None:
        kw["table_file"] = str(tmp_path / "kernel_autotune.json")
    kw.update(over)
    return KernelManager(KernelsConfig(**kw))


@pytest.fixture
def batcher(servable):
    b = DynamicBatcher(buckets=(16, 32), max_wait_us=0, device="cpu")
    b.warmup(servable)
    b.start()
    try:
        yield b
    finally:
        b.stop()


# ------------------------------------------------------------------ config


def test_kernels_config_parsing_matches_jax(tmp_path):
    path = tmp_path / "cfg.toml"
    path.write_text(
        "[kernels]\nenabled = true\npallas = false\nmin_speedup = 1.1\n"
        "max_abs_delta = 0.003\nmeasure_only = true\nautotune_buckets = [64, 256]\n"
    )
    cfg = load_config(path)["kernels"]
    assert cfg.enabled and not cfg.pallas and cfg.measure_only
    assert cfg.min_speedup == 1.1 and cfg.autotune_buckets == (64, 256)
    # Same fields and defaults as the JAX package's [kernels] section, but
    # its own table file: a JAX server and a port server in one checkout
    # must not overwrite each other's persisted decisions.
    ours = {f.name: f.default for f in dataclasses.fields(KernelsConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxKernelsConfig)}
    assert ours.pop("table_file") == "artifacts/kernel_autotune_torch.json"
    assert theirs.pop("table_file") != "artifacts/kernel_autotune_torch.json"
    assert ours == theirs
    empty = tmp_path / "empty.toml"
    empty.write_text("")
    assert "kernels" not in load_config(empty)


def test_kernels_config_validation():
    with pytest.raises(ValueError, match="min_speedup"):
        KernelsConfig(min_speedup=0)
    with pytest.raises(ValueError, match="max_abs_delta"):
        KernelsConfig(max_abs_delta=-1.0)
    with pytest.raises(ValueError, match="measure_iters"):
        KernelsConfig(measure_iters=-1)
    with pytest.raises(ValueError, match="autotune_buckets"):
        KernelsConfig(autotune_buckets=(0,))
    assert KernelsConfig().build() is None
    assert isinstance(KernelsConfig(enabled=True, table_file="").build(), KernelManager)


def test_int8_score_wire_parses_and_arms_only_a_built_plane(tmp_path):
    """The key parses; a built (enabled) plane arms its own server's int8
    score response wire, and enabled = false leaves it off."""
    path = tmp_path / "cfg.toml"
    path.write_text("[kernels]\nenabled = true\nint8_score_wire = true\n")
    kcfg = load_config(path)["kernels"]
    assert kcfg.int8_score_wire and kcfg.enabled
    assert kcfg.build().config.int8_score_wire
    assert dataclasses.replace(kcfg, enabled=False).build() is None
    cfg = ServerConfig(num_fields=F, buckets=(16,), max_wait_us=0)
    armed = {}
    for enabled in (True, False):
        impl, batcher, _ = build_stack(
            cfg, ModelConfig(**KW), "cpu",
            kernels_config=dataclasses.replace(kcfg, enabled=enabled, autotune=False,
                                               table_file=""))
        batcher.stop()
        armed[enabled] = impl.int8_score_wire
    assert armed == {True: True, False: False}
    path.write_text("[kernels]\nnot_a_knob = 1\n")
    with pytest.raises(ValueError, match="not_a_knob"):
        load_config(path)


def test_repo_configs_load_with_their_kernels_sections():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for name in ("latency.toml", "throughput.toml"):
        loaded = load_config(os.path.join(repo, "configs", name))
        assert loaded["server"].model_kind == "dcn_v2"
        assert loaded.get("kernels", KernelsConfig()) == KernelsConfig()


# ---------------------------------------------------------------- autotune


def test_autotune_decides_and_routes_live_traffic(servable, batcher):
    """min_speedup at the floor forces the int8 decision on the CPU; a live
    submit then serves through the quantized params (counter moves, scores
    within the quantization budget of the float baseline)."""
    km = _manager()
    batcher.kernels = km
    table = km.autotune(batcher, servable)
    row = table["buckets"]["32"][XLA_INT8]
    assert row["enabled"] and row["max_abs_delta"] <= 0.005
    assert row["auc_gate"] == "skipped"
    assert km.decision(servable, 32) == (True, False)
    arrays = make_arrays(20, seed=7)
    got = batcher.submit(servable, arrays).result(30)["prediction_node"]
    assert km.quantized_batches >= 1 and km.pallas_batches == 0
    assert np.max(np.abs(got - golden(servable, arrays))) < 0.01
    # The int8 tree's own forward (padded batch vs 20 rows: BLAS blocking).
    np.testing.assert_allclose(
        got, golden(servable, arrays, km.params_for(servable, True)), rtol=1e-6, atol=1e-6)


def test_fused_variants_ineligible_on_cpu_with_reason(servable, batcher):
    km = _manager()
    batcher.kernels = km
    table = km.autotune(batcher, servable)
    assert table["pallas_eligible"] is False
    assert table["pallas_ineligible_reason"] == CPU_REASON
    assert table["device"] == "cpu"
    for row in table["buckets"].values():
        assert set(row) == {BASELINE, XLA_INT8, "decision"}


@pytest.mark.parametrize("variant", [XLA_INT8, PALLAS_F32, PALLAS_INT8])
def test_failing_variant_raises_only_when_it_is_the_fused_kernel(servable, batcher, monkeypatch,
                                                                 variant):
    """A fused variant runs the CUDA kernel, which has no fallback: its
    failure stops the autotune instead of routing the bucket elsewhere. A
    failing xla_int8 is recorded with its error and left disabled. (The
    fused variants are made eligible here so that they run, through their
    plain versions on the CPU.)"""
    flags = VARIANT_FLAGS[variant]
    real = batcher._execute

    def execute(sv, arrays, keys, _kernel_override=None):
        if _kernel_override == flags:
            raise RuntimeError("launch failed")
        return real(sv, arrays, keys, _kernel_override=_kernel_override)

    monkeypatch.setattr(batcher, "_execute", execute)
    monkeypatch.setattr(KernelManager, "_fused_eligible", lambda self, sv, arrays: (True, ""))
    km = _manager()
    if flags[1]:
        with pytest.raises(RuntimeError, match=f"kernel variant {variant} failed") as info:
            km.autotune(batcher, servable)
        assert "launch failed" in str(info.value.__cause__)
        return
    table = km.autotune(batcher, servable)
    for row in table["buckets"].values():
        assert "launch failed" in row[variant]["error"] and not row[variant]["enabled"]
        assert row[PALLAS_F32]["enabled"] or row[PALLAS_INT8]["enabled"]


def test_autotune_accuracy_gate_disables(servable, batcher):
    km = _manager(max_abs_delta=1e-9)
    batcher.kernels = km
    table = km.autotune(batcher, servable)
    for row in table["buckets"].values():
        assert row["decision"] == BASELINE
        assert not row[XLA_INT8]["enabled"]
    assert km.decision(servable, 32) is None


def test_autotune_auc_gate(servable, batcher):
    km = _manager()
    batcher.kernels = km
    labels = (np.random.RandomState(8).rand(64) < 0.5).astype(np.float32)
    table = km.autotune(batcher, servable, eval_data=(make_arrays(64, seed=9), labels))
    assert table["gates"]["auc_evaluated"] and table["auc"][BASELINE] is not None
    row = table["buckets"]["32"][XLA_INT8]
    assert row["auc_gate"] in ("pass", "fail") and "auc_delta" in row


def test_auc_gate_fails_closed_on_eval_error(servable, batcher, monkeypatch):
    km = _manager()
    batcher.kernels = km
    monkeypatch.setattr(KernelManager, "_auc_of",
                        lambda self, *a, **k: (_ for _ in ()).throw(RuntimeError("boom")))
    labels = (np.random.RandomState(13).rand(32) < 0.5).astype(np.float32)
    table = km.autotune(batcher, servable, eval_data=(make_arrays(32, seed=13), labels))
    assert table["auc_errors"]
    for row in table["buckets"].values():
        assert row[XLA_INT8]["auc_gate"] == "error" and not row[XLA_INT8]["enabled"]
        assert row["decision"] == BASELINE


def test_measure_only_enables_nothing_and_is_never_adopted(servable, batcher, tmp_path):
    km = _manager(tmp_path, measure_only=True)
    batcher.kernels = km
    table = km.autotune(batcher, servable)
    assert table["measure_only"]
    for row in table["buckets"].values():
        assert row["decision"] == BASELINE and not row[XLA_INT8]["enabled"]
        assert row[XLA_INT8]["step_us"] > 0 and "max_abs_delta" in row[XLA_INT8]
    assert km.decision(servable, 32) is None
    assert os.path.exists(km.config.table_file)
    km2 = _manager(tmp_path, autotune=False)
    km2.prepare(batcher, servable)
    assert km2.table_reuses == 0 and km2.decision(servable, 32) is None


def test_table_persistence_and_reuse(servable, batcher, tmp_path):
    km = _manager(tmp_path)
    batcher.kernels = km
    km.autotune(batcher, servable)
    data = json.load(open(km.config.table_file))
    assert "DCN:1" in data["entries"] and data["device"] == "cpu"
    km2 = _manager(tmp_path)
    km2.prepare(batcher, servable)
    assert km2.autotunes == 0 and km2.table_reuses == 1
    assert km2.decision(servable, 32) == (True, False)
    # A different bucket set does not adopt it.
    km3 = _manager(tmp_path, autotune=False)
    km3.prepare(batcher, servable, buckets=(16,))
    assert km3.table_reuses == 0


def test_stale_table_on_version_swap_and_invalidate(servable, batcher, tmp_path):
    km = _manager(tmp_path)
    batcher.kernels = km
    km.autotune(batcher, servable)
    assert km.decision(servable, 32) is not None
    v2 = _servable(seed=1, version=2)
    km2 = _manager(tmp_path, autotune=False)
    km2.prepare(batcher, v2)
    assert km2.table_reuses == 0 and km2.decision(v2, 32) is None
    km.invalidate_model("DCN")
    assert km.decision(servable, 32) is None
    assert km.snapshot()["decisions"] == {} and km.snapshot()["tables"] == {}


def test_gate_fingerprint_mismatch_retunes(servable, batcher, tmp_path):
    km = _manager(tmp_path)
    batcher.kernels = km
    km.autotune(batcher, servable)
    km2 = _manager(tmp_path, max_abs_delta=0.004, autotune=False)
    km2.prepare(batcher, servable)
    assert km2.table_reuses == 0 and km2.decision(servable, 32) is None


def test_persisted_table_refused_on_params_digest_mismatch(servable, batcher, tmp_path):
    km = _manager(tmp_path)
    batcher.kernels = km
    km.autotune(batcher, servable)
    retrained = _servable(seed=10)
    km2 = _manager(tmp_path, autotune=False)
    km2.prepare(batcher, retrained)
    assert km2.table_reuses == 0 and km2.decision(retrained, 32) is None
    km3 = _manager(tmp_path, autotune=False)
    km3.prepare(batcher, servable)
    assert km3.table_reuses == 1 and km3.decision(servable, 32) == (True, False)


def test_save_table_merges_on_disk_entries(servable, batcher, tmp_path):
    km = _manager(tmp_path)
    batcher.kernels = km
    km.autotune(batcher, servable)
    v2 = _servable(seed=14, version=2)
    batcher.warmup(v2)
    km2 = _manager(tmp_path)
    km2.autotune(batcher, v2)
    data = json.load(open(km2.config.table_file))
    assert set(data["entries"]) == {"DCN:1", "DCN:2"} and km2.table_saves == 1


def test_autotune_force_skips_adoption(servable, batcher, tmp_path):
    km = _manager(tmp_path)
    batcher.kernels = km
    km.autotune(batcher, servable)
    km2 = _manager(tmp_path)
    km2.autotune(batcher, servable, force=True)
    assert km2.table_reuses == 0 and km2.autotunes == 1


def test_decisions_are_identity_guarded(servable, batcher):
    km = _manager()
    batcher.kernels = km
    km.autotune(batcher, servable)
    assert km.decision(servable, 32) == (True, False)
    clone = _servable(seed=9)
    assert km.decision(clone, 32) is None
    assert km.decision(servable, 32) == (True, False)


def test_snapshot_shape(servable, batcher):
    km = _manager()
    batcher.kernels = km
    km.autotune(batcher, servable)
    snap = km.snapshot()
    assert snap["enabled"] and snap["decisions"]["DCN:1"]["32"] == {
        "quantized": True, "pallas": False}
    assert snap["counters"]["autotunes"] == 1 and snap["gates"]["max_abs_delta"] == 0.005


def test_disabled_plane_is_bit_identical(servable):
    plain = DynamicBatcher(buckets=(16, 32), max_wait_us=0, device="cpu").start()
    gated = DynamicBatcher(buckets=(16, 32), max_wait_us=0, device="cpu").start()
    try:
        arrays = make_arrays(24, seed=11)
        a = plain.submit(servable, arrays).result(30)["prediction_node"]
        assert gated.kernels is None
        b = gated.submit(servable, arrays).result(30)["prediction_node"]
        np.testing.assert_array_equal(a, b)
    finally:
        plain.stop()
        gated.stop()


def test_fused_int8_override_runs_the_plain_step_on_cpu(servable, batcher):
    """_kernel_override=(True, True) is the pallas_int8 entry: on CPU
    tensors the wrapper runs its plain version (no launch counted), and it
    scores like the JAX Pallas kernel on the JAX-quantized tree."""
    from distributed_tf_serving_tpu.ops.cross_kernel import build_fused_serve as jax_fused

    km = _manager()
    batcher.kernels = km
    arrays = make_arrays(16, seed=12)
    ck.reset_launches()
    before = batcher.stats.fused_batches
    got = batcher._execute(servable, arrays, None, _kernel_override=VARIANT_FLAGS[PALLAS_INT8])
    assert batcher.stats.fused_batches == before + 1
    assert sum(ck.launches.values()) == 0
    assert km.pallas_apply_for(servable, True).serve_weights.quantized
    assert km.pallas_apply_for(servable, True) is km.pallas_apply_for(servable, True)
    _, jp = _jax_pair()
    want = jax_fused(jq.quantize_params(jp), JaxConfig(**KW), interpret=True)(None, {
        "feat_ids": jax_fold(arrays["feat_ids"], KW["vocab_size"]),
        "feat_wts": arrays["feat_wts"]})
    np.testing.assert_allclose(got["prediction_node"], np.asarray(want["prediction_node"]),
                               rtol=2e-5, atol=2e-5)


# -------------------------------------------------------- the whole plane


def test_jax_client_scores_through_port_server_with_kernels_plane(tmp_path):
    """build_stack with [kernels] enabled on the CPU: the autotune runs at
    load and picks int8 (min_speedup at the floor); Predicts from the JAX
    client match JAX model.apply on the JAX-quantized tree."""
    cfg = ServerConfig(num_fields=F, buckets=(16, 64), max_wait_us=0)
    kcfg = KernelsConfig(enabled=True, min_speedup=0.01, measure_iters=2,
                         table_file=str(tmp_path / "table.json"))
    impl, batcher, sv = build_stack(cfg, ModelConfig(**KW), "cpu", kernels_config=kcfg)
    server, port = create_server(impl, "127.0.0.1:0")
    server.start()
    try:
        km = batcher.kernels
        table = km.snapshot()["tables"]["DCN:1"]
        assert table["pallas_ineligible_reason"] == CPU_REASON
        decisions = {int(b): row["decision"] for b, row in table["buckets"].items()}
        assert decisions == {16: XLA_INT8, 64: XLA_INT8}
        payloads = [make_arrays(n, seed=20 + n) for n in (7, 33, 50)]

        async def go():
            async with ShardedPredictClient([f"127.0.0.1:{port}"], "DCN") as client:
                return [await client.predict(p) for p in payloads]

        outs = asyncio.run(go())
        assert km.quantized_batches >= 3
        # Rebuild the same seed-0 demo weights on the JAX side.
        jm = jax_build("dcn_v2", JaxConfig(**KW))
        jqp = jq.quantize_params(_torch_tree_to_numpy(sv.params))
        for p, got in zip(payloads, outs):
            want = np.asarray(jm.apply(jqp, {
                "feat_ids": jax_fold(p["feat_ids"], KW["vocab_size"]),
                "feat_wts": p["feat_wts"]})["prediction_node"])
            assert got.shape == (len(want),)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    finally:
        server.stop(0)
        batcher.stop()


def _torch_tree_to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch_tree_to_numpy(v) for v in tree]
    return tree.numpy()


def test_server_serves_baseline_when_the_tune_fails(servable, monkeypatch, caplog):
    """On the CPU only: a failed autotune is logged and the baseline serves.
    On the card build_stack raises instead (tests/test_torch_cuda.py)."""

    def boom(*a, **k):
        raise RuntimeError("tune exploded")

    monkeypatch.setattr(KernelManager, "prepare", boom)
    cfg = ServerConfig(num_fields=F, buckets=(16,), max_wait_us=0)
    with caplog.at_level("ERROR", logger="dts_torch.server"):
        impl, batcher, sv = build_stack(cfg, ModelConfig(**KW), "cpu",
                                        kernels_config=KernelsConfig(enabled=True, table_file=""))
    try:
        assert batcher.device.type == "cpu"
        assert "kernel autotune failed" in caplog.text
        arrays = make_arrays(9, seed=3)
        got = batcher.submit(sv, arrays).result(30)["prediction_node"]
        np.testing.assert_allclose(got, golden(sv, arrays), rtol=1e-6, atol=1e-6)
        assert batcher.kernels.quantized_batches == 0
    finally:
        batcher.stop()


def test_quantized_params_minted_once_per_servable(servable):
    km = _manager()
    a = km.params_for(servable, True)
    assert km.params_for(servable, True) is a
    assert km.params_for(servable, False) is servable.params
    for x, y in zip(a["cross"], quantize_params(servable.params)["cross"]):
        assert torch.equal(x["qw"], y["qw"]) and torch.equal(x["qscale"], y["qscale"])
    registry = ServableRegistry()
    registry.load(servable)
    assert registry.resolve("DCN") is servable
