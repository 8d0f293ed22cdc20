"""The port's training over a mesh (train/trainer.py with mesh= and
tensor_parallel=, parallel/sharding.py's trainable placement) against the
JAX package's on the CPU: the JAX trainer on the 8 virtual CPU devices,
the port's on eight logical CPU shards, from the same params (carried
across by convert.params_from_jax) on the same seeded stream.

Tolerances, each stated where it is used:

- one step's loss 1e-6 and gradients 1e-5 against jax.value_and_grad on
  the JAX trainer's placed state (tests/test_torch_train.py's bounds);
- a 5-step loss trajectory against the JAX trainer's step on its placed
  state: 1e-5 (f32), 1e-3 (bf16), the single-device test's bounds;
- the port's mesh run against its own single-device run: rel 2e-4
  (tests/test_train.py:93);
- the replicas of every leaf: bit-equal after every step.

Then the layouts: the TP spec after an update (tests/test_parallel.py:
243-244), the snapshot's placements (tests/test_train.py:71), and
load_servable onto a mesh (tests/test_train.py:122)."""

import jax
import numpy as np
import pytest
import torch

from distributed_tf_serving_tpu import native as jax_native
from distributed_tf_serving_tpu.models import ModelConfig as JaxConfig
from distributed_tf_serving_tpu.models import build_model as jax_build
from distributed_tf_serving_tpu.parallel import make_mesh as jax_make_mesh
from distributed_tf_serving_tpu.train import trainer as jax_trainer
from distributed_tf_serving_tpu_torch.convert import params_from_jax
from distributed_tf_serving_tpu_torch.models import ModelConfig, Servable, build_model
from distributed_tf_serving_tpu_torch.models import ctr_signatures
from distributed_tf_serving_tpu_torch.parallel import MODEL_AXIS, ShardedExecutor, make_mesh
from distributed_tf_serving_tpu_torch.parallel.mesh import P
from distributed_tf_serving_tpu_torch.parallel.sharding import (
    ShardedLeaf,
    gather_params,
    placed_leaves,
)
from distributed_tf_serving_tpu_torch.serving.batcher import fold_ids_host
from distributed_tf_serving_tpu_torch.train import Trainer, make_train_step
from distributed_tf_serving_tpu_torch.train import trainer as trainer_mod
from distributed_tf_serving_tpu_torch.train.checkpoint import (
    flatten_params,
    load_servable,
    save_servable,
)

F = 8
VOCAB = 1 << 12
KW = dict(num_fields=F, vocab_size=VOCAB, embed_dim=8, mlp_dims=(16,), num_cross_layers=2,
          compute_dtype="float32")
CPU8 = [torch.device("cpu")] * 8
LAYOUTS = [(1, False), (1, True), (2, False), (2, True), (4, False), (4, True)]


def _pair(model_parallel, tensor_parallel, seed=0, **over):
    """(JAX trainer on the 8-device mesh, port state on eight logical CPU
    shards from the same params, port mesh, port model)."""
    kw = {**KW, **over}
    jtr = jax_trainer.Trainer(jax_build("dcn_v2", JaxConfig(**kw)),
                              mesh=jax_make_mesh(8, model_parallel=model_parallel), seed=seed,
                              tensor_parallel=tensor_parallel, learning_rate=1e-2)
    model = build_model("dcn_v2", ModelConfig(**kw))
    mesh = make_mesh(8, model_parallel, devices=CPU8)
    params = params_from_jax(jax.tree.map(np.asarray, jtr.state.params))
    state = trainer_mod.init_state(params, 1e-2, mesh, tensor_parallel, model_kind="dcn_v2")
    return jtr, state, mesh, model


def _replicas_equal(state) -> None:
    for leaf in placed_leaves(state.params):
        for group in leaf.replicas():
            for t in group[1:]:
                assert torch.equal(t, group[0])


@pytest.mark.parametrize("model_parallel,tensor_parallel", LAYOUTS)
def test_one_mesh_step_is_jax_value_and_grad_on_the_placed_state(model_parallel,
                                                                   tensor_parallel):
    jtr, state, mesh, model = _pair(model_parallel, tensor_parallel, seed=1)
    raw = jtr.stream.batch(128, 3)
    jb = jtr._prepare(raw)

    def loss_fn(params):
        return jax_trainer.bce_with_logits(jtr.model.apply(params, jb)["logits"], jb["labels"])

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(jtr.state.params)
    state, metrics = make_train_step(model, mesh)(
        state, trainer_mod.prepare_batch(raw, VOCAB, "cpu", mesh))
    assert abs(float(metrics["loss"]) - float(jloss)) <= 1e-6  # tolerance: 1e-6
    got = {k: leaf.gather(grad=True).numpy() for k, leaf in flatten_params(state.params).items()}
    want = {k: np.asarray(v) for k, v in flatten_params(jgrads).items()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)  # 1e-5
    _replicas_equal(state)


@pytest.mark.parametrize("compute_dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-3)])
@pytest.mark.parametrize("model_parallel,tensor_parallel", LAYOUTS)
def test_a_five_step_mesh_trajectory_is_the_jax_mesh_step(model_parallel, tensor_parallel,
                                                          compute_dtype, tol):
    """Five steps on both meshes from the same params: the losses within
    the single-device test's bounds, the replicas bit-equal after every
    step, and with TP the dense weight still column-split after the
    updates (tests/test_parallel.py:243-244)."""
    jtr, state, mesh, model = _pair(model_parallel, tensor_parallel, seed=4,
                                    compute_dtype=compute_dtype)
    step = make_train_step(model, mesh)
    for i in range(5):
        raw = jtr.stream.batch(128, i)
        jtr.state, jmetrics = jtr.step_fn(jtr.state, jtr._prepare(raw))
        state, metrics = step(state, trainer_mod.prepare_batch(raw, VOCAB, "cpu", mesh))
        assert abs(float(metrics["loss"]) - float(jmetrics["loss"])) <= tol, i  # stated above
        assert abs(float(metrics["accuracy"]) - float(jmetrics["accuracy"])) <= 2 / 128
        _replicas_equal(state)
    assert state.step == int(jtr.state.step) == 5
    assert state.params["embedding"].spec == P(MODEL_AXIS, None)
    want = P(None, MODEL_AXIS) if tensor_parallel and model_parallel > 1 else P()
    assert state.params["mlp"][0]["w"].spec == want
    assert jtr.state.params["mlp"][0]["w"].sharding.spec == jax.sharding.PartitionSpec(*want)


@pytest.mark.parametrize("model_parallel,tensor_parallel", LAYOUTS)
def test_mesh_training_tracks_the_single_device_run(model_parallel, tensor_parallel):
    """Same seed, same data: the mesh run's losses against the port's own
    single-device run at rel 2e-4 (tests/test_train.py:93), and its
    snapshot gathered into a plain tree scores like the single-device
    params it tracks."""
    model = build_model("dcn_v2", ModelConfig(**KW))
    plain = Trainer(model, seed=2, device="cpu")
    mesh = Trainer(model, mesh=make_mesh(8, model_parallel, devices=CPU8), seed=2,
                   tensor_parallel=tensor_parallel, device="cpu")
    for i in range(5):
        _, m_plain = plain.step_fn(plain.state, plain._prepare(plain.stream.batch(128, i)))
        _, m_mesh = mesh.step_fn(mesh.state, mesh._prepare(mesh.stream.batch(128, i)))
        assert float(m_mesh["loss"]) == pytest.approx(float(m_plain["loss"]), rel=2e-4), i
    fit = mesh.fit(steps=2, batch_size=64)
    plain.fit(steps=2, batch_size=64)
    assert fit["steps_per_s"] > 0 and fit["examples_per_s"] > 0
    assert abs(mesh.eval_auc(batches=2, batch_size=256)
               - plain.eval_auc(batches=2, batch_size=256)) < 1e-3
    _replicas_equal(mesh.state)


def test_snapshot_params_preserves_mesh_sharding():
    """tests/test_train.py:71 for the port: the snapshot keeps every leaf's
    placement and spec, holds copies (further fit moves the live params,
    not the snapshot), and gathers into a plain tree that save_servable
    writes and a single device serves."""
    model = build_model("dcn_v2", ModelConfig(**KW))
    trainer = Trainer(model, mesh=make_mesh(8, 2, devices=CPU8), seed=3, tensor_parallel=True,
                      device="cpu")
    trainer.fit(steps=1, batch_size=64)
    snap = trainer.snapshot_params()
    live = trainer.state.params
    for a, b in zip(placed_leaves(live), placed_leaves(snap)):
        assert isinstance(b, ShardedLeaf) and a.sharding == b.sharding
        assert all(x is not y for x, y in zip(a.distinct(), b.distinct()))
        assert torch.equal(a.gather(), b.gather())
    before = {k: v.clone() for k, v in flatten_params(gather_params(snap)).items()}
    trainer.fit(steps=1, batch_size=64)
    after = flatten_params(gather_params(snap))
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert not torch.equal(trainer.state.params["embedding"].gather(), after["embedding"])
    batch = {"feat_ids": torch.zeros((4, F), dtype=torch.int32), "feat_wts": torch.ones((4, F))}
    with torch.no_grad():
        out = model.apply(gather_params(snap), batch)["prediction_node"]
    assert out.shape == (4,) and torch.isfinite(out).all()


def test_checkpoint_restores_onto_mesh(tmp_path):
    """tests/test_train.py:122 for the port, and host=True exclusive with a
    mesh: restored placed, the embedding split over the model axis with
    the saved values; with tensor_parallel the dense weights split too;
    the executor serves the placed params as they are, with the bits of
    the unplaced ones and of one device."""
    model = build_model("dcn_v2", ModelConfig(**KW))
    sv = Servable(name="DCN", version=1, model=model, params=model.init(4, "cpu"),
                  signatures=ctr_signatures(F))
    save_servable(tmp_path / "ckpt", sv, kind="dcn_v2")
    mesh = make_mesh(8, model_parallel=4, devices=CPU8)
    loaded = load_servable(tmp_path / "ckpt", mesh=mesh)
    emb = loaded.params["embedding"]
    assert emb.spec == P(MODEL_AXIS, None)
    assert torch.equal(emb.gather(), sv.params["embedding"])
    assert loaded.params["mlp"][0]["w"].spec == P()
    tp = load_servable(tmp_path / "ckpt", mesh=mesh, tensor_parallel=True)
    assert tp.params["mlp"][0]["w"].spec == P(None, MODEL_AXIS)
    with pytest.raises(ValueError, match="exclusive"):
        load_servable(tmp_path / "ckpt", mesh=mesh, host=True)
    host = load_servable(tmp_path / "ckpt", host=True)
    assert host.params["embedding"].device.type == "cpu"
    assert torch.equal(host.params["embedding"], sv.params["embedding"])

    rng = np.random.RandomState(3)
    arrays = {"feat_ids": fold_ids_host(rng.randint(0, 1 << 40, (100, F)).astype(np.int64),
                                        VOCAB),
              "feat_wts": rng.rand(100, F).astype(np.float32)}
    ex = ShardedExecutor(mesh)
    got = ex(loaded, arrays)["prediction_node"].numpy()
    assert ex._placed[loaded][1]["embedding"] is emb  # served as placed
    assert got.tobytes() == ex(sv, arrays)["prediction_node"].numpy().tobytes()
    with torch.inference_mode():
        one = model.apply(sv.params, {k: torch.from_numpy(v) for k, v in arrays.items()})
    assert got.tobytes() == one["prediction_node"].numpy().tobytes()


def test_the_cli_trains_over_a_mesh_and_writes_a_checkpoint_the_port_serves(tmp_path, capsys):
    out = tmp_path / "ckpt"
    trainer_mod.main(["--out", str(out), "--steps", "3", "--batch-size", "32",
                      "--num-fields", "6", "--vocab-size", "512", "--embed-dim", "4",
                      "--mesh-devices", "2", "--device", "cpu"])
    assert "steps on mesh2x1:cpu,cpu: loss=" in capsys.readouterr().out
    sv = load_servable(out, device="cpu")
    batch = {"feat_ids": torch.zeros((3, 6), dtype=torch.int32), "feat_wts": torch.ones((3, 6))}
    with torch.no_grad():
        assert sv(batch)["prediction_node"].shape == (3,)


def test_the_mesh_batch_must_split_over_the_data_axis():
    model = build_model("dcn_v2", ModelConfig(**KW))
    trainer = Trainer(model, mesh=make_mesh(8, 2, devices=CPU8), seed=0, device="cpu")
    with pytest.raises(ValueError, match="do not split evenly"):
        trainer.fit(steps=1, batch_size=30)


def test_jax_fold_and_port_fold_agree_on_the_mesh_batch():
    """The two trainers' _prepare feed the same folded ids: the stream's
    int64 ids through each package's host fold."""
    model = build_model("dcn_v2", ModelConfig(**KW))
    trainer = Trainer(model, mesh=make_mesh(8, 4, devices=CPU8), seed=0, device="cpu")
    raw = trainer.stream.batch(64, 0)
    shards = trainer._prepare(raw)
    ids = torch.cat([s["feat_ids"] for s in shards]).numpy()
    np.testing.assert_array_equal(ids, jax_native.fold_ids(raw["feat_ids"], VOCAB))
