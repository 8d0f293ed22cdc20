"""The port's training leg (train/data.py, train/trainer.py,
train/publisher.py) against the JAX package's on the CPU.

Inputs come from numpy seeds; the JAX params are carried to the port with
`convert.params_from_jax`, so both sides start from the same values.
Tolerances, each stated where it is used:

- the synthetic stream and its teacher: bit for bit (both are numpy);
- bce_with_logits: 1e-6;
- one step's loss 1e-6 and gradients 1e-5 against jax.value_and_grad (f32);
- one AdamW update on identical gradients against optax.adamw: 1e-7
  absolute plus 1e-7 relative (one float32 ulp of the params' scale; the
  two order the decay and the step differently);
- a 5-step loss trajectory against the JAX make_train_step: 1e-5 (f32),
  1e-3 (bf16);
- fine_tune over 2 steps against the JAX fine_tune: loss 1e-5, params 1e-5.

Then the port's own contracts: snapshot_params survives more fit, training
learns (AUC up, read against the Bayes ceiling), the CLI's checkpoint loads
and serves, publish_finetuned lands a version the port's watcher loads, a
mesh trains, the entry points default to the card, and a forward
through the cross-stack kernel (use_pallas_cross) under autograd raises on
the CPU as jax.grad through the Pallas kernel raises, so a fine-tune of
such a servable counts a publish failure in both packages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_tf_serving_tpu import native as jax_native
from distributed_tf_serving_tpu.models import ModelConfig as JaxConfig
from distributed_tf_serving_tpu.models import Servable as JaxServable
from distributed_tf_serving_tpu.models import build_model as jax_build
from distributed_tf_serving_tpu.models import ctr_signatures as jax_signatures
from distributed_tf_serving_tpu.train import data as jax_data
from distributed_tf_serving_tpu.train import publisher as jax_publisher
from distributed_tf_serving_tpu.train import trainer as jax_trainer
from distributed_tf_serving_tpu_torch.convert import params_from_jax
from distributed_tf_serving_tpu_torch.models import (
    ModelConfig,
    Servable,
    ServableRegistry,
    build_model,
    ctr_signatures,
)
from distributed_tf_serving_tpu_torch.ops.cross_kernel import NoBackwardError
from distributed_tf_serving_tpu_torch.serving.version_watcher import (
    VersionWatcher,
    VersionWatcherConfig,
)
from distributed_tf_serving_tpu_torch.train import (
    SyntheticCTRConfig,
    SyntheticCTRStream,
    Trainer,
    bce_with_logits,
    fine_tune,
    make_train_step,
    publish_finetuned,
)
from distributed_tf_serving_tpu_torch.train import trainer as trainer_mod
from distributed_tf_serving_tpu_torch.train.checkpoint import flatten_params, load_servable

F = 6
VOCAB = 512
KW = dict(num_fields=F, vocab_size=VOCAB, embed_dim=4, mlp_dims=(16, 8), num_cross_layers=2,
          bottom_mlp_dims=(8, 4), compute_dtype="float32")
# The families the synthetic stream feeds (feat_ids / feat_wts only).
KINDS = ("dcn", "dcn_v2", "wide_deep", "deepfm", "generic")


def _pair(kind="dcn_v2", seed=0, **over):
    """(JAX model, JAX params, port model, port params) from one JAX init."""
    kw = {**KW, **over}
    jm = jax_build(kind, JaxConfig(**kw))
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = build_model(kind, ModelConfig(**kw))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    return jm, jp, tm, tp


def _stream(seed=0):
    cfg = dict(num_fields=F, id_space=VOCAB, seed=seed)
    return jax_data.SyntheticCTRStream(jax_data.SyntheticCTRConfig(**cfg)), SyntheticCTRStream(
        SyntheticCTRConfig(**cfg))


def _jax_batch(raw):
    return {"feat_ids": jax_native.fold_ids(raw["feat_ids"], VOCAB), "feat_wts": raw["feat_wts"],
            "labels": raw["labels"]}


def _flat_np(tree):
    return {k: np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
            for k, v in flatten_params(tree).items()}


# ------------------------------------------------------------------ data


@pytest.mark.parametrize("seed,index,n,fields", [(0, 0, 64, 43), (0, 1_000_007, 33, 43),
                                                 (3, 5, 128, 6), (7, 2_000_003, 1, 6)])
def test_the_stream_is_the_jax_stream_bit_for_bit(seed, index, n, fields):
    cfg = dict(num_fields=fields, seed=seed)
    theirs = jax_data.SyntheticCTRStream(jax_data.SyntheticCTRConfig(**cfg))
    ours = SyntheticCTRStream(SyntheticCTRConfig(**cfg))
    a, b = theirs.batch(n, index), ours.batch(n, index)
    assert set(a) == set(b) == {"feat_ids", "feat_wts", "labels"}
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        assert a[k].tobytes() == b[k].tobytes(), k
    # The teacher: the Bayes ranking eval_auc(with_bayes=True) reads.
    ta = theirs._teacher_score(a["feat_ids"], a["feat_wts"])
    tb = ours._teacher_score(b["feat_ids"], b["feat_wts"])
    assert ta.dtype == tb.dtype and ta.tobytes() == tb.tobytes()
    assert dataclasses.asdict(ours.config) == dataclasses.asdict(theirs.config)


def test_bce_with_logits_is_the_jax_loss():
    rng = np.random.RandomState(0)
    logits = np.concatenate([rng.randn(500) * 4, [60.0, -60.0, 0.0]]).astype(np.float32)
    labels = (rng.rand(logits.size) < 0.4).astype(np.float32)
    want = float(jax_trainer.bce_with_logits(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(bce_with_logits(torch.from_numpy(logits), torch.from_numpy(labels)))
    assert abs(got - want) <= 1e-6  # tolerance: 1e-6


# --------------------------------------------------------------- one step


@pytest.mark.parametrize("kind", KINDS)
def test_one_step_loss_and_grads_are_jax_value_and_grad(kind):
    jm, jp, tm, tp = _pair(kind, seed=1)
    raw = _stream(1)[1].batch(64, 3)
    jb = _jax_batch(raw)

    def loss_fn(params):
        return jax_trainer.bce_with_logits(jm.apply(params, jb)["logits"], jb["labels"])

    jloss, jgrads = jax.value_and_grad(loss_fn)(jp)
    params = trainer_mod.trainable_copy(tp)
    batch = trainer_mod.prepare_batch(raw, VOCAB, "cpu")
    loss = bce_with_logits(tm.apply(params, batch)["logits"], batch["labels"])
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-6  # tolerance: 1e-6
    want = _flat_np(jgrads)
    got = {k: t.grad.numpy() for k, t in flatten_params(params).items()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)  # 1e-5


def test_one_adamw_update_is_optax_adamw_on_identical_grads():
    """The optimizer alone: the same params and the same gradients (drawn
    from a seed, not computed), one update at the trainer's default rate,
    against optax.adamw's default chain (weight decay 1e-4 on every leaf).
    One update: optax computes its bias corrections in float32 (1 - 0.999
    ** t loses ~1e-5 of its value to cancellation), torch.optim in double,
    so the two drift apart by that much of each later step."""
    _, jp, _, tp = _pair("dcn_v2", seed=2)
    rng = np.random.RandomState(3)
    grads = jax.tree.map(lambda x: rng.randn(*np.shape(x)).astype(np.float32) * 0.1, jp)
    lr = 1e-3
    opt = optax.adamw(lr)
    updates, _ = opt.update(grads, opt.init(jp), jp)
    jparams = optax.apply_updates(jp, updates)
    state = trainer_mod.init_state(tp, lr)
    flat_grads = flatten_params(grads)
    for k, t in flatten_params(state.params).items():
        t.grad = torch.from_numpy(np.array(flat_grads[k]))
    state.opt_state.step()
    got, want, start = _flat_np(state.params), _flat_np(jparams), _flat_np(tp)
    for k in want:
        # tolerance: 1e-7 absolute + 1e-7 relative (one f32 ulp at the
        # params' scale; decay and step are rounded in another order).
        np.testing.assert_allclose(got[k], want[k], rtol=1e-7, atol=1e-7, err_msg=k)
        assert not np.array_equal(got[k], start[k]), k  # every leaf moved
    group = state.opt_state.param_groups[0]
    assert group["weight_decay"] == 1e-4 and group["betas"] == (0.9, 0.999)
    assert group["eps"] == 1e-8 and group["lr"] == lr


@pytest.mark.parametrize("compute_dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-3)])
def test_a_five_step_trajectory_is_the_jax_step(compute_dtype, tol):
    jm, jp, tm, tp = _pair("dcn_v2", seed=4, compute_dtype=compute_dtype)
    jstream, stream = _stream(4)
    opt = optax.adamw(1e-2)
    jstep = jax_trainer.make_train_step(jm, opt)
    jstate = jax_trainer.TrainState(params=jp, opt_state=opt.init(jp), step=jnp.asarray(0))
    state = trainer_mod.init_state(tp, 1e-2)
    step = make_train_step(tm)
    for i in range(5):
        jstate, jmetrics = jstep(jstate, _jax_batch(jstream.batch(128, i)))
        state, metrics = step(state, trainer_mod.prepare_batch(stream.batch(128, i), VOCAB,
                                                               "cpu"))
        assert abs(float(metrics["loss"]) - float(jmetrics["loss"])) <= tol, i  # stated above
        assert abs(float(metrics["accuracy"]) - float(jmetrics["accuracy"])) <= 2 / 128
    assert state.step == int(jstate.step) == 5


def test_fine_tune_is_the_jax_fine_tune():
    jm, jp, tm, tp = _pair("dcn_v2", seed=5)
    jsv = JaxServable(name="DCN", version=3, model=jm, params=jp, signatures=jax_signatures(F))
    sv = Servable(name="DCN", version=3, model=tm, params=tp, signatures=ctr_signatures(F))
    before = {k: v.clone() for k, v in flatten_params(tp).items()}
    jparams, jm_ = jax_publisher.fine_tune(jsv, steps=2, batch_size=64, learning_rate=1e-3,
                                           seed=2)
    params, m = fine_tune(sv, steps=2, batch_size=64, learning_rate=1e-3, seed=2)
    assert m["steps"] == jm_["steps"] == 2
    assert abs(m["loss"] - jm_["loss"]) <= 1e-5  # tolerance: 1e-5
    got, want = _flat_np(params), _flat_np(jparams)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)  # 1e-5
    # The servable's own params never moved (the fine-tune trained a copy).
    for k, t in flatten_params(sv.params).items():
        assert torch.equal(t, before[k]) and not t.requires_grad
    assert all(not t.requires_grad for t in flatten_params(params).values())


# ------------------------------------------------------------ the trainer


CFG = ModelConfig(num_fields=8, vocab_size=4096, embed_dim=8, mlp_dims=(32, 16),
                  num_cross_layers=2, compute_dtype="float32")


def test_snapshot_params_survive_further_fit():
    """torch.optim updates in place: a Servable built from a snapshot must
    score the same after training goes on (the port's form of the JAX
    donation test)."""
    trainer = Trainer(build_model("dcn_v2", CFG), seed=3, device="cpu")
    trainer.fit(steps=1, batch_size=64)
    snap = trainer.snapshot_params()
    sv = Servable(name="DCN", version=1, model=trainer.model, params=snap,
                  signatures=ctr_signatures(8))
    rng = np.random.RandomState(0)
    batch = {"feat_ids": torch.from_numpy(rng.randint(0, 4096, (16, 8)).astype(np.int32)),
             "feat_wts": torch.from_numpy(rng.rand(16, 8).astype(np.float32))}
    with torch.no_grad():
        first = sv.model.apply(sv.params, batch)["prediction_node"].clone()
    live = {k: v.detach().clone() for k, v in flatten_params(trainer.state.params).items()}
    trainer.fit(steps=2, batch_size=64)
    with torch.no_grad():
        again = sv.model.apply(sv.params, batch)["prediction_node"]
    assert torch.equal(first, again)
    moved = [k for k, v in flatten_params(trainer.state.params).items()
             if not torch.equal(v.detach(), live[k])]
    assert moved  # the live params did move
    assert all(not t.requires_grad for t in flatten_params(snap).values())
    assert trainer.state.step == 3


def test_training_learns_and_eval_auc_reads_the_bayes_ceiling():
    trainer = Trainer(build_model("dcn_v2", CFG), seed=1, learning_rate=1e-2, device="cpu")
    before = trainer.eval_auc(batches=2, batch_size=512)
    out = trainer.fit(steps=80, batch_size=512, auc_every=40)
    after, bayes = trainer.eval_auc(batches=2, batch_size=512, with_bayes=True)
    assert after > max(before + 0.05, 0.62), (before, after)
    assert after < bayes <= 1.0 and bayes > 0.85
    assert np.isfinite(out["loss"]) and out["examples_per_s"] > 0
    assert [s for s, _ in out["auc_curve"]] == [40, 80]


def test_the_trainer_accepts_a_mesh_and_defaults_to_the_card():
    """A mesh trains (tests/test_torch_train_mesh.py holds it to the JAX
    trainer); the entry points still run on the card unless asked for the
    CPU, and the CLI's --mesh-devices builds make_mesh over the visible
    cards, so without one it fails with make_mesh's own error."""
    from distributed_tf_serving_tpu_torch.parallel import MODEL_AXIS, make_mesh
    from distributed_tf_serving_tpu_torch.parallel.mesh import P

    model = build_model("dcn_v2", CFG)
    mesh = make_mesh(8, model_parallel=2, devices=[torch.device("cpu")] * 8)
    tr = Trainer(model, mesh=mesh, tensor_parallel=True, device="cpu")
    assert np.isfinite(tr.fit(steps=2, batch_size=32)["loss"])
    assert tr.state.params["mlp"][0]["w"].spec == P(None, MODEL_AXIS)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Trainer(model)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            trainer_mod.main(["--out", "/nonexistent/x", "--steps", "1"])
        with pytest.raises(RuntimeError, match="no CUDA device is visible"):
            trainer_mod.main(["--out", "/nonexistent/x", "--mesh-devices", "2"])


def test_the_cli_writes_a_checkpoint_the_port_serves(tmp_path, capsys):
    out = tmp_path / "ckpt"
    trainer_mod.main(["--out", str(out), "--steps", "3", "--batch-size", "32",
                      "--num-fields", "6", "--vocab-size", "512", "--embed-dim", "4",
                      "--name", "CLI", "--version", "5", "--device", "cpu"])
    assert "bayes_auc=" in capsys.readouterr().out
    sv = load_servable(out, device="cpu")
    assert sv.name == "CLI" and sv.version == 5 and sv.model.kind == "dcn_v2"
    batch = {"feat_ids": torch.zeros((3, 6), dtype=torch.int32),
             "feat_wts": torch.ones((3, 6))}
    with torch.no_grad():
        assert sv(batch)["prediction_node"].shape == (3,)


def test_publish_finetuned_lands_a_version_the_port_watcher_loads(tmp_path):
    _, _, tm, tp = _pair("dcn_v2", seed=6)
    sv = Servable(name="DCN", version=1, model=tm, params=tp, signatures=ctr_signatures(F))
    summary = publish_finetuned(tmp_path, sv, kind="dcn_v2", steps=3, batch_size=16,
                                learning_rate=1e-4)
    assert summary["version"] == 2 and summary["steps"] == 3
    assert summary["path"].endswith("/2") and np.isfinite(summary["loss"])
    registry = ServableRegistry()
    watcher = VersionWatcher(tmp_path, registry,
                             VersionWatcherConfig(poll_interval_s=3600, model_name="DCN"),
                             device="cpu")
    watcher.poll_once()
    assert registry.models()["DCN"] == [2]
    loaded = registry.resolve("DCN")
    rng = np.random.RandomState(9)
    batch = {"feat_ids": torch.from_numpy(rng.randint(0, VOCAB, (8, F)).astype(np.int32)),
             "feat_wts": torch.from_numpy(rng.rand(8, F).astype(np.float32))}
    with torch.no_grad():
        base = tm.apply(tp, batch)["prediction_node"]
        tuned = loaded.model.apply(loaded.params, batch)["prediction_node"]
    # Fine-tuned FROM the serving params: 3 small steps stay close.
    assert float((base - tuned).abs().max()) < 0.2
    assert not torch.equal(base, tuned)


# ------------------------------------------- a kernel with no backward


def test_training_through_the_cross_kernel_raises_as_in_jax():
    jm, jp, tm, tp = _pair("dcn_v2", seed=7, **{"use_pallas_cross": True})
    raw = _stream(7)[1].batch(16, 0)
    jb = _jax_batch(raw)
    # JAX: differentiating the Pallas kernel (interpret mode on the CPU) fails.
    with pytest.raises(Exception):
        jax.grad(lambda p: jax_trainer.bce_with_logits(jm.apply(p, jb)["logits"],
                                                        jb["labels"]))(jp)
    state = trainer_mod.init_state(tp, 1e-3)
    batch = trainer_mod.prepare_batch(raw, VOCAB, "cpu")
    with pytest.raises(NoBackwardError, match="no backward"):
        make_train_step(tm)(state, batch)
    # Nothing trained: every leaf still has no gradient.
    assert all(t.grad is None for t in flatten_params(state.params).values())
    # Serving (no grad) is unchanged: the kernel path's plain version on
    # the CPU, against the plain cross stack of the same model.
    plain = build_model("dcn_v2", ModelConfig(**KW))
    with torch.no_grad():
        got = tm.apply(tp, batch)["prediction_node"]
        want = plain.apply(tp, batch)["prediction_node"]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)
    with torch.inference_mode():
        tm.apply(tp, batch)
    # Grad mode on, but nothing requires grad (a serving thread): no raise.
    tm.apply(tp, batch)


def test_a_fine_tune_through_the_cross_kernel_counts_a_publish_failure(tmp_path):
    from distributed_tf_serving_tpu.models import ServableRegistry as JaxRegistry
    from distributed_tf_serving_tpu.serving import lifecycle as jax_lifecycle
    from distributed_tf_serving_tpu.serving.version_watcher import (
        VersionWatcher as JaxWatcher,
    )
    from distributed_tf_serving_tpu.serving.version_watcher import (
        VersionWatcherConfig as JaxWatcherConfig,
    )
    from distributed_tf_serving_tpu.utils.config import LifecycleConfig as JaxLifecycleConfig
    from distributed_tf_serving_tpu_torch.serving import lifecycle
    from distributed_tf_serving_tpu_torch.utils.config import LifecycleConfig

    jm, jp, tm, tp = _pair("dcn_v2", seed=8, **{"use_pallas_cross": True})
    try:
        counts = []
        for reg, sv, watcher_cls, wcfg, lc_cls, ctrl_mod, base in (
            (JaxRegistry(), JaxServable(name="DCN", version=1, model=jm, params=jp,
                                        signatures=jax_signatures(F)),
             JaxWatcher, JaxWatcherConfig, JaxLifecycleConfig, jax_lifecycle, tmp_path / "jax"),
            (ServableRegistry(), Servable(name="DCN", version=1, model=tm, params=tp,
                                          signatures=ctr_signatures(F)),
             VersionWatcher, VersionWatcherConfig, LifecycleConfig, lifecycle,
             tmp_path / "torch"),
        ):
            base.mkdir()
            reg.load(sv)
            watcher = watcher_cls(base, reg, wcfg(poll_interval_s=3600, model_name="DCN"))
            ctrl = ctrl_mod.LifecycleController(
                lc_cls(enabled=True, fine_tune_steps=2, fine_tune_batch_size=16),
                registry=reg, model_name="DCN", watcher=watcher)
            assert ctrl.publish_once() is None
            counts.append(ctrl.snapshot()["counters"])
            assert not list(base.iterdir())  # nothing published
        assert counts[0]["publish_failures"] == counts[1]["publish_failures"] == 1
        assert counts[0]["publishes"] == counts[1]["publishes"] == 0
    finally:
        jax_lifecycle.deactivate()
        lifecycle.deactivate()
