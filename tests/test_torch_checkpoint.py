"""The port's checkpoint format (train/checkpoint.py): the param tree as a
safetensors file read and written with numpy and torch alone, beside the
JAX package's servable.json manifest.

- save_servable then load_servable is bit-identical, in f32 and bf16;
- files pass between the port and the `safetensors` package bit-identically
  in both directions;
- a checkpoint the JAX package trained and saved, converted by
  tools/jax_checkpoint_to_torch.py, scores through the port within the
  reference's tolerances (f32: scores 1e-5, AUC 1e-6; bf16: AUC 1e-3);
- a file that does not match the model's param tree is refused, naming the
  tensor.
"""

import dataclasses
import importlib.util
import json
import pathlib
import struct

import jax
import numpy as np
import pytest
import safetensors.numpy as st_numpy
import safetensors.torch as st_torch
import torch

from distributed_tf_serving_tpu.models import ModelConfig as JaxConfig
from distributed_tf_serving_tpu.models import build_model as jax_build
from distributed_tf_serving_tpu.serving.batcher import fold_ids_host as jax_fold
from distributed_tf_serving_tpu.train import checkpoint as jax_ckpt
from distributed_tf_serving_tpu.train.data import auc
from distributed_tf_serving_tpu.train.trainer import Trainer
from distributed_tf_serving_tpu_torch.models import ModelConfig, Servable, build_model, ctr_signatures
from distributed_tf_serving_tpu_torch.serving.batcher import DynamicBatcher
from distributed_tf_serving_tpu_torch.train import checkpoint as ckpt

REPO = pathlib.Path(__file__).resolve().parents[1]
F = 4
KW = dict(num_fields=F, vocab_size=1024, embed_dim=8, mlp_dims=(16, 8), num_cross_layers=2)


def _converter():
    spec = importlib.util.spec_from_file_location(
        "jax_checkpoint_to_torch", REPO / "tools" / "jax_checkpoint_to_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _servable(kind="dcn_v2", seed=0, version=1, **kw):
    model = build_model(kind, ModelConfig(**{**KW, **kw}))
    return Servable(name="DCN", version=version, model=model, params=model.init(seed, "cpu"),
                    signatures=ctr_signatures(F))


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _assert_trees_bit_identical(a, b):
    fa, fb = ckpt.flatten_params(a), ckpt.flatten_params(b)
    assert list(fa) == list(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, k
        assert torch.equal(_bits(fa[k]), _bits(fb[k])), k


def _payload(n, seed, fields=F):
    rng = np.random.RandomState(seed)
    return {"feat_ids": rng.randint(0, 1 << 40, size=(n, fields)).astype(np.int64),
            "feat_wts": rng.rand(n, fields).astype(np.float32)}


# ------------------------------------------------------------------ trees


@pytest.mark.parametrize("kind,param_dtype,mlp", [
    ("dcn_v2", "float32", (16, 8)), ("dcn", "float32", (16, 8)),
    ("dcn_v2", "bfloat16", (12,)), ("dcn_v2", "float32", ()),
])
def test_shapes_is_init_tree_on_the_meta_device(kind, param_dtype, mlp):
    model = build_model(kind, ModelConfig(**{**KW, "mlp_dims": mlp, "param_dtype": param_dtype}))
    want = ckpt.flatten_params(model.init(0, "cpu"))
    got = ckpt.flatten_params(model.shapes())
    assert list(got) == list(want)
    for k, t in got.items():
        assert t.device.type == "meta" and t.shape == want[k].shape and t.dtype == want[k].dtype


def test_flatten_names_and_unflatten_round_trip():
    sv = _servable()
    flat = ckpt.flatten_params(sv.params)
    assert list(flat) == ["embedding", "cross.0.w", "cross.0.b", "cross.1.w", "cross.1.b",
                          "mlp.0.w", "mlp.0.b", "mlp.1.w", "mlp.1.b", "out.w", "out.b"]
    _assert_trees_bit_identical(ckpt.unflatten_like(sv.params, flat), sv.params)


# -------------------------------------------------------------- round trip


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["dcn_v2", "dcn"])
def test_save_then_load_is_bit_identical(tmp_path, kind, param_dtype):
    sv = _servable(kind, seed=3, version=7, param_dtype=param_dtype)
    ckpt.save_servable(tmp_path / "7", sv, kind)
    assert sorted(p.name for p in (tmp_path / "7").iterdir()) == [ckpt.PARAMS_FILE, ckpt.MANIFEST]
    got = ckpt.load_servable(tmp_path / "7", device="cpu")
    assert (got.name, got.version, got.model.kind) == ("DCN", 7, kind)
    assert got.model.config == sv.model.config
    assert set(got.signatures) == set(sv.signatures)
    _assert_trees_bit_identical(got.params, sv.params)
    batch = {k: torch.from_numpy(v) for k, v in _payload(6, 1).items()}
    assert torch.equal(got(batch)["prediction_node"], sv(batch)["prediction_node"])


def test_manifest_is_the_jax_packages(tmp_path):
    """The same servable.json keys and config as the JAX package writes."""
    jm = jax_build("dcn_v2", JaxConfig(**KW))
    jsv = jax_ckpt.Servable(name="DCN", version=2, model=jm, params=jm.init(jax.random.PRNGKey(0)),
                            signatures={})
    jax_ckpt.save_servable(tmp_path / "jax", jsv, kind="dcn_v2")
    ckpt.save_servable(tmp_path / "port", _servable(version=2), "dcn_v2")
    a = json.loads((tmp_path / "jax" / ckpt.MANIFEST).read_text())
    b = json.loads((tmp_path / "port" / ckpt.MANIFEST).read_text())
    assert a == b


def test_load_defaults_to_the_card(tmp_path, monkeypatch):
    ckpt.save_servable(tmp_path, _servable(), "dcn_v2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ckpt.load_servable(tmp_path)


# ------------------------------------------------------ format compatibility


_NUMPY_TREES = {
    "float32": lambda rng: {"a.0.w": rng.randn(5, 3).astype(np.float32),
                            "b": rng.randn(7).astype(np.float32)},
    "float16": lambda rng: {"h": rng.randn(3, 3).astype(np.float16)},
    "int8": lambda rng: {"q": rng.randint(-128, 128, size=(9,)).astype(np.int8),
                         "x": np.zeros((0, 4), np.int8)},
    "int32": lambda rng: {"i": rng.randint(-1 << 30, 1 << 30, size=(2, 5)).astype(np.int32),
                          "s": np.array(7, np.int32)},
    "mixed": lambda rng: {"q": rng.randint(-128, 128, size=(3,)).astype(np.int8),
                          "w": rng.randn(4, 2).astype(np.float32),
                          "h": rng.randn(5).astype(np.float16)},
}


@pytest.mark.parametrize("tree", sorted(_NUMPY_TREES))
def test_file_from_safetensors_loads_bit_identically(tmp_path, tree):
    arrays = _NUMPY_TREES[tree](np.random.RandomState(0))
    path = tmp_path / "theirs.safetensors"
    st_numpy.save_file(arrays, str(path), metadata={"format": "np"})
    got = ckpt.load_safetensors(path)
    assert set(got) == set(arrays)
    for k, v in arrays.items():
        assert got[k].numpy().dtype == v.dtype and got[k].shape == v.shape
        np.testing.assert_array_equal(got[k].numpy(), v)
    header, start = ckpt.read_header(path)
    assert header["__metadata__"] == {"format": "np"}


@pytest.mark.parametrize("tree", sorted(_NUMPY_TREES))
def test_file_from_the_port_loads_in_safetensors_bit_identically(tmp_path, tree):
    arrays = _NUMPY_TREES[tree](np.random.RandomState(1))
    path = tmp_path / "ours.safetensors"
    ckpt.save_safetensors(path, {k: torch.from_numpy(v) for k, v in arrays.items()},
                          metadata={"k": "v"})
    (n,) = struct.unpack("<Q", path.read_bytes()[:8])
    assert n % 8 == 0  # the buffer starts aligned
    got = st_numpy.load_file(str(path))
    assert set(got) == set(arrays)
    for k, v in arrays.items():
        assert got[k].dtype == v.dtype
        np.testing.assert_array_equal(got[k], v)


def test_bf16_passes_both_ways_bit_identically(tmp_path):
    """numpy has no bf16: safetensors' torch side checks the BF16 bits."""
    rng = np.random.RandomState(2)
    t = {"w": torch.from_numpy(rng.randn(6, 5).astype(np.float32)).to(torch.bfloat16),
         "b": torch.from_numpy(rng.randn(3).astype(np.float32))}
    ckpt.save_safetensors(tmp_path / "ours", t)
    theirs = st_torch.load_file(str(tmp_path / "ours"))
    st_torch.save_file(t, str(tmp_path / "theirs"))
    ours = ckpt.load_safetensors(tmp_path / "theirs")
    for got in (theirs, ours):
        assert got["w"].dtype == torch.bfloat16
        assert torch.equal(got["w"].view(torch.int16), t["w"].view(torch.int16))
        assert torch.equal(got["b"], t["b"])


def test_writer_takes_numpy_bfloat16_leaves(tmp_path):
    """The JAX package's host restore gives ml_dtypes bfloat16 arrays."""
    import ml_dtypes

    arr = np.random.RandomState(3).randn(4, 4).astype(ml_dtypes.bfloat16)
    ckpt.save_safetensors(tmp_path / "f", {"w": arr})
    got = ckpt.load_safetensors(tmp_path / "f")["w"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), arr.view(np.int16))


# ------------------------------------------------------------- refusals


def _rewrite(path, mutate):
    flat = ckpt.load_safetensors(path / ckpt.PARAMS_FILE)
    mutate(flat)
    ckpt.save_safetensors(path / ckpt.PARAMS_FILE, flat)


@pytest.mark.parametrize("mutate,match", [
    (lambda f: f.__setitem__("cross.1.w", f["cross.1.w"].double().float()[:3]), "'cross.1.w'"),
    (lambda f: f.__setitem__("mlp.0.b", f["mlp.0.b"].to(torch.bfloat16)), "'mlp.0.b'.*BF16"),
    (lambda f: f.pop("out.b"), r"missing \['out.b'\]"),
    (lambda f: f.__setitem__("extra.w", torch.zeros(2)), r"unexpected \['extra.w'\]"),
])
def test_mismatch_with_the_param_tree_names_the_tensor(tmp_path, mutate, match):
    ckpt.save_servable(tmp_path, _servable(), "dcn_v2")
    _rewrite(tmp_path, mutate)
    with pytest.raises(ckpt.CheckpointError, match=match):
        ckpt.load_servable(tmp_path, device="cpu")


def test_corrupt_files_are_refused(tmp_path):
    ckpt.save_servable(tmp_path, _servable(), "dcn_v2")
    path = tmp_path / ckpt.PARAMS_FILE
    raw = path.read_bytes()
    path.write_bytes(raw[:-4])  # a truncated buffer
    with pytest.raises(ckpt.CheckpointError, match="data_offsets"):
        ckpt.load_safetensors(path)
    path.write_bytes(struct.pack("<Q", 10) + b"{not json}")
    with pytest.raises(ckpt.CheckpointError, match="not JSON"):
        ckpt.load_safetensors(path)
    path.write_bytes(struct.pack("<Q", 100) + b"{}")
    with pytest.raises(ckpt.CheckpointError, match="truncated"):
        ckpt.read_header(path)
    header = json.dumps({"t": {"dtype": "F64", "shape": [1], "data_offsets": [0, 8]}}).encode()
    path.write_bytes(struct.pack("<Q", len(header)) + header + bytes(8))
    with pytest.raises(ckpt.CheckpointError, match="'F64' is not supported"):
        ckpt.load_safetensors(path)


def test_manifest_with_an_unknown_config_key_is_refused(tmp_path):
    ckpt.save_servable(tmp_path, _servable(), "dcn_v2")
    m = json.loads((tmp_path / ckpt.MANIFEST).read_text())
    m["config"]["not_a_knob"] = 1
    (tmp_path / ckpt.MANIFEST).write_text(json.dumps(m))
    with pytest.raises(ckpt.CheckpointError, match="not_a_knob"):
        ckpt.load_servable(tmp_path, device="cpu")


# ------------------------------------------- a checkpoint the JAX package trained


def _trained_jax_checkpoint(path, compute_dtype):
    cfg = JaxConfig(num_fields=6, vocab_size=1 << 12, embed_dim=8, mlp_dims=(32, 16),
                    num_cross_layers=2, compute_dtype=compute_dtype)
    trainer = Trainer(jax_build("dcn_v2", cfg), seed=1, learning_rate=1e-2)
    trainer.fit(steps=3, batch_size=128)
    sv = jax_ckpt.Servable(name="DCN", version=4, model=trainer.model,
                           params=trainer.snapshot_params(), signatures={})
    jax_ckpt.save_servable(path, sv, kind="dcn_v2")
    return trainer


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_jax_trained_checkpoint_scores_through_the_port(tmp_path, compute_dtype):
    trainer = _trained_jax_checkpoint(tmp_path / "4", compute_dtype)
    out = _converter().convert(tmp_path / "4")
    assert out == tmp_path / "4" and (out / ckpt.PARAMS_FILE).is_file()

    jsv = jax_ckpt.load_servable(tmp_path / "4")
    sv = ckpt.load_servable(tmp_path / "4", device="cpu")
    assert (sv.name, sv.version) == ("DCN", 4)
    raw = trainer.stream.batch(512, 1_000_000)  # held out of training
    folded = {"feat_ids": jax_fold(raw["feat_ids"], 1 << 12), "feat_wts": raw["feat_wts"]}
    want = np.asarray(jsv.model.apply(jsv.params, folded)["prediction_node"], np.float32)
    batcher = DynamicBatcher(buckets=(256, 512), max_wait_us=0, device="cpu").start()
    try:
        got = batcher.submit(sv, {"feat_ids": raw["feat_ids"], "feat_wts": raw["feat_wts"]},
                             output_keys=("prediction_node",)).result(60)["prediction_node"]
    finally:
        batcher.stop()
    labels = raw["labels"]
    d_auc = abs(auc(labels, got) - auc(labels, want))
    if compute_dtype == "float32":
        assert np.max(np.abs(got - want)) < 1e-5
        assert d_auc < 1e-6
    else:
        assert d_auc < 1e-3


def test_converter_into_a_new_directory_copies_assets_and_writes_the_manifest_last(
        tmp_path, monkeypatch):
    _trained_jax_checkpoint(tmp_path / "src", "float32")
    (tmp_path / "src" / "assets.extra").mkdir()
    (tmp_path / "src" / "assets.extra" / "tf_serving_warmup_requests").write_bytes(b"r")
    conv = _converter()
    order = []
    real_replace = conv.os.replace
    monkeypatch.setattr(conv.os, "replace",
                        lambda a, b: (order.append(pathlib.Path(b).name), real_replace(a, b)))
    conv.main([str(tmp_path / "src"), str(tmp_path / "dst")])
    assert order == [ckpt.PARAMS_FILE, ckpt.MANIFEST]
    assert (tmp_path / "dst" / "assets.extra" / "tf_serving_warmup_requests").read_bytes() == b"r"
    assert not (tmp_path / "dst" / "params").exists()
    assert not list((tmp_path / "dst").glob("*.tmp"))
    a = ckpt.load_servable(tmp_path / "dst", device="cpu")
    conv.convert(tmp_path / "src")
    b = ckpt.load_servable(tmp_path / "src", device="cpu")
    _assert_trees_bit_identical(a.params, b.params)
    assert dataclasses.asdict(a.model.config) == dataclasses.asdict(b.model.config)
