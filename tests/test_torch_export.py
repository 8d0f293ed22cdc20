"""The port's SavedModel export (interop/export.py) against the JAX
package's, case for case with tests/test_export.py: the export validates
against the port's forward through TensorFlow itself, the artifact carries
the reference wire contract (read with the port's own protos in this
process), TF-Serving's warmup assets, the dlrm dense_features contract, and
an independent TF process scores it like the port's forward. Then: every
other zoo family exports, the port's export scores like the JAX export of
the same params (both loaded through TF), and the port's own `--savedmodel`
import (the GraphDef executor) serves its export.

Tolerances: the export's own validation and the cross-export comparison
1e-5 absolute (the JAX export's bound); the TF-golden round trip rtol 2e-5,
atol 1e-6 (tests/test_export.py's); the graph import 1e-5.

Every export runs in a subprocess: it imports TensorFlow, and this process
holds the vendored protos, which must never share a descriptor pool with
TF's. Skipped where TensorFlow is not installed (the card's machine)."""

import importlib.util
import json
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from distributed_tf_serving_tpu.models import ModelConfig as JaxConfig
from distributed_tf_serving_tpu.models import Servable as JaxServable
from distributed_tf_serving_tpu.models import build_model as jax_build
from distributed_tf_serving_tpu.models import ctr_signatures as jax_signatures
from distributed_tf_serving_tpu.train.checkpoint import save_servable as jax_save
from distributed_tf_serving_tpu_torch import native
from distributed_tf_serving_tpu_torch.convert import params_from_jax
from distributed_tf_serving_tpu_torch.models import ModelConfig, Servable, build_model
from distributed_tf_serving_tpu_torch.models.registry import model_signatures
from distributed_tf_serving_tpu_torch.train.checkpoint import save_servable

if importlib.util.find_spec("tensorflow") is None:
    pytest.skip("tensorflow is not installed: the export needs it", allow_module_level=True)

F = 6
KW = dict(num_fields=F, vocab_size=1 << 12, embed_dim=8, mlp_dims=(16,), num_cross_layers=2,
          num_user_fields=3, num_dense_features=4, bottom_mlp_dims=(16, 8))
EXPORT = "distributed_tf_serving_tpu_torch.interop.export"


def _export(ckpt, out, module=EXPORT) -> dict:
    r = subprocess.run([sys.executable, "-m", module, "--checkpoint", str(ckpt),
                        "--out", str(out)], capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _servable(kind, seed, name="DCN", version=1, **over) -> Servable:
    model = build_model(kind, ModelConfig(name=name, **{**KW, **over}))
    return Servable(name=name, version=version, model=model, params=model.init(seed, "cpu"),
                    signatures=model_signatures(model))


def _inputs(n, seed, dense=False):
    rng = np.random.RandomState(seed)
    out = {"feat_ids": rng.randint(0, 1 << 40, size=(n, F)).astype(np.int64),
           "feat_wts": rng.rand(n, F).astype(np.float32)}
    if dense:
        out["dense_features"] = rng.rand(n, KW["num_dense_features"]).astype(np.float32)
    return out


def _port_scores(sv, inputs) -> np.ndarray:
    batch = {k: torch.from_numpy(v) for k, v in inputs.items()}
    batch["feat_ids"] = torch.from_numpy(native.fold_ids(inputs["feat_ids"],
                                                         sv.model.config.vocab_size))
    with torch.no_grad():
        return sv.model.apply(sv.params, batch)["prediction_node"].float().numpy()


def _tf_scores(paths, inputs) -> list[np.ndarray]:
    """Each SavedModel scored on `inputs` by an independent TF process."""
    src = """
import json, sys
import numpy as np
import tensorflow as tf
inputs = dict(np.load(sys.argv[1]))
out = []
for path in sys.argv[2:]:
    f = tf.saved_model.load(path).signatures["serving_default"]
    feeds = {k: tf.constant(v) for k, v in inputs.items()}
    out.append([float(x) for x in f(**feeds)["prediction_node"].numpy()])
print(json.dumps(out))
"""
    npz = str(paths[0]) + ".inputs.npz"
    np.savez(npz, **inputs)
    r = subprocess.run([sys.executable, "-c", src, npz, *map(str, paths)],
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-1500:]
    return [np.asarray(v, np.float32) for v in json.loads(r.stdout.strip().splitlines()[-1])]


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """dcn_v2 through the export's CLI, as tests/test_export.py does."""
    root = tmp_path_factory.mktemp("export")
    ckpt, out = root / "ckpt", root / "sm"
    sv = _servable("dcn_v2", seed=5, version=3)
    save_servable(ckpt, sv, kind="dcn_v2")
    return sv, out, _export(ckpt, out)


FAMILIES = [("dcn", "bfloat16"), ("wide_deep", "float32"), ("deepfm", "bfloat16"),
            ("two_tower", "float32"), ("generic", "bfloat16")]


@pytest.fixture(scope="module")
def batch_exports(tmp_path_factory):
    """{tag: (servable, artifact dir, summary)}: dlrm, every other zoo
    family and the port's side of the JAX comparison, exported by
    export_servable in ONE subprocess (one TensorFlow start for all)."""
    root = tmp_path_factory.mktemp("exports")
    jcfg = JaxConfig(name="DCN", **KW)
    jm = jax_build("dcn_v2", jcfg)
    jsv = JaxServable(name="DCN", version=1, model=jm, params=jm.init(jax.random.PRNGKey(8)),
                      signatures=jax_signatures(F))
    jax_save(root / "jax_ckpt", jsv, kind="dcn_v2")
    model = build_model("dcn_v2", ModelConfig(name="DCN", **KW))
    servables = {
        "dlrm": _servable("dlrm", seed=2, name="DLRM"),
        "jax_pair": Servable(name="DCN", version=1, model=model,
                             params=params_from_jax(jax.tree.map(np.asarray, jsv.params)),
                             signatures=model_signatures(model)),
        **{kind: _servable(kind, seed=3, compute_dtype=cd) for kind, cd in FAMILIES},
    }
    pairs = []
    for tag, sv in servables.items():
        save_servable(root / f"ckpt_{tag}", sv, kind=sv.model.kind)
        pairs.append((str(root / f"ckpt_{tag}"), str(root / f"sm_{tag}")))
    src = (f"import json, sys\nfrom {EXPORT} import export_servable\n"
           "for ckpt, out in json.loads(sys.argv[1]):\n"
           "    print(json.dumps(export_servable(ckpt, out)), flush=True)\n")
    r = subprocess.run([sys.executable, "-c", src, json.dumps(pairs)], capture_output=True,
                       text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-2000:]
    summaries = [json.loads(line) for line in r.stdout.strip().splitlines()[-len(pairs):]]
    out = {tag: (sv, root / f"sm_{tag}", summary)
           for (tag, sv), summary in zip(servables.items(), summaries)}
    out["jax_ckpt"] = root / "jax_ckpt"
    return out


def test_export_validates_against_the_ports_forward(exported):
    """The export subprocess reloads its own artifact through TF and holds
    it to the port's forward on ids past 2^31; the summary carries the
    verdict."""
    _sv, _out, summary = exported
    assert summary["validated"] is True
    assert summary["max_abs_err"] < 1e-5
    assert summary["vocab_size"] == KW["vocab_size"] and summary["kind"] == "dcn_v2"
    assert summary["version"] == 3


def test_export_carries_reference_wire_contract(exported):
    """Read with the port's proto bindings (no TF in this process):
    serving_default declares feat_ids DT_INT64 [-1, F] + feat_wts DT_FLOAT
    -> prediction_node DT_FLOAT, and the weights are in variables/."""
    from distributed_tf_serving_tpu_torch.interop import read_saved_model
    from distributed_tf_serving_tpu_torch.interop.savedmodel import serve_meta_graph
    from distributed_tf_serving_tpu_torch.proto import tf_framework_pb2 as fw

    _sv, out, _summary = exported
    sig = serve_meta_graph(read_saved_model(out)).signature_def["serving_default"]
    assert set(sig.inputs) == {"feat_ids", "feat_wts"}
    assert sig.inputs["feat_ids"].dtype == fw.DataType.DT_INT64
    assert [d.size for d in sig.inputs["feat_ids"].tensor_shape.dim] == [-1, F]
    assert sig.inputs["feat_wts"].dtype == fw.DataType.DT_FLOAT
    assert sig.outputs["prediction_node"].dtype == fw.DataType.DT_FLOAT
    assert (out / "variables").exists()


def test_export_writes_warmup_assets(exported):
    """assets.extra/tf_serving_warmup_requests: one framed PredictionLog
    targeting the model, the temp inputs cleaned up, and the port's replay
    warms a live batcher with it."""
    from distributed_tf_serving_tpu_torch.proto import serving_apis_pb2 as apis
    from distributed_tf_serving_tpu_torch.serving.batcher import DynamicBatcher
    from distributed_tf_serving_tpu_torch.serving.warmup import (
        read_tfrecords,
        replay_warmup_file,
        warmup_file_for,
    )

    sv, out, _summary = exported
    wf = warmup_file_for(out)
    assert wf is not None
    assert not (out / "assets.extra" / "_warm_inputs.npz").exists()
    records = list(read_tfrecords(wf))
    assert len(records) == 1
    log = apis.PredictionLog()
    log.ParseFromString(records[0])
    assert log.WhichOneof("log_type") == "predict_log"
    req = log.predict_log.request
    assert set(req.inputs) == {"feat_ids", "feat_wts"}
    assert req.model_spec.name == "DCN"
    batcher = DynamicBatcher(buckets=(32,), max_wait_us=0, device="cpu").start()
    try:
        assert replay_warmup_file(wf, sv, batcher) == 1
    finally:
        batcher.stop()


def test_export_dlrm_dense_features(batch_exports):
    """The 3-input dlrm contract exports, validated through TF, declares
    dense_features [-1, dense] and scores like the port's forward in an
    independent TF process."""
    from distributed_tf_serving_tpu_torch.interop import read_saved_model
    from distributed_tf_serving_tpu_torch.interop.savedmodel import serve_meta_graph

    sv, out, summary = batch_exports["dlrm"]
    assert summary["validated"] is True and summary["max_abs_err"] < 1e-5
    sig = serve_meta_graph(read_saved_model(out)).signature_def["serving_default"]
    assert set(sig.inputs) == {"feat_ids", "feat_wts", "dense_features"}
    assert [d.size for d in sig.inputs["dense_features"].tensor_shape.dim] == [-1, 4]
    inputs = _inputs(9, seed=12, dense=True)
    (got,) = _tf_scores([out], inputs)
    np.testing.assert_allclose(got, _port_scores(sv, inputs), rtol=0, atol=1e-5)


def test_export_round_trip_scores_via_tf_golden(exported):
    """An independent TF process scores the artifact on a fresh batch; it
    must match the port's own forward (fold included)."""
    sv, out, _summary = exported
    inputs = _inputs(9, seed=11)
    (got,) = _tf_scores([out], inputs)
    np.testing.assert_allclose(got, _port_scores(sv, inputs), rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("kind,compute_dtype", FAMILIES)
def test_every_other_zoo_family_exports(batch_exports, kind, compute_dtype):
    sv, _out, summary = batch_exports[kind]
    assert summary["validated"] is True and summary["max_abs_err"] < 1e-5
    assert summary["kind"] == kind and sv.model.config.compute_dtype == compute_dtype


def test_the_ports_export_scores_like_the_jax_export(batch_exports, tmp_path):
    """The same params through both exports (the JAX one by jax2tf, the
    port's in plain TF ops), both loaded by TF: within 1e-5."""
    _sv, ours_dir, _summary = batch_exports["jax_pair"]
    theirs = subprocess.run(
        [sys.executable, "-m", "distributed_tf_serving_tpu.interop.export", "--checkpoint",
         str(batch_exports["jax_ckpt"]), "--out", str(tmp_path / "jax_sm")],
        capture_output=True, text=True, timeout=900)
    assert theirs.returncode == 0, theirs.stderr[-2000:]
    inputs = _inputs(33, seed=13)
    ours, jax_scores = _tf_scores([ours_dir, tmp_path / "jax_sm"], inputs)
    np.testing.assert_allclose(ours, jax_scores, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["dcn_v2", "dlrm"])
def test_the_ports_graph_import_serves_its_own_export(exported, batch_exports, kind):
    """The port's `--savedmodel` import with the GraphDef executor
    (interop/graph_exec.py) runs the export's plain TF ops: within 1e-5 of
    the port's forward, raw int64 ids folded by the graph itself."""
    from distributed_tf_serving_tpu_torch.interop.savedmodel import import_savedmodel

    sv, out, _summary = exported if kind == "dcn_v2" else batch_exports[kind]
    graph = import_savedmodel(out, "graph", sv.model.config, device="cpu")
    inputs = _inputs(17, seed=14, dense=kind == "dlrm")
    with torch.no_grad():
        got = graph.model.apply(graph.params, {k: torch.from_numpy(v) for k, v in inputs.items()})
    np.testing.assert_allclose(got["prediction_node"].float().numpy(), _port_scores(sv, inputs),
                               rtol=0, atol=1e-5)


def test_publish_export_lands_the_next_version(tmp_path):
    """publish_export lands the validated export in the next numeric slot,
    called from this process (which holds the port's protos: the export
    runs in a subprocess of its own)."""
    from distributed_tf_serving_tpu_torch.interop.export import publish_export
    from distributed_tf_serving_tpu_torch.serving.version_watcher import scan_versions

    sv = _servable("dcn_v2", seed=9)
    save_servable(tmp_path / "ckpt", sv, kind="dcn_v2")
    (tmp_path / "base" / "4").mkdir(parents=True)
    summary = publish_export(tmp_path / "base", tmp_path / "ckpt")
    assert summary["version"] == 5 and summary["validated"] is True
    assert summary["path"] == str(tmp_path / "base" / "5")
    assert (tmp_path / "base" / "5" / "saved_model.pb").exists()
    assert sorted(scan_versions(tmp_path / "base")) == [4, 5]
