"""The port's SavedModel importer (interop/savedmodel.py) held to the JAX
package's (tests/test_interop.py's cases): the same exports, written with
the vendored protos or by TensorFlow in a subprocess, go through both
importers — same signatures, the same mapped leaves for every family, the
same exception type and text for every refusal, scores of the imported
servable within 1e-5 (f32); the extraction cache's freshness, fingerprint
and owner check; the conversion CLI; a --savedmodel CLI server answering
Predict and GetModelMetadata; the watcher's default-config hint. The
TensorFlow exports are built in one TF process per module."""

import dataclasses
import json
import os
import pathlib
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from distributed_tf_serving_tpu.interop import savedmodel as jsm
from distributed_tf_serving_tpu.models import ModelConfig as JaxConfig
from distributed_tf_serving_tpu.models import build_model as jax_build
from distributed_tf_serving_tpu_torch import codec
from distributed_tf_serving_tpu_torch.interop import (
    SavedModelImportError,
    import_savedmodel,
    map_variables,
    read_saved_model,
    signatures_from_meta_graph,
)
from distributed_tf_serving_tpu_torch.interop import savedmodel as sm
from distributed_tf_serving_tpu_torch.models import ModelConfig, ServableRegistry, build_model
from distributed_tf_serving_tpu_torch.models.registry import PREDICT_METHOD
from distributed_tf_serving_tpu_torch.proto import tf_framework_pb2 as fw
from distributed_tf_serving_tpu_torch.proto import tf_saved_model_pb2 as smpb
from distributed_tf_serving_tpu_torch.serving.batcher import fold_ids_host

REPO = pathlib.Path(__file__).resolve().parents[1]
CFG_KW = dict(num_fields=6, vocab_size=997, embed_dim=4, mlp_dims=(16,), num_cross_layers=2,
              compute_dtype="float32")
CFG = ModelConfig(**CFG_KW)
JCFG = JaxConfig(**CFG_KW)


def _write_fake_savedmodel(tmp_path, signature_inputs=True, num_fields=6,
                           name="export") -> pathlib.Path:
    """A SavedModel directory written with the vendored bindings: byte
    compatible with what TF writes, no TF involved."""
    proto = smpb.SavedModel(saved_model_schema_version=1)
    mg = proto.meta_graphs.add()
    mg.meta_info_def.tags.append("serve")
    sd = mg.signature_def["serving_default"]
    sd.method_name = PREDICT_METHOD
    if signature_inputs:
        for alias, dtype in (("feat_ids", fw.DT_INT64), ("feat_wts", fw.DT_FLOAT)):
            info = sd.inputs[alias]
            info.name = f"{alias}:0"
            info.dtype = dtype
            info.tensor_shape.dim.add(size=-1)
            info.tensor_shape.dim.add(size=num_fields)
        out = sd.outputs["prediction_node"]
        out.name = "prediction_node:0"
        out.dtype = fw.DT_FLOAT
        out.tensor_shape.dim.add(size=-1)
    d = tmp_path / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "saved_model.pb").write_bytes(proto.SerializeToString())
    return d


def _jax_template(kind, cfg, seed=0):
    return jax.tree.map(np.asarray, jax_build(kind, cfg).init(jax.random.PRNGKey(seed)))


def _donor_npz(tmp_path, seed=11, cfg=JCFG) -> tuple[pathlib.Path, dict]:
    """Variables npz in TF object-graph naming, in the JAX package's tree
    order, so the repeated-shape (cross layers) tiebreak is exercised."""
    donor = _jax_template("dcn_v2", cfg, seed)
    flat = jsm._flatten_params(donor)
    npz_path = tmp_path / "vars.npz"
    np.savez(npz_path, **{f"model/layer{i:03d}/.ATTRIBUTES/VARIABLE_VALUE": v
                          for i, (_, v) in enumerate(flat.items())})
    return npz_path, donor


def _batch(n, seed, fields=6, vocab=997):
    rng = np.random.RandomState(seed)
    return {"feat_ids": rng.randint(0, 1 << 40, size=(n, fields)).astype(np.int64),
            "feat_wts": rng.rand(n, fields).astype(np.float32)}


def _scores(servable, arrays):
    """The port servable's scores on host arrays (ids folded as the
    batcher folds them)."""
    vocab = servable.model.config.vocab_size
    batch = {"feat_ids": torch.from_numpy(fold_ids_host(arrays["feat_ids"], vocab)),
             "feat_wts": torch.from_numpy(arrays["feat_wts"])}
    return servable.model.apply(servable.params, batch)["prediction_node"].float().numpy()


def _jax_scores(servable, arrays):
    from distributed_tf_serving_tpu.serving.batcher import prepare_inputs

    return np.asarray(servable(prepare_inputs(servable.model, arrays))["prediction_node"],
                      np.float32)


def _same_leaves(got_tree, want_tree, what=""):
    got, want = sm._flatten_params(got_tree), jsm._flatten_params(want_tree)
    assert list(got) == list(want), what
    for p in want:
        g = got[p].numpy() if isinstance(got[p], torch.Tensor) else np.asarray(got[p])
        assert g.dtype == np.asarray(want[p]).dtype, f"{what} {p}"
        np.testing.assert_array_equal(g, np.asarray(want[p]), err_msg=f"{what} {p}")


def _python_without_tensorflow(tmp_path) -> str:
    """An interpreter for the extraction subprocess that cannot import
    TensorFlow, as on the card's machine (its stderr fixed, so the ranked
    errors of both packages compare as text)."""
    exe = tmp_path / "python-without-tensorflow"
    exe.write_text("#!/bin/sh\necho \"ModuleNotFoundError: No module named 'tensorflow'\" >&2\n"
                   "exit 1\n")
    exe.chmod(0o755)
    return str(exe)


def _same_error(fn_torch, fn_jax):
    with pytest.raises(jsm.SavedModelImportError) as je:
        fn_jax()
    with pytest.raises(SavedModelImportError) as te:
        fn_torch()
    assert str(te.value) == str(je.value)
    return str(te.value)


# ------------------------------------------------------------- metadata


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_import_savedmodel_golden_scores(tmp_path, compute_dtype):
    """TF-free import: signatures from saved_model.pb, the weights in the
    slots the JAX importer picks (same leaves, tensors on the asked device);
    scores equal a direct forward on the donor and the JAX import's within
    1e-5 (f32) / 5e-3 (bf16)."""
    cfg = dataclasses.replace(CFG, compute_dtype=compute_dtype)
    jcfg = dataclasses.replace(JCFG, compute_dtype=compute_dtype)
    export = _write_fake_savedmodel(tmp_path)
    npz_path, donor = _donor_npz(tmp_path, cfg=jcfg)
    sv = import_savedmodel(export, "dcn_v2", cfg, name="DCN", version=7,
                           variables_npz=npz_path, device="cpu")
    jsv = jsm.import_savedmodel(export, "dcn_v2", jcfg, name="DCN", version=7,
                                variables_npz=npz_path)
    assert sv.version == 7 and sv.model.kind == "dcn_v2"
    sig = sv.signature("serving_default")
    assert {s.name for s in sig.inputs} == {"feat_ids", "feat_wts"}
    assert sig.method_name == PREDICT_METHOD
    _same_leaves(sm._jax_order(sv.params), jsv.params)
    assert all(t.device.type == "cpu" for t in sm._flatten_params(sv.params).values())
    arrays = _batch(5, 0)
    got = _scores(sv, arrays)
    tol = 1e-5 if compute_dtype == "float32" else 5e-3
    np.testing.assert_allclose(got, _jax_scores(jsv, arrays), atol=tol, rtol=0)
    model = build_model("dcn_v2", cfg)
    donor_t = sm._to_device(donor, sm._jax_order(model.shapes()), torch.device("cpu"))
    want = model.apply(donor_t, {"feat_ids": torch.from_numpy(fold_ids_host(
        arrays["feat_ids"], 997)), "feat_wts": torch.from_numpy(arrays["feat_wts"])})
    np.testing.assert_array_equal(got, want["prediction_node"].float().numpy())


def test_import_defaults_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    export = _write_fake_savedmodel(tmp_path)
    npz_path, _ = _donor_npz(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        import_savedmodel(export, "dcn_v2", CFG, variables_npz=npz_path)


def test_signatures_parse_shapes_and_dtypes(tmp_path):
    export = _write_fake_savedmodel(tmp_path)
    sigs = signatures_from_meta_graph(sm.serve_meta_graph(read_saved_model(export)))
    jsigs = jsm.signatures_from_meta_graph(jsm.serve_meta_graph(jsm.read_saved_model(export)))
    assert {k: dataclasses.astuple(v) for k, v in sigs.items()} == \
        {k: dataclasses.astuple(v) for k, v in jsigs.items()}
    ids = next(s for s in sigs["serving_default"].inputs if s.name == "feat_ids")
    assert ids.dtype == fw.DT_INT64 and ids.shape == (None, 6)


def test_serve_meta_graph_picks_the_serve_tag(tmp_path):
    proto = smpb.SavedModel(saved_model_schema_version=1)
    for tags in (["train"], ["serve", "gpu"]):
        proto.meta_graphs.add().meta_info_def.tags.extend(tags)
    assert list(sm.serve_meta_graph(proto).meta_info_def.tags) == ["serve", "gpu"]
    proto.meta_graphs[1].meta_info_def.ClearField("tags")
    with pytest.raises(SavedModelImportError, match="no meta graph tagged 'serve'"):
        sm.serve_meta_graph(proto)


def test_map_variables_explicit_mapping_and_errors():
    template = _jax_template("dcn_v2", JCFG)
    flat = jsm._flatten_params(template)
    variables = {f"v/{p}": v for p, v in flat.items()}
    mapping = {p: f"v/{p}" for p in flat}
    _same_leaves(map_variables(variables, template, mapping),
                 jsm.map_variables(variables, template, mapping))
    _same_error(lambda: map_variables(variables, template, {"nope/w": "v/embedding"}),
                lambda: jsm.map_variables(variables, template, {"nope/w": "v/embedding"}))
    msg = _same_error(lambda: map_variables({"only": np.zeros((1, 1))}, template),
                      lambda: jsm.map_variables({"only": np.zeros((1, 1))}, template))
    assert "no variable of shape" in msg


def test_map_variables_takes_a_meta_template_in_jax_order():
    """The port walks its model's shapes() (meta tensors, nothing
    allocated) in the JAX package's tree order: the same leaves bind, and
    the first failure is the same message."""
    model = build_model("dcn_v2", CFG)
    template = sm._jax_order(model.shapes())
    jtemplate = _jax_template("dcn_v2", JCFG)
    assert list(sm._flatten_params(template)) == list(jsm._flatten_params(jtemplate))
    variables = {f"model/layer{i:03d}": v
                 for i, v in enumerate(jsm._flatten_params(_jax_template("dcn_v2", JCFG, 3))
                                       .values())}
    _same_leaves(map_variables(variables, template), jsm.map_variables(variables, jtemplate))
    partial = dict(list(variables.items())[:-3])
    _same_error(lambda: map_variables(partial, template),
                lambda: jsm.map_variables(partial, jtemplate))


def test_map_variables_ambiguous_shape_rejected():
    template = {"a": np.zeros((3, 3)), "b": np.zeros((2,))}
    variables = {"x": np.ones((3, 3)), "y": np.ones((3, 3)), "z": np.ones((2,))}
    msg = _same_error(lambda: map_variables(variables, template),
                      lambda: jsm.map_variables(variables, template))
    assert "ambiguous shape" in msg


def test_missing_dir_and_empty_signatures(tmp_path):
    msg = _same_error(lambda: read_saved_model(tmp_path / "nope"),
                      lambda: jsm.read_saved_model(tmp_path / "nope"))
    assert "not found" in msg
    proto = smpb.SavedModel(saved_model_schema_version=1)
    proto.meta_graphs.add().meta_info_def.tags.append("serve")
    d = tmp_path / "empty"
    d.mkdir()
    (d / "saved_model.pb").write_bytes(proto.SerializeToString())
    msg = _same_error(
        lambda: signatures_from_meta_graph(sm.serve_meta_graph(read_saved_model(d))),
        lambda: jsm.signatures_from_meta_graph(jsm.serve_meta_graph(jsm.read_saved_model(d))))
    assert "no signatures" in msg
    (d / "saved_model.pb").write_bytes(b"")
    msg = _same_error(lambda: read_saved_model(d), lambda: jsm.read_saved_model(d))
    assert "contains no meta graphs" in msg


def test_bookkeeping_vars_filtered_and_natural_order():
    """save_counter never binds to a scalar param, and repeated-shape
    stacks bind numerically (layer_10 after layer_2)."""
    template = {"bias": np.zeros(()), "stack": [np.zeros((3, 3)) for _ in range(12)]}
    variables = {"save_counter/.ATTRIBUTES/VARIABLE_VALUE": np.int64(41),
                 "model/bias/.ATTRIBUTES/VARIABLE_VALUE": np.float64(0.25)}
    for i in range(12):
        variables[f"model/layer_{i}/kernel/.ATTRIBUTES/VARIABLE_VALUE"] = np.full(
            (3, 3), float(i))
    out = map_variables(variables, template)
    _same_leaves(out, jsm.map_variables(variables, template))
    assert float(out["bias"]) == 0.25
    for i in range(12):
        assert out["stack"][i][0, 0] == float(i)


def test_mapping_unknown_variable_rejected():
    template = {"w": np.zeros((2, 2))}
    variables = {"real/w": np.ones((2, 2))}
    msg = _same_error(lambda: map_variables(variables, template, {"w": "typo"}),
                      lambda: jsm.map_variables(variables, template, {"w": "typo"}))
    assert "unknown variables" in msg
    out = map_variables(variables, template, {"w": "real/w/.ATTRIBUTES/VARIABLE_VALUE"})
    np.testing.assert_array_equal(out["w"], np.ones((2, 2)))


def test_unknown_rank_signature(tmp_path):
    proto = smpb.SavedModel(saved_model_schema_version=1)
    mg = proto.meta_graphs.add()
    mg.meta_info_def.tags.append("serve")
    sd = mg.signature_def["serving_default"]
    sd.method_name = PREDICT_METHOD
    sd.inputs["anything"].dtype = fw.DT_FLOAT
    sd.inputs["anything"].tensor_shape.unknown_rank = True
    d = tmp_path / "ur"
    d.mkdir()
    (d / "saved_model.pb").write_bytes(proto.SerializeToString())
    spec = signatures_from_meta_graph(sm.serve_meta_graph(read_saved_model(d)))[
        "serving_default"].inputs[0]
    assert spec.shape is None
    assert spec.to_tensor_info().tensor_shape.unknown_rank


def test_npz_cache_staleness(tmp_path):
    """An in-place re-export (newer saved_model.pb) invalidates the
    extraction cache, in both packages alike."""
    export = _write_fake_savedmodel(tmp_path)
    npz = export / "variables_extracted.npz"
    time.sleep(0.02)
    np.savez(npz, x=np.zeros(1))
    assert sm._npz_cache_fresh(export, npz) and jsm._npz_cache_fresh(export, npz)
    time.sleep(0.02)
    (export / "saved_model.pb").touch()
    assert not sm._npz_cache_fresh(export, npz)
    assert not jsm._npz_cache_fresh(export, npz)


def test_npz_cache_fingerprint_and_own_directory(tmp_path):
    """The cache path lives in the port's own per-user directory (never the
    JAX package's), keyed on the export's path and content fingerprint: a
    version dir replaced wholesale with its mtimes kept misses the old
    cache."""
    export = _write_fake_savedmodel(tmp_path)
    (export / "variables").mkdir()
    (export / "variables" / "variables.index").write_bytes(b"a")
    p1 = sm._default_npz_cache_path(export)
    assert p1.parent.name == f"{sm.CACHE_DIR_PREFIX}{os.getuid()}"
    assert p1.parent != jsm._default_npz_cache_path(export).parent
    assert p1.name == jsm._default_npz_cache_path(export).name  # the same key
    assert sm.graph_cache_path(export).name == p1.stem + "-graph.npz"
    st = (export / "variables" / "variables.index").stat()
    (export / "variables" / "variables.index").write_bytes(b"bb")
    os.utime(export / "variables" / "variables.index", ns=(st.st_atime_ns, st.st_mtime_ns))
    assert sm._default_npz_cache_path(export) != p1
    assert sm._default_npz_cache_path(export) == sm._default_npz_cache_path(export)


def test_npz_cache_refuses_a_foreign_directory(tmp_path, monkeypatch):
    import tempfile

    monkeypatch.setattr(tempfile, "gettempdir", lambda: str(tmp_path))
    root = tmp_path / f"{sm.CACHE_DIR_PREFIX}{os.getuid()}"
    root.mkdir(mode=0o755)
    root.chmod(0o755)
    export = _write_fake_savedmodel(tmp_path)
    with pytest.raises(SavedModelImportError, match="not exclusively owned"):
        sm._default_npz_cache_path(export)
    root.chmod(0o700)
    assert sm._default_npz_cache_path(export).parent == root


def test_cross_group_same_shape_requires_mapping():
    template = {"cross": [{"w": np.zeros((4, 4))}], "mlp": [{"w": np.zeros((4, 4))}]}
    variables = {"a": np.ones((4, 4)), "b": np.full((4, 4), 2.0)}
    msg = _same_error(lambda: map_variables(variables, template),
                      lambda: jsm.map_variables(variables, template))
    assert "different param groups" in msg
    out = map_variables(variables, template, {"cross/0/w": "a", "mlp/0/w": "b"})
    assert out["cross"][0]["w"][0, 0] == 1.0 and out["mlp"][0]["w"][0, 0] == 2.0


def test_alias_mismatch_fails_at_import(tmp_path):
    proto = smpb.SavedModel(saved_model_schema_version=1)
    mg = proto.meta_graphs.add()
    mg.meta_info_def.tags.append("serve")
    sd = mg.signature_def["serving_default"]
    sd.method_name = PREDICT_METHOD
    sd.inputs["x"].dtype = fw.DT_FLOAT
    sd.inputs["x"].tensor_shape.dim.add(size=-1)
    d = tmp_path / "alias"
    d.mkdir()
    (d / "saved_model.pb").write_bytes(proto.SerializeToString())
    npz = tmp_path / "v.npz"
    np.savez(npz, w=np.zeros((1, 1)))
    msg = _same_error(
        lambda: import_savedmodel(d, "dcn_v2", CFG, variables_npz=npz, device="cpu"),
        lambda: jsm.import_savedmodel(d, "dcn_v2", JCFG, variables_npz=npz))
    assert "required aliases" in msg


def test_optimizer_slots_filtered_in_premade_npz():
    template = {"w": np.zeros((2, 2))}
    variables = {
        "w/.ATTRIBUTES/VARIABLE_VALUE": np.ones((2, 2)),
        "w/.OPTIMIZER_SLOT/adam/m/.ATTRIBUTES/VARIABLE_VALUE": np.full((2, 2), 9.0),
        "w/.OPTIMIZER_SLOT/adam/v/.ATTRIBUTES/VARIABLE_VALUE": np.full((2, 2), 9.0),
    }
    np.testing.assert_array_equal(map_variables(variables, template)["w"], np.ones((2, 2)))


# -------------------------------------------- role-based mapping-free import


def test_keras_names_resolve_cross_vs_mlp_shape_collision():
    """A DCN-v2 whose cross kernel and MLP kernels share one shape: pure
    shape matching refuses (same text as JAX), the Keras vocabulary binds
    every weight to its donor value with no mapping."""
    cfg = dataclasses.replace(JCFG, num_fields=4, embed_dim=4, mlp_dims=(16, 16),
                              num_cross_layers=1)
    donor = _jax_template("dcn_v2", cfg, 1)
    template = _jax_template("dcn_v2", cfg, 0)
    flat = jsm._flatten_params(donor)

    def keras_name(p):
        leaf = "kernel" if p.endswith("w") else "bias"
        parts = p.split("/")
        if p == "embedding":
            return "model/embedding/embeddings"
        if parts[0] == "cross":
            return f"model/cross_{parts[1]}/{leaf}"
        if parts[0] == "mlp":
            i = int(parts[1])
            return f"model/dense/{leaf}" if i == 0 else f"model/dense_{i}/{leaf}"
        return f"model/dense_7/{leaf}"

    anonymous = {f"v{i}": v for i, v in enumerate(flat.values())}
    msg = _same_error(lambda: map_variables(anonymous, template),
                      lambda: jsm.map_variables(anonymous, template))
    assert "shared across" in msg or "ambiguous" in msg
    variables = {keras_name(p): v for p, v in flat.items()}
    out = map_variables(variables, template)
    _same_leaves(out, donor)
    _same_leaves(out, jsm.map_variables(variables, template))


def _keras_name(p):
    """Keras-style export names for a zoo param path."""
    leaf = "kernel" if p.endswith("/w") else ("bias" if p.endswith("/b") else None)
    parts = p.split("/")
    if "embedding" in p:
        return "model/embedding/embeddings"
    if parts[0] in ("wide", "linear"):
        return f"model/linear_model/{p.replace('/', '_')}"
    if parts[0] == "wide_bias":
        return "model/linear_model/bias_weight"
    if parts[0] == "bias":
        return "model/top_bias"
    if parts[0] == "temperature":
        return "model/temperature_scale"
    if parts[0] == "cross":
        return f"model/cross_{parts[1]}/{leaf}"
    if parts[0] in ("user_mlp", "item_mlp"):
        tower = "user_tower" if parts[0] == "user_mlp" else "item_tower"
        i = int(parts[1])
        return f"model/{tower}/{'dense' if i == 0 else f'dense_{i}'}/{leaf}"
    if parts[0] in ("mlp", "bottom_mlp", "top_mlp"):
        i = int(parts[1])
        stem = {"mlp": "", "bottom_mlp": "bottom/", "top_mlp": "top/"}[parts[0]]
        return f"model/{stem}{'dense' if i == 0 else f'dense_{i}'}/{leaf}"
    if parts[0] == "out":
        return f"model/dense_9/{leaf}"
    raise AssertionError(f"unexpected param path {p}")


FAMILY_CFG = dict(mlp_dims=(8, 8), num_user_fields=3, num_dense_features=5,
                  bottom_mlp_dims=(8, 4))


@pytest.mark.parametrize("naming", ["keras", "explicit", "tree_order"])
@pytest.mark.parametrize("kind", ["dcn", "dcn_v2", "deepfm", "dlrm", "generic", "two_tower",
                                  "wide_deep"])
def test_import_per_family_binds_as_jax(kind, naming, tmp_path):
    """Every zoo family through both importers, on the same npz: Keras-style
    names mapping-free, an explicit mapping, and anonymous names in tree
    order. The same leaves bind (the donor's, where it binds at all), or
    both refuse with the same text."""
    jcfg = dataclasses.replace(JCFG, **FAMILY_CFG)
    cfg = dataclasses.replace(CFG, **FAMILY_CFG)
    donor = _jax_template(kind, jcfg, 2)
    flat = jsm._flatten_params(donor)
    names = {"keras": _keras_name, "explicit": lambda p: f"vars/{p}",
             "tree_order": None}[naming]
    if names is None:
        variables = {f"model/layer{i:03d}": v for i, v in enumerate(flat.values())}
        mapping = None
    else:
        variables = {names(p): v for p, v in flat.items()}
        mapping = {p: names(p) for p in flat} if naming == "explicit" else None
    export = _write_fake_savedmodel(tmp_path)
    npz = tmp_path / "v.npz"
    np.savez(npz, **variables)
    kw = dict(variables_npz=npz, mapping=mapping, fallback=False)
    try:
        jsv = jsm.import_savedmodel(export, kind, jcfg, **kw)
    except jsm.SavedModelImportError as exc:
        with pytest.raises(SavedModelImportError) as te:
            import_savedmodel(export, kind, cfg, device="cpu", **kw)
        assert str(te.value) == str(exc)
        assert naming != "explicit"
        return
    sv = import_savedmodel(export, kind, cfg, device="cpu", **kw)
    _same_leaves(sm._jax_order(sv.params), jsv.params, f"{kind}/{naming}")
    if naming != "tree_order":
        _same_leaves(sm._jax_order(sv.params), donor, f"{kind}/{naming} donor")


# ----------------------------------------------------- import boundary


def _nonzoo_npz(tmp_path, num_fields=6, embed_dim=4, dims=(20, 8)):
    """A Keras-style plain-DNN export: embedding + a dense chain the zoo
    never builds."""
    rng = np.random.RandomState(5)
    d0 = num_fields * embed_dim
    variables = {"model/embedding/embeddings/.ATTRIBUTES/VARIABLE_VALUE":
                 rng.randn(997, embed_dim).astype(np.float32)}
    widths = (d0,) + tuple(dims) + (1,)
    for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
        stem = "model/dense" if i == 0 else f"model/dense_{i}"
        variables[f"{stem}/kernel/.ATTRIBUTES/VARIABLE_VALUE"] = (
            rng.randn(a, b).astype(np.float32) / np.sqrt(a))
        variables[f"{stem}/bias/.ATTRIBUTES/VARIABLE_VALUE"] = (
            rng.randn(b).astype(np.float32) * 0.01)
    npz = tmp_path / "nonzoo.npz"
    np.savez(npz, **variables)
    return npz, variables


def test_generic_fallback_serves_non_zoo_export(tmp_path):
    export = _write_fake_savedmodel(tmp_path)
    npz, _ = _nonzoo_npz(tmp_path)
    sv = import_savedmodel(export, "dcn_v2", CFG, name="DCN", variables_npz=npz, device="cpu")
    jsv = jsm.import_savedmodel(export, "dcn_v2", JCFG, name="DCN", variables_npz=npz)
    assert dataclasses.asdict(sv.model.config) == dataclasses.asdict(jsv.model.config)
    assert sv.model.config.mlp_dims == (20, 8) and sv.model.kind == "generic"
    _same_leaves(sm._jax_order(sv.params), jsv.params)
    arrays = _batch(7, 1)
    got = _scores(sv, arrays)
    np.testing.assert_allclose(got, _jax_scores(jsv, arrays), atol=1e-5, rtol=0)
    assert got.shape == (7,) and np.all((got >= 0) & (got <= 1))


def test_unmappable_export_rejected_with_documented_boundary(tmp_path):
    """Neither zoo- nor embed+MLP-shaped, no executable graph: the same
    three-way ranked error text in both packages (the extraction
    interpreter given as one that cannot run TensorFlow)."""
    export = _write_fake_savedmodel(tmp_path)
    rng = np.random.RandomState(2)
    npz = tmp_path / "conv.npz"
    np.savez(npz, **{"model/conv/kernel": rng.randn(3, 3, 8, 16).astype(np.float32),
                     "model/conv/bias": rng.randn(16).astype(np.float32)})
    no_tf = _python_without_tensorflow(tmp_path)
    msg = _same_error(
        lambda: import_savedmodel(export, "dcn_v2", CFG, variables_npz=npz, python=no_tf,
                                  device="cpu"),
        lambda: jsm.import_savedmodel(export, "dcn_v2", JCFG, variables_npz=npz,
                                      python=no_tf))
    assert "could not be served" in msg and "generic" in msg and "dcn_v2" in msg
    assert "GraphDef executor" in msg and "Native families" in msg


def test_generic_fallback_unbound_vectors_rejected(tmp_path):
    export = _write_fake_savedmodel(tmp_path)
    _, variables = _nonzoo_npz(tmp_path)
    variables["model/bn/moving_mean/.ATTRIBUTES/VARIABLE_VALUE"] = np.zeros(24, np.float32)
    npz2 = tmp_path / "bn.npz"
    np.savez(npz2, **variables)
    no_tf = _python_without_tensorflow(tmp_path)
    msg = _same_error(
        lambda: import_savedmodel(export, "dcn_v2", CFG, variables_npz=npz2, python=no_tf,
                                  device="cpu"),
        lambda: jsm.import_savedmodel(export, "dcn_v2", JCFG, variables_npz=npz2,
                                      python=no_tf))
    assert "could not be served" in msg and "unbound" in msg


def test_extraction_without_tensorflow_names_the_cause(tmp_path):
    """Where TensorFlow is missing (the card's machine), an export with no
    pre-extraction fails with the named cause, not a silent default."""
    export = _write_fake_savedmodel(tmp_path)
    no_tf = _python_without_tensorflow(tmp_path)
    with pytest.raises(SavedModelImportError, match="is tensorflow importable by") as e:
        import_savedmodel(export, "dcn_v2", CFG, python=no_tf, device="cpu", fallback=False)
    assert "No module named 'tensorflow'" in str(e.value)


def test_watcher_default_loader_names_missing_model_config(tmp_path):
    from distributed_tf_serving_tpu.models import ServableRegistry as JaxRegistry
    from distributed_tf_serving_tpu.serving.version_watcher import VersionWatcher as JaxWatcher
    from distributed_tf_serving_tpu.serving.version_watcher import (
        VersionWatcherConfig as JaxWatcherConfig,
    )
    from distributed_tf_serving_tpu_torch.serving.version_watcher import (
        VersionWatcher,
        VersionWatcherConfig,
    )

    version_dir = tmp_path / "1"
    version_dir.mkdir()
    export = _write_fake_savedmodel(version_dir)
    npz_path, _ = _donor_npz(tmp_path)
    time.sleep(0.02)
    os.replace(npz_path, export / "variables_extracted.npz")
    os.utime(export / "variables_extracted.npz")
    watcher = VersionWatcher(tmp_path, ServableRegistry(),
                             VersionWatcherConfig(poll_interval_s=3600, model_name="DCN"),
                             device="cpu")
    jwatcher = JaxWatcher(tmp_path, JaxRegistry(),
                          JaxWatcherConfig(poll_interval_s=3600, model_name="DCN"))
    msg = _same_error(lambda: watcher._default_loader(1, export),
                      lambda: jwatcher._default_loader(1, export))
    assert "pass model_config" in msg


# ------------------------------------------------ serving surfaces (CPU)


def test_build_stack_serves_savedmodel(tmp_path):
    """--savedmodel through build_stack: the imported servable registered
    and scoring through the batcher (the in-export pre-extraction honored),
    GetModelMetadata answering the export's own signatures."""
    from distributed_tf_serving_tpu_torch.proto import serving_apis_pb2 as apis
    from distributed_tf_serving_tpu_torch.serving.server import build_stack
    from distributed_tf_serving_tpu_torch.utils.config import ServerConfig

    export = _write_fake_savedmodel(tmp_path)
    npz_path, _ = _donor_npz(tmp_path)
    time.sleep(0.02)
    os.replace(npz_path, export / "variables_extracted.npz")
    os.utime(export / "variables_extracted.npz")
    cfg = ServerConfig(model_kind="dcn_v2", model_name="DCN", num_fields=6, warmup=True,
                       buckets=(8,))
    impl, batcher, servable = build_stack(cfg, CFG, device="cpu", savedmodel=str(export))
    try:
        assert impl.registry.resolve("DCN").version == 1
        arrays = _batch(4, 1)
        out = batcher.submit(servable, arrays).result(60)
        np.testing.assert_array_equal(out["prediction_node"], _scores(servable, arrays))
        meta = impl.get_model_metadata(apis.GetModelMetadataRequest(
            model_spec=apis.ModelSpec(name="DCN"), metadata_field=["signature_def"]))
        sig_map = apis.SignatureDefMap()
        meta.metadata["signature_def"].Unpack(sig_map)
        assert sorted(sig_map.signature_def) == ["serving_default"]
        assert sorted(sig_map.signature_def["serving_default"].outputs) == ["prediction_node"]
    finally:
        batcher.stop()


def test_build_stack_replays_the_exports_warmup_file(tmp_path, caplog):
    """The export's assets.extra warmup records go through the service and
    the running batcher before the server answers."""
    import logging

    from distributed_tf_serving_tpu_torch.serving.server import build_stack
    from distributed_tf_serving_tpu_torch.serving.warmup import (
        WARMUP_DIRNAME,
        WARMUP_FILENAME,
        make_warmup_record,
        write_tfrecords,
    )
    from distributed_tf_serving_tpu_torch.utils.config import ServerConfig

    export = _write_fake_savedmodel(tmp_path)
    (export / WARMUP_DIRNAME).mkdir()
    write_tfrecords(export / WARMUP_DIRNAME / WARMUP_FILENAME,
                    [make_warmup_record(_batch(n, n), "DCN") for n in (3, 5)])
    npz_path, _ = _donor_npz(tmp_path)
    time.sleep(0.02)
    os.replace(npz_path, export / "variables_extracted.npz")
    os.utime(export / "variables_extracted.npz")
    cfg = ServerConfig(model_name="DCN", num_fields=6, warmup=True, buckets=(8,))
    with caplog.at_level(logging.INFO, logger="dts_torch.server"):
        impl, batcher, servable = build_stack(cfg, CFG, device="cpu", savedmodel=str(export))
    try:
        assert any("replayed 2 warmup records" in r.getMessage() for r in caplog.records)
        assert batcher.stats.requests >= 2
    finally:
        batcher.stop()


def test_model_platform_tensorflow_base_path_serves(tmp_path):
    """A model_config_list entry with model_platform "tensorflow" over a
    base path of SavedModel versions serves (imported as the server's
    model_kind with its [model] config), as in the JAX server."""
    from distributed_tf_serving_tpu_torch.proto import serving_apis_pb2 as apis
    from distributed_tf_serving_tpu_torch.serving.server import build_stack
    from distributed_tf_serving_tpu_torch.utils.config import ServerConfig

    export = _write_fake_savedmodel(tmp_path / "A", name="1")
    (export / "variables").mkdir()
    (export / "variables" / "variables.index").write_bytes(b"")
    npz_path, _ = _donor_npz(tmp_path, seed=3)
    time.sleep(0.02)
    os.replace(npz_path, export / "variables_extracted.npz")
    os.utime(export / "variables_extracted.npz")
    msc = apis.ModelServerConfig()
    msc.model_config_list.config.add(name="A", base_path=str(tmp_path / "A"),
                                     model_platform="tensorflow")
    from google.protobuf import text_format

    (tmp_path / "m.config").write_text(text_format.MessageToString(msc))
    cfg = ServerConfig(model_config_file=str(tmp_path / "m.config"), model_kind="dcn_v2",
                       num_fields=6, buckets=(8,), warmup=False)
    impl, batcher, servable = build_stack(cfg, CFG, device="cpu")
    try:
        assert impl.registry.models() == {"A": [1]}
        sv = impl.registry.resolve("A")
        arrays = _batch(3, 2)
        out = batcher.submit(sv, arrays).result(60)
        np.testing.assert_array_equal(out["prediction_node"], _scores(sv, arrays))
    finally:
        impl.model_lifecycle.stop()
        batcher.stop()


def test_build_stack_refuses_a_second_source(tmp_path):
    from distributed_tf_serving_tpu_torch.serving.server import build_stack
    from distributed_tf_serving_tpu_torch.utils.config import ServerConfig

    cfg = ServerConfig(buckets=(8,), warmup=False)
    with pytest.raises(ValueError, match="--model-base-path is mutually exclusive with "
                                         "--checkpoint/--savedmodel"):
        build_stack(cfg, None, device="cpu", savedmodel="x", model_base_path="y")
    with pytest.raises(ValueError, match="--checkpoint is mutually exclusive with --savedmodel"):
        build_stack(cfg, None, device="cpu", savedmodel="x", checkpoint="y")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_conversion_and_savedmodel_server(tmp_path):
    """The conversion CLI writes a checkpoint whose params are the import's;
    a --savedmodel CLI server on the CPU answers Predict with the scores of
    that checkpoint, and GetModelMetadata with the export's signatures."""
    import grpc

    from distributed_tf_serving_tpu_torch.proto import PredictionServiceStub
    from distributed_tf_serving_tpu_torch.proto import serving_apis_pb2 as apis
    from distributed_tf_serving_tpu_torch.train.checkpoint import load_servable

    export = _write_fake_savedmodel(tmp_path)
    # The CLI's architecture: its flags' widths, the zoo's default depth.
    npz_path, _ = _donor_npz(tmp_path, cfg=JaxConfig(num_fields=6, vocab_size=997,
                                                     embed_dim=4))
    time.sleep(0.02)
    os.replace(npz_path, export / "variables_extracted.npz")
    os.utime(export / "variables_extracted.npz")
    args = ["--num-fields", "6", "--vocab-size", "997", "--embed-dim", "4"]
    res = subprocess.run(
        [sys.executable, "-m", "distributed_tf_serving_tpu_torch.interop.savedmodel",
         str(export), str(tmp_path / "ckpt"), "--device", "cpu", *args],
        cwd=REPO, capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stderr
    assert "imported DCN v1 (dcn_v2)" in res.stdout
    ckpt = load_servable(tmp_path / "ckpt", device="cpu")
    toml = tmp_path / "s.toml"
    toml.write_text("[server]\nnum_fields = 6\nbuckets = [8]\nmax_wait_us = 0\n"
                    "[model]\nnum_fields = 6\nvocab_size = 997\nembed_dim = 4\n"
                    "mlp_dims = [256, 128, 64]\nnum_cross_layers = 3\n")
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_tf_serving_tpu_torch.serving.server", "--device",
         "cpu", "--port", str(port), "--config", str(toml), "--savedmodel", str(export)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        arrays = _batch(5, 4)
        req = apis.PredictRequest()
        req.model_spec.name = "DCN"
        for k, v in arrays.items():
            req.inputs[k].CopyFrom(codec.from_ndarray(v))
        with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
            stub = PredictionServiceStub(ch)
            deadline = time.time() + 120
            while True:
                try:
                    meta = stub.GetModelMetadata(apis.GetModelMetadataRequest(
                        model_spec=apis.ModelSpec(name="DCN"),
                        metadata_field=["signature_def"]), timeout=2)
                    break
                except grpc.RpcError:
                    assert proc.poll() is None and time.time() < deadline, proc.stdout.read()
                    time.sleep(0.2)
            resp = stub.Predict(req, timeout=60)
        sig_map = apis.SignatureDefMap()
        meta.metadata["signature_def"].Unpack(sig_map)
        assert sorted(sig_map.signature_def) == ["serving_default"]
        got = codec.to_ndarray(resp.outputs["prediction_node"])
        np.testing.assert_array_equal(got, _scores(ckpt, arrays))
    finally:
        proc.terminate()
        proc.wait(timeout=60)


# --------------------------------------------------- TensorFlow exports

_BUILD_TF = """
import sys
import numpy as np
import tensorflow as tf

root = sys.argv[1]


class M(tf.Module):
    def __init__(self):
        super().__init__()
        self.w = tf.Variable(np.arange(12, dtype=np.float32).reshape(4, 3), name="w")
        self.b = tf.Variable(np.array([1.5, -2.5], np.float32), name="b")

    @tf.function(input_signature=[tf.TensorSpec([None, 4], tf.float32, name="x")])
    def __call__(self, x):
        return {"y": tf.matmul(x, self.w) + self.b[0]}


m = M()
tf.saved_model.save(m, root + "/tf_export", signatures={"serving_default": m.__call__})

V, F, D, L = 499, 4, 3, 2
d = F * D
MLP = (d, d)  # deliberately collides with the (d,d) cross kernels
rng = np.random.RandomState(5)


class KerasishDCN(tf.Module):
    def __init__(self):
        super().__init__()
        self.embedding = tf.Variable((rng.randn(V, D) / np.sqrt(D)).astype(np.float32))
        self.cross_kernels = [
            tf.Variable((rng.randn(d, d) / np.sqrt(d)).astype(np.float32)) for _ in range(L)]
        self.cross_biases = [tf.Variable(np.zeros(d, np.float32) + 0.01 * i) for i in range(L)]
        self.dense0_kernel = tf.Variable(
            (rng.randn(d, MLP[0]) * np.sqrt(2.0 / d)).astype(np.float32))
        self.dense0_bias = tf.Variable(np.full(MLP[0], 0.02, np.float32))
        self.dense1_kernel = tf.Variable(
            (rng.randn(MLP[0], MLP[1]) * np.sqrt(2.0 / MLP[0])).astype(np.float32))
        self.dense1_bias = tf.Variable(np.full(MLP[1], 0.03, np.float32))
        self.output_kernel = tf.Variable(
            (rng.randn(d + MLP[1], 1) * np.sqrt(2.0 / (d + MLP[1]))).astype(np.float32))
        self.output_bias = tf.Variable(np.zeros(1, np.float32))

    @tf.function(input_signature=[
        tf.TensorSpec([None, F], tf.int64, name="feat_ids"),
        tf.TensorSpec([None, F], tf.float32, name="feat_wts"),
    ])
    def __call__(self, feat_ids, feat_wts):
        rows = tf.cast(tf.math.floormod(feat_ids, tf.constant(V, tf.int64)), tf.int32)
        emb = tf.gather(self.embedding, rows) * feat_wts[..., None]
        x0 = tf.reshape(emb, [-1, d])
        x = x0
        for w, b in zip(self.cross_kernels, self.cross_biases):
            x = x0 * (tf.matmul(x, w) + b) + x
        h = x0
        for w, b in ((self.dense0_kernel, self.dense0_bias),
                     (self.dense1_kernel, self.dense1_bias)):
            h = tf.nn.relu(tf.matmul(h, w) + b)
        cat = tf.concat([x, h], axis=-1)
        logit = tf.matmul(cat, self.output_kernel)[:, 0] + self.output_bias[0]
        return {"prediction_node": tf.sigmoid(logit)}


m = KerasishDCN()
tf.saved_model.save(m, root + "/keras_dcn", signatures={"serving_default": m.__call__})
ids = rng.randint(0, 1 << 40, size=(7, F)).astype(np.int64)
wts = rng.rand(7, F).astype(np.float32)
scores = m(tf.constant(ids), tf.constant(wts))["prediction_node"].numpy()
np.savez(root + "/golden.npz", ids=ids, wts=wts, scores=scores)
print("built")
"""


@pytest.fixture(scope="module")
def tf_exports(tmp_path_factory):
    """Both TensorFlow exports of this module, built in one TF process."""
    root = tmp_path_factory.mktemp("tf")
    r = subprocess.run([sys.executable, "-c", _BUILD_TF, str(root)],
                       capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        pytest.skip(f"tensorflow unavailable: {r.stderr.strip()[-300:]}")
    return root


def test_real_tensorflow_export_roundtrip(tf_exports, tmp_path):
    """A genuine tf.saved_model.save export: the native parser reads its
    signature_def as the JAX one does, and the importer's TF subprocess
    recovers exact variable values."""
    export = tf_exports / "tf_export"
    sigs = signatures_from_meta_graph(sm.serve_meta_graph(read_saved_model(export)))
    jsigs = jsm.signatures_from_meta_graph(jsm.serve_meta_graph(jsm.read_saved_model(export)))
    assert {k: dataclasses.astuple(v) for k, v in sigs.items()} == \
        {k: dataclasses.astuple(v) for k, v in jsigs.items()}
    x = next(s for s in sigs["serving_default"].inputs if s.dtype == fw.DT_FLOAT)
    assert x.shape[-1] == 4
    npz_path = sm.extract_variables(export, tmp_path / "vars.npz")
    with np.load(npz_path) as npz:
        by_shape = {tuple(npz[k].shape): npz[k] for k in npz.files}
    np.testing.assert_array_equal(by_shape[(4, 3)],
                                  np.arange(12, dtype=np.float32).reshape(4, 3))
    np.testing.assert_array_equal(by_shape[(2,)], np.array([1.5, -2.5], np.float32))


def test_real_keras_named_dcn_import_golden_scores(tf_exports):
    """A TF-exported DCN with non-zoo variable names imports with NO
    mapping (the extraction subprocess, then the cache) and serves TF's own
    golden scores; the JAX import binds the same leaves."""
    export = tf_exports / "keras_dcn"
    kw = dict(num_fields=4, vocab_size=499, embed_dim=3, mlp_dims=(12, 12),
              num_cross_layers=2, compute_dtype="float32")
    sv = import_savedmodel(export, "dcn_v2", ModelConfig(**kw), name="DCN", version=3,
                           device="cpu")
    assert sm._npz_cache_fresh(export, sm._default_npz_cache_path(export))
    jsv = jsm.import_savedmodel(export, "dcn_v2", JaxConfig(**kw), name="DCN", version=3,
                                variables_npz=sm._default_npz_cache_path(export))
    _same_leaves(sm._jax_order(sv.params), jsv.params)
    with np.load(tf_exports / "golden.npz") as g:
        arrays, want = {"feat_ids": g["ids"], "feat_wts": g["wts"]}, g["scores"]
    np.testing.assert_allclose(_scores(sv, arrays), want, rtol=1e-5)
    again = import_savedmodel(export, "dcn_v2", ModelConfig(**kw), device="cpu")
    _same_leaves(sm._jax_order(again.params), jsv.params)
    assert json.dumps(sorted(again.signatures)) == json.dumps(sorted(jsv.signatures))
