"""The port's model-version lifecycle (serving/version_watcher.py), the
TF-Serving base-path convention: the JAX package's watcher cases
(tests/test_version_watcher.py) run through poll_once, the JAX-only
directory that becomes ready once converted, SavedModel versions imported
and hot-swapped, the --model-base-path server (GetModelStatus START, health), and a hot swap over
a live CPU socket with zero failed requests and the retired Servable
collected."""

import dataclasses
import gc
import importlib.util
import logging
import os
import pathlib
import shutil
import socket
import subprocess
import sys
import threading
import time
import weakref

import grpc
import jax
import numpy as np
import pytest
import torch

from distributed_tf_serving_tpu.models import ModelConfig as JaxConfig
from distributed_tf_serving_tpu.models import Servable as JaxServable
from distributed_tf_serving_tpu.models import build_model as jax_build
from distributed_tf_serving_tpu.serving.batcher import fold_ids_host as jax_fold
from distributed_tf_serving_tpu.train import checkpoint as jax_ckpt
from distributed_tf_serving_tpu_torch import codec
from distributed_tf_serving_tpu_torch.models import (
    ModelConfig,
    Servable,
    ServableRegistry,
    build_model,
    ctr_signatures,
)
from distributed_tf_serving_tpu_torch.ops import cross_kernel as ck
from distributed_tf_serving_tpu_torch.proto import (
    HealthCheckRequest,
    HealthStub,
    ModelServiceStub,
    PredictionServiceStub,
)
from distributed_tf_serving_tpu_torch.proto import health as health_proto
from distributed_tf_serving_tpu_torch.proto import serving_apis_pb2 as apis
from distributed_tf_serving_tpu_torch.serving.batcher import DynamicBatcher, fold_ids_host
from distributed_tf_serving_tpu_torch.serving.server import build_stack, create_server
from distributed_tf_serving_tpu_torch.serving.service import PredictionServiceImpl
from distributed_tf_serving_tpu_torch.serving.version_watcher import (
    VersionWatcher,
    VersionWatcherConfig,
    _version_ready,
    is_jax_only,
    scan_versions,
)
from distributed_tf_serving_tpu_torch.train.checkpoint import PARAMS_FILE, save_servable
from distributed_tf_serving_tpu_torch.utils.config import ServerConfig, load_config

REPO = pathlib.Path(__file__).resolve().parents[1]
CFG = ModelConfig(num_fields=6, vocab_size=512, embed_dim=4, mlp_dims=(8,),
                  num_cross_layers=1, compute_dtype="float32")


def _servable(version, seed, kind="dcn", config=CFG):
    model = build_model(kind, config)
    return Servable(name="DCN", version=version, model=model, params=model.init(seed, "cpu"),
                    signatures=ctr_signatures(config.num_fields))


def _write_version(base, version, seed, kind="dcn", config=CFG):
    sv = _servable(version, seed, kind, config)
    save_servable(pathlib.Path(base) / str(version), sv, kind=kind)
    return sv


def _watcher(base, registry, keep=2, **kw):
    return VersionWatcher(
        base, registry,
        VersionWatcherConfig(poll_interval_s=3600, keep_versions=keep, model_name="DCN"),
        device="cpu", **kw,
    )


def _payload(n, seed, fields=6):
    rng = np.random.RandomState(seed)
    return {"feat_ids": rng.randint(0, 1 << 40, size=(n, fields)).astype(np.int64),
            "feat_wts": rng.rand(n, fields).astype(np.float32)}


def _scores(sv, arrays):
    batch = {"feat_ids": torch.from_numpy(fold_ids_host(arrays["feat_ids"],
                                                        sv.model.config.vocab_size)),
             "feat_wts": torch.from_numpy(arrays["feat_wts"])}
    with torch.inference_mode():
        return sv(batch)["prediction_node"].numpy()


def _request(arrays, version=None):
    req = apis.PredictRequest()
    req.model_spec.name = "DCN"
    if version is not None:
        req.model_spec.version.value = version
    for k, v in arrays.items():
        codec.from_ndarray(v, out=req.inputs[k])
    return req


# ------------------------------------------ the JAX package's watcher cases


def test_scan_ignores_non_numeric(tmp_path):
    (tmp_path / "1").mkdir()
    (tmp_path / "notaversion").mkdir()
    (tmp_path / "2").mkdir()
    (tmp_path / "file.txt").write_text("x")
    assert sorted(scan_versions(tmp_path)) == [1, 2]
    assert scan_versions(tmp_path / "missing") == {}


def test_load_retire_and_latest_flip(tmp_path):
    registry = ServableRegistry()
    _write_version(tmp_path, 1, seed=1)
    w = _watcher(tmp_path, registry)
    w.poll_once()
    assert registry.models() == {"DCN": [1]}
    assert registry.resolve("DCN").version == 1

    _write_version(tmp_path, 2, seed=2)
    _write_version(tmp_path, 3, seed=3)
    w.poll_once()
    assert registry.models() == {"DCN": [2, 3]}
    assert registry.resolve("DCN").version == 3
    assert registry.resolve("DCN", version=2).version == 2
    assert set(w.load_timings[3]) >= {"read_s", "copy_s", "loaded_at"}


def test_desired_labels_applied_and_pin_survives_retention(tmp_path):
    registry = ServableRegistry()
    _write_version(tmp_path, 1, seed=1)
    w = VersionWatcher(
        tmp_path, registry,
        VersionWatcherConfig(poll_interval_s=3600, keep_versions=2, model_name="DCN",
                             desired_labels=(("canary", 3), ("stable", 1))),
        device="cpu",
    )
    w.poll_once()
    assert registry.labels("DCN") == {"stable": 1}

    _write_version(tmp_path, 2, seed=2)
    _write_version(tmp_path, 3, seed=3)
    w.poll_once()
    assert registry.labels("DCN") == {"stable": 1, "canary": 3}
    assert registry.models() == {"DCN": [1, 2, 3]}

    _write_version(tmp_path, 4, seed=4)
    w.poll_once()
    assert registry.models() == {"DCN": [1, 3, 4]}
    assert registry.resolve("DCN", label="stable").version == 1


def test_partial_version_dir_skipped_then_loaded(tmp_path):
    registry = ServableRegistry()
    (tmp_path / "7").mkdir()
    w = _watcher(tmp_path, registry)
    w.poll_once()
    assert registry.models() == {}
    # params written, manifest not yet: still not ready (commit protocol).
    sv = _servable(7, seed=7)
    save_servable(tmp_path / "7", sv, kind="dcn")
    (tmp_path / "7" / "servable.json").rename(tmp_path / "manifest.later")
    w.poll_once()
    assert registry.models() == {}
    (tmp_path / "manifest.later").rename(tmp_path / "7" / "servable.json")
    w.poll_once()
    assert registry.models() == {"DCN": [7]}


def _poison(d):
    d.mkdir()
    (d / "servable.json").write_text("{not json")
    (d / PARAMS_FILE).write_bytes(b"")  # looks ready; load will fail


def test_poison_version_bounded_retries(tmp_path):
    registry = ServableRegistry()
    _poison(tmp_path / "9")
    w = _watcher(tmp_path, registry)
    for _ in range(5):
        w.poll_once()
        assert registry.models() == {}
    assert w._attempts[9] == w.config.max_load_attempts


def test_transient_failure_recovers_within_attempts(tmp_path):
    registry = ServableRegistry()
    d = tmp_path / "4"
    _poison(d)
    w = _watcher(tmp_path, registry)
    w.poll_once()
    assert w._attempts[4] == 1
    shutil.rmtree(d)
    _write_version(tmp_path, 4, seed=4)
    w.poll_once()
    assert registry.models() == {"DCN": [4]}
    assert 4 not in w._attempts


def test_retired_versions_never_reloaded(tmp_path):
    registry = ServableRegistry()
    for v in (1, 2, 3):
        _write_version(tmp_path, v, seed=v)
    w = _watcher(tmp_path, registry, keep=2)
    loads = []
    inner = w.loader
    w.loader = lambda version, path: (loads.append(version), inner(version, path))[1]
    w.poll_once()
    assert registry.models() == {"DCN": [2, 3]}
    assert loads == [2, 3]
    for _ in range(3):
        w.poll_once()
    assert loads == [2, 3]
    assert registry.models() == {"DCN": [2, 3]}


def test_blacklisted_version_recovers_when_writer_finishes(tmp_path):
    registry = ServableRegistry()
    d = tmp_path / "5"
    _poison(d)
    w = _watcher(tmp_path, registry)
    for _ in range(4):
        w.poll_once()
    assert w._attempts[5] == w.config.max_load_attempts
    assert registry.models() == {}
    shutil.rmtree(d)
    _write_version(tmp_path, 5, seed=5)
    os.utime(tmp_path / "5" / "servable.json")
    w.poll_once()
    assert registry.models() == {"DCN": [5]}
    assert 5 not in w._attempts


def test_saved_model_readiness_requires_variables_index_and_is_refused(tmp_path, caplog):
    """A SavedModel export probes ready like the JAX package's (once
    variables/variables.index exists); one whose saved_model.pb holds no
    meta graph is refused by the importer in every bounded attempt, with
    its named error."""
    d = tmp_path / "1"
    (d / "variables").mkdir(parents=True)
    (d / "saved_model.pb").write_bytes(b"")
    (d / "variables" / "variables.data-00000-of-00001").write_bytes(b"partial")
    assert not _version_ready(d)
    (d / "variables" / "variables.index").write_bytes(b"")
    assert _version_ready(d)
    registry = ServableRegistry()
    w = _watcher(tmp_path, registry)
    with caplog.at_level(logging.ERROR, logger="dts_torch.versions"):
        for _ in range(4):
            w.poll_once()
    assert registry.models() == {}
    assert w._attempts[1] == w.config.max_load_attempts
    assert sum("SavedModelImportError" in r.exc_text and "contains no meta graphs" in r.exc_text
               for r in caplog.records if r.exc_text) == w.config.max_load_attempts


def _write_saved_model_version(base, version, seed, config=CFG):
    """A dcn_v2 SavedModel export written with the vendored protos: serving
    signature, the variables.index the readiness probe needs, and the
    weights of a dcn_v2 `_servable(version, seed)` pre-extracted in the export (no
    TensorFlow involved)."""
    from distributed_tf_serving_tpu_torch.interop.savedmodel import _flatten_params
    from distributed_tf_serving_tpu_torch.proto import tf_saved_model_pb2 as sm

    d = pathlib.Path(base) / str(version)
    (d / "variables").mkdir(parents=True)
    proto = sm.SavedModel(saved_model_schema_version=1)
    mg = proto.meta_graphs.add()
    mg.meta_info_def.tags.append("serve")
    sd = mg.signature_def["serving_default"]
    sd.method_name = "tensorflow/serving/predict"
    for spec in ctr_signatures(config.num_fields)["serving_default"].inputs:
        sd.inputs[spec.name].CopyFrom(spec.to_tensor_info())
    sd.outputs["prediction_node"].name = "prediction_node:0"
    sd.outputs["prediction_node"].dtype = 1
    (d / "saved_model.pb").write_bytes(proto.SerializeToString())
    (d / "variables" / "variables.index").write_bytes(b"")
    sv = _servable(version, seed, kind="dcn_v2", config=config)
    flat = _flatten_params(sv.params)
    time.sleep(0.02)  # the pre-extraction must postdate the export's files
    np.savez(d / "variables_extracted.npz",
             **{f"model/{p}/.ATTRIBUTES/VARIABLE_VALUE": t.numpy() for p, t in flat.items()})
    return sv


def test_saved_model_version_is_imported_and_hot_swapped(tmp_path):
    """A SavedModel version probes ready and is imported (as the watcher's
    model_kind, with its model_config); the next one hot-swaps in, and
    each serves its donor's scores exactly."""
    donors = {1: _write_saved_model_version(tmp_path, 1, seed=1)}
    registry = ServableRegistry()
    w = VersionWatcher(
        tmp_path, registry,
        VersionWatcherConfig(poll_interval_s=3600, model_name="DCN", model_kind="dcn_v2"),
        device="cpu", model_config=CFG)
    w.poll_once()
    assert registry.models() == {"DCN": [1]}
    donors[2] = _write_saved_model_version(tmp_path, 2, seed=2)
    w.poll_once()
    assert registry.models() == {"DCN": [1, 2]}
    assert set(w.load_timings[2]) >= {"parse_s", "npz_s", "map_s", "ctx_s", "h2d_s",
                                     "loaded_at"}
    payload = _payload(5, seed=3)
    batch = {"feat_ids": torch.from_numpy(fold_ids_host(payload["feat_ids"], CFG.vocab_size)),
             "feat_wts": torch.from_numpy(payload["feat_wts"])}
    for v, donor in donors.items():
        sv = registry.resolve("DCN", v)
        assert sv.version == v and sorted(sv.signatures) == ["serving_default"]
        got = sv.model.apply(sv.params, batch)["prediction_node"]
        want = donor.model.apply(donor.params, batch)["prediction_node"]
        assert torch.equal(got, want), v
    assert registry.resolve("DCN").version == 2


def test_retire_blacklists_and_change_hook_fires(tmp_path):
    registry = ServableRegistry()
    for v in (1, 2):
        _write_version(tmp_path, v, seed=v)
    changes = []
    w = _watcher(tmp_path, registry, on_servable_change=changes.append)
    w.poll_once()
    assert changes == ["DCN", "DCN"]
    assert w.retire(2) and registry.models() == {"DCN": [1]}
    w.poll_once()
    assert registry.models() == {"DCN": [1]}  # not reloaded from disk
    snap = w.snapshot()
    assert snap["blacklisted"] == [2] and snap["on_disk_ready"] == [1, 2]
    assert not w.retire(7)
    w.on_servable_change = lambda name: 1 / 0  # a failing hook fails nothing
    w.unblacklist(2)
    w.poll_once()
    assert registry.models() == {"DCN": [1, 2]}


def test_pinned_version_survives_retention_until_unpinned(tmp_path):
    registry = ServableRegistry()
    for v in (1, 2):
        _write_version(tmp_path, v, seed=v)
    w = _watcher(tmp_path, registry)
    w.poll_once()
    w.pin(1)
    _write_version(tmp_path, 3, seed=3)
    w.poll_once()
    assert registry.models() == {"DCN": [1, 2, 3]}
    assert w.snapshot()["pinned"] == [1]
    w.unpin(1)
    w.poll_once()
    assert registry.models() == {"DCN": [2, 3]}


# ------------------------------------------------ the JAX-only directory


def _converter():
    spec = importlib.util.spec_from_file_location(
        "jax_checkpoint_to_torch", REPO / "tools" / "jax_checkpoint_to_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_jax_only_version_waits_for_the_converter_without_burning_attempts(tmp_path, caplog):
    jcfg = JaxConfig(**{f.name: getattr(CFG, f.name) for f in dataclasses.fields(CFG)})
    jm = jax_build("dcn", jcfg)
    jsv = JaxServable(name="DCN", version=3, model=jm, params=jm.init(jax.random.PRNGKey(3)),
                      signatures={})
    jax_ckpt.save_servable(tmp_path / "3", jsv, kind="dcn")
    _write_version(tmp_path, 1, seed=1)
    registry = ServableRegistry()
    w = _watcher(tmp_path, registry)
    assert is_jax_only(tmp_path / "3") and not _version_ready(tmp_path / "3")
    with caplog.at_level(logging.WARNING, logger="dts_torch.versions"):
        for _ in range(5):
            w.poll_once()
    assert registry.models() == {"DCN": [1]}
    assert 3 not in w._attempts
    hints = [r.getMessage() for r in caplog.records if "jax_checkpoint_to_torch" in r.getMessage()]
    assert len(hints) == 1 and "v3" in hints[0]

    _converter().convert(tmp_path / "3")  # in place
    w.poll_once()
    assert registry.models() == {"DCN": [1, 3]}
    arrays = _payload(5, 0)
    folded = {"feat_ids": jax_fold(arrays["feat_ids"], CFG.vocab_size),
              "feat_wts": arrays["feat_wts"]}
    np.testing.assert_allclose(_scores(registry.resolve("DCN"), arrays),
                               np.asarray(jm.apply(jsv.params, folded)["prediction_node"]),
                               rtol=1e-5, atol=1e-6)


# ------------------------------------------------ warmup through the queue


def test_warmup_via_queue_runs_on_the_batchers_threads(tmp_path):
    sv = _servable(1, seed=1)
    batcher = DynamicBatcher(buckets=(8, 32), max_wait_us=0, device="cpu").start()
    seen = []
    real = batcher._issue

    def spy(*a, **kw):
        seen.append(threading.current_thread().name)
        return real(*a, **kw)

    batcher._issue = spy
    try:
        batcher.warmup_via_queue(sv)
    finally:
        batcher.stop()
    assert seen and set(seen) == {"batch-dispatch"}
    assert batcher.stats.candidates == 40


# ----------------------------------------------- the --model-base-path stack


def _tiny_server_config(**kw):
    return ServerConfig(model_kind="dcn", num_fields=6, buckets=(8, 32), max_wait_us=0,
                        file_system_poll_wait_seconds=3600, **kw)


def test_base_path_stack_reports_start_then_serves(tmp_path):
    impl, batcher, servable = build_stack(_tiny_server_config(), None, "cpu",
                                          model_base_path=tmp_path)
    server, port = create_server(impl, "127.0.0.1:0")
    server.start()
    try:
        assert servable is None and impl.warmup_complete
        with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
            st = ModelServiceStub(ch).GetModelStatus(
                apis.GetModelStatusRequest(model_spec=apis.ModelSpec(name="DCN")))
            assert [(s.version, s.state) for s in st.model_version_status] == [
                (0, apis.ModelVersionStatus.START)]
            health = HealthStub(ch)
            assert health.Check(HealthCheckRequest(service="DCN")).status == \
                health_proto.NOT_SERVING
            assert health.Check(HealthCheckRequest(service="")).status == \
                health_proto.NOT_SERVING
            with pytest.raises(grpc.RpcError) as e:
                ModelServiceStub(ch).GetModelStatus(
                    apis.GetModelStatusRequest(model_spec=apis.ModelSpec(name="other")))
            assert e.value.code() == grpc.StatusCode.NOT_FOUND

            sv1 = _write_version(tmp_path, 1, seed=1)
            impl.version_watcher.poll_once()
            assert health.Check(HealthCheckRequest(service="DCN")).status == health_proto.SERVING
            arrays = _payload(5, 1)
            resp = PredictionServiceStub(ch).Predict(_request(arrays), timeout=30)
            assert resp.model_spec.version.value == 1
            np.testing.assert_allclose(codec.to_ndarray(resp.outputs["prediction_node"]),
                                       _scores(sv1, arrays), rtol=1e-5, atol=1e-6)
    finally:
        server.stop(0)
        impl.version_watcher.stop()
        batcher.stop()


def test_checkpoint_and_base_path_are_mutually_exclusive(tmp_path):
    with pytest.raises(ValueError, match="mutually exclusive"):
        build_stack(_tiny_server_config(), None, "cpu", checkpoint=tmp_path,
                    model_base_path=tmp_path)
    res = subprocess.run(
        [sys.executable, "-m", "distributed_tf_serving_tpu_torch.serving.server",
         "--device", "cpu", "--checkpoint", str(tmp_path), "--model-base-path", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and "not allowed with argument" in res.stderr


def test_checkpoint_stack_serves_the_checkpoint_with_its_labels(tmp_path):
    sv = _write_version(tmp_path, 3, seed=3)
    impl, batcher, servable = build_stack(
        _tiny_server_config(version_labels=(("stable", 3),)), None, "cpu",
        checkpoint=tmp_path / "3")
    try:
        assert (servable.name, servable.version) == ("DCN", 3)
        assert impl.registry.labels("DCN") == {"stable": 3}
        arrays = _payload(6, 2)
        resp = impl.predict(_request(arrays))
        np.testing.assert_allclose(codec.to_ndarray(resp.outputs["prediction_node"]),
                                   _scores(sv, arrays), rtol=1e-5, atol=1e-6)
    finally:
        batcher.stop()


def test_config_reads_the_lifecycle_server_keys(tmp_path):
    p = tmp_path / "c.toml"
    p.write_text("[server]\nwarmup = false\nversion_labels = {stable = 2, canary = 3}\n"
                 "file_system_poll_wait_seconds = 0.5\nmax_num_load_retries = 4\n")
    cfg = load_config(p)["server"]
    assert cfg.warmup is False
    assert cfg.version_labels == (("canary", 3), ("stable", 2))
    assert (cfg.file_system_poll_wait_seconds, cfg.max_num_load_retries) == (0.5, 4)
    assert ServerConfig().warmup and ServerConfig().max_num_load_retries == 2


# ------------------------------------------- hot swap over a live socket


def test_hot_swap_over_live_socket_fails_no_request_and_frees_the_old_version(tmp_path):
    """Clients keep sending while the watcher loads v2 and v3 (v1 falls out
    of the keep-2 window): every request succeeds with the scores of the
    version its response names, and the retired v1 is collected."""
    svs = {1: _write_version(tmp_path, 1, seed=1)}
    registry = ServableRegistry()
    batcher = DynamicBatcher(buckets=(8, 32), max_wait_us=0, device="cpu").start()
    impl = PredictionServiceImpl(registry, batcher)
    server, port = create_server(impl, "127.0.0.1:0")
    server.start()
    w = _watcher(tmp_path, registry, warmup=batcher.warmup_via_queue).start()
    ref = weakref.ref(registry.resolve("DCN", version=1))
    arrays = _payload(7, 3)
    answers, errors, stop = [], [], threading.Event()

    def client():
        with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
            stub = PredictionServiceStub(ch)
            while not stop.is_set():
                try:
                    resp = stub.Predict(_request(arrays), timeout=30)
                    answers.append((resp.model_spec.version.value,
                                    codec.to_ndarray(resp.outputs["prediction_node"])))
                except grpc.RpcError as e:  # reported below
                    errors.append(e)

    threads = [threading.Thread(target=client) for _ in range(3)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.2)
        for v in (2, 3):
            svs[v] = _write_version(tmp_path, v, seed=v)
            w.poll_once()
            time.sleep(0.2)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        server.stop(0)
        w.stop()
        batcher.stop()
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert registry.models() == {"DCN": [2, 3]}
    assert {v for v, _ in answers} >= {1, 3}
    want = {v: _scores(sv, arrays) for v, sv in svs.items()}
    for v, got in answers:
        np.testing.assert_allclose(got, want[v], rtol=1e-5, atol=1e-6)
    del svs[1]
    assert _collected(ref)


def _collected(ref, timeout_s: float = 10.0) -> bool:
    """True once `ref` dies: a batcher thread may hold the last batch of a
    retired version a moment after its future completed."""
    end = time.perf_counter() + timeout_s
    while ref() is not None and time.perf_counter() < end:
        gc.collect()
        time.sleep(0.01)
    return ref() is None


def test_retired_version_leaves_no_cross_weights_behind(tmp_path):
    """On the use_pallas_cross path the cross cache holds a version's
    prepared cross weights; it holds its sources weakly and drops the entry
    when they die, so a retired version leaves nothing behind."""
    ck.cross_cache.clear()
    cfg = dataclasses.replace(CFG, use_pallas_cross=True)
    _write_version(tmp_path, 1, seed=1, kind="dcn_v2", config=cfg)
    registry = ServableRegistry()
    batcher = DynamicBatcher(buckets=(8,), max_wait_us=0, device="cpu",
                             fused_kernel=False).start()
    w = _watcher(tmp_path, registry, warmup=batcher.warmup_via_queue)
    try:
        w.poll_once()
        assert len(ck.cross_cache) == 1
        src = weakref.ref(registry.resolve("DCN").params["cross"][0]["w"])
        w.retire(1)
        assert _collected(src)  # the cache kept no source tensor alive
        assert len(ck.cross_cache) == 0  # and dropped the prepared layout
    finally:
        batcher.stop()
        ck.cross_cache.clear()


def test_cli_hot_swaps_a_base_path(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    base = tmp_path / "base"
    base.mkdir()
    _write_version(base, 1, seed=1)
    cfg = tmp_path / "tiny.toml"
    cfg.write_text(
        "[server]\nmodel_kind = \"dcn\"\nnum_fields = 6\nbuckets = [8, 32]\nmax_wait_us = 0\n"
        "file_system_poll_wait_seconds = 0.1\n")
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_tf_serving_tpu_torch.serving.server",
         "--config", str(cfg), "--host", "127.0.0.1", "--port", str(port), "--device", "cpu",
         "--model-base-path", str(base)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
            grpc.channel_ready_future(ch).result(timeout=60)
            stub = PredictionServiceStub(ch)
            arrays = _payload(5, 0)
            assert stub.Predict(_request(arrays), timeout=30).model_spec.version.value == 1
            sv2 = _write_version(base, 2, seed=2)
            deadline = time.time() + 60
            while True:
                resp = stub.Predict(_request(arrays), timeout=30)
                if resp.model_spec.version.value == 2:
                    break
                assert time.time() < deadline
                time.sleep(0.05)
            np.testing.assert_allclose(codec.to_ndarray(resp.outputs["prediction_node"]),
                                       _scores(sv2, arrays), rtol=1e-5, atol=1e-6)
        proc.terminate()
        out, _ = proc.communicate(timeout=30)
        assert proc.returncode == 0, out
        assert "loaded DCN v2 from" in out and "shutdown complete" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
