"""Multi-model serving (--model-config-file) and HandleReloadConfigRequest:
the port's server against the JAX package's on the same model config file
and the same checkpoint directories (written by the JAX save_servable and
converted in place by tools/jax_checkpoint_to_torch.py). Both servers get
the same sequence of gRPC calls; after each step the registries, the
labels, every status code and the scores (1e-5) must agree."""

import dataclasses
import importlib.util
import pathlib
import threading

import grpc
import jax
import numpy as np
import pytest

from distributed_tf_serving_tpu.models import ModelConfig as JaxConfig
from distributed_tf_serving_tpu.models import Servable as JaxServable
from distributed_tf_serving_tpu.models import build_model as jax_build
from distributed_tf_serving_tpu.models import ctr_signatures as jax_signatures
from distributed_tf_serving_tpu.serving import server as jax_server
from distributed_tf_serving_tpu.train import checkpoint as jax_ckpt
from distributed_tf_serving_tpu.utils.config import ServerConfig as JaxServerConfig
from distributed_tf_serving_tpu_torch import codec
from distributed_tf_serving_tpu_torch.models import ServableRegistry
from distributed_tf_serving_tpu_torch.proto import (
    HealthCheckRequest,
    HealthStub,
    ModelServiceStub,
    PredictionServiceStub,
)
from distributed_tf_serving_tpu_torch.proto import serving_apis_pb2 as apis
from distributed_tf_serving_tpu_torch.serving import server as torch_server
from distributed_tf_serving_tpu_torch.serving.batcher import DynamicBatcher
from distributed_tf_serving_tpu_torch.serving.service import PredictionServiceImpl, ServiceError
from distributed_tf_serving_tpu_torch.utils.config import ServerConfig

REPO = pathlib.Path(__file__).resolve().parents[1]
SMALL = dict(vocab_size=1 << 10, embed_dim=4, mlp_dims=(8,), num_cross_layers=1,
             compute_dtype="float32")
TOL = 1e-5


def _converter():
    spec = importlib.util.spec_from_file_location(
        "jax_checkpoint_to_torch", REPO / "tools" / "jax_checkpoint_to_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _write(base, name, kind, fields, version=1, seed=0):
    """A JAX checkpoint at base/version, converted in place for the port."""
    cfg = JaxConfig(name=name, num_fields=fields, **SMALL)
    model = jax_build(kind, cfg)
    sv = JaxServable(name=name, version=version, model=model,
                     params=model.init(jax.random.PRNGKey(seed)),
                     signatures=jax_signatures(fields))
    jax_ckpt.save_servable(pathlib.Path(base) / str(version), sv, kind=kind)
    _converter().convert(pathlib.Path(base) / str(version))


def _entry(name, base, platform="", labels=None):
    mc = apis.ModelConfig(name=name, base_path=str(base), model_platform=platform)
    for label, v in (labels or {}).items():
        mc.version_labels[label] = v
    return mc


def _text(entries) -> str:
    msc = apis.ModelServerConfig()
    msc.model_config_list.config.extend(entries)
    from google.protobuf import text_format

    return text_format.MessageToString(msc)


def _reload(entries):
    req = apis.ReloadConfigRequest()
    req.config.model_config_list.config.extend(entries)
    return req


def _payload(n, fields, seed):
    rng = np.random.RandomState(seed)
    return {"feat_ids": rng.randint(0, 1 << 40, size=(n, fields)).astype(np.int64),
            "feat_wts": rng.rand(n, fields).astype(np.float32)}


def _predict_req(arrays, name, version=None, label=None):
    req = apis.PredictRequest()
    req.model_spec.name = name
    if version is not None:
        req.model_spec.version.value = version
    if label is not None:
        req.model_spec.version_label = label
    for k, v in arrays.items():
        codec.from_ndarray(v, out=req.inputs[k])
    return req


class Side:
    """One server (JAX or port) behind a real gRPC socket."""

    def __init__(self, which, cfg_kwargs, **build_kw):
        self.which = which
        if which == "jax":
            cfg = dataclasses.replace(JaxServerConfig(), **cfg_kwargs)
            self.registry, self.batcher, self.impl, _, _, self.watcher = jax_server.build_stack(
                cfg, **build_kw)
            self.server, port = jax_server.create_server(self.impl, "127.0.0.1:0")
        else:
            cfg = dataclasses.replace(ServerConfig(), **cfg_kwargs)
            self.impl, self.batcher, _ = torch_server.build_stack(cfg, None, device="cpu",
                                                                  **build_kw)
            self.registry = self.impl.registry
            self.watcher = self.impl.model_lifecycle or self.impl.version_watcher
            self.server, port = torch_server.create_server(self.impl, "127.0.0.1:0")
        self.server.start()
        self.channel = grpc.insecure_channel(f"127.0.0.1:{port}")
        self.predict_stub = PredictionServiceStub(self.channel)
        self.model_stub = ModelServiceStub(self.channel)

    def call(self, fn, req):
        try:
            return "OK", fn(req, timeout=120)
        except grpc.RpcError as e:
            return e.code().name, None

    def predict(self, req):
        code, resp = self.call(self.predict_stub.Predict, req)
        if resp is None:
            return code, None, None
        return code, resp.model_spec.version.value, codec.to_ndarray(
            resp.outputs["prediction_node"])

    def reload(self, entries):
        return self.call(self.model_stub.HandleReloadConfigRequest, _reload(entries))[0]

    def status(self, name):
        code, resp = self.call(self.model_stub.GetModelStatus,
                               apis.GetModelStatusRequest(model_spec=apis.ModelSpec(name=name)))
        return code, [(s.version, s.state) for s in resp.model_version_status] if resp else None

    def state(self):
        served = self.registry.models()
        return served, {name: self.registry.labels(name) for name in served}

    def poll(self):
        for w in (self.watcher.watchers if hasattr(self.watcher, "watchers")
                  else [self.watcher]):
            w.poll_once()

    def close(self):
        self.channel.close()
        self.server.stop(0)
        self.watcher.stop()
        self.batcher.stop()


@pytest.fixture
def bases(tmp_path):
    _write(tmp_path / "ctr", "CTR", "dcn_v2", 6, seed=0)
    _write(tmp_path / "ranker", "RANKER", "deepfm", 4, seed=7)
    _write(tmp_path / "new", "NEW", "dcn_v2", 6, seed=3)
    _write(tmp_path / "moved", "CTR", "dcn_v2", 6, seed=99)
    return tmp_path


@pytest.fixture
def pair(bases):
    cfg_file = bases / "models.pbtxt"
    cfg_file.write_text(_text([
        _entry("CTR", bases / "ctr", "dcn_v2", {"stable": 1}),
        _entry("RANKER", bases / "ranker", "deepfm"),
    ]))
    kw = dict(model_config_file=str(cfg_file), buckets=(8, 32), warmup=False,
              file_system_poll_wait_seconds=3600.0)
    sides = [Side("jax", kw), Side("torch", kw)]
    try:
        yield sides, bases
    finally:
        for s in sides:
            s.close()


def _same(sides, what, fn):
    """fn(side) on both sides: equal, or (for scores) within TOL."""
    jax_out, torch_out = fn(sides[0]), fn(sides[1])
    if isinstance(jax_out, tuple) and len(jax_out) == 3 and jax_out[2] is not None:
        assert jax_out[:2] == torch_out[:2], (what, jax_out[:2], torch_out[:2])
        assert torch_out[2] is not None and torch_out[2].shape == jax_out[2].shape, what
        assert np.max(np.abs(torch_out[2] - jax_out[2])) <= TOL, what
    else:
        assert jax_out == torch_out, (what, jax_out, torch_out)
    return torch_out


def test_multi_model_server_matches_jax_through_every_reload(pair):
    sides, bases = pair
    ctr, ranker = _payload(5, 6, 1), _payload(7, 4, 2)
    served = _same(sides, "startup", Side.state)
    assert served == ({"CTR": [1], "RANKER": [1]}, {"CTR": {"stable": 1}, "RANKER": {}})
    # Predicts to each model by name, version and label.
    for what, req in [("CTR", _predict_req(ctr, "CTR")),
                      ("CTR v1", _predict_req(ctr, "CTR", version=1)),
                      ("CTR stable", _predict_req(ctr, "CTR", label="stable")),
                      ("RANKER", _predict_req(ranker, "RANKER"))]:
        code, version, _ = _same(sides, what, lambda s, r=req: s.predict(r))
        assert (code, version) == ("OK", 1)
    # Errors: wrong arity, unknown label and model.
    for what, req, want in [
            ("wrong arity", _predict_req(ctr, "RANKER"), "INVALID_ARGUMENT"),
            ("unknown label", _predict_req(ctr, "CTR", label="canary"), "NOT_FOUND"),
            ("unknown model", _predict_req(ctr, "NOPE"), "NOT_FOUND")]:
        assert _same(sides, what, lambda s, r=req: s.predict(r))[0] == want
    assert _same(sides, "status", lambda s: s.status("CTR")) == ("OK", [(1, 30)])
    assert _same(sides, "status", lambda s: s.status("NOPE"))[0] == "NOT_FOUND"

    # Add NEW and relabel CTR (stable dropped, prod added) in one reload.
    entries = [_entry("CTR", bases / "ctr", "dcn_v2", {"prod": 1}),
               _entry("RANKER", bases / "ranker", "deepfm"),
               _entry("NEW", bases / "new", "dcn_v2")]
    assert _same(sides, "add", lambda s: s.reload(entries)) == "OK"
    assert _same(sides, "after add", Side.state) == (
        {"CTR": [1], "NEW": [1], "RANKER": [1]}, {"CTR": {"prod": 1}, "NEW": {}, "RANKER": {}})
    assert _same(sides, "NEW", lambda s: s.predict(_predict_req(ctr, "NEW")))[0] == "OK"
    assert _same(sides, "stable gone",
                 lambda s: s.predict(_predict_req(ctr, "CTR", label="stable")))[0] == "NOT_FOUND"

    # CTR v2 lands; a label on an unloaded version fails and applies nothing.
    _write(bases / "ctr", "CTR", "dcn_v2", 6, version=2, seed=4)
    for s in sides:
        s.poll()
    bad = [_entry("CTR", bases / "ctr", "dcn_v2", {"prod": 1, "stable": 9})] + entries[1:]
    assert _same(sides, "label on v9", lambda s: s.reload(bad)) == "FAILED_PRECONDITION"
    assert _same(sides, "unchanged", Side.state)[1]["CTR"] == {"prod": 1}
    # Relabel: stable -> 2 and drop RANKER.
    entries = [_entry("CTR", bases / "ctr", "dcn_v2", {"prod": 1, "stable": 2}),
               _entry("NEW", bases / "new", "dcn_v2")]
    assert _same(sides, "relabel and drop", lambda s: s.reload(entries)) == "OK"
    assert _same(sides, "after relabel", Side.state) == (
        {"CTR": [1, 2], "NEW": [1]}, {"CTR": {"prod": 1, "stable": 2}, "NEW": {}})
    code, version, _ = _same(sides, "stable -> v2",
                             lambda s: s.predict(_predict_req(ctr, "CTR", label="stable")))
    assert (code, version) == ("OK", 2)
    assert _same(sides, "RANKER dropped",
                 lambda s: s.predict(_predict_req(ranker, "RANKER")))[0] == "NOT_FOUND"
    assert _same(sides, "RANKER status", lambda s: s.status("RANKER"))[0] == "NOT_FOUND"

    # Move CTR's base path: its watcher restarts on the new source.
    before = _same(sides, "before move", lambda s: s.predict(_predict_req(ctr, "CTR", version=1)))
    entries = [_entry("CTR", bases / "moved", "dcn_v2"), _entry("NEW", bases / "new", "dcn_v2")]
    assert _same(sides, "move", lambda s: s.reload(entries)) == "OK"
    assert _same(sides, "after move", Side.state) == ({"CTR": [1], "NEW": [1]},
                                                      {"CTR": {}, "NEW": {}})
    after = _same(sides, "after move", lambda s: s.predict(_predict_req(ctr, "CTR", version=1)))
    assert not np.allclose(before[2], after[2])  # the params of the new path

    # Refused reloads apply nothing.
    custom = apis.ReloadConfigRequest()
    custom.config.custom_model_config.Pack(apis.ModelSpec(name="x"))
    for what, req in [
            ("empty", apis.ReloadConfigRequest(config=apis.ModelServerConfig(
                model_config_list=apis.ModelConfigList()))),
            ("custom_model_config", custom),
            ("duplicate", _reload([_entry("CTR", bases / "moved"), _entry("CTR", bases / "new")])),
            ("no base_path", _reload([_entry("CTR", "")]))]:
        got = _same(sides, what, lambda s, r=req: s.call(s.model_stub.HandleReloadConfigRequest,
                                                        r)[0])
        assert got == "INVALID_ARGUMENT", what
    assert _same(sides, "after refusals", Side.state)[0] == {"CTR": [1], "NEW": [1]}


@pytest.mark.parametrize("which", ["jax", "torch"])
def test_concurrent_reloads_serialize(bases, which):
    cfg_file = bases / "one.pbtxt"
    cfg_file.write_text(_text([_entry("CTR", bases / "ctr")]))
    side = Side(which, dict(model_config_file=str(cfg_file), buckets=(8,), warmup=False,
                            file_system_poll_wait_seconds=3600.0))
    try:
        paths = {"CTR": bases / "ctr", "NEW": bases / "new"}

        def reload_with(names):
            side.impl.handle_reload_config(
                _reload([_entry(n, paths[n], labels={"live": 1}) for n in names]))

        threads = [threading.Thread(target=reload_with, args=(names,))
                   for names in (("CTR",), ("CTR", "NEW"), ("NEW",)) * 4]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        served = set(side.registry.models())
        assert served in ({"CTR"}, {"CTR", "NEW"}, {"NEW"}), served
        for name in served:
            assert side.registry.labels(name) == {"live": 1}
    finally:
        side.close()


def test_single_model_reload_is_labels_only_as_in_jax(bases):
    _write(bases / "ctr", "CTR", "dcn_v2", 6, version=2, seed=4)
    kw = dict(model_name="CTR", buckets=(8,), warmup=False, file_system_poll_wait_seconds=3600.0)
    sides = [Side("jax", kw, model_base_path=str(bases / "ctr")),
             Side("torch", kw, model_base_path=str(bases / "ctr"))]
    try:
        assert _same(sides, "start", Side.state) == ({"CTR": [1, 2]}, {"CTR": {}})
        cases = [
            ("flip", [_entry("CTR", "", "", {"stable": 1, "canary": 2})], "OK"),
            ("restated source", [_entry("CTR", bases / "ctr", "dcn_v2", {"stable": 2})], "OK"),
            ("moved base_path", [_entry("CTR", bases / "new", "", {"stable": 1})],
             "FAILED_PRECONDITION"),
            ("moved platform", [_entry("CTR", "", "deepfm", {"stable": 1})],
             "FAILED_PRECONDITION"),
            ("unserved model", [_entry("NEW", "", "", {"stable": 1})], "NOT_FOUND"),
            ("unloaded version", [_entry("CTR", "", "", {"stable": 7})], "FAILED_PRECONDITION"),
            ("empty label", [_entry("CTR", "", "", {"": 1})], "INVALID_ARGUMENT"),
        ]
        for what, entries, want in cases:
            assert _same(sides, what, lambda s, e=entries: s.reload(e)) == want, what
        assert _same(sides, "end", Side.state) == ({"CTR": [1, 2]}, {"CTR": {"stable": 2}})
        code, version, _ = _same(sides, "stable", lambda s: s.predict(
            _predict_req(_payload(3, 6, 5), "CTR", label="stable")))
        assert (code, version) == ("OK", 2)
    finally:
        for s in sides:
            s.close()


def _build_errors(build, cfg_cls, bases, **kw):
    """The ValueError text of each startup refusal, from `build`."""
    dup = bases / "dup.pbtxt"
    dup.write_text(_text([_entry("A", bases / "ctr"), _entry("A", bases / "ctr")]))
    nobase = bases / "nobase.pbtxt"
    nobase.write_text('model_config_list { config { name: "X" } }\n')
    empty = bases / "empty.pbtxt"
    empty.write_text("model_config_list { }\n")
    ok = bases / "ok.pbtxt"
    ok.write_text(_text([_entry("CTR", bases / "ctr")]))
    base = dict(buckets=(8,), warmup=False)
    cases = {
        "duplicate": (dict(model_config_file=str(dup)), {}),
        "no base_path": (dict(model_config_file=str(nobase)), {}),
        "empty list": (dict(model_config_file=str(empty)), {}),
        "with checkpoint": (dict(model_config_file=str(ok)), {"checkpoint": "/nope"}),
        "with base path": (dict(model_config_file=str(ok)), {"model_base_path": str(bases)}),
        "with labels": (dict(model_config_file=str(ok), version_labels=(("stable", 1),)), {}),
    }
    out = {}
    for what, (fields, extra) in cases.items():
        with pytest.raises(ValueError) as e:
            build(dataclasses.replace(cfg_cls(), **base, **fields), **extra)
        out[what] = str(e.value)
    return out


def test_startup_refusals_match_jax(bases):
    jax_errs = _build_errors(lambda cfg, **kw: jax_server.build_stack(cfg, **kw),
                             JaxServerConfig, bases)
    torch_errs = _build_errors(
        lambda cfg, **kw: torch_server.build_stack(cfg, None, device="cpu", **kw),
        ServerConfig, bases)
    assert torch_errs == jax_errs
    assert "mutually exclusive" in torch_errs["with checkpoint"]
    assert "version_labels" in torch_errs["with labels"]


def test_configured_model_without_a_version_is_start_and_not_serving(tmp_path):
    """A listed model whose base path holds no version yet: START in
    GetModelStatus and NOT_SERVING in health, not NOT_FOUND; it serves once
    a version lands."""
    _write(tmp_path / "a", "A", "dcn_v2", 6)
    (tmp_path / "b").mkdir()
    cfg_file = tmp_path / "models.pbtxt"
    cfg_file.write_text(_text([_entry("A", tmp_path / "a"), _entry("B", tmp_path / "b")]))
    side = Side("torch", dict(model_config_file=str(cfg_file), buckets=(8,), warmup=False,
                              file_system_poll_wait_seconds=3600.0))
    try:
        assert side.status("B") == ("OK", [(0, apis.ModelVersionStatus.START)])
        health = HealthStub(side.channel)
        assert health.Check(HealthCheckRequest(service="B")).status == 2  # NOT_SERVING
        assert health.Check(HealthCheckRequest(service="A")).status == 1  # SERVING
        _write(tmp_path / "b", "B", "dcn", 6, seed=5)
        side.poll()
        assert side.predict(_predict_req(_payload(2, 6, 0), "B"))[:2] == ("OK", 1)
    finally:
        side.close()


def test_models_of_other_widths_and_families_interleave_in_one_batcher():
    """Concurrent requests to models of different families, field counts
    and compute dtypes through ONE batcher: every result is the model's own
    forward of that request alone (no group, packed layout or buffer is
    shared between models)."""
    from distributed_tf_serving_tpu_torch.serving.server import load_demo_servable
    from distributed_tf_serving_tpu_torch.models import ModelConfig

    registry = ServableRegistry()
    svs = [load_demo_servable(registry, kind=kind, name=name, seed=i, device="cpu",
                              config=ModelConfig(name=name, num_fields=f, **{
                                  **SMALL, "compute_dtype": cd}))
           for i, (kind, name, f, cd) in enumerate([
               ("dcn_v2", "A", 6, "float32"), ("deepfm", "B", 4, "float32"),
               ("dcn_v2", "C", 5, "bfloat16")])]
    batcher = DynamicBatcher(buckets=(8, 32), max_wait_us=2000, device="cpu").start()
    try:
        # Runs of four requests per model, the models taking turns: the
        # coalescer joins a run, never two models.
        payloads = [(sv, _payload(3 + i % 5, sv.model.config.num_fields, 10 * r + i))
                    for r in range(6) for sv in svs for i in range(4)]
        futs = [batcher.submit(sv, p) for sv, p in payloads]
        alone = DynamicBatcher(buckets=(8, 32), max_wait_us=0, device="cpu")
        for (sv, p), fut in zip(payloads, futs):
            got = fut.result(60)["prediction_node"]
            want = alone._execute(sv, {k: np.concatenate(
                [v, np.zeros((8 - len(v),) + v.shape[1:], v.dtype)]) for k, v in p.items()},
                None)["prediction_node"][:len(got)]
            # A coalesced group pads to a larger bucket: an f32 sum may
            # round differently in the last place.
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        assert batcher.stats.batches < len(payloads)  # same-model requests did coalesce
    finally:
        batcher.stop()


def test_dropped_model_releases_its_batcher_entry(tmp_path):
    """A model the reload drops dies with its batcher entry, as a retired
    version does."""
    import gc
    import weakref

    _write(tmp_path / "a", "A", "dcn_v2", 6)
    _write(tmp_path / "b", "B", "dcn_v2", 6, seed=1)
    cfg_file = tmp_path / "models.pbtxt"
    cfg_file.write_text(_text([_entry("A", tmp_path / "a"), _entry("B", tmp_path / "b")]))
    impl, batcher, _ = torch_server.build_stack(
        dataclasses.replace(ServerConfig(), model_config_file=str(cfg_file), buckets=(8,),
                            file_system_poll_wait_seconds=3600.0), None, device="cpu")
    try:
        assert impl.registry.models() == {"A": [1], "B": [1]}
        ref = weakref.ref(impl.registry.resolve("B"))
        impl.predict(_predict_req(_payload(3, 6, 0), "B"))
        assert len(batcher._entries) == 2
        impl.handle_reload_config(_reload([_entry("A", tmp_path / "a")]))
        with pytest.raises(ServiceError) as e:
            impl.predict(_predict_req(_payload(3, 6, 0), "B"))
        assert e.value.code == "NOT_FOUND"
        for _ in range(200):
            gc.collect()
            if ref() is None:
                break
            threading.Event().wait(0.01)
        assert ref() is None and len(batcher._entries) == 1
        assert impl.model_lifecycle.configured_models() == {"A"}
    finally:
        impl.model_lifecycle.stop()
        batcher.stop()


def test_reload_is_unimplemented_no_more_without_a_lifecycle():
    """A demo server (no watcher) answers a reload of an unserved model
    NOT_FOUND and relabels a served one."""
    from distributed_tf_serving_tpu_torch.models import ModelConfig

    registry = ServableRegistry()
    torch_server.load_demo_servable(registry, name="CTR", device="cpu",
                                    config=ModelConfig(name="CTR", num_fields=6, **SMALL))
    impl = PredictionServiceImpl(registry, DynamicBatcher(buckets=(8,), device="cpu"))
    with pytest.raises(ServiceError) as e:
        impl.handle_reload_config(_reload([_entry("X", "", "", {"a": 1})]))
    assert e.value.code == "NOT_FOUND"
    impl.handle_reload_config(_reload([_entry("CTR", "", "", {"a": 1})]))
    assert registry.labels("CTR") == {"a": 1}


def test_rest_gateway_serves_every_model_of_the_config_file_as_in_jax(pair):
    """The REST gateway over a --model-config-file server (both packages):
    Predict by label and by name, Classify, status and an unknown model
    answer with the same statuses and JSON, scores within TOL."""
    import asyncio
    import json

    import aiohttp

    from distributed_tf_serving_tpu.serving.rest import start_rest_gateway as jax_start
    from distributed_tf_serving_tpu_torch.serving.rest import start_rest_gateway

    sides, _ = pair
    ctr, ranker = _payload(5, 6, 1), _payload(3, 4, 2)

    def rows(arrays):
        return {"instances": [{k: v[i].tolist() for k, v in arrays.items()}
                              for i in range(len(arrays["feat_ids"]))]}

    requests = [
        ("POST", "/v1/models/CTR/labels/stable:predict", rows(ctr)),
        ("POST", "/v1/models/RANKER:predict", {"inputs": {k: v.tolist()
                                                          for k, v in ranker.items()}}),
        ("POST", "/v1/models/RANKER:classify", {"examples": rows(ranker)["instances"]}),
        ("GET", "/v1/models/CTR", None),
        ("GET", "/v1/models/RANKER/metadata", None),
        ("POST", "/v1/models/NEW:predict", rows(ctr)),
    ]

    async def drive(start, impl):
        runner, port = await start(impl, port=0)
        out = []
        try:
            async with aiohttp.ClientSession(f"http://127.0.0.1:{port}") as s:
                for method, path, body in requests:
                    async with s.request(method, path, json=body) as r:
                        out.append((r.status, json.loads(await r.text())))
        finally:
            await runner.cleanup()
        return out

    want = asyncio.run(drive(jax_start, sides[0].impl))
    got = asyncio.run(drive(start_rest_gateway, sides[1].impl))
    assert [s for s, _ in got] == [s for s, _ in want] == [200, 200, 200, 200, 200, 404]
    for (_, w), (_, g), (_, path, _) in zip(want, got, requests):
        if "predictions" in w:
            np.testing.assert_allclose([p["prediction_node"] for p in g["predictions"]],
                                       [p["prediction_node"] for p in w["predictions"]],
                                       atol=TOL)
        elif "outputs" in w:
            np.testing.assert_allclose(g["outputs"]["prediction_node"],
                                       w["outputs"]["prediction_node"], atol=TOL)
        elif "results" in w:
            np.testing.assert_allclose([[c[1] for c in r] for r in g["results"]],
                                       [[c[1] for c in r] for r in w["results"]], atol=TOL)
        else:
            assert g == w, path
