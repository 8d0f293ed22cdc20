"""The port's import boundary and device rule.

- distributed_tf_serving_tpu_torch (and chip_smoke.py) never import jax or
  any module of the JAX package. Mind the prefix: the port's own name
  STARTS WITH the JAX package's name, so a module counts as the JAX
  package only when it is `distributed_tf_serving_tpu` exactly or starts
  with `distributed_tf_serving_tpu.`.
- Entry points default to the card and raise without one; they never drop
  to the CPU unless asked.
"""

import ast
import filecmp
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "distributed_tf_serving_tpu_torch"
JAX_PKG = "distributed_tf_serving_tpu"


def _is_jax_side(module: str) -> bool:
    return (
        module == "jax" or module.startswith("jax.") or module == "jaxlib"
        or module.startswith("jaxlib.")
        or module == JAX_PKG or module.startswith(JAX_PKG + ".")
    )


def test_prefix_rule():
    assert _is_jax_side("distributed_tf_serving_tpu.models")
    assert _is_jax_side("distributed_tf_serving_tpu")
    assert not _is_jax_side("distributed_tf_serving_tpu_torch.models")
    assert not _is_jax_side("jaxtyping")


_SCRIPT = r"""
import json, sys
import numpy as np
import torch
from distributed_tf_serving_tpu_torch.models import ModelConfig, ServableRegistry
from distributed_tf_serving_tpu_torch.serving.server import load_demo_servable
from distributed_tf_serving_tpu_torch.serving.batcher import DynamicBatcher
import distributed_tf_serving_tpu_torch.serving.service  # noqa: F401
import distributed_tf_serving_tpu_torch.ops.cross_kernel  # noqa: F401
import distributed_tf_serving_tpu_torch.convert  # noqa: F401
import distributed_tf_serving_tpu_torch.ops.autotune  # noqa: F401
import distributed_tf_serving_tpu_torch.ops.quantize  # noqa: F401
import distributed_tf_serving_tpu_torch.train.data  # noqa: F401
import distributed_tf_serving_tpu_torch.native  # noqa: F401
import distributed_tf_serving_tpu_torch.serving.request_log  # noqa: F401
reg = ServableRegistry()
cfg = ModelConfig(num_fields=6, vocab_size=1024, embed_dim=4, mlp_dims=(8,),
                  num_cross_layers=2, use_pallas_cross=True)
sv = load_demo_servable(reg, config=cfg, device="cpu")
b = DynamicBatcher(buckets=(8,), max_wait_us=0, device="cpu").start()
rng = np.random.RandomState(0)
out = b.submit(sv, {"feat_ids": rng.randint(0, 1 << 40, size=(5, 6)),
                    "feat_wts": rng.rand(5, 6).astype(np.float32)}).result(60)
b.stop()
print(json.dumps({"n": int(out["prediction_node"].shape[0]),
                  "modules": sorted(sys.modules)}))
"""


def test_port_scores_without_importing_jax_subprocess():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run(
        [sys.executable, "-c", _SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=180,
    )
    assert res.returncode == 0, res.stderr
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["n"] == 5
    leaked = [m for m in line["modules"] if _is_jax_side(m)]
    assert leaked == []
    assert "distributed_tf_serving_tpu_torch.serving.batcher" in line["modules"]


_FAMILIES_SCRIPT = r"""
import json, sys
import numpy as np
from distributed_tf_serving_tpu_torch.models import ModelConfig, ServableRegistry, model_kinds
from distributed_tf_serving_tpu_torch.serving.server import load_demo_servable
from distributed_tf_serving_tpu_torch.serving.batcher import DynamicBatcher
cfg = ModelConfig(num_fields=6, vocab_size=1024, embed_dim=4, mlp_dims=(8,), num_user_fields=2,
                  bottom_mlp_dims=(4,))
b = DynamicBatcher(buckets=(8,), max_wait_us=0, device="cpu").start()
rng = np.random.RandomState(0)
n = {}
for kind in ("wide_deep", "deepfm", "generic", "two_tower", "dlrm"):
    sv = load_demo_servable(ServableRegistry(), kind=kind, config=cfg, device="cpu")
    out = b.submit(sv, {"feat_ids": rng.randint(0, 1 << 40, size=(5, 6)),
                        "feat_wts": rng.rand(5, 6).astype(np.float32)}).result(60)
    n[kind] = int(out["prediction_node"].shape[0])
b.stop()
print(json.dumps({"n": n, "kinds": model_kinds(), "modules": sorted(sys.modules)}))
"""


def test_every_family_scores_without_importing_jax_subprocess():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run(
        [sys.executable, "-c", _FAMILIES_SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=180,
    )
    assert res.returncode == 0, res.stderr
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert set(line["n"].values()) == {5}
    assert line["kinds"] == ["dcn", "dcn_v2", "deepfm", "dlrm", "generic", "two_tower",
                             "wide_deep"]
    assert [m for m in line["modules"] if _is_jax_side(m)] == []
    for kind in ("wide_deep", "deepfm", "generic", "two_tower", "dlrm"):
        assert f"distributed_tf_serving_tpu_torch.models.{kind}" in line["modules"]


_TELEMETRY_SCRIPT = r"""
import asyncio, json, sys
import aiohttp
import numpy as np
from distributed_tf_serving_tpu_torch.models import ModelConfig, ServableRegistry
from distributed_tf_serving_tpu_torch.serving.batcher import DynamicBatcher
from distributed_tf_serving_tpu_torch.serving.rest import start_rest_gateway
from distributed_tf_serving_tpu_torch.serving.server import load_demo_servable
from distributed_tf_serving_tpu_torch.serving.service import PredictionServiceImpl
from distributed_tf_serving_tpu_torch.utils import ServerMetrics, tracing
reg = ServableRegistry()
cfg = ModelConfig(num_fields=3, vocab_size=64, embed_dim=2, mlp_dims=(4,), num_cross_layers=1)
load_demo_servable(reg, config=cfg, device="cpu")
b = DynamicBatcher(buckets=(8,), max_wait_us=0, device="cpu").start()
impl = PredictionServiceImpl(reg, b)
tracing.enable()
metrics = ServerMetrics()

async def go():
    runner, port = await start_rest_gateway(impl, port=0, metrics=metrics)
    try:
        async with aiohttp.ClientSession(f"http://127.0.0.1:{port}") as s:
            body = {"inputs": {"feat_ids": [[1, 2, 3]], "feat_wts": [[0.5, 0.5, 0.5]]}}
            async with s.post("/v1/models/DCN:predict", json=body) as r:
                assert r.status == 200, await r.text()
            async with s.get("/tracez") as r:
                return len((await r.json())["traces"])
    finally:
        await runner.cleanup()

traces = asyncio.run(go())
b.stop()
print(json.dumps({"traces": traces, "ok": metrics.snapshot()["rpcs"]["REST.Predict"]["ok"],
                  "modules": sorted(sys.modules)}))
"""


def test_rest_gateway_and_telemetry_import_no_jax_subprocess():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run(
        [sys.executable, "-c", _TELEMETRY_SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=180,
    )
    assert res.returncode == 0, res.stderr
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["traces"] == 1 and line["ok"] == 1
    assert [m for m in line["modules"] if _is_jax_side(m)] == []
    for mod in ("serving.rest", "utils.metrics", "utils.tracing"):
        assert f"distributed_tf_serving_tpu_torch.{mod}" in line["modules"]


def _imports(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            found.append(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                found.append(str(node.args[0].value))
    return found


def test_static_no_jax_imports_in_port_or_chip_smoke():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    for mod in ("serving/rest.py", "utils/metrics.py", "utils/tracing.py",
                "serving/overload.py", "serving/integrity.py", "serving/utilization.py",
                "serving/quality.py", "serving/recovery.py", "interop/savedmodel.py",
                "interop/graph_exec.py"):
        assert PORT / mod in files, mod
    bad = {
        str(f.relative_to(REPO)): [m for m in _imports(f) if _is_jax_side(m)]
        for f in files
    }
    assert {k: v for k, v in bad.items() if v} == {}


# The card's machine has none of these; TensorFlow runs only in the
# SavedModel importer's extraction subprocess and in the export's own
# process (interop/export.py, a CPU-side tool).
_NOT_ON_THE_CARD = ("safetensors", "orbax", "tensorflow")
_TENSORFLOW_PROCESS = ("distributed_tf_serving_tpu_torch/interop/export.py",)

_LIFECYCLE_SCRIPT = r"""
import json, sys, tempfile
from distributed_tf_serving_tpu_torch.models import ModelConfig, ServableRegistry
from distributed_tf_serving_tpu_torch.serving.server import load_demo_servable
from distributed_tf_serving_tpu_torch.serving.version_watcher import VersionWatcher
import distributed_tf_serving_tpu_torch.serving.warmup  # noqa: F401
import distributed_tf_serving_tpu_torch.serving.example_codec  # noqa: F401
from distributed_tf_serving_tpu_torch.train.checkpoint import save_servable
cfg = ModelConfig(num_fields=3, vocab_size=64, embed_dim=2, mlp_dims=(4,), num_cross_layers=1)
sv = load_demo_servable(ServableRegistry(), config=cfg, device="cpu")
base = tempfile.mkdtemp()
save_servable(base + "/1", sv, "dcn_v2")
reg = ServableRegistry()
VersionWatcher(base, reg, device="cpu").poll_once()
print(json.dumps({"loaded": reg.models(), "modules": sorted(sys.modules)}))
"""


_MULTI_MODEL_SCRIPT = r"""
import json, sys, tempfile, pathlib
from distributed_tf_serving_tpu_torch.models import ModelConfig, ServableRegistry
from distributed_tf_serving_tpu_torch.proto import serving_apis_pb2 as apis
from distributed_tf_serving_tpu_torch.serving.request_log import RequestLogger
from distributed_tf_serving_tpu_torch.serving.server import (
    GracefulShutdown, build_stack, load_demo_servable)
from distributed_tf_serving_tpu_torch.train.checkpoint import save_servable
from distributed_tf_serving_tpu_torch.utils.config import ServerConfig
base = pathlib.Path(tempfile.mkdtemp())
for name, kind in (("A", "dcn_v2"), ("B", "deepfm")):
    cfg = ModelConfig(name=name, num_fields=3, vocab_size=64, embed_dim=2, mlp_dims=(4,),
                      num_cross_layers=1)
    save_servable(base / name / "1", load_demo_servable(ServableRegistry(), kind=kind, name=name,
                                                        config=cfg, device="cpu"), kind)
(base / "m.config").write_text(
    "model_config_list { " + " ".join(
        f'config {{ name: "{n}" base_path: "{base / n}" }}' for n in "AB") + " }")
impl, batcher, _ = build_stack(ServerConfig(model_config_file=str(base / "m.config"),
                                            buckets=(8,), warmup=False), None, device="cpu")
req = apis.ReloadConfigRequest()
req.config.model_config_list.config.add(name="A", base_path=str(base / "A"))
impl.handle_reload_config(req)
logger = RequestLogger(base / "r.log", sampling_rate=1.0)
gs = GracefulShutdown(impl, batcher, grace_s=1.0, watcher=impl.model_lifecycle,
                      request_logger=logger)
gs.shutdown()
print(json.dumps({"loaded": impl.registry.models(), "drained": gs.drained,
                  "modules": sorted(sys.modules)}))
"""


_SAVEDMODEL_SCRIPT = r"""
import json, pathlib, sys, tempfile
import numpy as np
from distributed_tf_serving_tpu_torch.interop.graph_exec import graph_model
from distributed_tf_serving_tpu_torch.interop.savedmodel import _flatten_params, _jax_order
from distributed_tf_serving_tpu_torch.models import ModelConfig, build_model, ctr_signatures
from distributed_tf_serving_tpu_torch.proto import serving_apis_pb2 as apis
from distributed_tf_serving_tpu_torch.proto import tf_meta_graph_pb2 as mg_pb
from distributed_tf_serving_tpu_torch.proto import tf_saved_model_pb2 as sm
from distributed_tf_serving_tpu_torch.serving.server import build_stack
from distributed_tf_serving_tpu_torch.utils.config import ServerConfig
cfg = ModelConfig(num_fields=3, vocab_size=64, embed_dim=2, mlp_dims=(4,), num_cross_layers=1)
d = pathlib.Path(tempfile.mkdtemp()) / "export"
(d / "variables").mkdir(parents=True)
proto = sm.SavedModel(saved_model_schema_version=1)
mg = proto.meta_graphs.add()
mg.meta_info_def.tags.append("serve")
sd = mg.signature_def["serving_default"]
sd.method_name = "tensorflow/serving/predict"
for spec in ctr_signatures(3)["serving_default"].inputs:
    sd.inputs[spec.name].CopyFrom(spec.to_tensor_info())
sd.outputs["prediction_node"].name = "prediction_node:0"
sd.outputs["prediction_node"].dtype = 1
(d / "saved_model.pb").write_bytes(proto.SerializeToString())
model = build_model("dcn_v2", cfg)
flat = _flatten_params(_jax_order(model.init(0, "cpu")))
np.savez(d / "variables_extracted.npz", **{p: t.numpy() for p, t in flat.items()})
impl, batcher, servable = build_stack(
    ServerConfig(num_fields=3, buckets=(8,), warmup=False), cfg, device="cpu",
    savedmodel=str(d))
req = apis.PredictRequest()
req.model_spec.name = "DCN"
from distributed_tf_serving_tpu_torch import codec
req.inputs["feat_ids"].CopyFrom(codec.from_ndarray(np.arange(6, dtype=np.int64).reshape(2, 3)))
req.inputs["feat_wts"].CopyFrom(codec.from_ndarray(np.ones((2, 3), np.float32)))
n = int(codec.to_ndarray(impl.predict(req).outputs["prediction_node"]).shape[0])
batcher.stop()
meta = mg_pb.MetaGraphDef()
meta.signature_def["serving_default"].inputs["x"].name = "x:0"
meta.signature_def["serving_default"].outputs["y"].name = "x:0"
meta.graph_def.node.add(name="x", op="Placeholder")
graph_model(meta, {}, device="cpu")
print(json.dumps({"n": n, "modules": sorted(sys.modules)}))
"""


def test_savedmodel_intake_imports_no_jax_or_tensorflow_subprocess():
    """interop.savedmodel, interop.graph_exec and a --savedmodel stack
    answering a Predict import neither JAX nor TensorFlow (nor the other
    packages the card's machine lacks)."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run(
        [sys.executable, "-c", _SAVEDMODEL_SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=180,
    )
    assert res.returncode == 0, res.stderr
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["n"] == 2
    assert [m for m in line["modules"] if _is_jax_side(m) or _is_off_card(m)] == []
    assert "distributed_tf_serving_tpu_torch.interop.graph_exec" in line["modules"]


def test_multi_model_reload_and_drain_import_no_jax_subprocess():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run(
        [sys.executable, "-c", _MULTI_MODEL_SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=180,
    )
    assert res.returncode == 0, res.stderr
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["loaded"] == {"A": [1]} and line["drained"] is True
    assert [m for m in line["modules"] if _is_jax_side(m) or _is_off_card(m)] == []
    assert "distributed_tf_serving_tpu_torch.serving.request_log" in line["modules"]


def _is_off_card(module: str) -> bool:
    return any(module == m or module.startswith(m + ".") for m in _NOT_ON_THE_CARD)


def test_checkpoint_lifecycle_imports_no_jax_safetensors_or_orbax():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run(
        [sys.executable, "-c", _LIFECYCLE_SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=180,
    )
    assert res.returncode == 0, res.stderr
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["loaded"] == {"DCN": [1]}
    assert [m for m in line["modules"] if _is_jax_side(m) or _is_off_card(m)] == []
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    bad = {str(f.relative_to(REPO)): [m for m in _imports(f) if _is_off_card(m)] for f in files}
    allowed = {k: ["tensorflow"] for k in _TENSORFLOW_PROCESS}
    assert {k: v for k, v in bad.items() if v and v != allowed.get(k)} == {}


def test_grpc_and_protobuf_stay_in_the_transport_modules():
    # The transport modules: the bindings, the codec, the service and the
    # server; and the two modules that speak gRPC as a caller, the fan-out
    # client and the fleet router.
    allowed = {"proto", "codec.py", "serving/service.py", "serving/server.py",
               "client/client.py", "fleet/router.py"}
    for f in PORT.rglob("*.py"):
        rel = f.relative_to(PORT)
        if rel.parts[0] in allowed or rel.as_posix() in allowed:
            continue
        mods = _imports(f)
        assert not [m for m in mods if m == "grpc" or m.startswith("google.protobuf")], rel


_FLEET_TIER_SCRIPT = r"""
import asyncio, json, sys
import distributed_tf_serving_tpu_torch.client as client_pkg
import distributed_tf_serving_tpu_torch.client.bench  # noqa: F401
import distributed_tf_serving_tpu_torch.fleet.gossip  # noqa: F401
import distributed_tf_serving_tpu_torch.fleet.observability  # noqa: F401
import distributed_tf_serving_tpu_torch.fleet.replica  # noqa: F401
import distributed_tf_serving_tpu_torch.fleet.rollout  # noqa: F401
torch_after_client = "torch" in sys.modules
from distributed_tf_serving_tpu_torch.fleet.router import run_router
from distributed_tf_serving_tpu_torch.utils.config import load_config

async def main():
    ready = asyncio.get_running_loop().create_future()
    task = asyncio.ensure_future(run_router(load_config(sys.argv[1]),
                                            ready_cb=lambda port, r: ready.set_result(port)))
    port = await asyncio.wait_for(ready, 60)
    async with client_pkg.ShardedPredictClient([f"127.0.0.1:{port}"], "DCN",
                                               timeout_s=2.0) as c:
        try:
            await c.predict({"feat_ids": __import__("numpy").zeros((4, 3), "int64")})
            code = "OK"
        except client_pkg.PredictClientError as e:
            code = e.code.name
    task.cancel()
    return code

code = asyncio.run(main())
torch_after_router = "torch" in sys.modules
import torch
print(json.dumps({"code": code, "torch_after_client": torch_after_client,
                  "torch_after_router": torch_after_router,
                  "cuda_initialized": torch.cuda.is_initialized(),
                  "modules": sorted(sys.modules)}))
"""


def _router_toml(tmp_path) -> Path:
    cfg = tmp_path / "router.toml"
    cfg.write_text('[server]\nhost = "127.0.0.1"\nport = 0\n'
                   '[client]\nhosts = ["127.0.0.1:1"]\nhealth_scoreboard = true\n'
                   'timeout_s = 1.0\n'
                   '[fleet]\nenabled = true\nself_id = "router"\nrollout_writer = true\n')
    return cfg


def test_client_fleet_and_router_import_no_jax_and_build_no_cuda_context(tmp_path):
    """client/ and fleet/ import neither jax nor the JAX package, nor torch
    (the config module is torch-free); a router forwards (here to a dead
    backend: UNAVAILABLE) without creating a CUDA context, on a host whose
    card is hidden."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", _FLEET_TIER_SCRIPT, str(_router_toml(tmp_path))],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stderr
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["code"] == "UNAVAILABLE"
    assert line["torch_after_client"] is False
    assert line["torch_after_router"] is False
    assert line["cuda_initialized"] is False
    assert [m for m in line["modules"] if _is_jax_side(m)] == []
    assert "distributed_tf_serving_tpu_torch.ops.cross_kernel" not in line["modules"]


def test_the_router_flag_starts_without_a_card(tmp_path):
    """`serving.server --router` hands off before any stack is built: it
    binds and serves health with no card, and SIGTERM stops it cleanly,
    while the same CLI without --router refuses to start there."""
    import signal

    import grpc

    from distributed_tf_serving_tpu_torch.proto import health as health_proto

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_tf_serving_tpu_torch.serving.server", "--router",
         "--config", str(_router_toml(tmp_path)), "--port", str(port)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
            grpc.channel_ready_future(ch).result(timeout=60)
            st = health_proto.HealthStub(ch).Check(health_proto.HealthCheckRequest(""),
                                                   timeout=5).status
        assert st in (health_proto.SERVING, health_proto.NOT_SERVING)
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    assert "fleet router up" in err and "CUDA is not available" not in err


def test_proto_bindings_are_byte_identical_copies():
    for src in sorted((REPO / JAX_PKG / "proto").glob("*_pb2.py")):
        assert filecmp.cmp(src, PORT / "proto" / src.name, shallow=False), src.name


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    from distributed_tf_serving_tpu_torch.models import ModelConfig, ServableRegistry, resolve_device
    from distributed_tf_serving_tpu_torch.serving.batcher import DynamicBatcher
    from distributed_tf_serving_tpu_torch.serving.server import build_stack, load_demo_servable
    from distributed_tf_serving_tpu_torch.utils.config import ServerConfig

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DynamicBatcher(buckets=(8,))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_demo_servable(ServableRegistry(), config=ModelConfig(num_fields=2, vocab_size=8,
                                                                  embed_dim=2, mlp_dims=(2,)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_stack(ServerConfig(buckets=(8,)), None)
    assert resolve_device("cpu") == torch.device("cpu")


def test_cli_refuses_to_start_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, "-m", "distributed_tf_serving_tpu_torch.serving.server", "--port", "0"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert res.returncode != 0
    assert "CUDA is not available" in res.stderr


def test_chip_smoke_refuses_without_card_and_outside_the_repo(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and '"ok"' not in res.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    res = subprocess.run([sys.executable, str(alone)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and '"ok"' not in res.stdout


def test_native_module_is_the_ports_own_and_builds_into_an_ignored_dir():
    import distributed_tf_serving_tpu_torch.native as native

    assert native._SRC.exists() and native._SRC.parent == PORT / "native"
    assert native._SO.parent == PORT / "native" / "build"
    assert "distributed_tf_serving_tpu_torch/native/build/" in (REPO / ".gitignore").read_text()


def test_kernel_modules_import_without_building():
    from distributed_tf_serving_tpu_torch.ops import cuda_build

    assert cuda_build.build_info == {} or all("path" in v for v in cuda_build.build_info.values())
    assert (PORT / "csrc" / "cross_kernel.cu").exists()
    assert "arch=compute_90a,code=sm_90a" in cuda_build.NVCC_FLAGS


_PLANES_SCRIPT = r"""
import json, sys
import numpy as np
from distributed_tf_serving_tpu_torch import codec
from distributed_tf_serving_tpu_torch.models import ModelConfig
from distributed_tf_serving_tpu_torch.proto import serving_apis_pb2 as apis
from distributed_tf_serving_tpu_torch.serving.server import build_stack
from distributed_tf_serving_tpu_torch.utils.config import (
    IntegrityConfig, OverloadConfig, ServerConfig)
cfg = ModelConfig(num_fields=3, vocab_size=64, embed_dim=2, mlp_dims=(4,), num_cross_layers=1)
impl, batcher, _ = build_stack(ServerConfig(buckets=(8,), num_fields=3), cfg, device="cpu",
                               overload_config=OverloadConfig(enabled=True),
                               integrity_config=IntegrityConfig(enabled=True,
                                                                shadow_fraction=1.0))
req = apis.PredictRequest()
req.model_spec.name = "DCN"
arrays = {"feat_ids": np.arange(12, dtype=np.int64).reshape(4, 3),
          "feat_wts": np.ones((4, 3), np.float32)}
for k, v in arrays.items():
    codec.from_ndarray(v, out=req.inputs[k])
resp = impl.predict(req, criticality="sheddable", input_crc=codec.crc_sidecar(arrays))
stamp = impl.response_crc_sidecar(resp)
batcher.stop()
snap = impl.integrity_stats()
print(json.dumps({"shadow": snap["shadow"]["batches"], "verified": snap["wire"]["inputs_verified"],
                  "stamped": bool(stamp), "admitted": impl.overload_stats()["admitted"],
                  "modules": sorted(sys.modules)}))
"""


def test_overload_and_integrity_planes_import_no_jax_subprocess():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run(
        [sys.executable, "-c", _PLANES_SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=180,
    )
    assert res.returncode == 0, res.stderr
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["shadow"] >= 1 and line["verified"] == 1 and line["stamped"]
    assert line["admitted"] >= 1
    assert [m for m in line["modules"] if _is_jax_side(m) or _is_off_card(m)] == []
    for mod in ("serving.overload", "serving.integrity"):
        assert f"distributed_tf_serving_tpu_torch.{mod}" in line["modules"]


_CASCADE_SCRIPT = r"""
import json, sys, tempfile
import numpy as np
from distributed_tf_serving_tpu_torch import codec
from distributed_tf_serving_tpu_torch.models import ModelConfig
from distributed_tf_serving_tpu_torch.proto import serving_apis_pb2 as apis
from distributed_tf_serving_tpu_torch.serving.cascade import publish_stage1
from distributed_tf_serving_tpu_torch.serving.server import build_stack
from distributed_tf_serving_tpu_torch.utils.config import CascadeConfig, ServerConfig
import distributed_tf_serving_tpu_torch.interop.export  # noqa: F401
cfg = ModelConfig(num_fields=3, vocab_size=64, embed_dim=2, mlp_dims=(4,), num_cross_layers=1)
impl, batcher, _ = build_stack(ServerConfig(buckets=(8, 16), num_fields=3), cfg, device="cpu",
                               cascade_config=CascadeConfig(enabled=True))
req = apis.PredictRequest()
req.model_spec.name = "DCN"
req.output_filter.append("prediction_node")
arrays = {"feat_ids": np.arange(48, dtype=np.int64).reshape(16, 3),
          "feat_wts": np.ones((16, 3), np.float32)}
for k, v in arrays.items():
    codec.from_ndarray(v, out=req.inputs[k])
stage = codec.to_ndarray(impl.predict(req).outputs["cascade_stage"])
version, _ = publish_stage1(tempfile.mkdtemp(), impl.registry.resolve("stage1"), "two_tower")
batcher.stop()
print(json.dumps({"ranked": int((stage == 2).sum()), "version": version,
                  "requests": impl.cascade_stats()["requests"],
                  "modules": sorted(sys.modules)}))
"""


def test_cascade_and_interop_import_no_jax_subprocess():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run(
        [sys.executable, "-c", _CASCADE_SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=180,
    )
    assert res.returncode == 0, res.stderr
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["ranked"] == 4 and line["version"] == 1 and line["requests"] == 1
    assert [m for m in line["modules"] if _is_jax_side(m) or _is_off_card(m)] == []
    for mod in ("serving.cascade", "interop", "interop.export"):
        assert f"distributed_tf_serving_tpu_torch.{mod}" in line["modules"]


_OBSERVABILITY_SCRIPT = r"""
import json, sys
import numpy as np
from distributed_tf_serving_tpu_torch import codec
from distributed_tf_serving_tpu_torch.models import ModelConfig
from distributed_tf_serving_tpu_torch.proto import serving_apis_pb2 as apis
from distributed_tf_serving_tpu_torch.serving.server import build_stack
from distributed_tf_serving_tpu_torch.serving.utilization import profiler_capture
from distributed_tf_serving_tpu_torch.utils.config import (
    QualityConfig, ServerConfig, UtilizationConfig)
cfg = ModelConfig(num_fields=3, vocab_size=64, embed_dim=2, mlp_dims=(4,), num_cross_layers=1)
impl, batcher, _ = build_stack(ServerConfig(buckets=(8,), num_fields=3), cfg, device="cpu",
                               utilization_config=UtilizationConfig(enabled=True),
                               quality_config=QualityConfig(enabled=True, reference_file=""))
req = apis.PredictRequest()
req.model_spec.name = "DCN"
arrays = {"feat_ids": np.arange(12, dtype=np.int64).reshape(4, 3),
          "feat_wts": np.ones((4, 3), np.float32)}
for k, v in arrays.items():
    codec.from_ndarray(v, out=req.inputs[k])
impl.predict(req)
batcher.stop()
print(json.dumps({"batches": impl.utilization_stats()["batches"],
                  "device": impl.utilization_stats()["device"],
                  "scores": impl.quality_stats()["models"]["DCN"]["versions"]["1"]["count"],
                  "capture": profiler_capture().status()["active"],
                  "modules": sorted(sys.modules)}))
"""


def test_utilization_and_quality_planes_import_no_jax_subprocess():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run(
        [sys.executable, "-c", _OBSERVABILITY_SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=180,
    )
    assert res.returncode == 0, res.stderr
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["batches"] == 1 and line["device"] == "cpu" and line["scores"] == 4
    assert line["capture"] is False
    assert [m for m in line["modules"] if _is_jax_side(m) or _is_off_card(m)] == []
    for mod in ("serving.utilization", "serving.quality"):
        assert f"distributed_tf_serving_tpu_torch.{mod}" in line["modules"]


_FRESHNESS_SCRIPT = r"""
import json, sys, tempfile
from distributed_tf_serving_tpu_torch.models import ModelConfig, ServableRegistry, build_model
from distributed_tf_serving_tpu_torch.models.registry import Servable, model_signatures
from distributed_tf_serving_tpu_torch.serving.lifecycle import LifecycleController
from distributed_tf_serving_tpu_torch.serving.quality import QualityMonitor
from distributed_tf_serving_tpu_torch.serving.version_watcher import (
    VersionWatcher, VersionWatcherConfig)
from distributed_tf_serving_tpu_torch.train import Trainer, save_servable
from distributed_tf_serving_tpu_torch.utils.config import LifecycleConfig
cfg = ModelConfig(num_fields=4, vocab_size=256, embed_dim=2, mlp_dims=(4,), num_cross_layers=1)
model = build_model("dcn_v2", cfg)
trainer = Trainer(model, device="cpu")
trainer.fit(2, batch_size=16)
base = tempfile.mkdtemp()
save_servable(base + "/1", Servable("DCN", 1, model, trainer.snapshot_params(),
                                    model_signatures(model)), kind="dcn_v2")
reg = ServableRegistry()
watcher = VersionWatcher(base, reg, VersionWatcherConfig(poll_interval_s=3600), device="cpu")
watcher.poll_once()
ctrl = LifecycleController(LifecycleConfig(enabled=True, fine_tune_steps=2,
                                           fine_tune_batch_size=8),
                           registry=reg, model_name="DCN", watcher=watcher,
                           quality=QualityMonitor())
ctrl.tick()
summary = ctrl.publish_once()
watcher.poll_once()
ctrl.tick()
print(json.dumps({"version": summary["version"], "state": ctrl.snapshot()["state"],
                  "modules": sorted(sys.modules)}))
"""


def test_the_freshness_loop_imports_no_jax_subprocess():
    """Train, publish a fine-tune and arm its canary in a process that
    imports nothing of JAX."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run(
        [sys.executable, "-c", _FRESHNESS_SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=180,
    )
    assert res.returncode == 0, res.stderr
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["version"] == 2 and line["state"] == "canary"
    assert [m for m in line["modules"] if _is_jax_side(m) or _is_off_card(m)] == []
    for mod in ("train.trainer", "train.publisher", "serving.lifecycle"):
        assert f"distributed_tf_serving_tpu_torch.{mod}" in line["modules"]


_TRAIN_MESH_SCRIPT = r"""
import json, sys, tempfile
import torch
from distributed_tf_serving_tpu_torch.models import ModelConfig, build_model
from distributed_tf_serving_tpu_torch.models.registry import Servable, model_signatures
from distributed_tf_serving_tpu_torch.parallel import ShardedExecutor, make_mesh
from distributed_tf_serving_tpu_torch.parallel.sharding import gather_params
from distributed_tf_serving_tpu_torch.train import Trainer, load_servable, save_servable
cfg = ModelConfig(num_fields=4, vocab_size=256, embed_dim=2, mlp_dims=(4,), num_cross_layers=1)
model = build_model("dcn_v2", cfg)
mesh = make_mesh(4, model_parallel=2, devices=[torch.device("cpu")] * 4)
trainer = Trainer(model, mesh=mesh, tensor_parallel=True, device="cpu")
trainer.fit(2, batch_size=16)
base = tempfile.mkdtemp()
save_servable(base + "/1", Servable("DCN", 1, model, gather_params(trainer.snapshot_params()),
                                    model_signatures(model)), kind="dcn_v2")
sv = load_servable(base + "/1", mesh=mesh)
import numpy as np
out = ShardedExecutor(mesh)(sv, {"feat_ids": np.zeros((6, 4), np.int32),
                                 "feat_wts": np.ones((6, 4), np.float32)})
print(json.dumps({"n": int(out["prediction_node"].shape[0]), "modules": sorted(sys.modules)}))
"""


def test_the_mesh_trainer_imports_no_jax_subprocess():
    """Train over a (2, 2) mesh with TP, save, restore placed and serve it
    over the mesh in a process that imports nothing of JAX."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", _TRAIN_MESH_SCRIPT], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stderr
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["n"] == 6
    assert [m for m in line["modules"] if _is_jax_side(m) or _is_off_card(m)] == []
    for mod in ("train.trainer", "parallel.sharding", "parallel.executor"):
        assert f"distributed_tf_serving_tpu_torch.{mod}" in line["modules"]


_EXPORT_SCRIPT = r"""
import json, runpy, sys
sys.argv = ["export", "--checkpoint", sys.argv[1], "--out", sys.argv[2]]
try:
    runpy.run_module("distributed_tf_serving_tpu_torch.interop.export", run_name="__main__")
except SystemExit as e:
    assert not e.code, e.code
print(json.dumps({"modules": sorted(m for m, v in sys.modules.items() if v is not None)}))
"""


def test_the_export_imports_tensorflow_and_no_jax_or_port_proto_subprocess(tmp_path):
    """The export CLI's process imports TensorFlow and none of JAX, of the
    JAX package or of the port's vendored protos (they would collide with
    TensorFlow's in the descriptor pool)."""
    import importlib.util

    if importlib.util.find_spec("tensorflow") is None:
        pytest.skip("tensorflow is not installed: the export needs it")
    from distributed_tf_serving_tpu_torch.models import ModelConfig, build_model
    from distributed_tf_serving_tpu_torch.models.registry import Servable, model_signatures
    from distributed_tf_serving_tpu_torch.train.checkpoint import save_servable

    model = build_model("dcn_v2", ModelConfig(num_fields=4, vocab_size=256, embed_dim=2,
                                              mlp_dims=(4,), num_cross_layers=1))
    save_servable(tmp_path / "ckpt", Servable("DCN", 1, model, model.init(0, "cpu"),
                                              model_signatures(model)), kind="dcn_v2")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", _EXPORT_SCRIPT, str(tmp_path / "ckpt"),
                          str(tmp_path / "sm")], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = res.stdout.strip().splitlines()
    assert json.loads(lines[-2])["validated"] is True
    mods = json.loads(lines[-1])["modules"]
    assert "tensorflow" in mods
    assert [m for m in mods if _is_jax_side(m)] == []
    assert [m for m in mods if m.startswith("distributed_tf_serving_tpu_torch.proto")] == []
