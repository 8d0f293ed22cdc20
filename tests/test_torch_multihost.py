"""The port's multi-process tier against the JAX package, case for case with
tests/test_multihost.py: the leader / follower broadcast protocol (SCORE,
RELOAD, SHUTDOWN), the bucket ladder, the watcher's group-wide hot swap, the
signature-driven templates of build_multihost_stack, and fail-fast on a dead
follower.

In process the port runs a world of one (gloo over an in-process store)
beside the JAX runner on the 8 virtual CPU devices, on the same params and
inputs. The two-process runs start real gloo groups on 127.0.0.1: one
(SCORE + RELOAD + SHUTDOWN) is tier-1 with its own 60 s limit; the JAX
file's slow two-process cases keep the `slow` marker in their copies."""

import dataclasses
import os
import socket
import subprocess
import sys
import textwrap
import time

import jax
import numpy as np
import pytest
import torch

from distributed_tf_serving_tpu.models import ModelConfig as JaxConfig
from distributed_tf_serving_tpu.models import build_model as jax_build
from distributed_tf_serving_tpu.parallel.multihost import MultiHostRunner as JaxRunner
from distributed_tf_serving_tpu.parallel.multihost import global_mesh as jax_global_mesh
from distributed_tf_serving_tpu.serving.batcher import fold_ids_host as jax_fold
from distributed_tf_serving_tpu_torch.convert import params_from_jax
from distributed_tf_serving_tpu_torch.models import (
    ModelConfig,
    Servable,
    ServableRegistry,
    build_model,
    ctr_signatures,
)
from distributed_tf_serving_tpu_torch.parallel.multihost import (
    MultiHostRunner,
    global_mesh,
    init_distributed,
)
from distributed_tf_serving_tpu_torch.serving.batcher import fold_ids_host
from distributed_tf_serving_tpu_torch.serving.version_watcher import (
    VersionWatcher,
    VersionWatcherConfig,
)
from distributed_tf_serving_tpu_torch.train.checkpoint import load_servable, save_servable

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The worker's preamble: a port-only process (no JAX) joining a gloo group
# of two on the CPU, with the tiny dcn_v2 of the JAX tests (the version's
# params are the numpy seed's).
_PREAMBLE = """
import os, sys, threading, time
import numpy as np
import torch
port, pid = sys.argv[1], int(sys.argv[2])
from distributed_tf_serving_tpu_torch.models import (
    ModelConfig, Servable, build_model, ctr_signatures)
from distributed_tf_serving_tpu_torch.parallel.multihost import (
    MultiHostRunner, global_mesh, init_distributed)
from distributed_tf_serving_tpu_torch.serving.batcher import DynamicBatcher, fold_ids_host
print("backend", init_distributed(f"127.0.0.1:{port}", 2, pid, heartbeat_timeout_s=10),
      flush=True)
cfg = ModelConfig(num_fields=8, vocab_size=512, embed_dim=4, mlp_dims=(16,),
                  num_cross_layers=1, compute_dtype="float32")
model = build_model("dcn_v2", cfg)

def param_loader(version):
    return model.init(version, "cpu")  # the same params on every process

def arrays(n, seed=0):
    rng = np.random.RandomState(seed)
    return {"feat_ids": fold_ids_host(rng.randint(0, 1 << 40, size=(n, 8)), 512),
            "feat_wts": rng.rand(n, 8).astype(np.float32)}

def golden(version, a):
    with torch.inference_mode():
        return model.apply(param_loader(version), {k: torch.from_numpy(v) for k, v in a.items()}
                           )["prediction_node"].numpy()

def templates(buckets):
    return [{"feat_ids": np.zeros((b, 8), np.int32), "feat_wts": np.zeros((b, 8), np.float32)}
            for b in buckets]

mesh = global_mesh(model_parallel=1, device="cpu")
assert mesh.shape == {"data": 2, "model": 1}, mesh.shape
"""

_PROTOCOL_WORKER = _PREAMBLE + """
runner = MultiHostRunner(mesh=mesh, params=param_loader(1),
                         score_fn=lambda p, b: model.apply(p, b)["prediction_node"],
                         batch_templates=templates((16, 32)), param_loader=param_loader)
assert runner.buckets == (16, 32)
if pid == 0:
    sv = Servable(name="DCN", version=1, model=model, params=None, signatures=ctr_signatures(8))
    batcher = DynamicBatcher(buckets=runner.buckets, max_wait_us=0, device="cpu",
                             run_fn=runner.as_run_fn()).start()
    small, large = arrays(10), arrays(20, seed=1)
    np.testing.assert_allclose(batcher.submit(sv, small).result(60)["prediction_node"],
                               golden(1, small), rtol=1e-6)
    np.testing.assert_allclose(runner.lead(
        {k: np.concatenate([v, np.zeros((12,) + v.shape[1:], v.dtype)])
         for k, v in large.items()})[:20], golden(1, large), rtol=1e-6)
    runner.reload(2)
    after = batcher.submit(sv, small).result(60)["prediction_node"]
    np.testing.assert_allclose(after, golden(2, small), rtol=1e-6)
    assert not np.allclose(after, golden(1, small)), "params did not swap"
    batcher.stop()
    runner.shutdown()
    print("LEADER_OK", flush=True)
else:
    runner.follow()
    assert runner.version == 2, "follower missed the RELOAD broadcast"
    print("FOLLOWER_DONE", flush=True)
"""

_SCORES_WORKER = _PREAMBLE + """
runner = MultiHostRunner(mesh=mesh, params=param_loader(0),
                         score_fn=lambda p, b: model.apply(p, b)["prediction_node"],
                         batch_template=templates((32,))[0])
if pid == 0:
    batch = arrays(32, seed=7)
    scores = runner.lead(batch)
    np.testing.assert_allclose(scores, golden(0, batch), rtol=1e-5)
    sv = Servable(name="DCN", version=1, model=model, params=None, signatures=ctr_signatures(8))
    batcher = DynamicBatcher(buckets=(32,), max_wait_us=0, device="cpu",
                             run_fn=runner.as_run_fn()).start()
    small = {k: v[:10] for k, v in batch.items()}
    got = batcher.submit(sv, small).result(60)["prediction_node"]
    np.testing.assert_allclose(got, golden(0, batch)[:10], rtol=1e-5)
    batcher.stop()
    runner.shutdown()
    print("MULTIHOST_OK", scores.shape, flush=True)
else:
    runner.follow()
    print("FOLLOWER_DONE", flush=True)
"""

_LIFECYCLE_WORKER = _PREAMBLE + """
runner = MultiHostRunner(mesh=mesh, params=param_loader(1),
                         score_fn=lambda p, b: model.apply(p, b)["prediction_node"],
                         batch_templates=templates((16, 32)), param_loader=param_loader)
if pid == 0:
    sv = Servable(name="DCN", version=1, model=model, params=None, signatures=ctr_signatures(8))
    batcher = DynamicBatcher(buckets=runner.buckets, max_wait_us=0, device="cpu",
                             run_fn=runner.as_run_fn()).start()
    small, large = arrays(10), arrays(20, seed=1)
    np.testing.assert_allclose(batcher.submit(sv, small).result(120)["prediction_node"],
                               golden(1, small), rtol=1e-5)
    np.testing.assert_allclose(batcher.submit(sv, large).result(120)["prediction_node"],
                               golden(1, large), rtol=1e-5)
    # Hot-swap to version 2 under traffic: every response matches v1 or v2
    # (an atomic swap), and later traffic scores with v2.
    results = []
    def load():
        for i in range(6):
            a = arrays(10, seed=100 + i)
            results.append((a, batcher.submit(sv, a).result(120)["prediction_node"]))
    t = threading.Thread(target=load)
    t.start()
    runner.reload(2)
    t.join()
    for a, got in results:
        assert any(np.allclose(got, golden(v, a), rtol=1e-5) for v in (1, 2))
    after = batcher.submit(sv, small).result(120)["prediction_node"]
    np.testing.assert_allclose(after, golden(2, small), rtol=1e-5)
    assert runner.version == 2
    batcher.stop()
    runner.shutdown()
    print("LIFECYCLE_OK", flush=True)
else:
    runner.follow()
    assert runner.version == 2, "follower missed the RELOAD broadcast"
    print("FOLLOWER_DONE", flush=True)
"""

_DEATH_WORKER = _PREAMBLE + """
runner = MultiHostRunner(mesh=mesh, params=param_loader(0),
                         score_fn=lambda p, b: model.apply(p, b)["prediction_node"],
                         batch_template=templates((16,))[0])
runner.heartbeat() if pid == 0 else runner._header(3, 0)  # both in the group
if pid == 1:
    os._exit(3)  # the follower dies abruptly mid-service
t0 = time.monotonic()
runner.start_heartbeat(1.0)
# The leader's next control broadcast fails: it must exit, not wedge.
runner.failed.wait(60)
print("FAILED_AFTER", round(time.monotonic() - t0, 3), repr(runner.failure)[:120], flush=True)
if not runner.failed.is_set():
    print("LEADER_SURVIVED", flush=True)
    sys.exit(0)
os._exit(1)
"""


def _run_two_process(worker_src: str, timeout_s: int = 240, env_extra=None):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, **(env_extra or {}),
           "PYTHONPATH": os.pathsep.join([REPO] + os.environ.get("PYTHONPATH", "").split(
               os.pathsep))}
    procs = [subprocess.Popen([sys.executable, "-c", textwrap.dedent(worker_src), str(port),
                               str(pid)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=env) for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout_s)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        dumps = []
        for p in procs:
            try:
                out, _ = p.communicate(timeout=10)
            except Exception:  # noqa: BLE001
                out = "<unreadable>"
            dumps.append(out)
        pytest.fail("multihost workers hung; outputs:\n"
                    + "\n====\n".join(d[-2000:] for d in dumps))
    return procs, outs


def test_two_process_gloo_score_reload_shutdown():
    """Tier-1: two gloo processes run the whole protocol — SCORE over the
    ladder (through the leader's batcher and directly), RELOAD to v2 on
    both, SHUTDOWN releasing the follower — within 60 s."""
    t0 = time.monotonic()
    procs, outs = _run_two_process(_PROTOCOL_WORKER, timeout_s=60)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"
    assert "backend gloo" in outs[0] and "LEADER_OK" in outs[0]
    assert "FOLLOWER_DONE" in outs[1]
    assert time.monotonic() - t0 < 60


@pytest.mark.slow
def test_two_process_leader_follower_scores():
    procs, outs = _run_two_process(_SCORES_WORKER)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"
    assert "MULTIHOST_OK" in outs[0]
    assert "FOLLOWER_DONE" in outs[1]


@pytest.mark.slow
def test_two_process_ladder_hot_swap_under_load():
    procs, outs = _run_two_process(_LIFECYCLE_WORKER)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"
    assert "LIFECYCLE_OK" in outs[0]
    assert "FOLLOWER_DONE" in outs[1]


@pytest.mark.slow
def test_follower_death_terminates_leader():
    """A dead follower fails the group fast: the leader's next control
    broadcast raises on the closed connection, and it exits nonzero."""
    procs, outs = _run_two_process(_DEATH_WORKER, timeout_s=120)
    assert procs[1].returncode == 3  # the induced death
    assert procs[0].returncode != 0, f"leader survived a dead follower:\n{outs[0][-2000:]}"
    assert "LEADER_SURVIVED" not in outs[0] and "FAILED_AFTER" in outs[0]


# --------------------------------------------------------------- in process


KW = dict(num_fields=6, vocab_size=512, embed_dim=4, mlp_dims=(8,), num_cross_layers=1,
          compute_dtype="float32")


def _world_of_one():
    assert init_distributed() == "gloo"
    return global_mesh(device="cpu")


def test_watcher_loader_hot_swaps_runner(tmp_path):
    """Leader-side glue: a VersionWatcher load drives the group-wide RELOAD,
    and the runner then scores the new version as the JAX runner does on
    the same params."""
    jm = jax_build("dcn", JaxConfig(**KW))
    model = build_model("dcn", ModelConfig(**KW))

    def write_version(version, seed):
        jparams = jm.init(jax.random.PRNGKey(seed))
        sv = Servable(name="DCN", version=version, model=model,
                      params=params_from_jax(jax.tree.map(np.asarray, jparams)),
                      signatures=ctr_signatures(6))
        save_servable(tmp_path / str(version), sv, kind="dcn")
        return jparams

    write_version(1, seed=0)

    def param_loader(version):
        return load_servable(tmp_path / str(version), device="cpu").params

    template = {"feat_ids": np.zeros((16, 6), np.int32), "feat_wts": np.zeros((16, 6), np.float32)}
    runner = MultiHostRunner(mesh=_world_of_one(), params=param_loader(1),
                             score_fn=lambda p, b: model.apply(p, b)["prediction_node"],
                             batch_template=template, param_loader=param_loader)
    registry = ServableRegistry()
    watcher = VersionWatcher(
        tmp_path, registry, VersionWatcherConfig(poll_interval_s=3600, model_name="DCN"),
        loader=runner.watcher_loader(
            lambda version, path: dataclasses.replace(load_servable(path, device="cpu"),
                                                      version=version)))
    watcher.poll_once()
    assert registry.models()["DCN"] == [1]
    assert runner.version == 1

    v2 = write_version(2, seed=9)
    watcher.poll_once()
    assert registry.models()["DCN"] == [1, 2]
    assert runner.version == 2

    rng = np.random.RandomState(3)
    batch = {"feat_ids": fold_ids_host(rng.randint(0, 1 << 40, size=(16, 6)), 512),
             "feat_wts": rng.rand(16, 6).astype(np.float32)}
    got = runner.lead(batch)
    theirs = JaxRunner(mesh=jax_global_mesh(), params=v2,
                       score_fn=lambda p, b: jm.apply(p, b)["prediction_node"],
                       batch_template=template).lead(batch)
    np.testing.assert_allclose(got, theirs, rtol=1e-5)
    with torch.inference_mode():
        want = model.apply(param_loader(2), {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(got, want["prediction_node"].numpy(), rtol=1e-5)
    # A batch off the template is refused before any collective.
    with pytest.raises(ValueError, match="not a configured bucket"):
        runner.lead({k: v[:8] for k, v in batch.items()})


def test_multihost_stack_dlrm_carries_dense_features(tmp_path):
    """Templates follow the signature: DLRM's dense_features crosses the
    broadcast (not zero-substituted), the architecture comes from the
    checkpoint's manifest, and the stack registers its source so a
    label-only reload re-stating it is accepted."""
    from distributed_tf_serving_tpu_torch.proto import serving_apis_pb2 as apis
    from distributed_tf_serving_tpu_torch.serving.multihost_server import build_multihost_stack

    over = dict(name="DLRM", bottom_mlp_dims=(8, 4), num_dense_features=5)
    kw = {**KW, **over}
    jm = jax_build("dlrm", JaxConfig(**kw))
    jparams = jm.init(jax.random.PRNGKey(0))
    model = build_model("dlrm", ModelConfig(**kw))
    sv = Servable(name="DLRM", version=1, model=model,
                  params=params_from_jax(jax.tree.map(np.asarray, jparams)),
                  signatures=ctr_signatures(6, with_dense=5))
    base = tmp_path / "models"
    save_servable(base / "1", sv, kind="dlrm")
    _world_of_one()
    runner, registry, batcher, impl, watcher = build_multihost_stack(
        base, None, 1, 0, model_name="DLRM", buckets=(16,), poll_interval_s=3600, device="cpu")
    try:
        assert "dense_features" in runner._keys
        assert registry.models()["DLRM"] == [1]
        assert impl.served_sources["DLRM"] == (str(base), "dcn_v2")
        restate = apis.ReloadConfigRequest()
        mc = restate.config.model_config_list.config.add()
        mc.name = "DLRM"
        mc.base_path = str(base)
        mc.version_labels["stable"] = 1
        assert impl.handle_reload_config(restate).status.error_code == 0
        assert registry.labels("DLRM") == {"stable": 1}

        rng = np.random.RandomState(4)
        arrays = {
            "feat_ids": rng.randint(0, 1 << 40, size=(9, 6)).astype(np.int64),
            "feat_wts": rng.rand(9, 6).astype(np.float32),
            "dense_features": rng.rand(9, 5).astype(np.float32),
        }
        got = batcher.submit(sv, dict(arrays)).result(timeout=120)["prediction_node"]
        prepared = {**arrays, "feat_ids": fold_ids_host(arrays["feat_ids"], 512)}
        want = np.asarray(jm.apply(jparams, {**prepared, "feat_ids": jax_fold(
            arrays["feat_ids"], 512)})["prediction_node"])
        np.testing.assert_allclose(got, want, rtol=1e-5)
        with torch.inference_mode():
            zeroed = {k: torch.from_numpy(v) for k, v in prepared.items()}
            zeroed["dense_features"] = torch.zeros_like(zeroed["dense_features"])
            without = model.apply(sv.params, zeroed)["prediction_node"].numpy()
        assert not np.allclose(want, without)  # the dense input mattered
    finally:
        watcher.stop()
        batcher.stop()


_SERVER_WORKER = """
import os, sys, pathlib
import numpy as np
port, pid = sys.argv[1], int(sys.argv[2])
base = pathlib.Path(os.environ["MH_BASE_PATH"])
from distributed_tf_serving_tpu_torch.models import (
    ModelConfig, Servable, build_model, ctr_signatures)
from distributed_tf_serving_tpu_torch.serving.multihost_server import build_multihost_stack
from distributed_tf_serving_tpu_torch.train.checkpoint import save_servable
cfg = ModelConfig(num_fields=8, vocab_size=512, embed_dim=4, mlp_dims=(16,),
                  num_cross_layers=1, compute_dtype="float32")
model = build_model("dcn_v2", cfg)
runner, registry, batcher, impl, watcher = build_multihost_stack(
    base, f"127.0.0.1:{port}", 2, pid, model_kind="dcn_v2", buckets=(16, 32),
    poll_interval_s=3600, device="cpu")
if pid != 0:
    runner.follow()
    assert runner.version == 2, f"follower ended on version {runner.version}"
    print("FOLLOWER_DONE", flush=True)
    sys.exit(0)
import torch
from distributed_tf_serving_tpu_torch.client import predict_sync
from distributed_tf_serving_tpu_torch.serving.batcher import fold_ids_host
from distributed_tf_serving_tpu_torch.serving.server import create_server
assert runner.version == 1 and registry.models()["DCN"] == [1]
assert impl.served_sources["DCN"] == (str(base), "dcn_v2")
server, gport = create_server(impl, "127.0.0.1:0")
server.start()
rng = np.random.RandomState(3)
arrays = {"feat_ids": rng.randint(0, 1 << 40, size=(10, 8)).astype(np.int64),
          "feat_wts": rng.rand(10, 8).astype(np.float32)}
def golden(seed):
    with torch.inference_mode():
        return model.apply(model.init(seed, "cpu"), {
            "feat_ids": torch.from_numpy(fold_ids_host(arrays["feat_ids"], 512)),
            "feat_wts": torch.from_numpy(arrays["feat_wts"])})["prediction_node"].numpy()
got1 = predict_sync(f"127.0.0.1:{gport}", arrays)["prediction_node"]
np.testing.assert_allclose(got1, golden(1), rtol=1e-5)
save_servable(base / "2", Servable(name="DCN", version=2, model=model,
                                   params=model.init(9, "cpu"), signatures=ctr_signatures(8)),
              kind="dcn_v2")
watcher.poll_once()  # leader load -> group-wide RELOAD broadcast
got2 = predict_sync(f"127.0.0.1:{gport}", arrays)["prediction_node"]
np.testing.assert_allclose(got2, golden(9), rtol=1e-5)
assert not np.allclose(got2, got1), "scores unchanged after hot swap"
assert registry.models()["DCN"] == [1, 2] and runner.version == 2
watcher.stop(); server.stop(0); batcher.stop(); runner.shutdown()
print("MULTIHOST_SERVER_OK", flush=True)
"""


@pytest.mark.slow
def test_multihost_server_stack_hot_swap_over_socket(tmp_path):
    """The operable entry point: leader and follower build the stack from a
    shared version base path, serve over a live gRPC socket, and a watcher
    poll hot-swaps the whole group."""
    base = tmp_path / "models"
    model = build_model("dcn_v2", ModelConfig(num_fields=8, vocab_size=512, embed_dim=4,
                                              mlp_dims=(16,), num_cross_layers=1,
                                              compute_dtype="float32"))
    save_servable(base / "1", Servable(name="DCN", version=1, model=model,
                                       params=model.init(1, "cpu"),
                                       signatures=ctr_signatures(8)), kind="dcn_v2")
    procs, outs = _run_two_process(_SERVER_WORKER, env_extra={"MH_BASE_PATH": str(base)})
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"
    assert "MULTIHOST_SERVER_OK" in outs[0]
    assert "FOLLOWER_DONE" in outs[1]
