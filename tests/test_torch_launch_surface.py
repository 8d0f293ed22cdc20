"""The server's launch and shutdown surface in the port, against the JAX
package where both have it: the config rule (a setting that is not ported
is refused with its reason, the mesh settings load and build, what changes
nothing is ignored, what the JAX package does not know raises), the batching-parameters file, the
request log's records in both directions, TLS, the graceful drain, and the
CLI's flags and SIGTERM."""

import dataclasses
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import grpc
import jax
import numpy as np
import pytest

from distributed_tf_serving_tpu.models import Servable as JaxServable
from distributed_tf_serving_tpu.models import ModelConfig as JaxConfig
from distributed_tf_serving_tpu.models import build_model as jax_build
from distributed_tf_serving_tpu.models import ctr_signatures as jax_signatures
from distributed_tf_serving_tpu.serving import DynamicBatcher as JaxBatcher
from distributed_tf_serving_tpu.serving import request_log as jax_request_log
from distributed_tf_serving_tpu.serving import warmup as jax_warmup
from distributed_tf_serving_tpu.utils import config as jax_config
from distributed_tf_serving_tpu_torch import codec
from distributed_tf_serving_tpu_torch.models import ModelConfig, ServableRegistry
from distributed_tf_serving_tpu_torch.proto import (
    HealthCheckRequest,
    HealthStub,
    ModelServiceStub,
    PredictionServiceStub,
)
from distributed_tf_serving_tpu_torch.proto import health as health_proto
from distributed_tf_serving_tpu_torch.proto import serving_apis_pb2 as apis
from distributed_tf_serving_tpu_torch.serving import warmup
from distributed_tf_serving_tpu_torch.serving.batcher import DynamicBatcher
from distributed_tf_serving_tpu_torch.serving.request_log import RequestLogger
from distributed_tf_serving_tpu_torch.serving.server import (
    GracefulShutdown,
    GrpcHealthService,
    TransportQuiesce,
    create_server,
    load_demo_servable,
    load_ssl_credentials,
    read_batching_parameters,
)
from distributed_tf_serving_tpu_torch.serving.service import PredictionServiceImpl, ServiceError
from distributed_tf_serving_tpu_torch.train.checkpoint import save_servable
from distributed_tf_serving_tpu_torch.utils import config as torch_config
from distributed_tf_serving_tpu_torch.utils.config import ServerConfig, load_config

REPO = Path(__file__).resolve().parents[1]
F = 6
CFG = ModelConfig(name="DCN", num_fields=F, vocab_size=1 << 10, embed_dim=4, mlp_dims=(8,),
                  num_cross_layers=1, compute_dtype="float32")


def _arrays(n=4, seed=0, fields=F):
    rng = np.random.RandomState(seed)
    return {"feat_ids": rng.randint(0, 1 << 40, size=(n, fields)).astype(np.int64),
            "feat_wts": rng.rand(n, fields).astype(np.float32)}


def _req(arrays, name="DCN"):
    req = apis.PredictRequest()
    req.model_spec.name = name
    for k, v in arrays.items():
        codec.from_ndarray(v, out=req.inputs[k])
    return req


def _toml(tmp_path, text):
    p = tmp_path / "c.toml"
    p.write_text(text)
    return p


# ------------------------------------------------------------ the config rule

REFUSED = [
    # Refused with its reason, not an item: a CUDA context has no in-process
    # rebuild (serving/recovery.py).
    ("[recovery]\nreinit_clear_backend = true\n", "a CUDA context cannot be rebuilt in-process"),
]


@pytest.mark.parametrize("text,item", REFUSED, ids=[t.split("\n")[1] + f"@{t.split(']')[0][1:]}"
                                                    for t, _ in REFUSED])
def test_a_setting_that_is_not_ported_is_refused_with_its_item(tmp_path, text, item):
    want = item if isinstance(item, str) else (
        f"not ported yet \\(ROADMAP.md Queue A item {item}\\)")
    with pytest.raises(ValueError, match=want):
        load_config(_toml(tmp_path, text))
    jax_config.load_config(_toml(tmp_path, text))  # the JAX package loads it


# The mesh settings (refused until the mesh was ported): each loads with the
# JAX package's values, and a stack built from it serves over eight logical
# CPU shards ([elastic] on top of the [mesh] it needs).
MESH_SETTINGS = [
    ("[server]\nmesh_devices = 8\n", {"data": 8, "model": 1}),
    ("[server]\nmodel_parallel = 2\n", None),
    ("[server]\ntensor_parallel = true\n", None),
    ("[mesh]\nenabled = true\n", {"data": 8, "model": 1}),
    ("[mesh]\nenabled = true\nmodel_parallel = 2\n[elastic]\nenabled = true\n",
     {"data": 4, "model": 2}),
]


@pytest.mark.parametrize("text,shape", MESH_SETTINGS,
                         ids=[t.split("\n")[-2] + f"@{t.split(']')[0][1:]}"
                              for t, _ in MESH_SETTINGS])
def test_a_mesh_setting_loads_and_builds(tmp_path, text, shape):
    from distributed_tf_serving_tpu_torch.serving.server import build_stack

    ours = load_config(_toml(tmp_path, text))
    theirs = jax_config.load_config(_toml(tmp_path, text))
    for section in ("mesh", "elastic"):
        assert dataclasses.asdict(ours[section]) == dataclasses.asdict(theirs[section])
    for key in ("mesh_devices", "model_parallel", "tensor_parallel"):
        assert getattr(ours["server"], key) == getattr(theirs["server"], key)
    cfg = dataclasses.replace(ours["server"], num_fields=F, buckets=(8,), max_wait_us=0,
                              warmup=False)
    impl, batcher, servable = build_stack(
        cfg, CFG, "cpu", mesh_config=ours["mesh"], elastic_config=ours["elastic"],
        mesh_device_list=["cpu"] * 8)
    try:
        got = batcher.submit(servable, _arrays(5)).result(timeout=60)["prediction_node"]
        assert got.shape == (5,) and np.isfinite(got).all()
        mesh = impl.mesh_stats()
        assert (mesh["shape"] if mesh else None) == shape
        assert (impl.elastic_stats() is not None) == ours["elastic"].enabled
    finally:
        batcher.stop()


# Refused until this package ported them; now each loads with the JAX
# package's value.
PORTED = [
    ("[batching]\ninflight_window = 4\n", "batching", "inflight_window", 4),
    ("[batching]\nbuffer_ring = true\n", "batching", "buffer_ring", True),
    ("[transport]\nresponse_arena = true\n", "transport", "response_arena", True),
    ("[cache]\nenabled = true\ndedup = true\nrow_granular = true\nttl_s = 5.0\n", "cache",
     "enabled", True),
    ("[overload]\nenabled = true\ntarget_queue_wait_ms = 5.0\nadjust_interval_s = 0.1\n",
     "overload", "enabled", True),
    ("[integrity]\nenabled = true\nshadow_fraction = 0.25\nscreen_max = 1.0\n", "integrity",
     "enabled", True),
    ("[cascade]\nenabled = true\n", "cascade", "enabled", True),
    ("[cascade]\nenabled = true\nstage1_model = \"retriever\"\nsurvivor_k = 16\n"
     "score_threshold = 0.1\nmin_candidates = 32\n", "cascade", "survivor_k", 16),
    ("[utilization]\nenabled = true\n", "utilization", "enabled", True),
    ("[quality]\nenabled = true\n", "quality", "enabled", True),
    ("[lifecycle]\nenabled = true\n", "lifecycle", "enabled", True),
    ("[lifecycle]\nenabled = true\ncanary_probe_only_s = 2.5\nrollback_psi = 0.35\n"
     "fine_tune_interval_s = 900.0\nfine_tune_steps = 64\n", "lifecycle", "fine_tune_steps", 64),
    ("[recovery]\nenabled = true\nwatchdog_interval_s = 0.1\nwedge_quarantine_s = 1.0\n",
     "recovery", "enabled", True),
    ("[integrity]\nrouter_audit_fraction = 0.5\n", "integrity", "router_audit_fraction", 0.5),
    ("[fleet]\nenabled = true\n", "fleet", "enabled", True),
    ("[fleet]\nenabled = true\nself_id = \"r1\"\npeers = [\"127.0.0.1:7001\"]\n"
     "gossip_interval_s = 0.25\nrollout_writer = true\n", "fleet", "peers", ("127.0.0.1:7001",)),
    ("[slo]\nenabled = true\n", "slo", "enabled", True),
    ("[slo]\nenabled = true\nlatency_target_ms = 100.0\nshort_window_s = 2.0\n"
     "long_window_s = 8.0\n", "slo", "latency_target_ms", 100.0),
    ("[client]\nhosts = [\"127.0.0.1:1\", \"127.0.0.1:2\"]\ncandidate_num = 1000\n"
     "concurrent_num = 4\n", "client", "hosts", ("127.0.0.1:1", "127.0.0.1:2")),
    ("[client]\nhealth_scoreboard = true\nplacement = \"affinity\"\n", "client", "placement",
     "affinity"),
]


@pytest.mark.parametrize("text,section,key,value", PORTED,
                         ids=[f"{key}@{section}" for _, section, key, _ in PORTED])
def test_a_setting_ported_since_loads_like_jax(tmp_path, text, section, key, value):
    ours_section = load_config(_toml(tmp_path, text))[section]
    theirs_section = jax_config.load_config(_toml(tmp_path, text))[section]
    ours, theirs = getattr(ours_section, key), getattr(theirs_section, key)
    assert ours == theirs == value
    if section in ("cache", "overload", "integrity", "cascade", "utilization", "quality",
                   "lifecycle", "recovery", "fleet", "slo", "client"):
        # every field, as the JAX package reads it
        assert dataclasses.asdict(ours_section) == dataclasses.asdict(theirs_section)


IGNORED = [
    "[server]\ncompress_transfer = false\nasync_readback = false\n"
    "pipelined_dispatch = false\ndonate_buffers = false\n",
    "[server]\nmesh_devices = 0\nmodel_parallel = 1\ntensor_parallel = false\n",
    "[batching]\ninflight_window = 0\nbuffer_ring = false\n",
    "[client]\nhosts = [\"127.0.0.1:1\"]\nconcurrent_num = 4\n",
    "[cache]\nenabled = false\nttl_s = 1.0\n",
    "[mesh]\ndevices = 4\n",
    "[observability]\nwindow_seconds = 30.0\ntracing = false\n",
    "[fleet]\npeers = []\n",
]


@pytest.mark.parametrize("text", IGNORED, ids=[t.split("\n")[1] for t in IGNORED])
def test_a_setting_that_changes_nothing_here_still_loads(tmp_path, text):
    loaded = load_config(_toml(tmp_path, text))
    assert loaded["server"].buckets == ServerConfig().buckets
    assert loaded["drain_grace_s"] == 5.0


UNKNOWN = ["[nope]\nx = 1\n", "[server]\nnope = 1\n", "[batching]\nnope = 1\n",
           "[cache]\nnope = 1\n", "[client]\nnope = 1\n", "[overload]\nnope = 1\n"]


@pytest.mark.parametrize("text", UNKNOWN, ids=[t.split("\n")[0] for t in UNKNOWN])
def test_what_the_jax_package_does_not_know_raises_in_both(tmp_path, text):
    with pytest.raises(ValueError, match="unknown"):
        load_config(_toml(tmp_path, text))
    with pytest.raises(ValueError, match="unknown"):
        jax_config.load_config(_toml(tmp_path, text))


def test_the_key_tables_are_the_jax_package_s():
    jax_fields = {s: {f.name for f in dataclasses.fields(cls)}
                  for s, cls in jax_config._SECTIONS.items()}
    ported = {"server": torch_config.ServerConfig, "batching": torch_config.BatchingConfig,
              "transport": torch_config.TransportConfig, "kernels": torch_config.KernelsConfig,
              "observability": torch_config.ObservabilityConfig,
              "cache": torch_config.CacheConfig, "overload": torch_config.OverloadConfig,
              "integrity": torch_config.IntegrityConfig, "cascade": torch_config.CascadeConfig,
              "utilization": torch_config.UtilizationConfig,
              "quality": torch_config.QualityConfig,
              "lifecycle": torch_config.LifecycleConfig,
              "recovery": torch_config.RecoveryConfig, "client": torch_config.ClientConfig,
              "fleet": torch_config.FleetConfig, "slo": torch_config.SloConfig,
              "mesh": torch_config.MeshConfig, "elastic": torch_config.ElasticConfig}
    assert set(ported) == set(jax_fields)
    for section, cls in ported.items():
        own = {f.name for f in dataclasses.fields(cls)}
        extra = set(torch_config._IGNORED_KEYS.get(section, ()))
        assert own | extra == jax_fields[section], section
        assert not own & extra, section
        jdefaults = {f.name: f.default for f in dataclasses.fields(jax_config._SECTIONS[section])}
        for f in dataclasses.fields(cls):
            if f.name in jdefaults and section != "kernels":
                assert jdefaults[f.name] == f.default, (section, f.name)


def test_server_fields_of_this_slice_have_the_jax_defaults():
    j, t = jax_config.ServerConfig(), ServerConfig()
    for name in ("request_log_file", "request_log_sampling", "model_config_file",
                 "file_system_poll_wait_seconds", "max_num_load_retries", "max_workers",
                 "max_wait_us", "num_fields", "warmup"):
        assert getattr(t, name) == getattr(j, name), name


def test_drain_grace_is_read_with_the_overload_plane_off(tmp_path):
    loaded = load_config(_toml(tmp_path, "[overload]\nenabled = false\ndrain_grace_s = 2.5\n"))
    assert loaded["drain_grace_s"] == 2.5
    assert jax_config.load_config(_toml(tmp_path, "[overload]\ndrain_grace_s = 2.5\n")
                                  )["overload"].drain_grace_s == 2.5


# --------------------------------------------- the batching parameters file

BATCHING_CASES = {
    "example": (REPO / "configs" / "batching.pbtxt.example").read_text(),
    "max_batch_only": "max_batch_size { value: 1000 }\n",
    "timeout_threads": "batch_timeout_micros { value: 0 }\nnum_batch_threads { value: 3 }\n",
    "enqueued_only": "max_enqueued_batches { value: 4 }\n",
    "no_analog": "thread_pool_name { value: \"x\" }\npad_variable_length_inputs { value: true }\n",
    "allowed_only": "allowed_batch_sizes: 64\nallowed_batch_sizes: 16\n",
    "err_mismatch": "max_batch_size { value: 100 }\nallowed_batch_sizes: 64\n",
    "err_zero_max": "max_batch_size { value: 0 }\n",
    "err_zero_threads": "num_batch_threads { value: 0 }\n",
    "err_negative": "allowed_batch_sizes: -8\n",
}


@pytest.mark.parametrize("case", sorted(BATCHING_CASES))
def test_batching_parameters_map_as_in_jax(tmp_path, case):
    path = tmp_path / "batching.pbtxt"
    path.write_text(BATCHING_CASES[case])
    fields = ("buckets", "max_wait_us", "queue_capacity_candidates", "completion_workers")
    try:
        want = jax_config.apply_batching_parameters(jax_config.ServerConfig(), path)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            torch_config.apply_batching_parameters(ServerConfig(),
                                                   read_batching_parameters(path))
        assert str(got.value) == str(e)
        return
    got = torch_config.apply_batching_parameters(ServerConfig(), read_batching_parameters(path))
    assert {f: getattr(got, f) for f in fields} == {f: getattr(want, f) for f in fields}


# ------------------------------------------------------------ the request log

def _jax_servable():
    jcfg = JaxConfig(**{f.name: getattr(CFG, f.name) for f in dataclasses.fields(CFG)})
    jm = jax_build("dcn_v2", jcfg)
    return JaxServable(name="DCN", version=1, model=jm, params=jm.init(jax.random.PRNGKey(0)),
                       signatures=jax_signatures(F))


@pytest.fixture
def port_stack():
    registry = ServableRegistry()
    sv = load_demo_servable(registry, kind="dcn_v2", config=CFG, device="cpu")
    batcher = DynamicBatcher(buckets=(8, 32), max_wait_us=0, device="cpu").start()
    impl = PredictionServiceImpl(registry, batcher)
    try:
        yield impl, sv, batcher
    finally:
        batcher.stop()


def _classify_req(n=3, seed=0):
    req = apis.ClassificationRequest(model_spec=apis.ModelSpec(name="DCN"))
    arrays = _arrays(n, seed)
    for ids, wts in zip(arrays["feat_ids"], arrays["feat_wts"]):
        e = req.input.example_list.examples.add()
        e.features.feature["feat_ids"].int64_list.value.extend(int(i) for i in ids)
        e.features.feature["feat_wts"].float_list.value.extend(float(w) for w in wts)
    return req


def test_port_log_records_read_and_replay_through_the_jax_package(tmp_path, port_stack):
    impl, _, _ = port_stack
    path = tmp_path / "requests.log"
    impl.request_logger = RequestLogger(path, sampling_rate=1.0)
    for i in range(3):
        impl.predict(_req(_arrays(4, i)))
    impl.classify(_classify_req())
    with pytest.raises(ServiceError):
        impl.predict(_req(_arrays(4, 9, fields=F + 1)))  # refused: never logged
    impl.request_logger.close()
    impl.request_logger.close()  # idempotent
    assert impl.request_logger.written == 4
    records = list(jax_warmup.read_tfrecords(path))
    assert len(records) == 4
    from distributed_tf_serving_tpu.proto import serving_apis_pb2 as japis

    kinds = [japis.PredictionLog.FromString(r).WhichOneof("log_type") for r in records]
    assert kinds == ["predict_log"] * 3 + ["classify_log"]
    jsv = _jax_servable()
    jb = JaxBatcher(buckets=(8, 32), max_wait_us=0).start()
    try:
        assert jax_warmup.replay_warmup_file(path, jsv, jb) == 4
    finally:
        jb.stop()
    # ... and through the port's own warmup replay.
    assert warmup.replay_warmup_file(path, port_stack[1], port_stack[2]) == 4


def test_jax_log_records_replay_through_the_port(tmp_path, port_stack):
    from distributed_tf_serving_tpu.proto import serving_apis_pb2 as japis

    _, sv, batcher = port_stack
    path = tmp_path / "jax.log"
    jlog = jax_request_log.RequestLogger(path, sampling_rate=1.0)
    for i in range(3):
        jreq = japis.PredictRequest.FromString(_req(_arrays(5, i)).SerializeToString())
        jlog.maybe_log("predict", jreq)
    jlog.close()
    assert [len(r) > 0 for r in warmup.read_tfrecords(path)] == [True] * 3
    assert warmup.replay_warmup_file(path, sv, batcher) == 3


def test_request_log_samples_and_counts_what_it_drops(tmp_path):
    import random

    off = RequestLogger(tmp_path / "off.log", sampling_rate=0.0)
    for _ in range(10):
        off.maybe_log("predict", _req(_arrays(2)))
    off.close()
    assert off.written == 0 and (tmp_path / "off.log").read_bytes() == b""
    with pytest.raises(ValueError, match="sampling_rate"):
        RequestLogger(tmp_path / "bad.log", sampling_rate=1.5)
    # A queue of one behind a writer held on the file: the rest are dropped.
    full = RequestLogger(tmp_path / "full.log", sampling_rate=1.0, max_queued=1,
                         rng=random.Random(0))
    held = threading.Event()
    real = full._write_record

    def slow(kind, payload):
        held.wait(5)
        real(kind, payload)

    full._write_record = slow
    for _ in range(20):
        full.maybe_log("predict", _req(_arrays(2)))
    assert full.dropped >= 18
    held.set()
    full.close()
    assert full.written + full.dropped == 20


# ------------------------------------------------------------------- TLS

def _openssl(*args):
    subprocess.run(["openssl", *args], check=True, capture_output=True)


@pytest.fixture(scope="module")
def pki(tmp_path_factory):
    """A self-signed CA, a server certificate (CN=localhost, SAN 127.0.0.1)
    and a client certificate, made with the openssl CLI."""
    if subprocess.run(["which", "openssl"], capture_output=True).returncode != 0:
        pytest.skip("the openssl CLI is not installed: no throwaway PKI to test TLS with")
    d = tmp_path_factory.mktemp("pki")
    _openssl("req", "-x509", "-newkey", "rsa:2048", "-nodes", "-keyout", str(d / "ca.key"),
             "-out", str(d / "ca.crt"), "-days", "1", "-subj", "/CN=test-ca")
    for name, cn in (("server", "localhost"), ("client", "test-client")):
        _openssl("req", "-newkey", "rsa:2048", "-nodes", "-keyout", str(d / f"{name}.key"),
                 "-out", str(d / f"{name}.csr"), "-subj", f"/CN={cn}")
        ext = d / f"{name}.ext"
        ext.write_text("subjectAltName=DNS:localhost,IP:127.0.0.1\n")
        _openssl("x509", "-req", "-in", str(d / f"{name}.csr"), "-CA", str(d / "ca.crt"),
                 "-CAkey", str(d / "ca.key"), "-CAcreateserial", "-days", "1",
                 "-extfile", str(ext), "-out", str(d / f"{name}.crt"))
    return d


def _ssl_config(pki, tmp_path, client_verify=False) -> str:
    def pem(name):  # inline PEM contents, escaped for text format
        return (pki / name).read_text().replace("\n", "\\n")

    body = f'server_key: "{pem("server.key")}"\nserver_cert: "{pem("server.crt")}"\n'
    if client_verify:
        body += f'custom_ca: "{pem("ca.crt")}"\nclient_verify: true\n'
    cfg = tmp_path / "ssl.pbtxt"
    cfg.write_text(body)
    return str(cfg)


def _scores(target, creds, arrays):
    with grpc.secure_channel(target, creds) as ch:
        resp = PredictionServiceStub(ch).Predict(_req(arrays), timeout=30)
    return codec.to_ndarray(resp.outputs["prediction_node"])


def test_tls_serves_and_rejects_plaintext(pki, port_stack, tmp_path):
    impl, _, batcher = port_stack
    server, port = create_server(impl, "localhost:0",
                                 credentials=load_ssl_credentials(_ssl_config(pki, tmp_path)))
    server.start()
    try:
        arrays = _arrays(5, 1)
        creds = grpc.ssl_channel_credentials(root_certificates=(pki / "ca.crt").read_bytes())
        got = _scores(f"localhost:{port}", creds, arrays)
        want = impl.predict(_req(arrays)).outputs["prediction_node"]
        np.testing.assert_array_equal(got, codec.to_ndarray(want))
        with grpc.insecure_channel(f"localhost:{port}") as ch:
            with pytest.raises(grpc.RpcError):
                PredictionServiceStub(ch).Predict(_req(arrays), timeout=10)
    finally:
        server.stop(0)


def test_mtls_requires_a_client_certificate(pki, port_stack, tmp_path):
    impl, _, _ = port_stack
    creds = load_ssl_credentials(_ssl_config(pki, tmp_path, client_verify=True))
    server, port = create_server(impl, "localhost:0", credentials=creds)
    server.start()
    try:
        arrays = _arrays(3, 2)
        no_cert = grpc.ssl_channel_credentials(root_certificates=(pki / "ca.crt").read_bytes())
        with pytest.raises(grpc.RpcError):
            _scores(f"localhost:{port}", no_cert, arrays)
        with_cert = grpc.ssl_channel_credentials(
            root_certificates=(pki / "ca.crt").read_bytes(),
            private_key=(pki / "client.key").read_bytes(),
            certificate_chain=(pki / "client.crt").read_bytes())
        got = _scores(f"localhost:{port}", with_cert, arrays)
        np.testing.assert_array_equal(
            got, codec.to_ndarray(impl.predict(_req(arrays)).outputs["prediction_node"]))
    finally:
        server.stop(0)


def test_a_unix_socket_beside_tls_is_refused(pki, port_stack, tmp_path):
    impl, _, _ = port_stack
    creds = load_ssl_credentials(_ssl_config(pki, tmp_path))
    with pytest.raises(ValueError, match="uds_path cannot be combined"):
        create_server(impl, "localhost:0", uds_path=str(tmp_path / "s.sock"), credentials=creds)


def test_ssl_config_validation(pki, tmp_path):
    bad = tmp_path / "bad.pbtxt"
    bad.write_text('server_key: "k"\n')
    with pytest.raises(ValueError, match="server_key and server_cert"):
        load_ssl_credentials(bad)
    bad.write_text('server_key: "k"\nserver_cert: "c"\nclient_verify: true\n')
    with pytest.raises(ValueError, match="client_verify requires custom_ca"):
        load_ssl_credentials(bad)


# ------------------------------------------------------------ graceful drain

def _slow_device_stage(batcher, gate: threading.Event, started: threading.Event | None = None,
                       sleep_s: float = 0.0):
    real = batcher._issue

    def slow(*a, **k):
        if started is not None:
            started.set()
        gate.wait(5.0)
        time.sleep(sleep_s)
        return real(*a, **k)

    batcher._issue = slow


def test_graceful_drain_answers_accepted_work_and_refuses_new(port_stack):
    impl, sv, batcher = port_stack
    release = threading.Event()
    _slow_device_stage(batcher, release)
    gs = GracefulShutdown(impl, batcher, grace_s=10.0)
    futs = [batcher.submit(sv, _arrays(4, seed=i)) for i in range(3)]
    t = threading.Thread(target=gs.shutdown)
    t.start()
    try:
        for _ in range(500):
            if impl.draining:
                break
            time.sleep(0.01)
        assert impl.draining
        with pytest.raises(ServiceError) as e:
            impl.predict(_req(_arrays(2)))
        assert e.value.code == "UNAVAILABLE" and "draining" in str(e.value)
        assert GrpcHealthService(impl)._status("") == health_proto.NOT_SERVING
        release.set()
        t.join(timeout=30)
        assert not t.is_alive() and gs.drained is True
        for f in futs:  # every accepted request was answered
            assert f.result(timeout=1)["prediction_node"].shape == (4,)
    finally:
        release.set()


def test_drain_grace_expiry_reports_undrained(port_stack):
    impl, sv, batcher = port_stack
    started, gate = threading.Event(), threading.Event()
    gate.set()
    _slow_device_stage(batcher, gate, started, sleep_s=0.5)
    gs = GracefulShutdown(impl, batcher, grace_s=0.05)
    fut = batcher.submit(sv, _arrays(4))
    assert started.wait(10.0)
    gs.shutdown()
    assert gs.drained is False  # the grace ran out with work in flight
    assert fut.result(timeout=10)["prediction_node"].shape == (4,)


def test_sigterm_runs_the_drain(port_stack):
    impl, _, batcher = port_stack
    gs = GracefulShutdown(impl, batcher, grace_s=2.0)
    old = signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)
    assert gs.install_signal_handler()
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        assert gs._done.wait(20.0)
        assert impl.draining and gs.drained is True
        gs.shutdown()  # idempotent: returns at once
    finally:
        signal.signal(signal.SIGTERM, old[0])
        signal.signal(signal.SIGINT, old[1])


class _Context:
    def __init__(self, remaining):
        self._remaining = remaining

    def time_remaining(self):
        return self._remaining


def test_transport_quiesce_holds_rpcs_until_released():
    q = TransportQuiesce()
    t0 = time.monotonic()
    q.hold(_Context(None))  # not settling: returns at once
    assert time.monotonic() - t0 < 0.05
    assert q.settle(5.0) < 1.0  # nothing arrives: quiet after QUIET_S
    done = threading.Event()
    held = threading.Thread(target=lambda: (q.hold(_Context(None)), done.set()))
    held.start()
    assert not done.wait(0.2)  # held while the transport settles
    t0 = time.monotonic()
    q.hold(_Context(0.15))  # ... but never into the last margin of its deadline
    assert 0.05 <= time.monotonic() - t0 < 0.5
    q.release()
    assert done.wait(5.0)
    held.join()
    # An arrival resets the quiet clock; the budget bounds the settle.
    q2 = TransportQuiesce()
    stop = threading.Event()

    def arrivals():
        while not stop.is_set():
            threading.Thread(target=q2.hold, args=(_Context(None),), daemon=True).start()
            time.sleep(0.01)

    feeder = threading.Thread(target=arrivals)
    feeder.start()
    try:
        assert 0.3 <= q2.settle(0.3) < 2.0
    finally:
        stop.set()
        feeder.join()
        q2.release()


def test_shutdown_under_traffic_answers_ok_or_unavailable_only():
    """Four clients send Predicts with no pause between them while the
    server drains and stops: every call answers OK or UNAVAILABLE (gRPC
    core would cancel a call still on the wire when the transport stops,
    CANCELLED)."""
    for round_ in range(3):
        registry = ServableRegistry()
        sv = load_demo_servable(registry, kind="dcn_v2", config=CFG, device="cpu")
        batcher = DynamicBatcher(buckets=(8, 32), max_wait_us=0, device="cpu").start()
        impl = PredictionServiceImpl(registry, batcher)
        gs = GracefulShutdown(impl, batcher, grace_s=5.0)
        server, port = create_server(impl, "127.0.0.1:0", quiesce=gs.quiesce)
        server.start()
        gs.server = server
        codes, lock, stop = [], threading.Lock(), threading.Event()
        req = _req(_arrays(4, seed=round_))

        def client():
            with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
                stub = PredictionServiceStub(ch)
                while not stop.is_set():
                    try:
                        stub.Predict(req, timeout=30)
                        code = "OK"
                    except grpc.RpcError as e:
                        code = e.code().name
                    with lock:
                        codes.append(code)

        clients = [threading.Thread(target=client) for _ in range(4)]
        for t in clients:
            t.start()
        try:
            time.sleep(0.3)
            gs.shutdown()
            time.sleep(0.2)  # clients keep calling the stopped server
        finally:
            stop.set()
            for t in clients:
                t.join(timeout=30)
            server.stop(None)
            batcher.stop()
        assert gs.drained is True
        assert "OK" in codes and "UNAVAILABLE" in codes
        assert set(codes) <= {"OK", "UNAVAILABLE"}, sorted(set(codes))
        del sv


def test_batcher_drain_waits_for_queue_staging_and_readback():
    registry = ServableRegistry()
    sv = load_demo_servable(registry, kind="dcn_v2", config=CFG, device="cpu")
    batcher = DynamicBatcher(buckets=(8,), max_wait_us=0, device="cpu")
    fut = batcher.submit(sv, _arrays(3))
    assert batcher.drain(0.2) is False  # never started: nothing will run it
    batcher.start()
    try:
        assert batcher.drain(30.0) is True and fut.done()
        assert batcher.drain(0.0) is True  # idle
    finally:
        batcher.stop()


# --------------------------------------------------------------------- CLI

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_serving(ch, proc, timeout=90):
    grpc.channel_ready_future(ch).result(timeout=timeout)
    end = time.time() + timeout
    while HealthStub(ch).Check(HealthCheckRequest(service="")).status != health_proto.SERVING:
        assert proc.poll() is None and time.time() < end
        time.sleep(0.1)


def test_cli_multi_model_flags_reload_request_log_and_sigterm_drain(tmp_path):
    """The CLI with --model-config-file, --batching-parameters-file,
    --request-log-file and the watcher flags: both models answer, a reload
    over ModelServiceStub drops one, SIGTERM drains (the [overload]
    drain_grace_s of the config) and the server exits 0; the request log
    replays."""
    from google.protobuf import text_format

    for name, kind, seed in (("A", "dcn_v2", 0), ("B", "deepfm", 1)):
        model_cfg = dataclasses.replace(CFG, name=name)
        sv = load_demo_servable(ServableRegistry(), kind=kind, name=name, seed=seed,
                                config=model_cfg, device="cpu")
        save_servable(tmp_path / name.lower() / "1", sv, kind)
    msc = apis.ModelServerConfig()
    for name in ("A", "B"):
        mc = msc.model_config_list.config.add(name=name, base_path=str(tmp_path / name.lower()))
        if name == "A":
            mc.version_labels["stable"] = 1
    (tmp_path / "models.config").write_text(text_format.MessageToString(msc))
    (tmp_path / "batching.pbtxt").write_text(
        "allowed_batch_sizes: 8\nallowed_batch_sizes: 32\nbatch_timeout_micros { value: 0 }\n")
    cfg = _toml(tmp_path, "[server]\nnum_fields = 6\n[overload]\ndrain_grace_s = 2.5\n")
    port = _free_port()
    log_path = tmp_path / "requests.log"
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_tf_serving_tpu_torch.serving.server", "--config",
         str(cfg), "--host", "127.0.0.1", "--port", str(port), "--device", "cpu",
         "--model-config-file", str(tmp_path / "models.config"),
         "--batching-parameters-file", str(tmp_path / "batching.pbtxt"),
         "--request-log-file", str(log_path), "--request-log-sampling", "1.0",
         "--file-system-poll-wait-seconds", "0.5", "--max-num-load-retries", "1",
         "--max-workers", "4", "--no-warmup"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
            _wait_serving(ch, proc)
            stub = PredictionServiceStub(ch)
            a = _req(_arrays(5, 0))
            a.model_spec.name, a.model_spec.version_label = "A", "stable"
            b = _req(_arrays(3, 1))
            b.model_spec.name = "B"
            assert stub.Predict(a, timeout=30).model_spec.version.value == 1
            assert stub.Predict(b, timeout=30).model_spec.name == "B"
            reload = apis.ReloadConfigRequest()
            reload.config.model_config_list.config.add(name="A",
                                                       base_path=str(tmp_path / "a"))
            ModelServiceStub(ch).HandleReloadConfigRequest(reload, timeout=60)
            with pytest.raises(grpc.RpcError) as e:
                stub.Predict(b, timeout=30)
            assert e.value.code() == grpc.StatusCode.NOT_FOUND
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, out
        assert "SIGTERM: draining (grace 2.5s)" in out
        assert "shutdown complete (drained=True" in out
        assert "reload: removed model 'B'" in out and "request logging to" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    records = [apis.PredictionLog.FromString(r) for r in warmup.read_tfrecords(log_path)]
    assert [r.predict_log.request.model_spec.name for r in records] == ["A", "B"]


def test_cli_refuses_a_version_label_beside_a_model_config_file(tmp_path):
    (tmp_path / "m.config").write_text(
        f'model_config_list {{ config {{ name: "A" base_path: "{tmp_path}" }} }}\n')
    res = subprocess.run(
        [sys.executable, "-m", "distributed_tf_serving_tpu_torch.serving.server", "--device",
         "cpu", "--port", "0", "--model-config-file", str(tmp_path / "m.config"),
         "--version-label", "stable=1"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and "version_labels have no meaning" in res.stderr


def test_cli_serves_with_mesh(tmp_path):
    """[mesh] enabled = true on the CLI: the stack serves over the mesh of
    its device (one CPU shard here), /meshz answers it and the
    dts_tpu_mesh_* series are in the Prometheus text."""
    import json
    import urllib.request

    cfg = _toml(tmp_path, "[server]\nnum_fields = 6\nbuckets = [8]\nmax_wait_us = 0\n"
                "[model]\nnum_fields = 6\nvocab_size = 1024\nembed_dim = 4\nmlp_dims = [8]\n"
                "num_cross_layers = 1\n[mesh]\nenabled = true\n")
    port, rest_port = _free_port(), _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_tf_serving_tpu_torch.serving.server", "--config",
         str(cfg), "--host", "127.0.0.1", "--port", str(port), "--device", "cpu",
         "--rest-port", str(rest_port)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
            _wait_serving(ch, proc)
            resp = PredictionServiceStub(ch).Predict(_req(_arrays(3, 5)), timeout=30)
            assert codec.to_ndarray(resp.outputs["prediction_node"]).shape == (3,)
            end = time.time() + 60
            while True:
                try:
                    with urllib.request.urlopen(f"http://127.0.0.1:{rest_port}/meshz",
                                                timeout=5) as r:
                        meshz = json.loads(r.read())
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{rest_port}/monitoring/prometheus/metrics",
                            timeout=5) as r:
                        prom = r.read().decode()
                    break
                except OSError:
                    assert proc.poll() is None and time.time() < end
                    time.sleep(0.1)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert meshz["enabled"] and meshz["shape"] == {"data": 1, "model": 1}
    assert meshz["executor"]["batches"] >= 1 and meshz["devices"] == ["cpu"]
    assert "dts_tpu_mesh_batches_total" in prom
    assert "mesh serving mode on:" in out


@pytest.mark.parametrize("flag,extra,message", [
    ("--mesh", ["--model-parallel", "0"], "model_parallel must be >= 1"),
    ("--elastic", ["--mesh-devices", "3", "--model-parallel", "2"], "not divisible"),
])
def test_mesh_flags_parse(flag, extra, message):
    """--mesh and --elastic parse, and the geometry flags beside them reach
    the [mesh] section (whose checks refuse these values before any stack
    is built)."""
    from distributed_tf_serving_tpu_torch.serving.server import serve

    with pytest.raises(ValueError, match=message):
        serve(["--device", "cpu", flag] + extra)


def test_cli_cache_flag_arms_the_store(tmp_path):
    """--cache arms the score cache ([cache] enabled = true): /cachez
    answers enabled, and a repeated Predict is a hit."""
    import json
    import urllib.request

    cfg = _toml(tmp_path, "[server]\nnum_fields = 6\nbuckets = [8]\nmax_wait_us = 0\n"
                "[model]\nnum_fields = 6\nvocab_size = 1024\nembed_dim = 4\nmlp_dims = [8]\n"
                "num_cross_layers = 1\n")
    port, rest_port = _free_port(), _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_tf_serving_tpu_torch.serving.server", "--config",
         str(cfg), "--host", "127.0.0.1", "--port", str(port), "--device", "cpu",
         "--rest-port", str(rest_port), "--cache"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
            _wait_serving(ch, proc)
            stub = PredictionServiceStub(ch)
            first = stub.Predict(_req(_arrays(3, 5)), timeout=30)
            again = stub.Predict(_req(_arrays(3, 5)), timeout=30)
            assert first.outputs["prediction_node"] == again.outputs["prediction_node"]
            end = time.time() + 60
            while True:
                try:
                    with urllib.request.urlopen(f"http://127.0.0.1:{rest_port}/cachez",
                                                timeout=5) as r:
                        cachez = json.loads(r.read())
                    break
                except OSError:
                    assert proc.poll() is None and time.time() < end
                    time.sleep(0.1)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert cachez["enabled"] and cachez["hits"] == 1 and cachez["misses"] == 1
    assert "score cache on:" in out


# (flag, the log line of the armed plane, the REST route whose block shows it)
PLANE_FLAGS = [
    ("--overload", "adaptive overload control on:", "/monitoring?section=overload"),
    ("--integrity", "data-integrity plane on:", "/integrityz"),
    ("--cascade", "cascade on:", "/cascadez"),
    ("--utilization", "utilization attribution on:", "/utilz"),
    ("--quality", "model-quality observability on:", "/qualityz"),
]


@pytest.mark.parametrize("flag,logged,route", PLANE_FLAGS, ids=[f for f, _, _ in PLANE_FLAGS])
def test_cli_plane_flag_arms_the_plane(tmp_path, flag, logged, route):
    """--overload, --integrity, --cascade, --utilization and --quality each
    arm their plane with no section in the config (as [<plane>] enabled =
    true would): the plane's REST block answers, and an output-filtered
    Predict of 8 rows runs through it (with --cascade it carries
    `cascade_stage`, 2 rows ranked; the ledger counts its batch, the quality
    monitor its 8 scores)."""
    import json
    import urllib.request

    cfg = _toml(tmp_path, "[server]\nnum_fields = 6\nbuckets = [8]\nmax_wait_us = 0\n"
                "[model]\nnum_fields = 6\nvocab_size = 1024\nembed_dim = 4\nmlp_dims = [8]\n"
                "num_cross_layers = 1\n")
    port, rest_port = _free_port(), _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_tf_serving_tpu_torch.serving.server", "--config",
         str(cfg), "--host", "127.0.0.1", "--port", str(port), "--device", "cpu",
         "--rest-port", str(rest_port), flag],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
            _wait_serving(ch, proc)
            req = _req(_arrays(8, 6))
            req.output_filter.append("prediction_node")
            resp = PredictionServiceStub(ch).Predict(req, timeout=30)
            assert codec.to_ndarray(resp.outputs["prediction_node"]).shape == (8,)
            end = time.time() + 60
            while True:
                try:
                    with urllib.request.urlopen(f"http://127.0.0.1:{rest_port}{route}",
                                                timeout=5) as r:
                        block = json.loads(r.read())
                    break
                except OSError:
                    assert proc.poll() is None and time.time() < end
                    time.sleep(0.1)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert logged in out
    if flag == "--cascade":
        stage = codec.to_ndarray(resp.outputs["cascade_stage"])
        assert stage.dtype == np.int32 and int((stage == 2).sum()) == 2
        assert block["requests"] == 1 and block["host_prunes"] == 0 and block["fallbacks"] == 0
        return
    assert "cascade_stage" not in resp.outputs
    if flag == "--overload":
        assert block["overload"]["state"] == "nominal"
    elif flag == "--utilization":
        assert block["enabled"] and block["batches"] == 1 and block["in_flight"] == 0
        assert block["device"] == "cpu" and not block["calibrated"]
    elif flag == "--quality":
        assert block["enabled"] and block["observed_requests"] == 1
        assert block["models"]["DCN"]["versions"]["1"]["count"] == 8
    else:
        assert block["enabled"] and block["wire"]["inputs_verified"] == 0


# ------------------------------------- the observability settings now serve

def test_observability_tracing_true_arms_the_recorder(tmp_path):
    from distributed_tf_serving_tpu_torch.utils import tracing

    loaded = load_config(_toml(tmp_path, "[observability]\ntracing = true\ntrace_buffer = 8\n"))
    obs = loaded["observability"]
    assert obs == torch_config.ObservabilityConfig(tracing=True, trace_buffer=8)
    try:
        rec = obs.apply()
        assert tracing.enabled() and rec is tracing.recorder() and rec.buffer_size == 8
    finally:
        tracing.disable()
    assert not tracing.enabled()


def test_observability_trace_export_true_loads_as_in_the_jax_package(tmp_path):
    text = "[observability]\ntrace_export = true\ntrace_export_interval_s = 0.5\n"
    assert load_config(_toml(tmp_path, text))["observability"].trace_export
    assert jax_config.load_config(_toml(tmp_path, text))["observability"].trace_export
    with pytest.raises(ValueError, match="trace_export_interval_s"):
        load_config(_toml(tmp_path, "[observability]\ntrace_export_interval_s = 0\n"))


@pytest.fixture(scope="module")
def telemetry_cli(tmp_path_factory):
    """One CLI server with --rest-port, --metrics-every-s and --tracing: a
    REST Predict and a traced gRPC Predict, then SIGTERM. Yields (the REST
    response, the /tracez body, the server's log). `--rest-port 0` means no
    gateway (as in the JAX server), so the test picks a free port."""
    import json
    import urllib.request

    tmp_path = tmp_path_factory.mktemp("telemetry")
    cfg = _toml(tmp_path, "[server]\nnum_fields = 6\nbuckets = [8]\nmax_wait_us = 0\n"
                "[model]\nnum_fields = 6\nvocab_size = 1024\nembed_dim = 4\nmlp_dims = [8]\n"
                "num_cross_layers = 1\n")
    port, rest_port = _free_port(), _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_tf_serving_tpu_torch.serving.server", "--config",
         str(cfg), "--host", "127.0.0.1", "--port", str(port), "--device", "cpu",
         "--rest-port", str(rest_port), "--metrics-every-s", "0.2", "--tracing"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    trace_id = "4bf92f3577b34da6a3ce929d0e0e4736"
    try:
        with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
            _wait_serving(ch, proc)
            # The gateway binds after the gRPC port serves.
            end = time.time() + 60
            while True:
                try:
                    socket.create_connection(("127.0.0.1", rest_port), timeout=1).close()
                    break
                except OSError:
                    assert proc.poll() is None and time.time() < end
                    time.sleep(0.1)
            arrays = _arrays(3, 0)
            body = json.dumps({"instances": [
                {k: v[i].tolist() for k, v in arrays.items()} for i in range(3)]}).encode()
            with urllib.request.urlopen(urllib.request.Request(
                    f"http://127.0.0.1:{rest_port}/v1/models/DCN:predict", data=body,
                    method="POST"), timeout=30) as r:
                rest = json.loads(r.read())
            _, call = PredictionServiceStub(ch).Predict.with_call(
                _req(arrays), timeout=30,
                metadata=(("traceparent", f"00-{trace_id}-00f067aa0ba902b7-01"),))
            initial = dict(call.initial_metadata())
            with urllib.request.urlopen(f"http://127.0.0.1:{rest_port}/tracez",
                                        timeout=30) as r:
                tracez = json.loads(r.read())
            time.sleep(0.5)  # at least one metrics line after the traffic
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    yield {"rest": rest, "tracez": tracez, "log": out, "trace_id": trace_id,
           "initial_metadata": initial}


def test_cli_rest_port_answers_a_rest_predict(telemetry_cli):
    preds = telemetry_cli["rest"]["predictions"]  # one object per row: two outputs
    assert len(preds) == 3 and all(0.0 < p["prediction_node"] < 1.0 for p in preds)
    assert "REST gateway on 127.0.0.1:" in telemetry_cli["log"]


def test_cli_metrics_every_s_logs_a_metrics_line(telemetry_cli):
    import json

    lines = [ln.split(" metrics ", 1)[1] for ln in telemetry_cli["log"].splitlines()
             if " metrics {" in ln]
    assert lines
    last = json.loads(lines[-1])
    assert last["rpcs"]["REST.Predict"]["ok"] == 1 and last["rpcs"]["Predict"]["ok"] == 1
    assert last["batcher"]["requests"] >= 2 and last["phases"]["batch.dispatch"]["count"] >= 2


def test_cli_metrics_line_shows_the_codec_decode_routes(telemetry_cli):
    import json

    lines = [ln.split(" metrics ", 1)[1] for ln in telemetry_cli["log"].splitlines()
             if " metrics {" in ln]
    decode = json.loads(lines[-1])["decode"]
    assert set(decode) == {"packed", "walked"}
    assert all(isinstance(v, int) and v >= 0 for v in decode.values())


def test_cli_tracing_records_a_tracez_trace(telemetry_cli):
    tracez = telemetry_cli["tracez"]
    assert tracez["enabled"]
    assert telemetry_cli["initial_metadata"]["x-dts-peer-role"] == "replica"
    traces = {t["trace_id"]: t for t in tracez["traces"]}
    root = traces[telemetry_cli["trace_id"]]["spans"][0]
    assert root["name"] == "server.Predict"
    # The service's phases and the batch's replayed ones are all children.
    names = {c["name"] for c in root["children"]}
    assert {"predict.decode", "predict.execute", "predict.encode", "batch.queue_wait",
            "batch.dispatch", "readback.wait"} <= names
    assert any(s["spans"][0]["name"] == "server.REST.Predict" for s in tracez["traces"])
