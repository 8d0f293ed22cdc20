"""The port's tracing plane (distributed_tf_serving_tpu_torch/utils/
tracing.py) against the JAX package's on the CPU: the traceparent codec,
span trees built the same way in both (the /tracez body's shape and
names), the Chrome export, a Predict through each package's service under
a root span (the same span names), and the two packages' module state kept
apart."""

import json
import threading
import time

import jax
import numpy as np
import pytest

from distributed_tf_serving_tpu.models import ModelConfig as JaxConfig
from distributed_tf_serving_tpu.models import Servable as JaxServable
from distributed_tf_serving_tpu.models import ServableRegistry as JaxRegistry
from distributed_tf_serving_tpu.models import build_model as jax_build
from distributed_tf_serving_tpu.models import ctr_signatures as jax_signatures
from distributed_tf_serving_tpu.serving import DynamicBatcher as JaxBatcher
from distributed_tf_serving_tpu.serving import PredictionServiceImpl as JaxImpl
from distributed_tf_serving_tpu.utils import tracing as jax_tracing
from distributed_tf_serving_tpu_torch import codec
from distributed_tf_serving_tpu_torch.convert import params_from_jax
from distributed_tf_serving_tpu_torch.models import (
    ModelConfig,
    Servable,
    ServableRegistry,
    build_model,
    ctr_signatures,
)
from distributed_tf_serving_tpu_torch.proto import serving_apis_pb2 as apis
from distributed_tf_serving_tpu_torch.serving.batcher import DynamicBatcher
from distributed_tf_serving_tpu_torch.serving.service import PredictionServiceImpl
from distributed_tf_serving_tpu_torch.utils import tracing

F = 6
KW = dict(num_fields=F, vocab_size=1 << 12, embed_dim=8, mlp_dims=(16,), num_cross_layers=2)
TRACE = "4bf92f3577b34da6a3ce929d0e0e4736"
WAIT = 60  # seconds: every join in this file


@pytest.fixture(autouse=True)
def both_off():
    tracing.disable()
    jax_tracing.disable()
    yield
    tracing.disable()
    jax_tracing.disable()


HEADERS = [
    None, "", f"00-{TRACE}-00f067aa0ba902b7-01", f"00-{TRACE.upper()}-00F067AA0BA902B7-00",
    f" 00-{TRACE}-00f067aa0ba902b7-01 ", f"00-{'0' * 32}-00f067aa0ba902b7-01",
    f"00-{TRACE}-{'0' * 16}-01", f"00-{TRACE}-00f067aa0ba902b7", f"00-{TRACE[:-1]}-00f067aa0ba902b7-01",
    f"00-{TRACE[:-1]}z-00f067aa0ba902b7-01", "garbage",
]


@pytest.mark.parametrize("header", HEADERS)
def test_parse_traceparent_equals_the_jax_package_s(header):
    assert tracing.parse_traceparent(header) == jax_tracing.parse_traceparent(header)


@pytest.mark.parametrize("sampled", [True, False])
def test_make_traceparent_equals_the_jax_package_s(sampled):
    got = tracing.make_traceparent(TRACE, "00f067aa0ba902b7", sampled)
    assert got == jax_tracing.make_traceparent(TRACE, "00f067aa0ba902b7", sampled)
    assert tracing.parse_traceparent(got) == (TRACE, "00f067aa0ba902b7")


def _build_trees(mod):
    """Three local roots: a remote-parented one with nested children, an
    interval and an annotation; a fresh root that fails; an untraced
    phase."""
    with mod.start_root("server.Predict", traceparent=f"00-{TRACE}-00f067aa0ba902b7-01",
                        attrs={"entrypoint": "Predict"}) as root:
        with mod.start_span("predict.decode"):
            pass
        with mod.start_span("predict.execute", attrs={"n": 3}) as ex:
            ex.add_interval("batch.dispatch", ex.start, ex.start + 0.001)
        mod.annotate("fault", site="readback")
        mod.replay_phases(root, [("readback.wait", root.start, root.start + 0.002),
                                 {"t": root.start, "message": "replayed"}])
    with pytest.raises(ValueError):
        with mod.start_root("server.Classify"):
            with mod.start_span("predict.decode"):
                raise ValueError("bad input")
    with mod.start_span("orphan"):
        pass


def _shape(node):
    """A span dict without its ids and times."""
    return {
        "name": node["name"], "status": node["status"], "attrs": node["attrs"],
        "annotations": [{k: v for k, v in a.items() if k != "t"} for a in node["annotations"]],
        "children": [_shape(c) for c in node["children"]],
    }


def _tracez_shape(body):
    return {
        "config": body["config"], "recorded": body["recorded"], "dropped": body["dropped"],
        "num_retained": body["num_retained"],
        "slowest": sorted(json.dumps(_shape(s), sort_keys=True) for s in body["slowest"]),
        "traces": sorted(json.dumps({"status": t["status"],
                                     "spans": [_shape(s) for s in t["spans"]]}, sort_keys=True)
                         for t in body["traces"]),
        "remote": sorted(t["trace_id"] for t in body["traces"] if t["trace_id"] == TRACE),
    }


def test_span_trees_give_the_jax_package_s_tracez():
    trec = tracing.enable(buffer_size=8, slowest_n=2, seed=1)
    jrec = jax_tracing.enable(buffer_size=8, slowest_n=2, seed=1)
    _build_trees(tracing)
    _build_trees(jax_tracing)
    got, want = trec.tracez(limit=10), jrec.tracez(limit=10)
    assert set(got) == set(want)
    assert _tracez_shape(got) == _tracez_shape(want)
    assert got["recorded"] == 3 and _tracez_shape(got)["remote"] == [TRACE]
    export = trec.export_since(0)
    assert export["enabled"] and export["cursor"] == 3 and len(export["spans"]) == 3
    assert set(export) == set(jrec.export_since(0))
    assert trec.export_since(export["cursor"])["spans"] == []


def test_the_chrome_export_is_valid(tmp_path):
    rec = tracing.enable()
    _build_trees(tracing)
    doc = json.loads(json.dumps(rec.chrome_trace()))
    events = doc["traceEvents"]
    assert {e["ph"] for e in events} == {"M", "X", "i"}
    assert all(e["ts"] >= 0 and e["dur"] >= 0 for e in events if e["ph"] == "X")
    assert {e["name"] for e in events if e["ph"] == "X"} >= {
        "server.Predict", "predict.decode", "predict.execute", "batch.dispatch",
        "readback.wait", "server.Classify", "orphan"}
    assert doc["otherData"]["producer"] == "distributed_tf_serving_tpu_torch"
    n = rec.write_chrome_trace(str(tmp_path / "t.json"))
    assert n == len(events) == len(json.loads((tmp_path / "t.json").read_text())["traceEvents"])


def test_enabling_one_package_leaves_the_other_off():
    tracing.enable()
    assert tracing.enabled() and not jax_tracing.enabled()
    with jax_tracing.start_root("jax.only") as sp:
        assert sp is None
    tracing.disable()
    jax_tracing.enable()
    assert jax_tracing.enabled() and not tracing.enabled()
    with tracing.start_root("port.only") as sp:
        assert sp is None
    assert tracing.recorder() is not jax_tracing.recorder()
    assert tracing.request_trace is not jax_tracing.request_trace


def _burn(cpu_s: float) -> None:
    """Spin until this thread has used `cpu_s` CPU seconds."""
    end = time.thread_time() + cpu_s
    while time.thread_time() < end:
        pass


def test_a_phase_records_its_thread_and_cpu_only_while_the_plane_is_on(monkeypatch):
    trace = tracing.PhaseTrace()
    sink: list = []

    def no_clock():
        raise AssertionError("read with the plane off")

    # Off: the aggregate only; no thread or CPU clock is read, nothing lands
    # in a phase sink, and no span opens.
    with monkeypatch.context() as m:
        m.setattr(tracing.time, "thread_time", no_clock)
        m.setattr(tracing.threading, "get_native_id", no_clock)
        with tracing.collect_phases(sink):
            with trace.span("off") as t0:
                assert t0 <= time.perf_counter()
        with tracing.start_root("server.Predict") as root:
            assert root is None
    assert sink == [] and trace.snapshot()["off"]["count"] == 1
    # On: into a sink, the thread and the CPU seconds of the block.
    tracing.enable()
    with tracing.collect_phases(sink):
        with trace.span("busy"):
            _burn(0.03)
        with trace.span("idle"):
            time.sleep(0.03)
    (busy, b0, b1, bthread, bcpu), (idle, i0, i1, ithread, icpu) = sink
    me = (threading.get_native_id(), threading.current_thread().name)
    assert (busy, idle) == ("busy", "idle") and bthread == ithread == me
    assert bcpu >= 0.03 and icpu < 0.5 * (i1 - i0)
    # On: onto the context span.
    rec = tracing.recorder()
    with tracing.start_root("server.Predict"):
        with trace.span("predict.decode"):
            _burn(0.005)
    (root,) = rec.export_since(0)["spans"]
    (decode,) = root["children"]
    assert decode["tid"] == me[0] and decode["thread"] == me[1] and "wait" not in decode
    assert 0 < decode["cpu_us"] <= decode["duration_us"] + 1000
    assert not {"tid", "thread", "cpu_us", "wait"} & set(root)


def test_replayed_phases_keep_their_thread_cpu_and_batch():
    tracing.enable()
    with tracing.start_root("server.Predict") as root:
        pass
    thread = (7, "batch-dispatch")
    tracing.replay_phases(root, [("batch.dispatch", 1.0, 1.5, thread, 0.25),
                                 ("bare", 2.0, 2.5)], {"batch": 3, "bucket": 64, "rows": 40})
    dispatch, bare = root.children
    assert (dispatch.thread, dispatch.cpu_s, dispatch.attrs) == (
        thread, 0.25, {"batch": 3, "bucket": 64, "rows": 40})
    assert bare.thread is None and bare.cpu_s is None and bare.attrs["batch"] == 3
    assert dispatch.attrs is not bare.attrs


def test_thread_cpu_sums_each_role_under_the_process_total():
    stop = threading.Event()
    names = ["rpc_0", "rpc_1", "batcher", "batch-dispatch", "batch-complete_0", "sampler"]
    burnt = threading.Barrier(len(names) + 1)

    def work():
        _burn(0.02)
        burnt.wait(WAIT)
        stop.wait(WAIT)

    ts = [threading.Thread(target=work, name=n, daemon=True) for n in names]
    for t in ts:
        t.start()
    try:
        burnt.wait(WAIT)  # every thread has used its CPU and is still alive
        got = tracing.thread_cpu()
    finally:
        stop.set()
        for t in ts:
            t.join(WAIT)
    assert not any(t.is_alive() for t in ts)
    assert set(got) == set(tracing.THREAD_ROLES) | {"process"}
    assert got["rpc"] >= 0.04 and got["other"] >= 0.02
    for role in ("batcher", "batch-dispatch", "batch-complete"):
        assert got[role] >= 0.02, (role, got)
    assert sum(got[r] for r in tracing.THREAD_ROLES) <= got["process"]


def test_a_span_on_the_profiler_clock_holds_a_marker_opened_inside_it(tmp_path):
    """A program span placed on a torch.profiler trace's clock through
    clock_anchor() and the trace's baseTimeNanoseconds contains a
    record_function marker opened inside it, with 10 ms to spare each
    side."""
    import torch

    rec = tracing.enable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.start_root("server.Predict"):
            with tracing.request_trace.span("predict.decode"):
                time.sleep(0.01)
                with torch.profiler.record_function("inside"):
                    torch.ones(64) @ torch.ones(64)
                time.sleep(0.01)
    export = rec.export_since(0)
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    doc = json.loads((tmp_path / "t.json").read_text())
    (marker,) = [e for e in doc["traceEvents"] if e.get("name") == "inside"]
    clock = export["clock"]
    shift = clock["unix_us"] - clock["perf_us"] - int(doc.get("baseTimeNanoseconds", 0)) // 1000
    (decode,) = export["spans"][0]["children"]
    a = decode["start_us"] + shift
    b = a + decode["duration_us"]
    assert a <= float(marker["ts"]) and float(marker["ts"]) + float(marker["dur"]) <= b


def _services():
    jm = jax_build("dcn_v2", JaxConfig(name="DCN", **KW))
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    jreg = JaxRegistry()
    jreg.load(JaxServable(name="DCN", version=1, model=jm, params=jp,
                          signatures=jax_signatures(F)))
    treg = ServableRegistry()
    treg.load(Servable(name="DCN", version=1,
                       model=build_model("dcn_v2", ModelConfig(name="DCN", **KW)),
                       params=params_from_jax(jp, "cpu"), signatures=ctr_signatures(F)))
    # Both batchers with their device input cache (on by default): a batch
    # is looked up and packed under batch.cache on both sides.
    jb = JaxBatcher(buckets=(8,), max_wait_us=0).start()
    tb = DynamicBatcher(buckets=(8,), max_wait_us=0, device="cpu").start()
    return JaxImpl(jreg, jb), PredictionServiceImpl(treg, tb), (jb, tb)


# The phases of planes the port does not have yet, and the port's split of
# batch.queue_wait, which the JAX package does not make.
_UNPORTED = {"batch.shadow_dispatch"}
_PORT_ONLY = {"batch.collect_wait", "batch.stage_wait"}


def _names(span_dict) -> list[str]:
    return sorted(c["name"] for c in span_dict["children"]
                  if c["name"] not in _UNPORTED | _PORT_ONLY)


def test_a_predict_gives_the_jax_service_s_span_names():
    jimpl, timpl, batchers = _services()
    rng = np.random.RandomState(0)
    req = apis.PredictRequest()
    req.model_spec.name = "DCN"
    codec.from_ndarray(rng.randint(0, 1 << 40, size=(3, F)).astype(np.int64),
                       out=req.inputs["feat_ids"])
    codec.from_ndarray(rng.rand(3, F).astype(np.float32), out=req.inputs["feat_wts"])
    from distributed_tf_serving_tpu.proto import serving_apis_pb2 as jax_apis

    jreq = jax_apis.PredictRequest.FromString(req.SerializeToString())
    try:
        trec, jrec = tracing.enable(), jax_tracing.enable()
        header = f"00-{TRACE}-00f067aa0ba902b7-01"
        with tracing.start_root("server.Predict", traceparent=header):
            tresp = timpl.predict(req)
        with jax_tracing.start_root("server.Predict", traceparent=header):
            jresp = jimpl.predict(jreq)
    finally:
        for b in batchers:
            b.stop()
    np.testing.assert_allclose(codec.to_ndarray(tresp.outputs["prediction_node"]),
                               np.frombuffer(jresp.outputs["prediction_node"].tensor_content
                                             or np.float32(jresp.outputs["prediction_node"]
                                                           .float_val).tobytes(), np.float32),
                               atol=1e-5)
    (troot,) = trec.tracez()["traces"][0]["spans"]
    (jroot,) = jrec.tracez()["traces"][0]["spans"]
    assert troot["trace_id"] == jroot["trace_id"] == TRACE
    assert _names(troot) == _names(jroot)
    assert {"predict.decode", "predict.execute", "predict.encode", "batch.queue_wait",
            "batch.dispatch", "batch.cache", "readback.wait"} <= set(_names(troot))
