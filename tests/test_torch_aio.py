"""The port's coroutine gRPC server (serving/server.py create_server_async)
against the JAX package's on the CPU: each serves its own stack on the
same seed-0 weights (the port's through the converter), one event loop
drives both, and every answer must match — Predict, Classify, Regress and
MultiInference scores within 1e-5 (f32), the error codes of the JAX
package's aio test, health and metadata — while PredictStream's chunks,
with response_arena on and off, keep the bits of the unary answer (each
chunk kept as received, so a chunk message reused before gRPC serialized
it would show), and an open circuit breaker turns a call away
UNAVAILABLE."""

import asyncio
import time

import grpc
import grpc.aio
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
from distributed_tf_serving_tpu.serving.server import create_server_async as jax_create
from distributed_tf_serving_tpu_torch import codec, faults
from distributed_tf_serving_tpu_torch.convert import params_from_jax
from distributed_tf_serving_tpu_torch.models import (
    ModelConfig,
    Servable,
    ServableRegistry,
    build_model,
    ctr_signatures,
)
from distributed_tf_serving_tpu_torch.proto import (
    HealthCheckRequest,
    HealthStub,
    ModelServiceStub,
    PredictionServiceStub,
)
from distributed_tf_serving_tpu_torch.proto import health as health_proto
from distributed_tf_serving_tpu_torch.proto import serving_apis_pb2 as apis
from distributed_tf_serving_tpu_torch.serving import create_server_async
from distributed_tf_serving_tpu_torch.serving.batcher import DynamicBatcher
from distributed_tf_serving_tpu_torch.serving.example_codec import make_example
from distributed_tf_serving_tpu_torch.serving.service import PredictionServiceImpl
from distributed_tf_serving_tpu_torch.utils.metrics import ServerMetrics

F = 6
KW = dict(num_fields=F, vocab_size=1 << 12, embed_dim=8, mlp_dims=(16,), num_cross_layers=2,
          compute_dtype="float32")
BUCKETS = (32, 64, 256)
TOL = 1e-5


def _stacks(buckets=BUCKETS, **batcher_kw):
    """(JAX impl, port impl, stop) over the same seed-0 f32 weights."""
    jm = jax_build("dcn_v2", JaxConfig(name="DCN", **KW))
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    jreg = JaxRegistry()
    jreg.load(JaxServable(name="DCN", version=1, model=jm, params=jp,
                          signatures=jax_signatures(F)))
    # Both batchers with their device input cache (on by default).
    jb = JaxBatcher(buckets=buckets, max_wait_us=0).start()
    treg = ServableRegistry()
    treg.load(Servable(name="DCN", version=1,
                       model=build_model("dcn_v2", ModelConfig(name="DCN", **KW)),
                       params=params_from_jax(jp, "cpu"), signatures=ctr_signatures(F)))
    tb = DynamicBatcher(buckets=buckets, max_wait_us=0, device="cpu", **batcher_kw).start()

    def stop():
        faults.get().clear()
        jb.stop()
        tb.stop()

    return JaxImpl(jreg, jb), PredictionServiceImpl(treg, tb), stop


def _rows(n, seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 1 << 40, size=(n, F)).astype(np.int64),
            rng.rand(n, F).astype(np.float32))


def _predict_request(n, seed, name="DCN", tensor_content=True):
    ids, wts = _rows(n, seed)
    req = apis.PredictRequest()
    req.model_spec.name = name
    codec.from_ndarray(ids, use_tensor_content=tensor_content, out=req.inputs["feat_ids"])
    codec.from_ndarray(wts, use_tensor_content=tensor_content, out=req.inputs["feat_wts"])
    return req


def _input(n, seed):
    ids, wts = _rows(n, seed)
    inp = apis.Input()
    for i in range(n):
        inp.example_list.examples.append(make_example(ids[i], wts[i]))
    return inp


def _scores(resp):
    return codec.to_ndarray(resp.outputs["prediction_node"])


async def _serve_both(jimpl, timpl, body):
    """Start both aio servers on this loop, run body(port_ours, port_theirs),
    stop both."""
    ours, port = create_server_async(timpl, "127.0.0.1:0", ServerMetrics())
    theirs, jport = jax_create(jimpl, "127.0.0.1:0")
    await ours.start()
    await theirs.start()
    try:
        return await body(port, jport)
    finally:
        await ours.stop(0)
        await theirs.stop(0)


def _run(coro_fn, *args):
    return asyncio.run(coro_fn(*args))


def test_aio_answers_match_the_jax_aio_server():
    jimpl, timpl, stop = _stacks()

    async def body(port, jport):
        got = {}
        for which, p in (("ours", port), ("theirs", jport)):
            async with grpc.aio.insecure_channel(f"127.0.0.1:{p}") as ch:
                stub = PredictionServiceStub(ch)
                out = got[which] = {}
                for n, seed in ((5, 1), (40, 2), (200, 3)):
                    out[f"predict{n}"] = _scores(await stub.Predict(
                        _predict_request(n, seed), timeout=30))
                out["predict_repeated"] = _scores(await stub.Predict(
                    _predict_request(7, 4, tensor_content=False), timeout=30))
                inp = _input(9, 5)
                cls = await stub.Classify(apis.ClassificationRequest(
                    model_spec=apis.ModelSpec(name="DCN"), input=inp), timeout=30)
                out["classify"] = np.asarray(
                    [[c.score for c in cl.classes] for cl in cls.result.classifications])
                reg = await stub.Regress(apis.RegressionRequest(
                    model_spec=apis.ModelSpec(name="DCN"), input=inp), timeout=30)
                out["regress"] = np.asarray([r.value for r in reg.result.regressions])
                mreq = apis.MultiInferenceRequest(input=_input(6, 6))
                mreq.tasks.add(model_spec=apis.ModelSpec(name="DCN"),
                               method_name="tensorflow/serving/classify")
                mreq.tasks.add(model_spec=apis.ModelSpec(name="DCN"),
                               method_name="tensorflow/serving/regress")
                multi = await stub.MultiInference(mreq, timeout=30)
                out["multi_classify"] = np.asarray(
                    [[c.score for c in cl.classes]
                     for cl in multi.results[0].classification_result.classifications])
                out["multi_regress"] = np.asarray(
                    [r.value for r in multi.results[1].regression_result.regressions])
                out["multi_specs"] = [r.model_spec.version.value for r in multi.results]
        return got

    try:
        got = _run(_serve_both, jimpl, timpl, body)
    finally:
        stop()
    ours, theirs = got["ours"], got["theirs"]
    assert ours.keys() == theirs.keys()
    assert ours["multi_specs"] == theirs["multi_specs"] == [1, 1]
    for key in ours:
        if key == "multi_specs":
            continue
        assert ours[key].shape == theirs[key].shape, key
        np.testing.assert_allclose(ours[key], theirs[key], rtol=0, atol=TOL, err_msg=key)
    np.testing.assert_allclose(ours["classify"][:, 1], ours["regress"], rtol=0, atol=0)


def test_aio_error_codes_match_the_jax_aio_server():
    """The JAX package's aio cases (unknown model -> NOT_FOUND, a malformed
    tensor -> INVALID_ARGUMENT) and more, code for code."""
    jimpl, timpl, stop = _stacks()
    bad_count = _predict_request(4, 0, tensor_content=False)
    bad_count.inputs["feat_ids"].int64_val.append(0)
    both = _predict_request(4, 0)
    both.model_spec.version.value = 1
    both.model_spec.version_label = "stable"
    missing = _predict_request(4, 0)
    del missing.inputs["feat_wts"]
    cases = [
        ("Predict", _predict_request(4, 0, name="NOPE")),
        ("Predict", bad_count),
        ("Predict", both),
        ("Predict", missing),
        ("Predict", _predict_request(300, 0)),  # past the largest bucket
        ("Classify", apis.ClassificationRequest(model_spec=apis.ModelSpec(name="DCN"))),
        ("Regress", apis.RegressionRequest(model_spec=apis.ModelSpec(name="NOPE"),
                                           input=_input(2, 0))),
        ("MultiInference", apis.MultiInferenceRequest(input=_input(2, 0))),
        ("GetModelMetadata", apis.GetModelMetadataRequest(
            model_spec=apis.ModelSpec(name="NOPE"))),
    ]

    async def body(port, jport):
        codes = {}
        for which, p in (("ours", port), ("theirs", jport)):
            async with grpc.aio.insecure_channel(f"127.0.0.1:{p}") as ch:
                stub = PredictionServiceStub(ch)
                codes[which] = []
                for rpc, req in cases:
                    try:
                        await getattr(stub, rpc)(req, timeout=30)
                        codes[which].append(None)
                    except grpc.aio.AioRpcError as e:
                        codes[which].append(e.code())
        return codes

    try:
        codes = _run(_serve_both, jimpl, timpl, body)
    finally:
        stop()
    assert codes["ours"][:2] == [grpc.StatusCode.NOT_FOUND, grpc.StatusCode.INVALID_ARGUMENT]
    assert codes["ours"] == codes["theirs"]


@pytest.mark.parametrize("arena", [False, True])
def test_aio_stream_chunks_keep_the_unary_bits(arena):
    """PredictStream over the coroutine server, in 16-row chunks with and
    without response_arena: every chunk, kept as received, carries the bits
    of the unary answer's slice (one bucket, so both run the same shape)."""
    jimpl, timpl, stop = _stacks(buckets=(64,))
    timpl.response_arena = arena

    async def body(port, jport):
        async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as ch:
            stub = PredictionServiceStub(ch)
            req = _predict_request(60, 8)
            unary = _scores(await stub.Predict(req, timeout=30))
            chunks = [c async for c in stub.PredictStream(
                req, timeout=30, metadata=(("x-dts-stream-chunk", "16"),))]
            single = [c async for c in stub.PredictStream(req, timeout=30)]
        return unary, chunks, single

    try:
        unary, chunks, single = _run(_serve_both, jimpl, timpl, body)
    finally:
        stop()
    assert sorted((c.offset, c.count) for c in chunks) == [(0, 16), (16, 16), (32, 16), (48, 12)]
    assert sum(c.final for c in chunks) == 1 and all(c.total == 60 for c in chunks)
    for c in chunks:
        assert c.model_spec.name == "DCN" and c.model_spec.version.value == 1
        np.testing.assert_array_equal(_scores(c), unary[c.offset:c.offset + c.count])
    assert len(single) == 1 and single[0].final
    np.testing.assert_array_equal(_scores(single[0]), unary)
    if arena:
        assert timpl._arena() is not None  # this thread's; the loop thread had its own


def test_aio_health_metadata_and_status_answer():
    jimpl, timpl, stop = _stacks()

    async def body(port, jport):
        out = {}
        for which, p in (("ours", port), ("theirs", jport)):
            async with grpc.aio.insecure_channel(f"127.0.0.1:{p}") as ch:
                health = HealthStub(ch)
                r = out[which] = {}
                r["health"] = (await health.Check(HealthCheckRequest(service=""),
                                                  timeout=10)).status
                r["health_model"] = (await health.Check(HealthCheckRequest(service="DCN"),
                                                        timeout=10)).status
                try:
                    await health.Check(HealthCheckRequest(service="NOPE"), timeout=10)
                    r["health_unknown"] = None
                except grpc.aio.AioRpcError as e:
                    r["health_unknown"] = e.code()
                meta = await PredictionServiceStub(ch).GetModelMetadata(
                    apis.GetModelMetadataRequest(model_spec=apis.ModelSpec(name="DCN")),
                    timeout=10)
                r["metadata"] = (meta.model_spec.name, meta.model_spec.version.value,
                                 sorted(meta.metadata))
                sig = apis.SignatureDefMap()
                meta.metadata["signature_def"].Unpack(sig)
                r["signatures"] = sorted(sig.signature_def)
                st = await ModelServiceStub(ch).GetModelStatus(
                    apis.GetModelStatusRequest(model_spec=apis.ModelSpec(name="DCN")),
                    timeout=10)
                r["status"] = [(s.version, s.state) for s in st.model_version_status]
        return out

    try:
        out = _run(_serve_both, jimpl, timpl, body)
    finally:
        stop()
    assert out["ours"]["health"] == health_proto.SERVING
    assert out["ours"]["health_unknown"] == grpc.StatusCode.NOT_FOUND
    assert out["ours"]["status"] == [(1, apis.ModelVersionStatus.AVAILABLE)]
    assert out["ours"] == out["theirs"]


def test_aio_metrics_and_label_reload():
    """Every RPC is observed once under its name; a label-only reload runs
    inline on the loop and retargets the label."""
    _, timpl, stop = _stacks()
    metrics = ServerMetrics()

    async def go():
        server, port = create_server_async(timpl, "127.0.0.1:0", metrics)
        await server.start()
        try:
            async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as ch:
                stub = PredictionServiceStub(ch)
                for _ in range(3):
                    await stub.Predict(_predict_request(4, 0), timeout=30)
                with pytest.raises(grpc.aio.AioRpcError):
                    await stub.Predict(_predict_request(4, 0, name="NOPE"), timeout=30)
                cfg = apis.ReloadConfigRequest()
                mc = cfg.config.model_config_list.config.add(name="DCN")
                mc.version_labels["stable"] = 1
                resp = await ModelServiceStub(ch).HandleReloadConfigRequest(cfg, timeout=30)
                req = _predict_request(4, 0)
                req.model_spec.version_label = "stable"
                labeled = await stub.Predict(req, timeout=30)
                return resp.status.error_code, labeled.model_spec.version.value
        finally:
            await server.stop(0)

    try:
        code, version = asyncio.run(go())
    finally:
        stop()
    assert (code, version) == (0, 1)
    rpcs = metrics.snapshot()["rpcs"]
    assert (rpcs["Predict"]["ok"], rpcs["Predict"]["errors"]) == (4, 1)
    assert rpcs["HandleReloadConfigRequest"]["ok"] == 1


def test_aio_breaker_turns_a_call_away_unavailable():
    """A wedged dispatch past breaker_timeout_s: a new aio Predict ends
    UNAVAILABLE in under a second, the queued one with it; once the wedge
    clears the stuck call and the next one are answered — and the event
    loop served the refusal while a handler awaited the stuck batch."""
    _, timpl, stop = _stacks(breaker_timeout_s=5.0)
    batcher = timpl.batcher
    faults.get().add("batcher.dispatch", "wedge", count=1)

    async def go():
        server, port = create_server_async(timpl, "127.0.0.1:0")
        await server.start()
        try:
            async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as ch:
                stub = PredictionServiceStub(ch)
                stuck = asyncio.ensure_future(stub.Predict(_predict_request(4, 1), timeout=60))
                while batcher._dispatching_since is None:
                    await asyncio.sleep(0.005)
                queued = asyncio.ensure_future(stub.Predict(_predict_request(4, 2), timeout=60))
                while not batcher._items and not batcher._staged:
                    await asyncio.sleep(0.005)
                with batcher._cv:
                    batcher._dispatching_since -= batcher.breaker_timeout_s + 1
                t0 = time.perf_counter()
                with pytest.raises(grpc.aio.AioRpcError) as e:
                    await stub.Predict(_predict_request(4, 3), timeout=60)
                refused_s = time.perf_counter() - t0
                with pytest.raises(grpc.aio.AioRpcError) as eq:
                    await queued
                faults.get().clear()
                first = _scores(await stuck)
                after = _scores(await stub.Predict(_predict_request(4, 4), timeout=60))
                return e.value.code(), eq.value.code(), refused_s, first, after
        finally:
            await server.stop(0)

    try:
        code, queued_code, refused_s, first, after = asyncio.run(go())
    finally:
        stop()
    assert code == queued_code == grpc.StatusCode.UNAVAILABLE
    assert refused_s < 1.0
    assert first.shape == after.shape == (4,)


@pytest.mark.parametrize("text", [
    "",
    "[batching]\ninflight_window = 3\nbuffer_ring = true\n[transport]\nresponse_arena = true\n",
    "[server]\ncompletion_workers = 2\n[batching]\ninflight_window = 6\n",
])
def test_build_stack_passes_the_config_knobs_like_jax(tmp_path, text):
    """build_stack hands [batching] inflight_window / buffer_ring and
    [transport] response_arena to the batcher and the service, as the JAX
    package's does."""
    from distributed_tf_serving_tpu.serving import server as jax_server
    from distributed_tf_serving_tpu.utils.config import load_config as jax_load_config
    from distributed_tf_serving_tpu_torch.serving import server as torch_server
    from distributed_tf_serving_tpu_torch.utils.config import load_config

    model = ("[model]\nnum_fields = 6\nvocab_size = 4096\nembed_dim = 8\nmlp_dims = [16]\n"
             "num_cross_layers = 2\ncompute_dtype = \"float32\"\n")
    path = tmp_path / "c.toml"
    path.write_text("[server]\nbuckets = [32, 64]\nnum_fields = 6\n" + text.replace(
        "[server]\n", "") + model)
    theirs, ours = jax_load_config(path), load_config(path)
    jstack = jax_server.build_stack(theirs["server"], model_config=theirs["model"],
                                    batching_config=theirs["batching"],
                                    transport_config=theirs["transport"])
    impl, batcher, _ = torch_server.build_stack(
        ours["server"], ours["model"], device="cpu", batching_config=ours["batching"],
        transport_config=ours["transport"])
    jbatcher, jimpl = jstack[1], jstack[2]
    try:
        assert batcher.inflight_window == jbatcher.inflight_window
        assert (batcher.buffer_ring is None) == (jbatcher.buffer_ring is None)
        if batcher.buffer_ring is not None:
            assert batcher.buffer_ring.per_key == jbatcher.buffer_ring.per_key
        assert impl.response_arena == jimpl.response_arena
        assert batcher._completers._max_workers == jbatcher._completers._max_workers
        assert batcher.pipeline_stats()["inflight_window"] == \
            jbatcher.pipeline_stats()["inflight_window"]
    finally:
        batcher.stop()
        jbatcher.stop()


def test_aio_root_spans_follow_the_traceparent_like_jax():
    """With tracing on, each aio RPC opens a `server.<RPC>` root in the
    caller's trace with the service's and the batch's phases as children,
    span for span the JAX aio server's."""
    from distributed_tf_serving_tpu.utils import tracing as jax_tracing
    from distributed_tf_serving_tpu_torch.utils import tracing

    trace = "4bf92f3577b34da6a3ce929d0e0e4736"
    meta = (("traceparent", f"00-{trace}-00f067aa0ba902b7-01"),)
    jimpl, timpl, stop = _stacks()

    def names(span):
        return sorted({span["name"], *(n for c in span["children"] for n in names(c))})

    async def body(port, jport):
        for p in (port, jport):
            async with grpc.aio.insecure_channel(f"127.0.0.1:{p}") as ch:
                stub = PredictionServiceStub(ch)
                await stub.Predict(_predict_request(5, 1), timeout=30, metadata=meta)
                _ = [c async for c in stub.PredictStream(_predict_request(5, 2), timeout=30,
                                                         metadata=meta)]

    try:
        trec, jrec = tracing.enable(), jax_tracing.enable()
        _run(_serve_both, jimpl, timpl, body)
        roots = {}
        for which, rec in (("ours", trec), ("theirs", jrec)):
            traces = {t["trace_id"]: t for t in rec.tracez(limit=10)["traces"]}
            roots[which] = {s["name"]: names(s) for s in traces[trace]["spans"]}
    finally:
        tracing.disable()
        jax_tracing.disable()
        stop()
    assert set(roots["ours"]) == {"server.Predict", "server.PredictStream"}
    # The port splits batch.queue_wait in two and times its numpy pack
    # (batch.hostpack); the JAX package does neither.
    port_only = {"batch.collect_wait", "batch.stage_wait", "batch.hostpack"}
    for names_of_root in roots["ours"].values():
        assert port_only <= set(names_of_root)
    assert {k: [n for n in v if n not in port_only] for k, v in roots["ours"].items()} == (
        roots["theirs"])
    assert {"predict.decode", "predict.execute", "predict.encode", "batch.queue_wait",
            "batch.dispatch"} <= set(roots["ours"]["server.Predict"])
