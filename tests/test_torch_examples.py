"""The Example-input RPCs of the port: serving/example_codec.py against the
JAX package's decoder, and Classify, Regress and MultiInference through the
port's service and gRPC server against the JAX service on the same
Examples and the same params (f32: scores within 1e-5)."""

import time

import grpc
import jax
import numpy as np
import pytest

from distributed_tf_serving_tpu.models import ModelConfig as JaxConfig
from distributed_tf_serving_tpu.models import Servable as JaxServable
from distributed_tf_serving_tpu.models import ServableRegistry as JaxRegistry
from distributed_tf_serving_tpu.models import build_model as jax_build
from distributed_tf_serving_tpu.models import ctr_signatures as jax_signatures
from distributed_tf_serving_tpu.proto import serving_apis_pb2 as jax_apis
from distributed_tf_serving_tpu.serving import DynamicBatcher as JaxBatcher
from distributed_tf_serving_tpu.serving import example_codec as jax_codec
from distributed_tf_serving_tpu.serving.service import PredictionServiceImpl as JaxImpl
from distributed_tf_serving_tpu.serving.service import ServiceError as JaxServiceError
from distributed_tf_serving_tpu_torch.convert import params_from_jax
from distributed_tf_serving_tpu_torch.models import (
    ModelConfig,
    Servable,
    ServableRegistry,
    build_model,
    ctr_signatures,
)
from distributed_tf_serving_tpu_torch.proto import PredictionServiceStub
from distributed_tf_serving_tpu_torch.proto import serving_apis_pb2 as apis
from distributed_tf_serving_tpu_torch.serving.batcher import DynamicBatcher
from distributed_tf_serving_tpu_torch.serving.example_codec import (
    ExampleDecodeError,
    decode_input,
    make_example,
)
from distributed_tf_serving_tpu_torch.serving.server import create_server
from distributed_tf_serving_tpu_torch.serving.service import PredictionServiceImpl, ServiceError

F = 5
KW = dict(num_fields=F, vocab_size=1 << 10, embed_dim=8, mlp_dims=(16, 8), num_cross_layers=2,
          compute_dtype="float32")


def _rows(n, seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 1 << 40, size=(n, F)).astype(np.int64),
            rng.rand(n, F).astype(np.float32))


def _input(with_context: bool, n=6, seed=0, proto=apis):
    """An Input of n Examples; with context, the first two fields' ids and
    all the weights come from the context (the two-tower pattern)."""
    ids, wts = _rows(n, seed)
    inp = proto.Input()
    if not with_context:
        for i in range(n):
            inp.example_list.examples.append(make_example(ids[i], wts[i] if i % 2 else None))
        return inp
    ctx = inp.example_list_with_context.context
    ctx.features.feature["feat_wts"].float_list.value.extend(float(w) for w in wts[0])
    for i in range(n):
        inp.example_list_with_context.examples.append(make_example(ids[i]))
    return inp


def _as_jax(msg, jax_cls):
    out = jax_cls()
    out.ParseFromString(msg.SerializeToString())
    return out


@pytest.fixture(scope="module")
def services():
    jm = jax_build("dcn_v2", JaxConfig(**KW))
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(5)))
    jreg = JaxRegistry()
    jreg.load(JaxServable(name="DCN", version=1, model=jm, params=jp,
                          signatures=jax_signatures(F)))
    jb = JaxBatcher(buckets=(8, 32), max_wait_us=0).start()
    sv = Servable(name="DCN", version=1, model=build_model("dcn_v2", ModelConfig(**KW)),
                  params=params_from_jax(jp, "cpu"), signatures=ctr_signatures(F))
    reg = ServableRegistry()
    reg.load(sv)
    b = DynamicBatcher(buckets=(8, 32), max_wait_us=0, device="cpu").start()
    impl = PredictionServiceImpl(reg, b)
    server, port = create_server(impl, "127.0.0.1:0")
    server.start()
    try:
        yield JaxImpl(jreg, jb), impl, f"127.0.0.1:{port}"
    finally:
        server.stop(0)
        b.stop()
        jb.stop()


# ----------------------------------------------------------------- decoding


@pytest.mark.parametrize("with_context", [False, True])
def test_decode_input_matches_the_jax_decoder(with_context):
    inp = _input(with_context, n=7, seed=3)
    got = decode_input(inp, F)
    want = jax_codec.decode_input(_as_jax(inp, jax_apis.Input), F)
    assert set(got) == set(want) == {"feat_ids", "feat_wts"}
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_example_wins_over_context_and_weights_default_to_one():
    inp = apis.Input()
    ctx = inp.example_list_with_context.context
    ctx.features.feature["feat_ids"].int64_list.value.extend([9] * F)
    inp.example_list_with_context.examples.append(make_example([1, 2, 3, 4, 5]))
    inp.example_list_with_context.examples.add()  # everything from the context
    got = decode_input(inp, F)
    np.testing.assert_array_equal(got["feat_ids"], [[1, 2, 3, 4, 5], [9] * F])
    np.testing.assert_array_equal(got["feat_wts"], np.ones((2, F), np.float32))


@pytest.mark.parametrize("build,match", [
    (lambda inp: None, "neither example_list"),
    (lambda inp: inp.example_list.SetInParent(), "no examples"),
    (lambda inp: inp.example_list.examples.append(make_example([1, 2])), "feat_ids has 2 values"),
    (lambda inp: inp.example_list.examples.add(), "missing int64 feature 'feat_ids'"),
    (lambda inp: inp.example_list.examples.append(make_example([1] * F, [0.5] * 3)),
     "feat_wts has 3 values"),
])
def test_decode_errors_match_the_jax_decoder(build, match):
    inp = apis.Input()
    build(inp)
    with pytest.raises(ExampleDecodeError, match=match):
        decode_input(inp, F)
    with pytest.raises(jax_codec.ExampleDecodeError, match=match):
        jax_codec.decode_input(_as_jax(inp, jax_apis.Input), F)


# -------------------------------------------------- the RPCs against JAX's


def _classify_req(with_context, proto=apis, signature=""):
    req = proto.ClassificationRequest()
    req.model_spec.name = "DCN"
    req.model_spec.signature_name = signature
    req.input.CopyFrom(_as_jax(_input(with_context), proto.Input))
    return req


def _classes(resp):
    return [[(c.label, c.score) for c in cl.classes] for cl in resp.result.classifications]


def _close(a, b, tol=1e-5):
    return np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))) < tol


@pytest.mark.parametrize("with_context", [False, True])
def test_classify_matches_the_jax_service(services, with_context):
    jimpl, impl, _ = services
    got = impl.classify(_classify_req(with_context))
    want = jimpl.classify(_classify_req(with_context, jax_apis))
    assert [[l for l, _ in row] for row in _classes(got)] == [["0", "1"]] * 6
    assert [[l for l, _ in row] for row in _classes(want)] == [["0", "1"]] * 6
    assert _close([s for row in _classes(got) for _, s in row],
                  [s for row in _classes(want) for _, s in row])
    for row in _classes(got):
        assert abs(row[0][1] + row[1][1] - 1.0) < 1e-6
    assert got.model_spec.SerializeToString() == want.model_spec.SerializeToString()
    assert got.model_spec.signature_name == "classify"


@pytest.mark.parametrize("with_context", [False, True])
def test_regress_matches_the_jax_service(services, with_context):
    jimpl, impl, _ = services
    req = apis.RegressionRequest()
    req.model_spec.name = "DCN"
    req.input.CopyFrom(_input(with_context))
    got = impl.regress(req)
    want = jimpl.regress(_as_jax(req, jax_apis.RegressionRequest))
    assert _close([r.value for r in got.result.regressions],
                  [r.value for r in want.result.regressions])
    assert got.model_spec.SerializeToString() == want.model_spec.SerializeToString()
    cls = impl.classify(_classify_req(with_context))
    assert _close([r.value for r in got.result.regressions],
                  [row[1][1] for row in _classes(cls)], 1e-7)


def _multi_req(with_context, methods=("classify", "regress")):
    req = apis.MultiInferenceRequest()
    for m in methods:
        task = req.tasks.add()
        task.model_spec.name = "DCN"
        task.method_name = f"tensorflow/serving/{m}"
    req.input.CopyFrom(_input(with_context, seed=4))
    return req


@pytest.mark.parametrize("with_context", [False, True])
def test_multi_inference_matches_the_jax_service(services, with_context):
    jimpl, impl, _ = services
    req = _multi_req(with_context)
    got = impl.multi_inference(req)
    want = jimpl.multi_inference(_as_jax(req, jax_apis.MultiInferenceRequest))
    assert len(got.results) == len(want.results) == 2
    g0, w0 = got.results[0].classification_result, want.results[0].classification_result
    assert _close([c.score for cl in g0.classifications for c in cl.classes],
                  [c.score for cl in w0.classifications for c in cl.classes])
    g1, w1 = got.results[1].regression_result, want.results[1].regression_result
    assert _close([r.value for r in g1.regressions], [r.value for r in w1.regressions])
    for g, w in zip(got.results, want.results):
        assert g.model_spec.SerializeToString() == w.model_spec.SerializeToString()


def test_rpc_errors_match_the_jax_service(services):
    jimpl, impl, _ = services
    cases = [
        (lambda s, p: s.multi_inference(p.MultiInferenceRequest()), "INVALID_ARGUMENT"),
        (lambda s, p: s.multi_inference(_as_jax(_multi_req(False, ("predict",)),
                                                p.MultiInferenceRequest)), "INVALID_ARGUMENT"),
        (lambda s, p: s.classify(p.ClassificationRequest(model_spec=p.ModelSpec(name="DCN"))),
         "INVALID_ARGUMENT"),
        (lambda s, p: s.regress(p.RegressionRequest(model_spec=p.ModelSpec(name="nope"))),
         "NOT_FOUND"),
        (lambda s, p: s.classify(_classify_req(False, p), deadline_s=-1.0), "DEADLINE_EXCEEDED"),
    ]
    for call, code in cases:
        with pytest.raises(ServiceError) as e:
            call(impl, apis)
        assert e.value.code == code
        with pytest.raises(JaxServiceError) as e:
            call(jimpl, jax_apis)
        assert e.value.code == code


def test_multi_inference_checks_the_deadline_between_tasks(services, monkeypatch):
    _, impl, _ = services
    real = impl._classify  # what MultiInference runs per classify task

    def slow_classify(req, deadline_s=None, **kw):
        out = real(req, deadline_s=deadline_s, **kw)
        time.sleep(0.3)
        return out

    monkeypatch.setattr(impl, "_classify", slow_classify)
    with pytest.raises(ServiceError) as e:
        impl.multi_inference(_multi_req(False, ("classify", "regress")), deadline_s=0.2)
    assert e.value.code == "DEADLINE_EXCEEDED" and "between MultiInference tasks" in str(e.value)


def test_rpcs_over_the_wire(services):
    jimpl, _, host = services
    with grpc.insecure_channel(host) as ch:
        stub = PredictionServiceStub(ch)
        got = stub.Classify(_classify_req(True), timeout=30)
        want = jimpl.classify(_classify_req(True, jax_apis))
        assert _close([s for row in _classes(got) for _, s in row],
                      [s for row in _classes(want) for _, s in row])
        req = apis.RegressionRequest(model_spec=apis.ModelSpec(name="DCN"), input=_input(False))
        assert len(stub.Regress(req, timeout=30).result.regressions) == 6
        assert len(stub.MultiInference(_multi_req(True), timeout=30).results) == 2
        with pytest.raises(grpc.RpcError) as e:
            stub.MultiInference(apis.MultiInferenceRequest(), timeout=30)
        assert e.value.code() == grpc.StatusCode.INVALID_ARGUMENT
