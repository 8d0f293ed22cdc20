"""The port's REST gateway (distributed_tf_serving_tpu_torch/serving/rest.py)
against the JAX package's (serving/rest.py) on the CPU: the same bodies go
to both gateways, each over its own stack (the JAX stack with its weights,
the port with the same weights through the converter), and every answer
must match in HTTP status and JSON — scores within 1e-5 in f32, AUC within
1e-3 in bf16 — including the error bodies, /monitoring with its sections,
the routes of the planes that are off, and the set of Prometheus
families."""

import asyncio
import json
import re

import jax
import numpy as np
import pytest

aiohttp = pytest.importorskip("aiohttp")

from distributed_tf_serving_tpu.models import ModelConfig as JaxConfig
from distributed_tf_serving_tpu.models import Servable as JaxServable
from distributed_tf_serving_tpu.models import ServableRegistry as JaxRegistry
from distributed_tf_serving_tpu.models import build_model as jax_build
from distributed_tf_serving_tpu.models import ctr_signatures as jax_signatures
from distributed_tf_serving_tpu.serving import DynamicBatcher as JaxBatcher
from distributed_tf_serving_tpu.serving import PredictionServiceImpl as JaxImpl
from distributed_tf_serving_tpu.serving.rest import start_rest_gateway as jax_start
from distributed_tf_serving_tpu.train.data import auc
from distributed_tf_serving_tpu.utils.tracing import request_trace as jax_request_trace
from distributed_tf_serving_tpu_torch.convert import params_from_jax
from distributed_tf_serving_tpu_torch.models import (
    ModelConfig,
    Servable,
    ServableRegistry,
    build_model,
    ctr_signatures,
)
from distributed_tf_serving_tpu_torch.serving.batcher import DynamicBatcher
from distributed_tf_serving_tpu_torch.serving.rest import start_rest_gateway
from distributed_tf_serving_tpu_torch.serving.service import PredictionServiceImpl
from distributed_tf_serving_tpu_torch.utils.tracing import request_trace

F = 6
KW = dict(num_fields=F, vocab_size=1 << 12, embed_dim=8, mlp_dims=(16,), num_cross_layers=2)
BUCKETS = (32, 64, 256)


def _stacks(compute_dtype: str):
    """(JAX impl, port impl, stop) over the same seed-0 weights, each with
    the label stable -> 1."""
    kw = {**KW, "compute_dtype": compute_dtype}
    jm = jax_build("dcn_v2", JaxConfig(name="DCN", **kw))
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    jreg = JaxRegistry()
    jreg.load(JaxServable(name="DCN", version=1, model=jm, params=jp,
                          signatures=jax_signatures(F)))
    jreg.set_label("DCN", "stable", 1)
    # Both batchers with their device input cache (on by default): a batch
    # is looked up and packed under batch.cache on both sides.
    jb = JaxBatcher(buckets=BUCKETS, max_wait_us=0).start()
    treg = ServableRegistry()
    treg.load(Servable(name="DCN", version=1,
                       model=build_model("dcn_v2", ModelConfig(name="DCN", **kw)),
                       params=params_from_jax(jp, "cpu"), signatures=ctr_signatures(F)))
    treg.set_label("DCN", "stable", 1)
    tb = DynamicBatcher(buckets=BUCKETS, max_wait_us=0, device="cpu").start()

    def stop():
        jb.stop()
        tb.stop()

    return JaxImpl(jreg, jb), PredictionServiceImpl(treg, tb), stop


def _rows(n, seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 1 << 40, size=(n, F)).astype(np.int64),
            rng.rand(n, F).astype(np.float32))


def _instances(ids, wts):
    return {"instances": [{"feat_ids": ids[i].tolist(), "feat_wts": wts[i].tolist()}
                          for i in range(len(ids))]}


def _examples(ids, wts):
    return {"examples": [{"feat_ids": ids[i].tolist(), "feat_wts": wts[i].tolist()}
                         for i in range(len(ids))]}


ids5, wts5 = _rows(5, 3)
ids4, wts4 = _rows(4, 4)
ids3, wts3 = _rows(3, 9)
ONE = _instances(*_rows(1, 1))

# (name, method, path, body): the same request to both gateways, in order.
CASES = [
    ("predict_rows", "POST", "/v1/models/DCN:predict", _instances(ids5, wts5)),
    ("predict_columns", "POST", "/v1/models/DCN:predict",
     {"inputs": {"feat_ids": ids4.tolist(), "feat_wts": wts4.tolist()},
      "signature_name": "serving_default"}),
    ("predict_version", "POST", "/v1/models/DCN/versions/1:predict",
     {"inputs": {"feat_ids": ids3.tolist(), "feat_wts": wts3.tolist()}}),
    ("predict_label", "POST", "/v1/models/DCN/labels/stable:predict", _instances(ids3, wts3)),
    ("classify", "POST", "/v1/models/DCN:classify", _examples(ids3, wts3)),
    ("classify_label", "POST", "/v1/models/DCN/labels/stable:classify", _examples(ids4, wts4)),
    ("regress", "POST", "/v1/models/DCN:regress", _examples(ids5, wts5)),
    ("regress_version", "POST", "/v1/models/DCN/versions/1:regress", _examples(ids3, wts3)),
    ("status", "GET", "/v1/models/DCN", None),
    ("status_version", "GET", "/v1/models/DCN/versions/1", None),
    ("status_label", "GET", "/v1/models/DCN/labels/stable", None),
    ("metadata", "GET", "/v1/models/DCN/metadata", None),
    ("metadata_version", "GET", "/v1/models/DCN/versions/1/metadata", None),
    ("err_malformed_json", "POST", "/v1/models/DCN:predict", b"not json"),
    ("err_not_an_object", "POST", "/v1/models/DCN:predict", b"[1, 2]"),
    ("err_both_formats", "POST", "/v1/models/DCN:predict", {"instances": [1], "inputs": {}}),
    ("err_neither_format", "POST", "/v1/models/DCN:predict", {"signature_name": ""}),
    ("err_empty_instances", "POST", "/v1/models/DCN:predict", {"instances": []}),
    ("err_missing_input", "POST", "/v1/models/DCN:predict",
     {"instances": [{"feat_ids": [1] * F}]}),
    ("err_unknown_model", "POST", "/v1/models/NOPE:predict", ONE),
    ("err_bad_version", "POST", "/v1/models/DCN/versions/latest:predict", ONE),
    ("err_missing_version", "POST", "/v1/models/DCN/versions/9:predict", ONE),
    ("err_unknown_label", "POST", "/v1/models/DCN/labels/nope:predict", ONE),
    ("err_classify_no_examples", "POST", "/v1/models/DCN:classify", {"examples": []}),
    ("err_status_unknown_model", "GET", "/v1/models/NOPE", None),
    ("err_metadata_unknown_label", "GET", "/v1/models/DCN/labels/nope/metadata", None),
    ("cachez", "GET", "/cachez", None),
    ("cachez_flush", "POST", "/cachez/flush", None),
    ("utilz", "GET", "/utilz", None),
    ("utilz_bad_window", "GET", "/utilz?window=soon", None),
    ("qualityz", "GET", "/qualityz", None),
    ("qualityz_bad_version", "GET", "/qualityz?version=x", None),
    ("qualityz_snapshot", "POST", "/qualityz/snapshot", None),
    ("labelz", "POST", "/labelz", {"id": "abc", "label": 1}),
    ("labelz_empty", "POST", "/labelz", {"labels": []}),
    ("labelz_bad_json", "POST", "/labelz", b"{"),
    ("lifecyclez", "GET", "/lifecyclez", None),
    ("lifecyclez_rollback", "POST", "/lifecyclez/rollback", None),
    ("fleetz", "GET", "/fleetz", None),
    ("recoveryz", "GET", "/recoveryz", None),
    ("meshz", "GET", "/meshz", None),
    ("cascadez", "GET", "/cascadez", None),
    ("integrityz", "GET", "/integrityz", None),
    ("integrityz_audit", "POST", "/integrityz/audit", None),
    ("tracez_export_off", "GET", "/tracez/export", None),
    ("tracez_bad_limit", "GET", "/tracez?limit=x", None),
    ("monitoring_unknown_section", "GET", "/monitoring?section=nope", None),
]
# Sent once both servers drain (the shutdown's first step).
DRAINING = [
    ("draining_predict", "POST", "/v1/models/DCN:predict", ONE),
    ("draining_classify", "POST", "/v1/models/DCN:classify", _examples(ids3, wts3)),
    ("draining_regress", "POST", "/v1/models/DCN/versions/1:regress", _examples(ids3, wts3)),
]
SECTIONS = ["metrics", "phases", "tracing", "cache", "row_cache", "overload", "utilization",
            "quality", "lifecycle", "recovery", "kernels", "mesh", "elastic", "fleet", "cascade",
            "integrity", "versions", "pipeline", "request_log", "draining"]
# Sections whose block is the same value in both packages (the rest carry
# timings and counts of each package's own process).
# The port's own /monitoring blocks, beside the JAX gateway's: the codec's
# repeated-field decode routes (codec.decode_counts).
PORT_SECTIONS = ["decode"]
EQUAL_SECTIONS = ["cache", "row_cache", "overload", "utilization", "quality", "lifecycle",
                  "recovery", "kernels", "mesh", "elastic", "fleet", "cascade", "integrity",
                  "versions", "request_log", "draining"]


async def _send(session, method, path, body):
    if body is None:
        kw = {}
    elif isinstance(body, bytes):
        kw = {"data": body}
    else:
        kw = {"json": body}
    async with session.request(method, path, **kw) as r:
        text = await r.text()
        ctype = r.headers.get("Content-Type", "")
    return r.status, json.loads(text) if "json" in ctype else text


async def _drive(jimpl, timpl):
    answers = {}
    # The phase means are process-wide: count only this traffic.
    jax_request_trace.reset()
    request_trace.reset()
    jr, jport = await jax_start(jimpl, port=0)
    tr, tport = await start_rest_gateway(timpl, port=0)
    try:
        async with aiohttp.ClientSession(f"http://127.0.0.1:{jport}") as js, \
                aiohttp.ClientSession(f"http://127.0.0.1:{tport}") as ts:
            for name, method, path, body in CASES:
                answers[name] = (await _send(js, method, path, body),
                                 await _send(ts, method, path, body))
            for sec in SECTIONS:
                path = f"/monitoring?section={sec}"
                answers[f"section_{sec}"] = (await _send(js, "GET", path, None),
                                             await _send(ts, "GET", path, None))
            for sec in PORT_SECTIONS:
                answers[f"port_section_{sec}"] = await _send(
                    ts, "GET", f"/monitoring?section={sec}", None)
            for name, path in (("monitoring", "/monitoring"), ("tracez", "/tracez"),
                               ("prometheus", "/monitoring/prometheus/metrics")):
                answers[name] = (await _send(js, "GET", path, None),
                                 await _send(ts, "GET", path, None))
            # Last: a draining server refuses new inference with 503.
            jimpl.draining = timpl.draining = True
            for name, _, path, body in DRAINING:
                answers[name] = (await _send(js, "POST", path, body),
                                 await _send(ts, "POST", path, body))
    finally:
        await jr.cleanup()
        await tr.cleanup()
    return answers


@pytest.fixture(scope="module")
def answers():
    jimpl, timpl, stop = _stacks("float32")
    try:
        yield asyncio.run(_drive(jimpl, timpl))
    finally:
        stop()


def _assert_same(want, got, path="$"):
    """Equal JSON, floats within 1e-5 (the f32 score tolerance)."""
    if isinstance(want, float) or isinstance(got, float):
        assert isinstance(got, (int, float)) and abs(want - got) <= 1e-5, (path, want, got)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and set(want) == set(got), (path, sorted(want), got)
        for k in want:
            _assert_same(want[k], got[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(want) == len(got), (path, want, got)
        for i, (w, g) in enumerate(zip(want, got)):
            _assert_same(w, g, f"{path}[{i}]")
    else:
        assert want == got, (path, want, got)


@pytest.mark.parametrize("case", [c[0] for c in CASES + DRAINING])
def test_the_port_answers_as_the_jax_gateway(answers, case):
    (jstatus, jbody), (tstatus, tbody) = answers[case]
    assert tstatus == jstatus, (case, jbody, tbody)
    if case == "monitoring_unknown_section":
        # The port names its own sections too.
        jsections, tsections = str(sorted(SECTIONS)), str(sorted(SECTIONS + PORT_SECTIONS))
        assert jsections in jbody["error"]
        jbody = {**jbody, "error": jbody["error"].replace(jsections, tsections)}
    _assert_same(jbody, tbody)
    if case.startswith("draining_"):
        assert tstatus == 503 and "draining" in tbody["error"]


def test_scores_are_the_jax_stack_s_and_the_routes_agree(answers):
    rows = [p["prediction_node"] for p in answers["predict_rows"][1][1]["predictions"]]
    want = [p["prediction_node"] for p in answers["predict_rows"][0][1]["predictions"]]
    np.testing.assert_allclose(rows, want, atol=1e-5)
    label = answers["predict_label"][1][1]["predictions"]
    version = answers["predict_version"][1][1]["outputs"]["prediction_node"]
    assert [p["prediction_node"] for p in label] == version  # same rows, same version
    regress = answers["regress"][1][1]["results"]
    np.testing.assert_allclose(regress, rows, atol=1e-6)


@pytest.mark.parametrize("section", SECTIONS)
def test_monitoring_sections_answer_as_the_jax_gateway(answers, section):
    (jstatus, jbody), (tstatus, tbody) = answers[f"section_{section}"]
    assert jstatus == tstatus == 200 and set(jbody) == set(tbody) == {section}
    if section in EQUAL_SECTIONS:
        assert tbody == jbody
    elif section == "phases":
        # The port also times its numpy pack (batch.hostpack).
        assert set(tbody[section]) == set(jbody[section]) | {"batch.hostpack"}
        for phase, blk in jbody[section].items():
            assert tbody[section][phase]["count"] > 0, phase
    elif isinstance(jbody[section], dict):
        assert set(tbody[section]) == set(jbody[section]), section


def test_monitoring_counts_every_rest_request_as_the_jax_gateway(answers):
    (_, jbody), (_, tbody) = answers["monitoring"]
    assert set(tbody) == set(jbody) | set(PORT_SECTIONS)
    assert set(tbody["rpcs"]) == set(jbody["rpcs"]) == {"REST.Predict", "REST.Classify",
                                                        "REST.Regress"}
    for name, blk in jbody["rpcs"].items():
        assert (tbody["rpcs"][name]["ok"], tbody["rpcs"][name]["errors"]) == (
            blk["ok"], blk["errors"]), name
        assert set(tbody["rpcs"][name]) == set(blk)
    assert set(tbody["models"]) == set(jbody["models"]) == {"DCN", "NOPE"}
    assert set(tbody["batcher"]) == set(jbody["batcher"])
    assert tbody["batcher"]["requests"] == jbody["batcher"]["requests"]
    assert set(tbody["pipeline"]) == set(jbody["pipeline"])
    for phase in ("predict.decode", "predict.execute", "predict.encode", "batch.dispatch",
                  "readback.wait"):
        assert tbody["phases"][phase]["count"] > 0, phase


def test_monitoring_shows_the_codec_decode_routes(answers):
    (_, tbody) = answers["monitoring"][1]
    status, section = answers["port_section_decode"]
    assert status == 200 and set(section) == {"decode"}
    for block in (tbody["decode"], section["decode"]):
        assert set(block) == {"packed", "walked"}
        assert all(isinstance(v, int) and v >= 0 for v in block.values())
    assert section["decode"]["packed"] <= tbody["decode"]["packed"]  # asked first


def test_the_prometheus_families_are_the_jax_gateway_s(answers):
    (js, jtext), (ts, ttext) = answers["prometheus"]
    assert js == ts == 200

    def families(text):
        return {m.group(1) for m in re.finditer(r"^# TYPE (\S+) ", text, re.M)}

    assert families(ttext) == families(jtext)
    counts = [ln for ln in ttext.splitlines()
              if ln.startswith(":tensorflow:serving:request_count{")]
    assert counts == [ln for ln in jtext.splitlines()
                      if ln.startswith(":tensorflow:serving:request_count{")]


def test_tracez_with_tracing_off_has_the_jax_keys(answers):
    (js, jbody), (ts, tbody) = answers["tracez"]
    assert js == ts == 200 and set(tbody) == set(jbody) and tbody["enabled"] is False


def test_bf16_scores_keep_the_auc_tolerance():
    jimpl, timpl, stop = _stacks("bfloat16")
    ids, wts = _rows(200, 11)
    labels = np.random.RandomState(12).rand(200) < 0.3
    body = {"inputs": {"feat_ids": ids.tolist(), "feat_wts": wts.tolist()}}

    async def go():
        jr, jport = await jax_start(jimpl, port=0)
        tr, tport = await start_rest_gateway(timpl, port=0)
        try:
            async with aiohttp.ClientSession() as s:
                out = []
                for port in (jport, tport):
                    async with s.post(f"http://127.0.0.1:{port}/v1/models/DCN:predict",
                                      json=body) as r:
                        assert r.status == 200, await r.text()
                        out.append((await r.json())["outputs"]["prediction_node"])
                return out
        finally:
            await jr.cleanup()
            await tr.cleanup()

    try:
        jscores, tscores = asyncio.run(go())
    finally:
        stop()
    assert abs(auc(labels, np.asarray(jscores)) - auc(labels, np.asarray(tscores))) <= 1e-3
