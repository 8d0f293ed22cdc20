"""The port's quality plane (serving/quality.py and its wiring) against the
JAX package's on the CPU: the same scores and labels fed to both
QualityMonitors on fake clocks give equal snapshots (sketch counts, moments,
percentiles, PSI, JS, AUC, calibration) and equal pair_drift /
version_auc / version_window_count, compared with exact == (the two
monitors run the same numpy operations in the same order); a reference
artifact written by either package loads in the other; label joins by trace
id and by row digest; drift exemplars annotated on spans and kept by the
tail sampler; one case per exclusion of the batcher's feed (warmup, a
screened row, a cascade prune, top-k, a mixed row-cache batch, the
integrity shadow) beside the dedup and all-fresh row batches that still
feed. Then a JAX stack and a port stack with the same seed-0 f32 weights,
both planes on, the same REST Predicts: equal /qualityz bin counts, except
that a score within 1e-5 of a bin edge may land in the neighbouring bin
(at most that many counts move, each between two adjacent bins); the REST
error bodies of both planes equal the JAX gateway's; the
dts_tpu_utilization_* and dts_tpu_quality_* families match in name, TYPE
and HELP."""

import asyncio
import json
import re

import jax
import numpy as np
import pytest

aiohttp = pytest.importorskip("aiohttp")

from distributed_tf_serving_tpu import faults as jax_faults
from distributed_tf_serving_tpu.cache.digest import row_label_keys as jax_row_label_keys
from distributed_tf_serving_tpu.models import ModelConfig as JaxConfig
from distributed_tf_serving_tpu.models import Servable as JaxServable
from distributed_tf_serving_tpu.models import ServableRegistry as JaxRegistry
from distributed_tf_serving_tpu.models import build_model as jax_build
from distributed_tf_serving_tpu.models import ctr_signatures as jax_signatures
from distributed_tf_serving_tpu.serving import DynamicBatcher as JaxBatcher
from distributed_tf_serving_tpu.serving import PredictionServiceImpl as JaxImpl
from distributed_tf_serving_tpu.serving import quality as jax_quality
from distributed_tf_serving_tpu.serving import utilization as jax_util
from distributed_tf_serving_tpu.serving.rest import start_rest_gateway as jax_start
from distributed_tf_serving_tpu_torch import faults
from distributed_tf_serving_tpu_torch.cache import RowScoreCache
from distributed_tf_serving_tpu_torch.convert import params_from_jax
from distributed_tf_serving_tpu_torch.models import (
    ModelConfig,
    Servable,
    ServableRegistry,
    build_model,
    ctr_signatures,
)
from distributed_tf_serving_tpu_torch.serving import quality
from distributed_tf_serving_tpu_torch.serving import utilization as util
from distributed_tf_serving_tpu_torch.serving.batcher import (
    DynamicBatcher,
    IntegrityScreenError,
    poison_fault_key,
    prepare_inputs,
)
from distributed_tf_serving_tpu_torch.serving.rest import start_rest_gateway
from distributed_tf_serving_tpu_torch.serving.service import PredictionServiceImpl, ServiceError
from distributed_tf_serving_tpu_torch.train.data import auc as exact_auc
from distributed_tf_serving_tpu_torch.utils import tracing
from distributed_tf_serving_tpu_torch.utils.config import IntegrityConfig, QualityConfig

F = 6
KW = dict(num_fields=F, vocab_size=1 << 10, embed_dim=4, mlp_dims=(8,), num_cross_layers=1,
          compute_dtype="float32")
SCORE = "prediction_node"


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset(0)
    jax_faults.reset(0)
    yield
    faults.reset(0)
    jax_faults.reset(0)


def _monitors(clock, **kw):
    kw = {"window_s": 60.0, "slices": 6, "drift_check_interval_s": 0.0, "min_drift_count": 10,
          **kw}
    return (jax_quality.QualityMonitor(clock=clock, **kw),
            quality.QualityMonitor(clock=clock, **kw))


# ------------------------------------------------ the monitor against JAX's


def _scenario(name, rng):
    """A scripted list of monitor operations: ("obs", model, version,
    scores, lane, trace_id), ("adv", dt), ("pin",), ("labels", items),
    ("change", model)."""
    ops = []
    if name == "two_versions":
        ops += [("obs", "DCN", 1, rng.beta(2, 5, 300), "critical", None), ("adv", 1.0),
                ("change", "DCN"),
                ("obs", "DCN", 2, rng.beta(5, 2, 300), None, None), ("adv", 1.0),
                ("obs", "DCN", 1, rng.beta(2, 5, 100), "sheddable", None)]
    elif name == "pinned_reference_shift":
        ops += [("obs", "DCN", 1, rng.uniform(0.1, 0.3, 400), None, None), ("pin",),
                ("adv", 61.0),
                ("obs", "DCN", 1, rng.uniform(0.6, 0.9, 250), "probe", None),
                ("obs", "OTHER", 3, rng.uniform(0, 1, 40), "bogus", None), ("adv", 2.0),
                ("obs", "DCN", 1, rng.uniform(0.6, 0.9, 5), None, None)]
    elif name == "labels":
        for i in range(12):
            ops.append(("obs", "DCN", 1 + i % 2, rng.uniform(0, 1, 20), None, f"t{i:02d}"))
        items = [{"id": f"t{i:02d}#{r}", "label": int(rng.rand() < 0.4)}
                 for i in range(12) for r in range(0, 20, 3)]
        items += [{"id": "nope", "label": 1}, {"id": "t00#99", "label": 0},
                  {"id": "t01#x", "label": 1}, {"id": "t03", "label": 1}]
        ops += [("adv", 5.0), ("labels", items), ("adv", 70.0),
                ("labels", [{"id": "t05#1", "label": 1}, {"id": "t06#2", "label": 0}])]
    elif name == "window_expiry":
        ops += [("obs", "DCN", 1, rng.normal(0.5, 0.2, 200), None, None), ("adv", 30.0),
                ("obs", "DCN", 1, rng.normal(0.4, 0.1, 50), None, None), ("adv", 40.0),
                ("pin",), ("adv", 100.0), ("pin",)]
    return ops


SCENARIOS = ["labels", "pinned_reference_shift", "two_versions", "window_expiry"]


@pytest.mark.parametrize("name", SCENARIOS)
def test_the_monitor_reads_as_the_jax_monitor(name):
    clock = FakeClock()
    monitors = _monitors(clock, drift_threshold_psi=0.2)
    reads = []
    for m in monitors:
        clock.t = 1000.0
        out = []
        for op in _scenario(name, np.random.RandomState(7)):
            if op[0] == "obs":
                _, model, version, scores, lane, trace_id = op
                m.observe(model, version, scores, lane=lane, trace_id=trace_id)
            elif op[0] == "adv":
                clock.t += op[1]
            elif op[0] == "pin":
                out.append(m.pin_reference(save=False))
            elif op[0] == "labels":
                out.append(m.ingest_labels(op[1]))
            elif op[0] == "change":
                m.note_servable_change(op[1])
            out.append(m.snapshot())
        out.append(m.snapshot(model="DCN", version=1))
        out.append([m.pair_drift("DCN", 1, 2), m.pair_drift("DCN", 1, 2, decision_bins=10,
                                                            min_count=1),
                    m.version_auc("DCN", 1), m.version_auc("DCN", 2),
                    m.version_window_count("DCN", 1), m.version_window_count("DCN", 9)])
        reads.append(out)
    assert reads[1] == reads[0]
    last = reads[1][-3]
    if name == "two_versions":
        assert last["models"]["DCN"]["drift"]["version_pair"]["psi"] > 0.2
        assert last["version_changes"] == 1
    if name == "pinned_reference_shift":
        assert last["models"]["DCN"]["drift"]["exceeded"] is True
    if name == "labels":
        # "nope", a row past the vector and a row that is not a number;
        # "t03" alone joins its vector's row 0.
        assert last["labels"]["joined"] > 0 and last["labels"]["orphaned"] == 3
        assert last["labels"]["late"] == 2


def test_psi_js_percentile_and_calibration_equal_the_jax_functions():
    rng = np.random.RandomState(3)
    a, b = rng.randint(0, 50, 50), rng.randint(0, 50, 50)
    assert quality.psi(a, b) == jax_quality.psi(a, b)
    assert quality.js_divergence(a, b) == jax_quality.js_divergence(a, b)
    assert np.array_equal(quality.coarsen_counts(a, 10), jax_quality.coarsen_counts(a, 10))
    for q in (1, 50, 99):
        assert (quality.histogram_percentile(a, 0.0, 1.0, q)
                == jax_quality.histogram_percentile(a, 0.0, 1.0, q))
    s, y = rng.rand(300), (rng.rand(300) < 0.3).astype(np.float64)
    assert quality.calibration_report(s, y) == jax_quality.calibration_report(s, y)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_reference_artifact_loads_in_the_other_package(tmp_path, writer):
    clock = FakeClock()
    path = str(tmp_path / "quality_reference.json")
    jm, tm = _monitors(clock, reference_file=path)
    src, dst = (jm, tm) if writer == "jax" else (tm, jm)
    rng = np.random.RandomState(1)
    src.observe("DCN", 1, rng.beta(2, 5, 500))
    src.observe("RANKER", 2, rng.beta(5, 2, 80))
    pinned = src.pin_reference()
    assert pinned["path"] == path and pinned["models"] == {"DCN": 500, "RANKER": 80}
    assert dst.load_reference(path) == 2
    assert dst.snapshot()["reference"] == src.snapshot()["reference"]
    other = (jax_quality if writer == "port" else quality).QualityMonitor(
        bins=20, reference_file=path, clock=clock)
    assert other.snapshot()["reference"] == {}  # another bin geometry: ignored


# ---------------------------------------------------------- on the batcher


@pytest.fixture(scope="module")
def servable():
    model = build_model("dcn_v2", ModelConfig(name="DCN", **KW))
    return Servable(name="DCN", version=1, model=model, params=model.init(0),
                    signatures=ctr_signatures(F))


def _arrays(n, seed=0):
    rng = np.random.RandomState(seed)
    return {"feat_ids": rng.randint(0, 1 << 40, size=(n, F)).astype(np.int64),
            "feat_wts": rng.rand(n, F).astype(np.float32)}


def _monitor(**kw):
    kw = {"window_s": 60.0, "drift_check_interval_s": 0.0, "min_drift_count": 10, **kw}
    return quality.QualityMonitor(**kw)


def _batcher(**kw):
    kw.setdefault("max_wait_us", 0)
    return DynamicBatcher(buckets=(8, 32, 64), device="cpu", **kw).start()


def test_labels_join_by_trace_id_and_by_row_digest(servable):
    rec = tracing.enable(buffer_size=16)
    monitor = _monitor()
    b = _batcher(quality=monitor)
    try:
        arrays = _arrays(12, 5)
        with tracing.start_root("server.Predict") as root:
            got = b.submit(servable, arrays, span=root).result(60)[SCORE]
        trace_id = root.trace_id
        small = _arrays(4, 6)
        got_small = b.submit(servable, small).result(60)[SCORE]
    finally:
        b.stop()
        tracing.disable()
    assert rec is not None
    keys = quality.row_label_keys(small)
    assert keys == jax_row_label_keys(small)  # the client's keys meet the server's
    labels = np.random.RandomState(8).rand(16) < 0.5
    items = [{"id": f"{trace_id}#{i}", "label": int(labels[i])} for i in range(12)]
    items += [{"id": k, "label": int(labels[12 + i])} for i, k in enumerate(keys)]
    assert monitor.ingest_labels(items) == {"joined": 16, "orphaned": 0}
    scores = np.concatenate([got, got_small]).astype(np.float32).astype(np.float64)
    block = monitor.snapshot()["labels"]
    assert block["window_pairs"] == 16
    assert block["auc"] == round(exact_auc(labels.astype(np.float64), scores), 6)
    assert monitor.ingest_labels([{"id": f"{trace_id}#12", "label": 1}]) == {
        "joined": 0, "orphaned": 1}
    with pytest.raises(ValueError, match="label must be 0 or 1"):
        monitor.ingest_labels([{"id": keys[0], "label": 0.5}])


def test_drift_exemplars_are_annotated_and_kept(servable):
    rec = tracing.enable(buffer_size=64, sample_rate=0.0, slowest_n=0)
    try:
        monitor = _monitor(drift_threshold_psi=0.1, exemplar_traces=4)
        rng = np.random.RandomState(0)
        monitor.observe("DCN", 1, rng.uniform(0.1, 0.3, 200))
        monitor.pin_reference(save=False)
        monitor.observe("DCN", 1, rng.uniform(0.7, 0.9, 400))
        b = _batcher(quality=monitor)
        try:
            with tracing.start_root("server.Predict") as span:
                b.submit(servable, _arrays(4, 2), span=span).result(60)
            with tracing.start_root("server.Predict.unmarked"):
                pass
        finally:
            b.stop()
        kept = [s for s in rec.spans()
                if any(a["message"] == "quality.drift" for a in s.annotations)]
        assert [s.name for s in rec.spans()] == ["server.Predict"] and len(kept) == 1
        ann = next(a for a in kept[0].annotations if a["message"] == "quality.drift")
        assert ann["model"] == "DCN" and ann["version"] == 1 and ann["psi"] >= 0.1
        assert monitor.snapshot()["exemplars"]["marked"] == 1
    finally:
        tracing.disable()


def _screened(servable, monitor):
    plane = IntegrityConfig(enabled=True).build()
    b = _batcher(quality=monitor, max_wait_us=200_000)
    b.integrity = plane
    try:
        b.submit(servable, _arrays(3, 39)).result(60)  # observed: 1
        payloads = [_arrays(5, s) for s in (40, 41)]
        faults.get().add("score_nan", "error", key=poison_fault_key(prepare_inputs(payloads[1])))
        futs = [b.submit(servable, p) for p in payloads]
        futs[0].result(60)
        with pytest.raises(IntegrityScreenError):
            futs[1].result(60)
        assert b.stats.batches == 2  # the two rode one batch
    finally:
        b.stop()
    return 1


def _prune(servable, monitor):
    b = _batcher(quality=monitor)
    try:
        out = b.submit(servable, _arrays(16, 3), output_keys=(SCORE,), _prune_k=4).result(60)
        assert set(out) == {"survivor_scores", "survivor_indices", "stage1_scores"}
        assert b.stats.prune_batches == 1
    finally:
        b.stop()
    return 0


def _topk(servable, monitor):
    b = _batcher(quality=monitor, output_top_k=2)
    try:
        b.submit(servable, _arrays(8, 4), output_keys=(SCORE,)).result(60)
        assert b.stats.topk_batches == 1
        b.submit(servable, _arrays(8, 4)).result(60)  # the whole vector: observed
    finally:
        b.stop()
    return 1


def _mixed_rows(servable, monitor):
    b = _batcher(quality=monitor, row_cache=RowScoreCache(ttl_s=600.0))
    try:
        a1 = _arrays(20, 11)
        b.submit(servable, a1).result(60)  # every row cold: observed
        fresh = _arrays(4, 12)
        a2 = {k: np.concatenate([a1[k][:16], fresh[k]]) for k in a1}
        b.submit(servable, a2).result(60)  # 16 cached + 4 executed: not observed
        assert b.stats.rows_executed == 24
    finally:
        b.stop()
    return 1


def _row_all_fresh(servable, monitor):
    b = _batcher(quality=monitor, row_cache=RowScoreCache(ttl_s=600.0), dedup=True)
    try:
        a = _arrays(6, 13)
        dup = {k: np.concatenate([a[k], a[k][:3]]) for k in a}  # cold, 3 repeated in batch
        got = b.submit(servable, dup).result(60)[SCORE]
        assert b.stats.rows_executed == 6
        assert monitor.snapshot()["models"]["DCN"]["versions"]["1"]["count"] == 9
        assert np.array_equal(got[6:], got[:3])
    finally:
        b.stop()
    return 1


def _dedup(servable, monitor):
    b = _batcher(quality=monitor, dedup=True)
    try:
        a = _arrays(5, 14)
        dup = {k: np.concatenate([a[k], a[k]]) for k in a}
        b.submit(servable, dup).result(60)
        assert b.stats.dedup_rows_collapsed == 5
        assert monitor.snapshot()["models"]["DCN"]["versions"]["1"]["count"] == 10
    finally:
        b.stop()
    return 1


def _shadow(servable, monitor):
    b = _batcher(quality=monitor)
    b.integrity = IntegrityConfig(enabled=True, shadow_fraction=1.0).build()
    try:
        b.submit(servable, _arrays(7, 15)).result(60)
        assert b.stats.shadow_batches == 1
        assert monitor.snapshot()["models"]["DCN"]["versions"]["1"]["count"] == 7
    finally:
        b.stop()
    return 1


def _warmup(servable, monitor):
    b = _batcher(quality=monitor)
    try:
        b.warmup_via_queue(servable)
        assert monitor.observed_requests == 0
        b.submit(servable, _arrays(5, 16), criticality="sheddable").result(60)
        lanes = monitor.snapshot()["models"]["DCN"]["versions"]["1"]["lanes"]
        assert lanes == {"sheddable": 1}
    finally:
        b.stop()
    return 1


EXCLUSIONS = {"warmup": _warmup, "screened": _screened, "prune": _prune, "topk": _topk,
              "mixed_row_batch": _mixed_rows, "shadow": _shadow,
              "dedup_still_feeds": _dedup, "row_all_fresh_still_feeds": _row_all_fresh}


@pytest.mark.parametrize("case", sorted(EXCLUSIONS))
def test_the_feed_skips_what_the_jax_batcher_skips(servable, case):
    monitor = _monitor()
    want = EXCLUSIONS[case](servable, monitor)
    assert monitor.observed_requests == want, case


def test_the_plane_off_refuses_labels_and_pins(servable):
    b = _batcher()
    try:
        impl = PredictionServiceImpl(ServableRegistry(), b)
        assert impl.quality_stats() is None and impl.utilization_stats() is None
        for call in (lambda: impl.quality_ingest_labels([{"id": "x", "label": 1}]),
                     impl.quality_pin_reference):
            with pytest.raises(ServiceError) as ei:
                call()
            assert ei.value.code == "FAILED_PRECONDITION"
    finally:
        b.stop()


def test_quality_config_builds_the_jax_defaults(tmp_path):
    assert QualityConfig().build() is None
    m = QualityConfig(enabled=True, bins=20, reference_file=str(tmp_path / "r.json")).build()
    assert m.snapshot()["config"] == jax_quality.QualityMonitor(
        bins=20, reference_file=str(tmp_path / "r.json")).snapshot()["config"]


# ------------------------------------------- two stacks, the same traffic

BUCKETS = (32, 64, 256)
NEAR_EDGE = 1e-5  # a score this close to a bin edge may fall on either side of it
PREDICTS = [(n, 20 + i) for i, n in enumerate((7, 50, 64, 200, 31, 150))]
ERROR_CASES = [
    ("utilz_bad_window", "GET", "/utilz?window=soon", None),
    ("qualityz_bad_version", "GET", "/qualityz?version=x", None),
    ("labelz_bad_json", "POST", "/labelz", b"{"),
    ("labelz_empty", "POST", "/labelz", {"labels": []}),
    ("labelz_not_a_list", "POST", "/labelz", {"labels": "x"}),
    ("labelz_no_label", "POST", "/labelz", {"id": "abc"}),
    ("labelz_fractional", "POST", "/labelz", [{"id": "abc", "label": 0.5}]),
    ("labelz_bad_number", "POST", "/labelz", {"labels": [{"id": "a", "label": "x"}]}),
    ("labelz_orphan", "POST", "/labelz", {"id": "abc", "label": 1}),
    ("profilez_bad_seconds", "POST", "/profilez/start?seconds=soon", None),
    ("profilez_status", "GET", "/profilez", None),
    ("qualityz_unknown_model", "GET", "/qualityz?model=NOPE&version=3", None),
]


def _stacks():
    jm = jax_build("dcn_v2", JaxConfig(name="DCN", **KW))
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    jreg = JaxRegistry()
    jreg.load(JaxServable(name="DCN", version=1, model=jm, params=jp,
                          signatures=jax_signatures(F)))
    jq = jax_quality.QualityMonitor(reference_file="")
    jb = JaxBatcher(buckets=BUCKETS, max_wait_us=0, quality=jq,
                    utilization=jax_util.OccupancyLedger(device="cpu")).start()
    treg = ServableRegistry()
    treg.load(Servable(name="DCN", version=1,
                       model=build_model("dcn_v2", ModelConfig(name="DCN", **KW)),
                       params=params_from_jax(jp, "cpu"), signatures=ctr_signatures(F)))
    tq = quality.QualityMonitor(reference_file="")
    tb = DynamicBatcher(buckets=BUCKETS, max_wait_us=0, device="cpu", quality=tq,
                        utilization=util.OccupancyLedger(device="cpu")).start()

    def stop():
        jb.stop()
        tb.stop()

    return JaxImpl(jreg, jb), PredictionServiceImpl(treg, tb), stop


async def _send(session, method, path, body):
    kw = {} if body is None else {"data": body} if isinstance(body, bytes) else {"json": body}
    async with session.request(method, path, **kw) as r:
        text = await r.text()
        ctype = r.headers.get("Content-Type", "")
    return r.status, json.loads(text) if "json" in ctype else text


async def _drive(jimpl, timpl):
    out = {"scores": [], "errors": {}}
    jr, jport = await jax_start(jimpl, port=0)
    tr, tport = await start_rest_gateway(timpl, port=0)
    try:
        async with aiohttp.ClientSession(f"http://127.0.0.1:{jport}") as js, \
                aiohttp.ClientSession(f"http://127.0.0.1:{tport}") as ts:
            for n, seed in PREDICTS:
                a = _arrays(n, seed)
                body = {"inputs": {"feat_ids": a["feat_ids"].tolist(),
                                   "feat_wts": a["feat_wts"].tolist()}}
                pair = [await _send(s, "POST", "/v1/models/DCN:predict", body) for s in (js, ts)]
                assert pair[0][0] == pair[1][0] == 200
                out["scores"].append([p[1]["outputs"][SCORE] for p in pair])
            for name, method, path, body in ERROR_CASES:
                out["errors"][name] = [await _send(s, method, path, body) for s in (js, ts)]
            for key, path in (("qualityz", "/qualityz"), ("utilz", "/utilz"),
                              ("prom", "/monitoring/prometheus/metrics")):
                out[key] = [await _send(s, "GET", path, None) for s in (js, ts)]
    finally:
        await jr.cleanup()
        await tr.cleanup()
    return out


@pytest.fixture(scope="module")
def answers():
    jimpl, timpl, stop = _stacks()
    try:
        yield asyncio.run(_drive(jimpl, timpl))
    finally:
        stop()


def test_the_two_stacks_sketch_the_same_bins(answers):
    (js, jq), (ts, tq) = answers["qualityz"]
    assert js == ts == 200
    jv, tv = (q["models"]["DCN"]["versions"]["1"] for q in (jq, tq))
    scores = np.concatenate([np.asarray(t, np.float64) for _, t in answers["scores"]])
    jscores = np.concatenate([np.asarray(j, np.float64) for j, _ in answers["scores"]])
    assert np.max(np.abs(scores - jscores)) <= 1e-5
    assert tv["count"] == jv["count"] == len(scores) == sum(n for n, _ in PREDICTS)
    assert tq["observed_requests"] == jq["observed_requests"] == len(PREDICTS)
    jc, tc = np.asarray(jv["histogram"]["counts"]), np.asarray(tv["histogram"]["counts"])
    assert tc.sum() == jc.sum() == len(scores)
    # The port's counts are a histogram of the scores it answered, exactly.
    edges = np.linspace(0.0, 1.0, 51)
    idx = np.clip(np.floor((scores - 0.0) / (1.0 / 50)).astype(np.int64), 0, 49)
    assert np.array_equal(tc, np.bincount(idx, minlength=50))
    near = int(np.sum(np.min(np.abs(scores[:, None] - edges[None, :]), axis=1) <= NEAR_EDGE))
    assert int(np.abs(tc - jc).sum()) <= 2 * near, (near, (tc - jc).tolist())
    assert set(tv) == set(jv) and set(tq) == set(jq)


def test_the_two_ledgers_count_the_same_batches(answers):
    (js, ju), (ts, tu) = answers["utilz"]
    assert js == ts == 200 and set(tu) == set(ju)
    assert tu["batches"] == ju["batches"] == len(PREDICTS) and tu["in_flight"] == 0
    assert set(tu["waterfall"]) == set(ju["waterfall"])
    assert set(tu["idle_gaps"]) == set(ju["idle_gaps"])


@pytest.mark.parametrize("case", [c[0] for c in ERROR_CASES])
def test_the_plane_bodies_are_the_jax_gateway_s(answers, case):
    (jstatus, jbody), (tstatus, tbody) = answers["errors"][case]
    assert tstatus == jstatus, (jbody, tbody)
    if case == "qualityz_unknown_model":
        assert tbody["models"] == jbody["models"] == {}
        assert tbody["config"] == jbody["config"]
    else:
        assert tbody == jbody


def test_the_plane_series_are_the_jax_exposition_s(answers):
    (js, jtext), (ts, ttext) = answers["prom"]
    assert js == ts == 200

    def decl(text):
        return {ln for ln in text.splitlines()
                if re.match(r"# (HELP|TYPE) dts_tpu_(utilization|quality)_", ln)}

    ours = decl(ttext)
    assert ours == decl(jtext)
    assert any("dts_tpu_utilization_busy_fraction" in ln for ln in ours)
    assert any("# TYPE dts_tpu_quality_score histogram" == ln for ln in ours)
    count = [ln for ln in ttext.splitlines() if ln.startswith("dts_tpu_quality_scores_total{")]
    assert count == [f'dts_tpu_quality_scores_total{{model_name="DCN",version="1"}} '
                     f'{sum(n for n, _ in PREDICTS)}']
