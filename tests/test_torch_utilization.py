"""The port's utilization plane (serving/utilization.py and its wiring)
against the JAX package's on the CPU: the same scripted fake-clock event
sequences fed to both OccupancyLedgers give equal snapshot(),
waterfall(window) and chrome_counter_events (exact ==; the two ledgers do
the same float operations in the same order); load_calibration on the same
files; ProfilerCapture's 409 refusal, degrade record and host_stacks.json
with injected device hooks, a real CPU-activity torch.profiler capture that
writes its trace, and the refusal while another torch.profiler records;
the batcher on the CPU with a ledger (non-warmup batches counted, the depth
gauge back to 0 after a faults.py readback and dispatch fault, sheds, the
components summing to wall, scores bit-identical with the plane on and
off); the Chrome export's counter track."""

import glob
import json
import os
import threading
import time

import numpy as np
import pytest

from distributed_tf_serving_tpu import faults as jax_faults
from distributed_tf_serving_tpu.serving import utilization as jax_util
from distributed_tf_serving_tpu_torch import faults
from distributed_tf_serving_tpu_torch.models import (
    ModelConfig,
    Servable,
    ServableRegistry,
    build_model,
    ctr_signatures,
)
from distributed_tf_serving_tpu_torch.serving import utilization as util
from distributed_tf_serving_tpu_torch.serving.batcher import (
    AdmissionRefusedError,
    DynamicBatcher,
    QueueOverloadError,
)
from distributed_tf_serving_tpu_torch.serving.service import PredictionServiceImpl
from distributed_tf_serving_tpu_torch.utils import tracing
from distributed_tf_serving_tpu_torch.utils.config import OverloadConfig, UtilizationConfig


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


# ------------------------------------------------- the ledger against JAX's

# A script: ("adv", dt) moves the clock; ("wb", cause, key) / ("we", key)
# open and close a wait; ("shed",); ("inc",) / ("dec",); ("batch", stage,
# issue, done, bucket, candidates, d2h_wait) with times relative to 1000.0;
# ("read", window) compares the two ledgers' readers at that point.
SCRIPTS = {
    "pipelined_overlap": [
        ("adv", 0.5), ("inc",), ("inc",),
        ("batch", 0.5, 0.6, 0.9, 256, 200, 0.05),
        ("batch", 0.55, 0.7, 1.0, 512, 400, 0.1), ("dec",), ("dec",),
        ("adv", 0.6), ("read", 10.0),
        ("wb", "queue_empty", "a"), ("adv", 0.2), ("we", "a"),
        ("inc",), ("batch", 1.3, 1.35, 1.42, 256, 100, 0.02), ("dec",),
        ("adv", 0.3), ("read", None), ("read", 0.5),
    ],
    "out_of_order_completion": [
        ("adv", 0.1), ("batch", 0.1, 0.12, 0.5, 2048, 2000, 0.2),
        ("wb", "host_pack", "p"), ("adv", 0.3), ("we", "p"),
        ("batch", 0.45, 0.46, 0.48, 256, 10, 0.01),
        ("batch", 0.6, 0.65, 0.7, 256, 10, 0.01),
        ("batch", 0.4, 0.41, 0.9, 1024, 800, 0.3),
        ("adv", 0.6), ("read", 5.0), ("read", 0.3),
    ],
    "sheds_during_idle": [
        ("batch", 0.0, 0.01, 0.05, 256, 50, 0.01),
        ("wb", "queue_empty", "q"), ("adv", 0.1), ("shed",), ("adv", 0.05), ("shed",),
        ("adv", 0.2), ("we", "q"),
        ("batch", 0.36, 0.37, 0.4, 256, 50, 0.01),
        ("wb", "queue_empty", "q2"), ("adv", 0.1), ("shed",), ("read", None),
        ("adv", 0.1), ("we", "q2"), ("read", 1.0),
    ],
    "startup_span": [
        ("wb", "queue_empty", "s"), ("adv", 2.0), ("read", None), ("we", "s"),
        ("adv", 0.5), ("batch", 2.4, 2.45, 2.6, 512, 300, 0.05), ("read", None),
        ("wb", "readback_wait", "r"), ("adv", 0.3), ("read", 1.0), ("we", "r"),
        ("inc",), ("read", 0.2), ("dec",),
    ],
    "window_clamping": [
        ("batch", 0.0, 0.1, 0.3, 256, 10, 0.05), ("adv", 5.0),
        ("batch", 4.9, 4.95, 5.2, 1024, 900, 0.1), ("adv", 1.0),
        ("read", 0.5), ("read", 1.5), ("read", 3.0), ("read", 100.0),
    ],
    "calibrated": [
        ("cal", {256: 100.0, 512: [150.0, 250.0], 2048: 400.0}),
        ("batch", 0.0, 0.01, 0.02, 256, 100, 0.001), ("adv", 0.05),
        ("batch", 0.05, 0.06, 0.08, 512, 400, 0.002),
        ("batch", 0.07, 0.08, 0.11, 2048, 2000, 0.01), ("adv", 0.2),
        ("read", 1.0), ("read", None),
    ],
    "zero_step_entry": [
        ("cal", {256: 0.0, 512: 120.0, 1024: -5.0}),
        ("batch", 0.0, 0.02, 0.03, 256, 100, 0.001),
        ("batch", 0.05, 0.06, 0.07, 512, 300, 0.001), ("adv", 0.1),
        ("read", 1.0),
    ],
}


def _replay(script):
    """Feed `script` to a JAX and a port ledger on fake clocks; the pairs of
    readings taken at each ("read", window)."""
    readings = []
    pair = []
    for mod in (jax_util, util):
        clock = FakeClock()
        ledger = mod.OccupancyLedger(device="dev:0", clock=clock, ring=64)
        tokens = {}
        out = []
        for op in script:
            kind = op[0]
            if kind == "adv":
                clock.t += op[1]
            elif kind == "wb":
                tokens[op[2]] = ledger.wait_begin(op[1])
            elif kind == "we":
                ledger.wait_end(tokens.pop(op[1]))
            elif kind == "shed":
                ledger.note_shed()
            elif kind == "inc":
                ledger.depth_inc()
            elif kind == "dec":
                ledger.depth_dec()
            elif kind == "cal":
                ledger.set_calibration(op[1])
            elif kind == "batch":
                _, s, i, d, bucket, cand, wait = op
                ledger.note_batch(1000.0 + s, 1000.0 + i, 1000.0 + d, bucket=bucket,
                                  candidates=cand, d2h_wait_s=wait)
            elif kind == "read":
                out.append((ledger.snapshot(op[1]), ledger.waterfall(op[1]),
                            ledger.chrome_counter_events(1000.0, 3)))
        pair.append(out)
    for j, t in zip(*pair):
        readings.append((j, t))
    return readings


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_the_ledger_reads_as_the_jax_ledger(name):
    readings = _replay(SCRIPTS[name])
    assert readings
    for (jsnap, jwf, jev), (tsnap, twf, tev) in readings:
        assert tsnap == jsnap
        assert twf == jwf
        assert tev == jev
        wf = twf
        assert wf["sum_over_wall"] == pytest.approx(1.0, abs=1e-5)
        assert all(v >= 0 for v in wf["components_s"].values())
    if name == "calibrated":
        assert readings[-1][1][1]["calibration"] == "device_step_table"
    if name == "zero_step_entry":
        # Only the 512 entry survives the normalization.
        assert readings[-1][1][0]["calibrated"] is True


CAL_FILES = {
    "plain": json.dumps({"256": 101.5, "2048": 400}),
    "envelope": json.dumps({"device_step_us": {"256": [90, 110], "512": 130.0}}),
    "zero_and_negative": json.dumps({"256": 0, "512": -3, "1024": 77.0}),
    "list_doc": json.dumps([1, 2, 3]),
    "corrupt": "{not json",
}


@pytest.mark.parametrize("name", sorted(CAL_FILES) + ["missing"])
def test_load_calibration_reads_as_the_jax_package(tmp_path, name):
    path = tmp_path / "table.json"
    if name != "missing":
        path.write_text(CAL_FILES[name])
    got = util.load_calibration(str(path))
    assert got == jax_util.load_calibration(str(path))
    if name == "plain":
        assert got == {256: 101.5, 2048: 400.0}


# ------------------------------------------------------------ deep capture


def _wait_idle(cap, timeout=10.0):
    end = time.time() + timeout
    while cap.status()["active"] and time.time() < end:
        time.sleep(0.02)
    assert not cap.status()["active"]


def test_capture_refuses_a_second_one_and_writes_host_stacks(tmp_path):
    results = []
    for mod in (jax_util, util):
        started, stopped = [], []
        cap = mod.ProfilerCapture(base_dir=str(tmp_path / mod.__name__),
                                  device_start=started.append,
                                  device_stop=lambda s=stopped: s.append(True))
        info = cap.start(seconds=0.1)
        with pytest.raises(mod.CaptureInProgressError):
            cap.start(seconds=0.1)
        assert cap.status()["active"] is True
        _wait_idle(cap)
        with open(info["host_stacks"]) as f:
            report = json.load(f)
        assert started == [info["artifact_dir"]] and stopped == [True]
        assert report["samples"] >= 1 and "MainThread" in report["threads"]
        results.append(sorted(info))
    assert results[0] == results[1]


def test_a_device_side_that_cannot_start_degrades_as_the_jax_package(tmp_path):
    infos = []
    for mod in (jax_util, util):
        def boom(_dir):
            raise RuntimeError("no profiler here")

        cap = mod.ProfilerCapture(base_dir=str(tmp_path / mod.__name__), device_start=boom)
        info = cap.start(seconds=0.05)
        _wait_idle(cap)
        with open(info["host_stacks"]) as f:
            assert json.load(f)["samples"] >= 1
        infos.append({k: v for k, v in info.items()
                      if k not in ("artifact_dir", "host_stacks")})
    assert infos[0] == infos[1] == {"seconds": 0.05, "device_trace": False,
                                    "device_trace_error": "RuntimeError: no profiler here"}


def test_a_real_cpu_capture_writes_a_trace(tmp_path):
    import torch

    stop = threading.Event()

    def work():
        while not stop.is_set():
            torch.ones(32, 32) @ torch.ones(32, 32)
            time.sleep(0.002)

    worker = threading.Thread(target=work, name="capture-test-worker")
    worker.start()
    try:
        cap = util.ProfilerCapture(base_dir=str(tmp_path))
        info = cap.start(seconds=0.2)
        assert info["device_trace"] is True, info
        _wait_idle(cap)
    finally:
        stop.set()
        worker.join()
    traces = glob.glob(os.path.join(info["artifact_dir"], "trace_*.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        assert "traceEvents" in json.load(f)
    with open(info["host_stacks"]) as f:
        assert "capture-test-worker" in json.load(f)["threads"]


def test_a_capture_beside_another_recording_profiler_degrades(tmp_path):
    import torch
    from torch.profiler import ProfilerActivity, profile

    cap = util.ProfilerCapture(base_dir=str(tmp_path))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        info = cap.start(seconds=0.05)
        _wait_idle(cap)
        torch.ones(4).add_(1)
    assert info["device_trace"] is False
    assert "another torch.profiler" in info["device_trace_error"]
    assert glob.glob(os.path.join(info["artifact_dir"], "trace_*.json")) == []
    assert any(e.key == "aten::add_" for e in prof.key_averages())  # its window intact


def test_utilization_config_build_applies_profile_dir_and_calibration(tmp_path):
    table = tmp_path / "steps.json"
    table.write_text(json.dumps({"256": 50.0}))
    capture = util.profiler_capture()
    base0 = capture.base_dir
    try:
        assert UtilizationConfig(profile_dir=str(tmp_path)).build() is None
        assert capture.base_dir == str(tmp_path)
        ledger = UtilizationConfig(enabled=True, ring=8, window_seconds=2.0,
                                   calibration_file=str(table)).build()
        assert ledger.snapshot()["calibrated"] and ledger.window_s == 2.0
        assert ledger in set(tracing._COUNTER_SOURCES)
    finally:
        capture.base_dir = base0


# ---------------------------------------------------------- on the batcher

F = 6
KW = dict(num_fields=F, vocab_size=1 << 10, embed_dim=4, mlp_dims=(8,), num_cross_layers=1,
          compute_dtype="float32")


@pytest.fixture(scope="module")
def servable():
    import torch

    torch.manual_seed(0)
    model = build_model("dcn_v2", ModelConfig(name="DCN", **KW))
    return Servable(name="DCN", version=1, model=model, params=model.init(0),
                    signatures=ctr_signatures(F))


def _arrays(n, seed=0):
    rng = np.random.RandomState(seed)
    return {"feat_ids": rng.randint(0, 1 << 40, size=(n, F)).astype(np.int64),
            "feat_wts": rng.rand(n, F).astype(np.float32)}


def _batcher(**kw):
    return DynamicBatcher(buckets=(8, 32), max_wait_us=0, device="cpu",
                          input_cache_entries=0, **kw).start()


def test_the_ledger_counts_non_warmup_batches_and_sums_to_wall(servable):
    ledger = util.OccupancyLedger(device="cpu")
    b = _batcher(utilization=ledger)
    try:
        b.warmup_via_queue(servable)
        assert ledger.batches == 0 and ledger.in_flight == 0
        s0 = b.stats.batches
        payloads = [_arrays(5, i) for i in range(5)]
        for arrays in payloads:
            b.submit(servable, arrays).result(60)
            time.sleep(0.02)  # the queue stays empty: each gap is a queue_empty wait
        assert ledger.batches == b.stats.batches - s0 == 5
        assert ledger.candidates == 25 and ledger.in_flight == 0 and ledger.max_in_flight >= 1
        snap = PredictionServiceImpl(ServableRegistry(), b).utilization_stats(60.0)
        wf = snap["waterfall"]
        assert wf["batches"] == 5 and wf["sum_over_wall"] == pytest.approx(1.0, abs=1e-4)
        assert all(v >= 0 for v in wf["components_s"].values())
        assert wf["calibration"] == "busy_fraction" and 0 < wf["busy_fraction"] <= 1
        # Idle between sequential requests: the queue_empty waits explain it.
        assert snap["idle_gaps"]["queue_empty"]["count"] >= 1
    finally:
        b.stop()


@pytest.mark.parametrize("site", ["readback", "batcher.dispatch"])
def test_the_depth_gauge_returns_to_zero_after_a_fault(servable, site):
    ledger = util.OccupancyLedger(device="cpu")
    b = _batcher(utilization=ledger)
    try:
        faults.get().add(site, "error", code="DATA_LOSS", count=1)
        with pytest.raises(Exception):
            b.submit(servable, _arrays(5)).result(60)
        assert ledger.in_flight == 0 and ledger.max_in_flight == 1
        assert ledger.batches == 0  # a failed batch records no interval
        b.submit(servable, _arrays(5, 1)).result(60)
        assert ledger.in_flight == 0 and ledger.batches == 1
    finally:
        b.stop()


def test_refusals_at_admission_are_sheds(servable):
    ledger = util.OccupancyLedger(device="cpu")
    b = _batcher(utilization=ledger)
    try:
        b.queue_capacity_candidates = 32
        with b._cv:
            b._queued_candidates = 32  # a full queue
        with pytest.raises(QueueOverloadError):
            b.submit(servable, _arrays(5))
        with b._cv:
            b._queued_candidates = 0
        assert ledger.sheds == 1
    finally:
        b.stop()
    ctrl = OverloadConfig(enabled=True, adjust_interval_s=0.0).build()
    ledger = util.OccupancyLedger(device="cpu")
    b = _batcher(utilization=ledger, overload=ctrl)
    try:
        faults.get().add("pressure", "error", code="SHED")
        with pytest.raises(AdmissionRefusedError):
            b.submit(servable, _arrays(5), criticality="sheddable")
        assert ledger.sheds == 1
    finally:
        faults.get().clear()
        b.stop()


def test_scores_with_the_plane_on_are_the_plane_off_bits(servable):
    b = _batcher()
    try:
        arrays = _arrays(7, 3)
        off = b.submit(servable, arrays).result(60)["prediction_node"]
        b.utilization = util.OccupancyLedger(device="cpu")
        on = b.submit(servable, arrays).result(60)["prediction_node"]
        b.utilization = None
        again = b.submit(servable, arrays).result(60)["prediction_node"]
    finally:
        b.stop()
    assert np.array_equal(on, off) and np.array_equal(again, off)


def test_the_chrome_export_carries_the_ledger_track(servable):
    ledger = util.OccupancyLedger(device="cpu:chrome-track")
    tracing.register_counter_source(ledger)
    rec = tracing.enable(buffer_size=8)
    b = _batcher(utilization=ledger)
    try:
        with tracing.start_root("server.Predict") as root:
            b.submit(servable, _arrays(5), span=root).result(60)
        events = rec.chrome_trace()["traceEvents"]
    finally:
        b.stop()
        tracing.disable()
    names = [e for e in events if e["ph"] == "M" and e["name"] == "thread_name"
             and e["args"]["name"] == "cpu:chrome-track"]
    assert len(names) == 1
    pid = names[0]["pid"]
    counters = [e for e in events if e["ph"] == "C" and e["pid"] == pid]
    assert [c["args"]["in_flight"] for c in counters] == [1, 0]
    assert counters[0]["ts"] <= counters[1]["ts"]
