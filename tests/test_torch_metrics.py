"""The port's ServerMetrics (distributed_tf_serving_tpu_torch/utils/
metrics.py) against the JAX package's on the CPU: the same observe
sequence under one fake clock gives the same snapshot() and the same
Prometheus text, with and without batcher and pipeline stats; the
histogram percentiles agree over arbitrary latencies; label escaping is the
same; and the port's text passes tools/check_prom.py."""

import dataclasses
import os
import sys

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from distributed_tf_serving_tpu.serving.batcher import BatcherStats as JaxBatcherStats
from distributed_tf_serving_tpu.utils import metrics as jax_metrics
from distributed_tf_serving_tpu_torch.serving.batcher import BatcherStats
from distributed_tf_serving_tpu_torch.utils import metrics

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
from check_prom import lint_text  # noqa: E402


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


# (advance seconds, rpc, latency seconds, ok, model): enough to cross window
# slices, fill several buckets, make errors, and name a model that needs
# escaping.
OBSERVATIONS = [
    (0.0, "Predict", 0.0021, True, "DCN"),
    (0.5, "Predict", 0.0035, True, "DCN"),
    (0.5, "REST.Predict", 0.0102, True, "DCN"),
    (3.0, "Predict", 0.0009, False, "NOPE"),
    (4.0, "Classify", 0.0150, True, "DCN"),
    (11.0, "Predict", 1.5, True, 'he"l\\lo\nx'),
    (20.0, "GetModelMetadata", 0.0004, True, None),
    (25.0, "REST.Predict", 0.25, False, "DCN"),
    (30.0, "Predict", 0.0000005, True, "DCN"),
    (45.0, "REST.Classify", 0.0077, True, "DCN"),
]


def _pair(window_s=60.0):
    clock = FakeClock()
    return (jax_metrics.ServerMetrics(window_s=window_s, clock=clock),
            metrics.ServerMetrics(window_s=window_s, clock=clock), clock)


def _observe_all(jm, tm, clock, upto=len(OBSERVATIONS)):
    for dt, name, secs, ok, model in OBSERVATIONS[:upto]:
        clock.t += dt
        jm.observe(name, secs, ok, model=model)
        tm.observe(name, secs, ok, model=model)


STATS = dict(batches=7, requests=19, candidates=4242, padded_candidates=5120,
             fused_batches=7, deadline_sheds=1, topk_batches=2, bytes_downloaded=16968,
             bytes_download_full_f32=40960, readback_window_s=0.25, readback_blocked_s=0.05,
             max_queue_depth=5, inflight_peak=2)
PIPELINE = {"depth": 2, "inflight_window": 0, "in_flight": 1, "dispatching": False,
            "dispatch_pending": 1, "per_bucket_in_flight": {256: 1}, "inflight_peak": 2,
            "inflight_window_waits": 0, "readback_overlap_fraction": 0.8}


def _stats():
    jax_fields = {f.name for f in dataclasses.fields(JaxBatcherStats)}
    return JaxBatcherStats(**{k: v for k, v in STATS.items() if k in jax_fields}), \
        BatcherStats(**STATS)


@pytest.mark.parametrize("upto", [0, 1, 4, len(OBSERVATIONS)])
@pytest.mark.parametrize("later_s", [0.0, 35.0, 200.0])
def test_snapshot_equals_the_jax_package_s(upto, later_s):
    jm, tm, clock = _pair()
    _observe_all(jm, tm, clock, upto)
    clock.t += later_s  # slices age out of the window
    assert tm.snapshot() == jm.snapshot()
    jstats, tstats = _stats()
    assert tm.snapshot(tstats) == jm.snapshot(jstats)


@pytest.mark.parametrize("with_stats", [False, True])
@pytest.mark.parametrize("with_pipeline", [False, True])
def test_prometheus_text_equals_the_jax_package_s(with_stats, with_pipeline):
    jm, tm, clock = _pair(window_s=30.0)
    _observe_all(jm, tm, clock)
    jstats, tstats = _stats() if with_stats else (None, None)
    pipeline = PIPELINE if with_pipeline else None
    want = jm.prometheus_text(jstats, pipeline=pipeline)
    got = tm.prometheus_text(tstats, pipeline=pipeline)
    assert got == want
    assert lint_text(got) == []


@pytest.mark.parametrize("window,ring", [(4, None), (1, {"reuses": 24, "allocs": 6,
                                                          "free_buffers": 6})])
def test_window_and_buffer_ring_series_are_the_jax_package_s(window, ring):
    jm, tm, clock = _pair(window_s=30.0)
    _observe_all(jm, tm, clock, 2)
    pipeline = {**PIPELINE, "inflight_window": window, "inflight_window_waits": 3}
    if ring is not None:
        pipeline["buffer_ring"] = ring
    got = tm.prometheus_text(pipeline=pipeline)
    assert got == jm.prometheus_text(pipeline=pipeline)
    assert lint_text(got) == []
    assert ("dts_tpu_pipeline_buffer_ring_reuses_total 24" in got.splitlines()) == \
        (ring is not None)


def test_kernel_series_are_the_jax_package_s_and_lint_clean():
    kernels = {
        "counters": {"autotunes": 1, "table_reuses": 0, "quantized_batches": 3,
                     "pallas_batches": 9},
        "measure_only": False, "int8_score_wire": True,
        "decisions": {"DCN:1": {"256": {"quantized": False, "pallas": True},
                                "2048": {"quantized": True, "pallas": True}}},
        "tables": {"DCN:1": {"buckets": {"256": {"pallas_f32": {"speedup": 4.2},
                                                 "xla_f32": {"speedup": 1.0}, "x": 3}}}},
    }
    jm, tm, clock = _pair()
    _observe_all(jm, tm, clock, 3)
    got = tm.prometheus_text(kernels=kernels)
    want = jm.prometheus_text(kernels=kernels)
    assert lint_text(got) == []

    def samples(text):
        return [ln for ln in text.splitlines() if ln.startswith("dts_tpu_kernel_")]

    assert samples(got) == samples(want) and len(samples(got)) == 12


def test_batcher_stats_properties_are_the_jax_package_s():
    jstats, tstats = _stats()
    for name in ("mean_occupancy", "mean_requests_per_batch", "download_compaction_ratio",
                 "readback_overlap_fraction"):
        assert getattr(tstats, name) == getattr(jstats, name), name
    empty_j, empty_t = JaxBatcherStats(), BatcherStats()
    for name in ("mean_occupancy", "mean_requests_per_batch", "download_compaction_ratio"):
        assert getattr(empty_t, name) == getattr(empty_j, name) == 0.0


@settings(max_examples=60, deadline=None)
@given(st.lists(st.floats(min_value=0.0, max_value=200.0, allow_nan=False), min_size=1,
                max_size=80),
       st.sampled_from([0.0, 1.0, 25.0, 50.0, 90.0, 99.0, 99.9, 100.0]))
def test_histogram_percentiles_equal_the_jax_package_s(latencies, q):
    jh, th = jax_metrics.LatencyHistogram(), metrics.LatencyHistogram()
    jw = jax_metrics.WindowedLatency(clock=FakeClock())
    tw = metrics.WindowedLatency(clock=FakeClock())
    for s in latencies:
        for h in (jh, th, jw, tw):
            h.record(s)
    assert th.percentile_ms(q) == jh.percentile_ms(q)
    assert th.snapshot() == jh.snapshot()
    assert th.prometheus_buckets() == jh.prometheus_buckets()
    assert tw.snapshot() == jw.snapshot()
    assert tw.to_dict() == jw.to_dict()
    assert metrics.WindowedLatency.wire_stats(tw.to_dict()) == \
        jax_metrics.WindowedLatency.wire_stats(jw.to_dict())
    assert metrics.WindowedLatency.merge_dicts([tw.to_dict(), tw.to_dict()]) == \
        jax_metrics.WindowedLatency.merge_dicts([jw.to_dict(), jw.to_dict()])


@pytest.mark.parametrize("value", ["DCN", 'he"llo', "a\\b", "line\nbreak", 'mix\\"\n', 7, ""])
def test_escape_label_value_equals_the_jax_package_s(value):
    assert metrics.escape_label_value(value) == jax_metrics.escape_label_value(value)


def test_the_model_label_cap_is_the_jax_package_s():
    jm, tm, _ = _pair()
    for i in range(metrics.ServerMetrics.MAX_MODEL_LABELS + 5):
        jm.observe("Predict", 0.001, True, model=f"m{i}")
        tm.observe("Predict", 0.001, True, model=f"m{i}")
    snap = tm.snapshot()
    assert snap == jm.snapshot() and "_other" in snap["models"]
    assert len(snap["models"]) == metrics.ServerMetrics.MAX_MODEL_LABELS + 1
