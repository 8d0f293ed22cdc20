"""The span plane's readings and gap labels (ctrbench/harness/spans.py):
each reading on a hand-built slice, the program's spans joining a device
trace's host events without moving anything but the gap labels, and whole
CPU runs with the plane on over the profiled slice and over the window."""

import contextlib
import io
import json

import pytest

from ctrbench.harness import devtrace, runner, spans
from test_ctrbench_correct import SEED, _tiny_bench
from test_ctrbench_metrics import _events


def _span(name, start, dur, root=False, **kw):
    return {"name": name, "start_us": start, "duration_us": dur, "attrs": kw.pop("attrs", {}),
            "root": root, **kw}


def _slice():
    sp = [
        _span("server.Predict", 0, 10_000, root=True),
        _span("predict.decode", 100, 3_000, tid=11, thread="rpc_0", cpu_us=1_000),
        _span("batch.queue_wait", 3_100, 5_000, wait=True),
        _span("batch.collect_wait", 3_100, 4_000, wait=True),
        _span("batch.stage_wait", 7_100, 1_000, wait=True),
        _span("server.Predict", 0, 12_000, root=True),
        _span("predict.decode", 200, 1_000, tid=12, thread="rpc_1", cpu_us=500),
        _span("batch.queue_wait", 1_200, 7_000, wait=True),
        _span("batch.collect_wait", 1_200, 6_000, wait=True),
        _span("batch.stage_wait", 7_200, 1_000, wait=True),
    ]
    # One batch of both requests (its dispatch replayed onto each), and a
    # batch of one.
    for _ in range(2):
        sp.append(_span("batch.dispatch", 8_200, 400, tid=13, thread="batch-dispatch",
                        cpu_us=100, attrs={"batch": 1, "bucket": 64, "rows": 40}))
    sp.append(_span("batch.dispatch", 9_000, 600, tid=13, thread="batch-dispatch",
                    cpu_us=300, attrs={"batch": 2, "bucket": 64, "rows": 20}))
    cpu = {"rpc": 0.6, "batcher": 0.1, "batch-dispatch": 0.4, "batch-complete": 0.2,
           "other": 0.1, "process": 2.5}
    return spans.Slice(spans=sp, clock={"perf_us": 0, "unix_us": 0}, thread_cpu=cpu,
                       seconds=2.0)


def test_each_reading_on_a_hand_built_slice():
    sl = _slice()
    assert spans.decode_cpu_us(sl) == pytest.approx(750.0)
    assert spans.collect_wait_us(sl) == pytest.approx(5_000.0)
    assert spans.stage_wait_us(sl) == pytest.approx(1_000.0)
    # Batch 1 once: 1 - (100 + 300) / (400 + 600).
    assert spans.dispatch_offcpu_frac(sl) == pytest.approx(0.6)
    assert spans.py_cpu_cores(sl) == pytest.approx(1.4 / 2.0)


def test_readings_are_none_without_the_program_s_new_fields():
    sl = _slice()
    for s in sl.spans:
        s.pop("cpu_us", None)
    sl.spans = [s for s in sl.spans if s["name"] not in ("batch.collect_wait",
                                                           "batch.stage_wait")]
    sl.thread_cpu = None
    for name, (_, fn) in spans.READINGS.items():
        assert fn(sl) is None, name


def test_work_events_leave_waits_roots_and_repeats_out():
    ev = spans.work_events(_slice().spans, shift_us=1_000.0)
    assert [(e["name"], e["ts"], e["tid"]) for e in ev] == [
        ("predict.decode", 1_100.0, 11), ("predict.decode", 1_200.0, 12),
        ("batch.dispatch", 9_200.0, 13), ("batch.dispatch", 10_000.0, 13)]
    assert all(e["cat"] == "user_annotation" for e in ev)


def test_program_spans_move_nothing_but_the_gap_labels():
    events = _events()
    # A work span over the middle of the first gap (92 -> 1000 us), and one
    # shorter over the middle of the second, inside a wider one.
    sp = [_span("predict.decode", 300, 400, tid=11, cpu_us=350),
          _span("batch.fusedpack", 1_500, 100, tid=13, cpu_us=90),
          _span("readback.wait", 1_200, 700, tid=14, cpu_us=10)]
    plain = devtrace.reduce_events(events, 0.0, 4000.0)
    merged = devtrace.reduce_events(events + spans.work_events(
        [dict(s, root=False, attrs={}) for s in sp], 0.0), 0.0, 4000.0)
    assert merged.busy_s == plain.busy_s and merged.window_s == plain.window_s
    assert merged.by_name == plain.by_name
    assert [(s.h2d_bytes, s.span_s, s.kernels) for s in merged.steps] == [
        (s.h2d_bytes, s.span_s, s.kernels) for s in plain.steps]
    assert [g[0] for g in merged.gaps] == [g[0] for g in plain.gaps]
    labels = {g[1].split(";")[0] for g in merged.gaps}
    assert all("no traced host op" in g[1] for g in plain.gaps if g[1])
    assert {"host: predict.decode", "host: batch.fusedpack"} <= labels


def test_idle_split_sums_every_gap_by_the_span_over_its_middle():
    work = spans.work_events([_span("predict.decode", 300, 400, tid=11, cpu_us=350, root=False),
                              _span("batch.fusedpack", 1_500, 100, tid=13, cpu_us=90,
                                    root=False)], 0.0)
    split = spans.idle_split(_events(), work, 0.0, 4000.0)
    plain = devtrace.reduce_events(_events(), 0.0, 4000.0)
    assert sum(split.values()) == pytest.approx(sum(g[0] for g in plain.gaps))
    assert split["predict.decode"] == pytest.approx(908e-6)
    assert split["batch.fusedpack"] == pytest.approx(908e-6)
    assert set(split) == {"predict.decode", "batch.fusedpack", "none"}


def test_clock_offsets_pair_each_marker_with_its_interval():
    events = [{"ph": "X", "name": spans.CLOCK_MARK, "ts": 1_010.0, "dur": 2.0},
              {"ph": "X", "name": "other", "ts": 5.0, "dur": 1.0},
              {"ph": "X", "name": spans.CLOCK_MARK, "ts": 9_000.0, "dur": 4.0}]
    got = spans.clock_offsets_us(events, [(0.008995, 0.009005), (0.001, 0.00102)], 0.0)
    assert got[0] == pytest.approx((1_011.0 - 1_010.0, 10.0))
    assert got[1] == pytest.approx((9_002.0 - 9_000.0, 5.0))
    wide, narrow = (30.0, 900.0), (-4.0, 6.0)
    assert spans.tightest([wide, narrow, (1.0, 8.0), wide]) == [narrow, (1.0, 8.0)]


def _line(fn, argv, bench):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(["--workload", "dcn43-ref6-closed", "--seed", str(SEED), "--seconds", "3",
                 *argv], device_override="cpu", bench=bench)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_a_traced_cpu_run_reports_the_readings_beside_run_py_s_metrics(tmp_path):
    from distributed_tf_serving_tpu_torch.utils import tracing

    bench = _tiny_bench(tmp_path)
    plain = _line(runner.run, ["--trace", "1"], bench)
    line = _line(spans.run, [], bench)
    assert line["correct"] is True and plain["correct"] is True
    assert set(line["metrics"]) == set(plain["metrics"]) | set(spans.READINGS)
    for name in spans.READINGS:
        assert line["metrics"][name]["value"] is not None, name
    assert 0 < line["metrics"]["decode_cpu_us"]["value"]
    assert not tracing.enabled()
    assert devtrace.profile_slice is not None and devtrace.profile_slice.__module__ == (
        devtrace.__name__)


def test_a_window_run_prices_the_plane_and_turns_it_off(tmp_path):
    from distributed_tf_serving_tpu_torch.utils import tracing

    line = _line(spans.run, ["--plane", "window"], _tiny_bench(tmp_path))
    assert line["correct"] is True and "p50_ms" in line["metrics"]
    assert line["metrics"]["collect_wait_us"]["value"] > 0
    assert "py_cpu_cores" not in line["metrics"]  # the threads ended with the replica
    assert not tracing.enabled()
