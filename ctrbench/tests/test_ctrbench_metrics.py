"""The end-to-end readers take every sample of the window, and the trace
readers reduce a device timeline as described."""

import types

import numpy as np
import pytest

from ctrbench.harness import devtrace, spec


def _ctx(lat_ms, n=None, in_window=None):
    lat = np.asarray(lat_ms, np.float64) / 1e3
    n = np.full(lat.size, 100) if n is None else np.asarray(n)
    done = np.ones(lat.size, bool) if in_window is None else np.asarray(in_window)
    return types.SimpleNamespace(load={"latency_s": lat, "n": n, "done_in_window": done},
                                 seconds=10.0)


def test_percentiles_are_over_all_samples_and_see_one_stall():
    rng = np.random.default_rng(0)
    lat = 5.0 + rng.random(199)
    p95 = spec.reader("p95_ms.host")
    p50 = spec.reader("p50_ms")
    base95, base50 = p95.read(_ctx(lat)), p50.read(_ctx(lat))
    # Eleven stalls of a second among 210 samples move the tail, not the median
    # by much; the tail is the 95th percentile of every sample, not a mean
    # of chunk percentiles.
    stalled = np.concatenate([lat, np.full(11, 1000.0)])
    assert p95.read(_ctx(stalled)) > 10 * base95
    assert p50.read(_ctx(stalled)) == pytest.approx(base50, rel=0.05)
    assert p95.read(_ctx(stalled)) == pytest.approx(np.percentile(stalled, 95))


def test_candidates_per_s_counts_answers_inside_the_window():
    r = spec.reader("candidates_per_s")
    ctx = _ctx([1, 1, 1], n=[1500, 1500, 700], in_window=[True, True, False])
    assert r.read(ctx) == pytest.approx(300.0)


def _events():
    ev = []
    t = 0.0
    for i in range(4):
        ev.append({"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> Device)",
                   "ts": t, "dur": 10, "args": {"bytes": 2048 * 215}})
        ev.append({"ph": "X", "cat": "kernel", "name": "unpack", "ts": t + 12, "dur": 4})
        ev.append({"ph": "X", "cat": "kernel", "name": "void fused_serve_bf16_kernel<1>",
                   "ts": t + 20, "dur": 68})
        ev.append({"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pinned)",
                   "ts": t + 90, "dur": 2})
        t += 1000
    return ev


def test_trace_reduction_busy_steps_and_gaps():
    r = devtrace.reduce_events(_events(), 0.0, 4000.0)
    assert r.window_s == pytest.approx(4e-3)
    assert r.busy_s == pytest.approx(4 * (10 + 4 + 68 + 2) * 1e-6)
    assert len(r.steps) == 4 and r.steps[0].span_s == pytest.approx(76e-6)
    assert r.gaps[0][0] == pytest.approx((1000 - 92) * 1e-6)
    assert r.by_name["void fused_serve_bf16_kernel<1>"] == pytest.approx(4 * 68e-6)


def _trace_ctx():
    bench = spec.Bench()
    cell = bench.cell("dcn43-ref6-closed")
    red = devtrace.reduce_events(_events(), 0.0, 4000.0)
    red.stats = {"candidates": 4 * 1500}
    return types.SimpleNamespace(trace=red, device_name="NVIDIA H100 80GB HBM3", cell=cell,
                                 model=cell.config["model"],
                                 flops=lambda: spec.flops("dcn_v2"))


def test_roofline_and_mfu_from_the_trace():
    ctx = _trace_ctx()
    fl = spec.flops("dcn_v2")
    ops, nbytes = fl.fused_serve_cost(ctx.model, 2048)
    bound = max(ops / 989e12, nbytes / 3.35e12)
    assert spec.reader("fused_serve_roofline").read(ctx) == pytest.approx(100 * bound / 68e-6)
    mfu = 100 * 4 * 1500 * fl.flops_per_row(ctx.model) / (4 * 76e-6) / 989e12
    assert spec.reader("step_mfu").read(ctx) == pytest.approx(mfu)
    idle = spec.reader("device_idle_frac").read(ctx)
    assert idle == pytest.approx(1 - 4 * 84e-6 / 4e-3)


def test_readers_give_nothing_rather_than_zero():
    ctx = _trace_ctx()
    ctx.device_name = "some other card"
    assert spec.reader("fused_serve_roofline").read(ctx) is None
    assert spec.reader("step_mfu").read(ctx) is None
    ctx = _trace_ctx()
    for s in ctx.trace.steps:
        s.h2d_bytes = 12345  # not one bucket's batch
    assert spec.reader("fused_serve_roofline").read(ctx) is None
