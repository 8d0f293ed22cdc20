"""The `dlrm-mlperf-shard8` configuration and the readers of its cell's two
new metrics: the configuration is MLPerf's widths on at least an eighth of
the Criteo Terabyte rows, the interaction kernel's counts match counts by
hand, and `hostpack_us` and `dlrm_interact_roofline` read nothing where the
program has no such span or kernel and a value where it has."""

import types

import pytest

from ctrbench.harness import devtrace, spec

CRITEO_TB_ROWS = 188_000_000  # the 26 tables capped at 40M rows (--max-ind-range)
H100 = "NVIDIA H100 80GB HBM3"


def test_the_configuration_is_mlperf_widths_on_an_eighth_of_the_rows():
    bench = spec.Bench()
    cfg = bench.config("dlrm-mlperf-shard8")
    assert cfg["name"] == "dlrm-mlperf-shard8" and cfg["kind"] == "dlrm"
    assert cfg["reduced"] == ["vocab_size"]
    model = cfg["model"]
    assert model["vocab_size"] * 8 >= CRITEO_TB_ROWS
    assert model["vocab_size"] > 1 << 24  # past the 24-bit id wire
    assert model["vocab_size"] * model["embed_dim"] * 4 < 80e9 / 4  # a quarter of the card
    base = bench.config("dlrm-mlperf")
    assert {k: v for k, v in model.items() if k != "vocab_size"} == {
        k: v for k, v in base["model"].items() if k != "vocab_size"}
    assert cfg["server"] == base["server"] and cfg["source"] == base["source"]
    (entry,) = [c for c in bench.doc["configs"] if c["name"] == "dlrm-mlperf-shard8"]
    assert entry["reduced"] == cfg["reduced"]
    cell = bench.cell("dlrm-mlperf-open")
    assert cell.chips == 1 and cell.traffic_name == "mlperf-server-open"
    assert 0 < cfg["check"]["score_max_abs_err"] < 0.1


def test_interaction_counts_at_one_row():
    m = spec.Bench().config("dlrm-mlperf-shard8")["model"]
    fl = spec.flops("dlrm_interact")
    assert fl.pairs(m) == 27 * 26 // 2 == 351
    ops, nbytes = fl.interact_cost(m, 1)
    assert ops == 2 * 351 * 128 == 89_856
    by_hand = 26 * 128 * 4 + 26 * 4 + 26 * 2 + 128 * 4 + (128 + 351) * 2
    assert nbytes == by_hand == 14_938
    assert fl.interact_cost(m, 512) == (512 * ops, 512 * nbytes)
    # Padding rows (ids 0) read no table bytes: 300 real rows of 512.
    table = 26 * 128 * 4
    assert fl.interact_cost(m, 512, real=300) == (512 * ops, 512 * (nbytes - table) + 300 * table)
    assert fl.wire_bytes_per_row(m) == 26 * 4 + 26 * 2 + 13 * 4 == 208
    # A 512-row batch's bound (the ~2 us of PERF.md): bytes over 3.35 TB/s.
    assert fl.interact_cost(m, 512)[1] / 3.35e12 == pytest.approx(2.283e-6, rel=1e-3)


def _ctx(window=None, events=None, stats=None):
    cell = spec.Bench().cell("dlrm-mlperf-open")
    trace = devtrace.reduce_events(events, 0.0, 4000.0) if events is not None else None
    if trace is not None:
        trace.stats = stats
    return types.SimpleNamespace(window=window, trace=trace, device_name=H100, cell=cell,
                                 model=cell.config["model"])


def _events(rows, kernel="void dlrm_interact_bf16_kernel<float>(int const*, "
                         "__nv_bfloat16 const*, float const*, int)"):
    ev = []
    for i, n in enumerate(rows):
        t = 1000.0 * i
        ev.append({"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> Device)",
                   "ts": t, "dur": 5, "args": {"bytes": n * 208}})
        ev.append({"ph": "X", "cat": "kernel", "name": "gemm", "ts": t + 10, "dur": 20})
        ev.append({"ph": "X", "cat": "kernel", "name": kernel, "ts": t + 40, "dur": 10})
    return ev


def test_hostpack_us_reads_the_span_per_batch():
    r = spec.reader("hostpack_us")
    assert r.read(_ctx(window={"phases": {}, "stats": {}})) is None
    assert r.read(_ctx(window={"phases": {"batch.fusedpack": {"seconds": 1.0, "count": 4}}})) \
        is None
    ctx = _ctx(window={"phases": {"batch.hostpack": {"seconds": 0.003, "count": 12}}})
    assert r.read(ctx) == pytest.approx(250.0)


def test_dlrm_interact_roofline_reads_the_kernel_by_name():
    """Each call's bound from its bucket, with the slice's share of
    requests' rows gathering table rows and the padding none."""
    r = spec.reader("dlrm_interact_roofline")
    full = {"candidates": 1536, "padded_candidates": 1536}
    assert r.read(_ctx()) is None  # no trace
    assert r.read(_ctx(events=_events([512, 1024], kernel="fused_serve_bf16_kernel"),
                       stats=full)) is None
    assert r.read(_ctx(events=_events([500]), stats=full)) is None  # not one bucket's copy
    assert r.read(_ctx(events=_events([512, 1024]))) is None  # no counters over the slice
    m = spec.Bench().config("dlrm-mlperf-shard8")["model"]
    fl = spec.flops("dlrm_interact")
    bound = sum(fl.interact_cost(m, n)[1] / 3.35e12 for n in (512, 1024))
    got = r.read(_ctx(events=_events([512, 1024]), stats=full))
    assert got == pytest.approx(100.0 * bound / 20e-6)
    assert 0 < got <= 100
    # Two thirds of the rows real: a third of the calls' rows read no table.
    padded = r.read(_ctx(events=_events([512, 1024]),
                         stats={"candidates": 1024, "padded_candidates": 1536}))
    bound = sum(fl.interact_cost(m, n, real=n * 2 / 3)[1] / 3.35e12 for n in (512, 1024))
    assert padded == pytest.approx(100.0 * bound / 20e-6) and padded < 0.71 * got
