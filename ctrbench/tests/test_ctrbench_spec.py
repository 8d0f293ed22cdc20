"""Everything is found by name, and a new cell, configuration, traffic or
metric is picked up from new files and entries alone."""

import json
import shutil

import pytest

from ctrbench.harness import spec


def test_every_named_file_is_found():
    bench = spec.Bench()
    doc = bench.doc
    for c in doc["configs"]:
        cfg = bench.config(c["name"])
        assert cfg["name"] == c["name"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        assert c["file"] == f"ctrbench/configs/{c['name']}.json"
        spec.reference(cfg["kind"]).make_params
        spec.flops(cfg["kind"]).flops_per_row
    for w in doc["workloads"]:
        cell = bench.cell(w["name"])
        assert cell.chips == w["chips"]
        assert cell.traffic["loop"] in ("closed", "open")
        for per_layer in (False, True):
            assert bench.metrics(w["name"], per_layer)
    for m in doc["end_to_end"] + doc["per_layer"]:
        assert callable(spec.reader(m["name"]).read)


def test_each_cell_reports_what_its_layer_metrics_move():
    doc = spec.Bench().doc
    e2e = {m["name"]: m for m in doc["end_to_end"]}
    for m in doc["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads") or [w["name"] for w in doc["workloads"]]:
            assert "workloads" not in moved or cell in moved["workloads"], (m["name"], cell)


@pytest.fixture
def copy(tmp_path):
    root = spec.ROOT
    shutil.copy(root / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(root / "ctrbench", tmp_path / "ctrbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return tmp_path


def test_a_new_cell_and_metric_are_files_and_entries(copy):
    doc = json.loads((copy / "BENCHMARK.json").read_text())
    traffic = json.loads((copy / "ctrbench/workloads/ref6-closed-1500.json").read_text())
    traffic["clients"] = 3
    (copy / "ctrbench/workloads/throwaway-traffic.json").write_text(json.dumps(traffic))
    (copy / "ctrbench/metrics/throwaway_metric.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    doc["workloads"].append({"name": "throwaway-cell", "config": "dcn_v2-ref43",
                             "traffic": "throwaway-traffic", "chips": 1, "why": "test"})
    doc["per_layer"].append({"name": "throwaway_metric", "unit": "us", "better": "lower",
                             "source": "program_span", "layer": "batcher", "moves": "p50_ms",
                             "workloads": ["throwaway-cell"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(doc))
    bench = spec.Bench(root=copy, bench_dir=copy / "ctrbench")
    cell = bench.cell("throwaway-cell")
    assert cell.traffic["clients"] == 3 and cell.config["kind"] == "dcn_v2"
    names = [m.name for m in bench.metrics("throwaway-cell", per_layer=True)]
    assert "throwaway_metric" in names
    assert bench.metrics("throwaway-cell", per_layer=True)[-1].reader.read(None) == 42.0
    assert "throwaway_metric" not in [m.name for m in bench.metrics("dcn43-ref6-closed", True)]


def test_unknown_names_are_refused(copy):
    bench = spec.Bench(root=copy, bench_dir=copy / "ctrbench")
    with pytest.raises(KeyError):
        bench.cell("no-such-cell")
    with pytest.raises(FileNotFoundError):
        spec.reader("no_such_metric", copy / "ctrbench")
