"""Finds everything by name: a cell in BENCHMARK.json, its configuration in
`ctrbench/configs/<config>.json`, its traffic in
`ctrbench/workloads/<traffic>.json`, a metric's reader in
`ctrbench/metrics/<metric>.py`, a model kind's plain reference in
`ctrbench/reference/<kind>.py` and its operation counts in
`ctrbench/flops/<kind>.py`. Adding a cell, a configuration or a metric is
adding files and entries; nothing here changes."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def _load_module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    return json.loads(path.read_text())


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    workloads: tuple[str, ...] | None
    reader: object  # the module with read(ctx)

    def applies_to(self, cell: str) -> bool:
        return self.workloads is None or cell in self.workloads


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict


class Bench:
    """BENCHMARK.json and the files it names, under `bench_dir`."""

    def __init__(self, root: Path = ROOT, bench_dir: Path = BENCH_DIR):
        self.root = Path(root)
        self.bench_dir = Path(bench_dir)
        self.doc = _json(self.root / "BENCHMARK.json")

    def cell(self, name: str) -> Cell:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return Cell(name=name, config_name=w["config"], traffic_name=w["traffic"],
                            chips=int(w["chips"]), config=self.config(w["config"]),
                            traffic=self.traffic(w["traffic"]))
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return _json(self.bench_dir / "configs" / f"{name}.json")

    def traffic(self, name: str) -> dict:
        return _json(self.bench_dir / "workloads" / f"{name}.json")

    def metrics(self, cell: str, per_layer: bool) -> list[Metric]:
        """The metrics a run of `cell` reports: its end-to-end metrics, or
        with per_layer its per-layer ones."""
        out = []
        for m in self.doc["per_layer" if per_layer else "end_to_end"]:
            ws = m.get("workloads")
            metric = Metric(name=m["name"], unit=m["unit"],
                            workloads=tuple(ws) if ws is not None else None, reader=None)
            if metric.applies_to(cell):
                metric.reader = reader(m["name"], self.bench_dir)
                out.append(metric)
        return out


def reader(name: str, bench_dir: Path = BENCH_DIR):
    """The module `metrics/<name>.py`, which defines read(ctx) -> float | None."""
    return _load_module(bench_dir / "metrics" / f"{name}.py", f"ctrbench_metric_{name}")


def reference(kind: str, bench_dir: Path = BENCH_DIR):
    """The plain reference of a model kind: make_params and forward."""
    return _load_module(bench_dir / "reference" / f"{kind}.py", f"ctrbench_reference_{kind}")


def flops(kind: str, bench_dir: Path = BENCH_DIR):
    """The operation and byte counts of a model kind and its kernels."""
    return _load_module(bench_dir / "flops" / f"{kind}.py", f"ctrbench_flops_{kind}")
