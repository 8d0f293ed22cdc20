"""The comparison that decides `correct` can fail: the precision control
(the plain reference computed with float8 operands in the program's place)
misses each configuration's limit, and a whole run on the CPU whose timed
path alters answers where they are produced comes out not correct, while
the same run unbroken comes out correct."""

import dataclasses
import io
import json
import shutil
import contextlib

import numpy as np
import pytest
import torch

from ctrbench.harness import check, runner, spec
from ctrbench.harness.traffic import Traffic

SEED = 3_000_000_019


@pytest.mark.parametrize("config", ["dcn_v2-ref43", "dlrm-mlperf"])
def test_fp8_control_misses_the_limit_at_full_width(config):
    cfg = spec.Bench().config(config)
    cfg = dict(cfg, model=dict(cfg["model"], vocab_size=1 << 14))
    traffic = Traffic("t", {"loop": "closed", "candidates": {"dist": "fixed", "n": 512},
                            "ids": {"dist": "uniform", "low": 0, "high": 2 ** 40},
                            "weights": {"dist": "uniform" if cfg["kind"] == "dcn_v2" else "one"},
                            "dense": {"dist": "log1p_lognormal", "mu": 1.0, "sigma": 1.5}})
    sample = [(0, k, 512, None) for k in range(2)]
    ref = check.reference_scores(cfg, traffic, SEED, sample, "cpu")
    control = check.reference_scores(cfg, traffic, SEED, sample, "cpu", precision="fp8")
    assert check.score_gap(control, ref) > cfg["check"]["score_max_abs_err"]
    assert check.score_gap(ref, ref) == 0.0


def _tiny_bench(tmp_path):
    root = spec.ROOT
    shutil.copy(root / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(root / "ctrbench", tmp_path / "ctrbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cpath = tmp_path / "ctrbench/configs/dcn_v2-ref43.json"
    cfg = json.loads(cpath.read_text())
    cfg["model"]["vocab_size"] = 4096
    cfg["server"]["buckets"] = [64, 128, 256]
    cpath.write_text(json.dumps(cfg))
    tpath = tmp_path / "ctrbench/workloads/ref6-closed-1500.json"
    t = json.loads(tpath.read_text())
    t.update(clients=2, candidates={"dist": "fixed", "n": 100}, sample_requests=4)
    tpath.write_text(json.dumps(t))
    return spec.Bench(root=tmp_path, bench_dir=tmp_path / "ctrbench")


def _run(bench):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = runner.run(["--workload", "dcn43-ref6-closed", "--seed", str(SEED),
                         "--seconds", "1.5", "--trace", "0"], device_override="cpu",
                        bench=bench)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def _altered(model):
    """The model with every 7th row's score moved by 0.05 where it is
    produced."""
    def apply(params, batch):
        out = dict(model.apply(params, batch))
        s = out["prediction_node"].clone()
        s[::7] = s[::7] + 0.05
        out["prediction_node"] = s
        return out

    return dataclasses.replace(model, apply=apply)


def test_a_sound_run_is_correct(tmp_path):
    line = _run(_tiny_bench(tmp_path))
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert list(line)[-1] == "check"
    assert line["check"]["score_max_abs_err"]["value"] <= line["check"]["score_max_abs_err"]["limit"]


def test_a_run_with_altered_answers_is_not_correct(tmp_path, monkeypatch):
    import distributed_tf_serving_tpu_torch.models as models

    real = models.build_model
    monkeypatch.setattr(models, "build_model", lambda *a, **k: _altered(real(*a, **k)))
    line = _run(_tiny_bench(tmp_path))
    assert line["correct"] is False
    assert line["check"]["score_max_abs_err"]["value"] > 0.04


def test_a_run_without_a_card_prints_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = runner.main(["--workload", "dcn43-ref6-closed", "--seed", "1", "--seconds", "1",
                      "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out.strip() == "" and "cuda" in out.err.lower()


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["dcn_v2-ref43", "dlrm-mlperf"])
def test_fp8_control_misses_the_limit_on_the_card(card, config):
    cfg = spec.Bench().config(config)
    traffic = Traffic("t", {"loop": "closed", "candidates": {"dist": "fixed", "n": 2048},
                            "ids": {"dist": "uniform", "low": 0, "high": 2 ** 40},
                            "weights": {"dist": "uniform" if cfg["kind"] == "dcn_v2" else "one"},
                            "dense": {"dist": "log1p_lognormal", "mu": 1.0, "sigma": 1.5}})
    sample = [(0, k, 2048, None) for k in range(4)]
    ref = check.reference_scores(cfg, traffic, SEED, sample, card)
    control = check.reference_scores(cfg, traffic, SEED, sample, card, precision="fp8")
    assert check.score_gap(control, ref) > cfg["check"]["score_max_abs_err"]
    assert np.isfinite(check.score_gap(ref, ref))


class _ThreadProc:
    """The load generator on a thread of this process (so a fault planted
    in the program's client here reaches it), with the Process surface the
    runner uses."""

    def __init__(self, target, args):
        import threading

        self.exitcode = None
        self._t = threading.Thread(target=target, args=args, daemon=True)
        self._t.start()

    def is_alive(self):
        return self._t.is_alive()

    def join(self, timeout=None):
        self._t.join(timeout)

    def terminate(self):
        pass


def _loadgen_on_a_thread(job):
    import multiprocessing as mp

    from ctrbench.harness import loadgen

    parent, child = mp.Pipe()
    return _ThreadProc(loadgen.main, (child, job)), parent


def _tiny_fanout(tmp_path):
    bench = _tiny_bench(tmp_path)
    doc = json.loads((tmp_path / "BENCHMARK.json").read_text())
    if not any(w["name"] == "dcn43-fanout4-closed" for w in doc["workloads"]):
        doc["workloads"].append({"name": "dcn43-fanout4-closed", "config": "dcn_v2-ref43",
                                 "traffic": "ref6-fanout4-closed", "chips": 4, "why": "test"})
    for w in doc["workloads"]:
        if w["name"] == "dcn43-fanout4-closed":
            w["chips"] = 2  # two CPU replica processes stand for the cards here
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    tpath = tmp_path / "ctrbench/workloads/ref6-fanout4-closed.json"
    t = json.loads(tpath.read_text())
    t.update(clients=2, candidates={"dist": "fixed", "n": 100}, sample_requests=4)
    tpath.write_text(json.dumps(t))
    return spec.Bench(root=tmp_path, bench_dir=tmp_path / "ctrbench")


def _run_fanout(bench):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = runner.run(["--workload", "dcn43-fanout4-closed", "--seed", str(SEED),
                         "--seconds", "1.5", "--trace", "0"], device_override="cpu",
                        bench=bench)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("fault", [None, "shard_left_out"])
def test_fanout_run_and_a_shard_left_out_of_the_merge(tmp_path, monkeypatch, fault):
    import distributed_tf_serving_tpu_torch.client.client as client_mod

    monkeypatch.setattr(runner, "start_loadgen", _loadgen_on_a_thread)
    if fault:
        real = client_mod.merge_host_order
        monkeypatch.setattr(client_mod, "merge_host_order", lambda results: real(
            [*results[:-1], np.zeros_like(np.asarray(results[-1]))]))
    line = _run_fanout(_tiny_fanout(tmp_path))
    assert line["device"]["count"] == 2 and line["attempted"] > 0
    assert line["correct"] is (fault is None)
