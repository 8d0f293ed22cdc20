"""The plain references agree with the program's forward on the CPU at tiny
widths (the program in float32 compute; this test may import the program,
the references may not)."""

import ast
import pathlib

import numpy as np
import pytest
import torch

from ctrbench.harness import spec
from ctrbench.harness.replica import model_config
from ctrbench.harness.traffic import Traffic
from distributed_tf_serving_tpu_torch.models import build_model

TINY = {
    "dcn_v2": {"name": "DCN", "num_fields": 5, "vocab_size": 97, "embed_dim": 4,
               "mlp_dims": [16, 8], "num_cross_layers": 2, "compute_dtype": "float32",
               "param_dtype": "float32"},
    "dlrm": {"name": "DLRM", "num_fields": 4, "num_dense_features": 3, "vocab_size": 97,
             "embed_dim": 8, "bottom_mlp_dims": [16, 8], "mlp_dims": [32, 16],
             "compute_dtype": "float32", "param_dtype": "float32"},
}


@pytest.mark.parametrize("kind", sorted(TINY))
def test_reference_matches_the_program_forward(kind):
    model = TINY[kind]
    ref = spec.reference(kind)
    params = ref.make_params(model, 3_000_000_019, "cpu")
    prog = build_model(kind, model_config({"kind": kind, "model": model}))
    t = Traffic("t", {"loop": "closed", "candidates": {"dist": "fixed", "n": 33},
                      "ids": {"dist": "uniform", "low": 0, "high": 2 ** 40},
                      "weights": {"dist": "uniform"},
                      "dense": {"dist": "log1p_lognormal", "mu": 1.0, "sigma": 1.5}})
    inputs = t.request(5, 0, 0, 33, model["num_fields"], model.get("num_dense_features", 0)
                       if kind == "dlrm" else 0)
    batch = {k: torch.from_numpy(v) for k, v in inputs.items()}
    with torch.inference_mode():
        want = prog.apply(params, batch)["prediction_node"].numpy()
        got = ref.forward(params, batch, model).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    assert 0.05 < float(np.std(got)) or kind == "dlrm"  # not a saturated head


@pytest.mark.parametrize("name", ["common", "dcn_v2", "dlrm"])
def test_references_import_nothing_of_the_program(name):
    src = (pathlib.Path(spec.BENCH_DIR) / "reference" / f"{name}.py").read_text()
    tops = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    assert tops <= {"__future__", "math", "torch", "importlib", "pathlib"}, tops


def test_weights_are_a_function_of_the_seed():
    ref = spec.reference("dcn_v2")
    a = ref.make_params(TINY["dcn_v2"], 11, "cpu")
    b = ref.make_params(TINY["dcn_v2"], 11, "cpu")
    c = ref.make_params(TINY["dcn_v2"], 12, "cpu")
    assert torch.equal(a["embedding"], b["embedding"])
    assert torch.equal(a["cross"][1]["w"], b["cross"][1]["w"])
    assert not torch.equal(a["embedding"], c["embedding"])
    assert a["mlp"][0]["w"].shape == (20, 16) and a["out"]["w"].shape == (28, 1)
