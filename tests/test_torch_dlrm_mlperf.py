"""DLRM at the MLPerf widths (facebookresearch/dlrm run_and_time.sh: 26
sparse fields x 128, 13 dense features, bottom MLP 13-512-256-128, top MLP
1024-1024-512-256-1) against the benchmark's plain float32 reference
(ctrbench/reference/dlrm.py, loaded by path as the benchmark loads it), at
a small table on the CPU; and the path a table past 2^24 rows takes: int32
ids in the combined buffer, the `batch.hostpack` span of the three-input
pack.

Tolerances, max |score - reference| over 256 rows of seeded inputs:
- float32 compute: 1e-5 (the ROADMAP's f32 parity: only the order of the
  sums may differ from the reference; on the CPU the gap reads 0). The
  bf16 port misses it by two orders.
- bfloat16 compute: BF16_TOL = 0.02. The port rounds the table rows, the
  weights, their products, Z and every MLP operand to bf16 (8-bit
  significands) against the reference's float32: the gap reads 0.0058 here
  (0.0044-0.0083 over five other weight and input seeds). The float8 e4m3
  control (the reference with float8 operands, 4-bit significands) reads
  0.068 here (0.068-0.144) and must miss it: the limit sits about 3.4x
  from either reading, so the test tells bf16 from the precision below.
"""

import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from distributed_tf_serving_tpu_torch.models import (
    ModelConfig,
    Servable,
    build_model,
    ctr_signatures,
)
from distributed_tf_serving_tpu_torch.ops.transfer import (
    U24_MAX,
    combined_layout,
    pack_host_combined,
    transfer_spec,
    unpack_device_combined,
)
from distributed_tf_serving_tpu_torch.serving.batcher import DynamicBatcher, fold_ids_host
from distributed_tf_serving_tpu_torch.utils import tracing
from distributed_tf_serving_tpu_torch.utils.tracing import request_trace

REPO = Path(__file__).resolve().parents[1]
MLPERF = dict(name="DLRM", num_fields=26, num_dense_features=13, embed_dim=128,
              bottom_mlp_dims=(512, 256, 128), mlp_dims=(1024, 1024, 512, 256),
              param_dtype="float32")
ROWS = 256
F32_TOL = 1e-5
BF16_TOL = 0.02
SEED = 3_000_000_019


def _load(name: str):
    path = REPO / "ctrbench" / "reference" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"ctrbench_reference_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(vocab: int, n: int = ROWS, seed: int = 7) -> dict[str, np.ndarray]:
    """The benchmark's request shape: ids over [0, 2^40) (folded by the
    server), weights 1.0, dense features log1p of lognormal counts."""
    rng = np.random.default_rng(seed)
    return {
        "feat_ids": rng.integers(0, 1 << 40, size=(n, 26), dtype=np.int64),
        "feat_wts": np.ones((n, 26), np.float32),
        "dense_features": np.log1p(np.floor(np.exp(rng.normal(1.0, 1.5, (n, 13))))
                                   ).astype(np.float32),
    }


@pytest.fixture(scope="module")
def scored():
    """Scores at the MLPerf widths, vocab 2^12: the port in both compute
    dtypes, the float32 reference and the float8 control, all on the same
    seeded weights."""
    ref = _load("dlrm")
    model = dict(MLPERF, vocab_size=1 << 12, compute_dtype="bfloat16")
    params = ref.make_params(model, SEED, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in _inputs(model["vocab_size"]).items()}
    out = {}
    with torch.inference_mode():
        for cd in ("float32", "bfloat16"):
            cfg = ModelConfig(**{**model, "compute_dtype": cd})
            out[cd] = build_model("dlrm", cfg).apply(params, batch)["prediction_node"]
        out["reference"] = ref.forward(params, batch, model)
        out["fp8"] = ref.forward(params, batch, model, "fp8")
    return {k: v.double().numpy() for k, v in out.items()}


def _gap(a, b) -> float:
    return float(np.max(np.abs(a - b)))


def test_f32_port_matches_the_reference(scored):
    assert _gap(scored["float32"], scored["reference"]) <= F32_TOL
    assert _gap(scored["bfloat16"], scored["reference"]) > 100 * F32_TOL
    assert 0.01 < float(np.std(scored["reference"]))  # not a saturated head


def test_bf16_port_matches_the_reference_and_the_fp8_control_does_not(scored):
    assert _gap(scored["bfloat16"], scored["reference"]) <= BF16_TOL
    assert _gap(scored["fp8"], scored["reference"]) > BF16_TOL


@pytest.mark.parametrize("vocab,spec_ids", [(U24_MAX, "u24"), (U24_MAX + 1, None),
                                            (23_500_000, None)])
def test_a_table_past_2_24_rows_sends_int32_ids(vocab, spec_ids):
    """transfer_spec and the combined layout from model.shapes() alone: no
    table is allocated (its tree is on the meta device)."""
    model = build_model("dlrm", ModelConfig(**MLPERF, vocab_size=vocab))
    table = model.shapes()["embedding"]
    assert table.device.type == "meta" and tuple(table.shape) == (vocab, 128)
    spec = transfer_spec(model)
    assert spec.get("feat_ids") == spec_ids and spec["feat_wts"] == "bf16"
    arrays = {"feat_ids": np.zeros((4, 26), np.int32), "feat_wts": np.zeros((4, 26), np.float32),
              "dense_features": np.zeros((4, 13), np.float32)}
    layout = dict((e[0], e[1:]) for e in combined_layout(arrays, spec))
    if spec_ids is None:
        assert layout["feat_ids"] == ("raw", (26,), 26 * 4, "int32")
    else:
        assert layout["feat_ids"] == ("u24", (26,), 26 * 3, "u24")
    assert layout["feat_wts"] == ("raw", (26,), 26 * 2, "bfloat16")
    assert layout["dense_features"] == ("raw", (13,), 13 * 4, "float32")


@pytest.mark.parametrize("rows", [1, 3, 256])
def test_ids_past_2_24_survive_the_three_input_pack(rows):
    vocab = 23_500_000
    model = build_model("dlrm", ModelConfig(**MLPERF, vocab_size=vocab))
    spec = transfer_spec(model)
    raw = _inputs(vocab, n=rows, seed=rows)
    raw["feat_ids"][0, :3] = [vocab - 1, U24_MAX, U24_MAX + 12345]
    arrays = dict(raw, feat_ids=fold_ids_host(raw["feat_ids"], vocab))
    assert arrays["feat_ids"].dtype == np.int32 and int(arrays["feat_ids"].max()) >= U24_MAX
    layout = combined_layout(arrays, spec)
    buf = pack_host_combined(arrays, spec)
    assert buf.size == rows * (26 * 4 + 26 * 2 + 13 * 4)
    out = unpack_device_combined(torch.from_numpy(buf), layout)
    assert out["feat_ids"].dtype == torch.int32
    np.testing.assert_array_equal(out["feat_ids"].numpy(), arrays["feat_ids"])
    np.testing.assert_array_equal(out["feat_ids"][0, :3].numpy(),
                                  [vocab - 1, U24_MAX, U24_MAX + 12345])
    np.testing.assert_array_equal(out["dense_features"].numpy(), arrays["dense_features"])
    wts = out["feat_wts"].float().numpy()
    np.testing.assert_array_equal(wts, arrays["feat_wts"])  # 1.0 is exact in bf16


def test_a_served_three_input_batch_records_the_hostpack_span():
    """A DLRM batch (feat_ids, feat_wts, dense_features) packs through
    pack_host_combined under `batch.hostpack`: in the aggregate phases, and
    replayed onto the request's span with the batch's id, bucket and rows."""
    cfg = ModelConfig(**{**MLPERF, "embed_dim": 8, "bottom_mlp_dims": (16, 8),
                         "mlp_dims": (16, 8)}, vocab_size=U24_MAX + 7)
    model = build_model("dlrm", cfg)
    sv = Servable(name="DLRM", version=1, model=model, params=model.init(0, "cpu"),
                  signatures=ctr_signatures(26, with_dense=13))
    batcher = DynamicBatcher(buckets=(16, 64), max_wait_us=0, device=torch.device("cpu"))
    batcher.start()
    arrays = _inputs(cfg.vocab_size, n=40, seed=1)
    before = request_trace.snapshot().get("batch.hostpack", {"count": 0})["count"]
    rec = tracing.enable(buffer_size=64, slowest_n=0)
    try:
        with tracing.start_root("server.Predict", attrs={"n": 40}) as span:
            got = batcher.submit(sv, arrays, span=span).result(60)["prediction_node"]
        roots = rec.export_since(0, limit=64)["spans"]
    finally:
        tracing.disable()
        batcher.stop()
    assert got.shape == (40,) and np.all(np.isfinite(got))
    assert request_trace.snapshot()["batch.hostpack"]["count"] > before
    (root,) = roots
    (pack,) = [c for c in root["children"] if c["name"] == "batch.hostpack"]
    (dispatch,) = [c for c in root["children"] if c["name"] == "batch.dispatch"]
    assert pack["attrs"] == dispatch["attrs"] == {"batch": pack["attrs"]["batch"],
                                                  "bucket": 64, "rows": 40}
    assert pack["thread"] == "batch-dispatch" and not any(
        c["name"] == "batch.fusedpack" for c in root["children"])
    assert math.isfinite(pack["duration_us"])


@pytest.mark.parametrize("change,why", [
    ({}, None),
    ({"compute_dtype": "float32"}, "float32 compute"),
    ({"param_dtype": "bfloat16"}, None),
    ({"num_fields": 63}, None),
    ({"num_fields": 64}, "64 fields (at most 63)"),
    ({"embed_dim": 6, "bottom_mlp_dims": (16, 6)}, "embed_dim 6"),
])
def test_the_interaction_route_is_decided_from_the_model_alone(change, why):
    """ops/dlrm_kernel.py `unsupported` from a model's shapes (no table
    allocated): the kernel takes bf16 compute over an f32 or bf16 table,
    any table row count under 2^31 and up to 63 fields; `serving_route`,
    which the batcher calls when a DLRM servable loads on the card, keeps
    float32 compute on the eager ops and raises at load for a bf16 model
    the kernel cannot take (with no compiler needed for either answer)."""
    from distributed_tf_serving_tpu_torch.ops import dlrm_kernel as dk

    cfg = ModelConfig(**{**MLPERF, **change}, vocab_size=23_500_000)
    table = build_model("dlrm", cfg).shapes()["embedding"]
    got = dk.unsupported(table, cfg.num_fields, cfg.cdtype)
    assert (got is None) if why is None else why in got
    if cfg.compute_dtype == "float32":
        assert dk.serving_route(table, cfg.num_fields, cfg.cdtype) == "eager"
    elif why is not None:
        with pytest.raises(ValueError, match=why.split(" (")[0]):
            dk.serving_route(table, cfg.num_fields, cfg.cdtype)
