"""The port's serving host path on the CPU, against the JAX package: the
combined single buffer (layout, pack, unpack), the native fused pack, the
[batching] config, and the pipelined batcher (dispatch thread, pinned-style
buffer ring, async readback, completion workers).

Tolerances are the reference's: f32 scores 1e-5, bf16 AUC 1e-3; buffers
byte for byte. Every wait has its own timeout, so a deadlock fails one test.
"""

import dataclasses
import os
import sys
import threading
import time

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from distributed_tf_serving_tpu import native as jax_native
from distributed_tf_serving_tpu.models import ModelConfig as JaxConfig
from distributed_tf_serving_tpu.models import Servable as JaxServable
from distributed_tf_serving_tpu.models import build_model as jax_build
from distributed_tf_serving_tpu.models import ctr_signatures as jax_signatures
from distributed_tf_serving_tpu.ops import transfer as jt
from distributed_tf_serving_tpu.serving import DynamicBatcher as JaxBatcher
from distributed_tf_serving_tpu.serving.batcher import fold_ids_host as jax_fold
from distributed_tf_serving_tpu.train.data import auc
from distributed_tf_serving_tpu.utils.config import load_config as jax_load_config
from distributed_tf_serving_tpu_torch import codec, native
from distributed_tf_serving_tpu_torch.convert import params_from_jax
from distributed_tf_serving_tpu_torch.models import (
    ModelConfig,
    Servable,
    build_model,
    ctr_signatures,
)
from distributed_tf_serving_tpu_torch.ops import transfer as tt
from distributed_tf_serving_tpu_torch.proto import serving_apis_pb2 as apis
from distributed_tf_serving_tpu_torch.serving.batcher import (
    DynamicBatcher,
    QueueOverloadError,
    RequestDeadlineError,
    bucket_for,
    fold_ids_host,
)
from distributed_tf_serving_tpu_torch.serving.server import build_stack
from distributed_tf_serving_tpu_torch.utils import tracing
from distributed_tf_serving_tpu_torch.utils.config import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F = 11  # odd, so odd row counts give an odd rows * F (a misaligned weights segment)
KW = dict(num_fields=F, vocab_size=1 << 14, embed_dim=8, mlp_dims=(32, 16), num_cross_layers=2)
SPECS = {
    "bf16": {"feat_ids": "u24", "feat_wts": "bf16"},
    "f32": {"feat_ids": "u24"},
}
WAIT = 60  # seconds: every future and join in this file


@pytest.fixture(scope="module", autouse=True)
def _native_built():
    # Both libraries built up front: the JAX package's pack_host then takes
    # its native path, and the port's fused pack is eligible.
    assert native.ensure() and jax_native.ensure()


def _weights(n: int, seed: int) -> np.ndarray:
    """Weights with the edge values of the float32 -> bf16 cast."""
    rng = np.random.RandomState(seed)
    w = rng.randn(n, F).astype(np.float32)
    special = np.array([np.inf, -np.inf, np.nan, -np.nan, -0.0, 0.0, 1e-40, -1e-45,
                        3.4e38, -3.4e38, 3.3895314e38], np.float32)
    flat = w.reshape(-1)
    flat[:min(special.size, flat.size)] = special[:flat.size]
    return w


def _ids(n: int, kind: str, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    if kind == "int32":
        return rng.randint(0, 1 << 24, size=(n, F)).astype(np.int32)
    ids = rng.randint(0, 1 << 40, size=(n, F)).astype(np.int64)
    if kind == "int64_negative":
        ids[::2] = -ids[::2]
    return ids


# ------------------------------------------------------- combined buffer


@pytest.mark.parametrize("vocab", [1 << 14, 1000003])
@pytest.mark.parametrize("id_kind", ["int32", "int64", "int64_negative"])
@pytest.mark.parametrize("spec_name", sorted(SPECS))
def test_combined_buffer_is_byte_identical_to_jax(spec_name, id_kind, vocab):
    spec = SPECS[spec_name]
    raw = {"feat_ids": _ids(37, id_kind, 1), "feat_wts": _weights(37, 2)}
    ours = dict(raw, feat_ids=fold_ids_host(raw["feat_ids"], vocab)
                if raw["feat_ids"].dtype == np.int64 else raw["feat_ids"])
    theirs = dict(raw, feat_ids=jax_fold(raw["feat_ids"], vocab)
                  if raw["feat_ids"].dtype == np.int64 else raw["feat_ids"])
    np.testing.assert_array_equal(ours["feat_ids"], theirs["feat_ids"])
    assert tt.combined_supported(ours) and jt.combined_supported(theirs)
    assert tt.combined_layout(ours, spec) == jt.combined_layout(theirs, spec)
    got = tt.pack_host_combined(ours, spec)
    want = jt.pack_host_combined(theirs, spec)
    assert got.dtype == np.uint8 and got.tobytes() == want.tobytes()
    # Written into a caller's buffer (the batcher's pinned one): the same bytes.
    out = np.full(got.size, 0xAB, np.uint8)
    assert tt.pack_host_combined(ours, spec, out=out) is out
    assert out.tobytes() == want.tobytes()
    with pytest.raises(ValueError, match="out must be"):
        tt.pack_host_combined(ours, spec, out=np.empty(got.size + 1, np.uint8))


def test_combined_supported_matches_jax_on_dtypes():
    for dt in (np.int8, np.uint8, np.int16, np.uint16, np.float16, np.int32, np.float32,
               np.int64, np.float64, np.bool_):
        a = {"x": np.zeros((2, 3), dt)}
        assert tt.combined_supported(a) == jt.combined_supported(a), dt
    # bf16 bit patterns: uint16 here, ml_dtypes.bfloat16 in the JAX package.
    assert tt.combined_supported({"w": np.zeros(4, np.uint16)})
    assert jt.combined_supported({"w": np.zeros(4, ml_dtypes.bfloat16)})


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({torch.bfloat16: torch.int16, torch.float32: torch.int32}.get(t.dtype, t.dtype))


@pytest.mark.parametrize("rows", [16, 7, 5])  # 7 * 11 and 5 * 11: misaligned weights
@pytest.mark.parametrize("spec_name", sorted(SPECS))
def test_unpack_combined_equals_per_key_unpack(spec_name, rows):
    spec = SPECS[spec_name]
    arrays = {"feat_ids": _ids(rows, "int32", 3), "feat_wts": _weights(rows, 4)}
    layout = tt.combined_layout(arrays, spec)
    buf = torch.from_numpy(tt.pack_host_combined(arrays, spec))
    if rows * F * 3 % 2:
        wts_off = rows * F * 3
        assert buf[wts_off:].storage_offset() % 2  # the case a plain view refuses
    got = tt.unpack_device_combined(buf, layout)
    want = tt.unpack_device(tt.to_device(tt.pack_host(arrays, spec), "cpu"), spec)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert torch.equal(_bits(got[k]), _bits(want[k]))  # NaN weights: compare bits
    # And the JAX package's unpack of the same bytes.
    jgot = jt.unpack_device_combined(jax.numpy.asarray(buf.numpy()), layout)
    np.testing.assert_array_equal(np.asarray(jgot["feat_ids"]), got["feat_ids"].numpy())
    jw = np.asarray(jgot["feat_wts"])
    if spec_name == "bf16":
        jw = jw.view(np.uint16)
        np.testing.assert_array_equal(jw, got["feat_wts"].view(torch.int16).numpy()
                                      .view(np.uint16))
    else:
        np.testing.assert_array_equal(jw.view(np.uint32), got["feat_wts"].numpy()
                                      .view(np.uint32))


def test_unpack_combined_raw_uint16_and_one_byte_segments():
    arrays = {"a": np.arange(15, dtype=np.uint8).reshape(5, 3),
              "b": np.arange(10, dtype=np.uint16).reshape(5, 2) * 4099,
              "c": np.arange(5, dtype=np.int32) - 2}
    layout = tt.combined_layout(arrays, {})
    assert layout == jt.combined_layout(arrays, {})
    got = tt.unpack_device_combined(torch.from_numpy(tt.pack_host_combined(arrays, {})), layout)
    for k, v in arrays.items():
        np.testing.assert_array_equal(got[k].numpy(), v)


# ------------------------------------------------------------ native pack


def _jax_parts(parts):
    """The same parts as the JAX package takes them: bf16 bits as
    ml_dtypes.bfloat16."""
    return [{"feat_ids": p["feat_ids"],
             "feat_wts": p["feat_wts"].view(ml_dtypes.bfloat16)
             if p["feat_wts"].dtype == np.uint16 else p["feat_wts"]} for p in parts]


def _padded_reference(parts, bucket, vocab):
    """JAX pack_host_combined over the padded, folded batch."""
    ids = np.zeros((bucket, F), np.int32)
    wts = np.zeros((bucket, F), ml_dtypes.bfloat16)
    off = 0
    for p in _jax_parts(parts):
        n = p["feat_ids"].shape[0]
        i = p["feat_ids"]
        ids[off:off + n] = jax_fold(i, vocab) if i.dtype == np.int64 else i
        wts[off:off + n] = p["feat_wts"].astype(ml_dtypes.bfloat16)
        off += n
    return jt.pack_host_combined({"feat_ids": ids, "feat_wts": wts}, SPECS["bf16"])


def _part(n, id_kind, wts_kind, seed):
    w = _weights(n, seed)
    if wts_kind == "bf16_bits":
        w = w.astype(ml_dtypes.bfloat16).view(np.uint16)
    return {"feat_ids": _ids(n, id_kind, seed + 100), "feat_wts": w}


MIXES = {
    "wide": [("int64", "f32"), ("int64_negative", "f32")],
    "compact": [("int32", "bf16_bits")],
    "mixed": [("int64", "f32"), ("int32", "bf16_bits"), ("int64_negative", "bf16_bits"),
              ("int32", "f32")],
}


@pytest.mark.parametrize("vocab", [1 << 14, 1009])
@pytest.mark.parametrize("mix", sorted(MIXES))
def test_native_pack_is_byte_identical_to_jax(mix, vocab):
    parts = [_part(3 + i, ik, wk, seed=10 * i + len(mix)) for i, (ik, wk) in enumerate(MIXES[mix])]
    bucket = 32
    got = native.pack_batch_u24_bf16([p["feat_ids"] for p in parts],
                                     [p["feat_wts"] for p in parts], F, bucket, vocab)
    jp = _jax_parts(parts)
    theirs = jax_native.pack_batch_u24_bf16([p["feat_ids"] for p in jp],
                                            [p["feat_wts"] for p in jp], F, bucket, vocab)
    assert got.tobytes() == theirs.tobytes()
    assert got.tobytes() == _padded_reference(parts, bucket, vocab).tobytes()
    # A stale caller buffer: every byte is rewritten, the padding comes back zero.
    stale = np.full(bucket * F * 5, 0xEE, np.uint8)
    assert native.pack_batch_u24_bf16([p["feat_ids"] for p in parts],
                                      [p["feat_wts"] for p in parts], F, bucket, vocab,
                                      out=stale) is stale
    assert stale.tobytes() == theirs.tobytes()


def test_native_pack_guards_raise_before_writing():
    ids, wts = _ids(4, "int64", 0), _weights(4, 0)
    out = np.zeros(8 * F * 5, np.uint8)
    cases = [
        (([ids], [wts.astype(np.float64)], F, 8), "not float32/uint16"),
        (([ids.astype(np.int16)], [wts], F, 8), "not int64/int32"),
        (([ids], [wts[:, :-1]], F, 8), "do not match"),
        (([ids], [wts], F, 3), "exceed bucket"),
        (([ids], [], F, 8), "part-count mismatch"),
    ]
    for args, msg in cases:
        with pytest.raises(ValueError, match=msg):
            native.pack_batch_u24_bf16(*args, 1 << 14, out=out)
    assert not out.any()
    for bad in (np.zeros(8 * F * 5 - 1, np.uint8), np.zeros(8 * F * 5, np.int8),
                np.zeros((8 * F * 5, 2), np.uint8)[:, 0]):
        with pytest.raises(ValueError, match="out must be"):
            native.pack_batch_u24_bf16([ids], [wts], F, 8, 1 << 14, out=bad)


def test_native_fold_matches_jax_fold():
    ids = _ids(64, "int64_negative", 5)
    for vocab in (1 << 14, 1 << 20, 1000003):
        np.testing.assert_array_equal(native.fold_ids(ids, vocab), jax_fold(ids, vocab))
        np.testing.assert_array_equal(native.fold_i32(ids, vocab), jax_fold(ids, vocab))


def test_f32_to_bf16_bits_matches_the_native_cast_and_ml_dtypes():
    rng = np.random.RandomState(6)
    x = (rng.randn(4096) * np.exp(rng.randn(4096) * 20)).astype(np.float32)
    x = np.concatenate([x, _weights(2, 7).reshape(-1)])
    ours = tt.f32_to_bf16_bits(x)
    np.testing.assert_array_equal(ours, x.astype(ml_dtypes.bfloat16).view(np.uint16))
    np.testing.assert_array_equal(ours, jax_native.f32_to_bf16(x).view(np.uint16))


# ----------------------------------------------------------------- config


def _toml(tmp_path, text):
    p = tmp_path / "c.toml"
    p.write_text(text)
    return p


@pytest.mark.parametrize("text", [
    "",
    "[server]\ncompletion_workers = 3\n",
    "[server]\npipeline_depth = 3\n",
    "[server]\npipeline_depth = 3\n[batching]\npipeline_depth = 0\n",
    "[server]\npipeline_depth = 3\n[batching]\npipeline_depth = 5\n",
    "[batching]\npipeline_depth = 1\ninflight_window = 2\n",
    "[server]\nasync_readback = false\ncompletion_workers = 12\n",
    "[server]\ncompletion_workers = 2\npipeline_depth = 4\n[batching]\npipeline_depth = 2\n",
])
def test_config_pipeline_knobs_match_jax(tmp_path, text):
    path = _toml(tmp_path, text)
    theirs = jax_load_config(path)
    loaded = load_config(path)
    assert loaded["batching"].inflight_window == theirs["batching"].inflight_window
    ours = loaded["server"]
    js = theirs["server"]
    assert ours.completion_workers == js.completion_workers
    # The JAX server's rule: a nonzero [batching] pipeline_depth wins.
    assert ours.pipeline_depth == (theirs["batching"].pipeline_depth or js.pipeline_depth)


def test_config_pipeline_knobs_of_the_repo_configs():
    for name in ("latency.toml", "throughput.toml"):
        path = os.path.join(REPO, "configs", name)
        ours, theirs = load_config(path)["server"], jax_load_config(path)
        assert (ours.completion_workers, ours.pipeline_depth) == (
            theirs["server"].completion_workers,
            theirs["batching"].pipeline_depth or theirs["server"].pipeline_depth)
    assert load_config(os.path.join(REPO, "configs", "latency.toml"))["server"].completion_workers \
        == 8


@pytest.mark.parametrize("text", [
    "[server]\ncompletion_workers = 0\n",
    "[server]\npipeline_depth = 0\n",
    "[batching]\npipeline_depth = -1\n",
])
def test_config_refuses_bad_pipeline_knobs(tmp_path, text):
    with pytest.raises(ValueError, match="pipeline_depth|completion_workers"):
        load_config(_toml(tmp_path, text))


def test_built_stack_honours_latency_toml():
    loaded = load_config(os.path.join(REPO, "configs", "latency.toml"))
    cfg = dataclasses.replace(loaded["server"], buckets=(16, 32))
    mc = dataclasses.replace(loaded["model"], **KW)
    impl, batcher, servable = build_stack(cfg, mc, "cpu")
    try:
        assert batcher.completion_workers == 8 and batcher.pipeline_depth == 2
        assert batcher.step_for(servable).native_pack  # bf16 layout, library built
        assert batcher.stats.native_packs == 2  # warmup: one per bucket
        rng = np.random.RandomState(0)
        out = batcher.submit(servable, {
            "feat_ids": rng.randint(0, 1 << 40, size=(9, F)).astype(np.int64),
            "feat_wts": rng.rand(9, F).astype(np.float32)}).result(WAIT)
        assert out["prediction_node"].shape == (9,)
    finally:
        batcher.stop()
    assert not batcher._thread.is_alive() and not batcher._dispatch_thread.is_alive()


# --------------------------------------------------------------- pipeline


def _pair(compute_dtype, seed=0):
    kw = {**KW, "compute_dtype": compute_dtype}
    jm = jax_build("dcn_v2", JaxConfig(**kw))
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    sv = Servable(name="DCN", version=1, model=build_model("dcn_v2", ModelConfig(**kw)),
                  params=params_from_jax(jp, "cpu"), signatures=ctr_signatures(F))
    jsv = JaxServable(name="DCN", version=1, model=jm, params=jp, signatures=jax_signatures(F))
    return sv, jsv


def _payloads(count=24, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(count):
        n = int(rng.randint(1, 30))
        out.append({"feat_ids": rng.randint(0, 1 << 40, size=(n, F)).astype(np.int64),
                    "feat_wts": rng.rand(n, F).astype(np.float32)})
    return out


BUCKETS = (16, 64)


@pytest.fixture(scope="module")
def reference():
    """Per compute dtype: the servable, the payloads, and the JAX
    DynamicBatcher's scores of them (same converted params)."""
    out = {}
    for cd in ("float32", "bfloat16"):
        sv, jsv = _pair(cd)
        payloads = _payloads(seed=1 if cd == "float32" else 2)
        jb = JaxBatcher(buckets=BUCKETS, max_wait_us=0).start()
        try:
            want = [np.asarray(jb.submit(jsv, p).result(timeout=WAIT)["prediction_node"])
                    for p in payloads]
        finally:
            jb.stop()
        out[cd] = (sv, payloads, want)
    return out


def _serve_concurrently(batcher, sv, payloads, threads=4):
    """Submit from several threads at once; each request's own result."""
    results = [None] * len(payloads)
    errors = []
    barrier = threading.Barrier(threads)

    def client(k):
        try:
            barrier.wait(timeout=WAIT)
            futs = [(i, batcher.submit(sv, payloads[i]))
                    for i in range(k, len(payloads), threads)]
            for i, f in futs:
                results[i] = f.result(timeout=WAIT)
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    ts = [threading.Thread(target=client, args=(k,)) for k in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=2 * WAIT)
    assert not errors and not any(t.is_alive() for t in ts), errors
    return results


@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_pipelined_scores_match_sync_execute_and_jax(reference, cd, depth, workers):
    sv, payloads, want = reference[cd]
    batcher = DynamicBatcher(buckets=BUCKETS, max_wait_us=2000, device="cpu",
                             pipeline_depth=depth, completion_workers=workers)
    batcher.ring.per_size = 2
    batcher.start()
    try:
        got = _serve_concurrently(batcher, sv, payloads)
    finally:
        batcher.stop()
    assert batcher.completion_workers == workers and batcher.pipeline_depth == depth
    assert batcher.stats.requests == len(payloads)
    # One combined copy per batch, unless the device input cache held the
    # batch's bytes already (then neither pack nor copy).
    hits = batcher.input_cache.hits
    assert batcher.stats.native_packs == (batcher.stats.batches - hits if cd == "bfloat16" else 0)
    assert batcher.stats.h2d_copies + hits == batcher.stats.batches
    assert batcher.stats.readback_window_s > 0
    for p, g in zip(payloads, got):
        assert g["prediction_node"].shape == (p["feat_ids"].shape[0],)
    # The synchronous path on each request alone, padded to its bucket.
    sync = []
    for p in payloads:
        n = p["feat_ids"].shape[0]
        b = bucket_for(n, BUCKETS)
        padded = {k: np.concatenate([v, np.zeros((b - n,) + v.shape[1:], v.dtype)])
                  for k, v in p.items()}
        sync.append(batcher._execute(sv, padded, None)["prediction_node"][:n])
    g = np.concatenate([r["prediction_node"] for r in got])
    s = np.concatenate(sync)
    w = np.concatenate(want)
    # Served and synchronous scores differ only in how the CPU matmuls block
    # rows of differently composed batches (an ulp or so).
    np.testing.assert_allclose(g, s, rtol=0, atol=1e-6)
    if cd == "float32":
        assert np.max(np.abs(g - w)) < 1e-5
    else:
        labels = (np.random.RandomState(0).rand(len(w)) < w).astype(np.float32)
        assert abs(auc(labels, g) - auc(labels, w)) < 1e-3
        assert abs(auc(labels, s) - auc(labels, w)) < 1e-3


def test_results_do_not_alias_reused_ring_buffers(reference):
    """Results handed to the futures are owned copies: a later batch that
    reuses the same ring buffer does not change them."""
    sv, payloads, _ = reference["float32"]
    batcher = DynamicBatcher(buckets=BUCKETS, max_wait_us=0, device="cpu")
    batcher.ring.per_size = 1
    batcher.start()
    try:
        first = batcher.submit(sv, payloads[0]).result(WAIT)["prediction_node"]
        kept = first.copy()
        for p in payloads[1:8]:
            batcher.submit(sv, p).result(WAIT)
    finally:
        batcher.stop()
    np.testing.assert_array_equal(first, kept)
    snap = batcher.ring.snapshot()
    assert snap["reuses"] > 0 and snap["free_buffers"] <= 2 * 1 + 2


def test_combined_and_per_key_paths_agree_and_count_copies(reference):
    for cd in ("float32", "bfloat16"):
        sv, payloads, _ = reference[cd]
        batcher = DynamicBatcher(buckets=BUCKETS, max_wait_us=0, device="cpu")
        p = payloads[3]
        n = p["feat_ids"].shape[0]
        b = bucket_for(n, BUCKETS)
        padded = {k: np.concatenate([v, np.zeros((b - n,) + v.shape[1:], v.dtype)])
                  for k, v in p.items()}
        a = batcher._execute(sv, padded, None)
        assert batcher.stats.h2d_copies == 1  # the combined buffer
        b = batcher._execute(sv, padded, None, _per_key=True)
        assert batcher.stats.h2d_copies == 3  # then one copy per input
        assert batcher.stats.native_packs == (1 if cd == "bfloat16" else 0)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_failing_step_fails_only_its_own_group(reference):
    sv, payloads, want = reference["float32"]
    bad, _ = _pair("float32", seed=1)

    def broken(params, batch):
        raise RuntimeError("device step failed")

    bad.model = dataclasses.replace(bad.model, apply=broken)
    batcher = DynamicBatcher(buckets=BUCKETS, max_wait_us=0, device="cpu",
                             completion_workers=2).start()
    try:
        futs = []
        for i, p in enumerate(payloads[:10]):
            futs.append((i, batcher.submit(sv, p)))
            futs.append((None, batcher.submit(bad, p)))
        for i, f in futs:
            if i is None:
                with pytest.raises(RuntimeError, match="device step failed"):
                    f.result(WAIT)
            else:
                np.testing.assert_allclose(f.result(WAIT)["prediction_node"], want[i],
                                           rtol=1e-5, atol=1e-5)
        # The batcher keeps serving after the failures.
        batcher.submit(sv, payloads[0]).result(WAIT)
    finally:
        batcher.stop()


def test_failing_readback_fails_only_its_own_group(reference, monkeypatch):
    sv, payloads, want = reference["float32"]
    batcher = DynamicBatcher(buckets=BUCKETS, max_wait_us=0, device="cpu")
    real = batcher._wait
    calls = []

    def wait(rb):
        calls.append(rb)
        if len(calls) == 2:
            raise RuntimeError("readback failed")
        return real(rb)

    monkeypatch.setattr(batcher, "_wait", wait)
    batcher.start()
    try:
        outcomes = []
        for p in payloads[:4]:
            f = batcher.submit(sv, p)
            try:
                outcomes.append(f.result(WAIT)["prediction_node"])
            except RuntimeError as e:
                outcomes.append(str(e))
    finally:
        batcher.stop()
    assert outcomes[1] == "readback failed"
    for i in (0, 2, 3):
        np.testing.assert_allclose(outcomes[i], want[i], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("depth", [1, 3])
def test_stop_serves_every_accepted_item(reference, depth):
    sv, payloads, want = reference["float32"]
    batcher = DynamicBatcher(buckets=BUCKETS, max_wait_us=0, device="cpu",
                             pipeline_depth=depth, completion_workers=2)
    futs = [batcher.submit(sv, p) for p in payloads]  # all queued before start
    batcher.start()
    batcher.stop()
    assert all(f.done() for f in futs)
    for f, w in zip(futs, want):
        np.testing.assert_allclose(f.result(0)["prediction_node"], w, rtol=1e-5, atol=1e-5)
    with pytest.raises(RuntimeError, match="stopped"):
        batcher.submit(sv, payloads[0])


def test_sheds_and_refusals_behind_a_busy_pipeline(reference):
    """While the dispatch thread is held in a slow step, the queue fills:
    admission refuses past capacity and an item whose deadline passes while
    queued is shed; everything accepted and live is still served."""
    sv, payloads, want = reference["float32"]
    slow, _ = _pair("float32")
    gate = threading.Event()
    real_apply = slow.model.apply

    def held(params, batch):
        gate.wait(WAIT)
        return real_apply(params, batch)

    slow.model = dataclasses.replace(slow.model, apply=held)
    batcher = DynamicBatcher(buckets=(16,), max_wait_us=0, device="cpu",
                             queue_capacity_candidates=16, pipeline_depth=1).start()
    try:
        p = payloads[0]
        n = p["feat_ids"].shape[0]
        blocker = batcher.submit(slow, p)
        deadline = time.perf_counter() + WAIT
        while batcher._dispatch_pending == 0 and time.perf_counter() < deadline:
            time.sleep(0.001)
        expiring = batcher.submit(sv, p, deadline_s=0.0)
        with pytest.raises(QueueOverloadError):
            batcher.submit(sv, {k: np.repeat(v[:1], 17 - n, axis=0) for k, v in p.items()})
        gate.set()
        np.testing.assert_allclose(blocker.result(WAIT)["prediction_node"], want[0],
                                   rtol=1e-5, atol=1e-5)
        with pytest.raises(RequestDeadlineError):
            expiring.result(WAIT)
        assert batcher.stats.deadline_sheds == 1
    finally:
        gate.set()
        batcher.stop()


def test_timeline_records_each_request_in_order(reference):
    sv, payloads, _ = reference["float32"]
    batcher = DynamicBatcher(buckets=BUCKETS, max_wait_us=0, device="cpu").start()
    batcher.timeline = []
    try:
        for p in payloads[:5]:
            batcher.submit(sv, p).result(WAIT)
    finally:
        batcher.stop()
    assert len(batcher.timeline) == 5
    for t in batcher.timeline:
        assert list(t) == sorted(t)  # enqueue <= collected <= stage <= issue <= ready <= done


def test_stress_more_workers_than_cores_loses_no_update(reference):
    """16 completion workers and 12 submitting threads, with a short switch
    interval: every request gets its own rows, and the counters the
    dispatch thread and the workers share add up."""
    sv, payloads, want = reference["float32"]
    many = payloads * 4
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        batcher = DynamicBatcher(buckets=BUCKETS, max_wait_us=100, device="cpu",
                                 completion_workers=16, pipeline_depth=3,
                                 queue_capacity_candidates=1 << 20)
        batcher.ring.per_size = 1
        batcher.start()
        try:
            got = _serve_concurrently(batcher, sv, many, threads=12)
        finally:
            batcher.stop()
    finally:
        sys.setswitchinterval(old)
    s = batcher.stats
    assert s.requests == len(many)
    assert s.candidates == sum(p["feat_ids"].shape[0] for p in many)
    assert s.h2d_copies + batcher.input_cache.hits == s.batches
    for i, g in enumerate(got):
        np.testing.assert_allclose(g["prediction_node"], want[i % len(payloads)],
                                   rtol=1e-5, atol=1e-5)


def test_a_broken_completion_pool_fails_the_group_instead_of_hanging(reference):
    """A completion worker whose thread failed to start never runs the
    group's completion: its waiters get the pool's error, and stop() does
    not wait for a readback nobody will finish."""
    from concurrent.futures import BrokenExecutor, ThreadPoolExecutor

    sv, payloads, _ = reference["float32"]

    def broken_init():
        raise RuntimeError("worker start failed")

    batcher = DynamicBatcher(buckets=BUCKETS, max_wait_us=0, device="cpu")
    batcher._completers = ThreadPoolExecutor(2, initializer=broken_init)
    batcher.start()
    try:
        with pytest.raises(BrokenExecutor):
            batcher.submit(sv, payloads[0]).result(WAIT)
    finally:
        batcher.stop()
    assert batcher._inflight == 0


@pytest.mark.parametrize("depth", [1, 2])
def test_held_readbacks_do_not_hold_dispatch(reference, depth, monkeypatch):
    """With the readbacks of `depth` batches held by completion workers,
    new requests are still collected at max_wait and run through the
    device stage: dispatch waits only for staged groups, never for a
    readback."""
    sv, payloads, want = reference["float32"]
    gate = threading.Event()
    batcher = DynamicBatcher(buckets=BUCKETS, max_wait_us=0, device="cpu",
                             pipeline_depth=depth, completion_workers=depth + 2)
    real_wait = batcher._wait

    def held_wait(rb):
        gate.wait(WAIT)
        return real_wait(rb)

    def batches_reach(k):
        deadline = time.perf_counter() + WAIT
        while batcher.stats.batches < k and time.perf_counter() < deadline:
            time.sleep(0.001)
        return batcher.stats.batches >= k

    monkeypatch.setattr(batcher, "_wait", held_wait)
    batcher.start()
    try:
        futs = []
        for k, p in enumerate(payloads[:depth + 2]):
            futs.append(batcher.submit(sv, p))
            assert batches_reach(k + 1)  # dispatched while the earlier readbacks are held
        assert not any(f.done() for f in futs)
        gate.set()
        for f, w in zip(futs, want):
            np.testing.assert_allclose(f.result(WAIT)["prediction_node"], w, rtol=1e-5, atol=1e-5)
    finally:
        gate.set()
        batcher.stop()
    assert batcher.stats.batches == depth + 2  # one batch per request


# --------------------------------------------------------------- spans


@pytest.fixture
def traced_stack():
    """build_stack on latency.toml (two buckets) with the span plane on:
    (impl, batcher, servable, recorder); the plane off again after."""
    loaded = load_config(os.path.join(REPO, "configs", "latency.toml"))
    cfg = dataclasses.replace(loaded["server"], buckets=(16, 32))
    mc = dataclasses.replace(loaded["model"], **KW)
    impl, batcher, servable = build_stack(cfg, mc, "cpu")
    rec = tracing.enable(buffer_size=1024, slowest_n=0)
    try:
        yield impl, batcher, servable, rec
    finally:
        tracing.disable()
        batcher.stop()


def _traced_predicts(impl, servable, threads=4, each=4):
    """Predicts from several threads at once, each under its own
    server.Predict root span."""
    errors = []
    barrier = threading.Barrier(threads)

    def client(k):
        rng = np.random.RandomState(k)
        try:
            barrier.wait(timeout=WAIT)
            for _ in range(each):
                n = int(rng.randint(1, 14))
                req = apis.PredictRequest()
                req.model_spec.name = servable.name
                codec.from_ndarray(rng.randint(0, 1 << 40, size=(n, F)).astype(np.int64),
                                   out=req.inputs["feat_ids"])
                codec.from_ndarray(rng.rand(n, F).astype(np.float32),
                                   out=req.inputs["feat_wts"])
                with tracing.start_root("server.Predict", attrs={"n": n}):
                    impl.predict(req)
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    ts = [threading.Thread(target=client, args=(k,), name=f"caller_{k}") for k in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=2 * WAIT)
    assert not errors and not any(t.is_alive() for t in ts), errors


def _children(root: dict) -> dict:
    out: dict = {}
    for c in root["children"]:
        out.setdefault(c["name"], []).append(c)
    return out


def test_queue_wait_splits_into_collect_and_stage_waits(traced_stack):
    impl, batcher, servable, rec = traced_stack
    _traced_predicts(impl, servable)
    roots = rec.export_since(0, limit=1024)["spans"]
    assert len(roots) == 16
    for root in roots:
        kids = _children(root)
        (queue,), (collect,), (stage,) = (kids[k] for k in (
            "batch.queue_wait", "batch.collect_wait", "batch.stage_wait"))
        assert abs(collect["duration_us"] + stage["duration_us"] - queue["duration_us"]) <= 1
        assert collect["start_us"] == queue["start_us"]
        assert abs(stage["start_us"] - collect["start_us"] - collect["duration_us"]) <= 1
        for w in (queue, collect, stage):
            assert w["wait"] and "cpu_us" not in w and "tid" not in w


def test_replayed_phases_carry_one_batch_id_per_batch(traced_stack):
    impl, batcher, servable, rec = traced_stack
    before = batcher.stats.batches
    _traced_predicts(impl, servable)
    roots = rec.export_since(0, limit=1024)["spans"]
    batches: dict = {}
    for root in roots:
        kids = _children(root)
        (decode,) = kids["predict.decode"]
        assert decode["thread"].startswith("caller_") and "cpu_us" in decode
        replayed = [c for c in root["children"] if "batch" in c["attrs"]]
        ids = {c["attrs"]["batch"] for c in replayed}
        assert len(ids) == 1, ids  # one batch per request here
        (dispatch,) = kids["batch.dispatch"]
        (readback,) = kids["readback.wait"]
        assert dispatch["thread"] == "batch-dispatch" and "cpu_us" in dispatch
        assert readback["thread"].startswith("batch-complete") and "cpu_us" in readback
        attrs = dispatch["attrs"]
        b = batches.setdefault(attrs["batch"], {"attrs": attrs, "n": 0, "dispatch": set()})
        assert b["attrs"] == attrs  # the same id means the same bucket and rows
        b["n"] += root["attrs"]["n"]
        b["dispatch"].add((dispatch["start_us"], dispatch["duration_us"]))
    assert len(batches) == batcher.stats.batches - before
    for b in batches.values():
        assert b["attrs"]["rows"] == b["n"] <= b["attrs"]["bucket"]
        assert len(b["dispatch"]) == 1  # one dispatch, replayed onto each member
