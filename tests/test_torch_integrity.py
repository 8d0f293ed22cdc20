"""The port's integrity plane (serving/integrity.py, codec's CRC32C sidecars
and their wiring) against the JAX package's on the CPU: the sidecars (native
slicing-by-8 and the table loop) and poison_fault_key equal the JAX values
on seeded payloads; the IntegrityPlane reproduces the JAX plane's snapshots
over one scripted sequence of trips, audits and compares; over real gRPC the
JAX `ShardedPredictClient` with integrity_checksums verifies both ways, a
request damaged on the wire fails alone with corrupt-wire, and a damaged
response is caught before the merge; in the batcher the readback screen
fails only the NaN-keyed request, a keyed readback_bitflip fails its batch
through the shadow compare and marks the replica suspect until clean
shadows clear it, a natively packed batch's shadow (rebuilt padded arrays)
compares clean, and both planes on or off give the same bits; the
[integrity] section, build_stack's refusal beside the score cache, the
/integrityz routes and the dts_tpu_integrity_* series (the JAX
exposition's text)."""

import asyncio
import dataclasses

import jax
import numpy as np
import pytest

from distributed_tf_serving_tpu import codec as jax_codec
from distributed_tf_serving_tpu import faults as jax_faults
from distributed_tf_serving_tpu.models import ModelConfig as JaxConfig
from distributed_tf_serving_tpu.models import build_model as jax_build
from distributed_tf_serving_tpu.serving import batcher as jax_batcher
from distributed_tf_serving_tpu.serving import integrity as jax_integrity
from distributed_tf_serving_tpu.serving import overload as jax_overload
from distributed_tf_serving_tpu.utils import config as jax_config
from distributed_tf_serving_tpu.utils.metrics import ServerMetrics as JaxMetrics
from distributed_tf_serving_tpu_torch import codec, faults, native
from distributed_tf_serving_tpu_torch.convert import params_from_jax
from distributed_tf_serving_tpu_torch.models import (
    ModelConfig,
    Servable,
    ServableRegistry,
    build_model,
    ctr_signatures,
)
from distributed_tf_serving_tpu_torch.serving import overload as overload_mod
from distributed_tf_serving_tpu_torch.serving.batcher import (
    DynamicBatcher,
    poison_fault_key,
    prepare_inputs,
)
from distributed_tf_serving_tpu_torch.serving.integrity import (
    IntegrityPlane,
    IntegrityScreenError,
    OutputCorruptError,
)
from distributed_tf_serving_tpu_torch.serving.service import PredictionServiceImpl
from distributed_tf_serving_tpu_torch.utils.config import (
    CacheConfig,
    IntegrityConfig,
    OverloadConfig,
    ServerConfig,
    load_config,
)
from distributed_tf_serving_tpu_torch.utils.metrics import ServerMetrics

F = 8
KW = dict(num_fields=F, vocab_size=1009, embed_dim=4, mlp_dims=(16,), num_cross_layers=1,
          compute_dtype="float32")


def _servable(**over):
    kw = dict(KW, **over)
    jm = jax_build("dcn_v2", JaxConfig(name="DCN", **kw))
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    return Servable(name="DCN", version=1,
                    model=build_model("dcn_v2", ModelConfig(name="DCN", **kw)),
                    params=params_from_jax(jp, "cpu"), signatures=ctr_signatures(F))


@pytest.fixture(scope="module")
def servable():
    assert native.ensure()
    return _servable()


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset(0)
    jax_faults.reset(0)
    yield
    faults.reset(0)
    jax_faults.reset(0)
    for mod in (overload_mod, jax_overload):
        mod.deactivate()


def make_arrays(n, seed=0):
    rng = np.random.RandomState(seed)
    return {"feat_ids": rng.randint(0, 1 << 40, size=(n, F)).astype(np.int64),
            "feat_wts": rng.rand(n, F).astype(np.float32)}


def _plane(**kw) -> IntegrityPlane:
    return IntegrityConfig(enabled=True, **kw).build()


def _stack(servable, *, plane=None, **bkw):
    registry = ServableRegistry()
    registry.load(servable)
    defaults = dict(buckets=(32, 64), max_wait_us=0, device="cpu")
    defaults.update(bkw)
    batcher = DynamicBatcher(**defaults).start()
    impl = PredictionServiceImpl(registry, batcher)
    if plane is not None:
        batcher.integrity = plane
        impl.integrity = plane
    return batcher, impl


def _solo(servable, arrays):
    """The plane-off batcher's answer for `arrays` alone (the reference:
    same bucket, same positions)."""
    b, _ = _stack(servable)
    try:
        return b.submit(servable, arrays).result(timeout=60)["prediction_node"]
    finally:
        b.stop()


# ------------------------------------------------------- exact agreement


PAYLOADS = [
    {"feat_ids": np.random.RandomState(0).randint(0, 1 << 40, size=(2048, 43)).astype(np.int64),
     "feat_wts": np.random.RandomState(1).rand(2048, 43).astype(np.float32)},
    {"prediction_node": np.random.RandomState(2).rand(7).astype(np.float32),
     "q": np.arange(-5, 5, dtype=np.int8), "empty": np.zeros((0, 3), np.float32)},
    {"strided": np.arange(40, dtype=np.int32).reshape(8, 5)[:, ::2],
     "scalar": np.float64(3.25) * np.ones(()), "i16": np.arange(9, dtype=np.int16)},
]


@pytest.mark.parametrize("idx", range(len(PAYLOADS)))
def test_crc_sidecar_equals_the_jax_codec_native_and_table(idx, monkeypatch):
    arrays = PAYLOADS[idx]
    want = jax_codec.crc_sidecar(arrays)
    assert native.ensure() and codec.crc_sidecar(arrays) == want
    # The plain version: the table loop, as without the host ops (the
    # biggest payload alone is a second of it, so only the small ones).
    if idx:
        monkeypatch.setattr(native, "available", lambda: False)
        assert codec.crc_sidecar(arrays) == want
    assert codec.parse_crc_sidecar(want) == jax_codec.parse_crc_sidecar(want)
    assert codec.verify_crc_sidecar(arrays, want) == []
    name = sorted(arrays)[0]
    bad = dict(arrays)
    flipped = np.ascontiguousarray(arrays[name]).copy()
    if flipped.size:
        flipped.reshape(-1).view(np.uint8)[0] ^= 1
    else:
        flipped = flipped.reshape(-1, 1)  # a shape change is caught too
    bad[name] = flipped
    assert codec.verify_crc_sidecar(bad, want) == jax_codec.verify_crc_sidecar(bad, want) == [name]


def test_crc32c_primitives_agree():
    assert native.ensure()
    rng = np.random.RandomState(5)
    for n in (0, 1, 7, 8, 9, 1000):
        data = rng.randint(0, 256, n).astype(np.uint8)
        want = jax_codec.crc32c(data.tobytes())
        assert codec.crc32c_table(data.tobytes()) == want
        assert native.crc32c(data) == native.crc32c(data.tobytes()) == want
        assert codec.crc32c(data.tobytes(), 0x1234) == jax_codec.crc32c(data.tobytes(), 0x1234)
    with pytest.raises(codec.CodecError):
        codec.parse_crc_sidecar("feat_ids=zz")
    with pytest.raises(codec.CodecError):
        codec.parse_crc_sidecar("=00000000")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_poison_fault_key_equals_the_jax_digest(seed, servable):
    jm = jax_build("dcn_v2", JaxConfig(name="DCN", **KW))
    rng = np.random.RandomState(seed)
    payload = {"feat_ids": rng.randint(0, 1 << 40, size=(9, F)).astype(np.int64),
               "feat_wts": rng.rand(9, F).astype(np.float64 if seed == 2 else np.float32)}
    want = jax_batcher.poison_fault_key(jax_batcher.prepare_inputs(jm, payload, fold_ids=False))
    assert poison_fault_key(prepare_inputs(payload)) == want


# --------------------------------------------------- the JAX plane, step by step


@pytest.mark.parametrize("seed", [0, 1])
def test_scripted_sequence_gives_the_jax_plane_s_snapshots(seed):
    knobs = dict(enabled=True, screen_trips_per_window=3, screen_window_s=2.0,
                 shadow_fraction=0.3, suspect_clear_passes=2, history_events=16)
    clock = [0.0]
    ours = IntegrityPlane(IntegrityConfig(**knobs), clock=lambda: clock[0])
    theirs = jax_integrity.IntegrityPlane(jax_config.IntegrityConfig(**knobs),
                                          clock=lambda: clock[0])
    rng = np.random.RandomState(seed)
    ok = [np.arange(4, dtype=np.float32), np.ones(3, np.int32)]
    arrays = {"a": np.arange(6, dtype=np.int64)}
    stamp = codec.crc_sidecar(arrays)
    for step in range(300):
        r = rng.rand()
        if r < 0.15:
            clock[0] += float(rng.choice([0.1, 0.7, 3.0]))
        elif r < 0.3:
            assert ours.want_shadow() == theirs.want_shadow(), step
        elif r < 0.4:
            n = int(rng.randint(1, 4))
            assert ours.request_audit(n) == theirs.request_audit(n), step
        elif r < 0.55:
            reason = ours.screen_reason(np.array([np.nan, 1.0], np.float32))
            assert reason == theirs.screen_reason(np.array([np.nan, 1.0], np.float32))
            ours.note_screen_trip(reason)
            theirs.note_screen_trip(reason)
        elif r < 0.65:
            assert ours.maybe_escalate_screen(None) == theirs.maybe_escalate_screen(None), step
        elif r < 0.85:
            other = ok if rng.rand() < 0.7 else [ok[0], np.zeros(3, np.int32)]
            outcome = []
            for plane, exc in ((ours, OutputCorruptError), (theirs, jax_integrity.OutputCorruptError)):
                try:
                    plane.shadow_compare(ok, other)
                    outcome.append(None)
                except exc as e:
                    outcome.append(str(e))
            assert outcome[0] == outcome[1], step
        else:
            good = rng.rand() < 0.5
            sidecar = stamp if good else stamp[:-1] + ("0" if stamp[-1] != "0" else "1")
            assert ours.verify_inputs(arrays, sidecar) == theirs.verify_inputs(arrays, sidecar)
        assert ours.snapshot() == theirs.snapshot(), step
    snap = ours.snapshot()
    assert snap["shadow"]["batches"] and snap["screen"]["trips"] and snap["escalations"]


def test_screen_trip_window_escalates_once():
    t = [0.0]
    plane = IntegrityPlane(IntegrityConfig(enabled=True, screen_trips_per_window=2,
                                           screen_window_s=5.0), clock=lambda: t[0])
    plane.note_screen_trip("test")
    assert plane.maybe_escalate_screen(None) is False
    t[0] = 1.0
    plane.note_screen_trip("test")
    assert plane.maybe_escalate_screen(None) is True
    assert plane.suspect is True and plane.escalations == 1
    assert plane.maybe_escalate_screen(None) is False
    t[0] = 100.0
    plane.note_screen_trip("test")
    assert plane.maybe_escalate_screen(None) is False


def test_shadow_sampler_and_on_demand_audit(servable):
    plane = _plane(shadow_fraction=0.5)
    assert [plane.want_shadow() for _ in range(4)] == [False, True, False, True]
    off = _plane(shadow_fraction=0.0)
    assert not any(off.want_shadow() for _ in range(8))
    assert off.request_audit(2) == 2
    assert [off.want_shadow() for _ in range(3)] == [True, True, False]
    assert off.snapshot()["shadow"]["audits_run"] == 2
    batcher, _ = _stack(servable, plane=off)
    try:
        off.request_audit()
        arrays = make_arrays(6, seed=60)
        got = batcher.submit(servable, arrays).result(timeout=60)["prediction_node"]
        snap = off.snapshot()
        assert snap["shadow"]["batches"] == 1 and snap["shadow"]["mismatches"] == 0
        assert batcher.stats.shadow_batches == 1
    finally:
        batcher.stop()
    assert np.array_equal(got, _solo(servable, arrays))


def test_suspect_clears_after_consecutive_clean_passes():
    plane = _plane(suspect_clear_passes=2)
    plane._escalate("test")
    ok = [np.ones(4, np.float32)]
    plane.shadow_compare(ok, ok)
    assert plane.suspect is True
    plane.shadow_compare(ok, ok)
    assert plane.suspect is False
    with pytest.raises(OutputCorruptError):
        plane.shadow_compare(ok, [np.zeros(4, np.float32)])
    assert plane.suspect is True


# ------------------------------------------------------ the batcher's hooks


def test_screen_fails_exactly_the_nan_row(servable):
    plane = _plane()
    batcher, _ = _stack(servable, plane=plane, max_wait_us=200_000)
    try:
        batcher.submit(servable, make_arrays(3, seed=39)).result(timeout=60)  # warm
        payloads = [make_arrays(5, seed=s) for s in (40, 41, 42)]
        faults.get().add("score_nan", "error", key=poison_fault_key(prepare_inputs(payloads[1])))
        futs = [batcher.submit(servable, p) for p in payloads]
        with pytest.raises(IntegrityScreenError):
            futs[1].result(timeout=60)
        got = [futs[i].result(timeout=60)["prediction_node"] for i in (0, 2)]
        assert batcher.stats.batches == 2  # the warm batch; the three rode one batch
        snap = plane.snapshot()
        assert snap["screen"]["trips"] == 1
        assert snap["escalations"] == 0 and snap["suspect"] is False
    finally:
        batcher.stop()
    whole = _solo(servable, {k: np.concatenate([p[k] for p in payloads]) for k in payloads[0]})
    assert np.array_equal(got[0], whole[:5]) and np.array_equal(got[1], whole[10:])


def test_shadow_catches_a_keyed_bitflip_and_suspect_clears(servable):
    """A readback_bitflip keyed to one payload under shadow_fraction 1.0:
    its batch fails (OutputCorruptError, UNAVAILABLE at the RPC layer)
    before delivery, the replica turns suspect, and suspect_clear_passes
    clean shadows clear it."""
    from distributed_tf_serving_tpu_torch.serving.service import ServiceError

    plane = _plane(shadow_fraction=1.0)
    batcher, impl = _stack(servable, plane=plane)
    try:
        arrays = make_arrays(9, seed=50)
        faults.get().add("readback_bitflip", "error", count=1,
                         key=poison_fault_key(prepare_inputs(arrays)))
        fut = batcher.submit(servable, arrays)
        with pytest.raises(OutputCorruptError):
            fut.result(timeout=90)
        mapped = PredictionServiceImpl._translate_batcher_error(fut.exception(), fut)
        assert isinstance(mapped, ServiceError) and mapped.code == "UNAVAILABLE"
        snap = plane.snapshot()
        assert snap["shadow"]["mismatches"] == 1 and snap["escalations"] == 1
        assert snap["suspect"] is True and "shadow mismatch" in snap["suspect_reason"]
        for i in range(plane.config.suspect_clear_passes):
            batcher.submit(servable, make_arrays(3, seed=51 + i)).result(timeout=60)
        assert plane.snapshot()["suspect"] is False
        again = batcher.submit(servable, arrays).result(timeout=60)["prediction_node"]
    finally:
        batcher.stop()
    assert np.array_equal(again, _solo(servable, arrays))


def test_natively_packed_shadow_compares_clean_and_records_the_input_cache():
    """bf16 compute: the batch is natively packed, and its shadow packs
    the padded arrays rebuilt from the same parts through
    pack_host_combined (no entry of its own in the input cache, so a
    repeat misses again); the two readbacks are bit-identical. A
    generic-path (f32) shadow reads the upload its batch just made (an
    input-cache hit)."""
    assert native.ensure()
    for cdt, want_hits in (("bfloat16", 0), ("float32", 4)):
        sv = _servable(compute_dtype=cdt)
        plane = _plane(shadow_fraction=1.0)
        batcher, _ = _stack(sv, plane=plane, max_wait_us=200_000)
        try:
            batcher.submit(sv, make_arrays(3, seed=99)).result(timeout=60)  # warm
            futs = [batcher.submit(sv, make_arrays(n, seed=n)) for n in (5, 11)]
            for f in futs:
                f.result(timeout=60)
            batcher.submit(sv, make_arrays(20, seed=3)).result(timeout=60)
            batcher.submit(sv, make_arrays(20, seed=3)).result(timeout=60)  # a repeat
            snap = plane.snapshot()
            assert snap["shadow"]["batches"] == batcher.stats.batches == 4
            assert snap["shadow"]["mismatches"] == 0
            if cdt == "bfloat16":
                assert batcher.stats.native_packs == 3  # the repeat hit its own entry
                assert batcher.stats.shadow_native_packs == 0
            assert batcher.stats.shadow_input_cache_hits == want_hits
        finally:
            batcher.stop()


@pytest.mark.parametrize("cdt", ["bfloat16", "float32"])
def test_a_shadow_leaves_the_host_path_counts_and_the_input_cache_alone(cdt):
    """With every batch shadowed, the primary counters count the batches
    alone (an H2D copy or an input-cache hit per batch), and the shadow's
    own device stage is counted in the shadow_* stats; the input cache
    holds only the primaries' entries."""
    assert native.ensure()
    sv = _servable(compute_dtype=cdt)
    plane = _plane(shadow_fraction=1.0)
    batcher, _ = _stack(sv, plane=plane, max_wait_us=0)
    try:
        for seed in (1, 2, 1, 3, 2):  # two repeats: input-cache hits
            batcher.submit(sv, make_arrays(9, seed=seed)).result(timeout=60)
        s, cache = batcher.stats, batcher.input_cache
        assert s.batches == s.shadow_batches == 5 and plane.snapshot()["shadow"]["mismatches"] == 0
        assert cache.hits == 2 and cache.misses == 3 and len(cache._lru) == 3
        assert s.h2d_copies + cache.hits == s.batches
        assert s.fused_batches == s.shadow_fused_batches == 0  # the CPU runs model.apply
        assert s.shadow_h2d_copies + s.shadow_input_cache_hits == s.shadow_batches
        assert s.shadow_native_packs == 0
        if cdt == "bfloat16":
            assert s.native_packs == 3 and s.shadow_input_cache_hits == 0
        else:
            assert s.native_packs == 0 and s.shadow_input_cache_hits == 5
    finally:
        batcher.stop()


def test_both_planes_on_or_off_give_the_same_bits(servable):
    arrays = [make_arrays(n, seed=100 + n) for n in (1, 7, 30, 64)]
    outs = []
    for armed in (False, True):
        plane = _plane(shadow_fraction=1.0) if armed else None
        ov = OverloadConfig(enabled=True).build() if armed else None
        batcher, _ = _stack(servable, plane=plane, overload=ov)
        try:
            outs.append([batcher.submit(servable, a).result(timeout=60)["prediction_node"]
                         for a in arrays])
            if armed:
                assert plane.snapshot()["shadow"]["batches"] == len(arrays)
        finally:
            batcher.stop()
    for x, y in zip(*outs):
        assert np.array_equal(x, y)


def test_disabled_plane_is_inert(servable):
    batcher, impl = _stack(servable)
    try:
        assert batcher.integrity is None and impl.integrity is None
        assert impl.integrity_stats() is None
        assert impl.response_crc_sidecar(None) is None
        batcher.submit(servable, make_arrays(4)).result(timeout=60)
        assert batcher.stats.shadow_batches == 0
    finally:
        batcher.stop()


# ------------------------------------------------ wire layer over real gRPC


@pytest.fixture()
def wired_backend(servable):
    from distributed_tf_serving_tpu_torch.serving.server import create_server

    plane = _plane()
    batcher, impl = _stack(servable, plane=plane)
    server, port = create_server(impl, "127.0.0.1:0")
    server.start()
    yield f"127.0.0.1:{port}", plane
    server.stop(0)
    batcher.stop()


def _client_predict(addr, payloads, **kw):
    from distributed_tf_serving_tpu.client import ShardedPredictClient

    async def go():
        async with ShardedPredictClient([addr], "DCN", integrity_checksums=True, **kw) as c:
            out = await asyncio.gather(*(c.predict(p) for p in payloads),
                                       return_exceptions=True)
            return out, c.resilience_counters()

    return asyncio.run(go())


def test_wire_crc_roundtrip_both_directions(wired_backend, servable):
    addr, plane = wired_backend
    arrays = make_arrays(9, seed=3)
    (got,), counters = _client_predict(addr, [arrays])
    assert np.array_equal(got, _solo(servable, arrays))
    snap = plane.snapshot()["wire"]
    assert snap["inputs_verified"] >= 1 and snap["inputs_rejected"] == 0
    assert snap["responses_stamped"] >= 1 and counters["corrupt_responses"] == 0


def test_corrupt_request_fails_alone_batchmates_deliver(wired_backend, servable):
    from distributed_tf_serving_tpu.client import PredictClientError

    addr, plane = wired_backend
    payloads = [make_arrays(5, seed=s) for s in (20, 21, 22)]
    jax_faults.get().add("wire_corrupt", "error", key="feat_ids", count=1)
    results, _ = _client_predict(addr, payloads)
    errs = [r for r in results if isinstance(r, Exception)]
    assert len(errs) == 1 and isinstance(errs[0], PredictClientError)
    assert "corrupt-wire" in str(errs[0])
    for p, r in zip(payloads, results):
        if not isinstance(r, Exception):
            assert r.shape == (5,) and np.isfinite(r).all()
    assert plane.snapshot()["wire"]["inputs_rejected"] == 1


def test_corrupt_response_caught_before_merge(wired_backend, servable):
    addr, plane = wired_backend
    arrays = make_arrays(7, seed=31)
    jax_faults.get().add("wire_corrupt", "error", key="response", count=1)
    (got,), counters = _client_predict(addr, [arrays], scoreboard=True, failover_attempts=3,
                                       backoff_initial_s=0.0)
    assert np.array_equal(got, _solo(servable, arrays))
    assert counters["corrupt_responses"] == 1
    assert counters["scoreboard"]["corruptions"] == 1


@pytest.mark.parametrize("content", [True, False], ids=["tensor_content", "half_val"])
def test_a_bf16_stamp_verifies_over_the_wire_bits_on_both_servers(content):
    """A bf16 feat_wts stamped by the JAX codec (crc_sidecar over the
    ml_dtypes.bfloat16 array the client sends) passes the input check of
    the JAX service and of the port's; one flipped bit of its payload fails
    both with INVALID_ARGUMENT corrupt-wire. The port decodes the tensor
    widened to float32 and checks the bits that were sent."""
    import ml_dtypes

    from distributed_tf_serving_tpu.models import Servable as JaxServable
    from distributed_tf_serving_tpu.models import ServableRegistry as JaxRegistry
    from distributed_tf_serving_tpu.models import ctr_signatures as jax_signatures
    from distributed_tf_serving_tpu.proto import serving_apis_pb2 as japis
    from distributed_tf_serving_tpu.serving.service import PredictionServiceImpl as JaxImpl
    from distributed_tf_serving_tpu.serving.service import ServiceError as JaxServiceError
    from distributed_tf_serving_tpu_torch.proto import serving_apis_pb2 as apis
    from distributed_tf_serving_tpu_torch.serving.service import ServiceError

    kw = dict(KW, compute_dtype="bfloat16")
    jm = jax_build("dcn_v2", JaxConfig(name="DCN", **kw))
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    jreg = JaxRegistry()
    jreg.load(JaxServable(name="DCN", version=1, model=jm, params=jp,
                          signatures=jax_signatures(F)))
    jb = jax_batcher.DynamicBatcher(buckets=(32, 64), max_wait_us=0).start()
    jimpl = JaxImpl(jreg, jb)
    jimpl.integrity = jax_integrity.IntegrityPlane(jax_config.IntegrityConfig(enabled=True))
    tsv = Servable(name="DCN", version=1, model=build_model("dcn_v2", ModelConfig(name="DCN", **kw)),
                   params=params_from_jax(jp, "cpu"), signatures=ctr_signatures(F))
    plane = _plane()
    tb, timpl = _stack(tsv, plane=plane)
    try:
        arrays = make_arrays(9, seed=41)
        sent = {"feat_ids": arrays["feat_ids"],
                "feat_wts": arrays["feat_wts"].astype(ml_dtypes.bfloat16)}
        sidecar = jax_codec.crc_sidecar(sent)
        jreq = japis.PredictRequest()
        jreq.model_spec.name = "DCN"
        for k, v in sent.items():
            jax_codec.from_ndarray(v, use_tensor_content=content, out=jreq.inputs[k])
        assert jreq.inputs["feat_wts"].dtype == jax_codec.DataType.DT_BFLOAT16

        def both(jr):
            tr = apis.PredictRequest.FromString(jr.SerializeToString())
            outs = []
            for impl, req, err in ((jimpl, jr, JaxServiceError), (timpl, tr, ServiceError)):
                try:
                    resp = impl.predict(req, input_crc=sidecar)
                    outs.append(resp.outputs["prediction_node"])
                except err as e:
                    outs.append(e)
            return outs

        jgot, tgot = both(jreq)
        assert jax_codec.to_ndarray(jgot).shape == codec.to_ndarray(tgot).shape == (9,)
        snap = plane.snapshot()["wire"]
        assert snap["inputs_verified"] == 1 and snap["inputs_rejected"] == 0

        bad = japis.PredictRequest()
        bad.CopyFrom(jreq)
        wts = bad.inputs["feat_wts"]
        if content:
            raw = bytearray(wts.tensor_content)
            raw[5] ^= 0x01
            wts.tensor_content = bytes(raw)
        else:
            wts.half_val[3] ^= 0x0001
        for e in both(bad):
            assert e.code == "INVALID_ARGUMENT" and "corrupt-wire" in str(e)
            assert "feat_wts" in str(e)
        snap = plane.snapshot()["wire"]
        assert snap["inputs_verified"] == 1 and snap["inputs_rejected"] == 1
    finally:
        tb.stop()
        jb.stop()


# ----------------------------------------------------- config + build_stack


def test_integrity_config_parsing(tmp_path):
    p = tmp_path / "c.toml"
    p.write_text("[integrity]\nenabled = true\nshadow_fraction = 0.25\n"
                 "screen_trips_per_window = 5\nscreen_min = 0.0\nscreen_max = 1.0\n")
    ic = load_config(p)["integrity"]
    assert ic.enabled and ic.shadow_fraction == 0.25 and ic.screen_trips_per_window == 5
    assert (ic.screen_min, ic.screen_max) == (0.0, 1.0)
    assert dataclasses.asdict(ic) == dataclasses.asdict(jax_config.load_config(p)["integrity"])
    p2 = tmp_path / "empty.toml"
    p2.write_text("")
    assert "integrity" not in load_config(p2)
    with pytest.raises(ValueError, match="shadow_fraction"):
        IntegrityConfig(shadow_fraction=1.5)
    with pytest.raises(ValueError, match="screen_trips_per_window"):
        IntegrityConfig(screen_trips_per_window=0)
    with pytest.raises(ValueError, match="screen_max"):
        IntegrityConfig(screen_min=0.5, screen_max=0.1)
    p3 = tmp_path / "bad.toml"
    p3.write_text("[integrity]\nnot_a_knob = 1\n")
    with pytest.raises(ValueError, match="unknown"):
        load_config(p3)
    p4 = tmp_path / "router.toml"
    p4.write_text("[integrity]\nenabled = true\nrouter_audit_fraction = 0.01\n")
    assert load_config(p4)["integrity"].router_audit_fraction == 0.01
    with pytest.raises(ValueError, match="router_audit_fraction"):
        IntegrityConfig(router_audit_fraction=1.5)


def test_shadow_refuses_score_cache():
    from distributed_tf_serving_tpu_torch.serving.server import build_stack

    cfg = ServerConfig(buckets=(16,), warmup=False, num_fields=F)
    mc = ModelConfig(name="DCN", **KW)
    with pytest.raises(ValueError, match="conflicts with .cache."):
        build_stack(cfg, mc, device="cpu",
                    integrity_config=IntegrityConfig(enabled=True, shadow_fraction=0.1),
                    cache_config=CacheConfig(enabled=True))
    impl, batcher, _ = build_stack(cfg, mc, device="cpu",
                                   integrity_config=IntegrityConfig(enabled=True),
                                   cache_config=CacheConfig(enabled=True))
    try:
        assert impl.integrity is not None and batcher.integrity is impl.integrity
    finally:
        batcher.stop()


def test_build_stack_disabled_by_default():
    from distributed_tf_serving_tpu_torch.serving.server import build_stack

    cfg = ServerConfig(buckets=(16,), warmup=False, num_fields=F)
    impl, batcher, _ = build_stack(cfg, ModelConfig(name="DCN", **KW), device="cpu",
                                   integrity_config=IntegrityConfig())
    try:
        assert impl.integrity is None and batcher.integrity is None
    finally:
        batcher.stop()


# ------------------------------------------------------------ REST + metrics


def test_integrityz_monitoring_and_audit_routes(servable):
    import aiohttp

    from distributed_tf_serving_tpu_torch.serving.rest import start_rest_gateway

    plane = _plane(shadow_fraction=0.5)
    batcher, impl = _stack(servable, plane=plane)

    async def go():
        runner, port = await start_rest_gateway(impl, port=0)
        try:
            async with aiohttp.ClientSession(f"http://127.0.0.1:{port}") as s:
                async with s.get("/integrityz") as r:
                    body = await r.json()
                    assert r.status == 200 and body["enabled"] is True
                    assert body["shadow"]["fraction"] == 0.5
                async with s.get("/monitoring?section=integrity") as r:
                    sec = await r.json()
                    assert r.status == 200 and set(sec) == {"integrity"}
                    assert sec["integrity"]["enabled"] is True
                async with s.get("/monitoring?section=nope") as r:
                    assert r.status == 400
                async with s.get("/monitoring") as r:
                    assert (await r.json())["integrity"]["enabled"] is True
                async with s.post("/integrityz/audit?batches=2") as r:
                    assert r.status == 200
                    assert (await r.json()) == {"requested": 2, "pending_audits": 2}
                async with s.post("/integrityz/audit?batches=0") as r:
                    assert r.status == 400
                async with s.post("/integrityz/audit?batches=x") as r:
                    assert r.status == 400
                async with s.get("/monitoring/prometheus/metrics") as r:
                    text = await r.text()
                    assert "dts_tpu_integrity_audits_requested_total 2" in text
        finally:
            await runner.cleanup()

    try:
        asyncio.run(go())
    finally:
        batcher.stop()


def test_integrityz_with_the_plane_off(servable):
    import aiohttp

    from distributed_tf_serving_tpu_torch.serving.rest import start_rest_gateway

    batcher, impl = _stack(servable)

    async def go():
        runner, port = await start_rest_gateway(impl, port=0)
        try:
            async with aiohttp.ClientSession(f"http://127.0.0.1:{port}") as s:
                async with s.get("/integrityz") as r:
                    assert r.status == 200 and (await r.json()) == {"enabled": False}
                async with s.post("/integrityz/audit") as r:
                    assert r.status == 404
        finally:
            await runner.cleanup()

    try:
        asyncio.run(go())
    finally:
        batcher.stop()


def test_integrity_prometheus_series_are_the_jax_exposition():
    plane = _plane()
    plane.note_screen_trip("x")
    plane.request_audit(3)
    snap = plane.snapshot()
    text = ServerMetrics().prometheus_text(integrity=snap)
    assert text == JaxMetrics().prometheus_text(integrity=snap)
    assert "dts_tpu_integrity_screen_trips_total 1" in text
    assert "dts_tpu_integrity_suspect 0" in text


def test_cli_arms_both_planes_from_toml(tmp_path):
    """The CLI with [overload] and [integrity] enabled: a stamped Predict
    is verified and answered with x-dts-score-crc, a sheddable one under
    the `pressure` site's SHED is refused with retry-after-ms, the log names
    both planes, and SIGTERM exits 0."""
    import os
    import signal
    import socket
    import subprocess
    import sys
    import time
    from pathlib import Path

    import grpc

    from distributed_tf_serving_tpu_torch.proto import (
        HealthCheckRequest,
        HealthStub,
        PredictionServiceStub,
    )
    from distributed_tf_serving_tpu_torch.proto import health as health_proto
    from distributed_tf_serving_tpu_torch.proto import serving_apis_pb2 as apis

    repo = Path(__file__).resolve().parents[1]
    cfg = tmp_path / "planes.toml"
    cfg.write_text(f"[server]\nnum_fields = {F}\nbuckets = [8, 32]\n"
                   "[model]\nnum_fields = 8\nvocab_size = 1009\nembed_dim = 4\nmlp_dims = [16]\n"
                   "num_cross_layers = 1\ncompute_dtype = \"float32\"\n"
                   "[overload]\nenabled = true\nadjust_interval_s = 0.05\n"
                   "[integrity]\nenabled = true\nshadow_fraction = 1.0\n")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, DTS_TPU_FAULTS="pressure=error,code=SHED")
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_tf_serving_tpu_torch.serving.server", "--config",
         str(cfg), "--host", "127.0.0.1", "--port", str(port), "--device", "cpu",
         "--max-workers", "4"],
        cwd=repo, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
            grpc.channel_ready_future(ch).result(timeout=90)
            end = time.time() + 90
            while HealthStub(ch).Check(HealthCheckRequest(service="")).status != \
                    health_proto.SERVING:
                assert proc.poll() is None and time.time() < end
                time.sleep(0.1)
            arrays = make_arrays(5, seed=9)
            req = apis.PredictRequest()
            req.model_spec.name = "DCN"
            for k, v in arrays.items():
                codec.from_ndarray(v, out=req.inputs[k])
            stub = PredictionServiceStub(ch)
            resp, call = stub.Predict.with_call(
                req, timeout=30, metadata=((codec.CRC_INPUT_MD, codec.crc_sidecar(arrays)),
                                           ("x-dts-criticality", "critical")))
            md = dict(call.trailing_metadata())
            decoded = {k: codec.to_ndarray(v) for k, v in resp.outputs.items()}
            assert codec.verify_crc_sidecar(decoded, md[codec.CRC_SCORE_MD]) == []
            time.sleep(0.1)  # a tick past adjust_interval_s: the rule pins SHED
            with pytest.raises(grpc.RpcError) as e:
                stub.Predict(req, timeout=30, metadata=(("x-dts-criticality", "sheddable"),))
            assert e.value.code() == grpc.StatusCode.RESOURCE_EXHAUSTED
            assert int(dict(e.value.trailing_metadata())["retry-after-ms"]) >= 25
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, out
        assert "adaptive overload control on" in out and "data-integrity plane on" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
