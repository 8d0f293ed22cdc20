"""The port's PredictStream and UDS listener on the CPU: the sub-batch
plan, the service generator (coverage, out-of-order chunks, one `final`,
failures and deadlines), solo sub-batches in the batcher, the gRPC server
over TCP and over a Unix-domain socket, and the JAX package's
`ShardedPredictClient.predict_streamed()` against the port's server.
Mirrors tests/test_streaming.py case by case where the feature is ported.

Tolerance: streamed scores are bit-identical to unary Predict here (on the
CPU the plain forward of a row does not depend on its batch), and within
1e-5 of JAX model.apply."""

import asyncio
import os
import socket
import subprocess
import sys
import threading
import time

import grpc
import jax
import numpy as np
import pytest

from distributed_tf_serving_tpu.client import ShardedPredictClient, StreamingMerger
from distributed_tf_serving_tpu.models import ModelConfig as JaxConfig
from distributed_tf_serving_tpu.models import build_model as jax_build
from distributed_tf_serving_tpu.serving.batcher import fold_ids_host as jax_fold
from distributed_tf_serving_tpu_torch import codec
from distributed_tf_serving_tpu_torch.convert import params_from_jax
from distributed_tf_serving_tpu_torch.models import (
    ModelConfig,
    Servable,
    ServableRegistry,
    build_model,
    ctr_signatures,
)
from distributed_tf_serving_tpu_torch.proto import PredictionServiceStub
from distributed_tf_serving_tpu_torch.proto import serving_apis_pb2 as apis
from distributed_tf_serving_tpu_torch.serving.batcher import DynamicBatcher
from distributed_tf_serving_tpu_torch.serving.server import build_stack, create_server
from distributed_tf_serving_tpu_torch.serving.service import PredictionServiceImpl, ServiceError
from distributed_tf_serving_tpu_torch.utils.config import BatchingConfig, ServerConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F = 8
KW = dict(num_fields=F, vocab_size=1009, embed_dim=4, mlp_dims=(16,), num_cross_layers=1,
          compute_dtype="float32")
WAIT = 30


@pytest.fixture(scope="module")
def pair():
    jm = jax_build("dcn_v2", JaxConfig(**KW))
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    sv = Servable(name="DCN", version=1, model=build_model("dcn_v2", ModelConfig(**KW)),
                  params=params_from_jax(jp, "cpu"), signatures=ctr_signatures(F))
    return sv, jm, jp


def make_arrays(n, seed=0):
    rng = np.random.RandomState(seed)
    return {
        "feat_ids": rng.randint(0, 1 << 40, size=(n, F)).astype(np.int64),
        "feat_wts": rng.rand(n, F).astype(np.float32),
    }


def reference_scores(jm, jp, arrays):
    return np.asarray(jm.apply(jp, {"feat_ids": jax_fold(arrays["feat_ids"], KW["vocab_size"]),
                                    "feat_wts": arrays["feat_wts"]})["prediction_node"])


def make_stack(sv, **batcher_kw):
    registry = ServableRegistry()
    registry.load(sv)
    kw = dict(buckets=(32, 64, 128), max_wait_us=0, device="cpu")
    kw.update(batcher_kw)
    batcher = DynamicBatcher(**kw).start()
    return batcher, PredictionServiceImpl(registry, batcher)


def request(arrays):
    """The port's own PredictRequest, score output only."""
    req = apis.PredictRequest()
    req.model_spec.name = "DCN"
    for k, v in arrays.items():
        codec.from_ndarray(v, out=req.inputs[k])
    req.output_filter.append("prediction_node")
    return req


def drain(chunks, total):
    """Merge chunks (any order) -> scores; each row covered exactly once."""
    merger = StreamingMerger(total)
    for c in chunks:
        assert c.total == total
        merger.add(c.offset, codec.to_ndarray(c.outputs["prediction_node"]))
    assert merger.complete
    return merger.result()


# ------------------------------------------------------------- the plan


def test_stream_plan_split_and_clamp(pair):
    sv, _, _ = pair
    batcher, impl = make_stack(sv)
    try:
        assert impl._stream_plan(100, None) == [(0, 100)]  # off by default
        impl.stream_chunk_candidates = 32
        assert impl._stream_plan(100, None) == [(0, 32), (32, 32), (64, 32), (96, 4)]
        assert impl._stream_plan(100, 50) == [(0, 50), (50, 50)]  # the override wins
        assert impl._stream_plan(20, None) == [(0, 20)]  # chunk >= n: one chunk
        plan = impl._stream_plan(1000, 1)  # clamped to at most 64 chunks
        assert len(plan) <= impl._STREAM_MAX_CHUNKS == 64
        assert sum(c for _o, c in plan) == 1000
        assert [o for o, _c in plan] == sorted({o for o, _c in plan})
    finally:
        batcher.stop()


# ------------------------------------------------------- the generator


def test_streamed_bit_identical_and_out_of_order(pair, monkeypatch):
    """Sub-batches merge to exactly the unary scores even when their
    readbacks complete out of order (the first batch's wait delayed past
    its siblings')."""
    sv, jm, jp = pair
    batcher, impl = make_stack(sv, pipeline_depth=4, completion_workers=4)
    try:
        arrays = make_arrays(100, seed=3)
        req = request(arrays)
        unary = codec.to_ndarray(impl.predict(req).outputs["prediction_node"])
        real_wait = DynamicBatcher._wait
        first = []

        def slow_first(self, rb):
            if not first:
                first.append(rb)
                time.sleep(0.4)
            return real_wait(self, rb)

        monkeypatch.setattr(DynamicBatcher, "_wait", slow_first)
        chunks = list(impl.predict_stream(req, chunk=32))
        assert len(chunks) == 4
        assert [c.final for c in chunks].count(True) == 1 and chunks[-1].final
        offsets = [c.offset for c in chunks]
        assert offsets != sorted(offsets), f"chunks arrived in offset order {offsets}"
        assert sorted((c.offset, c.count) for c in chunks) == [(0, 32), (32, 32), (64, 32),
                                                               (96, 4)]
        merged = drain(chunks, 100)
        assert np.array_equal(merged, unary)
        np.testing.assert_allclose(merged, reference_scores(jm, jp, arrays), rtol=1e-5,
                                   atol=1e-6)
        assert batcher.stats.batches == 5  # the unary batch + four solo sub-batches
    finally:
        batcher.stop()


def test_stream_single_chunk_when_disabled(pair):
    sv, _, _ = pair
    batcher, impl = make_stack(sv)
    try:
        req = request(make_arrays(40, seed=5))
        unary = codec.to_ndarray(impl.predict(req).outputs["prediction_node"])
        chunks = list(impl.predict_stream(req))
        assert len(chunks) == 1 and chunks[0].final
        assert (chunks[0].offset, chunks[0].count, chunks[0].total) == (0, 40, 40)
        assert chunks[0].model_spec.name == "DCN" and chunks[0].model_spec.version.value == 1
        assert np.array_equal(drain(chunks, 40), unary)
    finally:
        batcher.stop()


def test_stream_chunk_zero_is_one_chunk(pair):
    sv, _, _ = pair
    batcher, impl = make_stack(sv)
    impl.stream_chunk_candidates = 16
    try:
        chunks = list(impl.predict_stream(request(make_arrays(40, seed=6)), chunk=0))
        assert len(chunks) == 3  # 0 = no override: the server's 16
        impl.stream_chunk_candidates = 0
        assert len(list(impl.predict_stream(request(make_arrays(40, seed=6)), chunk=0))) == 1
    finally:
        batcher.stop()


def test_stream_deadline_expires_mid_stream(pair, monkeypatch):
    """A deadline that runs out while sub-batches are pending aborts with
    DEADLINE_EXCEEDED at the deadline, and the rest is withdrawn."""
    sv, _, _ = pair
    batcher, impl = make_stack(sv, pipeline_depth=2)
    real_issue = DynamicBatcher._issue

    def slow_issue(self, *a, **k):
        time.sleep(1.0)
        return real_issue(self, *a, **k)

    monkeypatch.setattr(DynamicBatcher, "_issue", slow_issue)
    try:
        t0 = time.perf_counter()
        with pytest.raises(ServiceError) as exc_info:
            for _chunk in impl.predict_stream(request(make_arrays(100, seed=7)),
                                              deadline_s=0.3, chunk=32):
                pass
        assert exc_info.value.code == "DEADLINE_EXCEEDED"
        assert time.perf_counter() - t0 < 5.0
    finally:
        batcher.stop()


def test_a_failed_sub_batch_aborts_the_stream_and_cancels_its_siblings(pair, monkeypatch):
    sv, _, _ = pair
    batcher, impl = make_stack(sv, pipeline_depth=1)
    real_issue = DynamicBatcher._issue
    calls = []

    def failing_second(self, *a, **k):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("device step failed")
        time.sleep(0.05)
        return real_issue(self, *a, **k)

    monkeypatch.setattr(DynamicBatcher, "_issue", failing_second)
    try:
        got = []
        with pytest.raises(ServiceError) as exc_info:
            for chunk in impl.predict_stream(request(make_arrays(128, seed=8)), chunk=8):
                got.append(chunk)
        assert exc_info.value.code == "UNAVAILABLE"
        assert "device step failed" in str(exc_info.value)
        assert not any(c.final for c in got)  # the stream never completed
        time.sleep(0.3)
        # Withdrawn sub-batches never reached the device stage.
        assert len(calls) < 16
    finally:
        batcher.stop()


def test_stream_refuses_what_predict_refuses(pair):
    sv, _, _ = pair
    batcher, impl = make_stack(sv)
    try:
        req = request(make_arrays(5, seed=9))
        req.model_spec.name = "nope"
        with pytest.raises(ServiceError) as exc_info:
            list(impl.predict_stream(req))
        assert exc_info.value.code == "NOT_FOUND"
        with pytest.raises(ServiceError) as exc_info:
            list(impl.predict_stream(request(make_arrays(500, seed=9)), chunk=0))
        assert exc_info.value.code == "RESOURCE_EXHAUSTED"  # no bucket holds 500
    finally:
        batcher.stop()


# ------------------------------------------------------- solo sub-batches


@pytest.mark.parametrize("solo", [True, False])
def test_solo_items_never_coalesce(pair, solo):
    """Four items queued before the batcher starts, inside a wide-open
    window: solo ones run as four batches, ordinary ones as one."""
    sv, _, _ = pair
    batcher = DynamicBatcher(buckets=(32, 256), max_wait_us=50_000, device="cpu")
    try:
        futs = [batcher.submit(sv, make_arrays(8, seed=s), _solo=solo) for s in range(4)]
        batcher.start()
        for f in futs:
            f.result(WAIT)
        assert batcher.stats.batches == (4 if solo else 1)
        assert batcher.stats.requests == 4
    finally:
        batcher.stop()


def test_a_solo_item_is_not_joined_by_the_next(pair):
    sv, _, _ = pair
    batcher = DynamicBatcher(buckets=(32, 256), max_wait_us=50_000, device="cpu")
    try:
        futs = [batcher.submit(sv, make_arrays(8, seed=1), _solo=True)]
        futs += [batcher.submit(sv, make_arrays(8, seed=s)) for s in (2, 3)]
        batcher.start()
        for f in futs:
            f.result(WAIT)
        assert batcher.stats.batches == 2  # the solo item, then the other two together
    finally:
        batcher.stop()


# --------------------------------------------------------- the transports


@pytest.fixture
def served(pair, tmp_path):
    """The port's server on TCP and on a Unix-domain socket."""
    sv, jm, jp = pair
    batcher, impl = make_stack(sv, pipeline_depth=4)
    impl.stream_chunk_candidates = 32
    uds = str(tmp_path / "dts.sock")
    server, port = create_server(impl, "127.0.0.1:0", uds_path=uds)
    server.start()
    try:
        yield {"tcp": f"127.0.0.1:{port}", "uds": f"unix:{uds}", "jax": (jm, jp),
               "batcher": batcher}
    finally:
        server.stop(0)
        batcher.stop()


@pytest.mark.parametrize("transport", ["tcp", "uds"])
def test_stream_over_grpc(served, transport):
    arrays = make_arrays(90, seed=13)
    req = request(arrays)
    with grpc.insecure_channel(served[transport]) as ch:
        stub = PredictionServiceStub(ch)
        unary = codec.to_ndarray(stub.Predict(req, timeout=WAIT).outputs["prediction_node"])
        chunks = list(stub.PredictStream(req, timeout=WAIT))
    assert len(chunks) == 3 and sum(c.count for c in chunks) == 90
    assert sum(1 for c in chunks if c.final) == 1
    assert np.array_equal(drain(chunks, 90), unary)


def test_tcp_and_uds_answer_the_same(served):
    arrays = make_arrays(50, seed=14)
    got = {}
    for transport in ("tcp", "uds"):
        with grpc.insecure_channel(served[transport]) as ch:
            got[transport] = codec.to_ndarray(PredictionServiceStub(ch).Predict(
                request(arrays), timeout=WAIT).outputs["prediction_node"])
    assert np.array_equal(got["tcp"], got["uds"])


def test_stream_chunk_metadata_override(served):
    with grpc.insecure_channel(served["tcp"]) as ch:
        chunks = list(PredictionServiceStub(ch).PredictStream(
            request(make_arrays(64, seed=17)), timeout=WAIT,
            metadata=(("x-dts-stream-chunk", "16"),)))
    assert [c.count for c in chunks].count(16) == 4


def test_stream_errors_map_to_grpc_status(served):
    req = request(make_arrays(5, seed=18))
    req.model_spec.name = "nope"
    with grpc.insecure_channel(served["tcp"]) as ch:
        with pytest.raises(grpc.RpcError) as exc_info:
            list(PredictionServiceStub(ch).PredictStream(req, timeout=WAIT))
    assert exc_info.value.code() == grpc.StatusCode.NOT_FOUND


@pytest.mark.parametrize("transport", ["tcp", "uds"])
def test_reference_client_predict_streamed_matches_unary(served, transport):
    """The JAX package's client: predict_streamed() against the port's
    server equals its unary predict(), over TCP and over unix:<path>."""
    jm, jp = served["jax"]
    arrays = make_arrays(100, seed=23)

    async def run():
        async with ShardedPredictClient([served[transport]], "DCN",
                                        stream_chunk_candidates=32) as client:
            unary = await client.predict(arrays)
            streamed = await client.predict_streamed(arrays)
            ranked = await client.predict_streamed(arrays, sort_scores=True)
            return unary, streamed, ranked, client.stream_stats()

    unary, streamed, ranked, stats = asyncio.run(run())
    assert np.array_equal(unary, streamed)
    assert np.array_equal(np.sort(unary), ranked)
    np.testing.assert_allclose(streamed, reference_scores(jm, jp, arrays), rtol=1e-5, atol=1e-6)
    assert stats["streamed_shards"] == 2 and stats["stream_chunks"] == 8


def test_reference_client_streams_over_two_port_servers(pair, tmp_path):
    """Two shards, one over TCP and one over UDS, merged by the client."""
    sv, jm, jp = pair
    stacks = [make_stack(sv) for _ in range(2)]
    servers = []
    try:
        hosts = []
        for i, (batcher, impl) in enumerate(stacks):
            uds = str(tmp_path / f"s{i}.sock")
            server, port = create_server(impl, "127.0.0.1:0", uds_path=uds)
            server.start()
            servers.append(server)
            hosts.append(f"127.0.0.1:{port}" if i == 0 else f"unix:{uds}")
        arrays = make_arrays(120, seed=29)

        async def run():
            async with ShardedPredictClient(hosts, "DCN", stream_chunk_candidates=16) as client:
                return await client.predict(arrays), await client.predict_streamed(arrays)

        unary, streamed = asyncio.run(run())
        assert np.array_equal(unary, streamed)
        np.testing.assert_allclose(streamed, reference_scores(jm, jp, arrays), rtol=1e-5,
                                   atol=1e-6)
    finally:
        for server in servers:
            server.stop(0)
        for batcher, _ in stacks:
            batcher.stop()


def test_uds_replaces_a_stale_socket_file(pair, tmp_path):
    sv, _, _ = pair
    batcher, impl = make_stack(sv)
    uds = tmp_path / "stale.sock"
    uds.write_text("left over")
    server, _ = create_server(impl, "127.0.0.1:0", uds_path=str(uds))
    server.start()
    try:
        with grpc.insecure_channel(f"unix:{uds}") as ch:
            resp = PredictionServiceStub(ch).Predict(request(make_arrays(3)), timeout=WAIT)
        assert codec.to_ndarray(resp.outputs["prediction_node"]).shape == (3,)
    finally:
        server.stop(0)
        batcher.stop()


def test_build_stack_takes_the_stream_chunk(pair):
    cfg = ServerConfig(num_fields=F, buckets=(16, 64), max_wait_us=0)
    impl, batcher, _ = build_stack(cfg, ModelConfig(**KW), "cpu",
                                   batching_config=BatchingConfig(stream_chunk_candidates=24))
    try:
        assert impl.stream_chunk_candidates == 24
        chunks = list(impl.predict_stream(request(make_arrays(60, seed=2))))
        assert sorted(c.count for c in chunks) == [12, 24, 24]
    finally:
        batcher.stop()


def test_cli_serves_uds_and_stream_chunk(tmp_path):
    """The CLI's --uds-path and --stream-chunk: PredictStream over the
    socket answers in chunks of the flag's size."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cfg = tmp_path / "tiny.toml"
    cfg.write_text(
        "[server]\nmodel_kind = \"dcn_v2\"\nnum_fields = 8\nbuckets = [8, 32]\n"
        "max_wait_us = 0\n[model]\nnum_fields = 8\nvocab_size = 4096\nembed_dim = 4\n"
        "mlp_dims = [16]\nnum_cross_layers = 1\ncompute_dtype = \"float32\"\n")
    uds = str(tmp_path / "cli.sock")
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_tf_serving_tpu_torch.serving.server",
         "--config", str(cfg), "--host", "127.0.0.1", "--port", str(port), "--device", "cpu",
         "--uds-path", uds, "--stream-chunk", "8"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + 60
        while not os.path.exists(uds):
            assert proc.poll() is None and time.time() < deadline
            time.sleep(0.1)
        with grpc.insecure_channel(f"unix:{uds}") as ch:
            grpc.channel_ready_future(ch).result(timeout=60)
            stub = PredictionServiceStub(ch)
            while True:
                try:
                    chunks = list(stub.PredictStream(request(make_arrays(20)), timeout=WAIT))
                    break
                except grpc.RpcError:
                    assert time.time() < deadline
                    time.sleep(0.2)
        assert sorted(c.count for c in chunks) == [4, 8, 8]
        proc.terminate()
        out, _ = proc.communicate(timeout=30)
        assert proc.returncode == 0, out
        assert f"also serving on unix:{uds}" in out and "PredictStream chunk 8" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)


def test_concurrent_streams_each_cover_their_request(served):
    """Four client threads streaming at once: every stream covers its own
    request exactly once."""
    errors = []

    def client(k):
        try:
            arrays = make_arrays(70, seed=100 + k)
            with grpc.insecure_channel(served["tcp"]) as ch:
                stub = PredictionServiceStub(ch)
                for _ in range(3):
                    unary = codec.to_ndarray(stub.Predict(
                        request(arrays), timeout=WAIT).outputs["prediction_node"])
                    chunks = list(stub.PredictStream(request(arrays), timeout=WAIT))
                    assert np.array_equal(drain(chunks, 70), unary)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
