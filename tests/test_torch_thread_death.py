"""A batcher thread that dies fails its callers at once, in the port as in
the JAX package (serving/batcher.py BatcherThreadDead): when an exception
escapes the batching thread, the dispatch thread or a completion worker,
the batch that thread held, every queued item and every staged group fail
with BatcherThreadDead within a second, instead of at their deadlines, and
every later submit raises it up front (UNAVAILABLE at the RPC layer).
These batchers run without the recovery plane; with it, the thread is
revived and the work replayed instead (tests/test_torch_recovery.py)."""

import threading
import time
import types

import jax
import numpy as np
import pytest

from distributed_tf_serving_tpu.models import ModelConfig as JaxConfig
from distributed_tf_serving_tpu.models import Servable as JaxServable
from distributed_tf_serving_tpu.models import build_model as jax_build
from distributed_tf_serving_tpu.models import ctr_signatures as jax_signatures
from distributed_tf_serving_tpu.serving.batcher import BatcherThreadDead as JaxThreadDead
from distributed_tf_serving_tpu.serving.batcher import DynamicBatcher as JaxBatcher
from distributed_tf_serving_tpu_torch import codec
from distributed_tf_serving_tpu_torch.convert import params_from_jax
from distributed_tf_serving_tpu_torch.models import (
    ModelConfig,
    Servable,
    ServableRegistry,
    build_model,
    ctr_signatures,
)
from distributed_tf_serving_tpu_torch.proto import serving_apis_pb2 as apis
from distributed_tf_serving_tpu_torch.serving.batcher import BatcherThreadDead, DynamicBatcher
from distributed_tf_serving_tpu_torch.serving.service import PredictionServiceImpl, ServiceError

F = 6
KW = dict(num_fields=F, vocab_size=1 << 10, embed_dim=4, mlp_dims=(8,), num_cross_layers=1,
          compute_dtype="float32")
WAIT = 30  # seconds: bound on every wait of a gate in this file
FAST = 1.0  # seconds: what "at once" allows


class _Escape(BaseException):
    """An exception no stage body catches (they catch Exception): a bug
    that ends the thread it runs on."""


@pytest.fixture(scope="module")
def servables():
    jm = jax_build("dcn_v2", JaxConfig(name="DCN", **KW))
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    jsv = JaxServable(name="DCN", version=1, model=jm, params=jp, signatures=jax_signatures(F))
    tsv = Servable(name="DCN", version=1, model=build_model("dcn_v2", ModelConfig(name="DCN", **KW)),
                   params=params_from_jax(jp, "cpu"), signatures=ctr_signatures(F))
    return jsv, tsv


def _arrays(n, seed=0):
    rng = np.random.RandomState(seed)
    return {"feat_ids": rng.randint(0, 1 << 40, size=(n, F)).astype(np.int64),
            "feat_wts": rng.rand(n, F).astype(np.float32)}


def _resolve_all(futs, since: float) -> list:
    """Each future's outcome (result or exception) and the seconds from
    `since` until the last one resolved."""
    out = []
    for f in futs:
        try:
            out.append(f.result(timeout=WAIT))
        except Exception as exc:  # noqa: BLE001 — the outcome under test
            out.append(exc)
    return out, time.perf_counter() - since


def test_thread_death_fails_fast(servables):
    """The counterpart of the JAX package's test (tests/test_recovery.py
    test_thread_death_fails_fast): `_take` raises, the death is recorded and
    submit raises BatcherThreadDead at once, in both packages; in the port
    a waiter queued before the death fails with it within a second, and
    Predict answers UNAVAILABLE."""
    jsv, tsv = servables
    jb = JaxBatcher(buckets=(32,), max_wait_us=0)
    jb._take = types.MethodType(lambda self: (_ for _ in ()).throw(RuntimeError("loop bug")), jb)
    jb.start()
    deadline = time.perf_counter() + 5
    while jb._dead is None and time.perf_counter() < deadline:
        time.sleep(0.01)
    with pytest.raises(JaxThreadDead, match="batching thread died"):
        jb.submit(jsv, _arrays(4))
    jb.stop()

    gate = threading.Event()

    def take():
        gate.wait(WAIT)
        raise RuntimeError("loop bug")

    b = DynamicBatcher(buckets=(32,), max_wait_us=0, device="cpu")
    b._take = take
    b.start()
    try:
        waiter = b.submit(tsv, _arrays(4), deadline_s=WAIT)  # queued: the loop is in _take
        t0 = time.perf_counter()
        gate.set()
        (got,), took = _resolve_all([waiter], t0)
        assert isinstance(got, BatcherThreadDead) and "batching thread died" in str(got)
        assert took < FAST
        t0 = time.perf_counter()
        with pytest.raises(BatcherThreadDead, match="batching thread died: RuntimeError"):
            b.submit(tsv, _arrays(4))
        assert time.perf_counter() - t0 < FAST
        registry = ServableRegistry()
        registry.load(tsv)
        req = apis.PredictRequest()
        req.model_spec.name = "DCN"
        for k, v in _arrays(3).items():
            codec.from_ndarray(v, out=req.inputs[k])
        with pytest.raises(ServiceError) as e:
            PredictionServiceImpl(registry, b).predict(req, deadline_s=WAIT)
        assert e.value.code == "UNAVAILABLE" and "batching thread died" in str(e.value)
    finally:
        gate.set()
        b.stop()


def test_dispatch_thread_death_fails_its_batch_staged_and_queued_fast(servables):
    """An exception escaping the dispatch thread's stage: the batch it ran,
    the group staged behind it and the items still queued all fail with
    BatcherThreadDead within a second; submit raises it after."""
    _, tsv = servables
    gate, entered = threading.Event(), threading.Event()

    def run_stage(st):
        entered.set()
        gate.wait(WAIT)
        raise _Escape("dispatch bug")

    b = DynamicBatcher(buckets=(32,), max_wait_us=0, device="cpu", pipeline_depth=2)
    b._run_stage = run_stage
    b.start()
    try:
        futs = [b.submit(tsv, _arrays(4, s), deadline_s=WAIT, _solo=True) for s in range(4)]
        assert entered.wait(WAIT)
        end = time.perf_counter() + WAIT
        while not (b._staged and b._items) and time.perf_counter() < end:
            time.sleep(0.005)
        assert b._staged and b._items  # one group running, one staged, the rest queued
        t0 = time.perf_counter()
        gate.set()
        got, took = _resolve_all(futs, t0)
        assert all(isinstance(g, BatcherThreadDead) for g in got), got
        assert "dispatch thread died: _Escape" in str(got[0])
        assert took < FAST
        with pytest.raises(BatcherThreadDead, match="dispatch thread died"):
            b.submit(tsv, _arrays(4))
    finally:
        gate.set()
        b.stop()


def test_completion_worker_death_fails_its_batch_and_the_queue_fast(servables):
    """An exception escaping a completion worker: that batch, the group
    staged and the items queued behind the in-flight window fail with
    BatcherThreadDead within a second; the batch already in the device
    stage resolves too, and submit raises the death after."""
    _, tsv = servables
    gate, entered = threading.Event(), threading.Event()
    b = DynamicBatcher(buckets=(32,), max_wait_us=0, device="cpu", pipeline_depth=2,
                       inflight_window=1)
    finish = b._finish
    calls = []

    def first_finish_dies(st, rb):
        if not calls:
            calls.append(st)
            entered.set()
            gate.wait(WAIT)
            raise _Escape("completer bug")
        return finish(st, rb)

    b._finish = first_finish_dies
    b.start()
    try:
        first = b.submit(tsv, _arrays(4, 0), deadline_s=WAIT, _solo=True)
        assert entered.wait(WAIT)
        # Behind the window: one group in the device stage, one staged,
        # one queued.
        rest = [b.submit(tsv, _arrays(4, s), deadline_s=WAIT, _solo=True) for s in (1, 2, 3)]
        end = time.perf_counter() + WAIT
        while not (b._staged and b._items) and time.perf_counter() < end:
            time.sleep(0.005)
        assert b._staged and b._items
        t0 = time.perf_counter()
        gate.set()
        got, took = _resolve_all([first, *rest], t0)
        assert took < FAST
        assert isinstance(got[0], BatcherThreadDead)
        assert "completer thread died: _Escape" in str(got[0])
        # The staged and the queued group fail with it; the one the
        # dispatch thread had taken ran.
        assert isinstance(got[2], BatcherThreadDead) and isinstance(got[3], BatcherThreadDead)
        assert got[1]["prediction_node"].shape == (4,)
        with pytest.raises(BatcherThreadDead, match="completer thread died"):
            b.submit(tsv, _arrays(4))
    finally:
        gate.set()
        b.stop()
