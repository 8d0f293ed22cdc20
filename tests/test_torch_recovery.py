"""The device-failure recovery plane (serving/recovery.py) held against the
JAX package's, on the CPU at small widths:

- the state machine: the JAX test's fake clock and fake batcher script
  (tests/test_recovery.py) drives both controllers through its scenarios,
  which must agree on the events (state, trigger, round, units), every
  counter of snapshot(), the MTTR ring and each item's outcome;
- through the real batchers, with the same `device_lost` rules: a
  keyless count=1 kill replays with zero failures and scores within 1e-5
  (f32) of the JAX stack's; a keyed rule convicts the same single request
  (PoisonedInputError, INVALID_ARGUMENT) while its batchmates answer;
- the quarantine gate and the health flip, the lifecycle pause / resume,
  thread death revived and replayed, drain during a cycle, the disabled
  plane, config parsing, /recoveryz, /monitoring and the series, the
  integrity escalation (trigger output_corrupt);
- the GPU-only design, on a fake probe (no JAX counterpart: the JAX REINIT
  rebuilds its executables in process): a dead CUDA context convicts no
  one — the captured requests end UNAVAILABLE, poisoned_requests stays 0,
  the controller holds QUARANTINED and the drain still returns — and
  device_fatal on the texts the launch wrapper and torch produce.
"""

import asyncio
import dataclasses
import os
import sys
import time
from concurrent.futures import Future

import jax
import numpy as np
import pytest

from distributed_tf_serving_tpu import faults as jax_faults
from distributed_tf_serving_tpu.models import ModelConfig as JaxConfig
from distributed_tf_serving_tpu.models import Servable as JaxServable
from distributed_tf_serving_tpu.models import ServableRegistry as JaxRegistry
from distributed_tf_serving_tpu.models import build_model as jax_build
from distributed_tf_serving_tpu.models import ctr_signatures as jax_signatures
from distributed_tf_serving_tpu.serving import batcher as jax_batcher
from distributed_tf_serving_tpu.serving import recovery as jax_recovery
from distributed_tf_serving_tpu.utils import config as jax_config
from distributed_tf_serving_tpu_torch import faults
from distributed_tf_serving_tpu_torch.convert import params_from_jax
from distributed_tf_serving_tpu_torch.models import (
    ModelConfig,
    Servable,
    ServableRegistry,
    build_model,
    ctr_signatures,
)
from distributed_tf_serving_tpu_torch.proto import health as health_proto
from distributed_tf_serving_tpu_torch.proto import serving_apis_pb2 as apis
from distributed_tf_serving_tpu_torch.serving import batcher as torch_batcher
from distributed_tf_serving_tpu_torch.serving import recovery
from distributed_tf_serving_tpu_torch.serving.batcher import (
    DeviceQuarantinedError,
    DeviceWedgedError,
    DynamicBatcher,
    PoisonedInputError,
    poison_fault_key,
    prepare_inputs,
)
from distributed_tf_serving_tpu_torch.serving.service import PredictionServiceImpl, ServiceError
from distributed_tf_serving_tpu_torch.utils.config import RecoveryConfig, load_config

F = 8
KW = dict(num_fields=F, vocab_size=1009, embed_dim=4, mlp_dims=(16,), num_cross_layers=1,
          compute_dtype="float32")
WAIT = 60  # seconds: bound on every wait in this file
SCORE_TOL = 1e-5  # f32 scores, the port against the JAX stack


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset(seed=0)
    jax_faults.reset(seed=0)
    yield
    faults.reset(seed=0)
    jax_faults.reset(seed=0)


@pytest.fixture(scope="module")
def servables():
    jm = jax_build("dcn_v2", JaxConfig(name="DCN", **KW))
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    jsv = JaxServable(name="DCN", version=1, model=jm, params=jp, signatures=jax_signatures(F))
    tsv = Servable(name="DCN", version=1, model=build_model("dcn_v2", ModelConfig(name="DCN", **KW)),
                   params=params_from_jax(jp, "cpu"), signatures=ctr_signatures(F))
    return jsv, tsv


def make_arrays(n, seed=0):
    rng = np.random.RandomState(seed)
    return {"feat_ids": rng.randint(0, 1 << 40, size=(n, F)).astype(np.int64),
            "feat_wts": rng.rand(n, F).astype(np.float32)}


def _wait_idle(rec, timeout=10.0):
    end = time.perf_counter() + timeout
    while rec.cycle_active() and time.perf_counter() < end:
        time.sleep(0.01)
    assert not rec.cycle_active(), rec.snapshot()


# ---------------------------------------------------- the state machine
# The JAX test's FakeClock and FakeBatcher (tests/test_recovery.py), one
# copy driving both controllers.


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.01
        return self.t


class FakeBatcher:
    def __init__(self):
        self.recovery = None
        self.requeued: list[list] = []
        self.replaced = 0
        self.revived = 0
        self.wedge = 0.0
        self.queued: list = []
        self.inflight: list[list] = []
        self.on_requeue = None

    def wedge_age(self):
        return self.wedge

    def capture_for_recovery(self):
        q, f = self.queued, self.inflight
        self.queued, self.inflight = [], []
        return q, f

    def requeue_for_replay(self, items):
        self.requeued.append(list(items))
        if self.on_requeue is not None:
            self.on_requeue(list(items))
        else:
            for it in items:
                if not it.future.done():
                    it.future.set_result({"replayed": True})

    def replace_workers_for_recovery(self):
        self.replaced += 1

    def revive_batching_thread(self):
        self.revived += 1
        return False


SIDES = {
    "jax": dict(ctl=jax_recovery.RecoveryController, cfg=jax_config.RecoveryConfig,
                item=jax_batcher._WorkItem, fault=jax_faults.InjectedFaultError,
                wedged=jax_batcher.DeviceWedgedError),
    "torch": dict(ctl=recovery.RecoveryController, cfg=RecoveryConfig,
                  item=torch_batcher._WorkItem, fault=faults.InjectedFaultError,
                  wedged=DeviceWedgedError),
}


class Side:
    """One package's controller over a FakeBatcher under a FakeClock."""

    def __init__(self, name, **cfg_kw):
        s = SIDES[name]
        self.s = s
        kw = dict(enabled=True, reinit_warmup=False, replay_drain_s=2.0)
        kw.update(cfg_kw)
        self.fb = FakeBatcher()
        self.rec = s["ctl"](s["cfg"](**kw), self.fb, clock=FakeClock())
        self.rec.auto_cycle = False
        self.dev_lost = s["fault"]("device_lost", "UNAVAILABLE")

    def item(self, n=1):
        return self.s["item"](servable=object(), arrays={"x": np.zeros((n, 1), np.float32)},
                              n=n, future=Future(), enqueue_t=0.0, output_keys=None)


def _outcome(it):
    if not it.future.done():
        return "pending"
    exc = it.future.exception()
    if exc is None:
        return "replayed" if it.future.result() == {"replayed": True} else "result"
    name = type(exc).__name__
    return f"{name}:bisection" if "bisection" in str(exc) else name


def _record(side, items):
    snap = side.rec.snapshot()
    return {
        "state": snap["state"],
        "events": [(e["state"], e.get("trigger"), e.get("round"), e.get("units"))
                   for e in snap["events"]],
        "counters": snap["counters"],
        "last_cycle": snap["last_cycle"],
        "mttr": {k: v for k, v in snap["mttr"].items() if k != "history"},
        "history": [(h["trigger"], h["rounds"], h["replayed_items"])
                    for h in snap["mttr"]["history"]],
        "outcomes": [_outcome(it) for it in items],
        "kills": [(it.device_kills, it.replays) for it in items],
        "fake": (side.fb.replaced, side.fb.revived, [len(u) for u in side.fb.requeued]),
    }


def sc_cycle(side):
    items = [side.item() for _ in range(3)]
    assert side.rec.take_group(list(items), side.dev_lost) is True
    assert side.rec.cycle_active()
    assert side.rec.run_cycle("device_fatal") is True
    return items


def sc_non_device_error(side):
    it = side.item()
    assert side.rec.take_group([it], ValueError("client junk")) is False
    return [it]


def sc_wedge(side):
    side.fb.wedge = 1.0
    assert side.rec.check() == "serving"
    stranded = [side.item(), side.item()]
    queued = [side.item()]
    side.fb.inflight = [list(stranded)]
    side.fb.queued = list(queued)
    side.fb.wedge = 9.0
    side.rec.check()
    return stranded + queued


def sc_budget(side):
    it = side.item()
    it.replays = 1
    side.rec.take_group([it], side.dev_lost)
    return [it]


def sc_bisection(side):
    items = [side.item() for _ in range(4)]
    poison = items[2]

    def on_requeue(unit):
        if poison in unit:
            side.rec.take_group(unit, side.dev_lost)
        else:
            for it in unit:
                if not it.future.done():
                    it.future.set_result({"replayed": True})

    side.fb.on_requeue = on_requeue
    side.rec.take_group(list(items), side.dev_lost)
    side.rec.run_cycle("device_fatal")
    return items


def sc_wedge_never_convicts(side):
    it = side.item()
    it.device_kills = 5
    it.replays = 1
    side.rec._absorb([it], None)
    return [it]


def sc_internal_not_fatal(side):
    class XlaRuntimeError(RuntimeError):
        pass

    it = side.item()
    assert side.rec.take_group([it], XlaRuntimeError("INTERNAL: custom call failed")) is False
    assert side.rec.take_group([it], XlaRuntimeError("DEVICE_LOST: chip went away")) is True
    side.rec.run_cycle("device_fatal")
    return [it]


def sc_warmup_fails(side):
    warm, live = side.item(), side.item()
    warm.warmup = True
    side.rec.take_group([warm, live], side.dev_lost)
    side.rec.run_cycle("device_fatal")
    return [warm, live]


def sc_mttr_ring(side):
    items = []
    for k in range(3):
        group = [side.item() for _ in range(k + 1)]
        items += group
        assert side.rec.take_group(list(group), side.dev_lost)
        assert side.rec.run_cycle("device_fatal")
    return items


def sc_mttr_bounded(side):
    items = []
    for _ in range(12):
        items.append(side.item())
        side.rec.take_group([items[-1]], side.dev_lost)
        side.rec.run_cycle("device_fatal")
    return items


SCENARIOS = {
    "cycle": (sc_cycle, {}),
    "non_device_error": (sc_non_device_error, {}),
    "wedge": (sc_wedge, dict(wedge_quarantine_s=5.0)),
    "replay_budget": (sc_budget, dict(replay_budget=1, poison_kills=99, bisect_after_kills=99)),
    "bisection": (sc_bisection, {}),
    "wedge_never_convicts": (sc_wedge_never_convicts, dict(replay_budget=1)),
    "internal_not_fatal": (sc_internal_not_fatal, {}),
    "warmup_fails": (sc_warmup_fails, {}),
    "mttr_ring": (sc_mttr_ring, {}),
    "mttr_bounded": (sc_mttr_bounded, dict(history_events=8)),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_state_machine_agrees_with_the_jax_controller(name):
    fn, cfg_kw = SCENARIOS[name]
    got = {}
    for side_name in ("jax", "torch"):
        side = Side(side_name, **cfg_kw)
        got[side_name] = _record(side, fn(side))
    assert got["torch"] == got["jax"]


def test_scripted_outcomes_are_the_jax_test_s():
    """The JAX test's own assertions, on the port's controller."""
    side = Side("torch")
    items = sc_bisection(side)
    assert _outcome(items[2]) == "PoisonedInputError:bisection"
    assert all(_outcome(it) == "replayed" for i, it in enumerate(items) if i != 2)
    assert side.rec.bisections >= 1 and side.rec.poisoned_requests == 1
    assert len({it.bisect_key for it in items if it.bisect_key is not None}) >= 2
    side = Side("torch", wedge_quarantine_s=5.0)
    items = sc_wedge(side)
    assert side.rec.watchdog_wedge_trips == 1 and side.fb.replaced == 1
    assert [it.device_kills for it in items] == [1, 1, 0]
    side = Side("torch", history_events=8)
    sc_mttr_bounded(side)
    snap = side.rec.snapshot()
    assert snap["mttr"]["cycles"] == 8 and snap["counters"]["cycles_completed"] == 12
    assert side.rec._mttr_ring.maxlen == side.rec._events.maxlen


# ------------------------------------------------ through the real batchers


def _jax_stack(jsv, registry=None, **kw):
    b = jax_batcher.DynamicBatcher(**{"buckets": (32, 64), "max_wait_us": 0, **kw}).start()
    rec = jax_recovery.RecoveryController(
        jax_config.RecoveryConfig(enabled=True, reinit_warmup=False, replay_drain_s=10.0), b,
        registry=registry)
    return b, rec


def _torch_stack(tsv, registry=None, probe=None, **kw):
    b = DynamicBatcher(**{"buckets": (32, 64), "max_wait_us": 0, "device": "cpu", **kw}).start()
    rec = recovery.RecoveryController(
        RecoveryConfig(enabled=True, replay_drain_s=10.0, reinit_warmup=registry is not None),
        b, registry=registry, probe=probe)
    return b, rec


def test_a_transient_device_lost_replays_with_zero_failures_like_jax(servables):
    jsv, tsv = servables
    arrays = make_arrays(9, seed=1)
    jb, jrec = _jax_stack(jsv)
    reg = ServableRegistry()
    reg.load(tsv)
    tb, trec = _torch_stack(tsv, registry=reg)
    try:
        jax_faults.get().add("device_lost", "error", code="UNAVAILABLE", count=1)
        faults.get().add("device_lost", "error", code="UNAVAILABLE", count=1)
        want = np.asarray(jb.submit(jsv, arrays).result(WAIT)["prediction_node"])
        got = tb.submit(tsv, arrays).result(WAIT)["prediction_node"]
        np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_TOL)
        _wait_idle(jrec)
        _wait_idle(trec)
        js, ts = jrec.snapshot(), trec.snapshot()
        for k in ("quarantines", "replayed_items", "device_failures", "poisoned_requests",
                  "bisections", "cycles_completed"):
            assert ts["counters"][k] == js["counters"][k], k
        assert ts["counters"]["replayed_items"] == 1 and ts["state"] == "serving"
        assert ts["last_cycle"]["trigger"] == "device_fatal"
        # The re-warm went through the queue: every bucket once more.
        assert tb.stats.batches >= 2
    finally:
        jrec.stop()
        trec.stop()
        jb.stop()
        tb.stop()


def test_a_keyed_device_lost_convicts_the_same_request_in_both_stacks(servables):
    """Three coalesced requests, the middle one's content keyed: both stacks
    fail exactly it with PoisonedInputError ("bisection" in the message)
    while its batchmates answer the same scores."""
    jsv, tsv = servables
    payloads = [make_arrays(5, seed=s) for s in (10, 11, 12)]
    jkey = jax_batcher.poison_fault_key(
        jax_batcher.prepare_inputs(jsv.model, payloads[1], fold_ids=False))
    tkey = poison_fault_key(prepare_inputs(payloads[1]))
    assert tkey == jkey
    jb, jrec = _jax_stack(jsv, max_wait_us=100_000)
    tb, trec = _torch_stack(tsv, max_wait_us=100_000)
    try:
        jax_faults.get().add("device_lost", "error", code="DATA_LOSS", key=jkey)
        faults.get().add("device_lost", "error", code="DATA_LOSS", key=tkey)
        outcomes = {}
        for side, b, sv in (("jax", jb, jsv), ("torch", tb, tsv)):
            futs = [b.submit(sv, p) for p in payloads]
            res = []
            for f in futs:
                try:
                    res.append(np.asarray(f.result(WAIT)["prediction_node"]))
                except Exception as exc:  # noqa: BLE001 — the outcome under test
                    res.append(exc)
            outcomes[side] = res
        for side in ("jax", "torch"):
            assert isinstance(outcomes[side][1], (PoisonedInputError,
                                                  jax_batcher.PoisonedInputError))
            assert "bisection" in str(outcomes[side][1])
        for i in (0, 2):
            np.testing.assert_allclose(outcomes["torch"][i], outcomes["jax"][i], rtol=0,
                                       atol=SCORE_TOL)
        mapped = PredictionServiceImpl._translate_batcher_error(outcomes["torch"][1], None)
        assert mapped.code == "INVALID_ARGUMENT"
        _wait_idle(jrec)
        _wait_idle(trec)
        js, ts = jrec.snapshot()["counters"], trec.snapshot()["counters"]
        assert ts["poisoned_requests"] == js["poisoned_requests"] == 1
        assert ts["bisections"] >= 1 and js["bisections"] >= 1
    finally:
        jrec.stop()
        trec.stop()
        jb.stop()
        tb.stop()


def test_a_shadow_mismatch_replays_through_an_output_corrupt_cycle(servables):
    """A readback_bitflip keyed to one payload under shadow_fraction 1.0:
    the shadow compare's OutputCorruptError reaches take_group (trigger
    output_corrupt) in both stacks, and the request is answered by the
    replay with the scores of the JAX stack."""
    from distributed_tf_serving_tpu.serving import integrity as jax_integrity
    from distributed_tf_serving_tpu_torch.utils.config import IntegrityConfig

    jsv, tsv = servables
    arrays = make_arrays(9, seed=50)
    jb, jrec = _jax_stack(jsv)
    tb, trec = _torch_stack(tsv)
    jb.integrity = jax_integrity.IntegrityPlane(
        jax_config.IntegrityConfig(enabled=True, shadow_fraction=1.0))
    tb.integrity = IntegrityConfig(enabled=True, shadow_fraction=1.0).build()
    try:
        jax_faults.get().add("readback_bitflip", "error", count=1, key=jax_batcher.poison_fault_key(
            jax_batcher.prepare_inputs(jsv.model, arrays, fold_ids=False)))
        faults.get().add("readback_bitflip", "error", count=1,
                         key=poison_fault_key(prepare_inputs(arrays)))
        want = np.asarray(jb.submit(jsv, arrays).result(WAIT)["prediction_node"])
        got = tb.submit(tsv, arrays).result(WAIT)["prediction_node"]
        np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_TOL)
        _wait_idle(jrec)
        _wait_idle(trec)
        for rec in (jrec, trec):
            snap = rec.snapshot()
            assert snap["last_cycle"]["trigger"] == "output_corrupt"
            assert snap["counters"]["replayed_items"] == 1
        assert tb.integrity.snapshot()["shadow"]["mismatches"] == 1
    finally:
        jrec.stop()
        trec.stop()
        jb.stop()
        tb.stop()


def test_a_screen_trip_burst_starts_an_output_corrupt_cycle(servables):
    """score_nan on two payloads past screen_trips_per_window = 2: the
    tripped requests fail alone (IntegrityScreenError) and the escalation
    starts a cycle with the trigger output_corrupt, in both stacks."""
    from distributed_tf_serving_tpu.serving import integrity as jax_integrity
    from distributed_tf_serving_tpu_torch.serving.integrity import IntegrityScreenError
    from distributed_tf_serving_tpu_torch.utils.config import IntegrityConfig

    jsv, tsv = servables
    payloads = [make_arrays(4, seed=60 + i) for i in range(2)]
    jb, jrec = _jax_stack(jsv)
    tb, trec = _torch_stack(tsv)
    knobs = dict(enabled=True, screen_trips_per_window=2, screen_window_s=60.0)
    jb.integrity = jax_integrity.IntegrityPlane(jax_config.IntegrityConfig(**knobs))
    tb.integrity = IntegrityConfig(**knobs).build()
    try:
        for p in payloads:
            jax_faults.get().add("score_nan", "error", key=jax_batcher.poison_fault_key(
                jax_batcher.prepare_inputs(jsv.model, p, fold_ids=False)))
            faults.get().add("score_nan", "error", key=poison_fault_key(prepare_inputs(p)))
        for b, sv in ((jb, jsv), (tb, tsv)):
            for p in payloads:
                fut = b.submit(sv, p)
                with pytest.raises(Exception) as ei:
                    fut.result(WAIT)
                assert "readback screen" in str(ei.value)
        assert isinstance(fut.exception(), IntegrityScreenError)
        for rec in (jrec, trec):
            end = time.perf_counter() + 10
            while rec.snapshot()["counters"]["cycles_completed"] < 1 and time.perf_counter() < end:
                time.sleep(0.01)
            snap = rec.snapshot()
            assert snap["last_cycle"]["trigger"] == "output_corrupt", snap
            assert snap["counters"]["replayed_items"] == 0
        assert tb.integrity.snapshot()["escalations"] == jb.integrity.snapshot()["escalations"] == 1
    finally:
        jrec.stop()
        trec.stop()
        jb.stop()
        tb.stop()


def test_the_quarantine_gate_and_the_health_flip_match_jax(servables):
    from distributed_tf_serving_tpu.serving.server import GrpcHealthService as JaxHealth
    from distributed_tf_serving_tpu.serving.service import PredictionServiceImpl as JaxImpl
    from distributed_tf_serving_tpu_torch.serving.server import GrpcHealthService

    jsv, tsv = servables
    jreg, treg = JaxRegistry(), ServableRegistry()
    jreg.load(jsv)
    treg.load(tsv)
    jb, jrec = _jax_stack(jsv, registry=jreg, buckets=(32,))
    tb, trec = _torch_stack(tsv, registry=treg, buckets=(32,))
    jrec.auto_cycle = trec.auto_cycle = False
    jimpl, timpl = JaxImpl(jreg, jb), PredictionServiceImpl(treg, tb)
    jimpl.recovery, timpl.recovery = jrec, trec
    jh, th = JaxHealth(jimpl), GrpcHealthService(timpl)
    try:
        seen = []
        for state in ("serving", "quarantined", "reinit", "replay", "serving"):
            jrec._enter(state, trigger="test")
            trec._enter(state, trigger="test")
            row = (th._status(""), th._reason("") if th._status("") != health_proto.SERVING
                   else "", trec.refusing())
            assert row == (jh._status(""), jh._reason("") if jh._status("") !=
                           health_proto.SERVING else "", jrec.refusing())
            seen.append(row)
            if state in ("quarantined", "reinit"):
                with pytest.raises(DeviceQuarantinedError):
                    tb.submit(tsv, make_arrays(4))
                with pytest.raises(jax_batcher.DeviceQuarantinedError):
                    jb.submit(jsv, make_arrays(4))
                # Warmup is exempt: REINIT re-warms through this queue.
                tb.submit(tsv, tb.warmup_arrays(tsv, 32), _warmup=True).result(WAIT)
            else:
                tb.submit(tsv, make_arrays(4)).result(WAIT)
        assert seen[1] == (health_proto.NOT_SERVING, "quarantined", True)
        assert seen[3] == (health_proto.NOT_SERVING, "quarantined", False)
        assert seen[4] == (health_proto.SERVING, "", False)
        mapped = PredictionServiceImpl._translate_batcher_error(
            DeviceQuarantinedError("replica quarantined"), None)
        assert mapped.code == "UNAVAILABLE"
    finally:
        jb.stop()
        tb.stop()


def test_a_cycle_pauses_and_resumes_the_lifecycle_controller_like_jax():
    from distributed_tf_serving_tpu.serving import lifecycle as jax_lifecycle
    from distributed_tf_serving_tpu_torch.serving import lifecycle as lifecycle_mod
    from distributed_tf_serving_tpu_torch.serving.lifecycle import LifecycleController
    from distributed_tf_serving_tpu_torch.utils.config import LifecycleConfig

    calls = {}
    try:
        for name, lc_cls, lc_cfg, reg in (
            ("jax", jax_lifecycle.LifecycleController, jax_config.LifecycleConfig, JaxRegistry()),
            ("torch", LifecycleController, LifecycleConfig, ServableRegistry()),
        ):
            lc = lc_cls(lc_cfg(enabled=True), registry=reg, model_name="DCN")
            side = Side(name)
            side.rec.lifecycle = lc
            seq = []
            orig_pause, orig_resume, orig_tick = lc.pause, lc.resume, lc.tick

            def pause(seq=seq, orig=orig_pause, lc=lc):
                seq.append("pause")
                orig()
                before = lc.ticks
                lc.tick()  # no advance while paused
                seq.append(("ticked", lc.ticks - before))

            lc.pause = pause
            lc.resume = lambda seq=seq, orig=orig_resume: (seq.append("resume"), orig())
            side.rec.take_group([side.item()], side.dev_lost)
            side.rec.run_cycle("device_fatal")
            seq.append(("paused_after", lc.paused))
            calls[name] = seq
            del orig_tick
    finally:
        lifecycle_mod.deactivate()
        jax_lifecycle.deactivate()
    assert calls["torch"] == calls["jax"] == ["pause", ("ticked", 0), "resume",
                                              ("paused_after", False)]


def _flaky_take(cls):
    state = {"killed": False}
    orig = cls._take

    def flaky(self):
        if not state["killed"]:
            state["killed"] = True
            raise RuntimeError("one-shot loop bug")
        return orig(self)

    return flaky


def test_a_dead_batching_thread_is_revived_and_serves_like_jax(servables):
    import types

    jsv, tsv = servables
    arrays = make_arrays(6, seed=4)
    outs = {}
    for side, b_cls, rec_cls, cfg_cls, sv in (
        ("jax", jax_batcher.DynamicBatcher, jax_recovery.RecoveryController,
         jax_config.RecoveryConfig, jsv),
        ("torch", DynamicBatcher, recovery.RecoveryController, RecoveryConfig, tsv),
    ):
        kw = {"device": "cpu"} if side == "torch" else {}
        b = b_cls(buckets=(32,), max_wait_us=0, **kw)
        b._take = types.MethodType(_flaky_take(b_cls), b)
        rec = rec_cls(cfg_cls(enabled=True, reinit_warmup=False), b)
        b.start()
        try:
            end = time.perf_counter() + 10
            while rec.cycles_completed < 1 and time.perf_counter() < end:
                time.sleep(0.02)
            outs[side] = (rec.thread_deaths, rec.cycles_completed >= 1,
                          np.asarray(b.submit(sv, arrays).result(WAIT)["prediction_node"]))
        finally:
            rec.stop()
            b.stop()
    assert outs["torch"][:2] == outs["jax"][:2] == (1, True)
    np.testing.assert_allclose(outs["torch"][2], outs["jax"][2], rtol=0, atol=SCORE_TOL)


def test_a_dispatch_thread_death_replays_the_batch_it_held(servables):
    """The port's dispatch thread is a thread of its own (the JAX package's
    is a pool): an exception escaping its stage hands the batch it ran back
    to the queue, the cycle revives the thread under a new generation and
    the request answers."""
    _, tsv = servables
    b, rec = _torch_stack(tsv)
    orig = b._run_stage
    state = {"killed": False}

    class _Escape(BaseException):
        pass

    def run_stage(st):
        if not state["killed"]:
            state["killed"] = True
            raise _Escape("dispatch bug")
        return orig(st)

    b._run_stage = run_stage
    try:
        arrays = make_arrays(5, seed=8)
        got = b.submit(tsv, arrays).result(WAIT)["prediction_node"]
        np.testing.assert_allclose(got, b._execute(tsv, arrays, None)["prediction_node"][:5],
                                   rtol=0, atol=SCORE_TOL)
        _wait_idle(rec)
        snap = rec.snapshot()
        assert snap["counters"]["thread_deaths"] == 1
        assert snap["last_cycle"]["trigger"] == "thread_death"
        assert b._dispatch_gen >= 1 and b._dispatch_thread.is_alive() and b._dead is None
        assert b.submit(tsv, arrays).result(WAIT)["prediction_node"].shape == (5,)
    finally:
        rec.stop()
        b.stop()


def test_drain_observes_a_cycle_and_shutdown_aborts_it_like_jax(servables):
    jsv, tsv = servables
    for side, b, rec in (("jax", *_jax_stack(jsv, buckets=(32,))),
                         ("torch", *_torch_stack(tsv, buckets=(32,)))):
        rec.auto_cycle = False
        it = Side(side).item()
        try:
            assert rec.take_group([it], Side(side).dev_lost) is True
            assert rec.cycle_active()
            t0 = time.perf_counter()
            assert b.drain(0.3) is False
            assert time.perf_counter() - t0 < 2.0
            rec.shutdown_for_drain(1.0)
            with pytest.raises(SIDES[side]["wedged"], match="draining"):
                it.future.result(timeout=0)
            assert b.drain(2.0) is True
            assert rec.state() == "serving"
        finally:
            b.stop()


def test_the_disabled_plane_is_inert_like_jax(servables):
    jsv, tsv = servables
    jb = jax_batcher.DynamicBatcher(buckets=(32,), max_wait_us=0).start()
    tb = DynamicBatcher(buckets=(32,), max_wait_us=0, device="cpu").start()
    try:
        assert tb.recovery is None
        jax_faults.get().add("device_lost", "error", code="UNAVAILABLE", count=1)
        faults.get().add("device_lost", "error", code="UNAVAILABLE", count=1)
        with pytest.raises(jax_faults.InjectedFaultError):
            jb.submit(jsv, make_arrays(4)).result(WAIT)
        with pytest.raises(faults.InjectedFaultError):
            tb.submit(tsv, make_arrays(4)).result(WAIT)
        arrays = make_arrays(5, seed=2)
        np.testing.assert_allclose(tb.submit(tsv, arrays).result(WAIT)["prediction_node"],
                                   np.asarray(jb.submit(jsv, arrays).result(WAIT)
                                              ["prediction_node"]), rtol=0, atol=SCORE_TOL)
        assert tb.stats.recovery_dropped == 0
    finally:
        jb.stop()
        tb.stop()


# ------------------------------------------------------ config and surfaces


BAD = [
    dict(replay_budget=0), dict(poison_kills=True), dict(bisect_after_kills=-1),
    dict(max_cycle_rounds=1.5), dict(watchdog_interval_s=0), dict(wedge_quarantine_s=-1.0),
    dict(replay_drain_s=False), dict(rewarm_timeout_s="x"), dict(scope="rack"),
]


@pytest.mark.parametrize("kw", BAD, ids=[next(iter(k)) for k in BAD])
def test_config_checks_raise_the_jax_package_s_errors(kw):
    with pytest.raises(ValueError) as ours:
        RecoveryConfig(**kw)
    with pytest.raises(ValueError) as theirs:
        jax_config.RecoveryConfig(**kw)
    assert str(ours.value) == str(theirs.value)


def test_the_recovery_section_loads_like_jax_and_refuses_clear_backend(tmp_path):
    p = tmp_path / "c.toml"
    p.write_text("[recovery]\nenabled = true\nwedge_quarantine_s = 3.0\nreplay_budget = 4\n"
                 "poison_kills = 3\nscope = \"per_chip\"\n")
    assert dataclasses.asdict(load_config(p)["recovery"]) == dataclasses.asdict(
        jax_config.load_config(p)["recovery"])
    p.write_text("[recovery]\nnot_a_knob = 1\n")
    with pytest.raises(ValueError, match="not_a_knob"):
        load_config(p)
    with pytest.raises(ValueError, match="not_a_knob"):
        jax_config.load_config(p)
    p.write_text("[recovery]\nenabled = true\nreinit_clear_backend = true\n")
    with pytest.raises(ValueError, match="CUDA context cannot be rebuilt in-process"):
        load_config(p)
    assert jax_config.load_config(p)["recovery"].reinit_clear_backend is True


def test_recoveryz_monitoring_and_prometheus_match_jax_and_lint(servables):
    import aiohttp

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                    "tools"))
    from check_prom import lint_text
    from distributed_tf_serving_tpu.utils.metrics import _recovery_prometheus_lines
    from distributed_tf_serving_tpu_torch.serving.rest import start_rest_gateway
    from distributed_tf_serving_tpu_torch.utils.metrics import ServerMetrics

    _, tsv = servables
    reg = ServableRegistry()
    reg.load(tsv)
    b, rec = _torch_stack(tsv, registry=reg, buckets=(32,))
    rec.auto_cycle = False
    impl = PredictionServiceImpl(reg, b)
    impl.recovery = rec
    it = Side("torch").item()
    rec.take_group([it], Side("torch").dev_lost)
    rec.run_cycle("device_fatal")
    jside = Side("jax")
    jside.rec.take_group([jside.item()], jside.dev_lost)
    jside.rec.run_cycle("device_fatal")

    async def go():
        runner, port = await start_rest_gateway(impl, port=0, metrics=ServerMetrics())
        try:
            async with aiohttp.ClientSession(f"http://127.0.0.1:{port}") as s:
                async with s.get("/recoveryz") as r:
                    body = await r.json()
                    assert r.status == 200 and body["enabled"] is True
                    assert body["state"] == "serving"
                    assert body["counters"]["quarantines"] == 1
                async with s.get("/monitoring?section=recovery") as r:
                    sec = await r.json()
                    assert set(sec) == {"recovery"}
                    assert sec["recovery"]["mttr"]["cycles"] == 1
                async with s.get("/monitoring") as r:
                    assert "recovery" in await r.json()
                async with s.get("/monitoring/prometheus/metrics") as r:
                    text = await r.text()
                impl.recovery = None
                async with s.get("/recoveryz") as r:
                    off = await r.json()
                async with s.get("/monitoring") as r:
                    off_mon = await r.json()
                return text, off, off_mon
        finally:
            await runner.cleanup()

    try:
        text, off, off_mon = asyncio.run(go())
    finally:
        b.stop()
    assert lint_text(text) == []
    ours = [ln for ln in text.splitlines() if "dts_tpu_recovery_" in ln]
    assert 'dts_tpu_recovery_state{state="serving"} 1' in ours
    assert "dts_tpu_recovery_quarantines_total 1" in ours
    # The same families, HELP text and values (the durations aside) as the
    # JAX package's lines for the same scripted cycle.
    from distributed_tf_serving_tpu_torch.utils.metrics import _recovery_prometheus_lines as ours_fn

    def norm(lines):
        return [ln for ln in lines if not ln.startswith(("dts_tpu_recovery_last_cycle_seconds ",
                                                         "dts_tpu_recovery_mttr_mean_seconds "))]

    jsnap = jside.rec.snapshot()
    assert norm(ours_fn(jsnap)) == norm(_recovery_prometheus_lines(jsnap))
    assert norm(ours) == norm(ours_fn(rec.snapshot()))
    assert off == {"enabled": False} and "recovery" not in off_mon


def test_build_stack_attaches_the_controller_and_the_cli_takes_the_flag():
    from distributed_tf_serving_tpu_torch.serving.server import build_stack, serve
    from distributed_tf_serving_tpu_torch.utils.config import ServerConfig

    cfg = ServerConfig(model_kind="dcn", buckets=(16,), warmup=False)
    mc = ModelConfig(name="DCN", **KW)
    impl, b, _ = build_stack(cfg, mc, "cpu", recovery_config=RecoveryConfig())
    try:
        assert impl.recovery is None and b.recovery is None and impl.recovery_stats() is None
    finally:
        b.stop()
    impl, b, _ = build_stack(cfg, mc, "cpu", recovery_config=RecoveryConfig(enabled=True))
    try:
        assert impl.recovery is not None and b.recovery is impl.recovery
        assert impl.recovery._worker is None  # serve() starts the watchdog
        assert impl.recovery_stats()["enabled"] is True
    finally:
        impl.recovery.stop()
        b.stop()
    with pytest.raises(SystemExit):
        serve(["--recovery", "--help"])


# ----------------------------- the GPU-only design, on a fake probe
# No JAX counterpart: the JAX REINIT rebuilds its executables in process,
# where a CUDA context after a sticky error cannot be rebuilt.

STICKY = ["an illegal memory access was encountered", "unspecified launch failure",
          "device-side assert triggered", "misaligned address", "illegal instruction",
          "uncorrectable ECC error encountered"]
NOT_FATAL = ["out of memory", "too many resources requested for launch", "invalid argument"]
TORCH_TAIL = ("\nCUDA kernel errors might be asynchronously reported at some other API call, so "
              "the stacktrace below might be incorrect.\nFor debugging consider passing "
              "CUDA_LAUNCH_BLOCKING=1\nCompile with `TORCH_USE_CUDA_DSA` to enable device-side "
              "assertions.\n")


@pytest.mark.parametrize("text,fatal", [
    *[(f"fused-serve kernel launch failed: {s}", True) for s in STICKY],
    *[(f"cross-stack kernel launch failed: {s}", False) for s in NOT_FATAL],
    *[(f"CUDA error: {s}{TORCH_TAIL}", True) for s in STICKY],
    (f"CUDA error: out of memory{TORCH_TAIL}", False),
    ("CUDA out of memory. Tried to allocate 2.00 GiB", False),
    ("DEVICE_LOST: chip went away", True),
    ("INTERNAL: custom call failed", False),
])
def test_device_fatal_reads_the_launch_wrapper_s_and_torch_s_texts(text, fatal):
    assert recovery.device_fatal(RuntimeError(text)) is fatal
    if "CUDA" not in text and "kernel launch" not in text:
        # The JAX package's markers: both packages agree.
        assert jax_recovery.device_fatal(RuntimeError(text)) is fatal


def test_the_launch_wrapper_s_text_is_what_device_fatal_reads():
    """ops/cross_kernel.py _check: the string a failed launch raises."""
    from distributed_tf_serving_tpu_torch.ops import cross_kernel as ck

    class Lib:
        @staticmethod
        def dts_error_string(rc):
            return {700: b"an illegal memory access was encountered", 2: b"out of memory"}[rc]

    with pytest.raises(RuntimeError) as fatal:
        ck._check(Lib, 700, "fused-serve")
    with pytest.raises(RuntimeError) as oom:
        ck._check(Lib, 2, "fused-serve")
    assert recovery.device_fatal(fatal.value) and not recovery.device_fatal(oom.value)


def test_the_probe_answers_for_a_device_with_no_cuda_context():
    assert recovery.probe_context(None, 0.1) is None
    import torch

    assert recovery.probe_context(torch.device("cpu"), 0.1) is None


class _Probe:
    """A context that answers `alive` times, then is lost."""

    def __init__(self, alive: int):
        self.alive = alive
        self.calls = 0

    def __call__(self):
        self.calls += 1
        if self.calls <= self.alive:
            return None
        return "CUDA error: an illegal memory access was encountered"


@pytest.mark.parametrize("alive", [0, 1], ids=["dead_at_reinit", "dead_at_the_verdict"])
def test_a_dead_context_convicts_no_one_and_holds_the_quarantine(servables, alive):
    """A keyed device_lost on a solo request: with a live context it is
    convicted on its second kill. With the context lost at the first
    REINIT's probe, or found lost when the verdict's probe runs, the
    request ends UNAVAILABLE, never INVALID_ARGUMENT; poisoned_requests
    stays 0; the controller holds QUARANTINED (health NOT_SERVING,
    submits refused); and the drain still returns."""
    from distributed_tf_serving_tpu_torch.serving.server import GrpcHealthService

    _, tsv = servables
    reg = ServableRegistry()
    reg.load(tsv)
    probe = _Probe(alive)
    b, rec = _torch_stack(tsv, registry=reg, probe=probe, buckets=(32,))
    impl = PredictionServiceImpl(reg, b)
    impl.recovery = rec
    health = GrpcHealthService(impl)
    arrays = make_arrays(4, seed=21)
    faults.get().add("device_lost", "error", code="DATA_LOSS",
                     key=poison_fault_key(prepare_inputs(arrays)))
    req = apis.PredictRequest()
    req.model_spec.name = "DCN"
    from distributed_tf_serving_tpu_torch import codec

    for k, v in arrays.items():
        codec.from_ndarray(v, out=req.inputs[k])
    try:
        with pytest.raises(ServiceError) as ei:
            impl.predict(req, deadline_s=WAIT)
        assert ei.value.code == "UNAVAILABLE", ei.value
        assert "context lost" in str(ei.value)
        end = time.perf_counter() + 10
        while not (rec.snapshot()["last_cycle"] and rec.state() == "quarantined") \
                and time.perf_counter() < end:
            time.sleep(0.01)
        snap = rec.snapshot()
        assert snap["counters"]["poisoned_requests"] == 0
        assert snap["state"] == "quarantined"
        assert "illegal memory access" in snap["last_cycle"]["context_lost"]
        assert snap["last_cycle"]["gave_up_items"] == 1 and snap["mttr"]["cycles"] == 0
        assert health._status("") == health_proto.NOT_SERVING
        assert health._reason("") == "quarantined"
        with pytest.raises(ServiceError) as refused:
            impl.predict(req, deadline_s=WAIT)
        assert refused.value.code == "UNAVAILABLE" and "quarantined" in str(refused.value)
        time.sleep(0.3)
        assert rec.state() == "quarantined"  # held: the watchdog does not lift it
        rec.shutdown_for_drain(1.0)
        t0 = time.perf_counter()
        assert b.drain(2.0) is True
        assert time.perf_counter() - t0 < 2.0
    finally:
        rec.stop()
        b.stop()


def test_a_captured_stage_s_late_result_is_dropped_and_the_wedge_is_recovered(servables):
    """A batcher.dispatch wedge held past wedge_quarantine_s: the watchdog
    trips, the dispatch thread and the completion pool are replaced, the
    captured request is answered once by the replay, and when the wedge
    clears, the old thread's late result is dropped (recovery_dropped) and
    its stage leaves the counts alone."""
    _, tsv = servables
    b = DynamicBatcher(buckets=(32,), max_wait_us=0, device="cpu").start()
    rec = recovery.RecoveryController(
        RecoveryConfig(enabled=True, reinit_warmup=False, watchdog_interval_s=0.05,
                       wedge_quarantine_s=0.3, replay_drain_s=10.0), b).start()
    try:
        arrays = make_arrays(6, seed=30)
        want = b._execute(tsv, arrays, None)["prediction_node"][:6]
        faults.get().add("batcher.dispatch", "wedge", count=1)
        fut = b.submit(tsv, arrays)
        got = fut.result(WAIT)["prediction_node"]
        np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_TOL)
        _wait_idle(rec)  # the replay answers before the cycle ends
        snap = rec.snapshot()
        assert snap["counters"]["watchdog_wedge_trips"] == 1
        assert snap["last_cycle"]["trigger"] == "wedge" and b._dispatch_gen == 1
        faults.get().clear()  # the old thread's stage returns now
        end = time.perf_counter() + 10
        while b.stats.recovery_dropped < 1 and time.perf_counter() < end:
            time.sleep(0.01)
        assert b.stats.recovery_dropped == 1
        assert b.submit(tsv, arrays).result(WAIT)["prediction_node"].shape == (6,)
        assert b.drain(5.0) is True
        assert (b._dispatch_pending, b._inflight, b.wedge_age()) == (0, 0, 0.0)
        assert rec.snapshot()["counters"]["quarantines"] == 1
    finally:
        rec.stop()
        b.stop()


def test_the_ring_keeps_every_pinned_buffer_once_recovery_is_armed():
    """torch aborts the process when a pinned buffer that a copy used is
    freed after a sticky CUDA error, so with the plane armed the host ring
    frees nothing: a surplus release is kept, and a buffer whose event
    query raises goes back to the ring before the error is raised. No JAX
    counterpart (the JAX ring holds numpy buffers)."""
    b = DynamicBatcher(buckets=(32,), max_wait_us=0, device="cpu")
    ring = b.ring
    assert ring.keep is False
    bufs = [ring.acquire(64) for _ in range(ring.per_size + 2)]
    ring.release(bufs)
    assert ring.snapshot()["free_buffers"] == ring.per_size  # the surplus dropped
    recovery.RecoveryController(RecoveryConfig(enabled=True), b)
    assert ring.keep is True
    more = [ring.acquire(64) for _ in range(ring.per_size + 2)]
    ring.release(more)
    assert ring.snapshot()["free_buffers"] == ring.per_size + 2  # nothing dropped

    class DeadEvent:
        def query(self):
            raise RuntimeError("CUDA error: an illegal memory access was encountered")

    dead = ring.acquire(128)
    ring.release([dead], DeadEvent())
    with pytest.raises(RuntimeError, match="illegal memory access"):
        ring.acquire(128)
    assert any(buf is dead for buf, _ in ring._free[128])  # kept, not freed


def _request(arrays):
    from distributed_tf_serving_tpu_torch import codec

    req = apis.PredictRequest()
    req.model_spec.name = "DCN"
    for k, v in arrays.items():
        codec.from_ndarray(v, out=req.inputs[k])
    req.output_filter.append("prediction_node")
    return req


def test_a_killed_stream_sub_batch_replays_bit_identically_like_jax(servables):
    """A keyless device_lost count=1 under a chunked PredictStream (the
    JAX test's case): the killed solo sub-batch replays, the merged stream
    is bit-identical to the unary answer of the same impl, and within 1e-5
    of the JAX stack's stream."""
    from distributed_tf_serving_tpu import codec as jax_codec
    from distributed_tf_serving_tpu.client import StreamingMerger, build_predict_request
    from distributed_tf_serving_tpu.serving.service import PredictionServiceImpl as JaxImpl
    from distributed_tf_serving_tpu_torch import codec

    jsv, tsv = servables
    jreg, treg = JaxRegistry(), ServableRegistry()
    jreg.load(jsv)
    treg.load(tsv)
    jb, jrec = _jax_stack(jsv, registry=jreg)
    tb, trec = _torch_stack(tsv, registry=treg)
    jimpl, timpl = JaxImpl(jreg, jb), PredictionServiceImpl(treg, tb)
    jimpl.recovery, timpl.recovery = jrec, trec
    arrays = make_arrays(24, seed=7)
    try:
        jax_faults.get().add("device_lost", "error", code="UNAVAILABLE", count=1)
        faults.get().add("device_lost", "error", code="UNAVAILABLE", count=1)
        jchunks = list(jimpl.predict_stream(
            build_predict_request(arrays, "DCN", output_filter=("prediction_node",)), chunk=8))
        merger = StreamingMerger(jchunks[0].total)
        for c in jchunks:
            merger.add(c.offset, jax_codec.to_ndarray(c.outputs["prediction_node"]))
        theirs = merger.result()
        ours = np.zeros(24, np.float32)
        for c in timpl.predict_stream(_request(arrays), chunk=8):
            ours[c.offset:c.offset + c.count] = codec.to_ndarray(c.outputs["prediction_node"])
        _wait_idle(jrec)
        _wait_idle(trec)
        unary = codec.to_ndarray(timpl.predict(_request(arrays)).outputs["prediction_node"])
        assert ours.tobytes() == unary.tobytes()
        np.testing.assert_allclose(ours, theirs, rtol=0, atol=SCORE_TOL)
        assert trec.snapshot()["counters"]["replayed_items"] >= 1
        assert jrec.snapshot()["counters"]["replayed_items"] >= 1
    finally:
        jrec.stop()
        trec.stop()
        jb.stop()
        tb.stop()


def test_a_capture_fails_the_row_cache_s_flights_and_the_replay_refills_it(servables):
    """With the row cache armed, a killed batch's rows are in flight when
    the cycle captures it: the capture fails every row flight
    (DeviceQuarantinedError to whoever joined one), the replay re-plans the
    rows, answers within 1e-5 of the JAX stack and fills the cache, so the
    repeat is a full row hit."""
    from distributed_tf_serving_tpu_torch.utils.config import CacheConfig

    jsv, tsv = servables
    arrays = make_arrays(9, seed=40)
    jb = jax_batcher.DynamicBatcher(buckets=(32, 64), max_wait_us=0).start()
    rc = CacheConfig(enabled=True, row_granular=True).build_row()
    tb, trec = _torch_stack(tsv, row_cache=rc)
    try:
        want = np.asarray(jb.submit(jsv, arrays).result(WAIT)["prediction_node"])
        faults.get().add("device_lost", "error", code="UNAVAILABLE", count=1)
        got = tb.submit(tsv, arrays).result(WAIT)["prediction_node"]
        np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_TOL)
        _wait_idle(trec)
        assert trec.snapshot()["counters"]["replayed_items"] == 1
        assert rc._flights == {}
        hits = tb.stats.row_full_hit_batches
        again = tb.submit(tsv, arrays).result(WAIT)["prediction_node"]
        assert again.tobytes() == got.tobytes() and tb.stats.row_full_hit_batches == hits + 1
    finally:
        trec.stop()
        jb.stop()
        tb.stop()


_LOST_CLI = r"""
import sys
from distributed_tf_serving_tpu_torch.serving import recovery, server

# A context that no longer answers (what a sticky CUDA error leaves).
recovery.probe_context = lambda *a: "CUDA error: an illegal memory access was encountered"
server.serve(sys.argv[1:])
"""


def test_a_cli_server_with_a_lost_context_refuses_then_drains_and_exits_0(tmp_path):
    """The CLI server with --recovery whose context probe finds the context
    lost (a fake probe: no JAX counterpart): the Predict its first batch
    carried ends UNAVAILABLE ("context lost"), health "" answers NOT_SERVING
    with the quarantined reason and /recoveryz names the lost context; on
    SIGTERM it drains and exits 0 without the interpreter's teardown."""
    import json
    import signal
    import socket
    import subprocess
    import urllib.request

    import grpc

    from distributed_tf_serving_tpu_torch.proto import PredictionServiceStub
    from distributed_tf_serving_tpu_torch.proto.health import HealthCheckRequest, HealthStub

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    cfg = tmp_path / "c.toml"
    cfg.write_text("[server]\nnum_fields = 8\nbuckets = [32]\nmax_wait_us = 0\n"
                   "[model]\nnum_fields = 8\nvocab_size = 1009\nembed_dim = 4\nmlp_dims = [16]\n"
                   "num_cross_layers = 1\n[recovery]\nwatchdog_interval_s = 0.05\n")
    port, rest_port = free_port(), free_port()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, DTS_TPU_FAULTS="device_lost=error,count=1")
    proc = subprocess.Popen(
        [sys.executable, "-c", _LOST_CLI, "--config", str(cfg), "--host", "127.0.0.1",
         "--port", str(port), "--device", "cpu", "--rest-port", str(rest_port), "--recovery"],
        cwd=repo, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
            health = HealthStub(ch)
            end = time.time() + 120
            while True:
                try:
                    if health.Check(HealthCheckRequest(service=""), timeout=2).status == \
                            health_proto.SERVING:
                        break
                except grpc.RpcError:
                    pass
                assert proc.poll() is None and time.time() < end
                time.sleep(0.1)
            with pytest.raises(grpc.RpcError) as ei:
                PredictionServiceStub(ch).Predict(_request(make_arrays(4, seed=5)), timeout=30)
            assert ei.value.code() == grpc.StatusCode.UNAVAILABLE
            assert "context lost" in ei.value.details()
            resp, call = health.Check.with_call(HealthCheckRequest(service=""), timeout=5)
            assert resp.status == health_proto.NOT_SERVING
            assert dict(call.trailing_metadata())["x-dts-health-reason"] == "quarantined"
            end = time.time() + 60
            while True:
                try:
                    with urllib.request.urlopen(f"http://127.0.0.1:{rest_port}/recoveryz",
                                                timeout=5) as r:
                        body = json.loads(r.read())
                    break
                except OSError:
                    assert proc.poll() is None and time.time() < end
                    time.sleep(0.1)
        assert body["state"] == "quarantined" and "illegal memory access" in \
            body["last_cycle"]["context_lost"]
        assert body["counters"]["poisoned_requests"] == 0
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, out
    assert "shutdown complete" in out and "without the interpreter's teardown" in out
