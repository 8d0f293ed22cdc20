"""The port's continuous-freshness lifecycle plane (serving/lifecycle.py and
its wiring) against the JAX package's on the CPU.

The JAX LifecycleController needs no device, so both controllers run side
by side: the same fake clock, the same registry and watcher stubs (each
over its own package's registry) and real quality planes of each package
fed identical scores and labels. After every step of a scripted scenario
the route decisions, the whole /lifecyclez snapshot (state, versions,
fraction, counters, judgments with their PSI / JS / AUC, events) must be
equal (exact ==: the two quality planes run the same numpy operations).

Then the JAX package's lifecycle cases on the port (probe-first ramp,
exact fraction, PSI and AUC rollback, sampling noise that must not roll
back, keep_versions 1 refused, a detached stop, an externally vanished
canary, config parsing, the master switch, disabled mode inert,
/lifecyclez armed and off, explicit pins untouched, publisher counts), the
watcher's `is_blacklisted` through the real port watcher (a blacklisted
latest never arms a canary; fleet_blacklist's actions as the JAX
controller's), a rollback through a real watcher swap with real traffic,
the lane over gRPC and REST, the Prometheus lines against the JAX
exposition, and the whole loop through the CLI on the CPU: publish,
canary, promote, then a poisoned version rolled back."""

import dataclasses
import json
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import grpc
import numpy as np
import pytest
import torch

from distributed_tf_serving_tpu.models import ServableRegistry as JaxRegistry
from distributed_tf_serving_tpu.models import Servable as JaxServable
from distributed_tf_serving_tpu.serving import lifecycle as jax_lifecycle
from distributed_tf_serving_tpu.serving import quality as jax_quality
from distributed_tf_serving_tpu.serving.version_watcher import VersionWatcher as JaxWatcher
from distributed_tf_serving_tpu.serving.version_watcher import (
    VersionWatcherConfig as JaxWatcherConfig,
)
from distributed_tf_serving_tpu.utils import config as jax_config
from distributed_tf_serving_tpu.utils import metrics as jax_metrics
from distributed_tf_serving_tpu_torch import codec
from distributed_tf_serving_tpu_torch.interop.export import publish_version
from distributed_tf_serving_tpu_torch.models import (
    ModelConfig,
    Servable,
    ServableRegistry,
    build_model,
    ctr_signatures,
)
from distributed_tf_serving_tpu_torch.proto import (
    HealthCheckRequest,
    HealthStub,
    PredictionServiceStub,
)
from distributed_tf_serving_tpu_torch.proto import health as health_proto
from distributed_tf_serving_tpu_torch.proto import serving_apis_pb2 as apis
from distributed_tf_serving_tpu_torch.serving import lifecycle
from distributed_tf_serving_tpu_torch.serving import quality
from distributed_tf_serving_tpu_torch.serving.batcher import DynamicBatcher
from distributed_tf_serving_tpu_torch.serving.lifecycle import (
    CANARY,
    IDLE,
    PROMOTING,
    ROLLED_BACK,
    LifecycleController,
)
from distributed_tf_serving_tpu_torch.serving.server import (
    _servable_change_hook,
    build_stack,
    create_server,
)
from distributed_tf_serving_tpu_torch.serving.service import PredictionServiceImpl
from distributed_tf_serving_tpu_torch.serving.version_watcher import (
    VersionWatcher,
    VersionWatcherConfig,
)
from distributed_tf_serving_tpu_torch.train.checkpoint import flatten_params, save_servable
from distributed_tf_serving_tpu_torch.train.trainer import tree_map
from distributed_tf_serving_tpu_torch.utils import metrics
from distributed_tf_serving_tpu_torch.utils.config import (
    LifecycleConfig,
    QualityConfig,
    ServerConfig,
    load_config,
)

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
from check_prom import lint_text  # noqa: E402

F = 6
VOCAB = 1 << 10
CFG = ModelConfig(name="DCN", num_fields=F, vocab_size=VOCAB, embed_dim=4, mlp_dims=(8,),
                  num_cross_layers=1, compute_dtype="float32")


@pytest.fixture(autouse=True)
def _drop_active_flags():
    """A controller arms its module's criticality-scan gate; later tests
    (and files) must not inherit it."""
    yield
    lifecycle.deactivate()
    jax_lifecycle.deactivate()


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


class StubWatcher:
    """Records the controller's watcher calls; retires through the
    registry, as the real retire() does, so versions vanish."""

    base_path = "<stub>"

    def __init__(self, registry):
        self.registry = registry
        self.blacklisted: set[int] = set()
        self.pinned: set[int] = set()
        self.retired: list[int] = []

    def blacklist(self, v):
        self.blacklisted.add(int(v))

    def is_blacklisted(self, v):
        return int(v) in self.blacklisted

    def pin(self, v):
        self.pinned.add(int(v))

    def unpin(self, v):
        self.pinned.discard(int(v))

    def retire(self, v, blacklist=True):
        if blacklist:
            self.blacklist(v)
        self.retired.append(int(v))
        try:
            self.registry.unload("DCN", int(v))
        except KeyError:
            return False
        return True

    def snapshot(self):
        return {"blacklisted": sorted(self.blacklisted), "pinned": sorted(self.pinned)}


LC_DEFAULTS = dict(enabled=True, tick_interval_s=0.25, canary_probe_only_s=5.0,
                   canary_initial_fraction=0.25, canary_ramp_step=0.25, canary_step_dwell_s=5.0,
                   canary_max_fraction=0.5, promote_after_s=20.0, min_canary_scores=50,
                   rollback_psi=0.5, rollback_auc_drop=0.05, min_auc_pairs=10,
                   rollback_hold_s=30.0)
QM_DEFAULTS = dict(window_s=600.0, slices=6, drift_check_interval_s=0.0, min_drift_count=10)


def make_controller(registry, clock, quality_monitor=None, watcher=None, *, jax_side=False,
                    **kw):
    cfg_cls = jax_config.LifecycleConfig if jax_side else LifecycleConfig
    ctrl_cls = jax_lifecycle.LifecycleController if jax_side else LifecycleController
    return ctrl_cls(cfg_cls(**{**LC_DEFAULTS, **kw}), registry=registry, model_name="DCN",
                    watcher=watcher, quality=quality_monitor, clock=clock)


def make_monitor(clock=None, *, jax_side=False, **kw):
    cls = jax_quality.QualityMonitor if jax_side else quality.QualityMonitor
    kw = {**QM_DEFAULTS, **kw}
    if clock is not None:
        kw["clock"] = clock
    return cls(**kw)


def _dummy(version: int, jax_side=False):
    cls = JaxServable if jax_side else Servable
    return cls(name="DCN", version=version, model=None, params=None, signatures={})


# ------------------------------------------------- the JAX controller's twin


def _scores(spec):
    kind, seed, n, a, b = spec
    rng = np.random.RandomState(seed)
    if kind == "uniform":
        return rng.uniform(a, b, n)
    return np.clip(rng.normal(a, b, n), 0.0, 1.0)


SCENARIOS = {
    # canary entry, probe phase, ramp to the ceiling, healthy dwell, promote.
    "promote": ({}, [
        ("load", 1), ("tick",), ("load", 2), ("tick",),
        ("route", "probe", 5), ("route", None, 5),
        ("obs", 1, ("uniform", 0, 300, 0.4, 0.6)), ("obs", 2, ("uniform", 1, 300, 0.4, 0.6)),
        ("adv", 5.5), ("tick",), ("route", None, 40), ("adv", 5.0), ("tick",),
        ("route", None, 40), ("route", "probe", 3), ("adv", 5.0), ("tick",), ("adv", 15.0),
        ("tick",), ("route", None, 5), ("adv", 1.0), ("tick",), ("route", "sheddable", 4),
    ]),
    # a shifted canary: pair PSI past the threshold, retire + blacklist, the
    # hold, and the blacklisted version never re-entering canary.
    "psi_rollback": ({"rollback_hold_s": 7.0}, [
        ("load", 1), ("tick",), ("load", 2), ("tick",),
        ("obs", 1, ("uniform", 0, 300, 0.4, 0.6)), ("obs", 2, ("uniform", 1, 300, 0.9, 1.0)),
        ("adv", 0.5), ("tick",), ("route", None, 3), ("route", "probe", 3), ("adv", 7.5),
        ("tick",), ("load", 2), ("tick",), ("route", None, 3),
    ]),
    # same score distribution, inverted label meaning: the AUC gate.
    "auc_rollback": ({"rollback_psi": 100.0}, [
        ("load", 1), ("tick",), ("load", 2), ("tick",),
        ("obs", 1, ("uniform", 0, 300, 0.3, 0.7)), ("obs", 2, ("uniform", 0, 300, 0.3, 0.7)),
        ("labels",), ("adv", 0.5), ("tick",), ("route", None, 4),
    ]),
    # quality=None: "no_signal", promote on the dwell at the ceiling alone.
    "no_signal": ({"_no_quality": True}, [
        ("load", 1), ("tick",), ("load", 2), ("tick",), ("route", None, 8), ("adv", 30.0),
        ("tick",), ("route", None, 8), ("adv", 20.5), ("tick",), ("route", None, 2),
    ]),
    # retired from outside: back to IDLE, no rollback counted.
    "vanished": ({}, [
        ("load", 1), ("tick",), ("load", 2), ("tick",), ("route", "probe", 2), ("unload", 2),
        ("adv", 0.5), ("tick",), ("route", "probe", 2), ("load", 3), ("tick",),
    ]),
    # a ceiling of 1.0 starves the stable window by construction.
    "starved_full": ({"canary_probe_only_s": 0.0, "canary_initial_fraction": 1.0,
                      "canary_max_fraction": 1.0, "promote_after_s": 10.0}, [
        ("load", 1), ("tick",), ("load", 2), ("tick",),
        ("obs", 2, ("uniform", 0, 300, 0.4, 0.6)), ("adv", 0.5), ("tick",), ("route", None, 6),
        ("adv", 10.5), ("tick",), ("route", None, 2),
    ]),
    # sampling noise of a small canary window stays under the coarsened
    # gate; a genuine shift then rolls back through it.
    "noise_then_shift": ({"rollback_psi": 0.4, "min_canary_scores": 120}, [
        ("load", 1), ("tick",), ("load", 2), ("tick",),
        ("obs", 1, ("normal", 0, 8000, 0.5, 0.08)), ("obs", 2, ("normal", 1, 150, 0.5, 0.08)),
        ("adv", 0.5), ("tick",), ("obs", 2, ("uniform", 2, 150, 0.9, 1.0)), ("adv", 0.5),
        ("tick",),
    ]),
    # never enough canary evidence: the dwell alone never promotes.
    "insufficient": ({}, [
        ("load", 1), ("tick",), ("load", 2), ("tick",),
        ("obs", 1, ("uniform", 0, 300, 0.4, 0.6)), ("obs", 2, ("uniform", 1, 10, 0.4, 0.6)),
        ("adv", 1000.0), ("tick",), ("route", None, 10),
    ]),
}


def _side(jax_side: bool, over: dict):
    over = dict(over)
    no_quality = over.pop("_no_quality", False)
    clock = FakeClock()
    registry = JaxRegistry() if jax_side else ServableRegistry()
    watcher = StubWatcher(registry)
    monitor = None if no_quality else make_monitor(clock, jax_side=jax_side)
    ctrl = make_controller(registry, clock, monitor, watcher, jax_side=jax_side, **over)
    return clock, registry, watcher, monitor, ctrl


def _play(jax_side: bool, name: str) -> list:
    over, script = SCENARIOS[name]
    clock, registry, watcher, monitor, ctrl = _side(jax_side, over)
    trail = []
    for op in script:
        kind = op[0]
        out = None
        if kind == "load":
            registry.load(_dummy(op[1], jax_side))
        elif kind == "unload":
            registry.unload("DCN", op[1])
        elif kind == "tick":
            ctrl.tick()
        elif kind == "adv":
            clock.advance(op[1])
        elif kind == "obs":
            monitor.observe("DCN", op[1], _scores(op[2]))
        elif kind == "labels":
            now = monitor._clock()
            for i in range(20):
                score = 0.3 + 0.4 * i / 19
                monitor._labels.put(f"s{i}", "DCN", 1, score, now)
                monitor._labels.ingest(f"s{i}", 1.0 if score > 0.5 else 0.0)
                monitor._labels.put(f"c{i}", "DCN", 2, score, now)
                monitor._labels.ingest(f"c{i}", 0.0 if score > 0.5 else 1.0)
        elif kind == "route":
            out = [ctrl.route(op[1]) for _ in range(op[2])]
        trail.append((op, out, ctrl.snapshot(), sorted(watcher.blacklisted),
                      sorted(watcher.pinned), list(watcher.retired)))
    return trail


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_the_controller_decides_as_the_jax_controller(name):
    theirs, ours = _play(True, name), _play(False, name)
    assert len(theirs) == len(ours)
    for step, (t, o) in enumerate(zip(theirs, ours)):
        assert o == t, (name, step, t[0])
    # Each scenario reaches its point (a scenario that never moved would
    # compare trivially).
    final = ours[-1][2]
    expect = {"promote": IDLE, "psi_rollback": IDLE, "auc_rollback": ROLLED_BACK,
              "no_signal": PROMOTING, "vanished": CANARY, "starved_full": PROMOTING,
              "noise_then_shift": ROLLED_BACK, "insufficient": CANARY}[name]
    assert final["state"] == expect
    if name in ("promote", "no_signal", "starved_full"):
        assert final["counters"]["promotes"] == 1
    if name in ("psi_rollback", "auc_rollback", "noise_then_shift"):
        assert final["counters"]["rollbacks"] == 1


# ------------------------------------------ the real watcher: is_blacklisted


def _fake_version(base: Path, v: int) -> None:
    d = base / str(v)
    (d / "params").mkdir(parents=True)  # the JAX watcher's ready probe
    (d / "params.safetensors").write_bytes(b"")  # the port's
    (d / "servable.json").write_text("{}")


def _watchers(tmp_path):
    """(JAX registry, JAX watcher), (port registry, port watcher) over two
    base paths of fake versions, loaded by a stub loader."""
    out = []
    for jax_side in (True, False):
        base = tmp_path / ("jax" if jax_side else "torch")
        base.mkdir()
        registry = JaxRegistry() if jax_side else ServableRegistry()
        cls, cfg_cls = (JaxWatcher, JaxWatcherConfig) if jax_side else (VersionWatcher,
                                                                         VersionWatcherConfig)
        watcher = cls(base, registry, cfg_cls(poll_interval_s=3600, model_name="DCN"),
                      loader=lambda v, p, js=jax_side: _dummy(v, js))
        out.append((base, registry, watcher))
    return out


def test_a_blacklisted_latest_never_arms_a_canary_through_the_real_watcher(tmp_path):
    trails = []
    for jax_side, (base, registry, watcher) in zip((True, False), _watchers(tmp_path)):
        clock = FakeClock()
        ctrl = make_controller(registry, clock, make_monitor(clock, jax_side=jax_side), watcher,
                               jax_side=jax_side)
        _fake_version(base, 1)
        watcher.poll_once()
        ctrl.tick()
        watcher.blacklist(2)
        assert watcher.is_blacklisted(2) and not watcher.is_blacklisted(1)
        registry.load(_dummy(2, jax_side))  # loaded behind the watcher's back
        clock.advance(1.0)
        ctrl.tick()
        snap = ctrl.snapshot()
        assert snap["state"] == IDLE and snap["canary_version"] is None
        assert ctrl.route("probe") is None and watcher.snapshot()["pinned"] == []
        trails.append((snap["state"], snap["stable_version"], snap["counters"]))
    assert trails[0] == trails[1]


def test_fleet_blacklist_acts_as_the_jax_controller_through_the_real_watcher(tmp_path):
    actions = []
    for jax_side, (base, registry, watcher) in zip((True, False), _watchers(tmp_path)):
        clock = FakeClock()
        ctrl = make_controller(registry, clock, make_monitor(clock, jax_side=jax_side), watcher,
                               jax_side=jax_side)
        for v in (1, 2):
            _fake_version(base, v)
        watcher.poll_once()
        ctrl.tick()  # adopts v2 as stable
        registry.load(_dummy(1, jax_side))
        seq = [ctrl.fleet_blacklist(2),  # the stable version: refused
               ctrl.fleet_blacklist(1),  # loaded, not blacklisted: retired
               ctrl.fleet_blacklist(1),  # now blacklisted
               ctrl.fleet_blacklist(7),  # never seen: blacklisted
               ctrl.fleet_blacklist(7)]
        watcher.poll_once()
        seq.append(sorted(registry.models()["DCN"]))
        seq.append(watcher.snapshot()["blacklisted"])
        actions.append(seq)
    assert actions[0] == actions[1] == [
        "refused_stable", "retired", "already_blacklisted", "blacklisted",
        "already_blacklisted", [2], [1, 7]]


# ----------------------------------------------- the JAX cases on the port


def test_keep_versions_one_is_refused_at_construction(tmp_path):
    registry = ServableRegistry()
    watcher = VersionWatcher(tmp_path, registry,
                             VersionWatcherConfig(poll_interval_s=3600, keep_versions=1))
    with pytest.raises(ValueError, match="keep_versions"):
        make_controller(registry, FakeClock(), watcher=watcher)


def test_a_restart_after_a_detached_stop_mints_a_fresh_loop():
    registry = ServableRegistry()
    registry.load(_dummy(1))
    ctrl = make_controller(registry, FakeClock(), make_monitor())
    ctrl.start()
    first = ctrl._stop
    ctrl.stop()
    assert first.is_set() and not lifecycle.active()
    ctrl.start()
    try:
        assert ctrl._stop is not first and not ctrl._stop.is_set()
        assert ctrl.publish_once(first) is None  # the old generation answers to its event
        assert ctrl.snapshot()["counters"]["publishes"] == 0
    finally:
        ctrl.stop()


def test_the_ramp_routes_its_exact_fraction():
    clock = FakeClock()
    registry = ServableRegistry()
    registry.load(_dummy(1))
    ctrl = make_controller(registry, clock, make_monitor(), canary_probe_only_s=0.0,
                           tick_interval_s=1e9)
    ctrl.tick()
    registry.load(_dummy(2))
    ctrl.tick()
    clock.advance(0.1)
    ctrl.tick()
    assert ctrl.snapshot()["canary_fraction"] == pytest.approx(0.25)
    routes = [ctrl.route(None) for _ in range(100)]
    # floor(k * f) advances exactly f of the time: no RNG.
    assert routes.count(2) == 25 and routes.count(1) == 75
    counters = ctrl.snapshot()["counters"]
    assert counters["routed_canary"] == 25 and counters["routed_stable"] == 75


def test_concurrent_routes_count_every_request_once():
    """8 threads route at the 0.5 ramp with a tiny switch interval: every
    route is counted once and the counter ramp gives exactly half."""
    import threading

    clock = FakeClock()
    registry = ServableRegistry()
    registry.load(_dummy(1))
    ctrl = make_controller(registry, clock, make_monitor(), canary_probe_only_s=0.0,
                           canary_initial_fraction=0.5, tick_interval_s=1e9)
    ctrl.tick()
    registry.load(_dummy(2))
    ctrl.tick()
    clock.advance(0.1)
    ctrl.tick()
    assert ctrl.snapshot()["canary_fraction"] == pytest.approx(0.5)
    got: list = []
    lock = threading.Lock()

    def worker():
        mine = [ctrl.route(None) for _ in range(500)]
        with lock:
            got.extend(mine)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    counters = ctrl.snapshot()["counters"]
    assert len(got) == 4000 and got.count(2) == got.count(1) == 2000
    assert counters["routed_canary"] == counters["routed_stable"] == 2000


def _model_servable(version=1, seed=0):
    model = build_model("dcn", CFG)
    return Servable(name="DCN", version=version, model=model, params=model.init(seed),
                    signatures=ctr_signatures(F))


def _arrays(n, seed=0):
    rng = np.random.RandomState(seed)
    return {"feat_ids": rng.randint(0, 1 << 40, size=(n, F)).astype(np.int64),
            "feat_wts": rng.rand(n, F).astype(np.float32)}


def _request(arrays, version=None, label=None):
    req = apis.PredictRequest()
    req.model_spec.name = "DCN"
    if version is not None:
        req.model_spec.version.value = version
    if label is not None:
        req.model_spec.version_label = label
    for k, arr in arrays.items():
        codec.from_ndarray(arr, use_tensor_content=True, out=req.inputs[k])
    return req


def test_a_rollback_through_a_real_watcher_swap(tmp_path):
    """A real VersionWatcher hot-loads v2 beside v1, real traffic through a
    real batcher feeds both sketches, a shifted canary drives the pair PSI
    past the threshold: v2 is retired and blacklisted, and with its
    directory still ready on disk the next reconcile passes do not load it
    again."""
    clock = FakeClock()
    monitor = make_monitor()
    registry = ServableRegistry()
    sv = _model_servable()
    save_servable(tmp_path / "1", sv, kind="dcn")
    watcher = VersionWatcher(tmp_path, registry,
                             VersionWatcherConfig(poll_interval_s=3600, model_name="DCN"),
                             device="cpu", on_servable_change=_servable_change_hook(
                                 quality=monitor))
    watcher.poll_once()
    ctrl = make_controller(registry, clock, monitor, watcher, canary_probe_only_s=0.0,
                           min_canary_scores=20, rollback_psi=0.3)
    ctrl.tick()
    assert ctrl.snapshot()["stable_version"] == 1
    batcher = DynamicBatcher(buckets=(32,), max_wait_us=0, device="cpu", quality=monitor).start()
    impl = PredictionServiceImpl(registry, batcher)
    impl.lifecycle = ctrl
    try:
        arrays = _arrays(20, seed=3)
        for _ in range(3):
            batcher.submit(registry.resolve("DCN"), arrays).result(timeout=30)
        save_servable(tmp_path / "2", dataclasses.replace(sv, version=2), kind="dcn")
        watcher.poll_once()
        ctrl.tick()
        assert ctrl.snapshot()["state"] == CANARY
        req = _request(arrays)
        assert impl.predict(req, criticality="probe").model_spec.version.value == 2
        assert impl.predict(req).model_spec.version.value == 1  # probe phase: stable
        monitor.observe("DCN", 2, np.random.RandomState(5).uniform(0.9, 1.0, 200))
        clock.advance(0.5)
        ctrl.tick()
        assert ctrl.snapshot()["state"] == ROLLED_BACK
        assert registry.models()["DCN"] == [1] and watcher.is_blacklisted(2)
        for _ in range(2):
            watcher.poll_once()
            assert registry.models()["DCN"] == [1]
        assert impl.predict(req, criticality="probe").model_spec.version.value == 1
    finally:
        batcher.stop()


def test_explicit_pins_are_never_routed():
    registry = ServableRegistry()
    sv = _model_servable()
    registry.load(sv)
    registry.set_label("DCN", "stable", 1)
    clock = FakeClock()
    ctrl = make_controller(registry, clock, make_monitor(), canary_probe_only_s=0.0,
                           canary_initial_fraction=1.0, canary_max_fraction=1.0)
    ctrl.tick()
    registry.load(dataclasses.replace(sv, version=2))
    ctrl.tick()
    clock.advance(0.5)
    ctrl.tick()
    assert ctrl.snapshot()["canary_fraction"] == pytest.approx(1.0)
    batcher = DynamicBatcher(buckets=(32,), max_wait_us=0, device="cpu").start()
    try:
        impl = PredictionServiceImpl(registry, batcher)
        impl.lifecycle = ctrl
        arrays = _arrays(4)
        assert impl.predict(_request(arrays)).model_spec.version.value == 2  # routed
        assert impl.predict(_request(arrays, version=1)).model_spec.version.value == 1
        assert impl.predict(_request(arrays, label="stable")).model_spec.version.value == 1
        assert impl.lifecycle_route("OTHER", None, None, "probe") is None
    finally:
        batcher.stop()


def test_a_vanished_routed_version_falls_back_to_the_latest():
    """The routed version is gone by the time it is resolved (a rollback
    racing the request): the latest serves it, the request does not fail."""
    registry = ServableRegistry()
    sv = _model_servable()
    registry.load(sv)
    batcher = DynamicBatcher(buckets=(32,), max_wait_us=0, device="cpu").start()
    try:
        impl = PredictionServiceImpl(registry, batcher)

        class Routes:
            model = "DCN"

            def route(self, criticality):
                return 9  # never loaded

        impl.lifecycle = Routes()
        assert impl.predict(_request(_arrays(4))).model_spec.version.value == 1
    finally:
        batcher.stop()


def test_disabled_mode_is_inert():
    lifecycle.deactivate()
    registry = ServableRegistry()
    registry.load(_model_servable())
    batcher = DynamicBatcher(buckets=(32,), max_wait_us=0, device="cpu").start()
    try:
        impl = PredictionServiceImpl(registry, batcher)
        assert impl.lifecycle is None and impl.lifecycle_stats() is None
        assert impl.lifecycle_route("DCN", None, None, None) is None
        assert not lifecycle.active()
        assert impl.predict(_request(_arrays(4))).model_spec.version.value == 1
    finally:
        batcher.stop()


def test_the_publisher_counts_and_records_events(tmp_path):
    clock = FakeClock()
    registry = ServableRegistry()
    registry.load(_dummy(1))
    ctrl = make_controller(registry, clock, make_monitor())
    ctrl.publisher = lambda: {"version": 2, "path": str(tmp_path / "2")}
    assert ctrl.publish_once() == {"version": 2, "path": str(tmp_path / "2")}
    assert ctrl.snapshot()["counters"]["publishes"] == 1
    assert ctrl.snapshot()["events"][-1]["event"] == "published"

    def failing():
        raise RuntimeError("trainer exploded")

    ctrl.publisher = failing
    assert ctrl.publish_once() is None
    counters = ctrl.snapshot()["counters"]
    assert counters["publishes"] == 1 and counters["publish_failures"] == 1


def test_the_default_publisher_fine_tunes_the_stable_version_into_a_canary(tmp_path):
    """The loop on the CPU in process: the default publisher fine-tunes the
    served v1 (a copy: v1's params never move), commits v2 under the
    watched base path, the real watcher loads it, and the next tick arms
    it as the canary."""
    registry = ServableRegistry()
    sv = _model_servable()
    save_servable(tmp_path / "1", sv, kind="dcn")
    watcher = VersionWatcher(tmp_path, registry,
                             VersionWatcherConfig(poll_interval_s=3600, model_name="DCN"),
                             device="cpu")
    watcher.poll_once()
    clock = FakeClock()
    ctrl = make_controller(registry, clock, make_monitor(), watcher, fine_tune_steps=3,
                           fine_tune_batch_size=16)
    ctrl.tick()
    v1 = registry.resolve("DCN")
    before = {k: t.clone() for k, t in flatten_params(v1.params).items()}
    summary = ctrl.publish_once()
    assert summary["version"] == 2 and summary["steps"] == 3
    assert all(torch.equal(t, before[k]) for k, t in flatten_params(v1.params).items())
    watcher.poll_once()
    ctrl.tick()
    snap = ctrl.snapshot()
    assert snap["state"] == CANARY and snap["canary_version"] == 2
    assert snap["counters"]["publishes"] == 1 and snap["events"][-2]["event"] == "published"


# ----------------------------------------------- config, build_stack, CLI


def test_the_lifecycle_section_parses_and_defaults(tmp_path):
    p = tmp_path / "c.toml"
    p.write_text("[lifecycle]\nenabled = true\ncanary_probe_only_s = 2.5\n"
                 "canary_max_fraction = 0.4\nrollback_psi = 0.35\n"
                 "fine_tune_interval_s = 900.0\nfine_tune_steps = 64\n")
    lc = load_config(p)["lifecycle"]
    assert (lc.enabled, lc.canary_probe_only_s, lc.canary_max_fraction, lc.rollback_psi,
            lc.fine_tune_interval_s, lc.fine_tune_steps) == (True, 2.5, 0.4, 0.35, 900.0, 64)
    assert dataclasses.asdict(lc) == dataclasses.asdict(jax_config.load_config(p)["lifecycle"])
    assert dataclasses.asdict(LifecycleConfig()) == dataclasses.asdict(
        jax_config.LifecycleConfig())
    p.write_text("")
    assert "lifecycle" not in load_config(p)
    p.write_text("[lifecycle]\nbogus = 1\n")
    with pytest.raises(ValueError, match="unknown \\[lifecycle\\] keys"):
        load_config(p)


def test_build_stack_arms_the_controller_and_refuses_what_jax_refuses(tmp_path):
    cfg = ServerConfig(model_name="DCN", num_fields=F, buckets=(32,), warmup=False,
                       max_wait_us=0)
    base = tmp_path / "versions"
    base.mkdir()
    impl, batcher, _ = build_stack(
        cfg, CFG, "cpu", model_base_path=str(base),
        quality_config=QualityConfig(enabled=True, reference_file=""),
        lifecycle_config=LifecycleConfig(enabled=True))
    try:
        lc = impl.lifecycle
        assert lc is not None and lc.model == "DCN" and lc.watcher is impl.version_watcher
        assert lc.quality is batcher.quality is not None and lifecycle.active()
    finally:
        impl.version_watcher.stop()
        batcher.stop()
        lifecycle.deactivate()
    impl2, batcher2, _ = build_stack(cfg, CFG, "cpu", model_base_path=str(base),
                                     lifecycle_config=LifecycleConfig(enabled=False))
    try:
        assert impl2.lifecycle is None
    finally:
        impl2.version_watcher.stop()
        batcher2.stop()
    with pytest.raises(ValueError, match="model-base-path"):
        build_stack(cfg, CFG, "cpu",
                    quality_config=QualityConfig(enabled=True, reference_file=""),
                    lifecycle_config=LifecycleConfig(enabled=True))
    with pytest.raises(ValueError, match="quality"):
        build_stack(cfg, CFG, "cpu", model_base_path=str(base),
                    lifecycle_config=LifecycleConfig(enabled=True))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(port, path, method="GET"):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", method=method, data=(
        b"" if method == "POST" else None))
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_the_lane_routes_over_grpc_and_rest_and_the_surfaces_answer(tmp_path):
    """A stack with a controller in its probe phase: a Predict with
    x-dts-criticality: probe (gRPC metadata, REST header) answers from the
    canary, one without from the stable version; /lifecyclez,
    ?section=lifecycle, the lint-clean dts_tpu_lifecycle_* lines (the JAX
    exposition's on the same snapshot) and POST /lifecyclez/rollback (200
    with a canary, 409 after, 404 with the plane off)."""
    from distributed_tf_serving_tpu_torch.serving.server import start_rest_in_thread

    registry = ServableRegistry()
    sv = _model_servable()
    registry.load(sv)
    clock = FakeClock()
    watcher = StubWatcher(registry)
    ctrl = make_controller(registry, clock, make_monitor(), watcher, tick_interval_s=1e9)
    ctrl.tick()
    registry.load(dataclasses.replace(sv, version=2))
    ctrl.tick()
    batcher = DynamicBatcher(buckets=(32,), max_wait_us=0, device="cpu").start()
    impl = PredictionServiceImpl(registry, batcher)
    impl.lifecycle = ctrl
    server, port = create_server(impl, "127.0.0.1:0")
    server.start()
    rest_port = start_rest_in_thread(impl, "127.0.0.1", 0, None)
    try:
        arrays = _arrays(4)
        with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
            stub = PredictionServiceStub(ch)
            probe = stub.Predict(_request(arrays), timeout=30,
                                 metadata=(("x-dts-criticality", "probe"),))
            plain = stub.Predict(_request(arrays), timeout=30)
            assert HealthStub(ch).Check(HealthCheckRequest(service="")).status == \
                health_proto.SERVING
        assert probe.model_spec.version.value == 2 and plain.model_spec.version.value == 1
        body = json.dumps({"instances": [{"feat_ids": [int(x) for x in row],
                                          "feat_wts": [float(x) for x in w]}
                                         for row, w in zip(arrays["feat_ids"] % VOCAB,
                                                           arrays["feat_wts"])]}).encode()
        for header, want in (({"x-dts-criticality": "probe"}, 2), ({}, 1)):
            req = urllib.request.Request(
                f"http://127.0.0.1:{rest_port}/v1/models/DCN:predict", data=body,
                headers={"Content-Type": "application/json", **header}, method="POST")
            with urllib.request.urlopen(req, timeout=30) as r:
                assert r.status == 200
        counters = ctrl.snapshot()["counters"]
        assert counters["routed_probe"] == 2 and counters["routed_stable"] == 2
        status, lz = _get(rest_port, "/lifecyclez")
        assert status == 200 and lz["state"] == CANARY and lz["canary_version"] == 2
        status, sec = _get(rest_port, "/monitoring?section=lifecycle")
        assert set(sec) == {"lifecycle"} and sec["lifecycle"]["counters"] == lz["counters"]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{rest_port}/monitoring/prometheus/metrics", timeout=10) as r:
            prom = r.read().decode()
        assert lint_text(prom) == []
        assert 'dts_tpu_lifecycle_state{state="canary"} 1' in prom
        assert 'dts_tpu_lifecycle_routed_total{target="canary"} 2' in prom
        assert "dts_tpu_lifecycle_probe_routed_total 2" in prom
        snap = ctrl.snapshot()
        assert metrics._lifecycle_prometheus_lines(snap) == \
            jax_metrics._lifecycle_prometheus_lines(snap)
        ours = [ln for ln in prom.splitlines() if "dts_tpu_lifecycle" in ln]
        assert len(ours) >= 30
        status, rb = _get(rest_port, "/lifecyclez/rollback", "POST")
        assert status == 200 and rb["rolled_back"] and rb["lifecycle"]["state"] == ROLLED_BACK
        assert watcher.blacklisted == {2} and registry.models()["DCN"] == [1]
        status, rb = _get(rest_port, "/lifecyclez/rollback", "POST")
        assert status == 409 and not rb["rolled_back"]
        impl.lifecycle = None
        assert _get(rest_port, "/lifecyclez") == (200, {"enabled": False})
        assert _get(rest_port, "/lifecyclez/rollback", "POST") == (404, {"enabled": False})
    finally:
        server.stop(0).wait()
        batcher.stop()


def _wait(pred, what, timeout=90.0, proc=None):
    end = time.time() + timeout
    while True:
        got = pred()
        if got:
            return got
        assert proc is None or proc.poll() is None, f"server exited waiting for {what}"
        assert time.time() < end, f"timed out waiting for {what}"
        time.sleep(0.1)


LIFECYCLE_TOML = (
    f"[server]\nnum_fields = {F}\nbuckets = [16]\nmax_wait_us = 0\n"
    "file_system_poll_wait_seconds = 0.2\n"
    "[quality]\nreference_file = \"\"\nmin_drift_count = 8\n"
    "[lifecycle]\ntick_interval_s = 0.1\ncanary_probe_only_s = 0.5\n"
    "canary_initial_fraction = 0.5\ncanary_step_dwell_s = 0.5\ncanary_max_fraction = 0.5\n"
    "promote_after_s = 1.0\nmin_canary_scores = 128\nrollback_psi = 0.5\n"
    "rollback_hold_s = 0.5\nfine_tune_steps = 2\nfine_tune_batch_size = 16\n")


class _Cli:
    """The CLI server over `base` with --lifecycle, and a gRPC client that
    counts the versions it was answered from and every failed call."""

    def __init__(self, tmp_path, base, publish_every_s: float):
        cfg = tmp_path / f"c{publish_every_s}.toml"
        cfg.write_text(LIFECYCLE_TOML + f"fine_tune_interval_s = {publish_every_s}\n")
        self.port, self.rest = _free_port(), _free_port()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "distributed_tf_serving_tpu_torch.serving.server",
             "--config", str(cfg), "--host", "127.0.0.1", "--port", str(self.port),
             "--device", "cpu", "--model-base-path", str(base), "--rest-port", str(self.rest),
             "--lifecycle"],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self.ch = grpc.insecure_channel(f"127.0.0.1:{self.port}")
        self.stub = PredictionServiceStub(self.ch)
        self.failures: list = []
        self.seen: dict = {}
        self.k = 0
        grpc.channel_ready_future(self.ch).result(timeout=90)
        _wait(lambda: HealthStub(self.ch).Check(HealthCheckRequest(service="")).status
              == health_proto.SERVING, "SERVING", proc=self.proc)
        _wait(lambda: _get_or_none(self.rest, "/lifecyclez"), "REST", proc=self.proc)

    def send(self, lane=None):
        md = (("x-dts-criticality", lane),) if lane else None
        try:
            resp = self.stub.Predict(_request(_arrays(16, seed=self.k % 50)), timeout=30,
                                     metadata=md)
        except grpc.RpcError as e:
            self.failures.append(e.code())
            return
        v = resp.model_spec.version.value
        self.seen[v] = self.seen.get(v, 0) + 1

    def traffic_until(self, pred, what):
        def step():
            self.send()
            if self.k % 5 == 0:
                self.send("probe")
            self.k += 1
            snap = _get(self.rest, "/lifecyclez")[1]
            return snap if pred(snap) else None

        return _wait(step, what, timeout=120, proc=self.proc)

    def stop(self) -> str:
        self.ch.close()
        try:
            self.proc.send_signal(signal.SIGTERM)
            out, _ = self.proc.communicate(timeout=60)
            assert self.proc.returncode == 0, out[-4000:]
            return out
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()


def test_the_cli_runs_the_loop_publish_canary_promote_then_rolls_back(tmp_path):
    """The whole loop on the CPU through the CLI: --lifecycle (which arms
    --quality) over --model-base-path with short [lifecycle] times. First
    with the fine-tune publisher on: the server fine-tunes v1 into v2, the
    watcher loads it, the controller routes the probe lane and then half of
    the default lane to it and promotes it. Then a second run with the
    publisher off: a version published from outside with every score
    pushed to 1 is rolled back (retired, blacklisted, not reloaded), and
    POST /lifecyclez/rollback answers 409. No Predict fails, and SIGTERM
    exits 0 both times."""
    base = tmp_path / "base"
    sv = _model_servable(seed=0)
    save_servable(base / "1", sv, kind="dcn")
    cli = _Cli(tmp_path, base, publish_every_s=0.5)
    try:
        lz = cli.traffic_until(lambda s: s["counters"]["promotes"] >= 1 and s["state"] == IDLE,
                               "publish, canary and promote of v2")
    finally:
        out = cli.stop()
    # The publisher fires again once the controller is IDLE, so a later
    # version may be on its way by now: read v2's own events.
    assert lz["counters"]["publishes"] >= 1 and lz["stable_version"] >= 2
    events = [(e["event"], e.get("version", e.get("canary"))) for e in lz["events"]]
    assert events.index(("published", 2)) < events.index(("canary_started", 2)) < \
        events.index(("promoted", 2))
    assert cli.seen.get(2, 0) > 0 and cli.failures == []
    assert "continuous-freshness lifecycle on" in out

    cli = _Cli(tmp_path, base, publish_every_s=0.0)
    try:
        stable = _get(cli.rest, "/lifecyclez")[1]
        cli.traffic_until(lambda s: s["stable_version"] is not None, "a stable version")
        poisoned = dataclasses.replace(sv, params=_poison(sv.params))
        version, _ = publish_version(
            base, lambda tmp: save_servable(tmp, poisoned, kind="dcn"), at_least=2)
        lz = cli.traffic_until(lambda s: s["counters"]["rollbacks"] >= 1,
                               f"the rollback of v{version}")
        assert lz["rolled_back_version"] == version and lz["last_rollback"]["reason"] == "psi"
        assert version in lz["watcher"]["blacklisted"]
        time.sleep(0.6)  # reconcile passes every 0.2 s
        lz = _get(cli.rest, "/lifecyclez")[1]
        assert version not in lz["versions_loaded"] and lz["canary_version"] is None
        assert _get(cli.rest, "/lifecyclez/rollback", "POST")[0] == 409
    finally:
        cli.stop()
    assert stable["counters"]["publishes"] == 0 and cli.failures == []


def _get_or_none(port, path):
    try:
        return _get(port, path)
    except OSError:
        return None


def _poison(params):
    """The params with the head's bias pushed to +20: every score near 1."""
    out = tree_map(lambda t: t.clone(), params)
    out["out"]["b"] = out["out"]["b"] + torch.tensor(20.0)
    return out
