"""The port's fault injector (distributed_tf_serving_tpu_torch/faults.py)
against the JAX package's: the same rules and seed fire on the same calls,
the same DTS_TPU_FAULTS strings parse to the same rules, a rule on a site
this package never fires is refused with its ROADMAP.md item, and each of
the four sites it fires ends a Predict with the code its rule names, in
the port's service as in the JAX package's."""

import jax
import numpy as np
import pytest

from distributed_tf_serving_tpu import faults as jax_faults
from distributed_tf_serving_tpu.models import ModelConfig as JaxConfig
from distributed_tf_serving_tpu.models import Servable as JaxServable
from distributed_tf_serving_tpu.models import ServableRegistry as JaxRegistry
from distributed_tf_serving_tpu.models import build_model as jax_build
from distributed_tf_serving_tpu.models import ctr_signatures as jax_signatures
from distributed_tf_serving_tpu.serving import DynamicBatcher as JaxBatcher
from distributed_tf_serving_tpu.serving import PredictionServiceImpl as JaxImpl
from distributed_tf_serving_tpu.serving.service import ServiceError as JaxServiceError
from distributed_tf_serving_tpu_torch import codec, faults
from distributed_tf_serving_tpu_torch.convert import params_from_jax
from distributed_tf_serving_tpu_torch.models import (
    ModelConfig,
    Servable,
    ServableRegistry,
    build_model,
    ctr_signatures,
)
from distributed_tf_serving_tpu_torch.proto import serving_apis_pb2 as apis
from distributed_tf_serving_tpu_torch.serving.batcher import DynamicBatcher
from distributed_tf_serving_tpu_torch.serving.service import PredictionServiceImpl, ServiceError

F = 6
KW = dict(num_fields=F, vocab_size=1 << 12, embed_dim=8, mlp_dims=(16,), num_cross_layers=2,
          compute_dtype="float32")


@pytest.fixture(autouse=True)
def _reset_injectors():
    """Both process-global injectors start and end with no rule."""
    faults.reset(0)
    jax_faults.reset(0)
    yield
    faults.reset(0)
    jax_faults.reset(0)


def _draws(inj, site: str, n: int, key=None) -> list[bool]:
    fired = []
    for _ in range(n):
        try:
            inj.fire(site, key=key)
            fired.append(False)
        except Exception as e:  # noqa: BLE001 — either package's InjectedFaultError
            assert type(e).__name__ == "InjectedFaultError"
            fired.append(True)
    return fired


@pytest.mark.parametrize("site", faults.SITES)
@pytest.mark.parametrize("seed", [0, 7])
def test_same_rules_and_seed_fire_on_the_same_calls(site, seed):
    ours, theirs = faults.FaultInjector(seed=seed), jax_faults.FaultInjector(seed=seed)
    for inj in (ours, theirs):
        inj.add(site, "error", rate=0.3)
        inj.add(site, "error", rate=0.3, key="b", code="DATA_LOSS")
    a = _draws(ours, site, 500)
    b = _draws(theirs, site, 500)
    assert a == b
    assert 100 < sum(a) < 200  # rate 0.3 over 500 draws
    assert _draws(ours, site, 200, key="b") == _draws(theirs, site, 200, key="b")
    assert ours.fires == theirs.fires


def test_count_caps_and_keys_select_like_jax():
    ours, theirs = faults.FaultInjector(seed=3), jax_faults.FaultInjector(seed=3)
    for inj in (ours, theirs):
        inj.add("readback", "error", count=3)
        inj.add("decode", "error", key="x", rate=0.5)
    a, b = ([*_draws(inj, "readback", 10), *_draws(inj, "decode", 50),
             *_draws(inj, "decode", 50, key="x")] for inj in (ours, theirs))
    assert a == b
    assert sum(a[:10]) == 3 and not any(a[10:60]) and any(a[60:])
    assert ours.snapshot() == theirs.snapshot()


def test_device_lost_keyed_by_payload_digest_fires_like_jax():
    """The recovery plane's site: a keyless count=1 rule and a keyed rule on
    one payload's poison_fault_key (the key the batcher fires it with once
    per batch member), drawn over five payloads' digests in both packages:
    the same calls fire."""
    import numpy as np

    from distributed_tf_serving_tpu.serving.batcher import poison_fault_key as jax_key
    from distributed_tf_serving_tpu_torch.serving.batcher import poison_fault_key

    rng = np.random.RandomState(5)
    payloads = [{"feat_ids": rng.randint(0, 1 << 40, size=(4, 6)).astype(np.int64),
                 "feat_wts": rng.rand(4, 6).astype(np.float32)} for _ in range(5)]
    keys = [poison_fault_key(p) for p in payloads]
    assert keys == [jax_key(p) for p in payloads]
    ours, theirs = faults.FaultInjector(seed=9), jax_faults.FaultInjector(seed=9)
    for inj in (ours, theirs):
        inj.add("device_lost", "error", code="UNAVAILABLE", count=1, rate=0.5)
        inj.add("device_lost", "error", code="DATA_LOSS", key=keys[2])
    a, b = ([d for k in keys * 4 for d in _draws(inj, "device_lost", 1, key=k)]
            for inj in (ours, theirs))
    assert a == b
    assert sum(a) == 1 + 4  # the keyless rule once, the keyed one on each of its calls
    assert ours.snapshot() == theirs.snapshot()


SPECS = [
    "decode=error,code=INVALID_ARGUMENT",
    "batcher.dispatch=wedge,count=1",
    "readback=delay,delay=0.02;executor_abort=error,rate=0.25,code=INTERNAL,key=k1",
    " decode=delay,delay=0.5,rate=0.1 ; readback=error,count=2 ;",
    "batcher.dispatch=error,code=DATA_LOSS,rate=1.0,count=4,key=batch",
]


def _rules(inj) -> list[tuple]:
    return [(r.site, r.kind, r.rate, r.delay_s, r.code, r.count, r.key) for r in inj._rules]


@pytest.mark.parametrize("spec", SPECS)
def test_env_strings_parse_to_the_same_rules(monkeypatch, spec):
    monkeypatch.setenv("DTS_TPU_FAULTS", spec)
    monkeypatch.setenv("DTS_TPU_FAULT_SEED", "11")
    n = faults.configure_from_env()
    assert n == jax_faults.configure_from_env()
    assert _rules(faults.get()) == _rules(jax_faults.get())
    assert faults.get().seed == jax_faults.get().seed == 11
    assert faults.active() and jax_faults.active()
    # The same draws from the same parsed rules (sites with error rules
    # only: a delay or wedge rule would hold the test).
    rules = _rules(faults.get())
    for site in sorted({r[0] for r in rules}):
        if all(r[1] == "error" for r in rules if r[0] == site):
            assert _draws(faults.get(), site, 40, key="k1") == \
                _draws(jax_faults.get(), site, 40, key="k1")


def test_every_site_of_the_jax_package_fires_here():
    assert faults.UNPORTED_SITES == {}
    assert set(jax_faults.SITES) <= set(faults.SITES)


@pytest.mark.parametrize("site,key", [("client.rpc", "127.0.0.1:9001"),
                                      ("wire_corrupt", "feat_wts"),
                                      ("wire_corrupt", "response")])
def test_a_client_site_takes_rules_and_fires_as_the_jax_package_s(monkeypatch, site, key):
    """The client's two sites, once refused here, take rules from the
    environment and draw as the JAX package's do, sync and async."""
    monkeypatch.setenv("DTS_TPU_FAULTS", f"decode=delay,delay=0.1;{site}=error,rate=0.5,key={key}")
    monkeypatch.setenv("DTS_TPU_FAULT_SEED", "3")
    assert faults.configure_from_env() == jax_faults.configure_from_env() == 2
    assert _draws(faults.get(), site, 40, key=key) == _draws(jax_faults.get(), site, 40, key=key)
    assert _draws(faults.get(), site, 5, key="other") == [False] * 5

    async def fire_async():
        out = []
        for _ in range(20):
            try:
                await faults.fire_async(site, key)
                out.append(False)
            except faults.InjectedFaultError:
                out.append(True)
        return out

    faults.reset(3)
    jax_faults.reset(3)
    faults.get().add(site, "error", rate=0.5, key=key)
    jax_faults.get().add(site, "error", rate=0.5, key=key)
    import asyncio

    assert asyncio.run(fire_async()) == _draws(jax_faults.get(), site, 20, key=key)


@pytest.mark.parametrize("spec,match", [
    ("nowhere=error", "unknown fault site 'nowhere'"),
    ("decode", "needs site=kind"),
    ("decode=explode", "unknown fault kind"),
    ("decode=error,colour=red", "unknown option"),
    ("decode=error,rate", "bad option"),
])
def test_malformed_specs_raise(monkeypatch, spec, match):
    monkeypatch.setenv("DTS_TPU_FAULTS", spec)
    with pytest.raises(ValueError, match=match):
        faults.configure_from_env()


def test_the_module_surface_is_the_jax_package_s():
    for name in ("SITES", "KINDS", "InjectedFaultError", "FaultRule", "FaultInjector", "get",
                 "active", "fire", "reset", "configure_from_env"):
        assert hasattr(faults, name) and hasattr(jax_faults, name), name
    assert faults.KINDS == jax_faults.KINDS
    assert set(faults.SITES) | set(faults.UNPORTED_SITES) == set(jax_faults.SITES) | {"pressure"}
    e = faults.InjectedFaultError("decode", "DATA_LOSS")
    j = jax_faults.InjectedFaultError("decode", "DATA_LOSS")
    assert (e.code().name, e.details(), str(e)) == (j.code().name, j.details(), str(j))


def test_clear_releases_a_wedge_and_deactivates():
    import threading

    faults.get().add("readback", "wedge")
    assert faults.active()
    t = threading.Thread(target=faults.fire, args=("readback",))
    t.start()
    t.join(0.2)
    assert t.is_alive()  # held by the wedge
    faults.get().clear()
    t.join(5)
    assert not t.is_alive() and not faults.active()


# ---------------------------------------------------- through the service


def _stacks():
    """(JAX impl, port impl, stop) over the same seed-0 f32 weights."""
    jm = jax_build("dcn_v2", JaxConfig(name="DCN", **KW))
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    jreg = JaxRegistry()
    jreg.load(JaxServable(name="DCN", version=1, model=jm, params=jp,
                          signatures=jax_signatures(F)))
    jb = JaxBatcher(buckets=(32, 64), max_wait_us=0).start()
    treg = ServableRegistry()
    treg.load(Servable(name="DCN", version=1,
                       model=build_model("dcn_v2", ModelConfig(name="DCN", **KW)),
                       params=params_from_jax(jp, "cpu"), signatures=ctr_signatures(F)))
    tb = DynamicBatcher(buckets=(32, 64), max_wait_us=0, device="cpu").start()

    def stop():
        faults.get().clear()
        jax_faults.get().clear()
        jb.stop()
        tb.stop()

    return JaxImpl(jreg, jb), PredictionServiceImpl(treg, tb), stop


def _predict_request(n=5, seed=0):
    rng = np.random.RandomState(seed)
    req = apis.PredictRequest()
    req.model_spec.name = "DCN"
    codec.from_ndarray(rng.randint(0, 1 << 40, size=(n, F)).astype(np.int64),
                       out=req.inputs["feat_ids"])
    codec.from_ndarray(rng.rand(n, F).astype(np.float32), out=req.inputs["feat_wts"])
    return req


@pytest.mark.parametrize("site,code", [
    ("decode", "INVALID_ARGUMENT"),
    ("batcher.dispatch", "RESOURCE_EXHAUSTED"),
    ("readback", "DATA_LOSS"),
    ("executor_abort", "INTERNAL"),
])
def test_each_site_ends_a_predict_with_its_code_in_both_services(site, code):
    from distributed_tf_serving_tpu.proto import serving_apis_pb2 as japis

    jimpl, timpl, stop = _stacks()
    try:
        req = _predict_request()
        jreq = japis.PredictRequest.FromString(req.SerializeToString())
        want = np.asarray(codec.to_ndarray(timpl.predict(req).outputs["prediction_node"]))
        for inj, impl, r, err in ((faults.get(), timpl, req, ServiceError),
                                  (jax_faults.get(), jimpl, jreq, JaxServiceError)):
            inj.add(site, "error", code=code, count=1)
            with pytest.raises(err) as e:
                impl.predict(r, deadline_s=30)
            assert e.value.code == code
            assert inj.fires == {site: 1}
        # The next Predict is answered, and alike.
        ours = codec.to_ndarray(timpl.predict(req, deadline_s=30).outputs["prediction_node"])
        theirs = np.asarray(codec.to_ndarray(apis.PredictResponse.FromString(
            jimpl.predict(jreq, deadline_s=30).SerializeToString()).outputs["prediction_node"]))
        np.testing.assert_array_equal(ours, want)
        np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-5)
    finally:
        stop()
