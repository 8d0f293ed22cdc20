"""Deterministic fault injection for the serving stack (the JAX package's
faults.py: the same rule grammar, kinds, per-rule seeding and environment
variable, so the same rules and seed fire on the same calls in both).

The degraded modes that defend a caller against a sick backend (scoreboard
ejection, hedging, partial merges, deadline shedding, the batcher's circuit
breaker) are exactly the paths ordinary traffic never exercises. This
module makes them testable on demand and deterministically: named sites
inside the stack call `fire()` / `fire_async()`, which is a no-op until
rules are installed (one module-bool check on the hot path).

Named sites fired in this package:

- ``decode``            service-side request decode/validation
                        (service._predict_prepare)
- ``batcher.dispatch``  the device stage of one batch (batcher._run_stage)
- ``readback``          the completion worker's wait for a batch's
                        readback (batcher._finish)
- ``executor_abort``    the completion worker's result path, next to
                        ``readback``: the step aborted after dispatch
- ``client.rpc``        one per-backend shard RPC (client._shard_call;
                        ``key`` is the backend host string, so a rule can
                        target one backend of a fan-out)
- ``wire_corrupt``      request-tensor bytes flipped in flight (client
                        _one_rpc, after CRC stamping: the checksum describes
                        the original bytes, so the server's verify must
                        catch it); ``key`` is the input tensor name, or
                        ``response`` for the score tensor the client
                        receives. ``error`` kind, used as a marker
- ``pressure``          the overload controller's tick
                        (serving/overload.py): an ``error`` rule whose
                        ``code`` names a pressure state (``BROWNOUT`` /
                        ``SHED`` / ``NOMINAL``) pins the state machine
                        there while the rule fires, with no real load
- ``readback_bitflip``  one bit flipped in a member request's first score
                        row after the readback's event wait and before the
                        shadow compare and the screen (batcher._finish),
                        fired once per member with ``key`` = that
                        request's batcher.poison_fault_key; the ``error``
                        kind is a marker, caught there and applied
- ``score_nan``         a member request's score rows set to NaN at the
                        same point, keyed the same way (the readback
                        screen's prey)
- ``device_lost``       the device stage of one batch, once per member
                        request with ``key`` = its batcher.poison_fault_key
                        (batcher._run_stage; only while a rule names the
                        site): an ``error`` kills the batch as a dead device
                        would, the recovery plane's trigger
                        (serving/recovery.py); a keyed rule kills exactly
                        the batches that carry one payload

Every site of the JAX package fires here too. A rule on an unknown site
would do nothing without saying so, so `add()` (and with it
`configure_from_env`) refuses it with a ValueError.

Rule kinds:

- ``delay``  sleep ``delay_s`` then proceed (tail-latency injection);
- ``error``  raise InjectedFaultError carrying a grpc status-code NAME —
             the service maps it onto the matching RPC status, and the
             client treats it like an AioRpcError (failover, ejection);
- ``wedge``  block until ``clear()`` (or ``delay_s`` as a safety cap when
             set) — the stuck-backend / stuck-device scenario.

Determinism: every rule gets its own ``random.Random`` seeded from
``(injector seed, site, kind, key)``, so a given rule/traffic interleaving
reproduces exactly; ``rate=1.0`` rules never consult the RNG at all.

Config: programmatic (``faults.get().add(...)``) or the ``DTS_TPU_FAULTS``
env var, read at import — semicolon-separated rules, each
``site=kind[,rate=R][,delay=D][,code=NAME][,count=N][,key=K]``, e.g.::

    DTS_TPU_FAULTS="client.rpc=error,rate=0.05,code=UNAVAILABLE;readback=delay,delay=0.02"
    DTS_TPU_FAULT_SEED=7
"""

from __future__ import annotations

import asyncio
import dataclasses
import os
import random
import threading
import time

from .utils import tracing

SITES = ("decode", "batcher.dispatch", "readback", "executor_abort", "pressure",
         "readback_bitflip", "score_nan", "device_lost", "client.rpc", "wire_corrupt")
KINDS = ("delay", "error", "wedge")
# The JAX package's sites whose plane is not ported: site -> the ROADMAP.md
# Queue A item that ports it. Empty: every site fires.
UNPORTED_SITES: dict[str, int] = {}


def check_site(site: str) -> None:
    """Refuse a rule on a site this package never fires."""
    if site in UNPORTED_SITES:
        raise ValueError(
            f"fault site {site!r} is not ported yet (ROADMAP.md Queue A item "
            f"{UNPORTED_SITES[site]}); this package fires {list(SITES)}")
    if site not in SITES:
        raise ValueError(f"unknown fault site {site!r}; this package fires {list(SITES)}")


class _Code:
    """Duck-type of grpc.StatusCode: `.name` is what the stack matches on."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __repr__(self):
        return f"StatusCode.{self.name}"


class InjectedFaultError(RuntimeError):
    """Raised by `error` rules. code()/details() mimic grpc.aio.AioRpcError,
    and the service maps `code_name` onto the RPC status, so injected and
    real failures are handled alike."""

    def __init__(self, site: str, code_name: str = "UNAVAILABLE", details: str | None = None):
        self.site = site
        self.code_name = code_name
        self._details = details or f"injected fault at {site!r}"
        super().__init__(self._details)

    def code(self) -> _Code:
        return _Code(self.code_name)

    def details(self) -> str:
        return self._details


@dataclasses.dataclass
class FaultRule:
    site: str
    kind: str
    rate: float = 1.0
    delay_s: float = 0.0
    code: str = "UNAVAILABLE"
    count: int | None = None  # max fires; None = unlimited
    key: str | None = None  # only fire when the call site's key matches
    fired: int = 0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; have {KINDS}")
        # Per-rule deterministic stream: independent of every other rule's
        # draw order, reproducible across runs for the same seed.
        self._rng: random.Random | None = None
        self._unwedge = threading.Event()


class FaultInjector:
    """Rule registry + the fire sites. One process-global instance (get());
    tests may also construct private ones and pass them explicitly."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self._lock = threading.Lock()
        self._rules: list[FaultRule] = []
        self.fires: dict[str, int] = {}

    # -------------------------------------------------------------- config

    def add(
        self,
        site: str,
        kind: str = "error",
        rate: float = 1.0,
        delay_s: float = 0.0,
        code: str = "UNAVAILABLE",
        count: int | None = None,
        key: str | None = None,
    ) -> FaultRule:
        check_site(site)
        rule = FaultRule(
            site=site, kind=kind, rate=rate, delay_s=delay_s,
            code=code, count=count, key=key,
        )
        rule._rng = random.Random(f"{self.seed}:{site}:{kind}:{key}")
        with self._lock:
            self._rules.append(rule)
        if self is _GLOBAL:
            _set_active(True)
        return rule

    def has_site(self, site: str) -> bool:
        """True when any rule (spent or not) targets `site`: the cheap
        gate a call site checks before deriving per-item keys."""
        with self._lock:
            return any(r.site == site for r in self._rules)

    def clear(self, site: str | None = None) -> None:
        """Remove matching rules (all when site is None) and release every
        wedge they hold — the recovery edge of a wedged-backend scenario."""
        with self._lock:
            gone = [r for r in self._rules if site is None or r.site == site]
            self._rules = [r for r in self._rules if r not in gone]
            empty = not self._rules
        for r in gone:
            r._unwedge.set()
        if self is _GLOBAL and empty:
            _set_active(False)

    def reset(self, seed: int | None = None) -> None:
        self.clear()
        with self._lock:
            self.fires.clear()
            if seed is not None:
                self.seed = seed

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "fires": dict(self.fires),
                "rules": [
                    {"site": r.site, "kind": r.kind, "rate": r.rate,
                     "key": r.key, "fired": r.fired}
                    for r in self._rules
                ],
            }

    # --------------------------------------------------------------- sites

    def _match(self, site: str, key: str | None) -> FaultRule | None:
        with self._lock:
            for rule in self._rules:
                if rule.site != site:
                    continue
                if rule.key is not None and key != rule.key:
                    continue
                if rule.count is not None and rule.fired >= rule.count:
                    continue
                if rule.rate < 1.0 and rule._rng.random() >= rule.rate:
                    continue
                rule.fired += 1
                self.fires[site] = self.fires.get(site, 0) + 1
                return rule
        return None

    @staticmethod
    def _annotate(site: str, rule: FaultRule, key: str | None) -> None:
        """Mark the active request span (or the batcher's phase sink) with
        the injected fault, so a chaos run's trace shows exactly where the
        delay/error/wedge landed (no-op when tracing is off)."""
        tracing.annotate(
            f"fault.{site}",
            kind=rule.kind,
            code=rule.code if rule.kind == "error" else None,
            delay_s=rule.delay_s or None,
            key=key,
        )

    def fire(self, site: str, key: str | None = None) -> None:
        """Synchronous site (server threads). Sleeps, raises, or wedges
        according to the first matching rule; returns untouched otherwise."""
        rule = self._match(site, key)
        if rule is None:
            return
        self._annotate(site, rule, key)
        if rule.kind == "delay":
            time.sleep(rule.delay_s)
        elif rule.kind == "wedge":
            # delay_s > 0 doubles as a safety cap so a forgotten clear()
            # cannot hang a thread forever.
            rule._unwedge.wait(rule.delay_s or None)
        else:
            raise InjectedFaultError(site, rule.code)

    async def fire_async(self, site: str, key: str | None = None) -> None:
        """Coroutine site (the asyncio client): never blocks the loop."""
        rule = self._match(site, key)
        if rule is None:
            return
        self._annotate(site, rule, key)
        if rule.kind == "delay":
            await asyncio.sleep(rule.delay_s)
        elif rule.kind == "wedge":
            cap = time.perf_counter() + rule.delay_s if rule.delay_s else None
            while not rule._unwedge.is_set():
                if cap is not None and time.perf_counter() >= cap:
                    break
                await asyncio.sleep(0.02)
        else:
            raise InjectedFaultError(site, rule.code)


# ------------------------------------------------------- process-global API

_GLOBAL = FaultInjector()
_ACTIVE = False  # fast-path gate: one bool read when no faults configured


def _set_active(value: bool) -> None:
    global _ACTIVE
    _ACTIVE = value


def get() -> FaultInjector:
    return _GLOBAL


def active() -> bool:
    return _ACTIVE


def fire(site: str, key: str | None = None) -> None:
    if _ACTIVE:
        _GLOBAL.fire(site, key)


async def fire_async(site: str, key: str | None = None) -> None:
    if _ACTIVE:
        await _GLOBAL.fire_async(site, key)


def reset(seed: int | None = None) -> None:
    _GLOBAL.reset(seed)


def configure_from_env(env: str = "DTS_TPU_FAULTS") -> int:
    """Install rules from the env spec (see module docstring); returns the
    number installed. A malformed spec raises — a chaos run with a typo'd
    rule set must not silently run fault-free."""
    spec = os.environ.get(env, "").strip()
    if not spec:
        return 0
    _GLOBAL.seed = int(os.environ.get("DTS_TPU_FAULT_SEED", "0"))
    n = 0
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        head, _, tail = part.partition(",")
        site, sep, kind = head.partition("=")
        if not sep:
            raise ValueError(f"{env}: rule {part!r} needs site=kind")
        kwargs: dict = {}
        for kv in filter(None, (s.strip() for s in tail.split(","))):
            k, sep, v = kv.partition("=")
            if not sep:
                raise ValueError(f"{env}: bad option {kv!r} in {part!r}")
            if k == "rate":
                kwargs["rate"] = float(v)
            elif k == "delay":
                kwargs["delay_s"] = float(v)
            elif k == "code":
                kwargs["code"] = v
            elif k == "count":
                kwargs["count"] = int(v)
            elif k == "key":
                kwargs["key"] = v
            else:
                raise ValueError(f"{env}: unknown option {k!r} in {part!r}")
        _GLOBAL.add(site.strip(), kind.strip(), **kwargs)
        n += 1
    return n


if os.environ.get("DTS_TPU_FAULTS"):
    configure_from_env()
