"""Elastic mesh serving: pressure-driven data/model parallelism resizing
with hitless switching.

The [mesh] mode serves ONE static ("data", "model") split chosen at build
time, but the overload plane measures when that choice is wrong: under
saturating load a model-parallel split wastes devices a data-parallel split
would turn into throughput, and at low load the trade reverses for latency.
This module makes the split a runtime variable:

- **ElasticMeshExecutor**: a DynamicBatcher run_fn holding one
  ShardedExecutor per configured split (e.g. {4,1}, {2,2}, {1,4} over the
  SAME devices). Every dispatch routes to the CURRENT split; warmup places
  every split's params, so a switch never pays a placement on the serving
  path.

- **Hitless switching.** `switch_split` flips the routing pointer: new
  dispatches go to the target split at once while batches already in
  flight on the old split drain to completion. The per-split in-flight
  accounting (an issue token minted per batch in ``__call__``, closed by the
  batcher's completer through ``note_complete``) IS the drain barrier: a
  further switch is refused until the previous drain closes, and the drain
  duration is recorded in the switch history ring.

- **ElasticController**: the decision loop. The overload plane's
  NOMINAL/BROWNOUT/SHED pressure plus a queue-depth / batch-occupancy EWMA
  drive one-rung moves along the ladder (pressure -> toward the
  data-parallel / throughput end; sustained low load -> toward the
  model-parallel / latency end), with consecutive-tick thresholds, a
  hysteresis band between the load thresholds, and a dwell floor. No
  background thread: the controller ticks from the executor's dispatch
  path and from snapshot(), so an injected clock makes every trajectory
  deterministic under test.

Off by default ([elastic] enabled = false); the plane arms only on top of
[mesh] (build_stack refuses it otherwise). Surfaces: the `elastic` block
inside mesh_stats() / /meshz / /monitoring and the dts_tpu_elastic_*
Prometheus series. Host logic only: it launches nothing itself.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable

# Split ordering: the ladder is sorted THROUGHPUT end first (most
# data-parallel = model_parallel ascending). "up" = toward index 0
# (throughput), "down" = toward the model-parallel/latency end.
UP, DOWN = "up", "down"


def parse_split(value) -> tuple[int, int]:
    """"4x2" / (4, 2) -> (data, model). Raises ValueError on anything
    else — a typo'd ladder must fail at config time, not at switch time."""
    if isinstance(value, (tuple, list)) and len(value) == 2:
        d, m = value
    else:
        text = str(value).strip().lower()
        d, sep, m = text.partition("x")
        if not sep:
            raise ValueError(
                f"elastic split {value!r} is not of the form 'DATAxMODEL' "
                "(e.g. '4x2')"
            )
    try:
        d, m = int(d), int(m)
    except (TypeError, ValueError) as e:
        raise ValueError(f"elastic split {value!r}: {e}") from e
    if d < 1 or m < 1:
        raise ValueError(f"elastic split {value!r}: axes must be >= 1")
    return d, m


def format_split(split: tuple[int, int]) -> str:
    return f"{split[0]}x{split[1]}"


def resolve_ladder(
    splits, n_devices: int, initial: tuple[int, int]
) -> list[tuple[int, int]]:
    """Normalize a configured ladder (or derive a default one) against the
    device count: every split must factorize exactly n_devices (the ladder
    re-factorizes the SAME devices, it never resizes the mesh), the initial
    [mesh] split must be a rung (it is where serving starts), and the
    result is sorted throughput-first. An empty `splits` derives
    {n,1} / {n/2,2} / the initial split: {8,1}, {4,2}, {2,4} over eight
    devices."""
    if splits:
        ladder = {parse_split(s) for s in splits}
    else:
        ladder = {(n_devices, 1), initial}
        if n_devices % 2 == 0:
            ladder.add((n_devices // 2, 2))
    ladder.add(initial)
    for d, m in sorted(ladder):
        if d * m != n_devices:
            raise ValueError(
                f"elastic split {format_split((d, m))} does not factorize "
                f"{n_devices} devices (the ladder re-shapes the same "
                "chips; data*model must equal the mesh device count)"
            )
    out = sorted(ladder, key=lambda s: (s[1], -s[0]))
    if len(out) < 2:
        raise ValueError(
            "elastic needs >= 2 distinct splits to switch between "
            f"(resolved ladder {[format_split(s) for s in out]}); add "
            "[elastic] splits or use a device count with more than one "
            "factorization"
        )
    return out


class ElasticMeshExecutor:
    """run_fn for DynamicBatcher routing each batch to the current split's
    ShardedExecutor, with per-split in-flight accounting as the switch
    drain barrier.

    Completion protocol (the batcher side lives in _run_stage / _finish):
    ``__call__`` registers the batch against the split it routed to and
    leaves an issue token in thread-local state; the batcher pops it with
    ``take_issue_token()`` right after the dispatch returns (same thread,
    synchronous) and hands it to the completer, whose finally calls
    ``note_complete(token)`` once the readback finished — the exact
    lifetime the batcher's own per-bucket in-flight accounting covers, so
    "the old split drained" means what pipeline_stats means by it.
    """

    supports_out_keys = True
    # The batcher's elastic protocol gate: take_issue_token after dispatch,
    # note_complete from the completer, warmup_call warming EVERY split.
    elastic = True

    def __init__(
        self,
        splits,
        initial,
        devices=None,
        compress_transfer: bool = True,
        tensor_parallel: bool = False,
        output_wire_dtype: str = "float32",
        history_events: int = 64,
        clock: Callable[[], float] = time.monotonic,
        executors: dict | None = None,
    ):
        parsed = [parse_split(s) for s in splits]
        if len(set(parsed)) != len(parsed):
            raise ValueError("elastic ladder holds duplicate splits")
        # Pin the throughput-first ordering HERE, where the controller's
        # rung arithmetic consumes it ("up" = toward index 0): a caller
        # passing an unsorted ladder must not get inverted switch
        # directions.
        self.splits: list[tuple[int, int]] = sorted(
            parsed, key=lambda s: (s[1], -s[0])
        )
        initial = parse_split(initial)
        if initial not in self.splits:
            raise ValueError(
                f"initial split {format_split(initial)} is not in the "
                f"ladder {[format_split(s) for s in self.splits]}"
            )
        self._clock = clock
        if executors is not None:
            # Test injection: any mapping split -> run_fn-like callable.
            self._executors = dict(executors)
        else:
            from .executor import ShardedExecutor
            from .mesh import make_mesh

            self._executors = {}
            for d, m in self.splits:
                mesh = make_mesh(d * m, model_parallel=m, devices=devices)
                self._executors[(d, m)] = ShardedExecutor(
                    mesh,
                    compress_transfer=compress_transfer,
                    tensor_parallel=tensor_parallel,
                    output_wire_dtype=output_wire_dtype,
                )
        missing = [s for s in self.splits if s not in self._executors]
        if missing:
            raise ValueError(f"no executor for splits {missing}")
        # The initial split's mesh doubles as the stack's `mesh`; each
        # split's executor places its own copy of the params lazily (warmup
        # does it at load time). Blocks on one device share storage, so on
        # a single card the ladder costs no second copy.
        self.mesh = getattr(self._executors[initial], "mesh", None)
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._current = initial
        # In-flight EPOCH: clear_for_recovery() bumps it, so a STRANDED
        # pre-recovery completer (its batch was captured and replayed)
        # whose finally fires note_complete later cannot decrement the
        # post-recovery registrations — without this, one stray close
        # could release the drain barrier while a new batch is still in
        # flight on the old split.
        self._epoch = 0
        self._inflight = {s: 0 for s in self.splits}
        self._batches = {s: 0 for s in self.splits}
        self._rows = {s: 0 for s in self.splits}
        # Switch drain barrier: the split still draining after the last
        # switch (None = no drain open). A new switch is refused while
        # open — the controller counts the hold and retries next tick.
        self._pending_from: tuple[int, int] | None = None
        self._switch_t0 = 0.0
        self.history: deque = deque(maxlen=max(int(history_events), 1))
        self.switches_up = 0
        self.switches_down = 0
        self.switches_refused_drain = 0
        self.last_drain_s: float | None = None
        # ElasticController attaches itself here; ticked once per dispatch.
        self.controller = None

    # ------------------------------------------------------------- routing

    @property
    def current_split(self) -> tuple[int, int]:
        return self._current

    @property
    def drain_pending(self) -> bool:
        return self._pending_from is not None

    def __call__(self, servable, arrays, out_keys=None):
        rows = next(iter(arrays.values())).shape[0]
        ctrl = self.controller
        if ctrl is not None:
            # Occupancy feed + opportunistic decision tick BEFORE routing,
            # so this very batch can ride a fresh switch (interval-gated).
            ctrl.note_batch(rows)
            ctrl.maybe_tick()
        with self._lock:
            split = self._current
            token = (split, self._epoch)
            self._inflight[split] += 1
            self._batches[split] += 1
            self._rows[split] += rows
        self._tls.token = token
        try:
            return self._executors[split](servable, arrays, out_keys=out_keys)
        except BaseException:
            # A dispatch that never returned outputs is not in flight:
            # close its registration here so the batcher's failure path
            # (which only completes MINTED tokens) cannot strand the
            # drain barrier.
            self._tls.token = None
            with self._lock:
                self._dec_locked(token)
            raise

    def take_issue_token(self):
        """Pop the (split, epoch) token of the JUST-dispatched batch
        (same-thread, called by the batcher right after __call__
        returns). None when no dispatch minted a token on this thread."""
        token = getattr(self._tls, "token", None)
        self._tls.token = None
        return token

    def note_complete(self, token) -> None:
        """Close one batch's in-flight registration (the completer's
        finally — readback done, or the failure path). A token from a
        PREVIOUS epoch (its batch was captured by a recovery cycle and
        the accounting reset; the stranded completer reports in late) is
        a no-op — it must not decrement a post-recovery batch's
        registration."""
        with self._lock:
            self._dec_locked(token)

    def _dec_locked(self, token) -> None:
        split, epoch = token
        if epoch != self._epoch:
            return  # pre-recovery stragglers close against a dead epoch
        n = self._inflight.get(split, 0)
        if n > 0:
            self._inflight[split] = n - 1
        if (
            self._pending_from is not None
            and self._inflight.get(self._pending_from, 0) == 0
        ):
            # The old split drained: the switch is COMPLETE. Record the
            # drain time on the history entry that opened it.
            self.last_drain_s = self._clock() - self._switch_t0
            if self.history:
                self.history[-1]["drain_s"] = round(self.last_drain_s, 6)
            self._pending_from = None

    # ----------------------------------------------------------- switching

    def switch_split(self, target, reason: str = "manual") -> bool:
        """Route new dispatches to `target` (hitless: in-flight old-split
        batches drain to completion behind the barrier). False when the
        switch cannot happen now: already current, unknown split, or the
        PREVIOUS switch's drain is still open (one drain at a time keeps
        "which split is draining" a single answer)."""
        target = parse_split(target)
        if target not in self._executors:
            raise ValueError(
                f"unknown split {format_split(target)}; ladder "
                f"{[format_split(s) for s in self.splits]}"
            )
        with self._lock:
            if target == self._current:
                return False
            if self._pending_from is not None:
                self.switches_refused_drain += 1
                return False
            old = self._current
            self._current = target
            direction = (
                UP if self.splits.index(target) < self.splits.index(old)
                else DOWN
            )
            if direction == UP:
                self.switches_up += 1
            else:
                self.switches_down += 1
            self._switch_t0 = self._clock()
            entry = {
                "t": self._switch_t0,
                "from": format_split(old),
                "to": format_split(target),
                "direction": direction,
                "reason": reason,
                "drained_behind": self._inflight.get(old, 0),
                "drain_s": None,
            }
            self.history.append(entry)
            if self._inflight.get(old, 0) > 0:
                self._pending_from = old
            else:
                self.last_drain_s = 0.0
                entry["drain_s"] = 0.0
            return True

    # ------------------------------------------------------------- warmup

    def place(self, servable) -> None:
        """Place `servable`'s params on every split's mesh now."""
        for ex in self._executors.values():
            place = getattr(ex, "place", None)
            if place is not None:
                place(servable)

    def warmup_call(self, servable, arrays, out_keys=None):
        """Run one (already host-folded) warmup batch through EVERY
        split's executor: every rung's params are placed, and its kernels
        built, before serving starts, so a switch does no load-time work on
        the serving path. No issue tokens:
        warmup is not in-flight work. Returns the current split's outputs
        (callers treat warmup results as discardable)."""
        out = None
        for split in self.splits:
            res = self._executors[split](servable, arrays, out_keys=out_keys)
            if split == self._current:
                out = res
        return out

    # ----------------------------------------------------------- recovery

    def clear_for_recovery(self) -> None:
        """REINIT hook (serving/recovery.py): drop every split's placed
        params and entries (they reference the dead context) and reset
        the in-flight accounting — captured batches' completers are
        stranded and must not hold the drain barrier open forever. The
        recovery re-warm places every split again before replay (see
        RecoveryController._rewarm)."""
        for ex in self._executors.values():
            clear = getattr(ex, "clear_for_recovery", None)
            if clear is not None:
                clear()
        with self._lock:
            self._epoch += 1  # stranded completers close a dead epoch
            for s in self._inflight:
                self._inflight[s] = 0
            if self._pending_from is not None:
                self._pending_from = None
                self.last_drain_s = self._clock() - self._switch_t0
                if self.history:
                    self.history[-1]["drain_s"] = round(self.last_drain_s, 6)

    # ------------------------------------------------------------ snapshot

    def elastic_snapshot(self) -> dict:
        """The `elastic` surface body (inside mesh_stats()//meshz, the
        /monitoring `elastic` section, and dts_tpu_elastic_*): current
        split, ladder, per-split serve counters + live in-flight, switch
        history ring, and the controller's decision state."""
        ctrl = self.controller
        if ctrl is not None:
            ctrl.maybe_tick()  # scrapes advance the loop on idle servers
        with self._lock:
            snap = {
                "enabled": True,
                "current_split": format_split(self._current),
                "splits": [format_split(s) for s in self.splits],
                "pending_drain_from": (
                    format_split(self._pending_from)
                    if self._pending_from is not None else None
                ),
                "switches_up": self.switches_up,
                "switches_down": self.switches_down,
                "switches_refused_drain": self.switches_refused_drain,
                "last_drain_s": self.last_drain_s,
                "per_split": {
                    format_split(s): {
                        "batches": self._batches[s],
                        "rows": self._rows[s],
                        "in_flight": self._inflight[s],
                    }
                    for s in self.splits
                },
                "history": list(self.history),
            }
        if ctrl is not None:
            snap["controller"] = ctrl.snapshot()
        return snap

    def snapshot(self) -> dict:
        """mesh_stats()-shaped snapshot: the CURRENT split's geometry
        (shape/devices/layout — what the mesh dashboards read) with the
        executor serve counters AGGREGATED across every rung — the
        dts_tpu_mesh_*_total families are process-lifetime counters, and
        reading only the current rung's would jump (usually backward) on
        every switch, which Prometheus reads as a counter reset and
        rate()/increase() over-count from — plus the `elastic` block
        (which keeps the per-rung view)."""
        current = self._current
        ex = self._executors[current]
        base = ex.snapshot() if hasattr(ex, "snapshot") else {"enabled": True}
        # COUNTERS aggregate; placed_servables is a GAUGE ("servables
        # with params placed") and stays the current rung's value —
        # summing it across a warmed ladder would read N servables where
        # there is one.
        totals = {"batches": 0, "rows": 0, "pad_batches": 0,
                  "data_pad_rows": 0}
        layout: dict = {}
        for split, sub in self._executors.items():
            if split == current:
                counters = base.get("executor") or {}  # already computed
            elif hasattr(sub, "snapshot"):
                counters = sub.snapshot().get("executor") or {}
            else:
                continue
            for k in totals:
                totals[k] += int(counters.get(k, 0))
            layout.update(counters.get("layout") or {})
        if base.get("executor"):
            base["executor"] = {**base["executor"], **totals,
                                "layout": layout}
        base["elastic"] = self.elastic_snapshot()
        return base


class ElasticController:
    """The resize decision loop over one ElasticMeshExecutor.

    Signals, read per tick (interval-gated, opportunistic — dispatches
    and snapshot() drive it, no thread):

    - **pressure**: the overload plane's NOMINAL/BROWNOUT/SHED state
      (state() itself ticks that plane, and the `pressure` fault site
      pins it deterministically for tests/CI). Absent controller reads
      as NOMINAL.
    - **load EWMA**: queue fraction (queued+staged candidates /
      capacity), AMPLIFIED by the dispatched-bucket occupancy EWMA when
      the queue is non-empty — a backlog of full largest-bucket batches
      is saturation, a backlog of small ones may just be a wait-window
      artifact. An EMPTY queue always reads as its own (zero) load: a
      lone full-bucket request at a low arrival rate must not hold the
      split at the throughput end forever.

    Decision: pressure past NOMINAL or EWMA >= load_up_threshold counts
    an UP tick (toward the data-parallel/throughput end); NOMINAL and
    EWMA <= load_down_threshold counts a DOWN tick (toward the
    model-parallel/latency end); anything between resets both streaks
    (the hysteresis band). A switch fires one rung at a time after
    up_after_ticks/down_after_ticks consecutive ticks, never inside
    dwell_s of the last switch, and never while the previous switch's
    drain barrier is open.
    """

    def __init__(
        self,
        cfg,
        executor: ElasticMeshExecutor,
        overload=None,
        load_fn: Callable[[], tuple[int, int]] | None = None,
        largest_bucket: int = 0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.cfg = cfg
        self.executor = executor
        self.overload = overload
        self._load_fn = load_fn
        self._largest_bucket = max(int(largest_bucket or 0), 0)
        self._clock = clock
        self._lock = threading.Lock()
        self._last_tick = clock()
        # Dwell measured from arming: the FIRST switch also waits a full
        # dwell, so a cold server cannot flap before its signals settle.
        self._last_switch = clock()
        self._ewma_load: float | None = None
        self._occ_ewma: float | None = None
        self._up_streak = 0
        self._down_streak = 0
        self._last_pressure = "nominal"
        self.ticks = 0
        self.holds_dwell = 0
        self.holds_drain = 0
        executor.controller = self

    # --------------------------------------------------------------- feeds

    def note_batch(self, rows: int) -> None:
        """Dispatch-side occupancy feed (called by the executor path via
        maybe_tick's caller — rows is the padded bucket size): bucket /
        largest-bucket is the saturation proxy the queue term misses
        when the pipeline drains the queue as fast as it fills."""
        if self._largest_bucket <= 0 or rows <= 0:
            return
        frac = min(rows / self._largest_bucket, 1.0)
        alpha = float(getattr(self.cfg, "load_ewma_alpha", 0.3))
        with self._lock:
            self._occ_ewma = (
                frac if self._occ_ewma is None
                else (1 - alpha) * self._occ_ewma + alpha * frac
            )

    # ---------------------------------------------------------------- tick

    def maybe_tick(self) -> None:
        now = self._clock()
        if now - self._last_tick < float(
            getattr(self.cfg, "tick_interval_s", 0.5)
        ):
            return
        with self._lock:
            if now - self._last_tick < float(
                getattr(self.cfg, "tick_interval_s", 0.5)
            ):
                return
            self._last_tick = now
            self._tick_locked(now)

    def _tick_locked(self, now: float) -> None:
        cfg = self.cfg
        self.ticks += 1
        # Queue-depth term.
        qfrac = 0.0
        if self._load_fn is not None:
            try:
                queued, capacity = self._load_fn()
                qfrac = queued / max(int(capacity), 1)
            except Exception:  # noqa: BLE001 — a signal, never a failure
                qfrac = 0.0
        # Occupancy amplifies a NON-EMPTY queue (backlog of full buckets
        # = saturation); an empty queue is idle whatever the last batch's
        # size was — otherwise one full-bucket request per second would
        # pin the split at the throughput end forever.
        load = max(qfrac, self._occ_ewma or 0.0) if qfrac > 0 else qfrac
        alpha = float(getattr(cfg, "load_ewma_alpha", 0.3))
        self._ewma_load = (
            load if self._ewma_load is None
            else (1 - alpha) * self._ewma_load + alpha * load
        )
        pressure = "nominal"
        ov = self.overload
        if ov is not None:
            try:
                pressure = ov.state()
            except Exception:  # noqa: BLE001 — a signal, never a failure
                pressure = "nominal"
        self._last_pressure = pressure
        up_thresh = float(getattr(cfg, "load_up_threshold", 0.75))
        down_thresh = float(getattr(cfg, "load_down_threshold", 0.20))
        want_up = pressure != "nominal" or self._ewma_load >= up_thresh
        want_down = pressure == "nominal" and self._ewma_load <= down_thresh
        if want_up:
            self._up_streak += 1
            self._down_streak = 0
        elif want_down:
            self._down_streak += 1
            self._up_streak = 0
        else:
            # Hysteresis band: neither signal earns a streak — the split
            # holds where it is.
            self._up_streak = 0
            self._down_streak = 0
        ex = self.executor
        ladder = ex.splits
        cur_i = ladder.index(ex.current_split)
        target = None
        direction = None
        if (
            self._up_streak >= int(getattr(cfg, "up_after_ticks", 2))
            and cur_i > 0
        ):
            target, direction = ladder[cur_i - 1], UP
        elif (
            self._down_streak >= int(getattr(cfg, "down_after_ticks", 6))
            and cur_i < len(ladder) - 1
        ):
            target, direction = ladder[cur_i + 1], DOWN
        if target is None:
            return
        if now - self._last_switch < float(getattr(cfg, "dwell_s", 5.0)):
            self.holds_dwell += 1
            return
        if ex.drain_pending:
            self.holds_drain += 1
            return
        reason = (
            f"pressure={pressure} load_ewma={self._ewma_load:.3f} "
            f"{direction} after {self._up_streak or self._down_streak} ticks"
        )
        if ex.switch_split(target, reason=reason):
            self._last_switch = now
            self._up_streak = 0
            self._down_streak = 0

    # ------------------------------------------------------------ snapshot

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "ticks": self.ticks,
                "pressure": self._last_pressure,
                "load_ewma": (
                    round(self._ewma_load, 4)
                    if self._ewma_load is not None else None
                ),
                "occupancy_ewma": (
                    round(self._occ_ewma, 4)
                    if self._occ_ewma is not None else None
                ),
                "up_streak": self._up_streak,
                "down_streak": self._down_streak,
                "holds_dwell": self.holds_dwell,
                "holds_drain": self.holds_drain,
                "dwell_s": float(getattr(self.cfg, "dwell_s", 5.0)),
                "load_up_threshold": float(
                    getattr(self.cfg, "load_up_threshold", 0.75)
                ),
                "load_down_threshold": float(
                    getattr(self.cfg, "load_down_threshold", 0.20)
                ),
            }
