"""End-to-end data-integrity plane (the JAX package's
serving/integrity.py, the same behaviour line for line).

Silent corruption — a flipped bit on the wire, a bad device-to-host copy,
a unit that miscomputes one lane — serves with status OK, where every
other plane detects only loud failures. Three detection layers:

1. **Wire integrity** — CRC32C sidecars (codec.crc_sidecar) over tensor
   bytes in gRPC metadata, both ways. The server verifies
   ``x-dts-input-crc`` at decode and fails only the corrupted request
   (INVALID_ARGUMENT, ``corrupt-wire`` in the detail), never the batch it
   would have joined; it stamps ``x-dts-score-crc`` trailing metadata that
   a client may verify before it merges.

2. **Readback screen** — after the readback, the batcher's completion
   worker checks each request's score rows for NaN/Inf (and an optional
   plausible range). A failing request fails alone (IntegrityScreenError,
   UNAVAILABLE) while its batchmates deliver. Trips past
   ``screen_trips_per_window`` escalate: the replica marks itself
   suspect and, with the recovery plane armed, a cycle starts (trigger
   ``output_corrupt``) to reinit the executor before the next batch.

3. **Shadow verification** — a sampled fraction of batches runs a second
   time through the same entry (the same servable, bucket and kernel
   variant: on the card the same hand-written CUDA kernel at the same
   cluster size), and the two raw readbacks are compared bit for bit. The
   kernels are deterministic per (kernel, dtype, bucket, cluster size), so
   any divergence is miscomputation or readback corruption: the batch
   fails (OutputCorruptError), or with the recovery plane armed is
   replayed by a cycle (trigger ``output_corrupt``), and the replica is
   marked suspect until ``suspect_clear_passes`` clean compares.

Off by default: every hook then costs one attribute read. State is
process-local and lock-guarded; hooks are called from the batcher's
threads, the transports and the REST thread.
"""

from __future__ import annotations

import threading
import time
from collections import deque

import numpy as np

from .. import codec

__all__ = [
    "IntegrityPlane",
    "IntegrityScreenError",
    "OutputCorruptError",
]


class OutputCorruptError(RuntimeError):
    """The executor's outputs can no longer be trusted: shadow
    re-execution diverged bit for bit, or readback screens tripped past
    threshold. The marker attribute is what the recovery plane keys its
    ``output_corrupt`` cycle on (serving/recovery.py device_fatal); with
    the plane off the batch fails with it (UNAVAILABLE at the RPC
    layer)."""

    integrity_corrupt = True


class IntegrityScreenError(RuntimeError):
    """One delivered row failed the post-readback sanity screen (NaN/Inf
    or out of the configured plausible range). Scoped to the single
    request that owns the row — batchmates deliver normally. Translates
    to UNAVAILABLE so a resilient client retries/fails over.

    The message never names a fatal device status: this error is per-row
    by design and must not read as a dead device.
    """


class IntegrityPlane:
    """State + policy for the three detection layers of one server.

    Collaborators are late-bound: the batcher reads ``batcher.integrity``,
    the service impl reads ``impl.integrity``, the transports reach the
    plane through the impl. A fake clock makes the screen-trip window
    testable without sleeps.
    """

    def __init__(self, config, clock=time.monotonic):
        self.config = config
        self._clock = clock
        self._lock = threading.Lock()
        # Shadow sampler: deterministic fraction accumulator (no RNG —
        # the same traffic always samples the same batches) plus an
        # on-demand audit counter fed by POST /integrityz/audit.
        self._acc = 0.0
        self._pending_audits = 0
        # Counters (monotonic; Prometheus reads them off snapshot()).
        self.wire_verified = 0
        self.wire_rejected = 0
        self.responses_stamped = 0
        self.screen_trips = 0
        self.shadow_batches = 0
        self.shadow_mismatches = 0
        self.audits_requested = 0
        self.audits_run = 0
        self.escalations = 0
        # Suspect verdict (the JAX package gossips it in the fleet record);
        # cleared after `suspect_clear_passes` consecutive clean shadow
        # comparisons (evidence the data path computes correctly again).
        self.suspect = False
        self.suspect_reason: str | None = None
        self._clean_passes = 0
        # Screen-trip timestamps inside the sliding window.
        self._trips: deque[float] = deque()
        self._events: deque[dict] = deque(
            maxlen=max(int(getattr(config, "history_events", 64)), 8)
        )

    # -------------------------------------------------------------- events

    def _event(self, kind: str, **detail) -> None:
        self._events.append({"t": self._clock(), "kind": kind, **detail})

    # -------------------------------------------- layer 1: wire checksums

    def verify_inputs(self, arrays: dict, sidecar: str, bf16=()) -> list[str]:
        """Server-side request verify: decoded input arrays against the
        client's ``x-dts-input-crc`` stamp. Returns the mismatched names
        (empty = clean); a malformed sidecar IS a mismatch. The caller
        fails only the one request that carried the stamp. `bf16` names
        the inputs decoded from DT_BFLOAT16 (widened to float32): those are
        checked over the bits the wire carried."""
        try:
            bad = codec.verify_crc_sidecar(arrays, sidecar, bf16)
        except codec.CodecError as e:
            bad = [f"sidecar: {e}"]
        with self._lock:
            if bad:
                self.wire_rejected += 1
                self._event("wire_reject", names=list(bad))
            else:
                self.wire_verified += 1
        return bad

    def response_sidecar(self, outputs_map) -> str | None:
        """Server-side response stamp: CRC every output tensor in the
        encoded response (the client checks the same decoded-ndarray
        canonical form, so tensor_content / repeated fields / the int8
        score wire all verify identically). None when nothing encodes —
        stamping is advisory and must never fail a good response."""
        try:
            decoded = {
                name: codec.to_ndarray(tp)
                for name, tp in outputs_map.items()
            }
            sidecar = codec.crc_sidecar(decoded)
        except Exception:  # noqa: BLE001 — advisory stamp
            return None
        if not sidecar:
            return None
        with self._lock:
            self.responses_stamped += 1
        return sidecar

    # ------------------------------------------ layer 2: readback screens

    def screen_reason(self, row: np.ndarray) -> str | None:
        """Why one delivered row fails the sanity screen, or None. Only
        float outputs can carry NaN/Inf; the range check is opt-in
        ((0, 0) disables it — scores are model-specific)."""
        if row.dtype.kind != "f":
            return None
        if not np.isfinite(row).all():
            return "non-finite score (nan/inf) after readback"
        lo, hi = self.config.screen_min, self.config.screen_max
        if (lo, hi) != (0.0, 0.0) and row.size:
            mn, mx = float(row.min()), float(row.max())
            if mn < lo or mx > hi:
                return (
                    f"score outside plausible range [{lo}, {hi}]: "
                    f"observed [{mn:.6g}, {mx:.6g}]"
                )
        return None

    def note_screen_trip(self, reason: str) -> None:
        with self._lock:
            self.screen_trips += 1
            self._trips.append(self._clock())
            self._event("screen_trip", reason=reason)

    def screen_escalation_due(self) -> bool:
        """True when trips inside the sliding window crossed the
        threshold; consumes the window so one burst escalates once."""
        with self._lock:
            now = self._clock()
            horizon = now - self.config.screen_window_s
            while self._trips and self._trips[0] < horizon:
                self._trips.popleft()
            if len(self._trips) < self.config.screen_trips_per_window:
                return False
            self._trips.clear()
            return True

    def maybe_escalate_screen(self, recovery) -> bool:
        """Post-delivery hook: when the trip window overflowed, mark
        suspect and, with a recovery plane (the batcher's, or None), request
        a cycle. The empty group is deliberate — the tripped rows already
        failed individually; the cycle exists to reinit the executor before
        the next batch."""
        if not self.screen_escalation_due():
            return False
        self._escalate("screen trips crossed threshold")
        if recovery is not None:
            recovery.take_group([], OutputCorruptError(
                "readback screen trips crossed "
                f"{self.config.screen_trips_per_window}/"
                f"{self.config.screen_window_s:g}s — executor output "
                "path no longer trusted"
            ))
        return True

    # --------------------------------------- layer 3: shadow verification

    def request_audit(self, batches: int = 1) -> int:
        """POST /integrityz/audit: force the next `batches` eligible
        batches through shadow verification regardless of
        shadow_fraction. Returns the number of audits now pending."""
        with self._lock:
            self.audits_requested += batches
            self._pending_audits += batches
            self._event(f"audit_requested x{batches}")
            return self._pending_audits

    def want_shadow(self) -> bool:
        """Dispatch-side sampler. Pending audits fire first; otherwise a
        deterministic accumulator realizes shadow_fraction exactly (one
        shadow per 1/fraction batches, no RNG)."""
        with self._lock:
            if self._pending_audits > 0:
                self._pending_audits -= 1
                self.audits_run += 1
                return True
            f = self.config.shadow_fraction
            if f <= 0.0:
                return False
            self._acc += f
            if self._acc >= 1.0:
                self._acc -= 1.0
                return True
            return False

    def shadow_compare(self, primary, shadow) -> None:
        """Bit-identity compare of two host output lists from the same
        entry over the same inputs. Raises OutputCorruptError on
        ANY divergence (shape, dtype, or payload byte); a clean pass
        counts toward suspect rehabilitation."""
        mismatch = None
        if len(primary) != len(shadow):
            mismatch = (
                f"output arity diverged: {len(primary)} vs {len(shadow)}"
            )
        else:
            for i, (a, b) in enumerate(zip(primary, shadow)):
                a = np.ascontiguousarray(a)
                b = np.ascontiguousarray(b)
                if a.dtype != b.dtype or a.shape != b.shape:
                    mismatch = (
                        f"output {i} meta diverged: "
                        f"{a.dtype}{a.shape} vs {b.dtype}{b.shape}"
                    )
                    break
                if a.tobytes() != b.tobytes():
                    mismatch = f"output {i} bytes diverged"
                    break
        with self._lock:
            self.shadow_batches += 1
        if mismatch is None:
            self._note_clean_shadow()
            return
        with self._lock:
            self.shadow_mismatches += 1
            self._event("shadow_mismatch", detail=mismatch)
        self._escalate(f"shadow mismatch: {mismatch}")
        raise OutputCorruptError(
            "integrity shadow verification mismatch — same program, same "
            f"inputs, different bits ({mismatch}); capturing batch for "
            "replay"
        )

    # ------------------------------------------------------ suspect state

    def _escalate(self, reason: str) -> None:
        with self._lock:
            self.escalations += 1
            self.suspect = True
            self.suspect_reason = reason
            self._clean_passes = 0
            self._event("escalation", reason=reason)

    def _note_clean_shadow(self) -> None:
        with self._lock:
            if not self.suspect:
                return
            self._clean_passes += 1
            if self._clean_passes >= self.config.suspect_clear_passes:
                self.suspect = False
                self.suspect_reason = None
                self._clean_passes = 0
                self._event("suspect_cleared")

    # ---------------------------------------------------------- reporting

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "enabled": True,
                "suspect": self.suspect,
                "suspect_reason": self.suspect_reason,
                "clean_passes": self._clean_passes,
                "wire": {
                    "enabled": bool(self.config.wire_checksums),
                    "inputs_verified": self.wire_verified,
                    "inputs_rejected": self.wire_rejected,
                    "responses_stamped": self.responses_stamped,
                },
                "screen": {
                    "enabled": bool(self.config.screen),
                    "trips": self.screen_trips,
                    "window_trips": len(self._trips),
                    "trips_per_window": self.config.screen_trips_per_window,
                    "window_s": self.config.screen_window_s,
                },
                "shadow": {
                    "fraction": self.config.shadow_fraction,
                    "batches": self.shadow_batches,
                    "mismatches": self.shadow_mismatches,
                    "audits_requested": self.audits_requested,
                    "audits_run": self.audits_run,
                    "audits_pending": self._pending_audits,
                },
                "escalations": self.escalations,
                "events": list(self._events),
            }
