"""Per-bucket kernel-variant autotune: no execution variant serves live
traffic unless it measured faster than the baseline on THIS device at THIS
bucket and passed the accuracy gates.

Variants per (servable, bucket), each run through the batcher's own
`_execute` (so measurement and serving share one code path). The names are
the JAX package's table vocabulary:

  - xla_f32 (baseline): model.apply on the float params
  - xla_int8:           model.apply on ops/quantize.py int8 weight-only params
  - pallas_f32:         the fused serve kernel (ops/cross_kernel.py), float
  - pallas_int8:        the fused serve kernel with int8 weight operands

Gates ([kernels] section): measured speedup >= min_speedup AND max |dscore|
vs the float baseline <= max_abs_delta AND, when labeled eval data is
supplied, |AUC_f32 - AUC_variant| <= auc_margin. A variant that misses a
gate is recorded with its reason and left disabled; measure_only records
everything and enables nothing. The per-bucket decision is the fastest
enabled variant. The fused variants need the card: on a CPU device they
are recorded as ineligible, and on the card a fused variant that fails to
build or launch raises (the kernel has no fallback), where a failing
xla_int8 is recorded and left disabled.

The decision table persists to `table_file`, keyed by (model, version,
params digest, device name, gate fingerprint, bucket set), so a restart
adopts its own measurements instead of re-tuning; live decisions are
identity-guarded per tuned Servable object.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
import time
import weakref

import numpy as np
import torch

log = logging.getLogger("dts_torch.kernels")

BASELINE = "xla_f32"
XLA_INT8 = "xla_int8"
PALLAS_F32 = "pallas_f32"
PALLAS_INT8 = "pallas_int8"
VARIANTS = (XLA_INT8, PALLAS_F32, PALLAS_INT8)

# name -> (quantized, fused)
VARIANT_FLAGS = {
    BASELINE: (False, False),
    XLA_INT8: (True, False),
    PALLAS_F32: (False, True),
    PALLAS_INT8: (True, True),
}

CPU_REASON = "the CUDA kernels have no CPU mode"


def device_kind(device) -> str:
    """The table's device label: the card's name, or the device type."""
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type


def _sync(device) -> None:
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def params_digest(params) -> str:
    """Cheap, deterministic digest of a param tree's weights (path + shape
    + dtype + the first and last 64 bytes of each leaf): the persisted
    table's staleness guard. Equal to the JAX package's digest of the same
    weights."""
    h = hashlib.blake2b(digest_size=16)

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}/{k}")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}[{i}]")
        else:
            if isinstance(node, torch.Tensor):
                t = node.detach().cpu()
                if t.dtype == torch.bfloat16:  # numpy has no bf16: hash its bits
                    arr, dtype = t.view(torch.int16).numpy(), "bfloat16"
                else:
                    arr = t.numpy()
                    dtype = str(arr.dtype)
            else:
                arr = np.asarray(node)
                dtype = str(arr.dtype)
            h.update(path.encode())
            h.update(str(arr.shape).encode())
            h.update(dtype.encode())
            raw = np.ascontiguousarray(arr).view(np.uint8).ravel()
            h.update(raw[:64].tobytes())
            h.update(raw[-64:].tobytes())

    walk(params, "")
    return h.hexdigest()


class KernelManager:
    """The per-bucket variant router + autotune the batcher holds as
    `batcher.kernels` (None when the plane is off).

    Fast path: decision(servable, bucket) is a dict probe under no lock
    (the decisions dict is replaced whole, never mutated in place)."""

    def __init__(self, config, clock=time.perf_counter):
        self.config = config
        self._clock = clock
        self._lock = threading.Lock()
        # (model_name, version) -> (weakref to the tuned Servable,
        # {bucket: (quantized, fused)}). decision() answers only for the
        # exact Servable object an entry was tuned for.
        self._decisions: dict[tuple[str, int], tuple] = {}
        # (model_name, version) -> the full measured table.
        self._tables: dict[tuple[str, int], dict] = {}
        self._qparams: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()
        # servable -> (params identity, {quantized: apply_fn})
        self._fused: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()
        self.autotunes = 0
        self.table_saves = 0
        self.table_reuses = 0
        self.quantized_batches = 0
        self.pallas_batches = 0
        # The batcher whose _execute tunes and warms (set by prepare() and
        # autotune()); its device names the table.
        self._batcher = None

    # ------------------------------------------------------------ fast path

    def decision(self, servable, bucket: int) -> tuple[bool, bool] | None:
        """(quantized, fused) for this (servable, bucket), or None for the
        baseline. Counters move here."""
        entry = self._decisions.get((servable.name, servable.version))
        if entry is None or entry[0]() is not servable:
            return None
        dec = entry[1].get(int(bucket))
        if dec is None:
            return None
        if dec[0]:
            self.quantized_batches += 1
        if dec[1]:
            self.pallas_batches += 1
        return dec

    def params_for(self, servable, quantized: bool):
        """The servable's params in the requested precision; the int8 tree
        is minted once per servable and cached under a weak key."""
        if not quantized:
            return servable.params
        with self._lock:
            entry = self._qparams.get(servable)
            if entry is None or entry[0] is not servable.params:
                from .quantize import quantize_params

                entry = (servable.params, quantize_params(servable.params))
                self._qparams[servable] = entry
        return entry[1]

    def pallas_apply_for(self, servable, quantized: bool):
        """The fused serve callable for this servable (built once per
        (servable, precision); rebuilt when its params are swapped). The
        batcher asks for the float one only when its own device step is not
        already the fused kernel."""
        from .cross_kernel import build_fused_serve

        # Resolve the params BEFORE taking the lock: params_for takes the
        # same non-reentrant lock.
        params = self.params_for(servable, quantized)
        with self._lock:
            entry = self._fused.get(servable)
            if entry is None or entry[0] is not servable.params:
                entry = (servable.params, {})
                self._fused[servable] = entry
            fn = entry[1].get(quantized)
            if fn is None:
                fn = entry[1][quantized] = build_fused_serve(params, servable.model.config)
        return fn

    # ------------------------------------------------------------- autotune

    def _device(self):
        return self._batcher.device if self._batcher is not None else torch.device("cpu")

    def _fused_eligible(self, servable, arrays) -> tuple[bool, str]:
        from .cross_kernel import serve_fits_smem, serve_params_supported

        model = servable.model
        cfg = model.config
        if not model.folds_ids_on_host:
            return False, "model input contract (raw ids)"
        if set(arrays) != {"feat_ids", "feat_wts"}:
            return False, "inputs beyond feat_ids/feat_wts"
        if not serve_params_supported(servable.params):
            return False, "param tree is not dcn_v2-shaped"
        mlp_dims = tuple(p.get("qw", p.get("w")).shape[1] for p in servable.params["mlp"])
        if not serve_fits_smem(cfg.num_fields * cfg.embed_dim, mlp_dims, cfg.cdtype):
            return False, "over the shared-memory budget of one block"
        if self._device().type != "cuda":
            return False, CPU_REASON
        return True, ""

    @staticmethod
    def _tune_arrays(batcher, servable, bucket: int, seed: int = 7) -> dict:
        """A representative random batch with warmup_arrays' geometry
        (random ids exercise real gather addresses)."""
        rng = np.random.RandomState(seed + bucket)
        arrays = {}
        for k, v in batcher.warmup_arrays(servable, bucket).items():
            if np.issubdtype(v.dtype, np.integer):
                arrays[k] = rng.randint(0, 1 << 40, size=v.shape).astype(v.dtype)
            else:
                arrays[k] = rng.rand(*v.shape).astype(v.dtype)
        return arrays

    @staticmethod
    def _failure(name: str, where: str, exc: Exception) -> str:
        """The recorded error of a failing variant. A fused variant runs the
        CUDA kernel, which has no fallback: its failure is raised, never
        recorded as a disabled variant."""
        if VARIANT_FLAGS[name][1]:
            raise RuntimeError(f"kernel variant {name} failed ({where})") from exc
        return f"{type(exc).__name__}: {exc}"[:300]

    @staticmethod
    def _scores_of(batcher, servable, arrays, override) -> np.ndarray:
        """The variant's scores for the |dscore| gate, as float32 on the
        host: `_execute` reads back through the batcher's readback wire and
        restores it (ops/transfer.py restore_outputs_host) before they are
        compared."""
        key = servable.model.score_output
        out = batcher._execute(servable, dict(arrays), (key,), _kernel_override=override)
        return np.asarray(out[key], np.float32)

    def _time_variant(self, batcher, servable, arrays, override, iters: int) -> float:
        def run():
            batcher._execute(servable, dict(arrays), (servable.model.score_output,),
                             _kernel_override=override)
            _sync(batcher.device)

        run()  # first call builds the variant
        best = float("inf")
        for _ in range(max(iters, 1)):
            t0 = self._clock()
            run()
            best = min(best, self._clock() - t0)
        return best

    def _auc_of(self, batcher, servable, eval_data, override) -> float:
        """AUC of one variant over labeled arrays, padded into the nearest
        bucket (clamped to the ladder's top)."""
        from ..serving.batcher import bucket_for
        from ..train.data import auc as exact_auc

        arrays, labels = eval_data
        n = int(next(iter(arrays.values())).shape[0])
        top = int(batcher.buckets[-1])
        if n > top:
            arrays = {k: v[:top] for k, v in arrays.items()}
            labels = np.asarray(labels)[:top]
            n = top
        bucket = bucket_for(n, batcher.buckets)
        padded = {}
        for k, v in arrays.items():
            buf = np.zeros((bucket,) + v.shape[1:], v.dtype)
            buf[:n] = v
            padded[k] = buf
        scores = self._scores_of(batcher, servable, padded, override)[:n]
        return float(exact_auc(np.asarray(labels, np.float64), scores))

    def _buckets(self, batcher, buckets) -> tuple[int, ...]:
        return tuple(int(b) for b in (buckets or self.config.autotune_buckets or batcher.buckets))

    def prepare(self, batcher, servable, buckets=None, eval_data=None) -> None:
        """Load-time entry: adopt a persisted decision table that matches
        exactly, else measure (unless autotune = false, which serves the
        baseline)."""
        buckets = self._buckets(batcher, buckets)
        self._batcher = batcher
        if self._try_reuse(servable, buckets) is not None:
            return
        if self.config.autotune:
            self.autotune(batcher, servable, buckets, eval_data=eval_data)

    def autotune(self, batcher, servable, buckets=None, eval_data=None,
                 force: bool = False) -> dict:
        """Measure every candidate variant per bucket, gate, decide,
        persist; returns this servable's table. `eval_data` = (arrays,
        labels) arms the AUC gate. `force` skips adopting a persisted
        table."""
        cfg = self.config
        self.autotunes += 1
        key = (servable.name, servable.version)
        buckets = self._buckets(batcher, buckets)
        self._batcher = batcher
        if not force:
            reused = self._try_reuse(servable, buckets)
            if reused is not None:
                return reused
        on_cpu = batcher.device.type != "cuda"
        iters = int(cfg.measure_iters) or (4 if on_cpu else 30)
        sample = self._tune_arrays(batcher, servable, buckets[0])
        fused_ok, fused_why = self._fused_eligible(servable, sample)
        candidates = []
        if cfg.quantize:
            candidates.append(XLA_INT8)
        if cfg.pallas and fused_ok:
            candidates.extend([PALLAS_F32] + ([PALLAS_INT8] if cfg.quantize else []))

        # AUC gate: one evaluation per variant (rank quality does not depend
        # on the bucket), against the float baseline's AUC.
        aucs: dict[str, float | None] = {BASELINE: None}
        auc_errors: dict[str, str] = {}
        if eval_data is not None:
            for name in (BASELINE, *candidates):
                try:
                    aucs[name] = self._auc_of(batcher, servable, eval_data, VARIANT_FLAGS[name])
                except Exception as exc:  # noqa: BLE001 — recorded; the gate fails closed
                    auc_errors[name] = self._failure(name, "AUC evaluation", exc)[:200]

        table: dict = {
            "model": servable.name,
            "version": servable.version,
            "params_digest": params_digest(servable.params),
            "device": device_kind(batcher.device),
            "measure_iters": iters,
            "measure_only": bool(cfg.measure_only),
            "gates": {
                "min_speedup": cfg.min_speedup,
                "max_abs_delta": cfg.max_abs_delta,
                "auc_margin": cfg.auc_margin,
                "auc_evaluated": eval_data is not None,
            },
            "pallas_eligible": fused_ok,
            **({"pallas_ineligible_reason": fused_why} if not fused_ok else {}),
            "auc": {k: (round(v, 4) if v is not None else None) for k, v in aucs.items()},
            **({"auc_errors": auc_errors} if auc_errors else {}),
            "buckets": {},
        }
        decisions: dict[int, tuple[bool, bool]] = {}
        for bucket in buckets:
            arrays = self._tune_arrays(batcher, servable, bucket)
            row: dict = {}
            try:
                base = VARIANT_FLAGS[BASELINE]
                base_scores = self._scores_of(batcher, servable, arrays, base)
                base_t = self._time_variant(batcher, servable, arrays, base, iters)
            except Exception as exc:  # noqa: BLE001 — baseline broken: skip the bucket
                table["buckets"][str(bucket)] = {"error": f"{type(exc).__name__}: {exc}"[:300]}
                continue
            row[BASELINE] = {"step_us": round(base_t * 1e6, 1)}
            best: tuple[float, str] | None = None
            for name in candidates:
                flags = VARIANT_FLAGS[name]
                entry: dict = {}
                try:
                    scores = self._scores_of(batcher, servable, arrays, flags)
                    t = self._time_variant(batcher, servable, arrays, flags, iters)
                    entry["step_us"] = round(t * 1e6, 1)
                    entry["speedup"] = round(base_t / t, 3) if t > 0 else None
                    entry["max_abs_delta"] = round(float(np.max(np.abs(scores - base_scores))), 6)
                    auc_v, auc_b = aucs.get(name), aucs.get(BASELINE)
                    if auc_v is not None and auc_b is not None:
                        entry["auc_delta"] = round(abs(auc_b - auc_v), 5)
                        entry["auc_gate"] = "pass" if entry["auc_delta"] <= cfg.auc_margin else "fail"
                    elif eval_data is not None:
                        entry["auc_gate"] = "error"  # supplied but not evaluated: fails closed
                    else:
                        entry["auc_gate"] = "skipped"
                    enabled = (
                        entry["speedup"] is not None
                        and entry["speedup"] >= cfg.min_speedup
                        and entry["max_abs_delta"] <= cfg.max_abs_delta
                        and entry["auc_gate"] in ("pass", "skipped")
                        and not cfg.measure_only
                    )
                    entry["enabled"] = enabled
                    if enabled and (best is None or entry["speedup"] > best[0]):
                        best = (entry["speedup"], name)
                except Exception as exc:  # noqa: BLE001 — a failing xla_int8 is a
                    # disabled variant, recorded with its error, never a serving error.
                    entry["error"] = self._failure(name, f"bucket {bucket}", exc)
                    entry["enabled"] = False
                row[name] = entry
            if best is not None:
                decisions[bucket] = VARIANT_FLAGS[best[1]]
                row["decision"] = best[1]
            else:
                row["decision"] = BASELINE
            table["buckets"][str(bucket)] = row
        if decisions:
            self._warm_enabled(servable, decisions)
        with self._lock:
            new = dict(self._decisions)
            new[key] = (weakref.ref(servable), decisions)
            self._decisions = new  # whole swap: decision() reads lock-free
            self._tables[key] = table
        log.info(
            "kernel autotune %s v%d: %s", servable.name, servable.version,
            {int(b): row.get("decision", "error") for b, row in table["buckets"].items()},
        )
        self._save_table()
        return table

    def _warm_enabled(self, servable, decisions: dict) -> None:
        """Run every enabled (bucket, variant) once per output-key set live
        traffic asks for, so its first live batch finds it built. A fused
        variant that fails here raises, as in the autotune."""
        b = self._batcher
        if b is None:
            return
        for bucket, flags in sorted(decisions.items()):
            try:
                arrays = self._tune_arrays(b, servable, bucket)
                for out_keys in (None, (servable.model.score_output,)):
                    b._execute(servable, dict(arrays), out_keys, _kernel_override=flags)
            except Exception:  # noqa: BLE001 — first live use builds it instead
                if flags[1]:
                    raise
                log.exception(
                    "kernel variant warm failed (%s:%s bucket %s)",
                    servable.name, servable.version, bucket,
                )

    # --------------------------------------------------------- persistence

    def _fingerprint(self) -> dict:
        cfg = self.config
        return {
            "min_speedup": cfg.min_speedup,
            "max_abs_delta": cfg.max_abs_delta,
            "auc_margin": cfg.auc_margin,
            "quantize": cfg.quantize,
            "pallas": cfg.pallas,
        }

    def _try_reuse(self, servable, buckets: tuple[int, ...]):
        """Adopt a persisted table for this exact (model, version, params
        digest, device, gate fingerprint, bucket set); anything else
        re-measures."""
        key = (servable.name, servable.version)
        path = self.config.table_file
        if not path or not os.path.exists(path) or self.config.measure_only:
            return None
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError):  # an unreadable table is re-tuned
            return None
        if data.get("device") != device_kind(self._device()) or \
                data.get("fingerprint") != self._fingerprint():
            return None
        entry = (data.get("entries") or {}).get(f"{key[0]}:{key[1]}")
        if entry is None or entry.get("measure_only"):
            # A measure-only table never enabled anything; adopting it would
            # serve the baseline forever without measuring.
            return None
        if entry.get("params_digest") != params_digest(servable.params):
            return None
        if sorted(entry.get("buckets") or {}) != sorted(str(b) for b in buckets):
            return None
        decisions = {
            int(b): tuple(VARIANT_FLAGS[row.get("decision", BASELINE)])
            for b, row in entry["buckets"].items()
            if "error" not in row
        }
        decisions = {b: d for b, d in decisions.items() if d != (False, False)}
        if decisions:
            self._warm_enabled(servable, decisions)
        entry = dict(entry)
        entry["reused_from"] = path
        with self._lock:
            new = dict(self._decisions)
            new[key] = (weakref.ref(servable), decisions)
            self._decisions = new
            self._tables[key] = entry
        self.table_reuses += 1
        log.info("kernel autotune: reused persisted table for %s:%s", *key)
        return entry

    def _save_table(self) -> None:
        path = self.config.table_file
        if not path:
            return
        with self._lock:
            entries = {f"{name}:{ver}": table for (name, ver), table in self._tables.items()}
        kind = device_kind(self._device())
        # Merge with what is on disk (same device and gates only), so one
        # version's save does not erase another's measured entry.
        try:
            with open(path) as f:
                prior = json.load(f)
            if prior.get("device") == kind and prior.get("fingerprint") == self._fingerprint():
                entries = {**(prior.get("entries") or {}), **entries}
        except (OSError, ValueError):  # absent or unreadable: a fresh file
            pass
        data = {"version": 1, "device": kind, "fingerprint": self._fingerprint(),
                "entries": entries}
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(data, f, indent=1, sort_keys=True)
            os.replace(tmp, path)  # readers never see half a table
            self.table_saves += 1
        except OSError:  # persistence is best-effort
            log.exception("kernel autotune: table save failed (%s)", path)

    # ------------------------------------------------------------ lifecycle

    def invalidate_model(self, name: str) -> None:
        """Drop a model's live decisions and tables."""
        with self._lock:
            self._decisions = {k: v for k, v in self._decisions.items() if k[0] != name}
            for k in [k for k in self._tables if k[0] == name]:
                self._tables.pop(k, None)

    # -------------------------------------------------------------- surface

    def snapshot(self) -> dict:
        """Counters, live decisions, measured tables and gates."""
        cfg = self.config
        with self._lock:
            decisions = {
                f"{name}:{ver}": {
                    str(b): {"quantized": q, "pallas": p}
                    for b, (q, p) in sorted(entry[1].items())
                }
                for (name, ver), entry in self._decisions.items()
                if entry[0]() is not None
            }
            tables = {f"{name}:{ver}": table for (name, ver), table in self._tables.items()}
        return {
            "enabled": True,
            "measure_only": bool(cfg.measure_only),
            "counters": {
                "autotunes": self.autotunes,
                "table_saves": self.table_saves,
                "table_reuses": self.table_reuses,
                "quantized_batches": self.quantized_batches,
                "pallas_batches": self.pallas_batches,
            },
            "decisions": decisions,
            "tables": tables,
            "gates": {
                "min_speedup": cfg.min_speedup,
                "max_abs_delta": cfg.max_abs_delta,
                "auc_margin": cfg.auc_margin,
            },
        }
