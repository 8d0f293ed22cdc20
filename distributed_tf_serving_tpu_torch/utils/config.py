"""TOML config: the [server], [batching], [transport], [model] and [kernels]
sections the port reads.

Other sections of the JAX package's config files (planes this package has
not ported yet) are ignored with one log line, as are [server] and
[batching] keys that have no counterpart here.
"""

from __future__ import annotations

import dataclasses
import logging
import pathlib
import tomllib
from typing import Any

from ..models.base import ModelConfig
from ..ops.transfer import output_wire_dtype

log = logging.getLogger("dts_torch.config")


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """Serving frontend + batcher knobs."""

    host: str = "0.0.0.0"
    port: int = 9999
    max_workers: int = 16
    model_kind: str = "dcn_v2"
    model_name: str = "DCN"
    num_fields: int = 43
    buckets: tuple[int, ...] = (32, 64, 128, 256, 512, 1024, 2048, 4096)
    max_wait_us: int = 200
    # Threads that wait for a batch's readback, slice it per request and
    # complete the futures.
    completion_workers: int = 4
    # How many assembled batches may be staged for the device stage,
    # counting the one it runs (min 1: assembly and device stage in
    # turn). The [batching] section's pipeline_depth, when nonzero, wins.
    pipeline_depth: int = 2
    queue_capacity_candidates: int | None = None
    # Warm a loaded version before it serves: the bucket ladder, then the
    # version's own assets.extra/tf_serving_warmup_requests records.
    warmup: bool = True
    # Version-label routing (tensorflow_model_server's version_labels map:
    # "stable"/"canary" -> version number). TOML: version_labels = {stable
    # = 2, canary = 3}; stored as sorted (label, version) pairs so the
    # frozen config stays hashable.
    version_labels: tuple[tuple[str, int], ...] = ()
    # Version-watcher knobs (--model-base-path), named for their
    # tensorflow_model_server flags: --file_system_poll_wait_seconds and
    # --max_num_load_retries (retries AFTER the first attempt).
    file_system_poll_wait_seconds: float = 5.0
    max_num_load_retries: int = 2
    # Readback wire dtype: float32 outputs are downcast on the device
    # before the D2H copy and widened back to float32 on the host.
    # "float32" = no downcast (bit-exact); "bfloat16" / "float16" halve the
    # readback bytes; "int8" quarters them (affine, range/508 worst case).
    output_wire_dtype: str = "float32"
    # > 0: a single-request batch that asked for exactly the score output
    # reads back only its top-k (score, index) pairs; the host rebuilds the
    # full-length vector with 0.0 off the head. 0 = off.
    output_top_k: int = 0

    def __post_init__(self):
        for name in ("completion_workers", "pipeline_depth"):
            v = getattr(self, name)
            if not isinstance(v, int) or isinstance(v, bool) or v < 1:
                raise ValueError(f"[server] {name} must be a positive integer, got {v!r}")
        output_wire_dtype(self.output_wire_dtype)  # an unknown name raises
        v = self.output_top_k
        if not isinstance(v, int) or isinstance(v, bool) or v < 0:
            raise ValueError(f"[server] output_top_k must be a non-negative integer, got {v!r}")


@dataclasses.dataclass(frozen=True)
class BatchingConfig:
    """The [batching] section: the dispatch pipeline's depth and the
    PredictStream sub-batch split. The JAX package's other [batching] keys
    (inflight_window, buffer_ring) are not ported yet and are ignored with
    one log line."""

    # 0 = inherit [server] pipeline_depth; >= 1 otherwise.
    pipeline_depth: int = 0
    # Default candidates per PredictStream sub-batch (the server-side
    # split; a request's x-dts-stream-chunk metadata overrides it). 0 = no
    # split: PredictStream answers with one chunk.
    stream_chunk_candidates: int = 0

    def __post_init__(self):
        for name in ("pipeline_depth", "stream_chunk_candidates"):
            v = getattr(self, name)
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                raise ValueError(f"[batching] {name} must be a non-negative integer, got {v!r}")


@dataclasses.dataclass(frozen=True)
class TransportConfig:
    """The [transport] section: the Unix-domain-socket listener for
    co-located clients. The JAX package's response_arena parses and is
    refused (not ported)."""

    # Also bind the gRPC server to this Unix-domain socket path, next to
    # the TCP port; co-located clients dial "unix:<path>". "" = TCP only.
    uds_path: str = ""
    # Not ported; the key parses so the JAX package's config files load.
    response_arena: bool = False

    def __post_init__(self):
        if self.uds_path:
            if not isinstance(self.uds_path, str):
                raise ValueError("[transport] uds_path must be a string")
            # The kernel's sockaddr_un limit is ~107 bytes: fail at parse,
            # not at bind time.
            if len(self.uds_path.encode()) > 100:
                raise ValueError(
                    "[transport] uds_path exceeds the AF_UNIX path limit "
                    f"(~107 bytes): {self.uds_path!r}"
                )
            if ":" in self.uds_path:
                raise ValueError(
                    "[transport] uds_path is a filesystem path, not a "
                    f"host:port or URI: {self.uds_path!r}"
                )
        if self.response_arena:
            raise ValueError(
                "[transport] response_arena is not ported yet (ROADMAP.md Queue A "
                "item 5)"
            )


@dataclasses.dataclass(frozen=True)
class KernelsConfig:
    """Kernel/quantization plane knobs (ops/quantize.py, ops/autotune.py and
    the fused serve kernel): post-training int8 weight quantization and the
    fused serve step, each enabled per bucket only where the load-time
    autotune measured it faster than the baseline (model.apply on the float
    params) on this device AND it passed the accuracy gates. Off by
    default; off, the batcher reads one attribute per dispatch and serves
    as it does without the plane. Same fields and defaults as the JAX
    package's [kernels] section, but for the table file."""

    # Master switch: build a KernelManager, attach it to the batcher, and
    # run the autotune at load.
    enabled: bool = False
    # Candidate families the autotune considers.
    quantize: bool = True
    pallas: bool = True  # the fused serve kernel (the JAX package's name)
    # Measure at load; False serves only decisions adopted from table_file.
    autotune: bool = True
    # Measure and record everything, enable nothing.
    measure_only: bool = False
    # Decision-table persistence ("" disables it). Not the JAX package's
    # file: the two servers' tables would overwrite each other.
    table_file: str = "artifacts/kernel_autotune_torch.json"
    # Gates: speedup >= min_speedup AND max |dscore| vs the float baseline
    # <= max_abs_delta AND (with labeled eval data) |dAUC| <= auc_margin.
    min_speedup: float = 1.0
    max_abs_delta: float = 0.005
    auc_margin: float = 0.005
    # Timing iterations per (bucket, variant); 0 = auto (device-scaled).
    measure_iters: int = 0
    # Subset of the bucket ladder to tune; empty = the whole ladder.
    autotune_buckets: tuple[int, ...] = ()
    # The int8 score response wire: a Predict whose metadata carries
    # x-dts-score-wire: int8 gets its score tensor as DT_INT8 plus the
    # (scale, min) sidecars. Armed only by a built (enabled) plane, and per
    # server (PredictionServiceImpl.int8_score_wire).
    int8_score_wire: bool = False

    def __post_init__(self):
        for name in ("min_speedup", "max_abs_delta", "auc_margin"):
            v = getattr(self, name)
            if not isinstance(v, (int, float)) or isinstance(v, bool) or v <= 0:
                raise ValueError(f"[kernels] {name} must be a positive number, got {v!r}")
        if not isinstance(self.measure_iters, int) or \
                isinstance(self.measure_iters, bool) or self.measure_iters < 0:
            raise ValueError(
                "[kernels] measure_iters must be a non-negative integer, "
                f"got {self.measure_iters!r}"
            )
        for b in self.autotune_buckets:
            if not isinstance(b, int) or b <= 0:
                raise ValueError(
                    "[kernels] autotune_buckets must be positive integers, "
                    f"got {self.autotune_buckets!r}"
                )

    def build(self):
        """KernelManager per this config, or None when disabled."""
        from ..ops.autotune import KernelManager

        return KernelManager(self) if self.enabled else None


def _coerce(cls, data: dict[str, Any], section: str, strict: bool):
    fields = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(data) - fields)
    if unknown:
        if strict:
            raise ValueError(f"unknown [{section}] keys: {unknown}")
        log.info("ignoring [%s] keys this package does not use: %s", section, unknown)
    kwargs = {}
    for key, value in data.items():
        if key not in fields:
            continue
        if isinstance(value, list):
            value = tuple(value)
        elif isinstance(value, dict) and key == "version_labels":
            # TOML inline table -> the hashable pair form.
            value = tuple(sorted((str(k), int(v)) for k, v in value.items()))
        kwargs[key] = value
    return cls(**kwargs)


def load_config(path) -> dict[str, Any]:
    """Parse a TOML file: {"server": ServerConfig, "batching":
    BatchingConfig, "transport": TransportConfig, "model": ModelConfig,
    "kernels": KernelsConfig} ("model" and "kernels" only when the file has
    that section). A nonzero [batching] pipeline_depth replaces the
    [server] one, as in the JAX package's server."""
    raw = tomllib.loads(pathlib.Path(path).read_text())
    server = _coerce(ServerConfig, raw.get("server", {}), "server", False)
    batching = _coerce(BatchingConfig, raw.get("batching", {}), "batching", False)
    if batching.pipeline_depth:
        server = dataclasses.replace(server, pipeline_depth=batching.pipeline_depth)
    out: dict[str, Any] = {
        "server": server,
        "batching": batching,
        "transport": _coerce(TransportConfig, raw.get("transport", {}), "transport", True),
    }
    if "model" in raw:
        out["model"] = _coerce(ModelConfig, raw["model"], "model", True)
    if "kernels" in raw:
        out["kernels"] = _coerce(KernelsConfig, raw["kernels"], "kernels", True)
    extra = sorted(set(raw) - {"server", "batching", "transport", "model", "kernels"})
    if extra:
        log.info("ignoring config sections this package does not use: %s", extra)
    return out
