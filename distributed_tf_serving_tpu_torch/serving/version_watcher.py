"""Filesystem model-version lifecycle — TF-Serving's base-path convention.

The operational contract of tensorflow_model_server is a *base path*
containing numeric version subdirectories: `<base>/1/`, `<base>/2/`, ... —
the server loads the newest, hot-swaps when a new version directory
appears, and unloads retired ones without dropping traffic. This module is
that contract for the port:

- a version directory is a checkpoint of train/checkpoint.py
  (`servable.json` + `params.safetensors`). A JAX-package checkpoint
  (`servable.json` + an Orbax `params/` directory) is not ready until
  `tools/jax_checkpoint_to_torch.py` adds `params.safetensors` to it; a
  TF SavedModel export (`saved_model.pb`) is imported by
  interop/savedmodel.py as the configured `model_kind` (`graph`: the
  export's own GraphDef), with the watcher's `model_config`;
- a poller thread diffs the directory against loaded versions, loads new
  ones (warming the batcher's bucket ladder and replaying the version's
  warmup file BEFORE registering, so the version flip never serves a cold
  version), and unloads versions that fell out of the retention window;
- `ServableRegistry.resolve`'s latest-version default makes the swap atomic
  from the client's view: requests pin a version or follow the newest. A
  request that resolved a version just before it was unloaded still holds
  it and completes on it.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import pathlib
import threading
import time
from typing import Callable

from ..models.registry import (
    ModelNotFoundError,
    Servable,
    ServableRegistry,
    VersionNotFoundError,
)
from ..train.checkpoint import JAX_PARAMS_DIR, MANIFEST, PARAMS_FILE

log = logging.getLogger("dts_torch.versions")

CONVERTER = "tools/jax_checkpoint_to_torch.py"


def scan_versions(base_path) -> dict[int, pathlib.Path]:
    """Numeric subdirectories of the base path (TF-Serving's convention;
    non-numeric entries are ignored, matching upstream behavior).

    Transient filesystem errors are survivable by design: deploy tooling
    swaps version directories while this scan runs, so an ENOENT
    mid-listing or a stat race on a dir being replaced degrades to "saw
    nothing (or less) this tick" and the next poll retries — never an
    exception that kills the watcher thread (or the caller's startup
    scan)."""
    base = pathlib.Path(base_path)
    out: dict[int, pathlib.Path] = {}
    try:
        if not base.is_dir():
            return {}
        for child in base.iterdir():
            try:
                if child.is_dir() and child.name.isdigit():
                    out[int(child.name)] = child
            except OSError:
                continue  # entry vanished mid-scan: as if never listed
    except OSError as exc:
        log.warning(
            "transient filesystem error scanning %s (%s); retrying next tick",
            base_path, exc,
        )
    return out


def is_native_checkpoint(path: pathlib.Path) -> bool:
    return (path / MANIFEST).exists()


def is_saved_model(path: pathlib.Path) -> bool:
    return (path / "saved_model.pb").exists()


def is_jax_only(path: pathlib.Path) -> bool:
    """A JAX-package checkpoint the converter has not reached yet: the
    manifest and the Orbax params, no params.safetensors."""
    try:
        return (is_native_checkpoint(path) and (path / JAX_PARAMS_DIR).is_dir()
                and not (path / PARAMS_FILE).exists())
    except OSError:
        return False


def _version_ready(path: pathlib.Path) -> bool:
    """Only load fully-written versions. Checkpoints commit by writing
    servable.json AFTER params.safetensors (train/checkpoint.py write
    order; the converter replaces its file atomically), so both present
    means complete. SavedModel exports are ready once
    variables/variables.index exists — TF writes the index after the data
    shards."""
    try:
        if is_native_checkpoint(path):
            return (path / PARAMS_FILE).exists()
        if is_saved_model(path):
            return (path / "variables" / "variables.index").exists()
    except OSError:
        # Version dir swapped out from under the probe: not ready this
        # tick; the next poll sees the final state.
        pass
    return False


def _version_mtime(path: pathlib.Path) -> int:
    """Newest mtime under the version dir (1 level deep) — cheap change
    signal used to un-blacklist a version once its writer finishes."""
    try:
        stamps = [path.stat().st_mtime_ns]
        for child in path.iterdir():
            stamps.append(child.stat().st_mtime_ns)
            if child.is_dir():
                stamps.extend(g.stat().st_mtime_ns for g in child.iterdir())
        return max(stamps)
    except OSError:
        return 0


@dataclasses.dataclass
class VersionWatcherConfig:
    poll_interval_s: float = 5.0
    keep_versions: int = 2  # retention window, newest-first
    model_name: str = "DCN"
    model_kind: str = "dcn_v2"  # for SavedModel version dirs
    # Transient failures (e.g. a slow writer racing the readiness probe)
    # get this many polls before the version is blacklisted until its
    # directory changes.
    max_load_attempts: int = 3
    # Startup (label, version) assignments, applied ONCE each as their
    # version becomes loadable (retried while pending). Seed-once, not
    # continuous enforcement: after a label is assigned, runtime owners
    # may retarget or drop it and the watcher must not fight them back
    # every poll.
    desired_labels: tuple[tuple[str, int], ...] = ()


class VersionWatcher:
    """Poll a base path; keep the registry serving its newest versions.

    `loader(version, path) -> Servable` is injected so serving policy stays
    with the caller; the default loader reads a checkpoint onto `device`,
    or imports a SavedModel export there with `model_config` (default: a
    ModelConfig named after the model).
    `load_timings[version]` holds the seconds each load stage took
    (`read_s` and `copy_s` from the default loader, `warmup_s`,
    `replay_s` and `replay_records`) and `loaded_at` (time.time() of the
    registry flip).
    """

    def __init__(
        self,
        base_path,
        registry: ServableRegistry,
        config: VersionWatcherConfig | None = None,
        loader: Callable[[int, pathlib.Path], Servable] | None = None,
        warmup: Callable[[Servable], None] | None = None,
        # warmup_replay(servable, warmup_file) replays the version's own
        # assets.extra/tf_serving_warmup_requests records (serving/warmup
        # .py) after the bucket warmup, still BEFORE the registry flip; a
        # corrupt/failing file fails the load like upstream.
        warmup_replay: Callable[[Servable, pathlib.Path], int] | None = None,
        device=None,
        model_config=None,  # ModelConfig for SavedModel version dirs
        # on_servable_change(model_name) fires after every registry
        # mutation this watcher performs (version loaded or retired). Must
        # not raise; exceptions are logged and never fail the load/retire
        # that triggered them.
        on_servable_change: Callable[[str], None] | None = None,
    ):
        self.base_path = pathlib.Path(base_path)
        self.registry = registry
        self.config = config or VersionWatcherConfig()
        self.loader = loader or self._default_loader
        self.warmup = warmup
        self.warmup_replay = warmup_replay
        self.device = device
        self.model_config = model_config
        self.on_servable_change = on_servable_change
        self.load_timings: dict[int, dict] = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="version-watcher", daemon=True
        )
        self._attempts: dict[int, int] = {}  # version -> failed load count
        self._attempt_mtime: dict[int, int] = {}  # version -> mtime at last failure
        self._label_warned: set[str] = set()  # once-per-label pending warning
        self._labels_applied: set[str] = set()  # seed-once bookkeeping
        self._jax_only_warned: set[int] = set()  # once-per-version converter hint
        # Blacklisted versions are EXCLUDED from the candidate set (unlike
        # the mtime-keyed load-failure backoff above, an explicit
        # blacklist never self-clears when the directory changes); pinned
        # versions are exempt from retention. Mutations REBIND a fresh
        # frozenset, so the poll thread and snapshot() always iterate a
        # consistent immutable view, no lock needed.
        self._blacklisted: frozenset[int] = frozenset()
        self._pinned: frozenset[int] = frozenset()
        # Last reconcile pass's on-disk-ready versions: snapshot() reports
        # this cached view instead of re-scanning the base path.
        self._last_ready: tuple[int, ...] = ()

    # ----------------------------------------------------------------- API

    def start(self) -> "VersionWatcher":
        self.poll_once()  # synchronous first scan: serve something at start
        self._thread.start()
        return self

    def request_stop(self) -> None:
        """Signal the poller to stop without joining it (a multi-model
        shutdown signals every watcher first, so it waits for the slowest
        one, not for their sum)."""
        self._stop.set()

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=10)

    # ----------------------------------------------- lifecycle control API

    def blacklist(self, version: int) -> None:
        """Exclude `version` from the reconcile candidate set until
        unblacklisted (a retired bad version is otherwise reloaded on the
        next scan: its directory is still on disk and still probes ready)."""
        self._blacklisted = self._blacklisted | {int(version)}
        log.info("blacklisted %s v%d (excluded from reconcile)",
                 self.config.model_name, int(version))

    def unblacklist(self, version: int) -> None:
        self._blacklisted = self._blacklisted - {int(version)}

    def is_blacklisted(self, version: int) -> bool:
        return int(version) in self._blacklisted

    def pin(self, version: int) -> None:
        """Exempt `version` from retention (like a label pin, without a
        label)."""
        self._pinned = self._pinned | {int(version)}

    def unpin(self, version: int) -> None:
        self._pinned = self._pinned - {int(version)}

    def retire(self, version: int, blacklist: bool = True) -> bool:
        """Unload `version` from the registry NOW (traffic snaps to the
        remaining latest via resolve's default) and, by default,
        blacklist it so the next reconcile pass cannot hot-load it back
        from disk. True = a loaded version was actually unloaded."""
        v = int(version)
        if blacklist:
            self.blacklist(v)
        self.unpin(v)
        name = self.config.model_name
        try:
            self.registry.unload(name, v)
        except KeyError:  # Model/VersionNotFoundError: never loaded
            return False
        log.info("retired %s v%d (lifecycle)", name, v)
        self._notify_change(name)
        return True

    def snapshot(self) -> dict:
        """Watcher state: what is loaded, what the LAST reconcile pass saw
        ready on disk (cached: no filesystem I/O here), and the
        blacklist/pin sets."""
        name = self.config.model_name
        # _attempts is mutated in place by the poll thread; copying a
        # resizing dict can raise "changed size during iteration".
        attempts: dict[int, int] = {}
        for _ in range(3):
            try:
                attempts = dict(self._attempts)
                break
            except RuntimeError:
                continue
        return {
            "base_path": str(self.base_path),
            "model": name,
            "loaded": sorted(self.registry.models().get(name, ())),
            "on_disk_ready": list(self._last_ready),
            "blacklisted": sorted(self._blacklisted),
            "pinned": sorted(self._pinned),
            "failed_attempts": dict(sorted(attempts.items())),
        }

    def poll_once(self) -> None:
        """One reconcile pass: load new ready versions, retire old ones.

        Load candidates are the newest `keep_versions` READY versions on
        disk (TF-Serving's latest-N version policy). Considering every
        unloaded on-disk version would re-load each retired one on every
        poll — a continuous load/unload storm competing with live
        traffic once history outgrows the retention window."""
        name = self.config.model_name
        on_disk = scan_versions(self.base_path)
        loaded = set(self.registry.models().get(name, ()))

        ready_on_disk = {v: p for v, p in on_disk.items() if _version_ready(p)}
        for v, p in on_disk.items():
            if v not in ready_on_disk and v not in self._jax_only_warned and is_jax_only(p):
                self._jax_only_warned.add(v)
                log.warning(
                    "%s v%d at %s is a JAX-package checkpoint without %s; convert it in "
                    "place with `python %s %s` (where JAX is installed) and it loads on "
                    "the next poll", name, v, p, PARAMS_FILE, CONVERTER, p,
                )
        # Cached for snapshot(); it includes blacklisted versions on
        # purpose ("the bad dir still sits ready on disk").
        self._last_ready = tuple(sorted(ready_on_disk))
        ready = {
            v: p for v, p in ready_on_disk.items()
            if v not in self._blacklisted
        }
        candidates = sorted(ready, reverse=True)[: self.config.keep_versions]
        for version in sorted(v for v in candidates if v not in loaded):
            if self._stop.is_set():
                # A mid-load stop must not let this thread register
                # versions after the caller has shut down.
                return
            path = ready[version]
            if self._attempts.get(version, 0) >= self.config.max_load_attempts:
                # Blacklisted — but a writer that finished late changes the
                # directory; give the version a fresh set of attempts then,
                # so recovery never requires a server restart.
                mtime = _version_mtime(path)
                if mtime == self._attempt_mtime.get(version):
                    continue
                self._attempts.pop(version, None)
                self._attempt_mtime.pop(version, None)
            # Snapshot BEFORE loading: a writer finishing mid-attempt would
            # otherwise be recorded at its final mtime, making the blacklist
            # look current forever.
            pre_mtime = _version_mtime(path)
            try:
                timings = self.load_timings.setdefault(version, {})
                timings.clear()
                servable = self.loader(version, path)
                if self.warmup is not None:
                    t0 = time.perf_counter()
                    self.warmup(servable)  # cold-start work BEFORE the flip
                    timings["warmup_s"] = time.perf_counter() - t0
                if self.warmup_replay is not None:
                    from .warmup import warmup_file_for

                    wf = warmup_file_for(path)
                    if wf is not None:
                        t0 = time.perf_counter()
                        n = self.warmup_replay(servable, wf)
                        timings["replay_s"] = time.perf_counter() - t0
                        timings["replay_records"] = n
                        log.info(
                            "replayed %d warmup records for %s v%d", n, name, version
                        )
                if self._stop.is_set():
                    return  # stopped while loading: never register (above)
                self.registry.load(servable)
                timings["loaded_at"] = time.time()
                self._attempts.pop(version, None)
                self._attempt_mtime.pop(version, None)
                log.info("loaded %s v%d from %s: %s", name, version, path,
                         json.dumps(timings, sort_keys=True))
                self._notify_change(name)
            except Exception:
                self._attempts[version] = self._attempts.get(version, 0) + 1
                self._attempt_mtime[version] = pre_mtime
                log.exception(
                    "failed to load %s v%d from %s (attempt %d/%d)",
                    name, version, path,
                    self._attempts[version], self.config.max_load_attempts,
                )

        # Retention: keep the newest K of the union PLUS any labeled
        # version — a pinned "stable" must not be retired out from under
        # its label by newer rollouts. Pins follow the registry's LIVE
        # label state plus not-yet-seeded startup labels.
        loaded = set(self.registry.models().get(name, ()))
        # Defensive sweep: a blacklisted version that is somehow still
        # loaded is retired now — the blacklist means "do not serve".
        for version in sorted(loaded & self._blacklisted):
            try:
                self.registry.unload(name, version)
            except KeyError:
                pass  # retire() unloaded it meanwhile: the goal state
            else:
                log.info("retired %s v%d (blacklisted)", name, version)
                self._notify_change(name)
            loaded.discard(version)
        pinned = set(self.registry.labels(name).values()) | set(
            self._pinned
        ) | {
            v for l, v in self.config.desired_labels
            if l not in self._labels_applied
        }
        keep = set(sorted(loaded, reverse=True)[: self.config.keep_versions])
        keep |= pinned & loaded
        for version in sorted(loaded - keep):
            self.registry.unload(name, version)
            log.info("retired %s v%d (retention window %d)",
                     name, version, self.config.keep_versions)
            self._notify_change(name)

        # Startup-label seeding: assign each desired label the moment its
        # version is loaded, ONCE (retrying only while pending).
        for label, version in self.config.desired_labels:
            if label in self._labels_applied:
                continue
            try:
                self.registry.set_label(name, label, version)
                self._labels_applied.add(label)
                log.info("label %r -> %s v%d", label, name, version)
            except (ModelNotFoundError, VersionNotFoundError):
                if label not in self._label_warned:
                    self._label_warned.add(label)
                    log.warning(
                        "label %r wants %s v%d, which is not loaded yet; "
                        "will keep trying each poll", label, name, version,
                    )

    # ------------------------------------------------------------ internals

    def _notify_change(self, name: str) -> None:
        """Fire the servable-change hook; a hook failure must never fail
        the load/retire that triggered it."""
        if self.on_servable_change is None:
            return
        try:
            self.on_servable_change(name)
        except Exception:  # noqa: BLE001 — hook bugs stay out of the lifecycle
            log.exception("on_servable_change hook failed for %s", name)

    def _default_loader(self, version: int, path: pathlib.Path) -> Servable:
        timings = self.load_timings.setdefault(version, {})
        if is_native_checkpoint(path):
            from ..train.checkpoint import load_servable

            servable = load_servable(path, device=self.device, timings=timings)
        else:
            servable = self._import_saved_model(version, path, timings)
        # The directory number is authoritative (TF-Serving semantics),
        # whatever version the artifact itself recorded.
        if servable.version != version or servable.name != self.config.model_name:
            servable = dataclasses.replace(
                servable, version=version, name=self.config.model_name
            )
        return servable

    def _import_saved_model(self, version: int, path: pathlib.Path,
                            timings: dict) -> Servable:
        from ..interop.savedmodel import SavedModelImportError, import_savedmodel
        from ..models.base import ModelConfig

        try:
            return import_savedmodel(
                path,
                self.config.model_kind,
                self.model_config or ModelConfig(name=self.config.model_name),
                name=self.config.model_name,
                version=version,
                # No generic embed+MLP fallback here: the watcher swaps
                # versions into live traffic with no operator in the loop,
                # and serving an export under a different model family
                # than configured is a wrong-math surprise it must not
                # spring. Explicit import_savedmodel calls default it on.
                fallback=False,
                device=self.device,
                timings=timings,
            )
        except SavedModelImportError as exc:
            if self.model_config is None:
                # The likeliest cause of a binding failure here is an
                # architecture that differs from the DEFAULT ModelConfig
                # this watcher fell back to — say so, instead of letting a
                # bare shape-mismatch blame the export.
                raise SavedModelImportError(
                    f"{exc}\n(this VersionWatcher was constructed without "
                    "a model_config, so the import assumed the default "
                    f"{self.config.model_kind!r} architecture "
                    f"{ModelConfig(name=self.config.model_name)!r}; if "
                    "the export's num_fields/vocab_size/embed_dim/"
                    "mlp_dims differ, pass model_config / the TOML "
                    "[model] section)"
                ) from exc
            raise

    def _loop(self) -> None:
        while not self._stop.wait(self.config.poll_interval_s):
            try:
                self.poll_once()
            except Exception:
                log.exception("version poll failed; retrying next interval")
