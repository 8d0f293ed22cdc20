"""Publishing into a TF-Serving versioned base path.

`publish_version` lands one artifact in `<base>/<N>` atomically, under the
next version number the version watcher's own scanner
(serving/version_watcher.py scan_versions) leaves free. The SavedModel
export of the JAX package's module is not ported yet.
"""

from __future__ import annotations

import os
import shutil

from ..serving.version_watcher import scan_versions


def publish_version(base_dir, write_fn, at_least: int = 1,
                    max_attempts: int = 10) -> tuple[int, str]:
    """Write an artifact with `write_fn(tmp_dir)` into a dot-prefixed
    sibling directory (not numeric, so a watcher's scan never lists it),
    then rename it to `<base>/<N>`, N = max(existing numeric versions,
    at_least - 1) + 1. A watcher therefore never sees a half-written
    version. A publisher racing for the same number loses the rename (onto
    a non-empty directory it raises rather than merging), scans again and
    retries under the next number with the artifact already written; the
    directory number is authoritative. Returns (version, path)."""
    base = os.path.abspath(str(base_dir))
    os.makedirs(base, exist_ok=True)
    tmp = os.path.join(base, f".tmp-publish-{os.getpid()}-{id(write_fn):x}")
    shutil.rmtree(tmp, ignore_errors=True)
    try:
        write_fn(tmp)
        if not os.path.isdir(tmp):
            raise RuntimeError(f"publish writer did not create the artifact dir {tmp}")
        last_exc: OSError | None = None
        for _ in range(max_attempts):
            version = max(list(scan_versions(base)) + [int(at_least) - 1]) + 1
            dst = os.path.join(base, str(version))
            try:
                os.rename(tmp, dst)
            except OSError as exc:
                # Only a destination that now exists is a collision; any
                # other failure (EXDEV, EACCES) surfaces.
                if not os.path.isdir(dst):
                    raise
                last_exc = exc
                continue
            return version, dst
        raise RuntimeError(
            f"could not allocate a version under {base} after {max_attempts} collisions"
        ) from last_exc
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
