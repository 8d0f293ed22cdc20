"""Canonical-feature-bytes digests — the ONE canonicalization shared by the
score cache's exact-match key and the batcher's intra-batch duplicate
collapse (cache/dedup.py), so "these two requests are the same work" can
never mean different things on the two paths.

Canonical form: the DECODED feature tensors (dict[str, np.ndarray]), inputs
ordered by name, each row laid out as its contiguous raw bytes. Two protobuf
encodings of the same features (tensor_content vs repeated *_val fields —
both wire shapes the reference client emits, DCNClient.java:98-108) decode
to identical arrays, so they digest identically; genuinely different
requests (the compact int32/bf16 wire vs the wide int64/f32 wire) carry
different dtypes and different bytes, so they digest apart — the cache is
EXACT-match by design, never "probably the same features".

The digest primitive is the same one the DeviceInputCache keys on:
native.hash128 (one pass, GIL released) when the host ops are built,
blake2b-128 otherwise.
"""

from __future__ import annotations

import hashlib

import numpy as np


def _digest_bytes(arr: np.ndarray) -> bytes:
    """16-byte content digest of a contiguous array's raw bytes."""
    from .. import native

    if native.available():
        return native.hash128(arr)
    # uint8 view: ml_dtypes (bf16) arrays refuse the buffer protocol
    # directly, and the digest is over raw bytes anyway (same fallback as
    # serving/batcher.DeviceInputCache._key).
    return hashlib.blake2b(
        np.ascontiguousarray(arr).view(np.uint8).data, digest_size=16
    ).digest()


def rows_as_bytes(arr: np.ndarray) -> np.ndarray:
    """[n, ...] array -> [n, B] uint8 view/copy of each row's raw bytes.
    1-D arrays count as one value per row."""
    a = np.ascontiguousarray(arr)
    if a.ndim == 1:
        a = a.reshape(-1, 1)
    elif a.ndim > 2:
        a = a.reshape(a.shape[0], -1)
    return a.view(np.uint8).reshape(a.shape[0], -1)


def canonical_rows(arrays: dict[str, np.ndarray]) -> np.ndarray:
    """[n, B] uint8 matrix: row i holds candidate i's bytes across ALL
    inputs, inputs concatenated in sorted-name order. Exact row identity
    (dedup) and the request digest below both read from this one layout."""
    parts = [rows_as_bytes(arrays[k]) for k in sorted(arrays)]
    return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=1)


def row_label_keys(arrays: dict[str, np.ndarray]) -> list[str]:
    """Per-candidate JOIN KEYS for the label-feedback plane
    (serving/quality.py): a 16-byte blake2b digest (hex) of each row's
    canonical bytes — the same canonical_rows layout the dedup plane
    keys row identity on, so the key a client computes over the arrays
    it SENT equals the key the server computes over the arrays it
    decoded. The digest is ALWAYS blake2b (both sides must produce
    identical hex with or without the compiled host ops); when the host
    ops are built, native.hash128_rows computes the SAME blake2b for the
    whole batch in one GIL-released call (RFC 7693 in hostops.cc,
    byte-identity regression-tested) instead of a per-row python loop."""
    rows = canonical_rows(arrays)
    from .. import native

    if native.available():
        digests = native.hash128_rows(rows)
        return [digests[i].tobytes().hex() for i in range(digests.shape[0])]
    return [
        hashlib.blake2b(rows[i].tobytes(), digest_size=16).hexdigest()
        for i in range(rows.shape[0])
    ]


def features_digest(arrays: dict[str, np.ndarray], salt: bytes = b"") -> bytes:
    """Stable 16-byte digest of a request's decoded feature tensors.

    Same identity contract as canonical_rows — exact decoded bytes per
    sorted-name input — but folded per ARRAY instead of through the
    [n, B] row matrix: the cache key never needs the row layout (only
    dedup does), and building it would cost a full copy of the request's
    bytes per cache-armed submit. Each input's name/dtype/shape rides the
    fold, so identical raw bytes under a different tensor structure (an
    int64 id re-read as eight weight bytes, a reshaped batch) can never
    share a digest.

    `salt` folds an execution-mode discriminator into the digest itself:
    a cascade stage-1 prune submit produces survivor pairs, not a score
    vector, so the same (model, version, outputs, features) identity must
    never share a digest with a full-vector run — the salt keeps the two
    result shapes apart at the key level rather than trusting every
    consumer to know about modes.
    """
    h = hashlib.blake2b(digest_size=16)
    if salt:
        h.update(salt)
    for k in sorted(arrays):
        a = arrays[k]
        h.update(f"{k}:{a.dtype.str}:{a.shape};".encode())
        h.update(_digest_bytes(a))
    return h.digest()
