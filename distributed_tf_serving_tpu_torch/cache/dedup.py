"""Intra-batch duplicate collapse — effective-batch shrink under skew.

The score cache (score_cache.py) kills whole-request repeats before the
queue; this module kills ROW repeats inside one combined batch after
collect: zipfian candidate traffic re-scores the same hot rows across the
requests a batch coalesces (and often inside one request's candidate
list), so a 4096-row combined batch routinely holds far fewer distinct
rows. Only the unique rows are padded/uploaded/executed — possibly in a
smaller bucket — and the batcher scatters the executed scores back to
every requester's original row order (serving/batcher.py threads the
scatter map through to the completer).

Row identity is EXACT-bytes over the canonical row layout shared with the
cache key (cache/digest.py canonical_rows): "same row" means the same
decoded feature bytes, never a hash-collision gamble, and the collapse can
never disagree with the cache about what "identical" means.
"""

from __future__ import annotations

import numpy as np

from .digest import canonical_rows


def collapse_rows(
    arrays: dict[str, "list[np.ndarray] | np.ndarray"],
) -> "tuple[dict[str, np.ndarray] | None, np.ndarray | None, dict[str, np.ndarray]]":
    """Collapse duplicate rows across a batch's concatenated inputs.

    `arrays` maps each input name to its per-request parts (list) or an
    already-concatenated array. Returns (unique_arrays, scatter, cats):
    unique_arrays holds only the distinct rows (contiguous, any stable
    order) and scatter[i] is row i's index into them — outputs executed
    over unique_arrays are restored to original order by `out[scatter]`.
    `cats` is the concatenated full batch this function had to build
    anyway; on the all-unique outcome (unique_arrays/scatter None) the
    caller pads straight from it instead of re-concatenating its parts —
    the screening cost then is one concat + the unique() sort, not a
    second copy of the batch.
    """
    cats = {
        k: (np.concatenate(v) if isinstance(v, list) and len(v) > 1
            else (v[0] if isinstance(v, list) else v))
        for k, v in arrays.items()
    }
    blob = canonical_rows(cats)
    total = blob.shape[0]
    # np.unique(axis=0) sorts rows lexicographically (C path): first_idx
    # indexes the first occurrence of each distinct row in the ORIGINAL
    # batch, inverse maps every original row onto its unique slot.
    _, first_idx, inverse = np.unique(
        blob, axis=0, return_index=True, return_inverse=True
    )
    if first_idx.shape[0] == total:
        return None, None, cats
    uniq = {k: np.ascontiguousarray(a[first_idx]) for k, a in cats.items()}
    return uniq, inverse.reshape(-1).astype(np.int64), cats
