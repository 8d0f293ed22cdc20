"""Cache plane: exact-match score cache, single-flight coalescing, and
intra-batch duplicate collapse, the row-granular score cache. Numpy and
the standard library only; the digests use the native host ops when they
are built."""

from .digest import canonical_rows, features_digest, rows_as_bytes
from .dedup import collapse_rows
from .score_cache import CacheHandle, CoalescedLeaderCancelled, ScoreCache
from .row_cache import RowBatchPlan, RowScoreCache

__all__ = [
    "CacheHandle",
    "CoalescedLeaderCancelled",
    "RowBatchPlan",
    "RowScoreCache",
    "ScoreCache",
    "canonical_rows",
    "collapse_rows",
    "features_digest",
    "rows_as_bytes",
]
