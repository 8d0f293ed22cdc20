"""Ranking metrics over labeled scores (numpy only)."""

from __future__ import annotations

import numpy as np


def auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Rank-based AUC (Mann-Whitney U), ties handled by average rank."""
    labels = np.asarray(labels).astype(np.float64)
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    sorted_scores = np.asarray(scores)[order]
    i = 0
    n = len(sorted_scores)
    while i < n:
        j = i
        while j + 1 < n and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i : j + 1]] = (i + j) / 2.0 + 1.0
        i = j + 1
    pos = labels.sum()
    neg = n - pos
    if pos == 0 or neg == 0:
        raise ValueError("AUC undefined: single-class labels")
    return float((ranks[labels == 1].sum() - pos * (pos + 1) / 2) / (pos * neg))
