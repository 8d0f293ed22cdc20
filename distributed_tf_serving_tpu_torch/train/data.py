"""Synthetic CTR data and ranking metrics (numpy only).

A deterministic Criteo-like stream: `SyntheticCTRStream.batch(n, i)` is
reproducible for any index i, and equals the JAX package's stream for the
same (config, n, i) bit for bit (both draw from numpy's RandomState).
Labels come from a fixed random "teacher": each (field, id) pair adds a
hash-derived weight, the row score is their feature-weighted sum, and the
label is Bernoulli(sigmoid(score)), so every model family has learnable
signal and a known Bayes-optimal ranking to measure AUC against.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticCTRConfig:
    num_fields: int = 43
    # Finite id catalog: ids must recur across batches or nothing
    # generalizes (the teacher keys on raw ids). Sized to fit common vocab
    # settings so the model-side fold stays injective.
    id_space: int = 1 << 18
    # The teacher logit's std lands near 3.5 (Bayes AUC ~0.9), well clear
    # of a coin flip.
    teacher_scale: float = 6.0
    seed: int = 0


class SyntheticCTRStream:
    """Deterministic batch generator: batch(i) is reproducible for any i."""

    def __init__(self, config: SyntheticCTRConfig = SyntheticCTRConfig()):
        self.config = config
        # Teacher weights live in a small hashed space, so scores depend on
        # ids through a fixed pseudo-random map.
        rng = np.random.RandomState(config.seed)
        self._teacher = rng.randn(1 << 16).astype(np.float32) * config.teacher_scale

    def _teacher_score(self, ids: np.ndarray, wts: np.ndarray) -> np.ndarray:
        # Fibonacci hash in uint64 (the multiplier exceeds int64 range).
        h = (ids.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)) >> np.uint64(48)
        w = self._teacher[(h & np.uint64(0xFFFF)).astype(np.int64)]
        # sum / sqrt(F): the logit's variance does not depend on the field count.
        return (w * wts).sum(axis=1) / np.sqrt(wts.shape[1])

    def batch(self, batch_size: int, index: int) -> dict[str, np.ndarray]:
        cfg = self.config
        rng = np.random.RandomState((cfg.seed * 1_000_003 + index) & 0x7FFFFFFF)
        ids = rng.randint(0, cfg.id_space, size=(batch_size, cfg.num_fields)).astype(np.int64)
        wts = rng.rand(batch_size, cfg.num_fields).astype(np.float32)
        score = self._teacher_score(ids, wts)
        labels = (rng.rand(batch_size) < _sigmoid(score)).astype(np.float32)
        return {"feat_ids": ids, "feat_wts": wts, "labels": labels}


def _sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


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
