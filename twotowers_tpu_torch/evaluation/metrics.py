"""IR metrics: MRR, Precision@K, Recall@K, NDCG@K.

A copy of ``twotowers_tpu/evaluation/metrics.py``. P@K zero-pads when fewer
than K results exist, R@K truncates, MRR is 0 when nothing is relevant.
NDCG@K is the standard rank-ordered definition (gain = relevance at rank i,
discount 1/log2(i+2), normalised by the ideal DCG). ``reference_compat=True``
reproduces the original project's NDCG call shape instead (sklearn's
tie-averaged DCG with the retrieved-order relevance as ``y_score`` and its
descending sort as ``y_true``, an affine function of P@1), for parity
bookkeeping only.
"""

from __future__ import annotations

from typing import List, Union

import numpy as np

ArrayLike = Union[List[float], np.ndarray]


def mean_reciprocal_rank(relevance_scores: ArrayLike) -> float:
    """1/rank of the first relevant result (1-indexed); 0 if none."""
    relevance = np.asarray(relevance_scores)
    relevant = np.where(relevance == 1)[0]
    if len(relevant) == 0:
        return 0.0
    return 1.0 / (relevant[0] + 1)


def precision_at_k(relevance_scores: ArrayLike, k: int) -> float:
    """Fraction of the top-k that is relevant (zero-padded below k results)."""
    relevance = np.asarray(relevance_scores, dtype=np.float64)
    if len(relevance) < k:
        relevance = np.pad(relevance, (0, k - len(relevance)))
        return float(np.mean(relevance))
    return float(np.mean(relevance[:k]))


def recall_at_k(relevance_scores: ArrayLike, k: int, total_relevant: int) -> float:
    """Fraction of all relevant documents retrieved in the top-k."""
    if total_relevant == 0:
        return 0.0
    relevance = np.asarray(relevance_scores, dtype=np.float64)
    top_k = relevance if len(relevance) < k else relevance[:k]
    return float(np.sum(top_k) / total_relevant)


def _ndcg_tie_averaged(y_true: np.ndarray, y_score: np.ndarray, k: int) -> float:
    """sklearn-compatible NDCG: discounted gain with gains averaged across
    tied score groups (sklearn _tie_averaged_dcg)."""

    def tie_averaged_dcg(true: np.ndarray, score: np.ndarray, discount_cumsum):
        _, inv, counts = np.unique(-score, return_inverse=True, return_counts=True)
        ranked = np.zeros(len(counts))
        np.add.at(ranked, inv, true)
        ranked /= counts
        groups = np.cumsum(counts) - 1
        discount_sums = np.empty(len(counts))
        discount_sums[0] = discount_cumsum[groups[0]]
        discount_sums[1:] = np.diff(discount_cumsum[groups])
        return float((ranked * discount_sums).sum())

    discount = 1.0 / np.log2(np.arange(len(y_true)) + 2)
    discount[k:] = 0.0
    discount_cumsum = np.cumsum(discount)
    dcg = tie_averaged_dcg(y_true, y_score, discount_cumsum)
    ideal = tie_averaged_dcg(y_true, y_true, discount_cumsum)
    if ideal == 0:
        return 0.0
    return dcg / ideal


def ndcg_at_k(relevance_scores: ArrayLike, k: int,
              reference_compat: bool = False) -> float:
    """NDCG@K where the ranking is implied by list order.

    Default: standard NDCG — DCG = sum_{i<k} rel_i / log2(i+2) over the
    retrieved order, normalised by the ideal DCG of the same relevance
    multiset (so rank-1 > rank-2 > ... > rank-k hits, strictly).

    ``reference_compat=True`` reproduces the reference's defective call
    shape (evaluate.py:95-124: y_score = retrieved-order relevance, y_true =
    its descending sort, sklearn tie-averaged DCG) for parity measurement
    only; its output is an affine function of precision@1.
    """
    relevance = np.asarray(relevance_scores, dtype=np.float64)
    if reference_compat:
        y_true = np.sort(relevance)[::-1]
        y_score = relevance
        if len(y_true) < k:
            y_true = np.pad(y_true, (0, k - len(y_true)))
            y_score = np.pad(y_score, (0, k - len(y_score)))
        try:
            from sklearn.metrics import ndcg_score  # gated; fallback matches

            return float(
                ndcg_score(y_true.reshape(1, -1), y_score.reshape(1, -1), k=k)
            )
        except Exception:
            return _ndcg_tie_averaged(y_true, y_score, k)

    discount = 1.0 / np.log2(np.arange(min(k, len(relevance))) + 2)
    dcg = float(np.sum(relevance[: k] * discount))
    ideal = np.sort(relevance)[::-1]
    idcg = float(np.sum(ideal[: k] * discount[: min(k, len(ideal))]))
    if idcg == 0.0:
        return 0.0
    return dcg / idcg
