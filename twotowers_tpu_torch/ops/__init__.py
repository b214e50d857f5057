"""Tensor ops: pooling / normalisation and dense score + top-k."""

from .core import cosine_similarity, l2_normalize, masked_mean_pool
from .topk_score import score_topk, score_topk_reference, score_topk_torch

__all__ = [
    "cosine_similarity",
    "l2_normalize",
    "masked_mean_pool",
    "score_topk",
    "score_topk_reference",
    "score_topk_torch",
]
