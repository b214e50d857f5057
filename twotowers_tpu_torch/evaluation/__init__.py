"""IR evaluation: metrics and the model evaluation harness."""

from .evaluate import evaluate_model, print_evaluation_results
from .metrics import mean_reciprocal_rank, ndcg_at_k, precision_at_k, recall_at_k

__all__ = [
    "evaluate_model",
    "mean_reciprocal_rank",
    "ndcg_at_k",
    "precision_at_k",
    "print_evaluation_results",
    "recall_at_k",
]
