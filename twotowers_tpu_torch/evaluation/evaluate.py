"""Model evaluation over (query, documents, relevance) test tuples.

The counterpart of ``twotowers_tpu/evaluation/evaluate.py``: per-query
cosine ranking of the candidate documents, and P@K / R@K / MRR / NDCG@K
means over k in {1, 5, 10}. Texts are encoded in fixed chunks of
``batch_size`` rows (the last one padded with all-pad rows) on the model's
device, with one copy back to the host per call. The ranking stays on the
host: a stable argsort of the negated cosine scores, so ties keep the
documents' order.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..models.towers import TwoTower, TwoTowerSpec
from ..tokenizers.base import BaseTokenizer
from ..utils.logging import get_logger
from .metrics import mean_reciprocal_rank, ndcg_at_k, precision_at_k, recall_at_k

logger = get_logger("evaluation.evaluate")

TestTuple = Tuple[str, List[str], List[int]]

DEFAULT_K_VALUES = [1, 5, 10]
DEFAULT_MAX_LENGTH = 64


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


class _Encoder:
    """Encodes texts with one tower in fixed chunks of ``batch_size`` rows."""

    def __init__(self, model: TwoTower, tokenizer: BaseTokenizer, max_length: int,
                 batch_size: int):
        self.model = model
        self.device = next(model.parameters()).device
        self.tokenizer = tokenizer
        self.max_length = max_length
        self.batch_size = batch_size

    def __call__(self, texts: Sequence[str], tower: str) -> np.ndarray:
        ids = self.tokenizer.encode_batch(list(texts), self.max_length)
        n = len(texts)
        padded_n = _round_up(max(n, 1), self.batch_size)
        if padded_n != n:
            ids = np.concatenate(
                [ids, np.zeros((padded_n - n, self.max_length), np.int32)])
        ids = torch.from_numpy(ids).to(self.device)
        with torch.inference_mode():
            outs = [self.model.encode(ids[start:start + self.batch_size], tower)
                    for start in range(0, padded_n, self.batch_size)]
        return torch.cat(outs).cpu().numpy()[:n]  # the one copy back


def evaluate_model(
    model: TwoTower,
    spec: TwoTowerSpec,
    test_data: Sequence[TestTuple],
    tokenizer: BaseTokenizer,
    metrics: Sequence[str] = ("precision", "recall", "mrr", "ndcg"),
    k_values: Sequence[int] = DEFAULT_K_VALUES,
    batch_size: int = 32,
    max_length: int = DEFAULT_MAX_LENGTH,
    ndcg_reference_compat: bool = False,
) -> Dict[str, float]:
    """Evaluate retrieval quality on the model's device; returns
    {metric@k: score} means. The model is put in eval mode (no dropout).

    ``spec`` is the model's (``model.spec``); it is taken, as the JAX
    function takes it, so that either is called with what
    ``load_trained_model`` returns.
    ``ndcg_reference_compat=True`` reproduces the original project's NDCG
    call shape (see ``metrics.ndcg_at_k``) for parity runs only.
    """
    if spec != model.spec:
        raise ValueError("spec is not the model's")
    model.eval()
    encoder = _Encoder(model, tokenizer, max_length, batch_size)

    all_precision, all_recall, all_mrr, all_ndcg = [], [], [], []
    for query, documents, relevance in test_data:
        q_vec = encoder([query], "query")[0]
        d_vecs = encoder(documents, "document")

        # the towers emit unit vectors, so cosine == dot; guarded as the
        # JAX function guards it
        norms = np.linalg.norm(d_vecs, axis=-1) * np.linalg.norm(q_vec)
        scores = (d_vecs @ q_vec) / np.maximum(norms, 1e-8)
        order = np.argsort(-scores, kind="stable")
        sorted_relevance = np.asarray(relevance)[order]
        total_relevant = int(np.sum(relevance))

        all_precision.append([precision_at_k(sorted_relevance, k) for k in k_values])
        all_recall.append(
            [recall_at_k(sorted_relevance, k, total_relevant) for k in k_values])
        all_mrr.append(mean_reciprocal_rank(sorted_relevance))
        all_ndcg.append([
            ndcg_at_k(sorted_relevance, k, reference_compat=ndcg_reference_compat)
            for k in k_values
        ])

    results: Dict[str, float] = {}
    if "precision" in metrics:
        for i, k in enumerate(k_values):
            results[f"precision@{k}"] = float(np.mean([p[i] for p in all_precision]))
    if "recall" in metrics:
        for i, k in enumerate(k_values):
            results[f"recall@{k}"] = float(np.mean([r[i] for r in all_recall]))
    if "mrr" in metrics:
        results["mrr"] = float(np.mean(all_mrr))
    if "ndcg" in metrics:
        for i, k in enumerate(k_values):
            results[f"ndcg@{k}"] = float(np.mean([n[i] for n in all_ndcg]))
    return results


def print_evaluation_results(results: Dict[str, float]) -> None:
    """Pretty-print grouped metric results."""
    print("\nEvaluation Results:")
    print("=" * 50)
    for prefix, title in (("precision", "Precision"), ("recall", "Recall")):
        group = {k: v for k, v in results.items() if k.startswith(prefix)}
        if group:
            print(f"\n{title}:")
            for key, value in sorted(group.items()):
                print(f"  {key}: {value:.4f}")
    if "mrr" in results:
        print("\nMean Reciprocal Rank:")
        print(f"  MRR: {results['mrr']:.4f}")
    ndcg = {k: v for k, v in results.items() if k.startswith("ndcg")}
    if ndcg:
        print("\nNDCG:")
        for key, value in sorted(ndcg.items()):
            print(f"  {key}: {value:.4f}")
    print("=" * 50)
