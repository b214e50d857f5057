"""Dense scoring + top-k over a document matrix.

The counterpart of ``twotowers_tpu/ops/topk_score.py``. Conventions are the
same: ``doc_matrix`` is ``(N, D)`` with real rows ``[0, n_docs)``, queries are
``(Q, D)``, both L2-unit so dot == cosine; results are ``(Q, k)`` float32
scores and int32 indices, best first, equal scores to the lower index.

Dispatch is by device alone. A CPU tensor goes to the plain version,
``score_topk_reference``; a CUDA tensor goes to the hand-written kernel
(``kernels/topk.py``), which launches or raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..kernels.topk import score_topk_cuda

# the score of rows at or past n_docs (score_topk_xla's NEG_INF)
NEG_INF = -1e30


def score_topk_reference(
    doc_matrix: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    n_docs: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch top-k of ``queries @ doc_matrix.T`` (score_topk_xla).

    Queries are cast to the docs' dtype, then both are widened so that the
    products are summed in float32. ``torch.topk`` does not promise the
    lower-index order on ties, so this sorts stably instead.
    """
    scores = queries.to(doc_matrix.dtype).float() @ doc_matrix.float().T
    if n_docs is not None:
        col = torch.arange(scores.shape[1], device=scores.device)
        scores = scores.masked_fill(col >= int(n_docs), NEG_INF)
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k].contiguous(), idx[:, :k].to(torch.int32)


def score_topk(
    doc_matrix: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    n_docs: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k dot-product scores per query: the plain version for CPU
    tensors, the CUDA kernel for tensors on the card."""
    if doc_matrix.device.type == "cpu" and queries.device.type == "cpu":
        return score_topk_reference(doc_matrix, queries, k, n_docs)
    return score_topk_cuda(doc_matrix, queries, k, n_docs)
