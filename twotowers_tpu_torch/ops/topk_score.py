"""Dense scoring + top-k over a document matrix.

The counterpart of ``twotowers_tpu/ops/topk_score.py``. Conventions are the
same: ``doc_matrix`` is ``(N, D)`` with real rows ``[0, n_docs)``, queries are
``(Q, D)``, both L2-unit so dot == cosine; results are ``(Q, k)`` float32
scores and int32 indices, best first, equal scores to the lower index.

A CPU tensor goes to the plain version, ``score_topk_reference``. On the card
the route is chosen by shape before any launch, as the JAX dispatcher declines
shapes its Pallas kernel does not take: the hand-written kernel
(``kernels/topk.py``) when ``kernel_takes`` the shape, else
``score_topk_torch``, the counterpart of ``score_topk_xla``. A failed build or
launch of the kernel raises; it never hands the call to another route.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..kernels.topk import MAX_DIM, MAX_K, score_topk_cuda

# the score of rows at or past n_docs (score_topk_xla's NEG_INF)
NEG_INF = -1e30

# calls of score_topk_torch so far; a run reads it to show which route it took
TORCH_ROUTE_CALLS = 0


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


def score_topk_torch(
    doc_matrix: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    n_docs: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The route on the card for shapes the kernel does not take (``k > 256``
    or ``D > 1024``): a matmul and a stable sort, as ``score_topk_xla`` is a
    matmul and ``lax.top_k`` outside any Pallas kernel."""
    global TORCH_ROUTE_CALLS
    TORCH_ROUTE_CALLS += 1
    return score_topk_reference(doc_matrix, queries, k, n_docs)


def kernel_takes(doc_matrix: torch.Tensor, k: int) -> bool:
    """The route rule: the kernel serves ``1 <= k <= min(256, N)`` and
    ``D <= 1024`` (``pallas_topk.py``'s ``k > 256`` refusal; the TPU-only
    small-N clause does not apply, the kernel takes any N >= 1)."""
    n, dim = doc_matrix.shape
    return 1 <= k <= min(MAX_K, n) and dim <= MAX_DIM


def score_topk(
    doc_matrix: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    n_docs: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k dot-product scores per query: the plain version for CPU
    tensors; on the card the CUDA kernel where ``kernel_takes`` the shape,
    else ``score_topk_torch``."""
    if doc_matrix.device.type == "cpu" and queries.device.type == "cpu":
        return score_topk_reference(doc_matrix, queries, k, n_docs)
    if kernel_takes(doc_matrix, k):
        return score_topk_cuda(doc_matrix, queries, k, n_docs)
    return score_topk_torch(doc_matrix, queries, k, n_docs)
