"""Dense scoring + top-k over a document matrix.

The counterpart of ``twotowers_tpu/ops/topk_score.py``. Conventions are the
same: ``doc_matrix`` is ``(N, D)`` with real rows ``[0, n_docs)``, queries are
``(Q, D)``, both L2-unit so dot == cosine; results are ``(Q, k)`` float32
scores and int32 indices, best first, equal scores to the lower index.

On the card the route is chosen by shape before any launch, as the JAX
dispatcher declines shapes its Pallas kernel does not take: the hand-written
kernel (``kernels/topk.py``) when ``kernel_takes`` the shape, else
``score_topk_torch``. A failed build or launch of the kernel raises; it never
hands the call to another route. A CPU tensor goes to the plain version of the
route the shape would take on the card.

Queries are rounded as the JAX dispatcher rounds them. Its Pallas kernel casts
them to the docs' dtype; ``score_topk_xla``, where it sends ``k > 256``, widens
them and the docs to f32 unrounded. So the kernel and its plain version,
``score_topk_reference``, cast; the torch route casts at ``k <= 256`` (there
``D > 1024``, a shape the Pallas kernel takes) and calls
``score_topk_unrounded`` at ``k > 256``. Two deviations are TPU tuning the
port does not copy: at ``N < 2 * tile_n`` and at ``Q > 1024`` the Pallas
kernel declines and JAX gives the unrounded result, where the port casts.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..kernels.topk import MAX_DIM, MAX_K, score_topk_cuda
from ..utils.tracing import span

# the score of rows at or past n_docs (score_topk_xla's NEG_INF)
NEG_INF = -1e30

# calls of score_topk_torch so far; a run reads it to show which route it took
TORCH_ROUTE_CALLS = 0


def _sorted_topk(scores: torch.Tensor, k: int,
                 n_docs: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rows at or past ``n_docs`` masked, then the first k of a stable sort:
    ``torch.topk`` does not promise the lower-index order on ties."""
    if n_docs is not None:
        col = torch.arange(scores.shape[1], device=scores.device)
        scores = scores.masked_fill(col >= int(n_docs), NEG_INF)
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k].contiguous(), idx[:, :k].to(torch.int32)


def score_topk_reference(
    doc_matrix: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    n_docs: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch top-k of ``queries @ doc_matrix.T`` by the Pallas
    kernel's rule (``score_topk_pallas``), the kernel's plain version.

    Queries are cast to the docs' dtype, then both are widened so that the
    products are summed in float32.
    """
    return _sorted_topk(queries.to(doc_matrix.dtype).float() @ doc_matrix.float().T, k, n_docs)


def score_topk_unrounded(
    doc_matrix: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    n_docs: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch top-k by ``score_topk_xla``'s rule: queries and docs
    widened to float32 with no rounding of the queries to the docs' dtype,
    as ``jnp.dot`` promotes f32 queries and bf16 docs."""
    return _sorted_topk(queries.float() @ doc_matrix.float().T, k, n_docs)


def score_topk_plain(
    doc_matrix: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    n_docs: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain formula of the JAX route for ``k``: the Pallas cast at
    ``k <= 256``, ``score_topk_xla``'s unrounded product above."""
    plain = score_topk_reference if k <= MAX_K else score_topk_unrounded
    return plain(doc_matrix, queries, k, n_docs)


def score_topk_torch(
    doc_matrix: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    n_docs: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The route on the card for shapes the kernel does not take (``k > 256``
    or ``D > 1024``): a matmul and a stable sort, as ``score_topk_xla`` is a
    matmul and ``lax.top_k`` outside any Pallas kernel, with the queries
    rounded as ``score_topk_plain`` says."""
    global TORCH_ROUTE_CALLS
    TORCH_ROUTE_CALLS += 1
    return score_topk_plain(doc_matrix, queries, k, n_docs)


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
    """Top-k dot-product scores per query: on the card the CUDA kernel where
    ``kernel_takes`` the shape, else ``score_topk_torch``; for CPU tensors
    the plain formula of that route (``score_topk_plain``). ``k < 0``
    raises ValueError on every route, as ``lax.top_k`` does; ``k = 0``
    gives empty (Q, 0) results. While a profiler runs, the call is the span
    ``score_topk`` with its shapes and its route (``plain``, ``kernel`` or
    ``torch``)."""
    if k < 0:
        raise ValueError(f"k argument to top_k must be nonnegative, got {k}")
    if doc_matrix.device.type == "cpu" and queries.device.type == "cpu":
        route, fn = "plain", score_topk_plain
    elif kernel_takes(doc_matrix, k):
        route, fn = "kernel", score_topk_cuda
    else:
        route, fn = "torch", score_topk_torch
    with span("score_topk", n_docs=doc_matrix.shape[0] if n_docs is None else n_docs,
              dim=doc_matrix.shape[1], queries=queries.shape[0], k=k, dtype=doc_matrix.dtype,
              route=route):
        return fn(doc_matrix, queries, k, n_docs)
