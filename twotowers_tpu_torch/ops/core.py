"""Elementary ops shared by towers and the index.

The PyTorch counterparts of ``twotowers_tpu/ops/core.py``, with the same eps
constants: masked mean pooling, L2 normalisation (``F.normalize``
semantics) and cosine similarity (``F.cosine_similarity`` semantics).
"""

from __future__ import annotations

import torch

# encoders' +1e-9 on the token-count denominator; F.normalize and
# F.cosine_similarity clamp norms at 1e-12 and 1e-8
POOL_EPS = 1e-9
NORM_EPS = 1e-12
COSINE_EPS = 1e-8


def masked_mean_pool(embeddings: torch.Tensor, token_ids: torch.Tensor) -> torch.Tensor:
    """Mean-pool ``(..., seq_len, dim)`` embeddings over non-pad positions
    (PAD is id 0). All-pad rows pool to ~0 (eps-guarded)."""
    mask = (token_ids > 0).to(embeddings.dtype).unsqueeze(-1)
    summed = (embeddings * mask).sum(dim=-2)
    counts = mask.sum(dim=-2)
    return summed / (counts + POOL_EPS)


def _safe_norm(x: torch.Tensor, dim: int, keepdim: bool, eps: float) -> torch.Tensor:
    """L2 norm whose gradient is zero (not NaN) at x == 0: the clamp sits
    inside the sqrt, so the forward value is the plain norm wherever
    norm >= eps, and below eps the caller's denominator clamp dominates."""
    sq = (x * x).sum(dim=dim, keepdim=keepdim)
    return torch.sqrt(torch.clamp_min(sq, eps * eps))


def l2_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Unit-normalise along ``dim`` with F.normalize's eps clamp."""
    norm = _safe_norm(x, dim, keepdim=True, eps=NORM_EPS)
    return x / torch.clamp_min(norm, NORM_EPS)


def cosine_similarity(a: torch.Tensor, b: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Cosine similarity along ``dim`` (F.cosine_similarity semantics)."""
    a_norm = _safe_norm(a, dim, keepdim=False, eps=NORM_EPS)
    b_norm = _safe_norm(b, dim, keepdim=False, eps=NORM_EPS)
    dot = (a * b).sum(dim=dim)
    return dot / torch.clamp_min(a_norm * b_norm, COSINE_EPS)
