"""Contrastive training objectives on (query, document) unit vectors.

The counterpart of ``twotowers_tpu/models/losses.py``: the hinge triplet,
multiple-negatives InfoNCE, in-batch sampled softmax and cosine embedding
losses, each registered with the batch arity it consumes. Every loss takes
per-sample ``weights`` (1 real / 0 pad) and takes a weighted mean, so the
padded last batch of an epoch gives the mean over its real rows; pad rows
are also masked out of the in-batch negative pool. Each returns
``(loss, {"pos_similarity", "neg_similarity"})``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..ops.core import cosine_similarity
from ..utils.registry import Registry

LOSS_REGISTRY = Registry("loss")

NEG_INF = -1e9

Aux = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class LossDef:
    """A loss function plus the batch arity it consumes.

    arity:
        'triplet'   -> fn(q, pos, neg, weights)        with (B, D) vectors
        'pair'      -> fn(q, docs, weights)            with (B, D) vectors
        'multi_neg' -> fn(q, pos, negs, weights)       negs is (B, N, D)
    """

    fn: Callable[..., Tuple[torch.Tensor, Aux]]
    arity: str


def _weighted_mean(values: torch.Tensor, weights: Optional[torch.Tensor]) -> torch.Tensor:
    if weights is None:
        return values.mean()
    weights = weights.to(values.dtype)
    return (values * weights).sum() / torch.clamp_min(weights.sum(), 1.0)


def contrastive_triplet_loss(
    q: torch.Tensor, pos: torch.Tensor, neg: torch.Tensor,
    weights: Optional[torch.Tensor] = None, margin: float = 0.2,
) -> Tuple[torch.Tensor, Aux]:
    """Hinge triplet loss: mean(relu(margin - cos(q,pos) + cos(q,neg)))."""
    sim_pos = cosine_similarity(q, pos)
    sim_neg = cosine_similarity(q, neg)
    per_sample = torch.clamp_min(margin - sim_pos + sim_neg, 0.0)
    loss = _weighted_mean(per_sample, weights)
    aux = {
        "pos_similarity": _weighted_mean(sim_pos, weights),
        "neg_similarity": _weighted_mean(sim_neg, weights),
    }
    return loss, aux


def multiple_negatives_loss(
    q: torch.Tensor, pos: torch.Tensor, negs: torch.Tensor,
    weights: Optional[torch.Tensor] = None, temperature: float = 0.1,
) -> Tuple[torch.Tensor, Aux]:
    """InfoNCE over 1 positive + N explicit negatives per query. ``negs`` is
    (B, N, D); the positive sits at logit index 0, the target."""
    candidates = torch.cat([pos[:, None, :], negs], dim=1)  # (B, N+1, D)
    sims = cosine_similarity(q[:, None, :], candidates, dim=-1)  # (B, N+1)
    logits = sims / temperature
    per_sample = -torch.log_softmax(logits, dim=-1)[:, 0]
    loss = _weighted_mean(per_sample, weights)
    aux = {
        "pos_similarity": _weighted_mean(sims[:, 0], weights),
        "neg_similarity": _weighted_mean(sims[:, 1:].mean(dim=-1), weights),
    }
    return loss, aux


def in_batch_sampled_softmax_loss(
    q: torch.Tensor, docs: torch.Tensor,
    weights: Optional[torch.Tensor] = None, temperature: float = 0.1,
) -> Tuple[torch.Tensor, Aux]:
    """In-batch softmax: every other document in the batch is a negative.
    Raw dot-product logits (the towers' vectors are unit-norm), diagonal
    labels; pad rows (weight 0) never act as negatives."""
    batch = q.shape[0]
    dots = q @ docs.T
    logits = dots / temperature  # (B, B)
    if weights is not None:
        col_mask = weights.bool()[None, :]
        eye = torch.eye(batch, dtype=torch.bool, device=q.device)
        logits = torch.where(col_mask | eye, logits, torch.full_like(logits, NEG_INF))
    diag = torch.arange(batch, device=q.device)
    per_sample = -torch.log_softmax(logits, dim=-1)[diag, diag]
    loss = _weighted_mean(per_sample, weights)
    sims = cosine_similarity(q, docs)
    off_diag_sum = dots
    if weights is not None:
        off_diag_sum = off_diag_sum * weights[None, :]
        denom = torch.clamp_min(weights.sum() - 1.0, 1.0)
    else:
        denom = torch.tensor(float(max(batch - 1, 1)), dtype=q.dtype, device=q.device)
    neg_mean = (off_diag_sum.sum(dim=1) - torch.diagonal(dots)) / denom
    aux = {
        "pos_similarity": _weighted_mean(sims, weights),
        "neg_similarity": _weighted_mean(neg_mean, weights),
    }
    return loss, aux


def cosine_embedding_loss(
    q: torch.Tensor, pos: torch.Tensor, neg: torch.Tensor,
    weights: Optional[torch.Tensor] = None, margin: float = 0.0,
) -> Tuple[torch.Tensor, Aux]:
    """Cosine embedding loss over the triplet: pull ``1 - cos(q, pos)`` to
    zero, push ``relu(cos(q, neg) - margin)`` to zero."""
    sim_pos = cosine_similarity(q, pos)
    sim_neg = cosine_similarity(q, neg)
    per_sample = (1.0 - sim_pos) + torch.clamp_min(sim_neg - margin, 0.0)
    loss = _weighted_mean(per_sample, weights)
    aux = {
        "pos_similarity": _weighted_mean(sim_pos, weights),
        "neg_similarity": _weighted_mean(sim_neg, weights),
    }
    return loss, aux


LOSS_REGISTRY.add("triplet", LossDef(contrastive_triplet_loss, "triplet"))
LOSS_REGISTRY.add("multiple_negatives", LossDef(multiple_negatives_loss, "multi_neg"))
LOSS_REGISTRY.add("in_batch", LossDef(in_batch_sampled_softmax_loss, "pair"))
LOSS_REGISTRY.add("cosine", LossDef(cosine_embedding_loss, "triplet"))
# "contrastive" is the hinge triplet under the name of its config docs
LOSS_REGISTRY.add("contrastive", LossDef(contrastive_triplet_loss, "triplet"))


def build_loss(name: str, **kwargs: Any) -> LossDef:
    """Look up a loss and bind config kwargs (margin/temperature/...)."""
    base = LOSS_REGISTRY.get(name)
    if kwargs:
        return LossDef(functools.partial(base.fn, **kwargs), base.arity)
    return base
