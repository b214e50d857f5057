"""Collectives over the mesh: global in-batch negatives and the top-k merge.

The counterpart of ``twotowers_tpu/parallel/collectives.py``.

* ``global_in_batch_loss``: each data rank all-gathers every rank's
  document vectors, so its logits are (B_local, B_global) and the label of
  its row ``i`` is ``rank_in_data * B_local + i``. The all-gather carries
  gradients: its backward sums the gradient over the data group and keeps
  the rank's own rows (``psum_scatter``, the transpose of JAX's
  ``all_gather``), written with ``all_reduce`` because gloo has no
  reduce-scatter on a sub-group.
* ``sharded_topk_merge``: the per-shard (Q, k) winners are all-gathered in
  shard order and reduced by a stable descending sort, which is exact (the
  global top-k lies in the union of the shards' top-k) and sends equal
  scores to the lower global index, as ``lax.top_k`` over (Q, S*k) does.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..models.losses import NEG_INF
from ..ops.core import cosine_similarity
from .mesh import DATA_AXIS, axis_group, axis_index, axis_size


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The group's tensors stacked along dim 0 in group order (no grad)."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


class AllGatherRows(torch.autograd.Function):
    """``all_gather`` along dim 0 whose backward is the gradient summed over
    the group, cut to this rank's rows."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        ctx.rows = x.shape[0]
        return all_gather_rows(x, group)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        start = dist.get_group_rank(ctx.group, dist.get_rank()) * ctx.rows
        return grad[start:start + ctx.rows], None


class AllReduceSum(torch.autograd.Function):
    """``all_reduce`` (sum) whose backward is the identity. That is the
    gradient only because every rank of the group goes on to compute the
    same loss from the sum (JAX's ``psum`` under ``shard_map``)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad, None


def global_in_batch_loss(
    q: torch.Tensor,
    docs: torch.Tensor,
    weights: Optional[torch.Tensor],
    mesh: DeviceMesh,
    temperature: float = 0.1,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """In-batch softmax whose negatives are the whole data group's
    documents. ``q`` and ``docs`` are this rank's (B_local, D) rows; the
    loss and the similarities are sums over the data group divided by the
    group's weight sum, the same on every rank. On a 1-wide data axis this
    is the local in-batch loss."""
    if weights is None:
        weights = torch.ones(q.shape[0], dtype=q.dtype, device=q.device)
    group = axis_group(mesh, DATA_AXIS)
    b_local = q.shape[0]

    all_docs = AllGatherRows.apply(docs, group)                  # (B_global, D)
    all_weights = all_gather_rows(weights, group)                # (B_global,)
    dots = q @ all_docs.T
    logits = dots / temperature                                  # (B_local, B_global)
    rows = torch.arange(b_local, device=q.device)
    labels = axis_index(mesh, DATA_AXIS) * b_local + rows

    # pad rows anywhere in the global batch must not serve as negatives
    keep = all_weights.bool()[None, :].repeat(b_local, 1)
    keep[rows, labels] = True
    masked = torch.where(keep, logits, torch.full_like(logits, NEG_INF))
    per_sample = -torch.log_softmax(masked, dim=-1)[rows, labels]

    weight_sum = all_weights.sum()
    with torch.no_grad():
        sims = cosine_similarity(q, docs)
        neg_rowsum = (dots * all_weights[None, :]).sum(dim=1)
        diag = (q * docs).sum(dim=-1)
        neg_mean = (neg_rowsum - diag) / torch.clamp_min(weight_sum - 1.0, 1.0)
    # one all_reduce for the three sums; only the loss's carries a gradient
    sums = AllReduceSum.apply(torch.stack([
        (per_sample * weights).sum(), (sims * weights).sum(), (neg_mean * weights).sum()]),
        group)
    loss, pos, neg = sums / torch.clamp_min(weight_sum, 1.0)
    return loss, {"pos_similarity": pos.detach(), "neg_similarity": neg.detach()}


def sharded_topk_merge(
    scores: torch.Tensor, indices: torch.Tensor, mesh: DeviceMesh, k: int,
    axis: str = "model",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge this shard's (Q, k_local) winners, whose indices are global,
    with the other shards' along ``axis`` into the exact (Q, k) global
    top-k, the same on every rank."""
    group = axis_group(mesh, axis)
    if axis_size(mesh, axis) == 1:
        all_scores, all_indices = scores, indices
    else:
        all_scores = all_gather_rows(scores.T, group).T              # (Q, S*k_local)
        all_indices = all_gather_rows(indices.T, group).T
    best, pos = torch.sort(all_scores, dim=1, descending=True, stable=True)
    return best[:, :k].contiguous(), torch.gather(all_indices, 1, pos[:, :k])
