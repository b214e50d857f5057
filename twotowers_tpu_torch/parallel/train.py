"""Sharded training over the ('data', 'model') mesh.

The counterpart of ``twotowers_tpu/parallel/train.py``. Each rank holds its
data rank's rows of the batch, the towers whole and, when ``shard_vocab``
and the model axis is wider than 1, its row block of the embedding table,
looked up through ``sharded_embed_ids``. A pair loss (``in_batch``) takes
its negatives from the whole data group (``global_in_batch_loss``). A
per-sample loss (triplet, multiple negatives) scales each rank's weighted
mean by the rank's share of the global weight sum, and the sum over the
data group is the weighted mean of the global batch, as the JAX package
computes it on globally shaped arrays: a plain average of the ranks' means
would be wrong whenever pad rows fall unevenly.

After the backward the gradients of the towers and of each table shard are
summed over the data group, so every rank holds the gradient of the global
loss. ``grad_norm`` is the global norm: the table shards' squares are
summed over the model group; clipping uses it. The model-axis ranks of one
data rank compute the same towers on the same rows, so the dropout
generator is seeded by the data rank.

One deviation, on purpose: the JAX package's sharded lookup replaces
``embed_ids`` as a whole and drops the ``positional`` kind's learned
positions; here they are added as in the unsharded lookup.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..convert import opt_state_to_jax, params_to_jax
from ..models.losses import LossDef
from ..train.optim import OptimizerConfig, clip_by_global_norm_
from ..train.step import (
    Metrics, TrainState, _encode_for_loss, _metrics, trainable_parameters)
from .collectives import AllReduceSum, all_gather_rows, global_in_batch_loss
from .embedding_shard import sharded_embed_ids
from .mesh import DATA_AXIS, MODEL_AXIS, axis_group, axis_index, mesh_device, mesh_shape
from .sharding import local_rows, shard_params, table_block


def _loss_kwarg(loss_def: LossDef, name: str, default: float) -> float:
    kw = getattr(loss_def.fn, "keywords", None)
    if kw and name in kw:
        return float(kw[name])
    return default


def make_sharded_embed_fn(mesh: DeviceMesh) -> Callable:
    """An ``encode`` lookup backed by the row-sharded table; it adds the
    learned positions of the ``positional`` kind as the unsharded lookup
    does (the JAX package's drops them)."""

    def embed_fn(embedding, ids: torch.Tensor, dtype: torch.dtype = torch.float32):
        out = sharded_embed_ids(embedding.table, ids, mesh, dtype)
        return embedding.add_positions(out, ids, dtype)

    return embed_fn


def _sharded_loss_fn(loss_def: LossDef, mesh: DeviceMesh, shard_vocab: bool):
    """``(model, q, p, n, w, generator) -> (loss, aux)``: the loss of the
    global batch from this rank's rows, the same value on every rank. Its
    gradient on a rank is the part that flows through the rank's rows."""
    data_size, model_size = mesh_shape(mesh)
    embed_fn = make_sharded_embed_fn(mesh) if shard_vocab and model_size > 1 else None
    pair_loss = None
    if loss_def.arity == "pair" and data_size > 1:
        # the JAX package's step computes the in-batch softmax over the
        # global batch with or without ``global_negatives`` (GSPMD sees
        # globally shaped arrays); here that takes the all-gather
        temperature = _loss_kwarg(loss_def, "temperature", 0.1)
        pair_loss = lambda q, docs, w: global_in_batch_loss(  # noqa: E731
            q, docs, w, mesh, temperature)
    group = axis_group(mesh, DATA_AXIS)

    def loss_fn(model, queries, positives, negatives, weights, generator=None):
        loss, aux = _encode_for_loss(model, loss_def, queries, positives, negatives,
                                     weights, generator, embed_fn, pair_loss)
        if data_size == 1 or pair_loss is not None:
            return loss, aux
        # a weighted mean times max(weight sum, 1) is the weighted sum
        # (``_weighted_mean`` clamps at 1); sums over the group, divided by
        # the group's clamped weight sum, give the global weighted means
        local_w = weights.sum()
        scale = torch.clamp_min(local_w, 1.0)
        sums = AllReduceSum.apply(torch.stack([
            loss * scale, aux["pos_similarity"].detach() * scale,
            aux["neg_similarity"].detach() * scale, local_w.detach()]), group)
        loss, pos, neg = sums[:3] / torch.clamp_min(sums[3].detach(), 1.0)
        return loss, {"pos_similarity": pos.detach(), "neg_similarity": neg.detach()}

    return loss_fn


def _all_reduce_(grads: List[torch.Tensor], group) -> None:
    """Sum ``grads`` over ``group`` in place, as one flat all_reduce."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    for g, part in zip(grads, torch.split(flat, [g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def make_sharded_train_step(
    loss_def: LossDef,
    optimizer: OptimizerConfig,
    mesh: DeviceMesh,
    *,
    shard_vocab: bool = True,
    global_negatives: bool = True,
) -> Callable[..., Tuple[TrainState, Metrics]]:
    """The train step over ``mesh``: ``(state, q, p, n, w) -> (state,
    metrics)`` on this rank's rows, with the signature and metrics of
    ``train.step.make_train_step``. ``global_negatives`` is accepted for
    the JAX package's signature; a pair loss takes the global batch's
    negatives either way, as there."""
    del global_negatives
    data_size, model_size = mesh_shape(mesh)
    loss_fn = _sharded_loss_fn(loss_def, mesh, shard_vocab)
    sharded_table = shard_vocab and model_size > 1
    data_group, model_group = axis_group(mesh, DATA_AXIS), axis_group(mesh, MODEL_AXIS)
    max_norm = optimizer.grad_clip_norm

    def step_fn(state: TrainState, queries, positives, negatives, weights):
        model = state.model
        model.train()
        params = trainable_parameters(model)
        for p in params:
            p.grad = None
        loss, aux = loss_fn(model, queries, positives, negatives, weights, state.generator)
        loss.backward()
        for p in params:  # optax updates (and decays) every param, used or not
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        if data_size > 1:
            _all_reduce_(grads, data_group)
        squares = [g.float().square().sum() for g in grads]
        if sharded_table and model.embedding.table.requires_grad:
            table_sq = squares[[id(p) for p in params].index(id(model.embedding.table))]
            dist.all_reduce(table_sq, group=model_group)
        norm = torch.sqrt(sum(squares))
        if max_norm:
            clip_by_global_norm_(grads, max_norm, norm)
        state.optimizer.step()
        state.step += 1
        return state, {**_metrics(loss, aux), "grad_norm": norm.detach()}

    return step_fn


def make_sharded_eval_step(
    loss_def: LossDef,
    mesh: DeviceMesh,
    *,
    shard_vocab: bool = True,
    global_negatives: bool = True,
) -> Callable[..., Metrics]:
    """The eval step over ``mesh`` (no gradient, no dropout): the same
    lookup and the same global loss as the sharded train step, with the
    signature of ``train.step.make_eval_step``."""
    del global_negatives
    loss_fn = _sharded_loss_fn(loss_def, mesh, shard_vocab)

    def eval_fn(model, queries, positives, negatives, weights) -> Metrics:
        model.eval()
        with torch.no_grad():
            loss, aux = loss_fn(model, queries, positives, negatives, weights)
        return _metrics(loss, aux)

    return eval_fn


def create_sharded_train_state(
    model,
    optimizer: OptimizerConfig,
    mesh: DeviceMesh,
    *,
    shard_vocab: bool = True,
    seed: int = 0,
) -> TrainState:
    """Keep this rank's part of ``model`` (``shard_params``), build the
    optimizer over it (AdamW is elementwise, and the padded rows stay zero)
    and seed the dropout generator with ``seed`` plus the data rank."""
    shard_params(model, mesh, shard_vocab)
    device = next(model.parameters()).device
    return TrainState(
        model=model,
        optimizer=optimizer.build(trainable_parameters(model)),
        step=0,
        generator=torch.Generator(device=device).manual_seed(
            seed + axis_index(mesh, DATA_AXIS)),
    )


def _tables(params: Dict[str, Any], opt_state: Optional[Dict[str, Any]]) -> List[Dict]:
    """The dicts that hold the embedding table in a params tree and in each
    of its optimizer moments."""
    holders = [params["embedding"]]
    for key in ("mu", "nu", "trace"):
        if opt_state is not None and key in opt_state:
            holders.append(opt_state[key]["embedding"])
    return holders


def sharded_state_to_jax(state: TrainState, mesh: DeviceMesh, vocab_size: int,
                         shard_vocab: bool = True) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The params and optax state of ``state`` in the JAX layout with the
    whole, unpadded table (and moments): the checkpoint of a single
    process. A collective: every rank of the mesh calls it."""
    params = params_to_jax(state.model)
    opt_state = opt_state_to_jax(state.model, state.optimizer)
    if shard_vocab and mesh_shape(mesh)[1] > 1:
        group = axis_group(mesh, MODEL_AXIS)
        for holder in _tables(params, opt_state):
            local = torch.from_numpy(holder["table"]).to(mesh_device(mesh))
            holder["table"] = all_gather_rows(local, group).cpu().numpy()[:vocab_size]
    return params, opt_state


def shard_state_tree(params: Dict[str, Any], opt_state: Optional[Dict[str, Any]],
                     mesh: DeviceMesh, shard_vocab: bool = True) -> None:
    """In place: the table of a whole (JAX-layout) checkpoint tree and of
    its moments cut to this rank's padded row block, as ``shard_params``
    cuts the model's, so that the tree loads into a sharded state."""
    if shard_vocab and mesh_shape(mesh)[1] > 1:
        for holder in _tables(params, opt_state):
            holder["table"] = table_block(holder["table"], mesh)


def shard_batch(mesh: DeviceMesh, *arrays: Optional[np.ndarray],
                device: Optional[torch.device] = None):
    """This rank's rows of each global batch array as tensors on ``device``
    (default: this rank's device of the mesh); ``None`` stays ``None``.
    Every rank builds the same seeded global batch; it is padded to a
    multiple of the data axis with PAD ids and weight 0
    (``sharding.local_rows``), and data rank ``d`` takes block ``d``."""
    device = mesh_device(mesh) if device is None else device
    return tuple(None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in local_rows(mesh, *arrays))
