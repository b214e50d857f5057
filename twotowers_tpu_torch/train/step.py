"""The training and evaluation steps.

The counterpart of ``twotowers_tpu/train/step.py``. One call of the train
step runs forward (the towers the loss needs), loss, backward, the optimizer
update and the five metrics. The JAX package builds a fresh state each
step; here the state's model and optimizer are updated in place and the
same ``TrainState`` is returned. Metrics stay 0-d tensors on the device, so
the loop can read them one step late without stalling the card.

Loss arity (triplet / pair / multi_neg) decides which encodings are taken.
A frozen table (``trainable: false``) is not a trainable parameter: it gets
no gradient and is not in the optimizer, so it gets no update of any kind.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..models.losses import LossDef
from ..models.towers import TwoTower
from .optim import OptimizerConfig, clip_by_global_norm_, global_norm

Metrics = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    """Carried training state: model, optimizer, step counter and the
    generator that draws dropout masks."""

    model: TwoTower
    optimizer: torch.optim.Optimizer
    step: int
    generator: torch.Generator


def trainable_parameters(model: TwoTower) -> List[torch.nn.Parameter]:
    return [p for p in model.parameters() if p.requires_grad]


def create_train_state(model: TwoTower, optimizer: OptimizerConfig,
                       seed: int = 0) -> TrainState:
    device = next(model.parameters()).device
    return TrainState(
        model=model,
        optimizer=optimizer.build(trainable_parameters(model)),
        step=0,
        generator=torch.Generator(device=device).manual_seed(seed),
    )


def _encode_for_loss(
    model: TwoTower,
    loss_def: LossDef,
    queries: torch.Tensor,
    positives: torch.Tensor,
    negatives: Optional[torch.Tensor],
    weights: torch.Tensor,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, Metrics]:
    q = model.encode(queries, "query", generator)
    p = model.encode(positives, "document", generator)
    if loss_def.arity == "pair":
        return loss_def.fn(q, p, weights)
    if negatives is None:
        raise ValueError(f"Loss arity {loss_def.arity!r} requires negatives in the batch")
    if loss_def.arity == "multi_neg":
        batch, num_negs, seq = negatives.shape
        n = model.encode(negatives.reshape(batch * num_negs, seq), "document", generator)
        return loss_def.fn(q, p, n.reshape(batch, num_negs, -1), weights)
    n = model.encode(negatives, "document", generator)
    return loss_def.fn(q, p, n, weights)


def _metrics(loss: torch.Tensor, aux: Metrics) -> Metrics:
    pos, neg = aux["pos_similarity"].detach(), aux["neg_similarity"].detach()
    return {"loss": loss.detach(), "pos_similarity": pos, "neg_similarity": neg,
            "similarity_diff": pos - neg}


def make_train_step(
    loss_def: LossDef,
    optimizer: OptimizerConfig,
) -> Callable[..., Tuple[TrainState, Metrics]]:
    """Build the train step: (state, q, p, n, w) -> (state, metrics).

    ``metrics`` holds ``loss``, ``pos_similarity``, ``neg_similarity``,
    ``similarity_diff`` and ``grad_norm``, the global norm of the gradients
    before clipping (``optax.global_norm(grads)`` in the JAX step). The
    JAX step also takes the model's spec; here the model carries it.
    """
    max_norm = optimizer.grad_clip_norm

    def step_fn(state: TrainState, queries, positives, negatives, weights):
        model = state.model
        model.train()
        params = trainable_parameters(model)
        for p in params:
            p.grad = None
        loss, aux = _encode_for_loss(model, loss_def, queries, positives, negatives,
                                     weights, state.generator)
        loss.backward()
        for p in params:  # optax updates (and decays) every param, used or not
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        norm = global_norm(grads)
        if max_norm:
            clip_by_global_norm_(grads, max_norm, norm)
        state.optimizer.step()
        state.step += 1
        return state, {**_metrics(loss, aux), "grad_norm": norm.detach()}

    return step_fn


def make_eval_step(loss_def: LossDef) -> Callable[..., Metrics]:
    """Build the eval step: (model, q, p, n, w) -> metrics, without
    gradients or dropout."""

    def eval_fn(model: TwoTower, queries, positives, negatives, weights) -> Metrics:
        model.eval()
        with torch.no_grad():
            loss, aux = _encode_for_loss(model, loss_def, queries, positives, negatives,
                                         weights)
        return _metrics(loss, aux)

    return eval_fn
