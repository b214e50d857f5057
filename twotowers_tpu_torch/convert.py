"""Weights and optimizer state carried between the JAX package's pytrees and
a TwoTower with its torch optimizer.

The JAX param tree, as nested dicts of numpy arrays::

    {'embedding': {'table'},
     'query_tower': {'w1', 'b1', 'w2', 'b2'}            # mean
                 or {'proj_w', 'proj_b', 'ln_scale', 'ln_bias'}  # avg_pool
                 or {}                                   # avg_pool, hidden == emb
     ['document_tower': same keys, absent when tied]}

JAX linears are ``(in, out)`` and applied as ``x @ w``; ``nn.Linear.weight``
is ``(out, in)``, so every linear weight is transposed on the way.

The optimizer state is optax's, with the moments under the param paths:
``{'count', 'mu': tree, 'nu': tree}`` (``ScaleByAdamState``, adam and adamw)
or ``{'trace': tree}`` (``TraceState``, sgd with momentum). A frozen table
is in optax's state with zero moments and in no torch optimizer.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from .models.towers import TwoTower, TwoTowerSpec

# torch parameter name -> (JAX leaf name, transposed)
_TOWER_LEAVES = {
    "mean": {"fc1.weight": ("w1", True), "fc1.bias": ("b1", False),
             "fc2.weight": ("w2", True), "fc2.bias": ("b2", False)},
    "avg_pool": {"proj.weight": ("proj_w", True), "proj.bias": ("proj_b", False),
                 "norm.weight": ("ln_scale", False), "norm.bias": ("ln_bias", False)},
}


def _towers(model: TwoTower):
    yield "query_tower", model.query_tower
    if model.document_tower is not None:
        yield "document_tower", model.document_tower


def _leaves(model: TwoTower) -> Iterator[Tuple[str, str, torch.nn.Parameter, bool]]:
    """(JAX subtree, JAX leaf, parameter, transposed) for every parameter."""
    yield "embedding", "table", model.embedding.table, False
    leaves = _TOWER_LEAVES[model.spec.tower.arch]
    for name, tower in _towers(model):
        for torch_name, param in tower.named_parameters():
            jax_name, transposed = leaves[torch_name]
            yield name, jax_name, param, transposed


def _to_torch(value: Any, transposed: bool) -> torch.Tensor:
    value = np.array(value, np.float32)
    return torch.from_numpy(np.ascontiguousarray(value.T) if transposed else value)


def _to_jax(value: torch.Tensor, transposed: bool) -> np.ndarray:
    value = value.detach().float().cpu().numpy()
    return np.ascontiguousarray(value.T if transposed else value)


def _tree(model: TwoTower, value_of) -> Dict[str, Any]:
    tree: Dict[str, Any] = {"embedding": {}, **{name: {} for name, _ in _towers(model)}}
    for sub, leaf, param, transposed in _leaves(model):
        tree[sub][leaf] = value_of(param, transposed)
    return tree


@torch.no_grad()
def load_params(model: TwoTower, tree: Dict[str, Any]) -> TwoTower:
    """Copy the JAX tree's weights into ``model`` in place (its parameters,
    and so an optimizer holding them, stay the same objects). Keys or
    shapes that do not match raise."""
    for sub, leaf, param, transposed in _leaves(model):
        value = _to_torch(tree[sub][leaf], transposed)
        if value.shape != param.shape:
            raise ValueError(f"{sub}/{leaf}: shape {tuple(value.shape)} != {tuple(param.shape)}")
        param.copy_(value)
    return model


def params_from_jax(tree: Dict[str, Any], spec: TwoTowerSpec) -> TwoTower:
    """A TwoTower of ``spec`` holding the weights of the JAX tree ``tree``.
    Keys or shapes that do not match the spec raise."""
    return load_params(TwoTower(spec), tree)


def params_to_jax(model: TwoTower) -> Dict[str, Any]:
    """The JAX param tree (nested dicts of f32 numpy arrays) of ``model``."""
    return _tree(model, _to_jax)


def _is_sgd(optimizer: torch.optim.Optimizer) -> bool:
    return isinstance(optimizer, torch.optim.SGD)


def opt_state_to_jax(model: TwoTower, optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
    """The optax state of ``optimizer`` (bound to ``model``'s parameters):
    ``{'count', 'mu', 'nu'}`` for adam / adamw, ``{'trace'}`` for sgd."""
    def moment(key):
        def value_of(param, transposed):
            state = optimizer.state.get(param, {})
            if key not in state:  # frozen, or before the first step
                return np.zeros(tuple(reversed(param.shape)) if transposed else param.shape,
                                np.float32)
            return _to_jax(state[key], transposed)
        return value_of

    if _is_sgd(optimizer):
        return {"trace": _tree(model, moment("momentum_buffer"))}
    steps = [float(s["step"]) for s in optimizer.state.values() if "step" in s]
    return {"count": np.asarray(int(max(steps, default=0)), np.int32),
            "mu": _tree(model, moment("exp_avg")),
            "nu": _tree(model, moment("exp_avg_sq"))}


@torch.no_grad()
def opt_state_from_jax(tree: Dict[str, Any], model: TwoTower,
                       optimizer: torch.optim.Optimizer) -> torch.optim.Optimizer:
    """Load the optax state ``tree`` (as ``opt_state_to_jax`` gives it) into
    ``optimizer``, bound to ``model``'s parameters. Entries of parameters
    the optimizer does not hold (a frozen table) are skipped."""
    held = {id(p) for group in optimizer.param_groups for p in group["params"]}
    for sub, leaf, param, transposed in _leaves(model):
        if id(param) not in held:
            continue
        as_param = lambda key: _to_torch(tree[key][sub][leaf], transposed).to(param.device)  # noqa: E731
        if _is_sgd(optimizer):
            optimizer.state[param] = {"momentum_buffer": as_param("trace")}
        else:
            optimizer.state[param] = {
                "step": torch.tensor(float(np.asarray(tree["count"])), dtype=torch.float32),
                "exp_avg": as_param("mu"),
                "exp_avg_sq": as_param("nu"),
            }
    return optimizer
