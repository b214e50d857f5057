"""Weights carried between the JAX package's param pytree and a TwoTower.

The JAX tree, as nested dicts of numpy arrays::

    {'embedding': {'table'},
     'query_tower': {'w1', 'b1', 'w2', 'b2'}            # mean
                 or {'proj_w', 'proj_b', 'ln_scale', 'ln_bias'}  # avg_pool
                 or {}                                   # avg_pool, hidden == emb
     ['document_tower': same keys, absent when tied]}

JAX linears are ``(in, out)`` and applied as ``x @ w``; ``nn.Linear.weight``
is ``(out, in)``, so every linear weight is transposed on the way.
"""

from __future__ import annotations

from typing import Any, Dict

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


def params_from_jax(tree: Dict[str, Any], spec: TwoTowerSpec) -> TwoTower:
    """A TwoTower of ``spec`` holding the weights of the JAX tree ``tree``.
    Keys or shapes that do not match the spec raise."""
    model = TwoTower(spec)
    leaves = _TOWER_LEAVES[spec.tower.arch]
    state = {"embedding.table": torch.from_numpy(np.array(tree["embedding"]["table"],
                                                          np.float32))}
    for name, tower in _towers(model):
        params = tree.get(name, {})
        for torch_name in tower.state_dict():
            jax_name, transposed = leaves[torch_name]
            value = np.array(params[jax_name], np.float32)
            state[f"{name}.{torch_name}"] = torch.from_numpy(
                np.ascontiguousarray(value.T) if transposed else value)
    model.load_state_dict(state, strict=True)
    return model


def params_to_jax(model: TwoTower) -> Dict[str, Any]:
    """The JAX param tree (nested dicts of f32 numpy arrays) of ``model``."""
    tree: Dict[str, Any] = {"embedding": {
        "table": model.embedding.table.detach().cpu().numpy().copy()}}
    leaves = _TOWER_LEAVES[model.spec.tower.arch]
    for name, tower in _towers(model):
        tree[name] = {}
        for torch_name, value in tower.state_dict().items():
            jax_name, transposed = leaves[torch_name]
            value = value.detach().cpu().numpy()
            tree[name][jax_name] = np.ascontiguousarray(value.T if transposed else value)
    return tree
