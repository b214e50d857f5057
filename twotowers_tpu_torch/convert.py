"""Weights and optimizer state carried between the JAX package's pytrees and
a TwoTower with its torch optimizer.

The JAX param tree, as nested dicts (and, for the transformer's
``layers``, a list of dicts) of numpy arrays::

    {'embedding': {'table'[, 'pos']},                    # lookup[, positional]
     'query_tower': {'w1', 'b1', 'w2', 'b2'}            # mean
                 or {'proj_w', 'proj_b', 'ln_scale', 'ln_bias'}  # avg_pool
                 or {}                                   # avg_pool, hidden == emb
                 or {'conv1_w', 'conv1_b', 'conv2_w', 'conv2_b',
                     'proj_w', 'proj_b'}                 # cnn
                 or {'w_x', 'w_h', 'b'}                  # rnn
                 or {'proj_w', 'proj_b', 'pos', 'final_ln_scale',
                     'final_ln_bias', 'layers': [{'ln1_scale', 'ln1_bias',
                     'q_w', 'q_b', 'k_w', ..., 'ffn2_b'}, ...]}  # transformer
                 or {'final_norm', 'layers': [{'attn_norm', 'q_w', 'kv_a_w',
                     'kv_a_norm', 'kv_b_w', 'o_w', 'mlp_norm',
                     'gate_up_w', 'down_w'}                     # dense layers
                     or {..., 'router_w', 'router_bias', 'shared_gate_up_w',
                     'shared_down_w', 'experts_gate_up_w',
                     'experts_down_w'}, ...]}                    # deepseek_v3
     ['document_tower': same keys, absent when tied]}

JAX linears are ``(in, out)`` and applied as ``x @ w``; ``nn.Linear.weight``
is ``(out, in)``. JAX convolutions are ``WIO (K, C_in, C_out)``;
``nn.Conv1d.weight`` is ``(C_out, C_in, K)``. Both are the reverse of all
axes, so every such weight is transposed (``.T``) on the way. The
``deepseek_v3`` tower has no JAX counterpart; its tree keeps the same
convention (``gate_up_w`` holds gate then up, ``(in, 2 * inner)``), its
stacked experts are ``(E, in, out)`` on both sides, and the router's
selection bias, a buffer, is the leaf ``router_bias``.

The optimizer state is optax's, with the moments under the param paths:
``{'count', 'mu': tree, 'nu': tree}`` (``ScaleByAdamState``, adam and adamw)
or ``{'trace': tree}`` (``TraceState``, sgd with momentum). A frozen table
is in optax's state with zero moments and in no torch optimizer.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from .models.towers import TwoTower, TwoTowerSpec

Path = Tuple[Union[str, int], ...]

# torch parameter name -> (JAX leaf name, transposed)
_TOWER_LEAVES = {
    "mean": {"fc1.weight": ("w1", True), "fc1.bias": ("b1", False),
             "fc2.weight": ("w2", True), "fc2.bias": ("b2", False)},
    "avg_pool": {"proj.weight": ("proj_w", True), "proj.bias": ("proj_b", False),
                 "norm.weight": ("ln_scale", False), "norm.bias": ("ln_bias", False)},
    "cnn": {"conv1.weight": ("conv1_w", True), "conv1.bias": ("conv1_b", False),
            "conv2.weight": ("conv2_w", True), "conv2.bias": ("conv2_b", False),
            "proj.weight": ("proj_w", True), "proj.bias": ("proj_b", False)},
    "rnn": {"x_proj.weight": ("w_x", True), "x_proj.bias": ("b", False),
            "h_proj.weight": ("w_h", True)},
    "transformer": {"proj.weight": ("proj_w", True), "proj.bias": ("proj_b", False),
                    "pos": ("pos", False), "final_ln.weight": ("final_ln_scale", False),
                    "final_ln.bias": ("final_ln_bias", False)},
}
_TOWER_LEAVES["deepseek_v3"] = {"final_norm.weight": ("final_norm", False)}
# a block's parameters, under ``layers.<i>.`` in torch and ``['layers'][i]``
# in JAX
_BLOCK_LEAVES = {
    "transformer": {
        **{f"{m}.weight": (f"{m}_w", True) for m in ("q", "k", "v", "o", "ffn1", "ffn2")},
        **{f"{m}.bias": (f"{m}_b", False) for m in ("q", "k", "v", "o", "ffn1", "ffn2")},
        **{f"{m}.weight": (f"{m}_scale", False) for m in ("ln1", "ln2")},
        **{f"{m}.bias": (f"{m}_bias", False) for m in ("ln1", "ln2")},
    },
    "deepseek_v3": {
        "attn_norm.weight": ("attn_norm", False), "mlp_norm.weight": ("mlp_norm", False),
        "attn.q_proj.weight": ("q_w", True), "attn.kv_a_proj.weight": ("kv_a_w", True),
        "attn.kv_a_norm.weight": ("kv_a_norm", False),
        "attn.kv_b_proj.weight": ("kv_b_w", True), "attn.o_proj.weight": ("o_w", True),
        "mlp.gate_up.weight": ("gate_up_w", True), "mlp.down.weight": ("down_w", True),
        "mlp.router.weight": ("router_w", True), "mlp.router_bias": ("router_bias", False),
        "mlp.shared.gate_up.weight": ("shared_gate_up_w", True),
        "mlp.shared.down.weight": ("shared_down_w", True),
        "mlp.experts_gate_up": ("experts_gate_up_w", False),
        "mlp.experts_down": ("experts_down_w", False),
    },
}


def _towers(model: TwoTower):
    yield "query_tower", model.query_tower
    if model.document_tower is not None:
        yield "document_tower", model.document_tower


def _tower_leaf(arch: str, torch_name: str) -> Tuple[Path, bool]:
    if arch in _BLOCK_LEAVES and torch_name.startswith("layers."):
        _, index, rest = torch_name.split(".", 2)
        leaf, transposed = _BLOCK_LEAVES[arch][rest]
        return ("layers", int(index), leaf), transposed
    leaf, transposed = _TOWER_LEAVES[arch][torch_name]
    return (leaf,), transposed


def _leaves(model: TwoTower) -> Iterator[Tuple[Path, torch.Tensor, bool]]:
    """(path in the JAX tree, parameter or buffer, transposed) for every
    parameter and persistent buffer."""
    yield ("embedding", "table"), model.embedding.table, False
    if model.embedding.pos is not None:
        yield ("embedding", "pos"), model.embedding.pos, False
    for name, tower in _towers(model):
        state = tower.state_dict(keep_vars=True)
        for torch_name, param in state.items():
            path, transposed = _tower_leaf(model.spec.tower.arch, torch_name)
            yield (name, *path), param, transposed


def _get(tree: Any, path: Path) -> Any:
    for key in path:
        tree = tree[key]
    return tree


def _lists(node: Any) -> Any:
    """Turn every dict keyed 0..n-1 into a list."""
    if not isinstance(node, dict):
        return node
    node = {key: _lists(value) for key, value in node.items()}
    if node and all(isinstance(key, int) for key in node):
        return [node[i] for i in range(len(node))]
    return node


def nest(leaves: Iterable[Tuple[Path, Any]], tree: Optional[Dict[str, Any]] = None
         ) -> Dict[str, Any]:
    """A tree of nested dicts from ``(path, value)`` pairs, added to
    ``tree``; the int keys of a path index lists."""
    tree = {} if tree is None else tree
    for path, value in leaves:
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return _lists(tree)


def _to_torch(value: Any, transposed: bool) -> torch.Tensor:
    value = np.array(value, np.float32)
    return torch.from_numpy(np.ascontiguousarray(value.T) if transposed else value)


def _to_jax(value: torch.Tensor, transposed: bool) -> np.ndarray:
    value = value.detach().float().cpu().numpy()
    return np.ascontiguousarray(value.T if transposed else value)


def _tree(model: TwoTower, value_of) -> Dict[str, Any]:
    tree: Dict[str, Any] = {"embedding": {}, **{name: {} for name, _ in _towers(model)}}
    return nest(((path, value_of(param, transposed))
                 for path, param, transposed in _leaves(model)), tree)


@torch.no_grad()
def load_params(model: TwoTower, tree: Dict[str, Any]) -> TwoTower:
    """Copy the JAX tree's weights into ``model`` in place (its parameters,
    and so an optimizer holding them, stay the same objects). Keys or
    shapes that do not match raise."""
    for path, param, transposed in _leaves(model):
        value = _to_torch(_get(tree, path), transposed)
        if value.shape != param.shape:
            raise ValueError(f"{'/'.join(map(str, path))}: shape {tuple(value.shape)} "
                             f"!= {tuple(param.shape)}")
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
    for path, param, transposed in _leaves(model):
        if id(param) not in held:
            continue
        as_param = lambda key: _to_torch(_get(tree[key], path), transposed).to(param.device)  # noqa: E731
        if _is_sgd(optimizer):
            optimizer.state[param] = {"momentum_buffer": as_param("trace")}
        else:
            optimizer.state[param] = {
                "step": torch.tensor(float(np.asarray(tree["count"])), dtype=torch.float32),
                "exp_avg": as_param("mu"),
                "exp_avg_sq": as_param("nu"),
            }
    return optimizer
