"""Model weights made from the seed, on the device, in the JAX checkpoint
layout that the program loads (``convert.params_from_jax``) and that the
plain reference reads as it is.

The rules are the program's own initialisers: the table N(0, 1) with a zero
padding row, positions 0.02 N(0, 1), every linear's weight and bias
U(-1/sqrt(fan_in), 1/sqrt(fan_in)) stored (in, out), layer norms 1 and 0.
All normal draws come from one ``randn`` and all uniform ones from one
``rand`` of a ``torch.Generator`` on the device, seeded with the run's seed.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

Leaf = Tuple[Tuple[Any, ...], Tuple[int, ...], str, float]  # path, shape, rule, scale


def _linear(prefix: Tuple[Any, ...], w: str, b: str, fan_in: int, fan_out: int) -> List[Leaf]:
    bound = 1.0 / math.sqrt(fan_in)
    return [(prefix + (w,), (fan_in, fan_out), "uniform", bound),
            (prefix + (b,), (fan_out,), "uniform", bound)]


def mean_leaves(vocab: int, emb: int, hid: int, tied: bool) -> List[Leaf]:
    leaves = [(("embedding", "table"), (vocab, emb), "normal", 1.0)]
    for tower in ("query_tower",) + (() if tied else ("document_tower",)):
        leaves += _linear((tower,), "w1", "b1", emb, hid)
        leaves += _linear((tower,), "w2", "b2", hid, hid)
    return leaves


def transformer_leaves(vocab: int, emb: int, hid: int, layers: int, max_len: int,
                       tied: bool) -> List[Leaf]:
    leaves = [(("embedding", "table"), (vocab, emb), "normal", 1.0),
              (("embedding", "pos"), (max_len, emb), "normal", 0.02)]
    for tower in ("query_tower",) + (() if tied else ("document_tower",)):
        leaves += _linear((tower,), "proj_w", "proj_b", emb, hid)
        leaves += [((tower, "pos"), (max_len, hid), "normal", 0.02),
                   ((tower, "final_ln_scale"), (hid,), "ones", 1.0),
                   ((tower, "final_ln_bias"), (hid,), "zeros", 1.0)]
        for i in range(layers):
            block = (tower, "layers", i)
            for ln in ("ln1", "ln2"):
                leaves += [(block + (f"{ln}_scale",), (hid,), "ones", 1.0),
                           (block + (f"{ln}_bias",), (hid,), "zeros", 1.0)]
            for m in ("q", "k", "v", "o"):
                leaves += _linear(block, f"{m}_w", f"{m}_b", hid, hid)
            leaves += _linear(block, "ffn1_w", "ffn1_b", hid, 4 * hid)
            leaves += _linear(block, "ffn2_w", "ffn2_b", 4 * hid, hid)
    return leaves


def make(leaves: List[Leaf], seed: int, device: torch.device) -> Dict[str, Any]:
    """The tree of f32 tensors on ``device``; the table's row 0 is zero."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    counts = {rule: sum(math.prod(shape) for _, shape, r, _ in leaves if r == rule)
              for rule in ("normal", "uniform")}
    normal = torch.randn(counts["normal"], generator=gen, device=device)
    uniform = torch.rand(counts["uniform"], generator=gen, device=device)
    used = {"normal": 0, "uniform": 0}
    tree: Dict[str, Any] = {}
    for path, shape, rule, scale in leaves:
        n = math.prod(shape)
        if rule == "normal":
            value = normal[used[rule]:used[rule] + n].view(shape) * scale
        elif rule == "uniform":
            value = (uniform[used[rule]:used[rule] + n].view(shape) * 2.0 - 1.0) * scale
        else:
            value = (torch.ones if rule == "ones" else torch.zeros)(shape, device=device)
        used[rule] = used.get(rule, 0) + n
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    tree["embedding"]["table"][0] = 0.0
    return _lists(tree)


def _lists(node: Any) -> Any:
    """Dicts keyed 0..n-1 become lists (the transformer's ``layers``)."""
    if not isinstance(node, dict):
        return node
    node = {key: _lists(value) for key, value in node.items()}
    if node and all(isinstance(key, int) for key in node):
        return [node[i] for i in range(len(node))]
    return node


def to_numpy(tree: Any) -> Any:
    """The same tree as numpy arrays on the host (what a checkpoint holds)."""
    if isinstance(tree, dict):
        return {key: to_numpy(value) for key, value in tree.items()}
    if isinstance(tree, list):
        return [to_numpy(value) for value in tree]
    return tree.detach().cpu().numpy().astype(np.float32)
