"""Plain reference of the training cell: the positional embedding, the
pre-LN transformer tower with its dropout, the in-batch softmax loss and
AdamW, in plain PyTorch on f32 parameters.

From the configuration's equations, reading only the weights the benchmark
made (JAX layout) and the batches the step was fed:

* embedding: ``table[ids]``, plus ``pos[:L]`` on real tokens (id > 0);
* tower: ``x = e @ proj_w + proj_b + pos[:L]``; per block
  ``x += drop(attn(ln1(x)))``, ``x += drop(ffn(ln2(x)))`` with 4 heads,
  scores scaled by 1/sqrt(head_dim), a -1e30 bias on pad keys (none where a
  row has no real token), softmax, and ``gelu_tanh(h @ ffn1) @ ffn2``; then
  ``ln(x)`` (eps 1e-5), the mean over real tokens (1e-9 on the count) and a
  unit norm (clamp 1e-12);
* dropout: keep where ``rand(shape) < 1 - rate``, scaled by ``1 / (1 -
  rate)``, each mask drawn from a ``torch.Generator`` on the device seeded
  with the run's seed, in order: the query tower's blocks (attention, then
  FFN, block by block), then the document tower's (the same tower: tied);
* loss: ``-log_softmax(q @ d.T / temperature)`` on the diagonal, pad
  columns (weight 0) masked out of the negatives, the weighted mean;
* AdamW (b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay) by hand.

``cast`` rounds the operands of every product (``precision.caster``), so
the same code in ``fp8`` is the control.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30
LOSS_NEG_INF = -1e9


def _ln(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, scale.shape, scale, bias, 1e-5)


def _dropout(x: torch.Tensor, rate: float, gen: torch.Generator) -> torch.Tensor:
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0)


def tower(params: Dict[str, Any], ids: torch.Tensor, heads: int, rate: float,
          gen: torch.Generator, cast: Callable, tower_key: str = "query_tower") -> torch.Tensor:
    emb, tw = params["embedding"], params[tower_key]
    batch, seq = ids.shape
    real = ids > 0
    e = emb["table"][ids] + torch.where(real[..., None], emb["pos"][:seq], 0.0)
    x = cast(e) @ cast(tw["proj_w"]) + tw["proj_b"] + tw["pos"][:seq]
    bias = torch.where(real[:, None, None, :], 0.0, NEG_INF)
    bias = torch.where(real.any(dim=-1)[:, None, None, None], bias, 0.0)
    hid = x.shape[-1]
    hd = hid // heads
    for blk in tw["layers"]:
        h = _ln(x, blk["ln1_scale"], blk["ln1_bias"])
        q, k, v = ((cast(h) @ cast(blk[f"{m}_w"]) + blk[f"{m}_b"]).view(batch, seq, heads, hd)
                   for m in ("q", "k", "v"))
        scores = torch.einsum("bqhd,bkhd->bhqk", cast(q), cast(k)) / math.sqrt(hd) + bias
        w = torch.softmax(scores, dim=-1)
        a = torch.einsum("bhqk,bkhd->bqhd", cast(w), cast(v)).reshape(batch, seq, hid)
        x = x + _dropout(cast(a) @ cast(blk["o_w"]) + blk["o_b"], rate, gen)
        h = _ln(x, blk["ln2_scale"], blk["ln2_bias"])
        h = F.gelu(cast(h) @ cast(blk["ffn1_w"]) + blk["ffn1_b"], approximate="tanh")
        x = x + _dropout(cast(h) @ cast(blk["ffn2_w"]) + blk["ffn2_b"], rate, gen)
    x = _ln(x, tw["final_ln_scale"], tw["final_ln_bias"])
    mask = real.float()[..., None]
    pooled = (x * mask).sum(dim=1) / (mask.sum(dim=1) + 1e-9)
    return pooled / torch.clamp_min(torch.linalg.vector_norm(pooled, dim=-1, keepdim=True), 1e-12)


def in_batch_loss(q: torch.Tensor, d: torch.Tensor, weights: torch.Tensor,
                  temperature: float, cast: Callable) -> torch.Tensor:
    logits = (cast(q) @ cast(d).T) / temperature
    eye = torch.eye(len(q), dtype=torch.bool, device=q.device)
    logits = torch.where(weights.bool()[None, :] | eye, logits, LOSS_NEG_INF)
    per = -torch.log_softmax(logits, dim=-1).diagonal()
    return (per * weights).sum() / torch.clamp_min(weights.sum(), 1.0)


def leaves(tree: Any, path: Tuple = ()) -> List[Tuple[Tuple, torch.Tensor]]:
    if isinstance(tree, dict):
        return [x for key in tree for x in leaves(tree[key], path + (key,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in leaves(v, path + (i,))]
    return [(path, tree)]


def _rebuild(tree: Any, values: Dict[Tuple, torch.Tensor], path: Tuple = ()) -> Any:
    if isinstance(tree, dict):
        return {key: _rebuild(v, values, path + (key,)) for key, v in tree.items()}
    if isinstance(tree, list):
        return [_rebuild(v, values, path + (i,)) for i, v in enumerate(tree)]
    return values[path]


def train_steps(tree: Any, batches, *, heads: int, rate: float, temperature: float,
                lr: float, weight_decay: float, seed: int, cast: Callable,
                tied: bool = True) -> Dict[str, Any]:
    """Run the steps of ``batches`` ((queries, positives, weights) each)
    from the weights ``tree``. Returns the losses, the first step's
    gradient and the change of the parameters over all the steps, by leaf
    path."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    gen = torch.Generator(device=batches[0][0].device).manual_seed(int(seed) % (2 ** 63))
    start = {p: v.detach().float().clone() for p, v in leaves(tree)}
    params = {p: v.clone().requires_grad_(True) for p, v in start.items()}
    m = {p: torch.zeros_like(v) for p, v in start.items()}
    s = {p: torch.zeros_like(v) for p, v in start.items()}
    losses, first_grad = [], None
    for t, (queries, positives, weights) in enumerate(batches, start=1):
        nested = _rebuild(tree, params)
        q = tower(nested, queries.long(), heads, rate, gen, cast)
        d = tower(nested, positives.long(), heads, rate, gen, cast,
                  "query_tower" if tied else "document_tower")
        loss = in_batch_loss(q, d, weights.float(), temperature, cast)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()),
                                                     allow_unused=True)))
        grads = {p: torch.zeros_like(params[p]) if g is None else g for p, g in grads.items()}
        losses.append(float(loss.detach()))
        if first_grad is None:
            first_grad = {p: g.detach().clone() for p, g in grads.items()}
        with torch.no_grad():
            for p, g in grads.items():
                w = params[p]
                w.mul_(1.0 - lr * weight_decay)
                m[p].mul_(b1).add_(g, alpha=1.0 - b1)
                s[p].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                denom = (s[p] / (1.0 - b2 ** t)).sqrt() + eps
                w.addcdiv_(m[p], denom, value=-lr / (1.0 - b1 ** t))
    change = {p: (params[p].detach() - start[p]) for p in params}
    return {"losses": losses, "first_grad": first_grad, "change": change}


def leaf_norms(values: Dict[Tuple, torch.Tensor]) -> Dict[Tuple, float]:
    return {p: float(torch.linalg.vector_norm(v.float())) for p, v in values.items()}


def worst_leaf_gap(got: Dict[Tuple, float], want: Dict[Tuple, float], paths) -> float:
    """The widest gap between the program's norm of a leaf and the
    reference's, over the leaves ``paths``, against the reference's norm of
    that leaf or of the median leaf, whichever is larger."""
    median = sorted(want[p] for p in paths)[len(paths) // 2]
    return max(abs(got[p] - want[p]) / max(want[p], median, 1e-30) for p in paths)


def compare(program: Dict[str, Any], reference: Dict[str, Any]) -> Dict[str, float]:
    """``loss_gap`` (widest relative gap of a step's loss), ``grad_gap``
    (first gradient) and ``change_gap`` (parameters' change, leaves whose
    reference gradient is under a thousandth of the median leaf's left
    out)."""
    ref_grad = leaf_norms(reference["first_grad"])
    ref_change = leaf_norms(reference["change"])
    paths = sorted(ref_grad, key=str)
    median = sorted(ref_grad[p] for p in paths)[len(paths) // 2]
    moving = [p for p in paths if ref_grad[p] >= 1e-3 * median]
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(program["losses"], reference["losses"]))
    return {"loss_gap": loss_gap,
            "grad_gap": worst_leaf_gap(program["first_grad_norms"], ref_grad, paths),
            "change_gap": worst_leaf_gap(program["change_norms"], ref_change, moving)}
