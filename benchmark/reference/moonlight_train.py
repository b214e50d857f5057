"""Plain reference of the Moonlight-16B-A3B tower trained as a dual
encoder: DeepSeek-V3 blocks (multi-head latent attention, a leading dense
SwiGLU layer, then mixture-of-experts layers), the in-batch softmax loss,
their gradients and AdamW, in plain PyTorch on f32 parameters.

It follows ``modeling_deepseek.py`` (``model_type: deepseek_v3``) and the
published ``config.json``
(https://huggingface.co/moonshotai/Moonlight-16B-A3B/blob/main/config.json),
reading only the weights the benchmark made (JAX layout: linears ``(in,
out)``, stacked experts ``(E, in, out)``, ``gate_up`` gate then up) and the
batches the step was fed:

* embedding: ``table[ids]`` (no positions);
* a layer: ``x = x + mla(rmsnorm(x))``; ``x = x + mlp(rmsnorm(x))``, the MLP
  ``down(silu(gate(h)) * up(h))`` in the first ``first_k_dense`` layers and
  the expert layer after; then a final RMSNorm;
* RMSNorm: ``w * (x / sqrt(mean(x^2) + eps))``, eps 1e-5, but 1e-6 in
  ``kv_a_layernorm`` (``DeepseekV3RMSNorm``'s default, which
  ``modeling_deepseek.py`` leaves it);
* MLA without a query low rank: ``q = x @ q_w`` as 16 heads of 128 + 64;
  ``[c, k_pe] = x @ kv_a_w`` (512 + 64); ``[k_nope, v] = rmsnorm(c) @
  kv_b_w`` (128 + 128 a head); RoPE (theta 50,000, no scaling) on ``q_pe``
  and the one ``k_pe`` every head shares, by the model's own route: a
  head's 64 dims permuted to evens then odds, then ``x * cos +
  rotate_half(x) * sin``; scores ``q . k / sqrt(192)``, softmax, ``@ v``,
  ``@ o_w``;
* the expert layer: ``s = sigmoid(h @ router_w)`` in f32; the 6 experts
  of the largest ``s + router_bias``; their weights ``s`` over the sum of
  the 6 (+1e-20), times 2.446; the output is the shared experts' MLP (width
  2 x 1,408) plus, for each held expert, the weighted MLP of the tokens
  that chose it;
* pooling: the mean of the final RMSNorm over real tokens (id > 0; 1e-9 on
  the count), then a unit norm (clamp 1e-12);
* loss: ``transformer_train.in_batch_loss``; AdamW by hand (b1 0.9, b2
  0.999, eps 1e-8, decoupled weight decay).

Departures from the published model, which are the cell's (and the
configuration file's ``assumed``): attention is bidirectional, with the
key-pad mask only (a text with no real token attends over all its
positions), and the text's vector is the masked mean-pool, as NV-Embed
(arXiv:2405.17428) uses a decoder; there is no LM head; 5 of the 27
layers; the chip's share of expert parallelism over 8 chips: the router
scores all 64 experts, but only the held experts' terms are added (the
others lie on other chips), and the vocabulary is the chip's 20,480 rows;
the router's selection bias is given and held fixed (no update rule); no
dropout; the in-batch loss at temperature 0.02 and AdamW, as E5-Mistral
(arXiv:2401.00368) trains its embedder; random weights.

``cast`` rounds the operands of every product that the model runs in its
compute dtype (``precision.caster``; the router is f32 in the model and
here), so the same code in ``fp8`` is the control. ``train_steps`` computes
the embeddings in chunks and pushes the loss's gradient back chunk by
chunk (GradCache, arXiv:2101.06983), so that the batch fits on one card:
the gradients are those of the whole batch. Plain ``torch`` only, with no
kernel and no import of the program; ``precision.exact_matmuls`` keeps TF32
off.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from .transformer_train import _rebuild, in_batch_loss, leaves

KV_NORM_EPS = 1e-6


def arch_from_encoder(encoder: Dict[str, Any]) -> Dict[str, Any]:
    """The reference's settings from a config's ``encoder:`` block."""
    held = encoder.get("experts_held") or (0, int(encoder["n_routed_experts"]))
    return {"heads": int(encoder["num_heads"]), "nope": int(encoder["qk_nope_head_dim"]),
            "rope": int(encoder["qk_rope_head_dim"]), "v_dim": int(encoder["v_head_dim"]),
            "rank": int(encoder["kv_lora_rank"]), "first_dense": int(encoder["first_k_dense"]),
            "n_routed": int(encoder["n_routed_experts"]),
            "top_k": int(encoder["num_experts_per_tok"]),
            "scaling": float(encoder["routed_scaling_factor"]),
            "theta": float(encoder["rope_theta"]), "eps": float(encoder["rms_norm_eps"]),
            "held": (int(held[0]), int(held[1]))}


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    return weight * (x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps))


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """``apply_rotary_pos_emb`` of ``modeling_deepseek.py`` on ``x`` (B, H,
    L, d), positions 0..L-1: the dims permuted to evens then odds, then
    rotate-half with the angles repeated over both halves."""
    b, h, seq, d = x.shape
    inv_freq = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    freqs = torch.outer(torch.arange(seq, dtype=torch.float32, device=x.device), inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    x = x.view(b, h, seq, d // 2, 2).transpose(4, 3).reshape(b, h, seq, d)
    return x * emb.cos() + _rotate_half(x) * emb.sin()


def _mlp(x: torch.Tensor, gate_up: torch.Tensor, down: torch.Tensor, cast: Callable
         ) -> torch.Tensor:
    gate, up = (cast(x) @ cast(gate_up)).chunk(2, dim=-1)
    return cast(F.silu(gate) * up) @ cast(down)


def attention(blk: Dict[str, torch.Tensor], x: torch.Tensor, real: torch.Tensor,
              arch: Dict[str, Any], cast: Callable) -> torch.Tensor:
    batch, seq, _ = x.shape
    heads, nope, rope_dim, v_dim = arch["heads"], arch["nope"], arch["rope"], arch["v_dim"]
    q = (cast(x) @ cast(blk["q_w"])).view(batch, seq, heads, nope + rope_dim).transpose(1, 2)
    q_nope, q_pe = q.split([nope, rope_dim], dim=-1)
    c, k_pe = (cast(x) @ cast(blk["kv_a_w"])).split([arch["rank"], rope_dim], dim=-1)
    kv = (cast(rms_norm(c, blk["kv_a_norm"], KV_NORM_EPS)) @ cast(blk["kv_b_w"]))
    kv = kv.view(batch, seq, heads, nope + v_dim).transpose(1, 2)
    k_nope, v = kv.split([nope, v_dim], dim=-1)
    q_pe = rope(q_pe, arch["theta"])
    k_pe = rope(k_pe.view(batch, seq, 1, rope_dim).transpose(1, 2), arch["theta"])
    query = torch.cat([q_nope, q_pe], dim=-1)
    key = torch.cat([k_nope, k_pe.expand(-1, heads, -1, -1)], dim=-1)
    scores = (cast(query) @ cast(key).transpose(-1, -2)) * (nope + rope_dim) ** -0.5
    attend = real | ~real.any(dim=-1, keepdim=True)
    scores = scores.masked_fill(~attend[:, None, None, :], float("-inf"))
    out = cast(torch.softmax(scores, dim=-1)) @ cast(v)
    return cast(out.transpose(1, 2).reshape(batch, seq, heads * v_dim)) @ cast(blk["o_w"])


def route(h: torch.Tensor, blk: Dict[str, torch.Tensor], arch: Dict[str, Any]
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, top_k) chosen experts and their weights for f32 rows ``h``."""
    scores = torch.sigmoid(h @ blk["router_w"])
    chosen = torch.topk(scores.detach() + blk["router_bias"], arch["top_k"], dim=-1).indices
    weight = scores.gather(-1, chosen)
    return chosen, weight / (weight.sum(dim=-1, keepdim=True) + 1e-20) * arch["scaling"]


def moe(blk: Dict[str, torch.Tensor], h: torch.Tensor, arch: Dict[str, Any], cast: Callable,
        held: Tuple[int, int]) -> torch.Tensor:
    """The expert layer on (T, D) rows: the shared experts plus the held
    experts ``held`` (first, count) of ``blk``'s stacked ones."""
    out = _mlp(h, blk["shared_gate_up_w"], blk["shared_down_w"], cast)
    chosen, weight = route(h, blk, arch)
    first, n_held = held
    for e in range(n_held):
        hit = chosen == first + e
        tokens = hit.any(dim=-1).nonzero().squeeze(-1)
        if tokens.numel() == 0:
            continue
        w = (weight * hit).sum(dim=-1)[tokens, None]
        y = _mlp(h[tokens], blk["experts_gate_up_w"][e], blk["experts_down_w"][e], cast)
        out = out.index_add(0, tokens, w * y)
    return out


def tower(params: Dict[str, Any], ids: torch.Tensor, arch: Dict[str, Any], cast: Callable,
          tower_key: str = "query_tower") -> torch.Tensor:
    tw = params[tower_key]
    real = ids > 0
    x = params["embedding"]["table"][ids]
    batch, seq, dim = x.shape
    for i, blk in enumerate(tw["layers"]):
        x = x + attention(blk, rms_norm(x, blk["attn_norm"], arch["eps"]), real, arch, cast)
        h = rms_norm(x, blk["mlp_norm"], arch["eps"])
        if i < arch["first_dense"]:
            x = x + _mlp(h, blk["gate_up_w"], blk["down_w"], cast)
        else:
            x = x + moe(blk, h.reshape(-1, dim), arch, cast, arch["held"]).view(batch, seq, dim)
    x = rms_norm(x, tw["final_norm"], arch["eps"])
    mask = real.float()[..., None]
    pooled = (x * mask).sum(dim=1) / (mask.sum(dim=1) + 1e-9)
    return pooled / torch.clamp_min(torch.linalg.vector_norm(pooled, dim=-1, keepdim=True), 1e-12)


def _frozen(path) -> bool:
    return path[-1] == "router_bias"


def train_steps(tree: Any, batches, *, arch: Dict[str, Any], temperature: float, lr: float,
                weight_decay: float, cast: Callable, chunk: int = 64, tied: bool = True
                ) -> Dict[str, Any]:
    """Run the steps of ``batches`` ((queries, positives, weights) each)
    from the weights ``tree``, ``chunk`` texts at a time. Returns the
    losses, the first step's gradient and the change of the parameters over
    all the steps, by leaf path (the fixed selection bias: zero for both)."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    start = {p: v.detach().float().clone() for p, v in leaves(tree)}
    params = {p: v.clone().requires_grad_(not _frozen(p)) for p, v in start.items()}
    trained = [p for p in params if not _frozen(p)]
    m = {p: torch.zeros_like(start[p]) for p in trained}
    s = {p: torch.zeros_like(start[p]) for p in trained}
    losses, first_grad = [], None
    doc_key = "query_tower" if tied else "document_tower"
    for t, (queries, positives, weights) in enumerate(batches, start=1):
        nested = _rebuild(tree, params)
        sides = ((queries.long(), "query_tower"), (positives.long(), doc_key))
        with torch.no_grad():
            vectors = [torch.cat([tower(nested, ids[i:i + chunk], arch, cast, key)
                                  for i in range(0, len(ids), chunk)]) for ids, key in sides]
        vectors = [v.requires_grad_(True) for v in vectors]
        loss = in_batch_loss(*vectors, weights.float(), temperature, cast)
        cached = torch.autograd.grad(loss, vectors)
        for p in trained:
            params[p].grad = None
        for (ids, key), grad in zip(sides, cached):
            for i in range(0, len(ids), chunk):
                tower(nested, ids[i:i + chunk], arch, cast, key).backward(grad[i:i + chunk])
        grads = {p: torch.zeros_like(start[p]) if params[p].grad is None else params[p].grad
                 for p in trained}
        losses.append(float(loss.detach()))
        if first_grad is None:
            first_grad = {p: grads[p].detach().clone() if p in grads
                          else torch.zeros_like(start[p]) for p in params}
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
