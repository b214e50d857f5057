"""Operations of the Moonlight-16B-A3B tower's training step, counted from
its shapes, and the least time of its held experts' products.

Nothing here reads the program. A matrix product of an (n, k) by a (k, m)
operand is 2 n k m FLOPs forward and twice that backward (the gradients of
both operands), so a parameter that touches a row costs 6 FLOPs a training
step. The lookup, the norms, the router's top-k and the dispatch and
combine are no matrix product.
"""

from __future__ import annotations

from typing import Any, Dict

from .counts import H100_FLOPS


def mla_params(enc: Dict[str, Any]) -> int:
    """Weights of one latent attention that a token passes through."""
    d, h = int(enc["hidden_dim"]), int(enc["num_heads"])
    nope, rope, v = (int(enc[k]) for k in ("qk_nope_head_dim", "qk_rope_head_dim",
                                            "v_head_dim"))
    rank = int(enc["kv_lora_rank"])
    return d * h * (nope + rope) + d * (rank + rope) + rank * h * (nope + v) + h * v * d


def attention_flops(enc: Dict[str, Any], seq: int) -> float:
    """Forward FLOPs of one layer's scores and weighted values, a token
    against ``seq`` keys: 2 L H (d_qk + d_v)."""
    h = int(enc["num_heads"])
    return 2.0 * seq * h * (int(enc["qk_nope_head_dim"]) + int(enc["qk_rope_head_dim"])
                            + int(enc["v_head_dim"]))


def token_flops(enc: Dict[str, Any], seq: int) -> float:
    """Forward FLOPs a token position of a text of ``seq`` positions: every
    layer's attention and MLP; in an expert layer the router, the shared
    experts and its share of the held experts (``top_k`` of
    ``n_routed_experts`` picks, of which ``held`` are here: each expert is
    taken by ``top_k / n_routed`` of the tokens)."""
    d = int(enc["hidden_dim"])
    layers, dense = int(enc["num_layers"]), int(enc["first_k_dense"])
    n_routed, top_k = int(enc["n_routed_experts"]), int(enc["num_experts_per_tok"])
    held = int(enc["experts_held"][1]) if enc.get("experts_held") else n_routed
    inner = int(enc["moe_intermediate_size"])
    dense_mlp = 3 * d * int(enc["intermediate_size"])
    moe = d * n_routed + 3 * d * inner * int(enc["n_shared_experts"]) \
        + 3 * d * inner * held * top_k / n_routed
    per_layer_attn = 2.0 * mla_params(enc) + attention_flops(enc, seq)
    return layers * per_layer_attn + 2.0 * (dense * dense_mlp + (layers - dense) * moe)


def step_flops(enc: Dict[str, Any], batch: int, query_len: int, passage_len: int) -> float:
    """Model FLOPs of one train step with the ``in_batch`` loss: both
    towers over every position of the padded batch (pads included, as the
    step computes them), forward and backward (3x), plus the loss's
    similarity product (2 B^2 D forward, 3x)."""
    d = int(enc["hidden_dim"])
    fwd = batch * (query_len * token_flops(enc, query_len)
                   + passage_len * token_flops(enc, passage_len))
    return 3.0 * fwd + 3.0 * 2 * batch * batch * d


def experts_bound_s(assignments: float, dim: int, inner: int) -> float:
    """Least seconds of the held experts' products for ``assignments``
    token-expert pairs, forward and backward: 3 weights of ``dim`` x
    ``inner`` at 6 FLOPs a parameter and pair, at the bf16 peak."""
    return 18.0 * assignments * dim * inner / H100_FLOPS["bfloat16"]
