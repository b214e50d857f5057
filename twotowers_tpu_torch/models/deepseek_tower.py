"""The ``deepseek_v3`` tower: DeepSeek-V3 blocks (multi-head latent
attention, a leading dense SwiGLU layer, then mixture-of-experts layers)
as a bidirectional text encoder.

The equations are ``modeling_deepseek.py``'s (``model_type: deepseek_v3``,
as Moonlight-16B-A3B publishes it), used as a dual-encoder tower in
NV-Embed's way (arXiv:2405.17428): no causal mask, the key-pad mask only,
then a final RMSNorm, the masked mean-pool over the real tokens and an L2
norm. There is no LM head, no positional table and no input projection:
the embedding is a ``lookup`` of width ``hidden_dim``.

* A layer: ``x = x + mla(rmsnorm(x))``, then ``x = x + mlp(rmsnorm(x))``;
  the MLP is a SwiGLU of width ``intermediate_size`` in the first
  ``first_k_dense`` layers and the expert layer (``moe.py``) after.
* RMSNorm: ``w * x / sqrt(mean(x^2) + eps)`` computed in f32 and cast back
  (the weight applied in f32; the backward by hand, keeping ``x`` and each
  row's f32 scale, not f32 copies of the rows); ``eps`` is ``rms_norm_eps``
  except for ``kv_a_layernorm``, which takes ``DeepseekV3RMSNorm``'s
  default 1e-6, as ``modeling_deepseek.py`` builds it.
* MLA without a query low rank (``q_lora_rank: null``): ``q = q_proj(x)``,
  heads of ``qk_nope_head_dim + qk_rope_head_dim``; ``[c, k_pe] =
  kv_a_proj(x)``, ``[k_nope, v] = kv_b_proj(kv_a_layernorm(c))`` a head;
  rotary positions on the ``qk_rope_head_dim`` decoupled dims of ``q`` and
  on ``k_pe``, which all heads share; scores scaled by ``(qk_nope_head_dim
  + qk_rope_head_dim) ** -0.5``; ``o_proj`` of the heads' outputs.
* RoPE rotates dims (2i, 2i+1) of a head by ``pos * rope_theta ** (-2i /
  d)``, positions 0..L-1 in each text: ``modeling_deepseek.py`` permutes a
  head's dims to evens then odds before its rotate-half, which gives the
  same products.
* A text with no real token attends over all its positions (its pooled
  vector is zero whatever they hold).

Parameters stay f32; products run in the compute dtype of the embeddings
(``precision: bf16``), the router and the norms in f32. Attention is
``F.scaled_dot_product_attention`` with a boolean key mask. While a profiler
runs the attention is the device span ``mla`` (forward), with attrs
``layer`` and ``tokens``. Dropout is not applied (the published model has
none).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.core import l2_normalize, masked_mean_pool
from ..utils.tracing import span
from .moe import MoE, SwiGLU
from .seq_towers import _dense, _init_linear, _linear

KV_NORM_EPS = 1e-6  # DeepseekV3RMSNorm's default, which kv_a_layernorm keeps


class _RMSNorm(torch.autograd.Function):
    """``(w * x / sqrt(mean(x^2) + eps))`` in f32, cast to ``x``'s dtype;
    the backward keeps ``x`` as it is and the f32 reciprocal of each row's
    root mean square, and computes in f32."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
        x32 = x.float()
        rstd = torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
        ctx.save_for_backward(x, weight, rstd)
        return (weight * (x32 * rstd)).to(x.dtype)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        x, weight, rstd = ctx.saved_tensors
        normed = x.float() * rstd
        g = grad.float()
        d_weight = (g * normed).reshape(-1, normed.shape[-1]).sum(dim=0)
        gw = g * weight
        d_x = rstd * (gw - normed * (gw * normed).mean(dim=-1, keepdim=True))
        return d_x.to(x.dtype), d_weight, None


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    @torch.no_grad()
    def reset_parameters(self) -> None:
        self.weight.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _RMSNorm.apply(x, self.weight, self.eps)


def rope_angles(seq: int, dim: int, theta: float, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each (seq, dim // 2) f32, of positions 0..seq-1."""
    inv_freq = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim)
    angles = torch.arange(seq, dtype=torch.float32, device=device)[:, None] * inv_freq
    return angles.cos(), angles.sin()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate the pairs (2i, 2i+1) of the last axis of ``x`` (B, L, H, d)
    by the angles of its position, in f32, cast back."""
    x32 = x.float().unflatten(-1, (-1, 2))
    even, odd = x32[..., 0], x32[..., 1]
    cos, sin = cos[:, None, :], sin[:, None, :]
    return torch.stack([even * cos - odd * sin, odd * cos + even * sin],
                       dim=-1).flatten(-2).to(x.dtype)


class MLA(nn.Module):
    def __init__(self, spec, layer: int = 0):
        super().__init__()
        d, h = spec.hidden_dim, spec.num_heads
        self.heads, self.layer = h, layer
        self.nope, self.rope, self.v_dim = spec.qk_nope_head_dim, spec.qk_rope_head_dim, \
            spec.v_head_dim
        self.rank, self.theta = spec.kv_lora_rank, spec.rope_theta
        self.q_proj = _linear(d, h * (self.nope + self.rope), bias=False)
        self.kv_a_proj = _linear(d, self.rank + self.rope, bias=False)
        self.kv_a_norm = RMSNorm(self.rank, KV_NORM_EPS)
        self.kv_b_proj = _linear(self.rank, h * (self.nope + self.v_dim), bias=False)
        self.o_proj = _linear(h * self.v_dim, d, bias=False)
        self._angles: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    def reset_parameters(self, generator: torch.Generator) -> None:
        for linear in (self.q_proj, self.kv_a_proj, self.kv_b_proj, self.o_proj):
            _init_linear(linear, generator)
        self.kv_a_norm.reset_parameters()

    def angles(self, seq: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
        key = (seq, str(device))
        if key not in self._angles:
            self._angles[key] = rope_angles(seq, self.rope, self.theta, device)
        return self._angles[key]

    def forward(self, x: torch.Tensor, key_mask: torch.Tensor) -> torch.Tensor:
        """(B, L, D) in the compute dtype; ``key_mask`` (B, 1, 1, L) True
        where a key is attended."""
        batch, seq, _ = x.shape
        with span("mla", device=x, layer=self.layer, tokens=batch * seq):
            cos, sin = self.angles(seq, x.device)
            q = _dense(x, self.q_proj).view(batch, seq, self.heads, self.nope + self.rope)
            q_nope, q_pe = q.split([self.nope, self.rope], dim=-1)
            c, k_pe = _dense(x, self.kv_a_proj).split([self.rank, self.rope], dim=-1)
            kv = _dense(self.kv_a_norm(c), self.kv_b_proj).view(
                batch, seq, self.heads, self.nope + self.v_dim)
            k_nope, v = kv.split([self.nope, self.v_dim], dim=-1)
            k_pe = apply_rope(k_pe.unsqueeze(2), cos, sin)
            q = torch.cat([q_nope, apply_rope(q_pe, cos, sin)], dim=-1)
            k = torch.cat([k_nope, k_pe.expand(-1, -1, self.heads, -1)], dim=-1)
            out = F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=key_mask,
                scale=(self.nope + self.rope) ** -0.5)
            return _dense(out.transpose(1, 2).reshape(batch, seq, -1), self.o_proj)


class DeepseekBlock(nn.Module):
    def __init__(self, spec, layer: int):
        super().__init__()
        d = spec.hidden_dim
        self.attn_norm = RMSNorm(d, spec.rms_norm_eps)
        self.attn = MLA(spec, layer)
        self.mlp_norm = RMSNorm(d, spec.rms_norm_eps)
        if layer < spec.first_k_dense:
            self.mlp = SwiGLU(d, spec.intermediate_size)
        else:
            self.mlp = MoE(d, spec.moe_intermediate_size, spec.n_routed_experts,
                           spec.experts_held or (0, spec.n_routed_experts),
                           spec.n_shared_experts, spec.num_experts_per_tok,
                           spec.routed_scaling_factor, layer)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.attn_norm.reset_parameters()
        self.attn.reset_parameters(generator)
        self.mlp_norm.reset_parameters()
        self.mlp.reset_parameters(generator)

    def forward(self, x: torch.Tensor, key_mask: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.attn_norm(x), key_mask)
        return x + self.mlp(self.mlp_norm(x))


class DeepseekV3Tower(nn.Module):
    def __init__(self, spec):
        super().__init__()
        if spec.embedding_dim != spec.hidden_dim:
            raise ValueError(f"the deepseek_v3 tower takes embeddings of hidden_dim "
                             f"{spec.hidden_dim}, got embedding_dim {spec.embedding_dim}")
        self.layers = nn.ModuleList(DeepseekBlock(spec, i) for i in range(spec.num_layers))
        self.final_norm = RMSNorm(spec.hidden_dim, spec.rms_norm_eps)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for layer in self.layers:
            layer.reset_parameters(generator)
        self.final_norm.reset_parameters()

    def forward(self, embedded: torch.Tensor, ids: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        del generator  # no dropout in this tower
        real = ids > 0
        # a row with no real token attends over all of its positions
        key_mask = (real | ~real.any(dim=-1, keepdim=True))[:, None, None, :]
        x = embedded
        for layer in self.layers:
            x = layer(x, key_mask)
        return l2_normalize(masked_mean_pool(self.final_norm(x), ids).float())
