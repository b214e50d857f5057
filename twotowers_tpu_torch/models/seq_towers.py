"""Sequence towers: cnn / rnn / transformer.

The counterpart of ``twotowers_tpu/models/seq_towers.py`` as ``nn.Module``s.
Unlike the pooled towers, which take one pooled ``(B, D)`` vector, these
take the ``(B, L, D)`` token embeddings and the ids; ``TwoTower.encode``
dispatches on ``is_sequence_arch``. Parameters stay f32; each matmul casts
its weight to the compute dtype of the embeddings, as the JAX towers do.

* **cnn** -- two 1-D convolutions with XLA's SAME padding (``(K-1)//2``
  on the left, the rest on the right), ReLU, the pad positions masked again
  between them, a max-pool over the real positions, a linear, L2 norm.
* **rnn** -- a GRU with gates split z, r, n, one input-side bias and no
  hidden bias, written as a loop over the positions; a pad step carries the
  state forward unchanged. The final state, L2-normalised.
* **transformer** -- input projection plus learned positions, N pre-LN
  blocks (multi-head attention with an additive ``-1e30`` key bias and a
  GELU FFN), final LN, masked mean-pool, L2 norm. The layer norms compute
  in f32 and cast back. The softmax follows the JAX package's order:
  scores in the compute dtype, the row max without gradient, ``exp`` in
  f32 rounded to the compute dtype, the normaliser summed in f32. A row
  with no real token attends uniformly.

``jnp.maximum(x, 0)`` gives half the gradient to each side of a tie, so the
CNN's ReLU is ``torch.maximum`` (which does the same), not ``torch.relu``.
In training mode the dropout masks are drawn from the generator the caller
passes (the train state's), one per residual branch and layer in order;
without a generator nothing is dropped, as the JAX towers drop nothing
without a key.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.core import l2_normalize, masked_mean_pool

NEG_INF = -1e30

# archs whose forward takes (B, L, D) token embeddings + ids, not a pooled
# vector; TwoTower.encode dispatches on this set
SEQUENCE_ARCHS = frozenset({"cnn", "rnn", "transformer", "deepseek_v3"})


def is_sequence_arch(arch: str) -> bool:
    return arch in SEQUENCE_ARCHS


def _linear(fan_in: int, fan_out: int, bias: bool = True) -> nn.Linear:
    # skip_init: the weights are drawn from the model's generator, never
    # from the global RNG
    return nn.utils.skip_init(nn.Linear, fan_in, fan_out, bias=bias)


@torch.no_grad()
def _uniform_(tensor: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    bound = 1.0 / math.sqrt(fan_in)
    tensor.uniform_(-bound, bound, generator=generator)


def _init_linear(linear: nn.Linear, generator: torch.Generator) -> None:
    """nn.Linear's default init, U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    _uniform_(linear.weight, linear.in_features, generator)
    if linear.bias is not None:
        _uniform_(linear.bias, linear.in_features, generator)


def _dense(x: torch.Tensor, linear: nn.Linear) -> torch.Tensor:
    """``x @ w + b`` in the dtype of ``x``."""
    bias = None if linear.bias is None else linear.bias.to(x.dtype)
    return F.linear(x, linear.weight.to(x.dtype), bias)


def _dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
             train: bool) -> torch.Tensor:
    # no generator, no dropout: JAX's towers drop nothing without a key
    if not train or rate <= 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0)


def _relu(x: torch.Tensor) -> torch.Tensor:
    return torch.maximum(x, x.new_zeros(()))


class LayerNorm(nn.Module):
    """Layer norm over the last axis, computed in f32 and cast back to the
    input's dtype (``seq_towers._ln``)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    @torch.no_grad()
    def reset_parameters(self) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.weight.shape, self.weight, self.bias,
                            self.eps).to(x.dtype)


# ---------------------------------------------------------------------------
# cnn: conv -> ReLU -> conv -> ReLU -> masked max-pool -> Linear -> L2
# ---------------------------------------------------------------------------

class CNNTower(nn.Module):
    def __init__(self, spec):
        super().__init__()
        k, d, h = spec.kernel_size, spec.embedding_dim, spec.hidden_dim
        self.dropout = spec.dropout
        self.conv1 = nn.utils.skip_init(nn.Conv1d, d, h, k)
        self.conv2 = nn.utils.skip_init(nn.Conv1d, h, h, k)
        self.proj = _linear(h, h)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for conv in (self.conv1, self.conv2):
            _, c_in, k = conv.weight.shape
            _uniform_(conv.weight, k * c_in, generator)
            conv.bias.zero_()
        _init_linear(self.proj, generator)

    @staticmethod
    def _conv(x: torch.Tensor, conv: nn.Conv1d) -> torch.Tensor:
        """(B, L, C_in) -> (B, L, C_out), XLA's SAME padding."""
        total = conv.weight.shape[-1] - 1
        x = F.pad(x.transpose(1, 2), (total // 2, total - total // 2))
        out = F.conv1d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype))
        return out.transpose(1, 2)

    def forward(self, embedded: torch.Tensor, ids: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        mask = (ids > 0).unsqueeze(-1)  # (B, L, 1)
        x = torch.where(mask, embedded, 0.0)
        h = _relu(self._conv(x, self.conv1))
        # re-mask: SAME padding lets pad positions pick up conv responses
        h = torch.where(mask, h, 0.0)
        h = _relu(self._conv(h, self.conv2))
        h = _dropout(h, self.dropout, generator, self.training)
        pooled = torch.where(mask, h, NEG_INF).amax(dim=-2)  # (B, H)
        pooled = torch.where(mask.any(dim=-2), pooled, 0.0)
        return l2_normalize(_dense(pooled.float(), self.proj))


# ---------------------------------------------------------------------------
# rnn: GRU over the sequence, final hidden state -> L2
# ---------------------------------------------------------------------------

class RNNTower(nn.Module):
    """GRU. ``x_proj`` holds the JAX package's ``w_x`` and ``b``, ``h_proj``
    its ``w_h``; gates in the order z, r, n."""

    def __init__(self, spec):
        super().__init__()
        d, h = spec.embedding_dim, spec.hidden_dim
        self.x_proj = _linear(d, 3 * h)
        self.h_proj = _linear(h, 3 * h, bias=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        # nn.GRU's init: every weight and bias ~ U(-1/sqrt(H), 1/sqrt(H))
        hidden = self.h_proj.in_features
        for p in (self.x_proj.weight, self.h_proj.weight, self.x_proj.bias):
            _uniform_(p, hidden, generator)

    def forward(self, embedded: torch.Tensor, ids: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        del generator  # no dropout in this tower
        dtype = embedded.dtype
        w_h = self.h_proj.weight.to(dtype)
        mask = (ids > 0).to(dtype).transpose(0, 1).unsqueeze(-1)  # (L, B, 1)
        # the input projection of every step in one matmul, time-major
        gates_x = _dense(embedded.transpose(0, 1), self.x_proj)  # (L, B, 3H)
        h = embedded.new_zeros(embedded.shape[0], self.h_proj.in_features)
        for gx, m in zip(gates_x, mask):
            xz, xr, xn = gx.chunk(3, dim=-1)
            hz, hr, hn = F.linear(h, w_h).chunk(3, dim=-1)
            z = torch.sigmoid(xz + hz)
            r = torch.sigmoid(xr + hr)
            n = torch.tanh(xn + r * hn)
            h_new = (1.0 - z) * n + z * h
            h = m * h_new + (1.0 - m) * h  # pad steps carry state unchanged
        return l2_normalize(h.float())


# ---------------------------------------------------------------------------
# transformer: proj + learned positions -> N pre-LN MHA+FFN blocks ->
# final LN -> masked mean-pool -> L2
# ---------------------------------------------------------------------------

class TransformerBlock(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.ln1 = LayerNorm(hidden)
        self.q = _linear(hidden, hidden)
        self.k = _linear(hidden, hidden)
        self.v = _linear(hidden, hidden)
        self.o = _linear(hidden, hidden)
        self.ln2 = LayerNorm(hidden)
        self.ffn1 = _linear(hidden, 4 * hidden)
        self.ffn2 = _linear(4 * hidden, hidden)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for linear in (self.q, self.k, self.v, self.o, self.ffn1, self.ffn2):
            _init_linear(linear, generator)
        self.ln1.reset_parameters()
        self.ln2.reset_parameters()

    def attention(self, x: torch.Tensor, attn_bias: torch.Tensor,
                  num_heads: int) -> torch.Tensor:
        """Multi-head self-attention in ``_mha``'s order of operations and
        roundings; heads stay in the (B, L, heads, head_dim) layout."""
        batch, seq, hidden = x.shape
        head_dim = hidden // num_heads
        dtype = x.dtype
        q, k, v = (_dense(x, lin).view(batch, seq, num_heads, head_dim)
                   for lin in (self.q, self.k, self.v))
        # the scale rounded to the compute dtype, as jnp.asarray(scale, dtype)
        scale = torch.tensor(1.0 / math.sqrt(head_dim)).to(dtype).item()
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
        scores = scores + attn_bias.to(dtype)  # 0 / -1e30
        m = scores.amax(dim=-1, keepdim=True).detach()
        e = torch.exp((scores - m).float()).to(dtype)
        z = e.float().sum(dim=-1, keepdim=True)
        weights = e / z.to(dtype)
        attn = torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(batch, seq, hidden)
        return _dense(attn, self.o)


class TransformerTower(nn.Module):
    def __init__(self, spec):
        super().__init__()
        d, h = spec.embedding_dim, spec.hidden_dim
        if h % spec.num_heads:
            raise ValueError(f"hidden_dim {h} must divide by num_heads {spec.num_heads}")
        self.num_heads = spec.num_heads
        self.max_len = spec.max_len
        self.dropout = spec.dropout
        self.proj = _linear(d, h)
        self.pos = nn.Parameter(torch.empty(spec.max_len, h))
        self.layers = nn.ModuleList(TransformerBlock(h) for _ in range(spec.num_layers))
        self.final_ln = LayerNorm(h)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        _init_linear(self.proj, generator)
        self.pos.normal_(generator=generator).mul_(0.02)
        for layer in self.layers:
            layer.reset_parameters(generator)
        self.final_ln.reset_parameters()

    def forward(self, embedded: torch.Tensor, ids: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        seq = embedded.shape[1]
        if seq > self.max_len:
            raise ValueError(f"sequence length {seq} exceeds transformer max_len {self.max_len}")
        x = _dense(embedded, self.proj) + self.pos[:seq].to(embedded.dtype)

        key_mask = ids > 0  # (B, L)
        # rows with no real token would softmax over all -1e30; they attend
        # uniformly instead (the pool mask discards their output)
        bias = torch.where(key_mask[:, None, None, :], 0.0, NEG_INF)
        attn_bias = torch.where(key_mask.any(dim=-1)[:, None, None, None], bias, 0.0)

        for layer in self.layers:
            h = layer.attention(layer.ln1(x), attn_bias, self.num_heads)
            x = x + _dropout(h, self.dropout, generator, self.training)
            h = F.gelu(_dense(layer.ln2(x), layer.ffn1), approximate="tanh")
            h = _dense(h, layer.ffn2)
            x = x + _dropout(h, self.dropout, generator, self.training)

        pooled = masked_mean_pool(self.final_ln(x), ids)
        return l2_normalize(pooled.float())
