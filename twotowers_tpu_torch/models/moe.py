"""A mixture-of-experts layer that is told which experts it holds.

DeepSeek-V3's expert layer (``modeling_deepseek.py``: ``MoEGate`` with
``topk_method: noaux_tc``, ``DeepseekV3MoE``): a router over all
``n_routed`` experts, of which this layer holds ``held`` (the first held
expert and how many), plus shared experts that every token passes through.

* Router, in f32: ``s = sigmoid(x W^T)``; the ``top_k`` experts of
  ``s + bias`` (``bias`` a buffer, the selection bias, held fixed);
  their weights ``s`` at those experts over their sum, times
  ``scaling``. With ``n_group`` 1 the group selection is the identity.
* The layer's output is the shared experts' SwiGLU MLP plus, for each
  token, the weighted outputs of those of its chosen experts that are held
  here. What the absent experts would add is left out: under expert
  parallelism each holder adds its own part. No token is dropped and there
  is no capacity factor.
* Tokens are ordered by held expert once a layer (a stable sort, so within
  an expert by token). Dispatch is the row gather ``gather_rows`` (kernel
  #3) of the token rows in that order, whose backward is the scatter-add
  ``scatter_add_rows`` (kernel #2); combine is the scatter-add of the
  weighted expert rows back to their tokens (f32 sums), whose backward is
  the gather. On CPU tensors both are their plain versions.
* The held experts' SwiGLU products run over each expert's contiguous
  segment as grouped matrix products (``torch._grouped_mm``, one call for
  all the experts of a product), forward and backward by hand in
  ``ExpertProducts``; the elementwise SiLU and its derivative compute in
  f32.

The number of held assignments is read on the host once a layer (the size
of the gathered rows), the one wait on the card in the layer; the
segments' ends stay on the device. While a profiler
runs, the layer records the device spans ``moe.route`` (router, top-k and
the ordering), ``moe.dispatch``, ``moe.experts`` and ``moe.combine``
(forward and backward, attr ``phase``), each with attrs ``layer`` and
``tokens``, and the counter ``moe.assignments`` (token-expert pairs on
held experts).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.gather import gather_rows
from ..kernels.scatter_add import scatter_add_rows
from ..utils.tracing import count, span
from .seq_towers import _dense, _init_linear, _linear, _uniform_

NORM_EPS = 1e-20  # modeling_deepseek.py's guard on the top-k weights' sum


class Dispatch(torch.autograd.Function):
    """``x[tokens]``, the rows of the held assignments in expert order, by
    the gather kernel; the backward sums each row's gradient into its
    token's by the scatter-add kernel (f32 sums, cast to ``x``'s dtype)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, tokens: torch.Tensor, layer: int) -> torch.Tensor:
        ctx.save_for_backward(tokens)
        ctx.layer, ctx.n, ctx.dtype = layer, x.shape[0], x.dtype
        with span("moe.dispatch", device=x, phase="forward", layer=layer, tokens=x.shape[0]):
            return gather_rows(x, tokens, x.dtype)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (tokens,) = ctx.saved_tensors
        with span("moe.dispatch", device=grad, phase="backward", layer=ctx.layer,
                  tokens=ctx.n):
            return scatter_add_rows(grad, tokens, ctx.n, ctx.dtype), None, None


class Combine(torch.autograd.Function):
    """The rows summed into their tokens' rows, ``zeros(n, D).index_add(0,
    tokens, rows)`` in f32 and cast to ``dtype``, by the scatter-add kernel;
    the backward gathers each row's gradient from its token's."""

    @staticmethod
    def forward(ctx, rows: torch.Tensor, tokens: torch.Tensor, n: int, dtype: torch.dtype,
                layer: int) -> torch.Tensor:
        ctx.save_for_backward(tokens)
        ctx.layer, ctx.n, ctx.rows_dtype = layer, n, rows.dtype
        with span("moe.combine", device=rows, phase="forward", layer=layer, tokens=n):
            return scatter_add_rows(rows, tokens, n, dtype)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (tokens,) = ctx.saved_tensors
        with span("moe.combine", device=grad, phase="backward", layer=ctx.layer,
                  tokens=ctx.n):
            rows = gather_rows(grad.contiguous(), tokens, ctx.rows_dtype)
        return rows, None, None, None, None


# elements of ``h`` that one pass of the f32 SiLU-gate work takes: its f32
# temporaries stay near 256 MB each, where whole (T, 2 x 11,264) rows of the
# dense layer would need 8.8 GB apiece
ELEMENTWISE_CHUNK = 1 << 26


def _row_chunks(h: torch.Tensor):
    """``h`` as (rows, width) and the row ranges of its passes."""
    flat = h.reshape(-1, h.shape[-1])
    step = max(1, ELEMENTWISE_CHUNK // flat.shape[1])
    return flat, [(i, min(i + step, flat.shape[0])) for i in range(0, flat.shape[0], step)]


def _silu_gate(h: torch.Tensor) -> torch.Tensor:
    """``silu(gate) * up`` of ``h = [gate, up]`` on the last axis, in f32,
    cast back; a pass a chunk of rows."""
    flat, chunks = _row_chunks(h)
    out = flat.new_empty(flat.shape[0], flat.shape[1] // 2)
    for a, b in chunks:
        gate, up = flat[a:b].float().chunk(2, dim=-1)
        out[a:b] = F.silu(gate) * up
    return out.view(*h.shape[:-1], -1)


def _silu_gate_grad(h: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """The gradient of ``_silu_gate`` at ``h`` for the output gradient
    ``grad``, in f32, cast back: ``[grad * up * silu'(gate), grad *
    silu(gate)]``; a pass a chunk of rows."""
    flat, chunks = _row_chunks(h)
    grad = grad.reshape(-1, grad.shape[-1])
    out = torch.empty_like(flat)
    half = flat.shape[1] // 2
    for a, b in chunks:
        gate, up = flat[a:b].float().chunk(2, dim=-1)
        g = grad[a:b].float()
        sig = torch.sigmoid(gate)
        out[a:b, :half] = g * up * sig * (1.0 + gate * (1.0 - sig))
        out[a:b, half:] = g * gate * sig
    return out.view(h.shape)


class SiluGate(torch.autograd.Function):
    """``_silu_gate`` whose backward keeps only ``h`` (in its own dtype)
    and recomputes the f32 terms, where autograd would keep three f32
    tensors of ``h``'s size."""

    @staticmethod
    def forward(ctx, h: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(h)
        return _silu_gate(h)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (h,) = ctx.saved_tensors
        return _silu_gate_grad(h, grad)


class RouterLogits(torch.autograd.Function):
    """``F.linear(x.float(), weight)``: the router's f32 logits of rows in
    the compute dtype, keeping ``x`` as it is for the backward (its f32
    copy is exact) rather than a second, f32 copy."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x, weight)
        return F.linear(x.float(), weight)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        x, weight = ctx.saved_tensors
        return (grad @ weight).to(x.dtype), grad.t() @ x.float()


class ExpertProducts(torch.autograd.Function):
    """The held experts' SwiGLU MLPs over the rows in expert order:
    ``rows[o_e:o_e + n_e]`` through ``silu(x W_gate) * (x W_up)`` then
    ``W_down`` of expert ``e``. ``w_gate_up`` is (E, D, 2I) and ``w_down``
    (E, I, D), ``offsets`` the int32 ends of the segments on the device."""

    @staticmethod
    def forward(ctx, rows: torch.Tensor, w_gate_up: torch.Tensor, w_down: torch.Tensor,
                offsets: torch.Tensor, layer: int, n: int) -> torch.Tensor:
        with span("moe.experts", device=rows, phase="forward", layer=layer, tokens=n):
            h = torch._grouped_mm(rows, w_gate_up, offs=offsets)
            out = torch._grouped_mm(_silu_gate(h), w_down, offs=offsets)
        ctx.save_for_backward(rows, h, w_gate_up, w_down, offsets)
        ctx.layer, ctx.n = layer, n
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        rows, h, w_gate_up, w_down, offsets = ctx.saved_tensors
        with span("moe.experts", device=grad, phase="backward", layer=ctx.layer,
                  tokens=ctx.n):
            grad = grad.contiguous()
            act = _silu_gate(h)
            d_act = torch._grouped_mm(grad, w_down.transpose(-2, -1), offs=offsets)
            d_down = torch._grouped_mm(act.t(), grad, offs=offsets)
            d_h = _silu_gate_grad(h, d_act)
            d_rows = torch._grouped_mm(d_h, w_gate_up.transpose(-2, -1), offs=offsets)
            d_gate_up = torch._grouped_mm(rows.t(), d_h, offs=offsets)
        return d_rows, d_gate_up, d_down, None, None, None


class SwiGLU(nn.Module):
    """``down(silu(gate(x)) * up(x))`` with no biases; gate and up are one
    (2I, D) product, gate first."""

    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.gate_up = _linear(dim, 2 * inner, bias=False)
        self.down = _linear(inner, dim, bias=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _init_linear(self.gate_up, generator)
        _init_linear(self.down, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _dense(SiluGate.apply(_dense(x, self.gate_up)), self.down)


def route(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, top_k: int,
          scaling: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The router on rows ``x`` (T, D), in f32: (chosen experts (T,
    top_k), their weights (T, top_k), f32)."""
    scores = torch.sigmoid(RouterLogits.apply(x, weight))
    chosen = torch.topk(scores.detach() + bias, top_k, dim=-1).indices
    picked = scores.gather(-1, chosen)
    return chosen, picked / (picked.sum(dim=-1, keepdim=True) + NORM_EPS) * scaling


class MoE(nn.Module):
    """Shared experts plus the held routed experts of one layer."""

    def __init__(self, dim: int, inner: int, n_routed: int, held: Tuple[int, int],
                 n_shared: int, top_k: int, scaling: float, layer: int = 0):
        super().__init__()
        first, n_held = held
        if not (0 <= first and 1 <= n_held and first + n_held <= n_routed):
            raise ValueError(f"experts_held {held} is not a range of the {n_routed} experts")
        if not 1 <= top_k <= n_routed:
            raise ValueError(f"num_experts_per_tok {top_k} must be in 1..{n_routed}")
        self.first, self.n_held, self.top_k, self.scaling = first, n_held, top_k, scaling
        self.layer = layer
        self.router = _linear(dim, n_routed, bias=False)
        self.register_buffer("router_bias", torch.zeros(n_routed))
        self.shared = SwiGLU(dim, inner * n_shared)
        self.experts_gate_up = nn.Parameter(torch.empty(n_held, dim, 2 * inner))
        self.experts_down = nn.Parameter(torch.empty(n_held, inner, dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        _init_linear(self.router, generator)
        with torch.no_grad():
            self.router_bias.zero_()
        self.shared.reset_parameters(generator)
        for w in (self.experts_gate_up, self.experts_down):
            _uniform_(w, w.shape[1], generator)

    def order(self, chosen: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """The held assignments in expert order: their flat indices into
        ``chosen`` (T * top_k), the int32 ends of each held expert's
        segment on the device, and their number (read on the host)."""
        local = (chosen - self.first).flatten()
        key = torch.where((local >= 0) & (local < self.n_held), local, self.n_held)
        order = torch.sort(key, stable=True).indices
        counts = torch.bincount(key, minlength=self.n_held + 1)[:self.n_held]
        count("moe.assignments", counts)
        ends = counts.cumsum(0)
        held = int(ends[-1])
        return order[:held], ends.to(torch.int32), held

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(..., D) rows in the compute dtype -> (..., D)."""
        shape, dtype = x.shape, x.dtype
        flat = x.reshape(-1, shape[-1])
        n = flat.shape[0]
        with span("moe.route", device=flat, layer=self.layer, tokens=n):
            chosen, weights = route(flat, self.router.weight, self.router_bias, self.top_k,
                                    self.scaling)
            picks, offsets, held = self.order(chosen)
            tokens = (picks // self.top_k).to(torch.int32)
        out = self.shared(flat)
        if held:
            rows = Dispatch.apply(flat, tokens, self.layer)
            y = ExpertProducts.apply(rows, self.experts_gate_up.to(dtype),
                                     self.experts_down.to(dtype), offsets, self.layer, n)
            y = y * weights.flatten()[picks][:, None]  # f32, as modeling_deepseek.py
            out = out + Combine.apply(y, tokens, n, dtype, self.layer)
        return out.reshape(shape)
