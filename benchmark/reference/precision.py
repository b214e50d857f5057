"""The precision a plain reference computes its matrix products in.

``f32`` leaves float32 operands as they are (TF32 must be off, which
``exact_matmuls`` sees to). The lower precisions round both operands of
every product before an f32 product, as the tensor cores do: ``tf32`` to
10 mantissa bits (round to nearest, ties to even), ``fp8`` to e4m3 with one
scale a tensor (its largest magnitude to 448). Gradients pass the rounding
unchanged, so a training step in ``fp8`` rounds its forward products and
differentiates through them.
"""

from __future__ import annotations

from typing import Callable

import torch

FP8_MAX = 448.0  # largest finite float8_e4m3fn


def exact_matmuls() -> None:
    """Float32 products in float32: no TF32 anywhere in this process."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to TF32's 10 mantissa bits, ties to even."""
    bits = x.float().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0xFFF + lsb) & -0x2000).view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) scaled so its largest magnitude is 448, cast to e4m3 and
    back, unscaled."""
    x = x.float()
    scale = FP8_MAX / torch.clamp_min(x.detach().abs().amax(), 1e-30)
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


_ROUND = {"f32": None, "tf32": round_tf32, "fp8": round_fp8}


def caster(precision: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """The operand rounding of ``precision``, with a straight-through
    gradient; identity for ``f32``."""
    fn = _ROUND[precision]
    if fn is None:
        return lambda x: x
    return lambda x: x + (fn(x) - x).detach()
