"""Optimizer construction from the ``optimizer:`` config section.

The counterpart of ``twotowers_tpu/train/optim.py``: adamw (the default;
an unknown type falls back to it with a warning), adam, and sgd with
momentum, with torch's defaults pinned (b1=0.9, b2=0.999, eps=1e-8,
weight_decay=0.01) as the JAX package pins them for optax. Optional
``grad_clip_norm`` clips by the global norm with optax's rule
(``clip_by_global_norm``): gradients pass unchanged while the norm is below
``max_norm``, else each becomes ``g / norm * max_norm``.
``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm, so it is not used.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Optional

import torch

from ..utils.logging import get_logger

logger = get_logger("train.optim")

DEFAULT_LEARNING_RATE = 1e-3


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """What ``build_optimizer`` read from the config; ``build`` binds it to
    parameters (optax's transformation before ``init``)."""

    kind: str = "adamw"
    lr: float = DEFAULT_LEARNING_RATE
    weight_decay: float = 0.01
    momentum: float = 0.9
    grad_clip_norm: Optional[float] = None

    def build(self, params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
        params = list(params)
        if self.kind == "adam":
            return torch.optim.Adam(params, lr=self.lr, betas=(0.9, 0.999), eps=1e-8)
        if self.kind == "sgd":
            return torch.optim.SGD(params, lr=self.lr, momentum=self.momentum)
        return torch.optim.AdamW(params, lr=self.lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=self.weight_decay)


def build_optimizer(config: Dict[str, Any]) -> OptimizerConfig:
    """Read the optimizer from a config dict (``type``, ``lr``, ...)."""
    opt_config = config.get("optimizer", {}) or {}
    kind = str(opt_config.get("type", "adamw")).lower()
    lr = float(opt_config.get("lr", config.get("learning_rate", DEFAULT_LEARNING_RATE)))
    if kind not in ("adam", "sgd", "adamw"):
        logger.warning("Unknown optimizer type %r; falling back to adamw", kind)
        kind = "adamw"
    max_norm = opt_config.get("grad_clip_norm")
    return OptimizerConfig(
        kind=kind,
        lr=lr,
        weight_decay=float(opt_config.get("weight_decay", 0.01)),
        momentum=float(opt_config.get("momentum", 0.9)),
        grad_clip_norm=float(max_norm) if max_norm else None,
    )


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """``optax.global_norm``: the L2 norm of all gradients together, f32."""
    return torch.sqrt(sum(g.float().square().sum() for g in grads))


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         norm: torch.Tensor) -> None:
    """Clip in place with optax's rule; ``norm`` is ``global_norm(grads)``.
    Stays on the device: no host sync."""
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm))
