"""Encoder towers: token embeddings -> one L2-normalised vector per text.

The counterpart of ``twotowers_tpu/models/towers.py`` for the pooled towers
``mean`` and ``avg_pool`` as ``nn.Module``s. One embedding table is shared
by both towers; with tied weights the document tower is the query tower.
Parameters stay f32; with ``precision: bf16`` the lookup and the pooling
run in bf16 and the towers widen the pooled vector to f32, which is what
JAX's type promotion of ``bf16 @ f32`` does in the reference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
from torch import nn

from ..ops.core import l2_normalize, masked_mean_pool
from ..utils.registry import Registry
from .embeddings import Embedding, EmbeddingSpec

TOWER_REGISTRY = Registry("tower")

_SEQUENCE_ARCHS = ("cnn", "rnn", "transformer")


@dataclasses.dataclass(frozen=True)
class TowerSpec:
    """Static configuration of one tower architecture.

    kernel_size / num_layers / num_heads / max_len only apply to the
    sequence towers (cnn / rnn / transformer).
    """

    arch: str
    embedding_dim: int
    hidden_dim: int
    dropout: float = 0.1
    kernel_size: int = 3
    num_layers: int = 2
    num_heads: int = 4
    max_len: int = 128


@dataclasses.dataclass(frozen=True)
class TwoTowerSpec:
    """Static configuration of the full dual-encoder model."""

    embedding: EmbeddingSpec
    tower: TowerSpec
    tied_weights: bool = False
    compute_dtype: torch.dtype = torch.float32

    @property
    def output_dim(self) -> int:
        if self.tower.arch == "avg_pool" and self.tower.hidden_dim == self.embedding.embedding_dim:
            return self.embedding.embedding_dim
        return self.tower.hidden_dim


def _linear(fan_in: int, fan_out: int) -> nn.Linear:
    # skip_init: the weights are drawn from the model's generator, never
    # from the global RNG
    return nn.utils.skip_init(nn.Linear, fan_in, fan_out)


@torch.no_grad()
def _init_linear(linear: nn.Linear, generator: torch.Generator) -> None:
    """nn.Linear's default init, U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(linear.in_features)
    linear.weight.uniform_(-bound, bound, generator=generator)
    linear.bias.uniform_(-bound, bound, generator=generator)


@TOWER_REGISTRY.register("mean")
class MeanTower(nn.Module):
    """Linear -> ReLU -> Linear -> L2 norm over the pooled vector."""

    def __init__(self, spec: TowerSpec):
        super().__init__()
        self.fc1 = _linear(spec.embedding_dim, spec.hidden_dim)
        self.fc2 = _linear(spec.hidden_dim, spec.hidden_dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _init_linear(self.fc1, generator)
        _init_linear(self.fc2, generator)

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.fc1(pooled.float()))
        return l2_normalize(self.fc2(h))


@TOWER_REGISTRY.register("avg_pool")
class AvgPoolTower(nn.Module):
    """The pooled vector, projected (Linear -> Dropout -> LayerNorm) only
    when hidden_dim != embedding_dim, then L2-normalised."""

    def __init__(self, spec: TowerSpec):
        super().__init__()
        self.proj: Optional[nn.Linear] = None
        if spec.hidden_dim != spec.embedding_dim:
            self.proj = _linear(spec.embedding_dim, spec.hidden_dim)
            self.dropout = nn.Dropout(spec.dropout)
            self.norm = nn.LayerNorm(spec.hidden_dim, eps=1e-5)

    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.proj is not None:
            _init_linear(self.proj, generator)
            self.norm.reset_parameters()

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:
        out = pooled.float()
        if self.proj is not None:
            out = self.norm(self.dropout(self.proj(out)))
        return l2_normalize(out)


def _tower_class(arch: str):
    if arch in _SEQUENCE_ARCHS:
        raise NotImplementedError(
            f"tower arch {arch!r} is not ported yet (ROADMAP.md §1 item 9)"
        )
    return TOWER_REGISTRY.get(arch)


def spec_from_config(config: Dict[str, Any], vocab_size: int) -> TwoTowerSpec:
    """Build the full model spec from a training config dict."""
    from .embeddings import spec_from_config as embedding_spec_from_config

    embedding_cfg = config.get("embedding", {})
    encoder_cfg = config.get("encoder", {})
    emb_spec = embedding_spec_from_config(embedding_cfg, vocab_size)
    tower_spec = TowerSpec(
        arch=encoder_cfg.get("arch", "mean"),
        embedding_dim=emb_spec.embedding_dim,
        hidden_dim=int(encoder_cfg.get("hidden_dim", 128)),
        dropout=float(encoder_cfg.get("dropout", 0.1)),
        kernel_size=int(encoder_cfg.get("kernel_size", 3)),
        num_layers=int(encoder_cfg.get("num_layers", 2)),
        num_heads=int(encoder_cfg.get("num_heads", 4)),
        max_len=int(encoder_cfg.get("max_len",
                                    config.get("max_sequence_length", 128))),
    )
    dtype_name = str(config.get("precision", config.get("compute_dtype", "float32")))
    compute_dtype = torch.bfloat16 if dtype_name in ("bf16", "bfloat16") else torch.float32
    return TwoTowerSpec(
        embedding=emb_spec,
        tower=tower_spec,
        tied_weights=bool(encoder_cfg.get("tied_weights", False)),
        compute_dtype=compute_dtype,
    )


class TwoTower(nn.Module):
    """The dual encoder: a shared embedding, a query tower and, unless the
    weights are tied, a document tower."""

    def __init__(self, spec: TwoTowerSpec, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.spec = spec
        tower_cls = _tower_class(spec.tower.arch)
        self.embedding = Embedding(spec.embedding)
        self.query_tower = tower_cls(spec.tower)
        self.document_tower = None if spec.tied_weights else tower_cls(spec.tower)
        self.reset_parameters(generator if generator is not None
                              else torch.Generator().manual_seed(0))

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.embedding.reset_parameters(generator)
        self.query_tower.reset_parameters(generator)
        if self.document_tower is not None:
            self.document_tower.reset_parameters(generator)

    def encode(self, ids: torch.Tensor, tower: str = "query") -> torch.Tensor:
        """(batch, seq_len) ids, PAD=0 -> (batch, output_dim) f32 unit vectors."""
        embedded = self.embedding(ids, self.spec.compute_dtype)
        pooled = masked_mean_pool(embedded, ids)
        if tower == "query" or self.document_tower is None:
            return self.query_tower(pooled)
        return self.document_tower(pooled)

    def forward(self, query_ids: torch.Tensor,
                document_ids: Optional[torch.Tensor] = None,
                negative_ids: Optional[torch.Tensor] = None):
        """Returns 1-3 vectors depending on the inputs given."""
        q = self.encode(query_ids, "query")
        if document_ids is None:
            return q
        d = self.encode(document_ids, "document")
        if negative_ids is None:
            return q, d
        return q, d, self.encode(negative_ids, "document")
