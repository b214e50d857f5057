"""Encoder towers: token embeddings -> one L2-normalised vector per text.

The counterpart of ``twotowers_tpu/models/towers.py`` as ``nn.Module``s:
the pooled towers ``mean`` and ``avg_pool`` here, the sequence towers
``cnn``, ``rnn`` and ``transformer`` in ``seq_towers.py``. One embedding is
shared by both towers; with tied weights the document tower is the query
tower. Parameters stay f32; with ``precision: bf16`` the lookup, the
pooling and the sequence towers' layers run in bf16, and the pooled towers
widen the pooled vector to f32, which is what JAX's type promotion of
``bf16 @ f32`` does in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from ..ops.core import l2_normalize, masked_mean_pool
from ..utils.registry import Registry
from .embeddings import Embedding, EmbeddingSpec
from .seq_towers import (
    CNNTower, RNNTower, TransformerTower, _init_linear, _linear, is_sequence_arch)

TOWER_REGISTRY = Registry("tower")


@dataclasses.dataclass(frozen=True)
class TowerSpec:
    """Static configuration of one tower architecture.

    kernel_size / num_layers / num_heads / max_len only apply to the
    sequence towers (cnn / rnn / transformer, see seq_towers.py).
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

    def forward(self, pooled: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        del generator  # no dropout in this tower
        h = torch.relu(self.fc1(pooled.float()))
        return l2_normalize(self.fc2(h))


@TOWER_REGISTRY.register("avg_pool")
class AvgPoolTower(nn.Module):
    """The pooled vector, projected (Linear -> Dropout -> LayerNorm) only
    when hidden_dim != embedding_dim, then L2-normalised. In training mode
    the dropout mask is drawn from the generator the caller passes (the
    train state's), as the JAX package draws it from the step's key."""

    def __init__(self, spec: TowerSpec):
        super().__init__()
        self.proj: Optional[nn.Linear] = None
        self.dropout = spec.dropout
        if spec.hidden_dim != spec.embedding_dim:
            self.proj = _linear(spec.embedding_dim, spec.hidden_dim)
            self.norm = nn.LayerNorm(spec.hidden_dim, eps=1e-5)

    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.proj is not None:
            _init_linear(self.proj, generator)
            self.norm.reset_parameters()

    def forward(self, pooled: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        out = pooled.float()
        if self.proj is not None:
            out = self.proj(out)
            if self.training and self.dropout > 0.0:
                keep = 1.0 - self.dropout
                mask = torch.rand(out.shape, generator=generator, device=out.device) < keep
                out = torch.where(mask, out / keep, 0.0)
            out = self.norm(out)
        return l2_normalize(out)


TOWER_REGISTRY.add("cnn", CNNTower)
TOWER_REGISTRY.add("rnn", RNNTower)
TOWER_REGISTRY.add("transformer", TransformerTower)


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
        tower_cls = TOWER_REGISTRY.get(spec.tower.arch)
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

    def encode(self, ids: torch.Tensor, tower: str = "query",
               generator: Optional[torch.Generator] = None,
               embed_fn: Optional[Callable] = None) -> torch.Tensor:
        """(batch, seq_len) ids, PAD=0 -> (batch, output_dim) f32 unit vectors.
        ``generator`` draws the dropout masks of a tower in training mode.
        A sequence tower takes the (batch, seq_len, dim) embeddings and the
        ids; a pooled tower takes their masked mean. ``embed_fn(embedding,
        ids, dtype)`` replaces the lookup (the parallel layer's row-sharded
        one), as ``embed_fn`` does in the JAX package's ``encode``."""
        net = self.query_tower if tower == "query" or self.document_tower is None \
            else self.document_tower
        dtype = self.spec.compute_dtype
        embedded = self.embedding(ids, dtype) if embed_fn is None \
            else embed_fn(self.embedding, ids, dtype)
        if is_sequence_arch(self.spec.tower.arch):
            return net(embedded, ids, generator)
        return net(masked_mean_pool(embedded, ids), generator)

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
