"""Embedding stage: token ids -> dense vectors.

The counterpart of ``twotowers_tpu/models/embeddings.py`` for the ``lookup``
kind: an f32 ``(vocab_size, dim)`` table, N(0, 1) with a zero padding row.
The other kinds (``positional`` and the pretrained sources) come with the
training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class EmbeddingSpec:
    """Static description of the embedding stage."""

    kind: str
    vocab_size: int
    embedding_dim: int
    trainable: bool = True
    source: Optional[str] = None  # pretrained vector source name, if any
    padding_idx: int = 0
    max_len: int = 128  # positional-table length ('positional' kind only)


_DEFAULT_SOURCES = {
    "word2vec": "word2vec-google-news-300",
    "pretrained": "word2vec-google-news-300",
    "glove": "glove-wiki-gigaword-50",
}


def spec_from_config(config: Dict[str, Any], vocab_size: int) -> EmbeddingSpec:
    """Build an EmbeddingSpec from the ``embedding:`` config section."""
    kind = config.get("type", "lookup")
    trainable = bool(config.get("trainable", kind in ("lookup", "positional")))
    return EmbeddingSpec(
        kind=kind,
        vocab_size=vocab_size,
        embedding_dim=int(config.get("embedding_dim", 64)),
        trainable=trainable,
        source=config.get("source", _DEFAULT_SOURCES.get(kind)),
        max_len=int(config.get("max_len", 128)),
    )


# At or below this vocab size the JAX package computes the lookup as a
# HIGHEST-precision one_hot(ids) @ table, so that its backward is a matmul.
# For ids in range that selects each row exactly, so the forward here
# gathers in both branches and gives the same bits in f32 and bf16; the
# threshold stays for the training slice's backward.
_ONE_HOT_MAX_VOCAB = 512


class Embedding(nn.Module):
    """Lookup table with a zero padding row."""

    def __init__(self, spec: EmbeddingSpec):
        super().__init__()
        if spec.kind != "lookup":
            raise NotImplementedError(
                f"embedding type {spec.kind!r} is not ported yet (ROADMAP.md §1 item 4)"
            )
        self.spec = spec
        self.table = nn.Parameter(
            torch.empty(spec.vocab_size, spec.embedding_dim),
            requires_grad=spec.trainable,
        )

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """N(0, 1) init with a zero padding row (nn.Embedding's default)."""
        self.table.normal_(generator=generator)
        self.table[self.spec.padding_idx] = 0.0

    def forward(self, ids: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """(..., seq_len) ids -> (..., seq_len, dim) vectors in ``dtype``."""
        return F.embedding(ids, self.table).to(dtype)
