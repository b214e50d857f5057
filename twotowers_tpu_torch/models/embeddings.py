"""Embedding stage: token ids -> dense vectors.

The counterpart of ``twotowers_tpu/models/embeddings.py`` for the ``lookup``
kind: an f32 ``(vocab_size, dim)`` table, N(0, 1) with a zero padding row.
At a word-scale vocabulary (above ``_ONE_HOT_MAX_VOCAB``) the lookup is
``GatherScatterGrad``, the counterpart of the JAX package's
``_take_scatter_grad``: the gather kernel forward, the scatter-add kernel
backward. A frozen table (``trainable: false``) gets no gradient and is
kept out of the optimizer. The other kinds (``positional`` and the
pretrained sources) are not ported yet (ROADMAP.md §1 item 4).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.gather import gather_rows
from ..kernels.scatter_add import scatter_add_rows


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
# For ids in range that selects each row exactly, so the forward here is
# F.embedding, with the same bits in f32 and bf16, and its backward sums
# the f32 gradient rows. Above it the JAX package gathers and routes the
# backward through its scatter-add kernel; so does GatherScatterGrad.
_ONE_HOT_MAX_VOCAB = 512


class GatherScatterGrad(torch.autograd.Function):
    """``table[ids].to(dtype)`` whose gradient is the scatter-add kernel.

    Forward: the gather kernel, fused with the cast to the compute dtype.
    Backward: the incoming rows (in the compute dtype) are widened and
    summed in f32 per table row by the scatter-add kernel, then cast to the
    table's dtype, as ``_take_bwd`` does. On CPU tensors both are their
    plain versions.
    """

    @staticmethod
    def forward(ctx, table: torch.Tensor, ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        flat = ids.reshape(-1).to(torch.int32)
        ctx.save_for_backward(flat)
        ctx.vocab = table.shape[0]
        ctx.table_dtype = table.dtype
        out = gather_rows(table, flat, dtype)
        return out.reshape(*ids.shape, table.shape[1])

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (flat,) = ctx.saved_tensors
        d_table = scatter_add_rows(grad.reshape(-1, grad.shape[-1]), flat, ctx.vocab,
                                   ctx.table_dtype)
        return d_table, None, None


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
        if self.spec.vocab_size <= _ONE_HOT_MAX_VOCAB:
            return F.embedding(ids, self.table).to(dtype)
        return GatherScatterGrad.apply(self.table, ids, dtype)
