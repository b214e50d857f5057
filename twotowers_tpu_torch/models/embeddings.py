"""Embedding stage: token ids -> dense vectors.

The counterpart of ``twotowers_tpu/models/embeddings.py``: an f32
``(vocab_size, dim)`` table with a zero padding row. ``lookup`` draws it
N(0, 1); ``positional`` adds a learned ``(max_len, dim)`` table ``pos``,
0.02 N(0, 1), whose first ``seq_len`` rows are added to the non-pad tokens.
The pretrained kinds (``word2vec``, ``glove`` and ``pretrained``, the
spelling of ``configs/word2vec_skipgram.yml``) copy the first
``vocab_size - 1`` rows of gensim's vectors behind the padding row, cut to
the table's width; gensim is imported only when they are built, and where
it or its data is missing the table is a seeded N(0, 1/dim) draw. That
seed comes from ``hashlib``, not from Python's per-process ``hash()`` as in
the JAX package, so every process builds the same table.

At a word-scale vocabulary (above ``_ONE_HOT_MAX_VOCAB``) the lookup is
``GatherScatterGrad``, the counterpart of the JAX package's
``_take_scatter_grad``: the gather kernel forward, the scatter-add kernel
backward. A frozen embedding (``trainable: false``, the pretrained kinds'
default) gets no gradient, so the scatter-add never runs for it, and it is
kept out of the optimizer.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.gather import gather_rows
from ..kernels.scatter_add import scatter_add_rows
from ..utils.logging import get_logger
from ..utils.seeding import stable_seed

logger = get_logger("models.embeddings")

# the kinds whose table is copied from pretrained vectors
PRETRAINED_KINDS = ("word2vec", "glove", "pretrained")


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


def _pretrained_vectors(source: str) -> Optional[np.ndarray]:
    """Try to fetch pretrained vectors via gensim; None if unavailable."""
    try:
        import gensim.downloader as api  # type: ignore

        model = api.load(source)
        return np.asarray(model.vectors, dtype=np.float32)
    except Exception as exc:  # gensim, its data or the network may be absent
        logger.warning(
            "Pretrained vectors %r unavailable (%s); falling back to "
            "deterministic hash init.", source, exc,
        )
        return None


def _hash_fallback(spec: EmbeddingSpec) -> np.ndarray:
    """Deterministic pseudo-pretrained table keyed on (source, vocab, dim):
    N(0, 1) times 1/sqrt(dim), f32."""
    rng = np.random.default_rng(
        stable_seed(spec.source or "fallback", spec.vocab_size, spec.embedding_dim))
    table = rng.standard_normal((spec.vocab_size, spec.embedding_dim), dtype=np.float32)
    return table * np.float32(1.0 / np.sqrt(spec.embedding_dim))


def pretrained_table(spec: EmbeddingSpec) -> np.ndarray:
    """The f32 ``(vocab_size, dim)`` table of a pretrained kind: the first
    ``vocab_size - 1`` vectors copied behind the zero padding row, cut to
    the table's width (zeros past the vectors' width or count), or the
    hash fallback when no vectors can be had."""
    vectors = _pretrained_vectors(spec.source) if spec.source else None
    if vectors is None:
        table = _hash_fallback(spec)
    else:
        table = np.zeros((spec.vocab_size, spec.embedding_dim), dtype=np.float32)
        n_copy = min(len(vectors), spec.vocab_size - 1)
        width = min(vectors.shape[1], spec.embedding_dim)
        table[1:1 + n_copy, :width] = vectors[:n_copy, :width]
    table[spec.padding_idx] = 0.0
    return table


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
    """Lookup table with a zero padding row, plus learned positions for the
    ``positional`` kind."""

    def __init__(self, spec: EmbeddingSpec):
        super().__init__()
        if spec.kind not in ("lookup", "positional", *PRETRAINED_KINDS):
            raise ValueError(f"Unknown embedding: {spec.kind!r}. Available options: "
                             f"{sorted(('lookup', 'positional', *PRETRAINED_KINDS))}")
        self.spec = spec
        self.table = nn.Parameter(
            torch.empty(spec.vocab_size, spec.embedding_dim),
            requires_grad=spec.trainable,
        )
        self.pos: Optional[nn.Parameter] = None
        if spec.kind == "positional":
            self.pos = nn.Parameter(torch.empty(spec.max_len, spec.embedding_dim),
                                    requires_grad=spec.trainable)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """N(0, 1) init with a zero padding row (nn.Embedding's default);
        positions 0.02 N(0, 1). A pretrained kind copies
        ``pretrained_table`` and draws nothing from ``generator``."""
        if self.spec.kind in PRETRAINED_KINDS:
            self.table.copy_(torch.from_numpy(pretrained_table(self.spec)))
            return
        self.table.normal_(generator=generator)
        self.table[self.spec.padding_idx] = 0.0
        if self.pos is not None:
            self.pos.normal_(generator=generator).mul_(0.02)

    def forward(self, ids: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """(..., seq_len) ids -> (..., seq_len, dim) vectors in ``dtype``."""
        if self.spec.vocab_size <= _ONE_HOT_MAX_VOCAB:
            out = F.embedding(ids, self.table).to(dtype)
        else:
            out = GatherScatterGrad.apply(self.table, ids, dtype)
        if self.pos is not None:
            seq_len = ids.shape[-1]
            if seq_len > self.pos.shape[0]:
                raise ValueError(
                    f"sequence length {seq_len} exceeds positional table "
                    f"max_len {self.pos.shape[0]}"
                )
            # pad rows stay exactly zero so masked pooling ignores them
            out = out + torch.where((ids > 0).unsqueeze(-1), self.pos[:seq_len].to(dtype), 0.0)
        return out
