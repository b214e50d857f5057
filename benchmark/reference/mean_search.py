"""Plain reference of the serving cells: the char tokenizer, the lookup
embedding with the ``mean`` tower, and exhaustive cosine top-k.

Written from the configuration's equations, in plain PyTorch, reading only
what the benchmark made (the texts' bytes and the weights in the JAX
layout): the vocabulary is the sorted set of characters of the fit texts,
ids from 1, 0 for the pad and any other character; a text keeps its first
``max_len`` characters; its vector is the mean of its tokens' rows (a 1e-9
guard on the count), then ``relu(x @ w1 + b1) @ w2 + b2``, unit-normalised
(norms clamped at 1e-12). A score is the dot product of two unit vectors.
Every product is made by ``precision.caster``, so the same code is the
control at a lower precision. Work is done in blocks, so that 8.8M
documents fit beside nothing else.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

POOL_EPS = 1e-9
NORM_EPS = 1e-12
STORE_EPS = 1e-8  # the store's normalisation of added vectors and queries


def fit_vocab(data: np.ndarray) -> torch.Tensor:
    """(256,) int64: byte -> id, 1.. over the sorted distinct bytes of the
    fit texts (newlines, which separate texts, excluded); 0 elsewhere."""
    present = np.unique(data)
    present = present[present != ord("\n")]
    lut = np.zeros(256, np.int64)
    lut[present] = np.arange(1, len(present) + 1)
    return torch.from_numpy(lut)


def token_ids(data: torch.Tensor, starts: torch.Tensor, lengths: torch.Tensor,
              lut: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B, max_len) int64 ids of the texts at ``starts`` (device tensors)."""
    cols = torch.arange(max_len, device=data.device)
    real = cols[None, :] < lengths[:, None]
    pos = torch.where(real, starts[:, None] + cols[None, :], 0)
    return torch.where(real, lut[data[pos].long()], 0)


def l2_normalize(x: torch.Tensor, eps: float = NORM_EPS) -> torch.Tensor:
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=-1, keepdim=True), eps)


def encode(ids: torch.Tensor, table: torch.Tensor, tower: Dict[str, torch.Tensor],
           cast: Callable) -> torch.Tensor:
    """(B, L) ids -> (B, H) unit vectors."""
    mask = (ids > 0).float().unsqueeze(-1)
    pooled = (table[ids] * mask).sum(dim=1) / (mask.sum(dim=1) + POOL_EPS)
    h = torch.relu(cast(pooled) @ cast(tower["w1"]) + tower["b1"])
    return l2_normalize(cast(h) @ cast(tower["w2"]) + tower["b2"])


def encode_texts(texts, idx: torch.Tensor, lut: torch.Tensor, tree, tower: str,
                 max_len: int, cast: Callable, block: int = 131072) -> torch.Tensor:
    """(len(idx), H) vectors of the texts ``idx`` of ``texts`` (a
    ``DeviceTexts``) through ``tower``."""
    out = []
    for lo in range(0, len(idx), block):
        sel = idx[lo:lo + block]
        ids = token_ids(texts.data, texts.starts[sel], texts.lengths[sel], lut, max_len)
        out.append(encode(ids, tree["embedding"]["table"], tree[tower], cast))
    return torch.cat(out)


class DeviceTexts:
    """A ``textgen.Texts`` with its arrays on ``device``."""

    def __init__(self, texts, device: torch.device):
        self.data = torch.from_numpy(texts.data).to(device)
        self.starts = torch.from_numpy(texts.starts).to(device)
        self.lengths = torch.from_numpy(texts.lengths).to(device)

    def __len__(self) -> int:
        return len(self.starts)


def top_k(queries: torch.Tensor, docs: torch.Tensor, k: int, cast: Callable,
          block: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Q, k) best scores and their document indices, by exhaustive
    products (``docs`` already cast)."""
    values, indices = [], []
    for lo in range(0, len(queries), block):
        scores = cast(queries[lo:lo + block]) @ docs.T
        v, i = scores.topk(k, dim=1)
        values.append(v)
        indices.append(i)
    return torch.cat(values), torch.cat(indices)


def judge(queries: torch.Tensor, docs: torch.Tensor, got_ids: torch.Tensor,
          got_scores: torch.Tensor, block: int = 64) -> Dict[str, float]:
    """How far answers (``got_ids``, ``got_scores``: (Q, k)) lie from the
    exact top-k of ``queries`` over ``docs`` (both f32, products in f32).

    ``rank_gap``: the widest gap by which the reference score of the j-th
    answer lies below the reference's j-th best score; ``score_gap``: the
    widest gap between an answer's reported score and its reference score.
    """
    k = got_ids.shape[1]
    rank_gap, score_gap = 0.0, 0.0
    for lo in range(0, len(queries), block):
        scores = queries[lo:lo + block] @ docs.T
        best = scores.topk(k, dim=1).values
        at = scores.gather(1, got_ids[lo:lo + block])
        rank_gap = max(rank_gap, float((best - at).max()))
        score_gap = max(score_gap, float((got_scores[lo:lo + block] - at).abs().max()))
    return {"rank_gap": rank_gap, "score_gap": score_gap}
