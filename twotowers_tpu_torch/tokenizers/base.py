"""Tokenizer interface: text -> fixed-length int32 id arrays.

A copy of ``twotowers_tpu/tokenizers/base.py`` (fit / encode /
truncate_and_pad / vocab_size / save / load): the batch API returns
statically shaped ``numpy.int32`` arrays (PAD=0), never ragged Python lists.
"""

from __future__ import annotations

import json
from abc import ABC, abstractmethod
from pathlib import Path
from typing import Any, Dict, List, Sequence

import numpy as np

from ..utils.registry import Registry

PAD_ID = 0

TOKENIZER_REGISTRY = Registry("tokenizer")


class BaseTokenizer(ABC):
    """Abstract tokenizer. Vocab construction must be order-deterministic so
    every host in a multi-host job derives an identical vocabulary."""

    PAD = PAD_ID

    @abstractmethod
    def fit(self, texts: Sequence[str]) -> "BaseTokenizer":
        """Build the vocabulary from a corpus. Returns self."""

    @abstractmethod
    def encode(self, text: str) -> List[int]:
        """Convert one text into a variable-length list of token ids."""

    @abstractmethod
    def decode(self, ids: Sequence[int]) -> str:
        """Convert token ids back into text (best effort)."""

    @property
    @abstractmethod
    def vocab_size(self) -> int:
        """Vocabulary size including special tokens."""

    @property
    @abstractmethod
    def is_fitted(self) -> bool:
        """Whether fit() has produced a vocabulary."""

    # ---- fixed-shape helpers -------------------------------------------------

    def truncate_and_pad(self, sequence: Sequence[int], max_len: int) -> List[int]:
        """Pad with PAD (0) or truncate to exactly ``max_len``."""
        seq = list(sequence[:max_len])
        if len(seq) < max_len:
            seq.extend([self.PAD] * (max_len - len(seq)))
        return seq

    def encode_batch(self, texts: Sequence[str], max_len: int) -> np.ndarray:
        """Encode a batch of texts into a dense (len(texts), max_len) int32 array."""
        out = np.zeros((len(texts), max_len), dtype=np.int32)
        for i, text in enumerate(texts):
            ids = self.encode(text)[:max_len]
            out[i, : len(ids)] = ids
        return out

    def __call__(self, texts, max_len: int = 64) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        return self.encode_batch(texts, max_len)

    # ---- serialisation -------------------------------------------------------

    @abstractmethod
    def state_dict(self) -> Dict[str, Any]:
        """JSON-serialisable state (vocab + options)."""

    @classmethod
    @abstractmethod
    def from_state_dict(cls, state: Dict[str, Any]) -> "BaseTokenizer":
        """Rebuild a tokenizer from ``state_dict()`` output."""

    def save(self, filepath: str) -> None:
        """Save vocabulary + options as JSON (no pickle: portable & safe)."""
        path = Path(filepath)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.state_dict(), f)

    @classmethod
    def load(cls, filepath: str) -> "BaseTokenizer":
        with open(filepath) as f:
            state = json.load(f)
        return cls.from_state_dict(state)


def build_tokenizer(name: str, **kwargs: Any) -> BaseTokenizer:
    """Build a tokenizer by registry name
    (``char`` / ``word`` / ``bpe`` / ``wordpiece``)."""
    return TOKENIZER_REGISTRY.build(name, **kwargs)
