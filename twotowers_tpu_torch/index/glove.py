"""Training-free mean-word-vector retrieval baseline.

The counterpart of ``twotowers_tpu/index/glove.py``. ``MeanVectorSearch``
encodes a text as the mean of its known words' vectors (zeros when none is
known), L2-normalised on the host, and scores on the device through
``ops.topk_score.score_topk``, the CUDA kernel on the card. The document
matrix is not padded (the JAX package pads it to a TPU tile): the number of
real rows goes to ``score_topk`` as ``n_docs``, as ``TwoTowerSearch`` does.
``GloVeSearch`` loads gensim GloVe vectors behind a gated import; without
gensim or its data each word gets a seeded pseudo-vector. That seed comes
from ``hashlib`` (``utils.seeding.stable_seed``), where the JAX package
takes Python's per-process ``hash()``, so every process draws the same
vectors. Persistence is the JAX package's npz + JSON layout.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..ops.topk_score import score_topk
from ..utils.device import resolve_device
from ..utils.logging import get_logger
from ..utils.seeding import stable_seed
from .base import BaseSearch
from .two_tower import unpack_topk

logger = get_logger("index.glove")

_WORDS = re.compile(r"\b\w+\b")


class MeanVectorSearch(BaseSearch):
    """Mean-of-word-vectors text encoder + dense top-k search on ``device``
    (the card unless the caller asks for the CPU)."""

    def __init__(self, vectors: Dict[str, np.ndarray], dim: Optional[int] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.vectors = vectors
        if dim is None:
            dim = len(next(iter(vectors.values()))) if vectors else 50
        self.dim = int(dim)
        self.documents: List[str] = []
        self._doc_matrix: Optional[torch.Tensor] = None  # (N, dim) on the device
        self._n_docs = 0

    # ---- encoding ------------------------------------------------------------

    def _average_pool(self, text: str) -> np.ndarray:
        """Mean of known word vectors; zeros when no word is known."""
        words = _WORDS.findall(text.lower())
        vecs = [self.vectors[w] for w in words if w in self.vectors]
        if not vecs:
            return np.zeros(self.dim, dtype=np.float32)
        return np.mean(np.asarray(vecs, dtype=np.float32), axis=0)

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        """(len(texts), dim) f32 unit vectors (zero rows stay zero)."""
        out = np.zeros((len(texts), self.dim), dtype=np.float32)
        for i, text in enumerate(texts):
            out[i] = self._average_pool(text)
        norms = np.linalg.norm(out, axis=1, keepdims=True)
        return out / np.maximum(norms, 1e-8)

    # ---- BaseSearch ----------------------------------------------------------

    def _set_matrix(self, vecs: np.ndarray) -> None:
        self._doc_matrix = torch.from_numpy(np.ascontiguousarray(vecs, np.float32)).to(
            self.device)

    def index_documents(self, documents: Sequence[str]) -> None:
        self.documents = list(documents)
        self._n_docs = len(self.documents)
        self._set_matrix(self.encode(self.documents))
        logger.info("Indexed %d documents (dim=%d)", self._n_docs, self.dim)

    def search(self, query: str, top_k: int = 5) -> List[Tuple[str, float]]:
        if self._doc_matrix is None:
            raise RuntimeError("No index built; call index_documents or load_index")
        top_k = min(top_k, self._n_docs)
        q = torch.from_numpy(self.encode([query])).to(self.device)
        scores, indices = unpack_topk(*score_topk(self._doc_matrix, q, top_k, self._n_docs))
        return [(self.documents[int(i)], float(s)) for s, i in zip(scores[0], indices[0])]

    def save_index(self, path: str) -> None:
        if self._doc_matrix is None:
            raise RuntimeError("No index to save")
        out = Path(path)
        out.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(out / "embeddings.npz",
                            embeddings=self._doc_matrix[: self._n_docs].cpu().numpy())
        with open(out / "documents.json", "w") as f:
            json.dump({"documents": self.documents, "dim": self.dim}, f)
        logger.info("Saved index (%d docs) to %s", self._n_docs, out)

    def load_index(self, path: str) -> None:
        src = Path(path)
        with np.load(src / "embeddings.npz") as data:
            vecs = data["embeddings"]
        with open(src / "documents.json") as f:
            payload = json.load(f)
        self.documents = payload["documents"]
        self.dim = int(payload.get("dim", vecs.shape[1]))
        self._n_docs = len(self.documents)
        self._set_matrix(vecs)

    @property
    def num_documents(self) -> int:
        return self._n_docs


def _hashed_vectors(dim: int) -> Dict[str, np.ndarray]:
    """Deterministic per-word pseudo-vectors for offline runs (no gensim):
    N(0, 1) f32 from a seed of ``("hashed-vec", word)``."""

    class _HashDict(dict):
        def __missing__(self, word):
            seed = stable_seed("hashed-vec", word)
            vec = np.random.default_rng(seed).normal(size=dim).astype(np.float32)
            self[word] = vec
            return vec

        def __contains__(self, word):  # every word has a vector
            return isinstance(word, str)

    return _HashDict()


class GloVeSearch(MeanVectorSearch):
    """MeanVectorSearch bound to gensim GloVe downloads (gated)."""

    def __init__(self, model_name: str = "glove-twitter-25", dim: Optional[int] = None,
                 device: Union[str, torch.device] = "cuda"):
        resolve_device(device)  # no card and no device="cpu": raise before any load
        self.model_name = model_name
        vectors: Dict[str, np.ndarray] = {}
        try:
            import gensim.downloader as api  # gated import

            kv = api.load(model_name)
            vectors = {w: np.asarray(kv[w], np.float32) for w in kv.index_to_key}
            dim = kv.vector_size
            logger.info("Loaded %d GloVe vectors (%s)", len(vectors), model_name)
        except Exception as exc:  # gensim, its data or the network may be absent
            logger.warning(
                "GloVe vectors %r unavailable (%s); using deterministic hashed "
                "fallback vectors.", model_name, exc,
            )
            dim = dim or 50
            vectors = _hashed_vectors(dim)
        super().__init__(vectors, dim, device=device)
