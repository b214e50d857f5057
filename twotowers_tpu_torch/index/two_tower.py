"""On-device dense retrieval with a trained two-tower model.

The counterpart of ``twotowers_tpu/index/two_tower.py``. The document matrix
lives on the device, padded to ``ROW_ALIGN`` rows; queries are encoded by the
query tower and scored by ``ops.topk_score.score_topk`` (the CUDA kernel on
the card), and each search makes one device-to-host copy. Persistence is the
JAX package's npz + JSON layout, so either package loads the other's index.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..models.towers import TwoTower, TwoTowerSpec
from ..ops.topk_score import score_topk
from ..tokenizers.base import BaseTokenizer
from ..utils.device import resolve_device
from ..utils.logging import get_logger
from ..utils.tracing import span
from .base import BaseSearch

logger = get_logger("index.two_tower")

ROW_ALIGN = 128  # the doc axis is padded to a multiple of this


def _round_up(n: int, m: int) -> int:
    return -(-max(n, 1) // m) * m


def unpack_topk(scores: torch.Tensor, indices: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
    """(Q, k) scores and int32 indices on the host after ONE device-to-host
    copy: the indices ride beside the scores as their int32 bit patterns,
    exact at any corpus size."""
    with span("readback"):
        k = scores.shape[1]
        packed = torch.cat([scores.float(), indices.to(torch.int32).view(torch.float32)],
                           dim=1).cpu().numpy()
        return packed[:, :k], packed[:, k:].view(np.int32)


class TwoTowerSearch(BaseSearch):
    """Dense top-k search over documents encoded by the document tower."""

    def __init__(
        self,
        model: TwoTower,
        spec: TwoTowerSpec,
        tokenizer: BaseTokenizer,
        max_length: int = 64,
        encode_batch_size: int = 256,
        device: Union[str, torch.device] = "cuda",
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.spec = spec
        self.tokenizer = tokenizer
        self.max_length = int(max_length)
        self.encode_batch_size = int(encode_batch_size)

        self.documents: List[str] = []
        self._doc_matrix: Optional[torch.Tensor] = None  # (N_pad, D) on device
        self._n_docs: int = 0

    # ---- indexing ------------------------------------------------------------

    def _encode_texts_device(self, texts: Sequence[str], tower: str) -> torch.Tensor:
        """(N, D) float32 unit vectors, left on the device."""
        bs = self.encode_batch_size
        with span("encode", texts=len(texts), chunks=-(-max(len(texts), 1) // bs)):
            with span("encode.tokenize"):
                ids = torch.from_numpy(
                    self.tokenizer.encode_batch(list(texts), self.max_length)
                ).to(self.device)
            with span("encode.tower"), torch.inference_mode():
                chunks = [self.model.encode(ids[start:start + bs], tower)
                          for start in range(0, max(len(ids), 1), bs)]
                return chunks[0] if len(chunks) == 1 else torch.cat(chunks)

    def _encode_texts(self, texts: Sequence[str], tower: str) -> np.ndarray:
        return self._encode_texts_device(texts, tower).cpu().numpy()

    def _set_matrix(self, vecs: torch.Tensor) -> None:
        n_pad = _round_up(self._n_docs, ROW_ALIGN)
        pad = vecs.new_zeros((n_pad - self._n_docs, vecs.shape[1]))
        self._doc_matrix = torch.cat([vecs.to(self.device), pad.to(self.device)])

    def index_documents(self, documents: Sequence[str]) -> None:
        """Encode ``documents`` into the index; the logged time waits for
        the device."""
        start = time.perf_counter()
        self.documents = list(documents)
        self._n_docs = len(self.documents)
        self._set_matrix(self._encode_texts_device(self.documents, "document"))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        seconds = time.perf_counter() - start
        logger.info("Indexed %d documents in %.3fs (%.0f docs/s)",
                    self._n_docs, seconds, self._n_docs / max(seconds, 1e-9))

    # ---- search --------------------------------------------------------------

    def search_batch(
        self, queries: Sequence[str], top_k: int = 5
    ) -> List[List[Tuple[str, float]]]:
        """Top-k for a batch of queries: one kernel launch, one readback."""
        if self._doc_matrix is None:
            raise RuntimeError("No index built; call index_documents or load_index")
        top_k = min(top_k, self._n_docs)
        with span("search.batch", queries=len(queries), k=top_k):
            q_vecs = self._encode_texts_device(list(queries), "query")
            scores, indices = unpack_topk(
                *score_topk(self._doc_matrix, q_vecs, top_k, self._n_docs))
            with span("search.results"):
                return [
                    [(self.documents[int(i)], float(s)) for s, i in zip(qs, qi)]
                    for qs, qi in zip(scores, indices)
                ]

    def search(self, query: str, top_k: int = 5) -> List[Tuple[str, float]]:
        return self.search_batch([query], top_k)[0]

    # ---- persistence ---------------------------------------------------------

    def save_index(self, path: str) -> None:
        """Write embeddings (npz) + documents/meta (JSON) under ``path``."""
        if self._doc_matrix is None:
            raise RuntimeError("No index to save")
        out = Path(path)
        out.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(
            out / "embeddings.npz",
            embeddings=self._doc_matrix[: self._n_docs].cpu().numpy(),
        )
        with open(out / "documents.json", "w") as f:
            json.dump(
                {"documents": self.documents, "max_length": self.max_length}, f
            )
        logger.info("Saved index (%d docs) to %s", self._n_docs, out)

    def load_index(self, path: str) -> None:
        src = Path(path)
        with np.load(src / "embeddings.npz") as data:
            vecs = data["embeddings"]
        with open(src / "documents.json") as f:
            payload = json.load(f)
        self.documents = payload["documents"]
        self._n_docs = len(self.documents)
        self._set_matrix(torch.from_numpy(vecs))
        logger.info("Loaded index (%d docs) from %s", self._n_docs, src)

    @property
    def num_documents(self) -> int:
        return self._n_docs
