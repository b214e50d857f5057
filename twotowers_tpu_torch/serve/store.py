"""In-process vector store: the serving layer's document collection.

The counterpart of ``twotowers_tpu/serve/store.py``: add / query / persist
over (id, document, metadata, embedding) records, with Chroma's response
shape. The embeddings are kept on the host; a unit-normalised copy lives on
the device between queries and is rebuilt only after an add. A query is
scored by ``ops.topk_score.score_topk`` (the CUDA kernel on the card).
"""

from __future__ import annotations

import json
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..index.two_tower import unpack_topk
from ..ops.topk_score import score_topk
from ..utils.device import resolve_device
from ..utils.logging import get_logger

logger = get_logger("serve.store")

# optimistic attempts before a query is scored under the lock
MAX_RETRIES = 3


class VectorCollection:
    """A named collection of (id, document, metadata, embedding) records."""

    def __init__(self, name: str, dim: Optional[int] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.name = name
        self.dim = dim
        self.device = resolve_device(device)
        self._ids: List[str] = []
        self._documents: List[str] = []
        self._metadatas: List[Dict] = []
        self._embeddings: Optional[np.ndarray] = None
        self._id_to_pos: Dict[str, int] = {}
        self._lock = threading.Lock()
        # the device copy is rebuilt when _version moves past _device_version
        self._version = 0
        self._device_version = -1
        self._device_unit: Optional[torch.Tensor] = None
        self._device_n = 0

    # ---- mutation ------------------------------------------------------------

    def add(
        self,
        ids: Sequence[str],
        embeddings: np.ndarray,
        documents: Sequence[str],
        metadatas: Optional[Sequence[Dict]] = None,
    ) -> int:
        """Insert or overwrite records by id; returns number added.

        Deviation from the JAX store, on purpose: every length is checked
        before anything changes, and an id repeated within the call keeps
        its last record (last write wins), so a refused call leaves the
        store as it was and a repeated id cannot split a record."""
        embeddings = np.asarray(embeddings, dtype=np.float32)
        if embeddings.ndim != 2 or len(ids) != len(embeddings) or len(ids) != len(documents):
            raise ValueError("ids/embeddings/documents must align; embeddings 2-D")
        if metadatas and len(metadatas) != len(ids):
            raise ValueError(f"metadatas must align with ids: {len(metadatas)} != {len(ids)}")
        dim = self.dim if self.dim is not None else int(embeddings.shape[1])
        if embeddings.shape[1] != dim:
            raise ValueError(f"dim mismatch: {embeddings.shape[1]} != {dim}")
        last = {}  # id -> its last position in this call, in first-seen order
        for i, record_id in enumerate(ids):
            last[record_id] = i
        with self._lock:
            self.dim = dim
            new_rows = []
            for record_id, i in last.items():
                metadata = metadatas[i] if metadatas else {}
                if record_id in self._id_to_pos:
                    pos = self._id_to_pos[record_id]
                    self._documents[pos] = documents[i]
                    self._metadatas[pos] = metadata
                    self._embeddings[pos] = embeddings[i]
                else:
                    self._id_to_pos[record_id] = len(self._ids)
                    self._ids.append(record_id)
                    self._documents.append(documents[i])
                    self._metadatas.append(metadata)
                    new_rows.append(i)
            if new_rows:
                block = embeddings[new_rows]
                self._embeddings = (
                    block if self._embeddings is None
                    else np.concatenate([self._embeddings, block])
                )
            self._version += 1  # any add/overwrite invalidates the device copy
        return len(ids)

    def _device_index(self):
        """Device-resident unit-norm matrix (call under the lock)."""
        if self._device_version != self._version:
            norms = np.linalg.norm(self._embeddings, axis=1, keepdims=True)
            unit = (self._embeddings / np.maximum(norms, 1e-8)).astype(np.float32)
            self._device_unit = torch.from_numpy(unit).to(self.device)
            self._device_n = len(self._ids)
            self._device_version = self._version
        return self._device_unit, self._device_n

    # ---- query ---------------------------------------------------------------

    def _unit_queries(self, query_embeddings) -> torch.Tensor:
        if isinstance(query_embeddings, torch.Tensor):
            # already on the device (the serving path): normalise there
            queries = torch.atleast_2d(query_embeddings.float()).to(self.device)
            return queries / torch.clamp_min(
                torch.linalg.vector_norm(queries, dim=1, keepdim=True), 1e-8)
        host = np.atleast_2d(np.asarray(query_embeddings, np.float32))
        unit = host / np.maximum(np.linalg.norm(host, axis=1, keepdims=True), 1e-8)
        return torch.from_numpy(unit).to(self.device)

    def _response(self, scores: np.ndarray, indices: np.ndarray) -> Dict:
        """Chroma-shaped result (call under the lock: positions < n are
        append-only stable)."""
        return {
            "ids": [[self._ids[int(i)] for i in row] for row in indices],
            "documents": [[self._documents[int(i)] for i in row] for row in indices],
            "metadatas": [[self._metadatas[int(i)] for i in row] for row in indices],
            # cosine distance, as chroma reports
            "distances": [[float(1.0 - s) for s in row] for row in scores],
        }

    def query(self, query_embeddings, n_results: int = 5) -> Dict:
        """Top-n cosine matches per query; Chroma-shaped response dict.

        Scoring runs outside the lock against a snapshot of the device
        matrix. An add that overwrites a record meanwhile moves the version,
        and the query is scored again. After MAX_RETRIES such moves the last
        attempt is scored under the lock, so the texts returned always
        belong to the embeddings that were scored.
        """
        queries = self._unit_queries(query_embeddings)
        empty = {"ids": [[]], "documents": [[]], "distances": [[]], "metadatas": [[]]}
        for _ in range(MAX_RETRIES):
            with self._lock:
                if self._embeddings is None or not len(self._ids):
                    return empty
                device_unit, n = self._device_index()
                version = self._version
            k = min(n_results, n)
            scores, indices = unpack_topk(*score_topk(device_unit, queries, k, n))
            with self._lock:
                if self._version == version:
                    return self._response(scores, indices)
        with self._lock:
            if self._embeddings is None or not len(self._ids):
                return empty
            device_unit, n = self._device_index()
            k = min(n_results, n)
            return self._response(*unpack_topk(*score_topk(device_unit, queries, k, n)))

    def count(self) -> int:
        return len(self._ids)

    # ---- persistence ---------------------------------------------------------

    def save(self, path: str) -> None:
        out = Path(path)
        out.mkdir(parents=True, exist_ok=True)
        with self._lock:
            np.savez_compressed(out / "embeddings.npz",
                                embeddings=self._embeddings
                                if self._embeddings is not None
                                else np.zeros((0, self.dim or 0), np.float32))
            with open(out / "records.json", "w") as f:
                json.dump({"name": self.name, "dim": self.dim, "ids": self._ids,
                           "documents": self._documents,
                           "metadatas": self._metadatas}, f)

    @classmethod
    def load(cls, path: str, device: Union[str, torch.device] = "cuda") -> "VectorCollection":
        src = Path(path)
        with open(src / "records.json") as f:
            payload = json.load(f)
        collection = cls(payload["name"], payload.get("dim"), device=device)
        with np.load(src / "embeddings.npz") as data:
            embeddings = data["embeddings"]
        collection._ids = payload["ids"]
        collection._documents = payload["documents"]
        collection._metadatas = payload["metadatas"]
        collection._id_to_pos = {rid: i for i, rid in enumerate(collection._ids)}
        collection._embeddings = embeddings if len(embeddings) else None
        collection._version += 1  # invalidate any cached device index
        return collection
