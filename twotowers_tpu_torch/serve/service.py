"""Framework-agnostic serving core: the four routes as plain methods.

A copy of ``twotowers_tpu/serve/service.py``: /embed, /search, /add and
/health as a transport-independent class, with the same status codes,
response shapes and degraded mode. ``serve/app.py``'s FastAPI layer is a
thin adapter over it. Deviation, on purpose: a generated id carries a
per-process call number besides the millisecond, so two id-less adds in one
millisecond do not overwrite each other.
"""

from __future__ import annotations

import itertools
import time
from typing import Any, Dict, List, Optional, Union

import torch

from .store import VectorCollection

_ADD_CALLS = itertools.count()  # numbers the id-less adds of this process


class ServiceError(Exception):
    """Route-level error with an HTTP status (maps to HTTPException)."""

    def __init__(self, status: int, detail: str):
        super().__init__(detail)
        self.status = status
        self.detail = detail


class RetrievalService:
    """State + route handlers shared by every transport layer."""

    def __init__(self, model=None,
                 collection: Optional[VectorCollection] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.model = model  # ModelRuntime or None (degraded mode)
        self.collection = collection or VectorCollection("documents", device=device)

    def _require_model(self):
        if self.model is None:
            raise ServiceError(503, "model not loaded")
        return self.model

    def health(self) -> Dict[str, Any]:
        return {
            "status": "ok" if self.model else "degraded",
            "model_loaded": self.model is not None,
            "documents": self.collection.count(),
        }

    def embed(self, texts: List[str]) -> Dict[str, Any]:
        model = self._require_model()
        if not texts:
            raise ServiceError(422, "texts must be non-empty")
        vectors = model.encode(texts, "query")
        return {"embeddings": vectors.tolist()}

    def add(self, documents: List[str], ids: Optional[List[str]] = None,
            metadatas: Optional[List[Dict[str, Any]]] = None) -> Dict[str, Any]:
        model = self._require_model()
        if not documents:
            raise ServiceError(422, "documents must be non-empty")
        if ids is not None and len(ids) != len(documents):
            raise ServiceError(422, "ids and documents length mismatch")
        if not ids:
            stamp = f"doc_{int(time.time() * 1000)}_{next(_ADD_CALLS)}"
            ids = [f"{stamp}_{i}" for i in range(len(documents))]
        vectors = model.encode(documents, "document")
        added = self.collection.add(ids, vectors, documents, metadatas)
        return {"added": added, "total": self.collection.count()}

    def search(self, query: str, top_k: int = 5) -> Dict[str, Any]:
        model = self._require_model()
        # prefer the device-resident encode: the store consumes the vector
        # without a host round-trip, so the search result is the query's
        # only blocking device transfer
        if hasattr(model, "encode_device"):
            query_vec = model.encode_device([query], "query")
        else:
            query_vec = model.encode([query], "query")
        result = self.collection.query(query_vec, n_results=top_k)
        return {
            "query": query,
            "results": [
                {"id": i, "document": d, "distance": dist, "metadata": m}
                for i, d, dist, m in zip(
                    result["ids"][0], result["documents"][0],
                    result["distances"][0], result["metadatas"][0],
                )
            ],
        }
