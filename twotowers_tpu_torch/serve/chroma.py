"""ChromaDB-backed collection: the serving layer's external vector backend.

The counterpart of ``twotowers_tpu/serve/chroma.py``: a Chroma HTTP
collection behind the interface of the in-process ``VectorCollection``
(add / query / count), so ``RetrievalService`` runs against either backend
unchanged. ``collection_from_env`` selects it with ``CHROMA_HOST`` (and
``CHROMA_PORT``) and falls back to the in-process store, on ``device``, on
any error, as the JAX package does.

The in-process store keeps the document matrix on the card and scores with
the top-k kernel; Chroma scores server-side on the CPU. Use this adapter
when a store shared across replicas, or persisted outside the process,
outweighs the latency.

``chromadb`` is imported in ``ChromaCollection.__init__`` only. Deviation,
on purpose: an add without metadata sends none, where the JAX adapter sends
an empty dict a record, which Chroma servers that require non-empty
metadata reject; records without metadata read back as ``{}``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from ..utils.logging import get_logger

logger = get_logger("serve.chroma")


class ChromaCollection:
    """VectorCollection-compatible adapter over a ChromaDB HTTP collection."""

    def __init__(self, name: str, host: str = "localhost", port: int = 8000,
                 dim: Optional[int] = None, client=None):
        if client is None:
            import chromadb  # gated; collection_from_env handles the failure

            client = chromadb.HttpClient(host=host, port=int(port))
        self.name = name
        self.dim = dim
        self._client = client
        self._collection = client.get_or_create_collection(
            name=name, metadata={"hnsw:space": "cosine"}
        )

    # ---- VectorCollection interface -----------------------------------------

    def add(
        self,
        ids: Sequence[str],
        embeddings: np.ndarray,
        documents: Sequence[str],
        metadatas: Optional[Sequence[Dict]] = None,
    ) -> int:
        embeddings = np.asarray(embeddings, dtype=np.float32)
        if embeddings.ndim != 2 or len(ids) != len(embeddings) \
                or len(ids) != len(documents):
            raise ValueError("ids/embeddings/documents must align; embeddings 2-D")
        if self.dim is None:
            self.dim = int(embeddings.shape[1])
        if embeddings.shape[1] != self.dim:
            raise ValueError(f"dim mismatch: {embeddings.shape[1]} != {self.dim}")
        # upsert == the in-process store's insert-or-overwrite-by-id semantics
        self._collection.upsert(
            ids=list(ids),
            embeddings=embeddings.tolist(),
            documents=list(documents),
            metadatas=list(metadatas) if metadatas else None,
        )
        return len(ids)

    def query(self, query_embeddings: Union[np.ndarray, torch.Tensor],
              n_results: int = 5) -> Dict:
        if self.count() == 0:
            return {"ids": [[]], "documents": [[]], "distances": [[]],
                    "metadatas": [[]]}
        # the service hands over the device encode (its path for the
        # in-process store); Chroma takes host floats
        if isinstance(query_embeddings, torch.Tensor):
            query_embeddings = query_embeddings.detach().float().cpu().numpy()
        host = np.atleast_2d(np.asarray(query_embeddings, np.float32))
        out = self._collection.query(
            query_embeddings=host.tolist(),
            n_results=n_results,
            include=["documents", "distances", "metadatas"],
        )
        # Chroma gives None for a missing metadatas list or record
        rows = out.get("metadatas") or [[None] * len(ids) for ids in out["ids"]]
        out["metadatas"] = [[m or {} for m in row] for row in rows]
        return out

    def count(self) -> int:
        return int(self._collection.count())

    # ---- persistence: server-side in Chroma ---------------------------------

    def save(self, path: str) -> None:  # interface parity; state lives server-side
        logger.info("ChromaCollection.save is a no-op (server persists %r)",
                    self.name)

    @classmethod
    def load(cls, path: str) -> "ChromaCollection":
        raise NotImplementedError(
            "Chroma collections persist server-side; reconnect with "
            "ChromaCollection(name, host, port) instead of load()"
        )


def collection_from_env(name: str = "documents",
                        device: Union[str, torch.device] = "cuda"):
    """``CHROMA_HOST`` set -> a Chroma collection, falling back to the
    in-process store on any error; unset -> the in-process store on
    ``device``."""
    from .store import VectorCollection

    host = os.environ.get("CHROMA_HOST")
    if host:
        port = int(os.environ.get("CHROMA_PORT", 8000))
        try:
            collection = ChromaCollection(name, host=host, port=port)
            logger.info("Using ChromaDB collection %r at %s:%d", name, host, port)
            return collection
        except Exception as exc:
            logger.error(
                "Chroma connect failed (%s); falling back to the in-process "
                "store", exc)
    return VectorCollection(name, device=device)
