"""Row-sharded dense index: each rank holds a block of the documents, and a
search merges the shards' top-k into the exact global top-k.

The counterpart of ``twotowers_tpu/index/sharded.py``. The (N, D) matrix is
zero-padded to a multiple of the shard count (the mesh axis; the JAX
package's padding to a 128-row TPU tile is not needed) and shard ``s``
keeps rows ``[s * rows, (s + 1) * rows)`` on its device. A search runs
``score_topk`` (the CUDA kernel on the card) over the local rows with
``n_docs = clamp(N - s * rows, 0, rows)``, so a shard's pad rows score
-1e30, adds the shard's offset to the indices, and merges the shards'
winners with ``sharded_topk_merge``; ``k`` is clamped to N, and no pad row
can win while N real rows remain. The result is the same on every rank.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..ops.topk_score import score_topk
from ..parallel.collectives import all_gather_rows, sharded_topk_merge
from ..parallel.mesh import axis_group, axis_index, axis_size, is_writer, mesh_device
from ..utils.logging import get_logger
from .base import BaseSearch
from .two_tower import unpack_topk

logger = get_logger("index.sharded")


class ShardedDocIndex:
    """Vector-level sharded index (text handling stays with the caller)."""

    def __init__(self, mesh: DeviceMesh, axis: str = "model"):
        self.mesh = mesh
        self.axis = axis
        self.num_shards = axis_size(mesh, axis)
        self._doc_matrix: Optional[torch.Tensor] = None  # this shard's rows
        self._n_docs = 0
        self._rows_per_shard = 0

    def build(self, doc_vectors: np.ndarray) -> None:
        """Keep this rank's rows of the (N, D) vectors, which every rank
        passes whole, on its device."""
        doc_vectors = np.asarray(doc_vectors)
        n, dim = doc_vectors.shape
        self._n_docs = n
        rows = -(-max(n, 1) // self.num_shards)
        start = axis_index(self.mesh, self.axis) * rows
        block = np.zeros((rows, dim), doc_vectors.dtype)
        real = doc_vectors[start:start + rows]
        block[:len(real)] = real
        self._rows_per_shard = rows
        self._doc_matrix = torch.from_numpy(block).to(mesh_device(self.mesh))
        logger.info("Built sharded index: %d docs over %d shard(s), %d rows/shard",
                    n, self.num_shards, rows)

    def search_vectors(self, queries: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """(Q, D) query vectors -> exact global (scores, indices), (Q, k),
        on every rank (each passes the same queries)."""
        if self._doc_matrix is None:
            raise RuntimeError("Index not built")
        k = min(k, self._n_docs)
        rows = self._rows_per_shard
        offset = axis_index(self.mesh, self.axis) * rows
        q = torch.as_tensor(np.asarray(queries)).to(self._doc_matrix.device)
        local_n = min(max(self._n_docs - offset, 0), rows)
        scores, idx = score_topk(self._doc_matrix, q, min(k, rows), local_n)
        scores, idx = sharded_topk_merge(scores, idx + offset, self.mesh, k, self.axis)
        return unpack_topk(scores, idx)

    def to_host(self) -> np.ndarray:
        """The whole (unpadded) doc matrix as host numpy on every rank; a
        collective over the shards."""
        if self._doc_matrix is None:
            raise RuntimeError("Index not built")
        full = all_gather_rows(self._doc_matrix, axis_group(self.mesh, self.axis))
        return full[: self._n_docs].cpu().numpy()

    @property
    def num_documents(self) -> int:
        return self._n_docs


class ShardedTwoTowerSearch(BaseSearch):
    """Text-level sharded search: TwoTowerSearch's encoding + ShardedDocIndex."""

    def __init__(self, model, spec, tokenizer, mesh: DeviceMesh, *,
                 max_length: int = 64, encode_batch_size: int = 256,
                 axis: str = "model"):
        from .two_tower import TwoTowerSearch

        self._encoder = TwoTowerSearch(
            model, spec, tokenizer, max_length=max_length,
            encode_batch_size=encode_batch_size, device=mesh_device(mesh),
        )
        self._index = ShardedDocIndex(mesh, axis=axis)
        self.documents: List[str] = []

    def index_documents(self, documents: Sequence[str]) -> None:
        self.documents = list(documents)
        vectors = self._encoder._encode_texts(self.documents, "document")
        self._index.build(vectors)

    def search_batch(self, queries: Sequence[str], top_k: int = 5):
        q_vecs = self._encoder._encode_texts(list(queries), "query")
        scores, idx = self._index.search_vectors(q_vecs, top_k)
        return [
            [(self.documents[int(i)], float(s)) for s, i in zip(qs, qi)]
            for qs, qi in zip(scores, idx)
        ]

    def search(self, query: str, top_k: int = 5):
        return self.search_batch([query], top_k)[0]

    def save_index(self, path: str) -> None:
        """Every rank of the process group takes part: the shards are
        gathered (``to_host``), rank 0 alone writes, in the JAX package's
        layout, and the ranks wait for it, so a ``load_index`` that follows
        reads whole files."""
        full = self._index.to_host()
        if is_writer():
            out = Path(path)
            out.mkdir(parents=True, exist_ok=True)
            np.savez_compressed(out / "embeddings.npz", embeddings=full)
            with open(out / "documents.json", "w") as f:
                json.dump({"documents": self.documents}, f)
        dist.barrier()

    def load_index(self, path: str) -> None:
        """Every rank reads the files and keeps its rows."""
        src = Path(path)
        with np.load(src / "embeddings.npz") as data:
            vecs = data["embeddings"]
        with open(src / "documents.json") as f:
            self.documents = json.load(f)["documents"]
        self._index.build(vecs)

    @property
    def num_documents(self) -> int:
        return self._index.num_documents
