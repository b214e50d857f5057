"""Abstract dense-retrieval index interface.

A copy of ``twotowers_tpu/index/base.py``:
``index_documents`` / ``search`` / ``save_index`` / ``load_index``. Search
returns ``(document, score)`` pairs best-first. Persistence is
npz + JSON.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import List, Sequence, Tuple


class BaseSearch(ABC):
    """Index a document collection and answer top-k similarity queries."""

    @abstractmethod
    def index_documents(self, documents: Sequence[str]) -> None:
        """Encode and store the documents; replaces any existing index."""

    @abstractmethod
    def search(self, query: str, top_k: int = 5) -> List[Tuple[str, float]]:
        """Return the ``top_k`` (document, score) pairs, best first."""

    @abstractmethod
    def save_index(self, path: str) -> None:
        """Persist the index (embeddings + documents) to ``path``."""

    @abstractmethod
    def load_index(self, path: str) -> None:
        """Restore an index saved by :meth:`save_index`."""

    @property
    @abstractmethod
    def num_documents(self) -> int:
        """Number of indexed documents."""
