"""Serving layer: in-process vector store + route handlers (+ FastAPI, gated)."""

from .service import RetrievalService, ServiceError
from .store import VectorCollection

__all__ = ["RetrievalService", "ServiceError", "VectorCollection"]
