"""FastAPI inference service: /, /embed, /search, /add, /health.

The counterpart of ``twotowers_tpu/serve/app.py``: the model is loaded at
startup from a local checkpoint or, failing that, from a Hub repo; the
four routes run through ``RetrievalService``; ``/`` serves the search page
(``serve/static/index.html``). The vector backend is the in-process
``VectorCollection`` on the card, or a ChromaDB server when ``CHROMA_HOST``
is set and reachable (``serve/chroma.py``). The HTTP layer needs
``fastapi``; without it ``create_app`` raises, while ``build_service`` (the
service as the app builds it) and ``index_page`` (the page's text) still
work.

Environment:
    MODEL_CHECKPOINT  local checkpoint dir (preferred, offline)
    MODEL_REPO_URL    HF Hub repo id (fallback, needs the network)
    PORT              bind port (default 8080)
    CHROMA_HOST/PORT  optional external ChromaDB

Run:  python -m twotowers_tpu_torch.serve.app
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from ..utils.logging import get_logger, setup_logging
from .service import RetrievalService, ServiceError

logger = get_logger("serve.app")

try:  # gated optional dependency
    from fastapi import FastAPI, HTTPException
    from pydantic import BaseModel

    HAVE_FASTAPI = True
except ImportError:  # pragma: no cover - depends on environment
    HAVE_FASTAPI = False


class ModelRuntime:
    """Loaded two-tower model + tokenizer with a batch encode API."""

    def __init__(self, checkpoint_path: str, batch_size: int = 32,
                 device: Union[str, torch.device] = "cuda"):
        from ..index.two_tower import TwoTowerSearch
        from ..train.checkpoint import load_trained_model

        model, spec, tokenizer, config = load_trained_model(checkpoint_path, device)
        tok_cfg = config.get("tokeniser", config.get("tokenizer", {})) or {}
        max_length = int(tok_cfg.get("max_len", config.get("max_sequence_length", 64)))
        self._search = TwoTowerSearch(
            model, spec, tokenizer, max_length=max_length,
            encode_batch_size=batch_size, device=device,
        )
        self.device = self._search.device
        self.output_dim = spec.output_dim

    def encode(self, texts: List[str], tower: str = "query") -> np.ndarray:
        """(N, D) float32 unit vectors; always 2-D, even for one text."""
        vectors = self._search._encode_texts(texts, tower)
        return np.atleast_2d(np.asarray(vectors, np.float32))

    def encode_device(self, texts: List[str], tower: str = "query") -> torch.Tensor:
        """Device-resident encode for callers that chain another device op
        (RetrievalService.search): no host readback here."""
        return self._search._encode_texts_device(texts, tower)


INDEX_PAGE = Path(__file__).parent / "static" / "index.html"


def _load_runtime(device: Union[str, torch.device] = "cuda") -> Optional[ModelRuntime]:
    checkpoint = os.environ.get("MODEL_CHECKPOINT")
    if checkpoint and os.path.exists(checkpoint):
        logger.info("Loading model from local checkpoint %s", checkpoint)
        return ModelRuntime(checkpoint, device=device)
    repo = os.environ.get("MODEL_REPO_URL")
    if repo:
        try:
            from ..hub.huggingface import load_model_from_hub

            logger.info("Downloading model from the Hub: %s", repo)
            return ModelRuntime(load_model_from_hub(repo), device=device)
        except Exception as exc:
            logger.error("Hub model load failed: %s", exc)
    logger.warning("No model available (set MODEL_CHECKPOINT or MODEL_REPO_URL)")
    return None


def build_service(device: Union[str, torch.device] = "cuda",
                  load_model: bool = True) -> RetrievalService:
    """The service as the app builds it: the collection ``collection_from_env``
    picks (Chroma when ``CHROMA_HOST`` is set and reachable, else the
    in-process store on ``device``) and, with ``load_model``, the runtime
    ``_load_runtime`` finds (the app loads it at startup instead)."""
    from .chroma import collection_from_env

    collection = collection_from_env("documents", device=device)
    model = _load_runtime(device) if load_model else None
    return RetrievalService(model=model, collection=collection, device=device)


def index_page() -> str:
    """The search page ``/`` serves."""
    return INDEX_PAGE.read_text()


def create_app(device: Union[str, torch.device] = "cuda"):
    """Build the FastAPI app (needs fastapi)."""
    if not HAVE_FASTAPI:  # pragma: no cover
        raise RuntimeError(
            "fastapi is not installed; `pip install fastapi uvicorn` to serve"
        )

    service = build_service(device, load_model=False)

    class EmbedRequest(BaseModel):
        texts: List[str]

    class SearchRequest(BaseModel):
        query: str
        top_k: int = 5

    class AddRequest(BaseModel):
        documents: List[str]
        ids: Optional[List[str]] = None
        metadatas: Optional[List[Dict[str, Any]]] = None

    app = FastAPI(title="two-tower retrieval service")

    def run(handler, *args, **kwargs):
        try:
            return handler(*args, **kwargs)
        except ServiceError as exc:
            raise HTTPException(exc.status, exc.detail)

    @app.on_event("startup")
    def startup() -> None:
        service.model = _load_runtime(device)

    @app.get("/health")
    def health():
        return service.health()

    @app.post("/embed")
    def embed(request: EmbedRequest):
        return run(service.embed, request.texts)

    @app.post("/add")
    def add(request: AddRequest):
        return run(service.add, request.documents, request.ids,
                   request.metadatas)

    @app.get("/")
    def root():
        from fastapi.responses import HTMLResponse

        return HTMLResponse(index_page())

    @app.post("/search")
    def search(request: SearchRequest):
        return run(service.search, request.query, request.top_k)

    return app


def main() -> int:  # pragma: no cover - needs uvicorn
    setup_logging()
    import uvicorn

    uvicorn.run(create_app(), host="0.0.0.0", port=int(os.environ.get("PORT", 8080)))
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
