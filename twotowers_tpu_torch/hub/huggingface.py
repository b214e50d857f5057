"""HuggingFace Hub integration: export, upload, download.

The counterpart of ``twotowers_tpu/hub/huggingface.py`` over the port's
checkpoint layout (``params.npz`` + ``opt_state.npz`` + ``meta.json``):
``save_model_for_hub`` stages a checkpoint directory and a model card
offline; ``upload_model_to_hub``, ``save_and_upload``, ``load_model_from_hub``
and ``download_dataset_from_hub`` import ``huggingface_hub`` inside the call
and need a token and the network. Failures raise with clear messages; the
train loop soft-fails around them, as the JAX package's does.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict, Optional

from ..utils.logging import get_logger

logger = get_logger("hub.huggingface")

TOKEN_ENV = "HUGGINGFACE_ACCESS_TOKEN"


def _api(token: Optional[str] = None):
    try:
        from huggingface_hub import HfApi  # gated import
    except ImportError as exc:
        raise RuntimeError(f"huggingface_hub is not installed: {exc}") from exc
    return HfApi(token=token or os.environ.get(TOKEN_ENV))


def _model_card(repo_id: str, config: Optional[Dict[str, Any]]) -> str:
    encoder = (config or {}).get("encoder", {}) or {}
    loss = (config or {}).get("loss", {}) or {}
    return (
        "---\n"
        "tags: [retrieval, two-tower, dual-encoder, pytorch, cuda]\n"
        "library_name: twotowers_tpu_torch\n"
        "---\n\n"
        f"# {repo_id}\n\n"
        "Two-tower retrieval model trained with `twotowers_tpu_torch` (PyTorch, CUDA).\n\n"
        f"- encoder arch: `{encoder.get('arch', 'mean')}`\n"
        f"- hidden dim: `{encoder.get('hidden_dim', 128)}`\n"
        f"- loss: `{loss.get('type', 'triplet')}`\n\n"
        "Load with `twotowers_tpu_torch.hub.load_model_from_hub(repo_id)`.\n"
    )


def save_model_for_hub(checkpoint_path: str, local_dir: str,
                       repo_id: str = "two-tower") -> str:
    """Stage a checkpoint directory + model card for upload."""
    src = Path(checkpoint_path)
    dst = Path(local_dir)
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(src, dst / "checkpoint")
    meta = {}
    meta_path = src / "meta.json"
    if meta_path.exists():
        meta = json.loads(meta_path.read_text())
    (dst / "README.md").write_text(_model_card(repo_id, meta.get("config")))
    logger.info("Staged model for hub at %s", dst)
    return str(dst)


def upload_model_to_hub(local_dir: str, repo_id: str, *,
                        private: bool = False, token: Optional[str] = None) -> str:
    """Create the repo if needed and upload the staged folder."""
    api = _api(token)
    api.create_repo(repo_id, private=private, exist_ok=True)
    api.upload_folder(folder_path=local_dir, repo_id=repo_id)
    url = f"https://huggingface.co/{repo_id}"
    logger.info("Uploaded model to %s", url)
    return url


def save_and_upload(checkpoint_path: str, repo_id: str, *,
                    local_dir: Optional[str] = None, private: bool = False,
                    token: Optional[str] = None) -> str:
    """Stage + upload in one call (the train loop's ``push_to_hub`` hook)."""
    if "/" not in repo_id:
        try:
            username = _api(token).whoami()["name"]
            repo_id = f"{username}/{repo_id}"
        except Exception as exc:
            logger.warning("Could not resolve Hub username: %s", exc)
    staged = save_model_for_hub(
        checkpoint_path,
        local_dir or str(Path(checkpoint_path).parent / "hub_export"),
        repo_id,
    )
    return upload_model_to_hub(staged, repo_id, private=private, token=token)


def load_model_from_hub(repo_id: str, *, cache_dir: Optional[str] = None,
                        token: Optional[str] = None) -> str:
    """Download a model repo; returns the local checkpoint directory path."""
    try:
        from huggingface_hub import snapshot_download  # gated import
    except ImportError as exc:
        raise RuntimeError(f"huggingface_hub is not installed: {exc}") from exc
    local = snapshot_download(
        repo_id, cache_dir=cache_dir, token=token or os.environ.get(TOKEN_ENV)
    )
    return str(Path(local) / "checkpoint")


def download_dataset_from_hub(repo_id: str, *, cache_dir: Optional[str] = None,
                              token: Optional[str] = None) -> str:
    """Download a dataset repo snapshot; returns the local path."""
    try:
        from huggingface_hub import snapshot_download  # gated import
    except ImportError as exc:
        raise RuntimeError(f"huggingface_hub is not installed: {exc}") from exc
    return snapshot_download(
        repo_id, repo_type="dataset", cache_dir=cache_dir,
        token=token or os.environ.get(TOKEN_ENV),
    )
