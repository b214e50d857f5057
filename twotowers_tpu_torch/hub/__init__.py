"""HuggingFace Hub publishing/loading (optional, gated)."""

from .huggingface import (
    download_dataset_from_hub,
    load_model_from_hub,
    save_and_upload,
    save_model_for_hub,
    upload_model_to_hub,
)

__all__ = [
    "download_dataset_from_hub",
    "load_model_from_hub",
    "save_and_upload",
    "save_model_for_hub",
    "upload_model_to_hub",
]
