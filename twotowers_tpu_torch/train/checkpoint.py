"""Checkpoints, the serving half: write parameters and load a trained model.

The layout of ``twotowers_tpu/train/checkpoint.py`` with its ``meta.json``
sidecar (epoch, step, loss, timestamp, tokenizer state, config). The array
store is ``params.npz``: the JAX param pytree's leaves under their
``/``-joined paths, in the JAX layout, so ``convert.params_from_jax`` reads
it. Optimizer state, ``best_model``, resume and the orbax importer come
with the training slice (ROADMAP.md §1 item 6).
"""

from __future__ import annotations

import datetime
import json
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.logging import get_logger

logger = get_logger("train.checkpoint")

PARAMS_FILE = "params.npz"
META_FILE = "meta.json"


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            flat.update(_flatten(value, path + "/"))
        else:
            flat[path] = np.asarray(value)
    return flat


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, value in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


def save_params(
    checkpoint_path: str,
    params_np: Dict[str, Any],
    tokenizer_state: Dict[str, Any],
    config: Dict[str, Any],
    *,
    epoch: int = 0,
    step: int = 0,
    loss: float = float("inf"),
) -> str:
    """Write ``params.npz`` and ``meta.json`` into ``checkpoint_path``.

    ``params_np`` is the JAX param tree as nested dicts of numpy arrays
    (``convert.params_to_jax`` gives it for a TwoTower).
    """
    path = Path(checkpoint_path)
    path.mkdir(parents=True, exist_ok=True)
    np.savez(path / PARAMS_FILE, **_flatten(params_np))
    meta = {
        "epoch": int(epoch),
        "step": int(step),
        "loss": float(loss),
        "timestamp": datetime.datetime.now().strftime("%Y%m%d_%H%M%S"),
        "tokenizer": tokenizer_state,
        "config": config,
    }
    with open(path / META_FILE, "w") as f:
        json.dump(meta, f)
    logger.info("Saved parameters to %s", path)
    return str(path)


def load_metadata(checkpoint_path: str) -> Dict[str, Any]:
    with open(Path(checkpoint_path) / META_FILE) as f:
        return json.load(f)


def load_trained_model(
    checkpoint_path: str, device: Union[str, torch.device] = "cuda"
) -> Tuple[Any, Any, Any, Dict[str, Any]]:
    """Rebuild ``(model, spec, tokenizer, config)`` from a checkpoint
    directory; the model is in eval mode on ``device``."""
    from ..convert import params_from_jax
    from ..models.towers import spec_from_config
    from ..tokenizers import tokenizer_from_state

    device = resolve_device(device)
    meta = load_metadata(checkpoint_path)
    if not meta.get("tokenizer") or meta.get("config") is None:
        raise ValueError(
            f"Checkpoint {checkpoint_path} lacks tokenizer/config metadata"
        )
    tokenizer = tokenizer_from_state(meta["tokenizer"])
    config = meta["config"]
    spec = spec_from_config(config, vocab_size=tokenizer.vocab_size)
    with np.load(Path(checkpoint_path) / PARAMS_FILE) as data:
        tree = _unflatten({key: data[key] for key in data.files})
    model = params_from_jax(tree, spec).to(device).eval()
    return model, spec, tokenizer, config
