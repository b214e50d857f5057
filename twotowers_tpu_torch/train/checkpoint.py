"""Checkpoints: parameters, optimizer state, ``best_model`` and resume.

The layout of ``twotowers_tpu/train/checkpoint.py``: ``save_checkpoint``
writes ``<dir>/two_tower_<timestamp>_epoch<N>/`` and mirrors it to
``<dir>/best_model``; ``latest_checkpoint`` finds the newest and
``load_checkpoint`` reads it back for ``resume``. Each directory holds a
``meta.json`` sidecar (epoch, step, loss, timestamp, tokenizer state,
config). The array stores are ``params.npz`` and ``opt_state.npz``: the JAX
param pytree's leaves and optax's optimizer state (``count``, ``mu/...``,
``nu/...``; see ``convert.py``) under their ``/``-joined paths, in the JAX
layout, in place of the JAX package's orbax directory. A list in the tree
(the transformer's ``layers``) is stored item by item under its index
(``query_tower/layers/0/q_w``) and read back as a list. A directory the
JAX package wrote (an orbax ``state/`` and no ``params.npz``) is converted
by the repo's ``bridge/orbax_to_torch.py``; the loaders here say so.
"""

from __future__ import annotations

import datetime
import json
import re
import shutil
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.logging import get_logger

logger = get_logger("train.checkpoint")

PARAMS_FILE = "params.npz"
OPT_STATE_FILE = "opt_state.npz"
META_FILE = "meta.json"
BEST_NAME = "best_model"


def _flatten(tree: Union[Dict[str, Any], list], prefix: str = "") -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}
    items = enumerate(tree) if isinstance(tree, list) else tree.items()
    for key, value in items:
        path = f"{prefix}{key}"
        if isinstance(value, (dict, list)):
            flat.update(_flatten(value, path + "/"))
        else:
            flat[path] = np.asarray(value)
    return flat


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    from ..convert import nest

    return nest((tuple(int(part) if part.isdigit() else part for part in path.split("/")),
                 value) for path, value in flat.items())


def _write_meta(path: Path, tokenizer_state, config, *, epoch: int, step: int,
                loss: float, timestamp: str) -> None:
    meta = {
        "epoch": int(epoch),
        "step": int(step),
        "loss": float(loss),
        "timestamp": timestamp,
        "tokenizer": tokenizer_state,
        "config": config,
    }
    with open(path / META_FILE, "w") as f:
        json.dump(meta, f)


def _timestamp() -> str:
    return datetime.datetime.now().strftime("%Y%m%d_%H%M%S")


def save_arrays(checkpoint_path: Union[str, Path], state_tree: Dict[str, Any]) -> None:
    """Write ``state_tree["params"]`` to ``params.npz`` and its
    ``opt_state``, when there is one, to ``opt_state.npz`` in
    ``checkpoint_path`` (numpy trees in the JAX layout)."""
    path = Path(checkpoint_path)
    path.mkdir(parents=True, exist_ok=True)
    np.savez(path / PARAMS_FILE, **_flatten(state_tree["params"]))
    if state_tree.get("opt_state") is not None:
        np.savez(path / OPT_STATE_FILE, **_flatten(state_tree["opt_state"]))


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
    save_arrays(path, {"params": params_np})
    _write_meta(path, tokenizer_state, config, epoch=epoch, step=step, loss=loss,
                timestamp=_timestamp())
    logger.info("Saved parameters to %s", path)
    return str(path)


def save_checkpoint(
    state_tree: Dict[str, Any],
    checkpoint_dir: str,
    *,
    tokenizer_state: Optional[Dict[str, Any]] = None,
    config: Optional[Dict[str, Any]] = None,
    epoch: int = 0,
    step: int = 0,
    loss: float = float("inf"),
    checkpoint_name: Optional[str] = None,
    save_best: bool = True,
) -> str:
    """Save ``{"params": tree, "opt_state": tree}`` (numpy, JAX layout; see
    ``convert.params_to_jax`` / ``opt_state_to_jax``) with its sidecar
    metadata, and mirror it to ``best_model`` when ``save_best``. Returns
    the checkpoint directory.

    Directories are made with ``exist_ok``: two processes saving into one
    directory do not race between a check and a ``mkdir``.
    """
    root = Path(checkpoint_dir).resolve()
    root.mkdir(parents=True, exist_ok=True)
    timestamp = _timestamp()
    path = root / (checkpoint_name or f"two_tower_{timestamp}_epoch{epoch}")
    save_arrays(path, state_tree)
    _write_meta(path, tokenizer_state, config, epoch=epoch, step=step, loss=loss,
                timestamp=timestamp)
    logger.info("Saved checkpoint to %s", path)

    if save_best:
        best = root / BEST_NAME
        shutil.rmtree(best, ignore_errors=True)
        shutil.copytree(path, best, dirs_exist_ok=True)
        logger.info("Saved best model to %s", best)
    return str(path)


def _read_npz(path: Path) -> Dict[str, Any]:
    if not path.exists() and (path.parent / "state").is_dir():
        raise FileNotFoundError(
            f"{path.parent} is a checkpoint of the JAX package (an orbax state/, no "
            f"{PARAMS_FILE}); convert it first: python bridge/orbax_to_torch.py "
            f"{path.parent} DST")
    with np.load(path) as data:
        return _unflatten({key: data[key] for key in data.files})


def load_checkpoint(checkpoint_path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """``({"params": tree, "opt_state": tree or None}, metadata)`` of a
    checkpoint directory, numpy in the JAX layout."""
    path = Path(checkpoint_path)
    opt_path = path / OPT_STATE_FILE
    tree = {"params": _read_npz(path / PARAMS_FILE),
            "opt_state": _read_npz(opt_path) if opt_path.exists() else None}
    return tree, load_metadata(str(path))


_EPOCH_NAME = re.compile(r"^(.*)_epoch(\d+)$")


def _checkpoint_order(path: Path):
    """Timestamp, then epoch as a number: ``..._epoch10`` follows
    ``..._epoch9`` of the same second (a name sort would not)."""
    match = _EPOCH_NAME.match(path.name)
    return (match.group(1), int(match.group(2))) if match else (path.name, -1)


def latest_checkpoint(checkpoint_dir: str) -> Optional[str]:
    """Most recent checkpoint directory (by name timestamp), if any."""
    root = Path(checkpoint_dir)
    if not root.exists():
        return None
    candidates = sorted(
        (p for p in root.iterdir()
         if p.is_dir() and p.name != BEST_NAME and (p / META_FILE).exists()),
        key=_checkpoint_order)
    return str(candidates[-1]) if candidates else None


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
    tree = _read_npz(Path(checkpoint_path) / PARAMS_FILE)
    model = params_from_jax(tree, spec).to(device).eval()
    return model, spec, tokenizer, config
