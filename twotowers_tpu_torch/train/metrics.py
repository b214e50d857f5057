"""Metric logging with the reference's W&B metric-name contract.

A copy of ``twotowers_tpu/train/metrics.py``: per-batch scalars
(``train/batch_loss``, ``train/pos_similarity``, ``train/neg_similarity``,
``train/similarity_diff``, ``performance/*``, ``gradients/total_norm``) and
per-epoch scalars (``train/epoch_loss`` ...) under unchanged names. W&B is
optional: it is imported only when ``use_wandb`` asks for it, and the same
records are always appended to a local JSONL file.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, Optional

from ..utils.logging import get_logger

logger = get_logger("train.metrics")


def _import_wandb():
    try:  # gated optional dependency
        import wandb
    except Exception:  # pragma: no cover - depends on environment
        return None
    return wandb


class MetricLogger:
    """Logs metric dicts to W&B when available, always to a local JSONL."""

    def __init__(
        self,
        config: Dict[str, Any],
        log_dir: str = "logs",
        run_name: Optional[str] = None,
    ):
        wandb = _import_wandb() if config.get("use_wandb") else None
        self.enabled_wandb = wandb is not None
        if config.get("use_wandb") and wandb is None:
            logger.warning("use_wandb=true but wandb is not installed; using JSONL only")
        self._run = None
        wandb_cfg = config.get("wandb", {}) or {}
        self.run_name = run_name or wandb_cfg.get("run_name") or f"run_{int(time.time())}"
        if self.enabled_wandb:  # pragma: no cover - needs wandb
            self._run = wandb.init(
                project=wandb_cfg.get("project", "two-tower-retrieval"),
                entity=wandb_cfg.get("entity"),
                name=wandb_cfg.get("run_name"),
                tags=wandb_cfg.get("tags"),
                config=config,
            )
        log_path = Path(log_dir)
        log_path.mkdir(parents=True, exist_ok=True)
        self.jsonl_path = log_path / f"{self.run_name}_metrics.jsonl"
        self._file = open(self.jsonl_path, "a")

    def log(self, record: Dict[str, Any]) -> None:
        if self._run is not None:  # pragma: no cover - needs wandb
            self._run.log(record)
        payload = {k: (float(v) if hasattr(v, "__float__") else v) for k, v in record.items()}
        payload["_time"] = time.time()
        self._file.write(json.dumps(payload) + "\n")

    def finish(self) -> None:
        self._file.flush()
        self._file.close()
        if self._run is not None:  # pragma: no cover - needs wandb
            self._run.finish()

    def __enter__(self) -> "MetricLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.finish()
