"""Report helpers: run discovery, metric loading, genealogy rendering.

A copy of ``twotowers_tpu/reports/report_utils.py``. The source of truth is
the run directory the trainer writes (``scripts/train.py``: the metrics
JSONL, ``summary.json``, ``resolved_config.yml``, ``ir_metrics.json``,
``train.log``; the dataset's ``.genealogy.json`` beside it), so reports
work offline; a W&B run id resolves only where a ``wandb/`` directory is.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Optional

from ..utils.logging import get_logger

logger = get_logger("reports.utils")


def find_experiment_files(run_dir: str) -> Dict[str, Optional[Path]]:
    """Locate a run's artifacts inside its log directory."""
    root = Path(run_dir)
    metrics = sorted(root.glob("*_metrics.jsonl"))
    genealogy: Optional[Path] = None
    summary = root / "summary.json"
    for candidate in root.parent.glob("*.genealogy.json"):
        genealogy = candidate
        break
    resolved = root / "resolved_config.yml"
    return {
        "metrics": metrics[0] if metrics else None,
        "summary": summary if summary.exists() else None,
        "config": resolved if resolved.exists() else None,
        "ir_metrics": (root / "ir_metrics.json")
        if (root / "ir_metrics.json").exists() else None,
        "genealogy": genealogy,
        "log": (root / "train.log") if (root / "train.log").exists() else None,
    }


def load_metrics(metrics_path: Path) -> List[Dict[str, Any]]:
    records = []
    for line in metrics_path.read_text().splitlines():
        line = line.strip()
        if line:
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return records


def series(records: List[Dict[str, Any]], key: str) -> List[float]:
    return [r[key] for r in records if key in r]


def summarise_series(values: List[float]) -> Dict[str, float]:
    if not values:
        return {}
    import numpy as np

    arr = np.asarray(values, dtype=np.float64)
    return {
        "first": float(arr[0]),
        "last": float(arr[-1]),
        "min": float(arr.min()),
        "max": float(arr.max()),
        "mean": float(arr.mean()),
    }


def genealogy_flowchart(genealogy: Dict[str, Any]) -> str:
    """Render a dataset-genealogy record as a Mermaid flowchart."""
    lines = ["```mermaid", "flowchart TD"]
    steps = genealogy.get("pipeline", [])
    for i, step in enumerate(steps):
        label = step.get("step", f"step{i}")
        rows = step.get("rows")
        detail = f"{label}<br/>{rows:,} rows" if rows is not None else label
        lines.append(f'    S{i}["{detail}"]')
        if i:
            lines.append(f"    S{i-1} --> S{i}")
    if steps:
        lines.append(f'    S{len(steps)-1} --> A["{Path(genealogy.get("artifact", "artifact")).name}"]')
    lines.append("```")
    return "\n".join(lines)


def resolve_run_id(run_dir: str) -> Optional[str]:
    """W&B run id for a run directory, when wandb metadata exists."""
    wandb_dir = Path(run_dir) / "wandb"
    if not wandb_dir.exists():
        return None
    for latest in wandb_dir.glob("run-*"):
        return latest.name.split("-")[-1]
    return None
