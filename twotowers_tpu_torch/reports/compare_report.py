"""Multi-run comparison report.

A copy of ``twotowers_tpu/reports/compare_report.py``: side-by-side final
metrics with the best run per metric, IR metrics, config differences and
the cross-run blocks, as offline markdown across run directories.
"""

from __future__ import annotations

import datetime
import json
from pathlib import Path
from typing import Any, Dict, List, Optional

import yaml

from ..utils.logging import get_logger
from .blocks import parallel_coordinates_block, parameter_importance_block
from .report_utils import find_experiment_files, load_metrics, series

logger = get_logger("reports.compare")

COMPARE_METRICS = [
    ("train/epoch_loss", min, "last"),
    ("train/pos_similarity", max, "last"),
    ("train/similarity_diff", max, "last"),
    ("performance/samples_per_second", max, "mean"),
]


def _final(records, key: str, mode: str) -> Optional[float]:
    values = series(records, key)
    if not values:
        return None
    if mode == "mean":
        return sum(values) / len(values)
    return values[-1]


def _flatten_config(config: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    flat = {}
    for key, value in config.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            flat.update(_flatten_config(value, name + "."))
        else:
            flat[name] = value
    return flat


def create_comparison_report(run_dirs: List[str], output: Optional[str] = None) -> str:
    """Render a markdown comparison across run directories; returns path."""
    runs = []
    for run_dir in run_dirs:
        files = find_experiment_files(run_dir)
        records = load_metrics(files["metrics"]) if files["metrics"] else []
        config = yaml.safe_load(files["config"].read_text()) if files["config"] else {}
        ir = json.loads(files["ir_metrics"].read_text()) if files["ir_metrics"] else {}
        runs.append({"name": Path(run_dir).name, "records": records,
                     "config": _flatten_config(config), "ir": ir})

    lines = [
        "# Run comparison",
        f"_generated {datetime.datetime.now().isoformat(timespec='seconds')}_",
        "",
        "## Final metrics",
        "",
        "| metric | " + " | ".join(r["name"] for r in runs) + " | best |",
        "|---" * (len(runs) + 2) + "|",
    ]
    for key, better, mode in COMPARE_METRICS:
        values = [_final(r["records"], key, mode) for r in runs]
        present = [v for v in values if v is not None]
        best = better(present) if present else None
        cells = []
        for v in values:
            if v is None:
                cells.append("—")
            else:
                cells.append(f"{v:.4g}{'**' if v == best else ''}"
                             if v == best else f"{v:.4g}")
        winner = runs[values.index(best)]["name"] if best is not None else "—"
        lines.append(f"| {key} | " + " | ".join(cells) + f" | {winner} |")

    ir_keys = sorted({k for r in runs for k in r["ir"]})
    if ir_keys:
        lines += ["", "## IR metrics", "",
                  "| metric | " + " | ".join(r["name"] for r in runs) + " |",
                  "|---" * (len(runs) + 1) + "|"]
        for key in ir_keys:
            cells = [f"{r['ir'].get(key, float('nan')):.4f}" if key in r["ir"] else "—"
                     for r in runs]
            lines.append(f"| {key} | " + " | ".join(cells) + " |")

    # config differences only (identical keys are noise)
    all_keys = sorted({k for r in runs for k in r["config"]})
    diff_keys = [
        k for k in all_keys
        if len({json.dumps(r["config"].get(k), default=str) for r in runs}) > 1
    ]
    if diff_keys:
        lines += ["", "## Config differences", "",
                  "| key | " + " | ".join(r["name"] for r in runs) + " |",
                  "|---" * (len(runs) + 1) + "|"]
        for key in diff_keys:
            cells = [str(r["config"].get(key, "—")) for r in runs]
            lines.append(f"| {key} | " + " | ".join(cells) + " |")

    # cross-run analyses (analogues of W&B's hosted panels)
    if len(runs) >= 2:
        lines += ["", parallel_coordinates_block(runs),
                  "", parameter_importance_block(runs)]

    report = "\n".join(lines) + "\n"
    out_path = Path(output) if output else Path(run_dirs[0]).parent / "comparison_report.md"
    out_path.write_text(report)
    logger.info("Wrote comparison report to %s", out_path)
    return str(out_path)
