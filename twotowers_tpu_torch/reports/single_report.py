"""Single-run report generation.

A copy of ``twotowers_tpu/reports/single_report.py``: one markdown document
covering training dynamics, similarity, performance, gradients, config, IR
metrics and dataset genealogy, rendered from the run directory; or a
hosted W&B report when ``wandb_workspaces`` is importable (imported inside
the call).
"""

from __future__ import annotations

import datetime
import json
from pathlib import Path
from typing import Optional

import yaml

from ..utils.logging import get_logger
from .blocks import (
    config_block,
    gradient_block,
    ir_metrics_block,
    performance_block,
    similarity_block,
    training_dynamics_block,
)
from .report_utils import (
    find_experiment_files,
    genealogy_flowchart,
    load_metrics,
    resolve_run_id,
)

logger = get_logger("reports.single")


def create_run_report(run_dir: str, output: Optional[str] = None) -> str:
    """Render a markdown report for one run directory; returns the path."""
    files = find_experiment_files(run_dir)
    run_name = Path(run_dir).name
    sections = [f"# Training report: {run_name}",
                f"_generated {datetime.datetime.now().isoformat(timespec='seconds')}_"]

    if files["metrics"]:
        records = load_metrics(files["metrics"])
        sections += [
            training_dynamics_block(records),
            similarity_block(records),
            performance_block(records),
            gradient_block(records),
        ]
    else:
        sections.append("_No metrics JSONL found._")

    if files["ir_metrics"]:
        sections.append(ir_metrics_block(json.loads(files["ir_metrics"].read_text())))

    if files["config"]:
        sections.append(config_block(yaml.safe_load(files["config"].read_text())))

    if files["genealogy"]:
        sections.append("### Dataset genealogy\n\n" + genealogy_flowchart(
            json.loads(files["genealogy"].read_text())
        ))

    if files["summary"]:
        summary = json.loads(files["summary"].read_text())
        sections.append("### Run summary\n\n```json\n"
                        + json.dumps(summary, indent=2, default=str) + "\n```")

    report = "\n\n".join(sections) + "\n"
    out_path = Path(output) if output else Path(run_dir) / "report.md"
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(report)
    logger.info("Wrote report to %s", out_path)
    return str(out_path)


def create_wandb_report(run_dir: str, project: str,
                        entity: Optional[str] = None) -> str:
    """Hosted W&B report for a run (requires wandb_workspaces + a run id).

    Panels are built from the run's REAL metric records so only series the
    run actually logged appear.
    """
    try:
        import wandb_workspaces.reports.v2 as wr
    except Exception as exc:
        raise RuntimeError(f"wandb_workspaces not installed: {exc}")
    from .blocks import as_wandb_panels

    files = find_experiment_files(run_dir)
    if not files["metrics"]:
        raise ValueError(f"No metrics JSONL under {run_dir}; nothing to report")
    records = load_metrics(files["metrics"])

    run_id = resolve_run_id(run_dir)
    blocks = [wr.H1("Training dynamics"), *as_wandb_panels(records)]
    if run_id:
        blocks.append(wr.MarkdownBlock(text=f"W&B run id: `{run_id}`"))
    report = wr.Report(
        project=project, entity=entity,
        title=f"Two-tower report: {Path(run_dir).name}",
        blocks=blocks,
    )
    report.save()
    return report.url
