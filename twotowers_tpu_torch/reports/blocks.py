"""Reusable report sections.

A copy of ``twotowers_tpu/reports/blocks.py``: the training-dynamics,
similarity, performance, gradient, config and IR blocks render offline
markdown from a run's metric records, the cross-run blocks compare runs,
and ``as_wandb_panels`` builds W&B panel objects where
``wandb_workspaces`` is importable (imported inside the call).
"""

from __future__ import annotations

from typing import Any, Dict, List

import yaml

from .report_utils import series, summarise_series


def _stat_table(title: str, rows: List[tuple]) -> str:
    lines = [f"### {title}", "", "| metric | first | last | min | max | mean |",
             "|---|---|---|---|---|---|"]
    for name, stats in rows:
        if not stats:
            continue
        lines.append(
            f"| {name} | {stats['first']:.4g} | {stats['last']:.4g} | "
            f"{stats['min']:.4g} | {stats['max']:.4g} | {stats['mean']:.4g} |"
        )
    return "\n".join(lines)


def training_dynamics_block(records: List[Dict[str, Any]]) -> str:
    rows = [
        ("train/batch_loss", summarise_series(series(records, "train/batch_loss"))),
        ("train/epoch_loss", summarise_series(series(records, "train/epoch_loss"))),
        ("train/learning_rate", summarise_series(series(records, "train/learning_rate"))),
    ]
    return _stat_table("Training dynamics", rows)


def similarity_block(records: List[Dict[str, Any]]) -> str:
    rows = [
        ("train/pos_similarity", summarise_series(series(records, "train/pos_similarity"))),
        ("train/neg_similarity", summarise_series(series(records, "train/neg_similarity"))),
        ("train/similarity_diff", summarise_series(series(records, "train/similarity_diff"))),
    ]
    return _stat_table("Similarity monitors", rows)


def performance_block(records: List[Dict[str, Any]]) -> str:
    rows = [
        ("performance/batch_time", summarise_series(series(records, "performance/batch_time"))),
        ("performance/samples_per_second",
         summarise_series(series(records, "performance/samples_per_second"))),
        ("train/epoch_time", summarise_series(series(records, "train/epoch_time"))),
    ]
    return _stat_table("Performance", rows)


def gradient_block(records: List[Dict[str, Any]]) -> str:
    rows = [
        ("gradients/total_norm", summarise_series(series(records, "gradients/total_norm"))),
    ]
    return _stat_table("Gradients", rows)


def config_block(config: Dict[str, Any]) -> str:
    return "### Configuration\n\n```yaml\n" + yaml.dump(
        config, default_flow_style=False, sort_keys=False
    ) + "```"


def ir_metrics_block(ir_metrics: Dict[str, float]) -> str:
    lines = ["### IR evaluation", "", "| metric | score |", "|---|---|"]
    for key in sorted(ir_metrics):
        lines.append(f"| {key} | {ir_metrics[key]:.4f} |")
    return "\n".join(lines)


def parallel_coordinates_block(runs: List[Dict[str, Any]],
                               target: str = "train/epoch_loss") -> str:
    """Offline analogue of W&B's parallel-coordinates panel: each run is one line through
    the varying-config axes ending at the target metric — rendered as a
    markdown table with one row per run, one column per axis.

    ``runs``: [{"name", "config" (flat dict), "records"}], as built by
    compare_report.
    """
    import json as _json

    all_keys = sorted({k for r in runs for k in r["config"]})
    axes = [
        k for k in all_keys
        if len({_json.dumps(r["config"].get(k), default=str) for r in runs}) > 1
    ]
    if not axes:
        return "### Parallel coordinates\n\n_All run configs identical._"
    lines = ["### Parallel coordinates", "",
             "| run | " + " | ".join(axes) + f" | {target} |",
             "|---" * (len(axes) + 2) + "|"]
    for r in runs:
        values = series(r["records"], target)
        final = f"{values[-1]:.4g}" if values else "—"
        cells = [str(r["config"].get(k, "—")) for k in axes]
        lines.append(f"| {r['name']} | " + " | ".join(cells) + f" | {final} |")
    return "\n".join(lines)


def parameter_importance_block(runs: List[Dict[str, Any]],
                               target: str = "train/epoch_loss") -> str:
    """Offline analogue of W&B's parameter-importance panel: rank each varying numeric
    config key by |Pearson correlation| with the final target metric across
    runs. Needs >= 3 runs with the metric for a meaningful estimate."""
    import numpy as np

    points = []
    for r in runs:
        values = series(r["records"], target)
        if values:
            points.append((r["config"], values[-1]))
    if len(points) < 3:
        return ("### Parameter importance\n\n"
                f"_Needs >= 3 runs with `{target}`; have {len(points)}._")

    targets = np.asarray([t for _, t in points], np.float64)
    all_keys = sorted({k for cfg, _ in points for k in cfg})
    rows = []
    for key in all_keys:
        vals = [cfg.get(key) for cfg, _ in points]
        if any(v is None or isinstance(v, (str, bool, dict, list)) for v in vals):
            continue
        arr = np.asarray(vals, np.float64)
        if np.ptp(arr) == 0 or np.ptp(targets) == 0:
            continue
        corr = float(np.corrcoef(arr, targets)[0, 1])
        if np.isfinite(corr):
            rows.append((key, corr))
    rows.sort(key=lambda kv: -abs(kv[1]))
    if not rows:
        return ("### Parameter importance\n\n"
                "_No varying numeric config keys to correlate._")
    lines = ["### Parameter importance", "",
             f"|correlation| of each varying numeric config key with final "
             f"`{target}` across {len(points)} runs:", "",
             "| parameter | correlation |", "|---|---|"]
    for key, corr in rows:
        lines.append(f"| {key} | {corr:+.3f} |")
    return "\n".join(lines)


def as_wandb_panels(records: List[Dict[str, Any]]):
    """wandb_workspaces panel grid built from a run's REAL metric records:
    only series actually present get a panel."""
    try:
        import wandb_workspaces.reports.v2 as wr
    except Exception as exc:
        raise RuntimeError(f"wandb_workspaces not installed: {exc}")
    if not records:
        raise ValueError(
            "as_wandb_panels needs the run's metric records; got none "
            "(load them with report_utils.load_metrics)")

    present = {k for r in records for k in r}
    groups = [
        ["train/batch_loss", "train/epoch_loss"],
        ["train/pos_similarity", "train/neg_similarity", "train/similarity_diff"],
        ["performance/samples_per_second", "performance/batch_time"],
        ["gradients/total_norm"],
        ["val/loss", "val/pos_similarity"],
    ]
    panels = []
    for group in groups:
        ys = [k for k in group if k in present]
        if ys:
            x = "train/batch" if "train/batch" in present else "epoch"
            panels.append(wr.LinePlot(x=x, y=ys))
    if not panels:
        raise ValueError(
            f"records contain none of the known metric series; keys seen: "
            f"{sorted(present)[:12]}")
    return [wr.PanelGrid(panels=panels)]
