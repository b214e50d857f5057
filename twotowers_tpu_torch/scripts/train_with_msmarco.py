"""End-to-end MS MARCO pipeline: split -> triplets -> sample -> train -> eval.

The counterpart of the repo's root ``train_with_msmarco.py``: a (split x
preset) experiment matrix, fuzzy preset lookup, seeded sub-sampling, config
overrides, a dataset-genealogy JSON per run, optional process-parallel
experiments, and after training the IR evaluation (MRR, P@K, R@K, NDCG) on
held-out queries. Training runs through ``train_model`` on ``--device``,
the card unless the caller asks for the CPU; with no card and no
``--device cpu`` the script raises before any work. ``--input_parquet``
reads a raw split saved before (offline); without it the split is loaded
through the factory, which downloads it with ``datasets`` (imported there,
inside the call). The factory and the parquet files need pandas.
``--parallel`` starts its workers with ``spawn``, as ``scripts/train.py``
does.

Usage:
    python -m twotowers_tpu_torch.scripts.train_with_msmarco --preset presets/classic.yml \
        --samples 10000 [--input_parquet raw.parquet] [--device cpu]
    python -m twotowers_tpu_torch.scripts.train_with_msmarco --presets presets/*.yml \
        --splits train --parallel 2
"""

from __future__ import annotations

import argparse
import datetime
import difflib
import json
import multiprocessing
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import yaml

from ..utils import get_logger, load_config, resolve_device, save_config, setup_logging

logger = get_logger("cli.msmarco")

REPO_ROOT = Path(__file__).resolve().parents[2]
DEFAULT_CONFIG = "configs/msmarco_default.yml"


def find_preset_file(preset: str) -> str:
    """Fuzzy preset resolution: exact path, presets/<name>, then the
    closest name."""
    path = Path(preset)
    if path.exists():
        return str(path)
    candidate = REPO_ROOT / "presets" / path.name
    if candidate.exists():
        return str(candidate)
    if not path.suffix:
        candidate = REPO_ROOT / "presets" / f"{path.name}.yml"
        if candidate.exists():
            return str(candidate)
    available = [p.name for p in (REPO_ROOT / "presets").glob("*.yml")]
    close = difflib.get_close_matches(path.name, available, n=1)
    if close:
        logger.warning("Preset %r not found; using closest match %r", preset, close[0])
        return str(REPO_ROOT / "presets" / close[0])
    raise FileNotFoundError(f"Preset not found: {preset} (available: {available})")


def _build_eval_tuples(df, num_queries: int = 50, num_docs: int = 20, seed: int = 0):
    """Held-out (query, docs, relevance) tuples from triplet rows."""
    import numpy as np

    rng = np.random.default_rng(seed)
    eval_tuples = []
    grouped = df.groupby("q_text")
    all_negs = df["d_neg_text"].tolist()
    for query, group in list(grouped)[:num_queries]:
        positives = group["d_pos_text"].unique().tolist()[:2]
        negs = [all_negs[i] for i in rng.integers(0, len(all_negs),
                                                  num_docs - len(positives))]
        docs = positives + negs
        relevance = [1] * len(positives) + [0] * len(negs)
        order = rng.permutation(len(docs))
        eval_tuples.append((
            query,
            [docs[i] for i in order],
            [relevance[i] for i in order],
        ))
    return eval_tuples


def run_experiment(
    split: str,
    preset_path: str,
    samples: Optional[int],
    epochs: Optional[int],
    batch_size: Optional[int],
    config_path: str,
    seed: int = 42,
    log_dir: str = "logs",
    input_parquet: Optional[str] = None,
    device: str = "cuda",
) -> Dict[str, Any]:
    """One (split, preset) experiment on ``device``; returns a summary dict."""
    import pandas as pd

    from ..data.factory import readers
    from ..data.factory.build_dataset import build_triplets, write_genealogy
    from ..evaluation import evaluate_model, print_evaluation_results
    from ..train import train_model

    preset_path = find_preset_file(preset_path)
    preset = yaml.safe_load(Path(preset_path).read_text())
    preset_name = Path(preset_path).stem
    timestamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
    run_name = f"msmarco_{split}_{preset_name}_{timestamp}"
    run_dir = Path(log_dir) / run_name
    run_dir.mkdir(parents=True, exist_ok=True)
    setup_logging(log_level="INFO", log_file=str(run_dir / "train.log"))

    summary: Dict[str, Any] = {
        "run": run_name, "split": split, "preset": preset_name,
        "samples": samples, "started": timestamp, "device": device,
    }
    start = time.time()
    try:
        readers.setup_data_dirs()
        # 1. acquire split (download or pre-provided parquet)
        if input_parquet:
            raw_df = pd.read_parquet(input_parquet)
        else:
            raw_df = readers.load_split(split)

        # 2. preset -> triplets (+ genealogy sidecar)
        triplets = build_triplets(raw_df, preset, seed=seed)
        if samples and samples < len(triplets):
            triplets = triplets.sample(n=samples, random_state=seed)
        data_path = readers.PROCESSED_DATA_DIR / f"{run_name}.parquet"
        data_path.parent.mkdir(parents=True, exist_ok=True)
        triplets.to_parquet(data_path)
        write_genealogy(
            data_path, preset=preset, preset_path=preset_path, split=split,
            input_rows=len(raw_df), output_rows=len(triplets), seed=seed,
        )

        # 3. config assembly + train
        config = load_config(config_path)
        config["data"] = str(data_path)
        config["log_dir"] = str(run_dir)
        if epochs is not None:
            config["epochs"] = epochs
        if batch_size is not None:
            config["batch_size"] = batch_size
        wandb_cfg = config.setdefault("wandb", {})
        wandb_cfg["run_name"] = run_name
        wandb_cfg.setdefault("tags", []).extend(["msmarco", split, preset_name])
        save_config(config, str(run_dir / "resolved_config.yml"))

        state, pipeline = train_model(config, device=device)

        # 4. IR evaluation on held-out tuples
        eval_tuples = _build_eval_tuples(triplets, seed=seed + 1)
        results = evaluate_model(
            state.model, pipeline.spec, eval_tuples, pipeline.tokenizer,
            max_length=pipeline.max_length,
        )
        print_evaluation_results(results)
        with open(run_dir / "ir_metrics.json", "w") as f:
            json.dump(results, f, indent=2)

        summary.update(success=True, num_triplets=len(triplets),
                       ir_metrics=results)
    except Exception as exc:
        logger.exception("Experiment %s failed", run_name)
        summary.update(success=False, error=str(exc))
    summary["duration_s"] = time.time() - start
    with open(run_dir / "summary.json", "w") as f:
        json.dump(summary, f, indent=2, default=str)
    return summary


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="MS MARCO two-tower pipeline")
    parser.add_argument("--preset", help="Single preset YAML")
    parser.add_argument("--presets", nargs="+", help="Multiple preset YAMLs")
    parser.add_argument("--split", default="train")
    parser.add_argument("--splits", nargs="+", help="Multiple splits")
    parser.add_argument("--samples", type=int, default=None,
                        help="Subsample triplets to N rows")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--config", default=DEFAULT_CONFIG)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--log_dir", default="logs")
    parser.add_argument("--parallel", type=int, default=0)
    parser.add_argument("--input_parquet", default=None,
                        help="Pre-downloaded raw split parquet (offline mode)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    resolve_device(args.device)  # no card and no --device cpu: raise before any work

    presets = args.presets or ([args.preset] if args.preset else ["presets/classic.yml"])
    splits = args.splits or [args.split]
    matrix = [(s, p) for s in splits for p in presets]

    job_args = [
        (s, p, args.samples, args.epochs, args.batch_size, args.config,
         args.seed, args.log_dir, args.input_parquet, args.device)
        for s, p in matrix
    ]
    if args.parallel > 1 and len(matrix) > 1:
        with multiprocessing.get_context("spawn").Pool(args.parallel) as pool:
            summaries = pool.starmap(run_experiment, job_args)
    else:
        summaries = [run_experiment(*a) for a in job_args]

    succeeded = sum(1 for s in summaries if s.get("success"))
    group_path = Path(args.log_dir) / f"msmarco_group_{int(time.time())}.json"
    group_path.parent.mkdir(parents=True, exist_ok=True)
    with open(group_path, "w") as f:
        json.dump({"experiments": summaries}, f, indent=2, default=str)
    print(f"{succeeded}/{len(summaries)} experiments succeeded (details: {group_path})")
    return 0 if succeeded == len(summaries) else 1


if __name__ == "__main__":
    raise SystemExit(main())
