"""Preset -> triplets, with genealogy sidecars, plus a CLI.

A copy of ``twotowers_tpu/data/factory/build_dataset.py``: the selector and
sampler wiring, up to ``MAX_TRIALS`` draws a negative, ``q_text,
d_pos_text, d_neg_text`` output columns, and the ``<file>.genealogy.json``
provenance sidecar written next to every triplets parquet.

Usage:
    python -m twotowers_tpu_torch.data.factory.build_dataset \\
        --preset presets/classic.yml --output data/processed/classic.parquet \\
        [--input_parquet raw.parquet]
"""

from __future__ import annotations

import argparse
import datetime
import json
from pathlib import Path
from typing import Any, Dict, List, Optional

import pandas as pd

from ...utils.logging import get_logger, setup_logging
from .selectors import (
    build_inter_query_pool,
    classic_positives,
    intra_query_zero_filtered,
    random_inter_query,
)

logger = get_logger("data.factory.build")

SELECTORS = {"classic": classic_positives}

MAX_TRIALS = 5  # draws per negative slot before it is dropped


def _make_sampler(preset: Dict[str, Any], df: pd.DataFrame, seed: int):
    kind = (preset.get("negative_sampler") or {}).get("type", "random_inter")
    if kind == "random_inter":
        return random_inter_query(build_inter_query_pool(df), seed=seed)
    if kind == "intra_query_zero":
        return intra_query_zero_filtered(seed=seed)
    raise ValueError(f"unknown negative_sampler: {kind!r}")


def build_triplets(df: pd.DataFrame, preset: Dict[str, Any], *,
                   seed: int = 0) -> pd.DataFrame:
    """Apply a sampling preset to a raw MS MARCO-shaped frame.

    Returns a frame with columns ``q_text, d_pos_text, d_neg_text`` —
    ``negatives_per_pos`` rows per positive; positives whose sampler is
    exhausted (intra-query with no valid candidates) are dropped.
    """
    selector_name = preset.get("positive_selector", "classic")
    if selector_name not in SELECTORS:
        raise ValueError(f"unknown positive_selector: {selector_name!r}")
    sampler = _make_sampler(preset, df, seed)
    negatives_per_pos = int(preset.get("negatives_per_pos", 1))

    rows: List[tuple] = []
    for pos in SELECTORS[selector_name](df):
        query, d_pos = str(pos["query"]), str(pos["positive"])
        for _ in range(negatives_per_pos):
            d_neg = None
            for _trial in range(MAX_TRIALS):
                d_neg = sampler(pos)
                if d_neg is not None and d_neg != d_pos:
                    break
            if d_neg is None:
                continue  # exhausted sampler -> drop this negative slot
            rows.append((query, d_pos, str(d_neg)))

    out = pd.DataFrame(rows, columns=["q_text", "d_pos_text", "d_neg_text"])
    logger.info("Built %d triplets from %d raw rows (preset sampler=%s)",
                len(out), len(df),
                (preset.get("negative_sampler") or {}).get("type"))
    return out


def write_genealogy(
    triplets_path,
    *,
    preset: Dict[str, Any],
    preset_path: Optional[str] = None,
    split: Optional[str] = None,
    input_rows: int = 0,
    output_rows: int = 0,
    seed: int = 0,
) -> Path:
    """Write a ``<file>.genealogy.json`` provenance sidecar.

    Captures the full preprocessing lineage (rows in/out, preset, seed,
    timestamps, file size).
    """
    triplets_path = Path(triplets_path)
    sidecar = triplets_path.with_suffix(triplets_path.suffix + ".genealogy.json")
    now = datetime.datetime.now().isoformat(timespec="seconds")
    record = {
        "created": now,
        "framework": "twotowers_tpu_torch",
        "seed": seed,
        "split": split,
        "preset_path": preset_path,
        "preset": preset,
        "pipeline": [
            {"step": "load_split", "split": split, "rows": int(input_rows),
             "timestamp": now},
            {"step": "build_triplets", "rows": int(output_rows),
             "file": str(triplets_path),
             "bytes": triplets_path.stat().st_size if triplets_path.exists() else None,
             "timestamp": now},
        ],
    }
    sidecar.write_text(json.dumps(record, indent=2, default=str))
    return sidecar


def main(argv: Optional[List[str]] = None) -> int:
    """CLI: ``python -m twotowers_tpu_torch.data.factory.build_dataset``."""
    import yaml

    parser = argparse.ArgumentParser(description="Preset -> triplets parquet")
    parser.add_argument("--preset", required=True)
    parser.add_argument("--split", default="train")
    parser.add_argument("--output", required=True)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--input_parquet", default=None,
                        help="Pre-downloaded raw parquet (offline mode)")
    args = parser.parse_args(argv)

    setup_logging(log_level="INFO")
    from .readers import load_split, setup_data_dirs

    setup_data_dirs()
    if args.input_parquet:
        df = pd.read_parquet(args.input_parquet)
    else:
        df = load_split(args.split)
    preset = yaml.safe_load(Path(args.preset).read_text())
    triplets = build_triplets(df, preset, seed=args.seed)

    output = Path(args.output)
    output.parent.mkdir(parents=True, exist_ok=True)
    triplets.to_parquet(output)
    write_genealogy(output, preset=preset, preset_path=args.preset,
                    split=args.split, input_rows=len(df),
                    output_rows=len(triplets), seed=args.seed)
    print(f"Wrote {len(triplets):,} triplets to {output}")
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
