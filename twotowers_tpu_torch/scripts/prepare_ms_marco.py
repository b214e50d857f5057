"""Data prep only: an MS MARCO split -> triplets parquet (no training).

The counterpart of the repo's root ``prepare_ms_marco.py``: the split
(``--input_parquet``, a raw split saved before, offline; else loaded
through the factory, which downloads it with ``datasets``) goes through a
preset's selectors into a triplets parquet with its genealogy JSON. Needs
pandas.

Usage:
    python -m twotowers_tpu_torch.scripts.prepare_ms_marco --split train \
        --preset presets/classic.yml --output data/processed/classic_triplets.parquet \
        [--input_parquet raw.parquet]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import yaml

from ..utils import setup_logging


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Prepare MS MARCO triplets")
    parser.add_argument("--split", default="train")
    parser.add_argument("--preset", default="presets/classic.yml")
    parser.add_argument("--output", default="data/processed/classic_triplets.parquet")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--input_parquet", default=None,
                        help="Pre-downloaded raw split parquet (offline mode)")
    args = parser.parse_args(argv)

    setup_logging(log_level="INFO")

    import pandas as pd

    from ..data.factory.build_dataset import build_triplets, write_genealogy
    from ..data.factory.readers import load_split, setup_data_dirs

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


if __name__ == "__main__":
    raise SystemExit(main())
