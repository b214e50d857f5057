"""CLI for the synthetic corpus: generate / expand / convert.

A copy of ``twotowers_tpu/data/factory/synthetic_dataset_gen.py``.

Example (the README quick start):
    python -m twotowers_tpu_torch.data.factory.synthetic_dataset_gen \\
        --generate --num_pairs 200 --convert \\
        --output data/processed/synthetic_triplets_small.parquet
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import List, Optional

from ...utils.logging import setup_logging
from .readers import convert_tsv_to_parquet, load_synthetic_tsv, setup_data_dirs
from .synthetic import (
    expand_synthetic_dataset,
    generate_synthetic_pairs,
    write_pairs_tsv,
    write_triplets_parquet,
)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="Synthetic dataset generator")
    parser.add_argument("--generate", action="store_true",
                        help="Generate a fresh pairs dataset")
    parser.add_argument("--expand", type=int, default=0, metavar="N",
                        help="Add N expansion pairs (variants + new)")
    parser.add_argument("--convert", action="store_true",
                        help="Also write a triplets training parquet")
    parser.add_argument("--convert_parquet", action="store_true",
                        help="Convert the pairs TSV to a raw parquet")
    parser.add_argument("--num_pairs", type=int, default=200)
    parser.add_argument("--negatives_per_query", type=int, default=1)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--pairs_tsv", default=None,
                        help="Pairs TSV path (default data/raw/pairs.tsv)")
    parser.add_argument("--output",
                        default="data/processed/synthetic_triplets_small.parquet")
    args = parser.parse_args(argv)

    setup_logging(log_level="INFO")
    setup_data_dirs()

    if args.generate:
        df = generate_synthetic_pairs(args.num_pairs, args.negatives_per_query,
                                      seed=args.seed)
    elif args.pairs_tsv or args.expand or args.convert or args.convert_parquet:
        df = load_synthetic_tsv(args.pairs_tsv)
    else:
        parser.error("nothing to do: pass --generate, --expand, --convert, "
                     "or --convert_parquet")

    if args.expand:
        df = expand_synthetic_dataset(df, args.expand, seed=args.seed + 1)

    tsv_path = write_pairs_tsv(df, args.pairs_tsv)
    print(f"Pairs TSV: {tsv_path} ({len(df)} rows)")

    if args.convert_parquet:
        parquet = convert_tsv_to_parquet(tsv_path)
        print(f"Raw parquet: {parquet}")

    if args.convert:
        out = write_triplets_parquet(df, Path(args.output))
        print(f"Triplets parquet: {out}")
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
