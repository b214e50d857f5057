"""Synthetic pipeline: generate pairs -> triplets parquet -> train.

The counterpart of the repo's root ``generate_and_train.py``: the data
factory's generator (and expansion) writes the pairs TSV and the triplets
parquet, then ``train_model`` trains on it on ``--device``, the card unless
the caller asks for the CPU. The factory and the parquet need pandas.

Usage:
    python -m twotowers_tpu_torch.scripts.generate_and_train --num_pairs 200 --epochs 2 \\
        [--device cpu]
"""

from __future__ import annotations

import argparse

from ..utils import load_config, resolve_device, setup_logging


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Generate synthetic data and train")
    parser.add_argument("--num_pairs", type=int, default=200)
    parser.add_argument("--negatives_per_query", type=int, default=1)
    parser.add_argument("--expand", type=int, default=0,
                        help="Additionally expand by N pairs after generation")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--config", default="configs/char_tower.yml")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--output", default="data/processed/synthetic_triplets.parquet")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    resolve_device(args.device)  # no card and no --device cpu: raise before any work

    setup_logging(log_level="INFO")

    from ..data.factory.synthetic import (
        expand_synthetic_dataset,
        generate_synthetic_pairs,
        write_pairs_tsv,
        write_triplets_parquet,
    )
    from ..train import train_model

    df = generate_synthetic_pairs(args.num_pairs, args.negatives_per_query,
                                  seed=args.seed)
    if args.expand:
        df = expand_synthetic_dataset(df, args.expand, seed=args.seed + 1)
    write_pairs_tsv(df)
    data_path = write_triplets_parquet(df, args.output)

    config = load_config(args.config)
    config["data"] = str(data_path)
    config["use_wandb"] = config.get("use_wandb", False)
    if args.epochs is not None:
        config["epochs"] = args.epochs
    if args.batch_size is not None:
        config["batch_size"] = args.batch_size

    state, pipeline = train_model(config, device=args.device)
    print(f"Trained on {len(pipeline.dataset)} synthetic triplets "
          f"({int(state.step)} steps)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
