"""Evaluation CLI: score a checkpoint with IR metrics on test tuples.

The counterpart of ``twotowers_tpu/evaluation/cli.py``. Test data is a
JSON list of ``[query, [documents...], [relevance...]]`` tuples, or a
triplets parquet from which held-out tuples are made (that route needs
pandas, imported when it is taken). The model runs on ``--device``, the
card unless the caller asks for the CPU.

Usage:
    python -m twotowers_tpu_torch.evaluation.cli --checkpoint checkpoints/best_model \\
        --test_data eval_tuples.json [--device cpu]
    python -m twotowers_tpu_torch.evaluation.cli --checkpoint checkpoints/best_model \\
        --triplets data/processed/x.parquet --num_queries 100
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from ..train.checkpoint import load_trained_model
from ..utils.logging import setup_logging
from .evaluate import evaluate_model, print_evaluation_results


def tuples_from_triplets(parquet_path: str, num_queries: int = 100,
                         num_docs: int = 20, seed: int = 0):
    """Make (query, docs, relevance) tuples from triplet rows."""
    import pandas as pd

    df = pd.read_parquet(parquet_path)
    q_col = "q_text" if "q_text" in df.columns else "query"
    p_col = "d_pos_text" if "d_pos_text" in df.columns else "positive_doc"
    n_col = "d_neg_text" if "d_neg_text" in df.columns else "negative_doc"
    rng = np.random.default_rng(seed)
    negatives = df[n_col].tolist()
    tuples = []
    for query, group in list(df.groupby(q_col))[:num_queries]:
        positives = group[p_col].unique().tolist()[:2]
        sampled = [negatives[i] for i in
                   rng.integers(0, len(negatives), num_docs - len(positives))]
        docs = positives + sampled
        relevance = [1] * len(positives) + [0] * len(sampled)
        order = rng.permutation(len(docs))
        tuples.append((query, [docs[i] for i in order],
                       [relevance[i] for i in order]))
    return tuples


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Evaluate a two-tower checkpoint")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--test_data", help="JSON list of [query, docs, relevance]")
    parser.add_argument("--triplets", help="Triplets parquet to make tuples from")
    parser.add_argument("--num_queries", type=int, default=100)
    parser.add_argument("--k", nargs="+", type=int, default=[1, 5, 10])
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--max_length", type=int, default=None)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--output", help="Write metric JSON here")
    parser.add_argument(
        "--ndcg_reference_compat", action="store_true",
        help="Reproduce the original project's NDCG call shape (affine in P@1) "
             "instead of the rank-ordered metric; parity bookkeeping only")
    args = parser.parse_args(argv)
    if not args.test_data and not args.triplets:
        parser.error("Provide --test_data or --triplets")

    setup_logging(log_level="WARNING")
    model, spec, tokenizer, config = load_trained_model(args.checkpoint, args.device)
    max_length = args.max_length
    if max_length is None:
        tok_cfg = config.get("tokeniser", config.get("tokenizer", {})) or {}
        max_length = int(tok_cfg.get("max_len", config.get("max_sequence_length", 64)))

    if args.test_data:
        test_data = [tuple(t) for t in json.loads(Path(args.test_data).read_text())]
    else:
        test_data = tuples_from_triplets(args.triplets, args.num_queries)

    results = evaluate_model(
        model, spec, test_data, tokenizer,
        k_values=args.k, batch_size=args.batch_size, max_length=max_length,
        ndcg_reference_compat=args.ndcg_reference_compat,
    )
    print_evaluation_results(results)
    if args.output:
        Path(args.output).write_text(json.dumps(results, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
