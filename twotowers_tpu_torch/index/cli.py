"""Retrieval CLI: build an index from a checkpoint, then search it.

The counterpart of ``twotowers_tpu/index/cli.py``: ``build-index`` and
``search`` over ``train.checkpoint.load_trained_model`` (the checkpoint's
sidecar carries the config and the tokenizer, so the model is rebuilt in
full), ranked results with their latency. The model and the index live on
``--device``, the card unless the caller asks for the CPU, and every search
goes through ``ops.topk_score.score_topk``. A ``.parquet`` document file
needs pandas, imported when it is read.

Usage:
    python -m twotowers_tpu_torch.index.cli build-index \\
        --checkpoint checkpoints/best_model --documents docs.txt --index idx/ [--device cpu]
    python -m twotowers_tpu_torch.index.cli search \\
        --checkpoint checkpoints/best_model --index idx/ --query "..." --top_k 5
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import List, Optional

from ..data.triplets import read_parquet
from ..train.checkpoint import load_trained_model
from ..utils.logging import get_logger, setup_logging
from .two_tower import TwoTowerSearch

logger = get_logger("index.cli")


def _load_documents(path: str) -> List[str]:
    """One document per line (txt) or a parquet with a text column."""
    if path.endswith(".parquet"):
        table = read_parquet(Path(path))
        for col in ("document", "text", "d_pos_text", "passage_text"):
            if col in table:
                return [str(v) for v in table[col]]
        raise ValueError(f"No text column found in {path}: {list(table)}")
    return [line.strip() for line in Path(path).read_text().splitlines() if line.strip()]


def _build_search(checkpoint: str, max_length: Optional[int], device: str) -> TwoTowerSearch:
    model, spec, tokenizer, config = load_trained_model(checkpoint, device)
    if max_length is None:
        tok_cfg = config.get("tokeniser", config.get("tokenizer", {})) or {}
        max_length = int(tok_cfg.get("max_len", config.get("max_sequence_length", 64)))
    return TwoTowerSearch(model, spec, tokenizer, max_length=max_length, device=device)


def build_index_command(args) -> int:
    search = _build_search(args.checkpoint, args.max_length, args.device)
    documents = _load_documents(args.documents)
    start = time.time()
    search.index_documents(documents)
    elapsed = time.time() - start
    search.save_index(args.index)
    print(f"Indexed {len(documents)} documents in {elapsed:.2f}s "
          f"({len(documents)/max(elapsed,1e-9):.0f} docs/s) -> {args.index}")
    return 0


def search_command(args) -> int:
    search = _build_search(args.checkpoint, args.max_length, args.device)
    search.load_index(args.index)
    start = time.time()
    results = search.search(args.query, top_k=args.top_k)
    latency = time.time() - start
    print(f'Query: "{args.query}"  ({latency*1000:.1f} ms, '
          f"{search.num_documents} docs)")
    for rank, (doc, score) in enumerate(results, 1):
        snippet = doc if len(doc) <= 100 else doc[:97] + "..."
        print(f"{rank:2d}. [{score:.4f}] {snippet}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Two-tower dense retrieval CLI")
    sub = parser.add_subparsers(dest="command", required=True)

    build = sub.add_parser("build-index", help="Encode documents into an index")
    build.add_argument("--checkpoint", required=True)
    build.add_argument("--documents", required=True,
                       help="txt (one doc/line) or parquet with a text column")
    build.add_argument("--index", required=True, help="Output index directory")
    build.add_argument("--max_length", type=int, default=None)
    build.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    build.set_defaults(fn=build_index_command)

    search = sub.add_parser("search", help="Search a built index")
    search.add_argument("--checkpoint", required=True)
    search.add_argument("--index", required=True)
    search.add_argument("--query", required=True)
    search.add_argument("--top_k", type=int, default=5)
    search.add_argument("--max_length", type=int, default=None)
    search.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    search.set_defaults(fn=search_command)

    args = parser.parse_args(argv)
    setup_logging(log_level="WARNING")
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
