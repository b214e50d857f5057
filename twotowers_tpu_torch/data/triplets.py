"""Triplet dataset: TSV/parquet loading, pairs->triplets, eager encoding.

The counterpart of ``twotowers_tpu/data/triplets.py``: column-name aliasing
(``query``/``q_text``, ``positive_doc``/``d_pos_text``,
``negative_doc``/``d_neg_text``), pairs-format conversion via a per-query
cartesian product of positives x negatives, tokenizer fitting when unfit,
and eager encoding of the whole split into three static ``(N, L)`` int32
arrays for :func:`~twotowers_tpu_torch.data.batching.iterate_batches`.

One change: a TSV is read with the ``csv`` module (tab-separated, ``"``
quoting, blank lines skipped, the first row a header unless it names no
known schema, as pandas reads it), so the card's machine needs no pandas.
A parquet file still needs pandas and imports it at read time.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..tokenizers import BaseTokenizer
from ..utils.logging import get_logger

logger = get_logger("data.triplets")

# accepted column aliases, in priority order
TRIPLET_SCHEMAS = [
    ("q_text", "d_pos_text", "d_neg_text"),
    ("query", "positive_doc", "negative_doc"),
]
PAIRS_SCHEMA = ("query", "document", "label")

Table = Dict[str, List]


def pairs_to_triplets(
    queries: Sequence[str],
    documents: Sequence[str],
    labels: Sequence[int],
) -> Tuple[List[str], List[str], List[str]]:
    """Convert (query, document, label) pairs to cartesian triplets.

    For each query, every positive (label==1) is crossed with every
    negative (label==0); queries lacking either side are dropped.
    """
    by_query: dict = {}
    order: List[str] = []
    for q, d, lbl in zip(queries, documents, labels):
        if q not in by_query:
            by_query[q] = ([], [])
            order.append(q)
        by_query[q][0 if int(lbl) == 1 else 1].append(d)

    out_q: List[str] = []
    out_p: List[str] = []
    out_n: List[str] = []
    for q in order:
        positives, negatives = by_query[q]
        for pos in positives:
            for neg in negatives:
                out_q.append(q)
                out_p.append(pos)
                out_n.append(neg)
    return out_q, out_p, out_n


def _known_schema(columns) -> bool:
    cols = set(columns)
    return any(set(s) <= cols for s in TRIPLET_SCHEMAS) or set(PAIRS_SCHEMA) <= cols


def _read_tsv(path: Path) -> Table:
    with open(path, newline="", encoding="utf-8") as f:
        rows = [row for row in csv.reader(f, delimiter="\t") if row]
    if not rows:
        raise ValueError(f"empty table: {path}")
    header, body = rows[0], rows[1:]
    if not _known_schema(header):
        # headerless pairs TSV (the synthetic generator's raw format)
        header, body = list(PAIRS_SCHEMA), rows
    width = len(header)
    for i, row in enumerate(body):
        if len(row) != width:
            raise ValueError(f"{path}: row {i + 1} has {len(row)} fields, expected {width}")
    return {name: [row[j] for row in body] for j, name in enumerate(header)}


def read_parquet(path: Path) -> Table:
    """A parquet file as ``{column: list}``; pandas is imported here, and its
    absence raises ImportError."""
    try:
        import pandas as pd
    except ImportError as exc:
        raise ImportError(
            f"reading {path} needs pandas (with pyarrow), which is not installed; "
            "convert the file to TSV (query, positive_doc, negative_doc) instead"
        ) from exc
    df = pd.read_parquet(path)
    return {str(name): df[name].tolist() for name in df.columns}


def _read_table(data_path: str) -> Table:
    path = Path(data_path)
    suffix = path.suffix.lower()
    if suffix == ".parquet":
        return read_parquet(path)
    if suffix in (".tsv", ".txt"):
        return _read_tsv(path)
    raise ValueError(f"Unsupported file format: {suffix!r} ({data_path})")


class TripletDataset:
    """(query, positive, negative) text triplets encoded to static arrays."""

    def __init__(
        self,
        data_path: str,
        tokenizer: BaseTokenizer,
        max_length: int = 64,
        *,
        encode: bool = True,
    ):
        self.data_path = str(data_path)
        self.tokenizer = tokenizer
        self.max_length = int(max_length)

        table = _read_table(self.data_path)
        self.query_texts, self.positive_texts, self.negative_texts = (
            self._extract_triplets(table)
        )

        if not tokenizer.is_fitted:
            all_texts = (list(self.query_texts) + list(self.positive_texts)
                         + list(self.negative_texts))
            tokenizer.fit(all_texts)
            logger.info("Fitted tokenizer on %d texts (vocab=%d)",
                        len(all_texts), tokenizer.vocab_size)

        self._arrays: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None
        if encode:
            self._arrays = self._encode_all()

    @staticmethod
    def _extract_triplets(table: Table) -> Tuple[List[str], List[str], List[str]]:
        cols = set(table)
        for q_col, p_col, n_col in TRIPLET_SCHEMAS:
            if {q_col, p_col, n_col} <= cols:
                return ([str(v) for v in table[q_col]], [str(v) for v in table[p_col]],
                        [str(v) for v in table[n_col]])
        if set(PAIRS_SCHEMA) <= cols:
            return pairs_to_triplets(
                [str(v) for v in table["query"]],
                [str(v) for v in table["document"]],
                [int(float(v)) for v in table["label"]],
            )
        raise ValueError(
            f"Unsupported table format: columns {sorted(cols)}; expected "
            f"one of {TRIPLET_SCHEMAS} or {PAIRS_SCHEMA}"
        )

    def _encode_all(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        enc = lambda texts: self.tokenizer.encode_batch(texts, self.max_length)  # noqa: E731
        return (enc(self.query_texts), enc(self.positive_texts),
                enc(self.negative_texts))

    def arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Three static ``(N, max_length)`` int32 arrays (q, d+, d-)."""
        if self._arrays is None:
            self._arrays = self._encode_all()
        return self._arrays

    def get_original_texts(self, index: int) -> Tuple[str, str, str]:
        return (self.query_texts[index], self.positive_texts[index],
                self.negative_texts[index])

    @property
    def vocab_size(self) -> int:
        return self.tokenizer.vocab_size

    def __len__(self) -> int:
        return len(self.query_texts)

    def __repr__(self) -> str:  # pragma: no cover
        return (f"TripletDataset({self.data_path!r}, n={len(self)}, "
                f"max_length={self.max_length})")
