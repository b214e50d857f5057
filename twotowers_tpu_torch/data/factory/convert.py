"""Pairs <-> triplets format conversion utilities.

A copy of ``twotowers_tpu/data/factory/convert.py``: pairs -> triplets is
the per-query cartesian product; triplets -> pairs de-duplicates (query,
document, label) rows.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import pandas as pd

from ..triplets import PAIRS_SCHEMA, TRIPLET_SCHEMAS, pairs_to_triplets
from ...utils.logging import get_logger
from .readers import PROCESSED_DATA_DIR, RAW_DATA_DIR

logger = get_logger("data.factory.convert")


def _triplet_columns(df: pd.DataFrame):
    cols = set(df.columns)
    for schema in TRIPLET_SCHEMAS:
        if set(schema) <= cols:
            return schema
    return None


def convert_dataset_format(df: pd.DataFrame, target_format: str) -> pd.DataFrame:
    """Convert between ``pairs`` and ``triplets`` dataframe formats."""
    if target_format == "triplets":
        schema = _triplet_columns(df)
        if schema is not None:
            return df  # already triplets
        if not set(PAIRS_SCHEMA) <= set(df.columns):
            raise ValueError(f"Cannot convert columns {list(df.columns)} to triplets")
        q, p, n = pairs_to_triplets(
            df["query"].astype(str).tolist(),
            df["document"].astype(str).tolist(),
            df["label"].tolist(),
        )
        return pd.DataFrame({"query": q, "positive_doc": p, "negative_doc": n})
    if target_format == "pairs":
        if set(PAIRS_SCHEMA) <= set(df.columns):
            return df
        return convert_triplets_to_pairs(df)
    raise ValueError(f"unknown target format: {target_format!r}")


def convert_triplets_to_pairs(df: pd.DataFrame) -> pd.DataFrame:
    """Flatten triplets to labelled pairs, de-duplicating repeated docs."""
    schema = _triplet_columns(df)
    if schema is None:
        raise ValueError(f"Not a triplets frame: columns {list(df.columns)}")
    q_col, p_col, n_col = schema
    rows = []
    seen = set()
    for _, row in df.iterrows():
        for doc, label in ((row[p_col], 1), (row[n_col], 0)):
            key = (row[q_col], doc, label)
            if key in seen:
                continue
            seen.add(key)
            rows.append({"query": row[q_col], "document": doc, "label": label})
    return pd.DataFrame(rows, columns=["query", "document", "label"])


def transform_and_save_dataset(
    input_path,
    output_path,
    target_format: str,
    *,
    input_in_raw: bool = True,
    output_in_processed: bool = True,
) -> Path:
    """Read TSV/parquet, convert format, write parquet/TSV; returns the path."""
    input_path = Path(input_path)
    output_path = Path(output_path)
    if input_in_raw and not input_path.is_absolute():
        input_path = RAW_DATA_DIR / input_path
    if output_in_processed and not output_path.is_absolute():
        output_path = PROCESSED_DATA_DIR / output_path

    suffix = input_path.suffix.lower()
    if suffix == ".parquet":
        df = pd.read_parquet(input_path)
    elif suffix in (".tsv", ".txt"):
        df = pd.read_csv(input_path, sep="\t")
        if not (set(PAIRS_SCHEMA) <= set(df.columns)
                or _triplet_columns(df) is not None):
            df = pd.read_csv(input_path, sep="\t", header=None,
                             names=list(PAIRS_SCHEMA))
    else:
        raise ValueError(f"Unsupported input format: {suffix!r}")

    out = convert_dataset_format(df, target_format)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    if output_path.suffix.lower() == ".tsv":
        out.to_csv(output_path, sep="\t", index=False)
    else:
        out.to_parquet(output_path)
    logger.info("Transformed %s -> %s (%d rows, %s)", input_path, output_path,
                len(out), target_format)
    return output_path
