"""Dataset acquisition and on-disk layout: MS MARCO download + parquet cache.

A copy of ``twotowers_tpu/data/factory/readers.py``: the same
``data/{raw,processed}`` layout, relocated by ``TWOTOWERS_DATA_DIR``,
per-split parquet export, synthetic TSV loading and TSV -> parquet
conversion. ``datasets`` (which downloads) is imported only inside
``get_ms_marco_dataset``.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Iterable, Optional

import pandas as pd

from ...utils.logging import get_logger

logger = get_logger("data.factory.readers")

DATA_DIR = Path(os.environ.get("TWOTOWERS_DATA_DIR", "data"))
RAW_DATA_DIR = DATA_DIR / "raw"
PROCESSED_DATA_DIR = DATA_DIR / "processed"
RAW_PARQUET_DIR = RAW_DATA_DIR / "parquet"

MS_MARCO_NAME = "ms_marco"
MS_MARCO_CONFIG = "v1.1"
DEFAULT_SPLITS = ("train", "validation", "test")


def setup_data_dirs() -> None:
    for directory in (DATA_DIR, RAW_DATA_DIR, PROCESSED_DATA_DIR,
                      RAW_PARQUET_DIR):
        directory.mkdir(parents=True, exist_ok=True)


def _split_parquet_path(split: str) -> Path:
    return RAW_PARQUET_DIR / f"{MS_MARCO_NAME}_{MS_MARCO_CONFIG}_{split}.parquet"


def get_ms_marco_dataset(splits: Iterable[str] = DEFAULT_SPLITS):
    """Download MS MARCO v1.1 via HF ``datasets`` and cache each split.

    Returns the loaded DatasetDict; also writes per-split parquet into
    ``data/raw/parquet`` so later runs are offline (readers.py:18-54).
    """
    import datasets  # deferred: network-capable dependency

    setup_data_dirs()
    logger.info("Downloading %s/%s ...", MS_MARCO_NAME, MS_MARCO_CONFIG)
    dataset = datasets.load_dataset(MS_MARCO_NAME, MS_MARCO_CONFIG)
    for split in splits:
        if split in dataset:
            save_dataset_as_parquet(dataset[split], split)
    return dataset


def save_dataset_as_parquet(split_dataset, split: str,
                            path: Optional[Path] = None) -> Path:
    """Persist one split (an HF Dataset or DataFrame) as parquet."""
    setup_data_dirs()
    path = Path(path) if path else _split_parquet_path(split)
    df = (split_dataset if isinstance(split_dataset, pd.DataFrame)
          else split_dataset.to_pandas())
    df.to_parquet(path)
    logger.info("Saved %s split (%d rows) -> %s", split, len(df), path)
    return path


def load_split(split: str = "train") -> pd.DataFrame:
    """Load a raw MS MARCO split, preferring the local parquet cache."""
    cached = _split_parquet_path(split)
    if cached.exists():
        logger.info("Loading cached split %s", cached)
        return pd.read_parquet(cached)
    get_ms_marco_dataset(splits=(split,))
    return pd.read_parquet(cached)


def load_synthetic_tsv(path: Optional[Path] = None) -> pd.DataFrame:
    """Load a (possibly headerless) synthetic pairs TSV."""
    path = Path(path) if path else RAW_DATA_DIR / "pairs.tsv"
    df = pd.read_csv(path, sep="\t")
    if not {"query", "document", "label"} <= set(df.columns):
        df = pd.read_csv(path, sep="\t", header=None,
                         names=["query", "document", "label"])
    return df


def load_synthetic_dataset(path: Optional[Path] = None) -> pd.DataFrame:
    """Alias of ``load_synthetic_tsv``."""
    return load_synthetic_tsv(path)


def convert_tsv_to_parquet(tsv_path, parquet_path=None) -> Path:
    tsv_path = Path(tsv_path)
    parquet_path = (Path(parquet_path) if parquet_path
                    else tsv_path.with_suffix(".parquet"))
    df = load_synthetic_tsv(tsv_path)
    parquet_path.parent.mkdir(parents=True, exist_ok=True)
    df.to_parquet(parquet_path)
    logger.info("Converted %s -> %s (%d rows)", tsv_path, parquet_path, len(df))
    return parquet_path
