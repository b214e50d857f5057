"""Dataset factory: MS MARCO readers, samplers, converters, synthetics.

The counterpart of ``twotowers_tpu/data/factory``, with the same public
names. It uses pandas, which the card's machine lacks, so nothing outside
this package imports it: neither ``twotowers_tpu_torch`` nor its ``data``
package loads the factory. It runs on the host only.
"""

from .build_dataset import build_triplets, write_genealogy
from .convert import (
    convert_dataset_format,
    convert_triplets_to_pairs,
    transform_and_save_dataset,
)
from .readers import (
    DATA_DIR,
    PROCESSED_DATA_DIR,
    RAW_DATA_DIR,
    RAW_PARQUET_DIR,
    convert_tsv_to_parquet,
    get_ms_marco_dataset,
    load_split,
    load_synthetic_tsv,
    save_dataset_as_parquet,
    setup_data_dirs,
)
from .selectors import (
    answer_in_text,
    build_inter_query_pool,
    classic_positives,
    high_ngram_overlap,
    intra_query_zero_filtered,
    ngram_set,
    random_inter_query,
)
from .synthetic import (
    expand_synthetic_dataset,
    generate_synthetic_pairs,
    write_pairs_tsv,
    write_triplets_parquet,
)

__all__ = [
    "DATA_DIR",
    "PROCESSED_DATA_DIR",
    "RAW_DATA_DIR",
    "RAW_PARQUET_DIR",
    "answer_in_text",
    "build_inter_query_pool",
    "build_triplets",
    "classic_positives",
    "convert_dataset_format",
    "convert_triplets_to_pairs",
    "convert_tsv_to_parquet",
    "expand_synthetic_dataset",
    "generate_synthetic_pairs",
    "get_ms_marco_dataset",
    "high_ngram_overlap",
    "intra_query_zero_filtered",
    "load_split",
    "load_synthetic_tsv",
    "ngram_set",
    "random_inter_query",
    "save_dataset_as_parquet",
    "setup_data_dirs",
    "transform_and_save_dataset",
    "write_genealogy",
    "write_pairs_tsv",
    "write_triplets_parquet",
]
