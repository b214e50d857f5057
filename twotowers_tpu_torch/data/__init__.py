"""Data stage: triplet files -> encoded id arrays -> fixed-shape batches."""

from .batching import Batch, iterate_batches, num_batches, place_on_device, prefetch_to_device
from .triplets import PAIRS_SCHEMA, TRIPLET_SCHEMAS, TripletDataset, pairs_to_triplets

__all__ = [
    "Batch",
    "PAIRS_SCHEMA",
    "TRIPLET_SCHEMAS",
    "TripletDataset",
    "iterate_batches",
    "num_batches",
    "pairs_to_triplets",
    "place_on_device",
    "prefetch_to_device",
]
