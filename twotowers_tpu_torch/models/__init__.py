"""Model stages: embeddings and pooled towers."""

from .embeddings import Embedding, EmbeddingSpec
from .towers import TowerSpec, TwoTower, TwoTowerSpec, spec_from_config

__all__ = [
    "Embedding",
    "EmbeddingSpec",
    "TowerSpec",
    "TwoTower",
    "TwoTowerSpec",
    "spec_from_config",
]
