"""Model stages: embeddings, pooled towers and training losses."""

from .embeddings import Embedding, EmbeddingSpec
from .losses import LOSS_REGISTRY, LossDef, build_loss
from .towers import TowerSpec, TwoTower, TwoTowerSpec, spec_from_config

__all__ = [
    "Embedding",
    "EmbeddingSpec",
    "LOSS_REGISTRY",
    "LossDef",
    "TowerSpec",
    "TwoTower",
    "TwoTowerSpec",
    "build_loss",
    "spec_from_config",
]
