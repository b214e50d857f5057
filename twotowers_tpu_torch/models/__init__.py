"""Model stages: embeddings, pooled and sequence towers, training losses."""

from .embeddings import Embedding, EmbeddingSpec
from .losses import LOSS_REGISTRY, LossDef, build_loss
from .seq_towers import SEQUENCE_ARCHS, is_sequence_arch
from .towers import TOWER_REGISTRY, TowerSpec, TwoTower, TwoTowerSpec, spec_from_config

__all__ = [
    "Embedding",
    "EmbeddingSpec",
    "LOSS_REGISTRY",
    "LossDef",
    "SEQUENCE_ARCHS",
    "TOWER_REGISTRY",
    "TowerSpec",
    "TwoTower",
    "TwoTowerSpec",
    "build_loss",
    "is_sequence_arch",
    "spec_from_config",
]
