"""Dense retrieval index: trained two-tower engine, its row-sharded form and
the mean-vector baseline."""

from .base import BaseSearch
from .glove import GloVeSearch, MeanVectorSearch
from .sharded import ShardedDocIndex, ShardedTwoTowerSearch
from .two_tower import TwoTowerSearch

__all__ = ["BaseSearch", "GloVeSearch", "MeanVectorSearch", "ShardedDocIndex",
           "ShardedTwoTowerSearch", "TwoTowerSearch"]
