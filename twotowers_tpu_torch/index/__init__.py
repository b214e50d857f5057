"""Dense retrieval index: trained two-tower engine and mean-vector baseline."""

from .base import BaseSearch
from .glove import GloVeSearch, MeanVectorSearch
from .two_tower import TwoTowerSearch

__all__ = ["BaseSearch", "GloVeSearch", "MeanVectorSearch", "TwoTowerSearch"]
