"""Dense retrieval index over a trained two-tower model."""

from .base import BaseSearch
from .two_tower import TwoTowerSearch

__all__ = ["BaseSearch", "TwoTowerSearch"]
