from . import boxes
from .batch import WSODBatch

__all__ = ["WSODBatch", "boxes"]
