from .build import build_model
from .meta_arch import GeneralizedRCNNWSL

__all__ = ["GeneralizedRCNNWSL", "build_model"]
