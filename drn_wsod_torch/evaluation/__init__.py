from .evaluator import make_detect_fn

__all__ = ["make_detect_fn"]
