from .from_jax import params_from_jax
from .torch_import import load_reference_weights

__all__ = ["load_reference_weights", "params_from_jax"]
