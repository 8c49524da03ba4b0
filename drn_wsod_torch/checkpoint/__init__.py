from .from_jax import params_from_jax

__all__ = ["params_from_jax"]
