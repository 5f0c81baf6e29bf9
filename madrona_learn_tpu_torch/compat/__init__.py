"""Conversions from the JAX package's and upstream madrona-learn's state,
numpy only (``from_jax``, ``reference_import``)."""

from .reference_import import convert_reference_params

__all__ = ["convert_reference_params"]
