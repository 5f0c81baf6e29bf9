"""Utilities of the port (JAX: madrona_learn_tpu/utils): the tree and
symlog helpers (``math``), the profiling ranges (``profile``) and the
TensorBoard and W&B writers (``tensorboard``, ``wandb``)."""

from .math import symexp, symlog, tree_map, tree_stack
from .profile import profile

__all__ = ["profile", "symexp", "symlog", "tree_map", "tree_stack"]
