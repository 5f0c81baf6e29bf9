"""Simulators for the port (JAX: madrona_learn_tpu/envs)."""

from .sim_interface import SimInterface, as_sim_fns
from .toy_env import ToyEnvConfig, make_toy_env

__all__ = ["SimInterface", "ToyEnvConfig", "as_sim_fns", "make_toy_env"]
