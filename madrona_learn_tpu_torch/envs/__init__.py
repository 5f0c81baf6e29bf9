"""Simulators for the port (JAX: madrona_learn_tpu/envs)."""

from .fake_sim import FakeSimConfig, make_fake_sim
from .native_sim import NativeSimConfig, make_native_sim
from .sim_interface import SimInterface, as_sim_fns
from .toy_env import ToyEnvConfig, make_duel_env, make_toy_env

__all__ = ["FakeSimConfig", "NativeSimConfig", "SimInterface", "ToyEnvConfig",
           "as_sim_fns", "make_duel_env", "make_fake_sim", "make_native_sim",
           "make_toy_env"]
