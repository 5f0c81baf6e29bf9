"""The port's toy gridworld against the JAX package's.

The JAX start state is injected into the port (torch's generator cannot
draw jax.random's numbers); from there the same actions must give equal
obs, rewards, dones and state at every step, through episode ends whose
respawn draws come from the uint32 hash.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_learn_tpu.envs import ToyEnvConfig as JaxToyEnvConfig
from madrona_learn_tpu.envs import make_toy_env as jax_make_toy_env
from madrona_learn_tpu_torch.envs import ToyEnvConfig, make_toy_env

torch.set_num_threads(1)


def _to_torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _step_input(state, actions, resets):
    return {"state": state, "actions": {"move": actions}, "resets": resets,
            "sim_ctrl": None, "pbt": {}}


@pytest.mark.parametrize("seed", [0, 5])
def test_toy_env_matches_jax_from_injected_state(seed):
    W = 48
    j_fns = jax_make_toy_env(JaxToyEnvConfig(
        num_worlds=W, episode_len=7, grid_size=6, seed=seed))
    t_fns = make_toy_env(ToyEnvConfig(num_worlds=W, episode_len=7,
                                      grid_size=6, seed=seed))
    j_init = j_fns["init"]()
    j_state = j_init["state"]
    t_state = _to_torch(j_state)
    rng = np.random.default_rng(seed)
    for step in range(30):
        actions = rng.integers(0, 5, size=(W, 1)).astype(np.int32)
        resets = (rng.random((W, 1)) < 0.05).astype(np.int32)
        j_out = j_fns["step"](_step_input(
            j_state, jnp.asarray(actions), jnp.asarray(resets)))
        t_out = t_fns["step"](_step_input(
            t_state, torch.from_numpy(actions), torch.from_numpy(resets)))
        for key in ("pos", "target", "t", "tick"):
            np.testing.assert_array_equal(
                t_out["state"][key].numpy(), np.asarray(j_out["state"][key]),
                err_msg=f"step {step} state {key}")
        for key in ("delta", "time"):
            np.testing.assert_array_equal(
                t_out["obs"][key].numpy(), np.asarray(j_out["obs"][key]),
                err_msg=f"step {step} obs {key}")
        np.testing.assert_array_equal(t_out["rewards"].numpy(),
                                      np.asarray(j_out["rewards"]))
        np.testing.assert_array_equal(t_out["dones"].numpy(),
                                      np.asarray(j_out["dones"]))
        assert t_out["rewards"].dtype == torch.float32
        assert t_out["dones"].dtype == torch.bool
        j_state, t_state = j_out["state"], t_out["state"]


def test_toy_env_init_is_seeded_and_in_range():
    cfg = ToyEnvConfig(num_worlds=64, grid_size=8, seed=3)
    a = make_toy_env(cfg)["init"]()
    b = make_toy_env(cfg)["init"]()
    for key in ("pos", "target"):
        torch.testing.assert_close(a["state"][key], b["state"][key])
        assert a["state"][key].dtype == torch.int32
        assert a["state"][key].min() >= 0 and a["state"][key].max() < 8
    assert a["obs"]["delta"].shape == (64, 2)
    assert a["obs"]["time"].shape == (64, 1)
    torch.testing.assert_close(a["state"]["rid"][:, 0],
                               torch.arange(64, dtype=torch.int32))


def test_rollouts_reset_restarts_every_world():
    """rollouts_reset steps the sim with every reset raised and clears the
    returns and the recurrent state."""
    from types import SimpleNamespace

    from madrona_learn_tpu_torch.config import DiscreteActionsConfig
    from madrona_learn_tpu_torch.rollouts import (
        RolloutConfig, RolloutState, rollouts_reset)
    from test_torch_models import _torch_actor_critic

    cfg = RolloutConfig.setup(
        num_worlds=8, agents_per_world=1,
        actions_cfg={"move": DiscreteActionsConfig(actions_num_buckets=[5])})
    actor_critic = _torch_actor_critic(torch.float32, 32)
    state = RolloutState.create(
        cfg, make_toy_env(ToyEnvConfig(num_worlds=8, episode_len=5)),
        torch.Generator(), tuple(torch.ones(8, 1, 32) for _ in range(2)),
        torch.zeros((1,), dtype=torch.int32))
    state.sim_state["t"].fill_(3)
    state.env_returns.fill_(2.0)
    state = rollouts_reset(state, SimpleNamespace(actor_critic=actor_critic))
    assert (state.sim_state["t"] == 0).all()
    assert (state.cur_obs["time"] == 0).all()
    assert (state.env_returns == 0).all()
    for s in state.rnn_states:
        assert (s == 0).all()
