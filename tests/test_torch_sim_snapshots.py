"""Simulator-state snapshots of the port against the JAX package.

The toy gridworld's ``get_ckpts`` on the same state (JAX's start state,
converted) must equal JAX's bitwise (int32 rows ``[pos, target, t]``);
``load_ckpts`` of the same snapshot must give JAX's state and obs bitwise,
the row ids restarted at ``arange(n)`` and the tick at 0 as JAX does, and a
step from there the same state bitwise (its respawns hash the restarted
tick). ``RolloutState.get_current_checkpoints`` /
``load_checkpoints_into_sim`` round-trip a rollout's simulator in place,
for a functional sim and for a stateful one, whose hooks take no state and
return only the obs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import madrona_learn_tpu.envs.toy_env as jenv
import madrona_learn_tpu_torch as mlt
import madrona_learn_tpu_torch.envs.toy_env as tenv
from madrona_learn_tpu_torch.rollouts import RolloutConfig, RolloutState

WORLDS, EPISODE, GRID = 24, 6, 5


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _envs(seed=3):
    jcfg = jenv.ToyEnvConfig(num_worlds=WORLDS, episode_len=EPISODE,
                             grid_size=GRID, seed=seed)
    tcfg = tenv.ToyEnvConfig(num_worlds=WORLDS, episode_len=EPISODE,
                             grid_size=GRID, seed=seed)
    return jenv.make_toy_env(jcfg), tenv.make_toy_env(tcfg, device="cpu")


def _step(env, state, actions, lib):
    zeros = (jnp.zeros if lib == "jax" else torch.zeros)
    resets = zeros((WORLDS, 1), dtype=(jnp.int32 if lib == "jax"
                                       else torch.int32))
    return env["step"]({"state": state, "actions": {"move": actions},
                        "resets": resets, "sim_ctrl": None,
                        "pbt": {"policy_assignments": None}})


def _advance_jax(jax_env, steps, rng):
    state = jax_env["init"]()["state"]
    for _ in range(steps):
        actions = jnp.asarray(rng.integers(0, 5, (WORLDS, 1)), jnp.int32)
        state = _step(jax_env, state, actions, "jax")["state"]
    return state


def test_get_ckpts_matches_jax_bitwise():
    jax_env, port_env = _envs()
    state = _advance_jax(jax_env, 9, np.random.default_rng(0))
    want = np.asarray(jax_env["get_ckpts"](state))
    got = port_env["get_ckpts"](_torch(_np(state)))
    assert got.dtype == torch.int32 and want.dtype == np.int32
    assert got.shape == (WORLDS, 5)
    np.testing.assert_array_equal(got.numpy(), want)


def test_load_ckpts_matches_jax_bitwise():
    jax_env, port_env = _envs()
    rng = np.random.default_rng(1)
    ckpts = np.concatenate([rng.integers(0, GRID, (WORLDS, 4)),
                            rng.integers(0, EPISODE, (WORLDS, 1))],
                           axis=1).astype(np.int32)
    trigger = np.ones((WORLDS, 1), np.int32)
    want = jax_env["load_ckpts"](jnp.asarray(trigger), jnp.asarray(ckpts))
    got = port_env["load_ckpts"](torch.from_numpy(trigger),
                                 torch.from_numpy(ckpts))
    for part in ("state", "obs"):
        assert sorted(got[part]) == sorted(want[part])
        for k, v in _np(want[part]).items():
            assert got[part][k].numpy().dtype == v.dtype, (part, k)
            np.testing.assert_array_equal(got[part][k].numpy(), v,
                                          err_msg=f"{part}/{k}")
    np.testing.assert_array_equal(got["state"]["rid"].numpy()[:, 0],
                                  np.arange(WORLDS))
    assert not got["state"]["tick"].any()

    # A step from the restored state: movement, rewards and the respawns
    # drawn from the restarted (row id, tick) hash all agree.
    actions = rng.integers(0, 5, (WORLDS, 1)).astype(np.int32)
    want = _step(jax_env, want["state"], jnp.asarray(actions), "jax")
    got = _step(port_env, got["state"], torch.from_numpy(actions), "torch")
    assert bool(np.asarray(want["dones"]).any())
    for k, v in _np(want["state"]).items():
        np.testing.assert_array_equal(got["state"][k].numpy(), v,
                                      err_msg=k)
    np.testing.assert_array_equal(got["rewards"].numpy(),
                                  np.asarray(want["rewards"]))


def _rollout_state(sim_fns):
    actions = {"move": mlt.DiscreteActionsConfig(actions_num_buckets=[5])}
    return RolloutState.create(
        rollout_cfg=RolloutConfig.setup(WORLDS, 1, actions),
        sim_fns=mlt.envs.sim_interface.as_sim_fns(sim_fns),
        generator=torch.Generator().manual_seed(0), rnn_states=(),
        init_sim_ctrl=torch.zeros((1,), dtype=torch.int32))


def test_rollout_state_round_trip_functional_sim():
    _, port_env = _envs()
    state = _rollout_state(mlt.envs.sim_interface.SimInterface(**port_env))
    gen = torch.Generator().manual_seed(5)
    for _ in range(4):
        out = _step(port_env, state.sim_state,
                    torch.randint(0, 5, (WORLDS, 1), generator=gen,
                                  dtype=torch.int32), "torch")
        state.sim_state, state.cur_obs = out["state"], out["obs"]
    saved_state = {k: v.clone() for k, v in state.sim_state.items()}
    saved_obs = {k: v.clone() for k, v in state.cur_obs.items()}
    ckpts = state.get_current_checkpoints()

    out = _step(port_env, state.sim_state,
                torch.full((WORLDS, 1), 1, dtype=torch.int32), "torch")
    state.sim_state, state.cur_obs = out["state"], out["obs"]
    assert state.load_checkpoints_into_sim(ckpts) is state
    for k in ("pos", "target", "t"):
        assert torch.equal(state.sim_state[k], saved_state[k]), k
    for k, v in saved_obs.items():
        assert torch.equal(state.cur_obs[k], v), k
    assert torch.equal(state.sim_state["rid"], saved_state["rid"])
    assert not state.sim_state["tick"].any()
    with pytest.raises(ValueError, match="sim_batch"):
        state.load_checkpoints_into_sim(ckpts[0])


def test_rollout_state_round_trip_stateful_sim():
    """An engine that keeps its own state: ``get_ckpts()`` takes nothing
    and ``load_ckpts`` returns only the obs."""
    engine = {"pos": torch.arange(WORLDS, dtype=torch.int32)[:, None]}
    calls = []

    def obs():
        return {"pos": engine["pos"].to(torch.float32)}

    def load(trigger, ckpts):
        calls.append(trigger)
        engine["pos"] = ckpts.clone()
        return obs()

    state = _rollout_state({
        "init": lambda: {"state": None, "obs": obs()},
        "step": None,
        "get_ckpts": lambda: engine["pos"].clone(),
        "load_ckpts": load,
    })
    ckpts = state.get_current_checkpoints()
    engine["pos"] = engine["pos"] + 7
    state.load_checkpoints_into_sim(ckpts)
    assert state.sim_state is None
    assert torch.equal(state.cur_obs["pos"],
                       torch.arange(WORLDS, dtype=torch.float32)[:, None])
    (trigger,) = calls
    assert trigger.dtype == torch.int32 and trigger.shape == (WORLDS, 1)
    assert bool((trigger == 1).all())
