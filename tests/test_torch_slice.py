"""The whole PPO slice: the port's update_iter against the JAX package's.

A tiny configuration of the main path (16 worlds, T=8 in 2 BPTT chunks, MLP
2x32, LSTM 32, float32, one minibatch per epoch) is built in both packages.
The port gets the JAX run's parameters, start state and obs-normalizer
state, and its action sampler is replaced, in this test only, by one that
returns the JAX run's recorded actions (torch's generator cannot draw
jax.random's numbers). Two update_iter calls in each package must then give
equal rollout data, gradients, parameters and optimizer state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import madrona_learn_tpu as mlt
import madrona_learn_tpu_torch as tlt
import madrona_learn_tpu_torch.ops.dists as t_dists
from madrona_learn_tpu.envs import ToyEnvConfig as JaxToyEnvConfig
from madrona_learn_tpu.envs import make_toy_env as jax_make_toy_env
from madrona_learn_tpu.rollouts import RolloutManager as JaxRolloutManager
from madrona_learn_tpu.train import TrainHooks as JaxTrainHooks
from madrona_learn_tpu_torch.compat.from_jax import (
    actor_critic_state_dict,
    obs_preprocess_state,
    policy_slice,
)
from madrona_learn_tpu_torch.envs import ToyEnvConfig, make_toy_env
from madrona_learn_tpu_torch.rollouts import RolloutManager
from test_torch_models import _jax_actor_critic, _torch_actor_critic

torch.set_num_threads(1)

W, STEPS, CHUNKS, H, LR = 16, 8, 2, 32, 1e-3
SEED = 8


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
    return np.asarray(x)


def _jax_config():
    return mlt.TrainConfig(
        num_worlds=W, num_agents_per_world=1, num_updates=2,
        actions={"move": mlt.DiscreteActionsConfig(actions_num_buckets=[5])},
        steps_per_update=STEPS, num_bptt_chunks=CHUNKS, lr=LR, gamma=0.99,
        gae_lambda=0.95, seed=SEED, metrics_buffer_size=1,
        algo=mlt.PPOConfig(num_epochs=1, minibatch_size=W * CHUNKS,
                           clip_coef=0.2, value_loss_coef=0.5,
                           entropy_coef=0.01, max_grad_norm=0.5),
        dreamer_v3_critic=False, compute_advantages=True)


def _torch_config():
    return tlt.TrainConfig(
        num_worlds=W, num_agents_per_world=1,
        actions={"move": tlt.DiscreteActionsConfig(actions_num_buckets=[5])},
        steps_per_update=STEPS, num_bptt_chunks=CHUNKS, lr=LR, gamma=0.99,
        gae_lambda=0.95, seed=SEED, metrics_buffer_size=1,
        algo=tlt.PPOConfig(num_epochs=1, minibatch_size=W * CHUNKS,
                           clip_coef=0.2, value_loss_coef=0.5,
                           entropy_coef=0.01, max_grad_norm=0.5))


ENV = dict(num_worlds=W, episode_len=5, grid_size=5, seed=SEED)


@pytest.fixture(scope="module")
def jax_run():
    """Two JAX updates, with the rollout data each one trained on."""
    cfg = _jax_config()
    policy = mlt.Policy(
        actor_critic=_jax_actor_critic(jnp.float32, H),
        obs_preprocess=mlt.ObservationsEMANormalizer.create(
            decay=0.99999, dtype=jnp.float32))
    mgr = mlt.init_training(None, cfg, jax_make_toy_env(JaxToyEnvConfig(
        **ENV)), policy, init_sim_ctrl=jnp.zeros((1,), jnp.int32))
    hooks = JaxTrainHooks()
    rollout_mgr = JaxRolloutManager(
        train_cfg=cfg, init_rollout_state=mgr.rollout,
        example_policy_states=mgr.state.policy_states)

    @jax.jit
    def collect(state_mgr, rollout_state, metrics):
        return rollout_mgr.collect(
            state_mgr, rollout_state, metrics, hooks.start_rollouts,
            hooks.finish_rollouts, hooks.rollout_metrics)[2].all()

    update = jax.jit(lambda m: m.update_iter())
    mgrs, data = [mgr], []
    for _ in range(2):
        data.append(jax.device_get(collect(mgr.state, mgr.rollout,
                                           mgr.metrics)))
        mgr = update(mgr)
        mgrs.append(mgr)
    return mgrs, data


def _recorded_actions(data):
    """[P, B*C, T/C, 1] b-major training rows -> per-step [B, 1] actions."""
    a = np.asarray(data["actions"]["move"])
    P, BC, TC = a.shape[:3]
    a = a.reshape(P, BC // CHUNKS, CHUNKS, TC, 1).transpose(2, 3, 0, 1, 4)
    return [torch.from_numpy(a[c, t, 0].astype(np.int64))
            for c in range(CHUNKS) for t in range(TC)]


def _flat_state(tree):
    return {k: np.asarray(v) for k, v in actor_critic_state_dict(
        policy_slice(tree)).items()}


def _adam_state(jax_mgr):
    adam = [s for s in jax.tree.leaves(
        jax_mgr.state.train_states.opt_state,
        is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]
    return adam


@pytest.fixture(scope="module")
def torch_run(jax_run):
    jax_mgrs, jax_data = jax_run
    j0 = jax_mgrs[0]
    actor_critic = _torch_actor_critic(torch.float32, H)
    actor_critic.load_state_dict({
        k: torch.from_numpy(v)
        for k, v in _flat_state(j0.state.policy_states.params).items()})
    policy = tlt.Policy(actor_critic, tlt.ObservationsEMANormalizer.create(
        decay=0.99999, dtype=torch.float32))
    mgr = tlt.init_training("cpu", _torch_config(),
                            make_toy_env(ToyEnvConfig(**ENV)), policy,
                            torch.zeros((1,), dtype=torch.int32))
    # Inject the JAX start state.
    mgr.rollout.sim_state = {k: torch.from_numpy(np.array(v))
                             for k, v in j0.rollout.sim_state.items()}
    mgr.rollout.cur_obs = {k: torch.from_numpy(np.array(v))
                           for k, v in j0.rollout.cur_obs.items()}
    mgr.state.policy_states.obs_preprocess_state = {
        key: {name: torch.from_numpy(np.array(v)) for name, v in est.items()}
        for key, est in obs_preprocess_state(policy_slice(
            j0.state.policy_states.obs_preprocess_state)).items()}

    queue = [a for d in jax_data for a in _recorded_actions(d)]
    collected, snapshots = [], []
    mp = pytest.MonkeyPatch()
    mp.setattr(t_dists, "categorical", lambda logits, generator: queue.pop(0))
    orig_collect = RolloutManager.collect

    def recording_collect(self, *args, **kwargs):
        out = orig_collect(self, *args, **kwargs)
        collected.append(out[0].all())
        return out

    mp.setattr(RolloutManager, "collect", recording_collect)
    try:
        for _ in range(2):
            mgr.update_iter()
            ts = mgr.state.train_states
            snapshots.append({
                "params": {k: p.detach().clone() for k, p in
                           mgr.state.policy_states.actor_critic
                           .named_parameters()},
                "mu": {k: v.clone() for k, v in ts.opt_state.mu.items()},
                "nu": {k: v.clone() for k, v in ts.opt_state.nu.items()},
                "count": int(ts.opt_state.count),
                "obs_state": {k: {n: v.clone() for n, v in est.items()}
                              for k, est in mgr.state.policy_states
                              .obs_preprocess_state.items()},
                "metrics": {name: mgr.metrics.latest(name).mean.clone()
                            for name in mgr.metrics.metrics},
            })
    finally:
        mp.undo()
    assert not queue
    return collected, snapshots


def _leaves(tree, prefix=""):
    if hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}/")
    else:
        yield prefix.rstrip("/"), tree


@pytest.mark.parametrize("update", [0, 1])
def test_rollout_data_matches_jax(jax_run, torch_run, update):
    jax_data = jax_run[1][update]
    got = dict(_leaves(torch_run[0][update]))
    want = dict(_leaves(jax_data))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = _np(got[name])
        assert g.shape == np.shape(w), name
        if name in ("dones", "actions/move", "rewards"):
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
        else:
            # Same float32 math on the same inputs; products and reductions
            # sum in another order. The second update's inputs also carry
            # the first update's last-bit parameter differences.
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4,
                                       atol=1e-5, err_msg=name)


@pytest.mark.parametrize("update", [0, 1])
def test_gradients_and_optimizer_state_match_jax(jax_run, torch_run, update):
    snap = torch_run[1][update]
    adam = _adam_state(jax_run[0][update + 1])
    assert snap["count"] == int(np.asarray(adam.count)[0]) == update + 1
    mu = _flat_state(adam.mu)
    nu = _flat_state(adam.nu)
    for name in mu:
        if update == 0:
            # From zero moments, mu = (1 - b1) * clipped gradient.
            np.testing.assert_allclose(_np(snap["mu"][name]) / 0.1,
                                       mu[name] / 0.1, rtol=1e-4, atol=1e-6,
                                       err_msg=f"gradient {name}")
        np.testing.assert_allclose(_np(snap["mu"][name]), mu[name],
                                   rtol=1e-4, atol=1e-7, err_msg=name)
        np.testing.assert_allclose(_np(snap["nu"][name]), nu[name],
                                   rtol=1e-3, atol=1e-10, err_msg=name)


@pytest.mark.parametrize("update", [0, 1])
def test_parameters_match_jax(jax_run, torch_run, update):
    snap = torch_run[1][update]
    want = _flat_state(jax_run[0][update + 1].state.policy_states.params)
    assert sorted(snap["params"]) == sorted(want)
    for name, w in want.items():
        g = _np(snap["params"][name])
        # Adam's first steps are about lr * sign(g): where a gradient is
        # near 0 its sign may differ between the packages and the entry
        # moves by up to 2 * lr the other way. Everywhere else the
        # parameters agree to float32 rounding.
        np.testing.assert_allclose(g, w, rtol=0, atol=2 * LR + 1e-5,
                                   err_msg=name)
        close = np.isclose(g, w, rtol=1e-5, atol=1e-6)
        assert close.mean() > 0.99, (name, close.mean())


def test_obs_normalizer_and_metrics_match_jax(jax_run, torch_run):
    for update in (0, 1):
        snap = torch_run[1][update]
        j_mgr = jax_run[0][update + 1]
        j_obs = obs_preprocess_state(policy_slice(
            j_mgr.state.policy_states.obs_preprocess_state))
        for key, est in j_obs.items():
            for name, w in est.items():
                np.testing.assert_allclose(
                    _np(snap["obs_state"][key][name]), w, rtol=1e-5,
                    atol=1e-6, err_msg=f"{key}/{name}")
        for name in ("Loss", "Value Loss", "Entropy", "Rewards",
                     "Advantages", "Est Returns", "Values"):
            np.testing.assert_allclose(
                _np(snap["metrics"][name]),
                np.asarray(j_mgr.metrics.metrics[name].mean)[:, -1],
                rtol=1e-4, atol=1e-5, err_msg=name)


def test_rollout_log_probs_equal_update_log_probs(torch_run):
    """The port's counterpart of test_sequence_consistency.py:50: at the
    rollout's weights the update pass recomputes the recorded log-probs."""
    cfg = _torch_config()
    actor_critic = _torch_actor_critic(torch.float32, H)
    policy = tlt.Policy(actor_critic, tlt.ObservationsEMANormalizer.create(
        decay=0.99999, dtype=torch.float32))
    mgr = tlt.init_training("cpu", cfg, make_toy_env(ToyEnvConfig(**ENV)),
                            policy, torch.zeros((1,), dtype=torch.int32))
    hooks = tlt.TrainHooks()
    data, _ = mgr.rollout_mgr.collect(
        mgr.state, mgr.rollout, mgr.metrics, hooks.start_rollouts,
        hooks.finish_rollouts, hooks.rollout_metrics)
    data = data.policy(0)
    num_seqs = data.all()["dones"].shape[0]
    mb = data.minibatch(torch.arange(num_seqs))
    with torch.no_grad():
        out = actor_critic.update(mb["rnn_start_states"], mb["dones"],
                                  mb["actions"], mb["obs"])
    np.testing.assert_allclose(_np(out["log_probs"]["move"]),
                               _np(mb["log_probs"]["move"]), rtol=1e-4,
                               atol=1e-5)
