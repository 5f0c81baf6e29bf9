"""BackboneSeparate (an actor and a critic tower over one prefix) against
the JAX package's, on the CPU.

- One rollout step, ``actor_only`` and ``critic_only`` (each advances only
  its own tower's slot of the state, the other slot bitwise unchanged) and
  the update pass with its gradients, against flax at float32 (the model
  tests' tolerances, ``test_torch_models.py``): MLP 2 x 32 -> LSTM 32 in
  each tower over the toy gridworld's obs.
- Two ``update_iter``s of that trainer against JAX's, with the slice test's
  checks (rollout data, gradients and Adam state, parameters within
  2 lr + 1e-5 and 99% within 1e-5, normalizer and metrics).
- A two-policy population with separate towers: at a rollout step every
  row's recurrent state is its own policy's (within 1e-6, the other
  policy's farther away).
- Checkpoints of the separate-tower and the window-memory trainers: a
  resume from update 2 takes the third update bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

import madrona_learn_tpu as mlt
import madrona_learn_tpu.models as jm
import madrona_learn_tpu_torch as tlt
import madrona_learn_tpu_torch.models as tm
import test_torch_slice as slice_test
from madrona_learn_tpu_torch.compat.from_jax import actor_critic_state_dict
from madrona_learn_tpu_torch.config import DiscreteActionsConfig
from madrona_learn_tpu_torch.envs import ToyEnvConfig, make_duel_env
from madrona_learn_tpu_torch.rollouts import rollout_loop
from test_torch_checkpoint import (assert_trees_bitwise, copy_rollout,
                                   single_trainer, state_of)
from test_torch_models import F32, _load, _np, _obs, _perturb

# Two update_iters of the separate-tower trainer, with the slice test's
# checks run against this module's fixtures.
from test_torch_slice import (  # noqa: F401
    test_gradients_and_optimizer_state_match_jax,
    test_obs_normalizer_and_metrics_match_jax,
    test_parameters_match_jax,
    test_rollout_data_matches_jax,
)

torch.set_num_threads(1)

H = slice_test.H


def _jax_separate(hidden=H):
    def tower():
        return jm.RecurrentBackboneEncoder(
            net=jm.MLP(num_channels=hidden, num_layers=2, dtype=jnp.float32),
            rnn=jm.LSTM(num_hidden_channels=hidden, num_layers=1,
                        dtype=jnp.float32, use_pallas=True))

    actions = mlt.DiscreteActionsConfig(actions_num_buckets=[5])
    return jm.ActorCritic(
        backbone=jm.BackboneSeparate(
            prefix=lambda obs, train: jnp.concatenate(
                [obs["delta"], obs["time"]], axis=-1),
            actor_encoder=tower(), critic_encoder=tower()),
        actor=jm.DictActor(heads={"move": jm.DenseLayerDiscreteActor(
            cfg=actions, dtype=jnp.float32)}),
        critic=jm.DenseLayerCritic(dtype=jnp.float32))


def _tower(in_features, hidden, rnn=None):
    return tm.RecurrentBackboneEncoder(
        net=tm.MLP(in_features, hidden, 2, torch.float32),
        rnn=rnn if rnn is not None else tm.LSTM(hidden, hidden, 1,
                                                torch.float32))


def torch_separate(prefix=lambda obs: torch.cat([obs["delta"], obs["time"]],
                                                -1),
                   in_features=3, hidden=H):
    return tm.ActorCritic(
        backbone=tm.BackboneSeparate(
            prefix=prefix, actor_encoder=_tower(in_features, hidden),
            critic_encoder=_tower(in_features, hidden)),
        actor=tm.DictActor({"move": tm.DenseLayerDiscreteActor(
            DiscreteActionsConfig(actions_num_buckets=[5]), hidden,
            torch.float32)}),
        critic=tm.DenseLayerCritic(hidden, torch.float32))


def _pair(seed):
    rng = np.random.default_rng(seed)
    ac_j = _jax_separate()
    N = 12
    obs = {k: jnp.asarray(v) for k, v in _obs(rng, N).items()}
    params = _perturb(ac_j.init(random.PRNGKey(seed), random.PRNGKey(0),
                                ac_j.init_recurrent_state(N), obs,
                                method="rollout")["params"], rng)
    return ac_j, params, _load(torch_separate(), params), rng


def _states(rng, N):
    """Random (actor (c, h), critic (c, h)) states, as numpy."""
    return tuple(tuple(rng.normal(size=(N, 1, H)).astype(np.float32)
                       for _ in range(2)) for _ in range(2))


def _tree(fn, tree):
    if isinstance(tree, tuple):
        return tuple(_tree(fn, t) for t in tree)
    return fn(tree)


def _assert_trees_close(got, want, **tol):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_trees_close(g, w, **tol)
    else:
        np.testing.assert_allclose(_np(got), np.asarray(want), **tol)


def test_separate_parameter_tree_converts_strictly():
    _, params, ac_t, _ = _pair(1)
    towers = {name.split(".")[1] for name, _ in ac_t.named_parameters()
              if name.startswith("backbone.")}
    assert towers == {"actor_encoder", "critic_encoder"}
    assert sorted(params["backbone"]) == ["actor_encoder", "critic_encoder"]


def test_separate_step_matches_jax():
    ac_j, params, ac_t, rng = _pair(2)
    N = 12
    obs = _obs(rng, N)
    states = _states(rng, N)
    j_obs = {k: jnp.asarray(v) for k, v in obs.items()}
    t_obs = {k: torch.from_numpy(v) for k, v in obs.items()}
    out_j, rnn_j = ac_j.apply({"params": params}, random.PRNGKey(0),
                              _tree(jnp.asarray, states), j_obs,
                              sample_actions=False, method="rollout")
    with torch.no_grad():
        out_t, rnn_t = ac_t.rollout(None, _tree(torch.from_numpy, states),
                                    t_obs, sample_actions=False)
    np.testing.assert_array_equal(_np(out_t["actions"]["move"]),
                                  np.asarray(out_j["actions"]["move"]))
    np.testing.assert_allclose(_np(out_t["critic"]),
                               np.asarray(out_j["critic"]), **F32)
    _assert_trees_close(rnn_t, rnn_j, **F32)


@pytest.mark.parametrize("method", ["actor_only", "critic_only"])
def test_one_tower_advances_only_its_slot(method):
    ac_j, params, ac_t, rng = _pair(3)
    N = 12
    obs = _obs(rng, N)
    states = _states(rng, N)
    out_j, rnn_j = ac_j.apply(
        {"params": params}, _tree(jnp.asarray, states),
        {k: jnp.asarray(v) for k, v in obs.items()}, method=method)
    t_states = _tree(torch.from_numpy, states)
    with torch.no_grad():
        out_t, rnn_t = getattr(ac_t, method)(
            t_states, {k: torch.from_numpy(v) for k, v in obs.items()})
    if method == "actor_only":
        np.testing.assert_array_equal(_np(out_t["actions"]["move"]),
                                      np.asarray(out_j["actions"]["move"]))
    else:
        np.testing.assert_allclose(_np(out_t["critic"]),
                                   np.asarray(out_j["critic"]), **F32)
    _assert_trees_close(rnn_t, rnn_j, **F32)
    slot = 0 if method == "actor_only" else 1
    # The other tower's slot is passed through: the same tensors.
    assert rnn_t[1 - slot] is t_states[1 - slot]
    for got, want in zip(rnn_t[1 - slot], states[1 - slot]):
        np.testing.assert_array_equal(_np(got), want)
    assert not np.array_equal(_np(rnn_t[slot][1]), states[slot][1])


def test_separate_update_and_gradients_match_jax():
    ac_j, params, ac_t, rng = _pair(4)
    T, N = 5, 12
    obs = _obs(rng, T, N)
    dones = rng.random((T, N, 1)) < 0.2
    actions = rng.integers(0, 5, size=(T, N, 1)).astype(np.int32)
    states = _states(rng, N)
    probe = rng.normal(size=(T, N, 1)).astype(np.float32)

    def loss_j(p):
        out = ac_j.apply({"params": p}, _tree(jnp.asarray, states),
                         jnp.asarray(dones), {"move": jnp.asarray(actions)},
                         {k: jnp.asarray(v) for k, v in obs.items()},
                         method="update")
        return (jnp.sum(out["log_probs"]["move"] * probe)
                + jnp.sum(out["entropies"]["move"])
                + jnp.sum(out["critic"] ** 2)), out

    (lj, out_j), g_j = jax.value_and_grad(loss_j, has_aux=True)(params)
    out_t = ac_t.update(_tree(torch.from_numpy, states),
                        torch.from_numpy(dones),
                        {"move": torch.from_numpy(actions)},
                        {k: torch.from_numpy(v) for k, v in obs.items()})
    for key in ("log_probs", "entropies"):
        np.testing.assert_allclose(_np(out_t[key]["move"]),
                                   np.asarray(out_j[key]["move"]), **F32)
    np.testing.assert_allclose(_np(out_t["critic"]),
                               np.asarray(out_j["critic"]), **F32)
    lt = ((out_t["log_probs"]["move"] * torch.from_numpy(probe)).sum()
          + out_t["entropies"]["move"].sum() + (out_t["critic"] ** 2).sum())
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    names, tensors = zip(*ac_t.named_parameters())
    g_t = dict(zip(names, torch.autograd.grad(lt, tensors)))
    g_want = actor_critic_state_dict(g_j)
    assert sorted(g_t) == sorted(g_want)
    for name, want in g_want.items():
        np.testing.assert_allclose(_np(g_t[name]), want, rtol=1e-4,
                                   atol=1e-5, err_msg=name)


@pytest.fixture(scope="module")
def jax_run():
    return slice_test.run_jax(_jax_separate())


@pytest.fixture(scope="module")
def torch_run(jax_run):
    return slice_test.run_torch(jax_run, torch_separate())


# -- a population with separate towers --------------------------------------

DUEL_WORLDS = 16


def _duel_model(p=0):
    return torch_separate(lambda obs: torch.cat([obs["time"], obs["acc"]],
                                                -1), 2)


def test_population_rows_take_their_own_policys_state():
    cfg = tlt.TrainConfig(
        num_worlds=DUEL_WORLDS, num_agents_per_world=2,
        actions={"move": DiscreteActionsConfig(actions_num_buckets=[5])},
        steps_per_update=8, num_bptt_chunks=2, lr=1e-3, gamma=0.99,
        gae_lambda=0.95, seed=4, metrics_buffer_size=1,
        algo=tlt.PPOConfig(num_epochs=1, minibatch_size=8, clip_coef=0.2,
                           value_loss_coef=0.5, entropy_coef=0.01,
                           max_grad_norm=0.5),
        pbt=tlt.PBTConfig(num_teams=2, team_size=1, num_train_policies=2,
                          num_past_policies=0, self_play_portion=0.5,
                          cross_play_portion=0.5, past_play_portion=0.0),
        dreamer_v3_critic=False)
    torch.manual_seed(4)
    policy = tlt.Policy(_duel_model,
                        tlt.ObservationsCaster.create(torch.float32),
                        lambda er: (0.5, 0.5))
    env = make_duel_env(ToyEnvConfig(num_worlds=DUEL_WORLDS, episode_len=6,
                                     num_teams=2, team_size=1, seed=4),
                        device="cpu")
    mgr = tlt.init_training("cpu", cfg, env, policy,
                            torch.zeros((1,), dtype=torch.int32))
    population = mgr.state.policy_states
    # Advance a few steps so that the states are not all zeros.
    state, _, _ = rollout_loop(mgr.rollout, population, 3,
                               lambda *a: (a[-1], None),
                               lambda *a: (a[1], a[-1], None), None)
    before = _tree(lambda t: t.clone(), state.rnn_states)
    obs = {k: v.clone() for k, v in state.cur_obs.items()}
    assignments = state.policy_assignments.clone()
    assert sorted(assignments.unique().tolist()) == [0, 1]
    dones = []
    state, _, _ = rollout_loop(
        state, population, 1, lambda *a: (a[-1], None),
        lambda step, rs, d, *rest: (rs, dones.append(d), None), None)
    with torch.no_grad():
        each = [population[p].actor_critic.rollout(
            None, before, population[p].obs_preprocess.preprocess(
                population[p].obs_preprocess_state, obs),
            sample_actions=False)[1] for p in range(2)]
    keep = ~dones[0]

    def leaves(tree):
        if isinstance(tree, tuple):
            return [x for t in tree for x in leaves(t)]
        return [tree]

    for got, *per_policy in zip(leaves(state.rnn_states),
                                *map(leaves, each)):
        for p in range(2):
            rows = (assignments == p) & keep[:, 0]
            own = per_policy[p][rows]
            other = per_policy[1 - p][rows]
            np.testing.assert_allclose(_np(got[rows]), _np(own), rtol=0,
                                       atol=1e-6)
            assert (got[rows] - other).abs().max() > 1e-3
        assert (got[~keep[:, 0]] == 0).all()


# -- checkpoints of the new configurations ----------------------------------

def window_model():
    from test_torch_window_memory import torch_window_actor_critic
    return torch_window_actor_critic(torch.float32)


def _trainer(model):
    def make(seed=5, restore_ckpt=None):
        mp = pytest.MonkeyPatch()
        mp.setattr("test_torch_checkpoint._toy_model", model)
        try:
            return single_trainer(seed=seed, restore_ckpt=restore_ckpt)
        finally:
            mp.undo()
    return make


@pytest.mark.parametrize("model", ["separate", "window"])
def test_checkpoint_resume_is_bitwise(model, tmp_path):
    make = _trainer({"separate": torch_separate,
                     "window": window_model}[model])
    mgr = make()
    for _ in range(2):
        mgr.update_iter()
    mgr.save_ckpt(str(tmp_path))
    saved = state_of(mgr)
    rollout = copy_rollout(mgr.rollout)
    mgr.update_iter()
    after = state_of(mgr)

    fresh = make(seed=11, restore_ckpt=tlt.latest_checkpoint(str(tmp_path)))
    assert fresh.update_idx == 2
    assert_trees_bitwise(state_of(fresh), saved)
    fresh.rollout = copy_rollout(rollout)
    fresh.update_iter()
    assert_trees_bitwise(state_of(fresh), after)
