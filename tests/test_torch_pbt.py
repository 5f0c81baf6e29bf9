"""The port's PBT functions against the JAX package's.

- ``PBTMatchmakeConfig.setup``'s fields over a sweep of shapes (and the
  shapes both refuse); ``heuristic_policy_chunk_size``; the population
  ``RolloutConfig``'s chunk size and count; ``_compute_num_train_agents_
  per_policy`` and ``_compute_sim_to_train_indices``.
- ``pbt_init_matchmaking`` and ``pbt_update_matchmaking`` bitwise, with
  JAX's ``random.randint`` draws replayed through the port's module-level
  ``randint``.
- ``pbt_update_elo`` and ``pbt_update_fitness`` on the same inputs
  (within 1e-6), with the numpy oracles of ``tests/test_elo_semantics.py``
  beside them.
- ``explore_param`` and ``pbt_explore_hyperparams`` with JAX's uniforms
  replayed through the port's module-level ``uniform`` (the keys JAX
  splits, in its order: the coin, then the value).
- ``pbt_cull_update`` and ``pbt_past_update`` on the same fitness and
  draws: the same copies, bitwise-copied weights and optimizer moments,
  the same mutated ``lr``, the destination's own generator kept; under
  Elo and under episode-score (Welch) fitness.
- ``_build_all_pairs_assignments`` with ``pair_offset`` and the underfill
  warning.
"""

import warnings
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

import madrona_learn_tpu as mlt
import madrona_learn_tpu.pbt as j_pbt
import madrona_learn_tpu_torch as tlt
import madrona_learn_tpu_torch.pbt as t_pbt
from madrona_learn_tpu.rollouts import RolloutConfig as JaxRolloutConfig
from madrona_learn_tpu.rollouts import (
    _compute_num_train_agents_per_policy as jax_train_agents,
    _compute_sim_to_train_indices as jax_sim_to_train,
    heuristic_policy_chunk_size as jax_heuristic)
from madrona_learn_tpu.train import (
    _build_all_pairs_assignments as jax_all_pairs)
from madrona_learn_tpu.train_state import MMR as JaxMMR
from madrona_learn_tpu.train_state import MovingEpisodeScore as JaxScore
from madrona_learn_tpu.train_state import PolicyState as JaxPolicyState
from madrona_learn_tpu.train_state import (
    PolicyTrainState as JaxPolicyTrainState)
from madrona_learn_tpu.train_state import (
    TrainStateManager as JaxTrainStateManager)
from madrona_learn_tpu_torch.rollouts import (
    RolloutConfig,
    _compute_num_train_agents_per_policy,
    _compute_sim_to_train_indices,
)
from madrona_learn_tpu_torch.ops.reorder import heuristic_policy_chunk_size
from madrona_learn_tpu_torch.train import _build_all_pairs_assignments
from madrona_learn_tpu_torch.train_state import (
    MMR,
    MovingEpisodeScore,
    Population,
    PolicyState,
    TrainStateManager,
    _make_train_state,
)
from test_elo_semantics import _np_elo_oracle


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


# -- Geometry -----------------------------------------------------------------

# (train, past, teams, team size, batch, self, cross, past)
SHAPES = [
    (1, 0, 1, 1, 4, 1.0, 0.0, 0.0),
    (4, 0, 1, 1, 32, 1.0, 0.0, 0.0),
    (4, 0, 2, 2, 64, 1.0, 0.0, 0.0),
    (4, 0, 2, 1, 64, 0.5, 0.5, 0.0),
    (4, 2, 2, 1, 64, 0.5, 0.25, 0.25),
    (8, 7, 2, 2, 256, 0.25, 0.5, 0.25),
    (2, 1, 2, 2, 32, 0.0, 0.5, 0.5),
    (4, 2, 2, 1, 64, 0.25, 0.5, 0.25),
    (8, 4, 2, 1, 32768, 0.25, 0.5, 0.25),
    (16, 7, 2, 2, 16384, 0.25, 0.5, 0.25),
    (8, 7, 4, 4, 8192, 0.25, 0.25, 0.5),
    # Refused by both: a slice that is not whole matches, or matches that
    # do not divide among the train policies.
    (4, 2, 2, 1, 60, 0.5, 0.25, 0.25),
    (3, 1, 2, 1, 64, 0.5, 0.25, 0.25),
]


def _setup_args(shape):
    train, past, teams, size, batch, sp, cp, pp = shape
    return dict(num_current_policies=train, num_past_policies=past,
                num_teams=teams, team_size=size, sim_batch_size=batch,
                self_play_portion=sp, cross_play_portion=cp,
                past_play_portion=pp, static_play_portion=0.0)


def _jax_setup(shape):
    try:
        return JaxRolloutConfig.setup(actions_cfg={}, **_setup_args(shape))
    except AssertionError:
        return None


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_matchmake_and_rollout_config_match_jax(shape):
    want = _jax_setup(shape)
    if want is None:
        with pytest.raises(ValueError):
            RolloutConfig.setup_population(actions_cfg={},
                                           **_setup_args(shape))
        return
    got = RolloutConfig.setup_population(actions_cfg={},
                                         **_setup_args(shape))
    for name in t_pbt.PBTMatchmakeConfig.__dataclass_fields__:
        assert getattr(got.pbt, name) == getattr(want.pbt, name), name
    for name in ("num_worlds", "sim_batch_size"):
        assert getattr(got, name) == getattr(want, name), name
    assert (_compute_num_train_agents_per_policy(got)
            == jax_train_agents(want))
    np.testing.assert_array_equal(_compute_sim_to_train_indices(got).numpy(),
                                  np.asarray(jax_sim_to_train(want)))


def test_heuristic_policy_chunk_size_matches_jax():
    for batch in (16, 64, 1000, 4096, 32768):
        for policies in (1, 2, 5, 12, 40):
            for min_chunk in (1, 3, 64, 100, 2048):
                assert (heuristic_policy_chunk_size(batch, policies,
                                                    min_chunk)
                        == jax_heuristic(batch, policies, min_chunk))


# -- Matchmaking ------------------------------------------------------------

class _RandintRecorder:
    """``jax.random`` whose ``randint`` records (shape, low, high, draw)."""

    def __init__(self):
        self.draws = []

    def __getattr__(self, name):
        fn = getattr(random, name)
        if name != "randint":
            return fn

        def recording(key, shape, minval, maxval, *args, **kwargs):
            out = fn(key, shape, minval, maxval, *args, **kwargs)
            self.draws.append((tuple(shape), int(minval), int(maxval),
                               np.asarray(out)))
            return out

        return recording


def _replay_randint(mp, draws):
    queue = list(draws)

    def randint(generator, shape, low, high):
        want_shape, want_low, want_high, out = queue.pop(0)
        assert (tuple(shape), low, high) == (want_shape, want_low,
                                             want_high)
        return torch.from_numpy(out.astype(np.int32))

    mp.setattr(t_pbt, "randint", randint)
    return queue


@pytest.mark.parametrize("shape", [s for s in SHAPES if s[5] != 1.0
                                   and _jax_setup(s) is not None], ids=str)
def test_matchmaking_matches_jax(shape):
    want_cfg = _jax_setup(shape).pbt
    got_cfg = RolloutConfig.setup_population(actions_cfg={},
                                             **_setup_args(shape)).pbt
    recorder = _RandintRecorder()
    mp = pytest.MonkeyPatch()
    mp.setattr(j_pbt, "random", recorder)
    rng = np.random.default_rng(shape[4])
    try:
        j_assign = j_pbt.pbt_init_matchmaking(random.PRNGKey(4), want_cfg,
                                              None)
        key = random.PRNGKey(9)
        j_steps = []
        for _ in range(3):
            dones = rng.random((want_cfg.num_total_matches, 1)) < 0.4
            dones = np.repeat(dones, want_cfg.num_teams
                              * want_cfg.team_size, axis=0)
            prev = j_steps[-1][1] if j_steps else j_assign
            new, key = j_pbt.pbt_update_matchmaking(
                prev, None, jnp.asarray(dones), None, key, want_cfg)
            j_steps.append((dones, new))
    finally:
        mp.undo()
    assert recorder.draws

    mp = pytest.MonkeyPatch()
    queue = _replay_randint(mp, recorder.draws)
    try:
        gen = torch.Generator()
        t_assign = t_pbt.pbt_init_matchmaking(gen, got_cfg, None)
        assert t_assign.dtype == torch.int32
        np.testing.assert_array_equal(t_assign.numpy(), np.asarray(j_assign))
        for dones, want in j_steps:
            t_assign = t_pbt.pbt_update_matchmaking(
                t_assign, torch.from_numpy(dones), gen, got_cfg)
            np.testing.assert_array_equal(t_assign.numpy(),
                                          np.asarray(want))
    finally:
        mp.undo()
    assert not queue


# -- Fitness ------------------------------------------------------------------

def _elo_inputs():
    rng = np.random.default_rng(7)
    P, M, team_size, custom_id = 6, 48, 2, 100
    teams = rng.integers(0, P, size=(M, 2))
    teams[3, 1] = teams[3, 0]
    teams[7, 1] = custom_id
    assignments = np.repeat(teams, team_size, axis=1).reshape(-1)
    dones = np.repeat(rng.random(M) < 0.7, 2 * team_size).reshape(-1, 1)
    results = rng.standard_normal((M, 2)).astype(np.float32)
    elos = (1500 + 30 * rng.standard_normal(P)).astype(np.float32)
    setup = dict(num_current_policies=P, num_past_policies=0, num_teams=2,
                 team_size=team_size, sim_batch_size=M * 2 * team_size,
                 self_play_portion=0.0, cross_play_portion=1.0,
                 past_play_portion=0.0, static_play_portion=0.0,
                 custom_policy_ids=[custom_id])
    return P, team_size, custom_id, assignments, dones, results, elos, setup


def test_update_elo_matches_jax_and_oracle():
    P, team_size, custom_id, assignments, dones, results, elos, setup = \
        _elo_inputs()

    def get_scores(er):
        return er[0], er[1]

    want = j_pbt.pbt_update_elo(
        get_scores, jnp.asarray(assignments), jnp.asarray(dones),
        jnp.asarray(results), jnp.asarray(elos),
        j_pbt.PBTMatchmakeConfig.setup(**setup))
    got = t_pbt.pbt_update_elo(
        get_scores, torch.from_numpy(assignments.astype(np.int32)),
        torch.from_numpy(dones), torch.from_numpy(results),
        torch.from_numpy(elos), t_pbt.PBTMatchmakeConfig.setup(**setup))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6 * 1500)
    conv = np.where(assignments == custom_id, P, assignments)
    oracle = _np_elo_oracle(get_scores, conv, dones, results,
                            elos.astype(np.float64), 2, team_size)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=1e-5)


def test_update_fitness_matches_jax_and_oracle():
    rng = np.random.default_rng(11)
    P, M = 4, 64
    setup = dict(num_current_policies=P, num_past_policies=0, num_teams=1,
                 team_size=1, sim_batch_size=M, self_play_portion=1.0,
                 cross_play_portion=0.0, past_play_portion=0.0,
                 static_play_portion=0.0)
    assignments = rng.integers(0, P, size=M).astype(np.int32)
    assignments[assignments == 3] = 2  # policy 3 finishes no episode
    dones = rng.random(M) < 0.6
    scores = (rng.standard_normal(M) * 3 + 1).astype(np.float32)
    mean = rng.standard_normal(P).astype(np.float32)
    var = rng.random(P).astype(np.float32)
    N = np.array([0, 5, 100, 2], np.int32)

    j_states = JaxPolicyState(
        apply_fn=None, rnn_reset_fn=None, params={}, batch_stats={},
        obs_preprocess=None, obs_preprocess_state={},
        reward_hyper_params=None, get_episode_scores_fn=lambda er: er,
        episode_score=JaxScore(mean=jnp.asarray(mean), var=jnp.asarray(var),
                               N=jnp.asarray(N)), mmr=None)
    want = j_pbt.pbt_update_fitness(
        jnp.asarray(assignments), j_states, jnp.asarray(dones),
        jnp.asarray(scores), j_pbt.PBTMatchmakeConfig.setup(**setup)
    ).episode_score
    got = t_pbt.pbt_update_fitness(
        torch.from_numpy(assignments),
        MovingEpisodeScore(torch.from_numpy(mean), torch.from_numpy(var),
                           torch.from_numpy(N)),
        torch.from_numpy(dones), torch.from_numpy(scores), lambda er: er,
        t_pbt.PBTMatchmakeConfig.setup(**setup))
    for name in ("mean", "var"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), rtol=0,
                                   atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(got.N.numpy(), np.asarray(want.N))
    # The oracle: a decayed weighted Chan merge, in float64.
    decay = 0.9999
    for p in range(P):
        mask = (assignments == p) & dones
        n = int(mask.sum())
        if n == 0:
            assert (float(got.mean[p]), float(got.var[p]),
                    int(got.N[p])) == (mean[p], var[p], N[p])
            continue
        x = scores[mask].astype(np.float64)
        x_var = x.var(ddof=1) if n > 1 else 0.0
        cw = np.expm1(n * np.log(decay)) + 1.0
        xw = 1.0 - cw
        cross = (N[p] / (N[p] + n - 1) * cw * xw * (x.mean() - mean[p]) ** 2
                 if N[p] > 0 else 0.0)
        np.testing.assert_allclose(float(got.mean[p]),
                                   cw * mean[p] + xw * x.mean(), rtol=1e-5)
        np.testing.assert_allclose(float(got.var[p]),
                                   cw * var[p] + xw * x_var + cross,
                                   rtol=1e-4)
        assert int(got.N[p]) == N[p] + n


# -- Hyperparameter exploration ---------------------------------------------

class _UniformReplay:
    """The port's ``uniform`` as JAX's ``explore_param`` draws it: each
    explore pops a key and splits it (the coin's key, the value's key)."""

    def __init__(self, keys):
        self.keys = list(keys)
        self.pending = None

    def __call__(self, generator, low, high):
        if self.pending is None:
            coin, self.pending = random.split(self.keys.pop(0))
            assert (low, high) == (0.0, 1.0)
            key = coin
        else:
            key, self.pending = self.pending, None
        return torch.tensor(np.asarray(random.uniform(
            key, (), jnp.float32, minval=low, maxval=high)))


SPECS = {
    "log10": mlt.ParamExplore(1e-3, 0.1, 10.0, log10_scale=True),
    "ln": mlt.ParamExplore(0.01, 0.5, 4.0, ln_scale=True),
    "linear": mlt.ParamExplore(0.2, 0.5, 2.0),
    "clipped": mlt.ParamExplore(0.2, 0.9, 1.1, clip_perturb=True,
                                perturb_rnd_min=0.5, perturb_rnd_max=1.5),
}


@pytest.mark.parametrize("space", sorted(SPECS))
def test_explore_param_matches_jax(space):
    j_spec = SPECS[space]
    t_spec = tlt.ParamExplore(**vars(j_spec))
    for i, chance in enumerate((0.0, 0.2, 0.5, 1.0) * 3):
        key = random.PRNGKey(100 + i)
        want = j_pbt.explore_param(key, jnp.float32(0.3), j_spec, chance)
        mp = pytest.MonkeyPatch()
        replay = _UniformReplay([key])
        mp.setattr(t_pbt, "uniform", replay)
        try:
            got = t_pbt.explore_param(None, torch.tensor(0.3), t_spec,
                                      chance)
        finally:
            mp.undo()
        assert not replay.keys and replay.pending is None
        assert got.dtype == torch.float32
        # 10 ** x and exp(x) round the last bit their own way.
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6)


def _jax_cfg(lr, entropy, reward_explore=None, pbt=None, threshold=0.7):
    pbt = pbt or dict(num_teams=2, team_size=1, num_train_policies=4,
                      num_past_policies=2, self_play_portion=0.25,
                      cross_play_portion=0.5, past_play_portion=0.25)
    return mlt.TrainConfig(
        num_worlds=32, num_agents_per_world=2, num_updates=1,
        actions={}, steps_per_update=4, lr=lr, num_bptt_chunks=1,
        gamma=0.99, seed=0, metrics_buffer_size=1,
        algo=mlt.PPOConfig(num_epochs=1, minibatch_size=4, clip_coef=0.2,
                           value_loss_coef=0.5, entropy_coef=entropy,
                           max_grad_norm=0.5),
        pbt=mlt.PBTConfig(**pbt, policy_overwrite_threshold=threshold,
                          reward_hyper_params_explore=reward_explore or {}),
        dreamer_v3_critic=False)


def _torch_pe(x):
    return tlt.ParamExplore(**vars(x)) if isinstance(
        x, mlt.ParamExplore) else x


def _torch_cfg(jcfg):
    pbt = jcfg.pbt
    return tlt.TrainConfig(
        num_worlds=jcfg.num_worlds, num_agents_per_world=2, actions={},
        steps_per_update=4, lr=_torch_pe(jcfg.lr), num_bptt_chunks=1,
        gamma=0.99, seed=0, metrics_buffer_size=1,
        algo=tlt.PPOConfig(num_epochs=1, minibatch_size=4, clip_coef=0.2,
                           value_loss_coef=0.5,
                           entropy_coef=_torch_pe(jcfg.algo.entropy_coef),
                           max_grad_norm=0.5),
        pbt=tlt.PBTConfig(
            num_teams=2, team_size=1,
            num_train_policies=pbt.num_train_policies,
            num_past_policies=pbt.num_past_policies,
            self_play_portion=pbt.self_play_portion,
            cross_play_portion=pbt.cross_play_portion,
            past_play_portion=pbt.past_play_portion,
            policy_overwrite_threshold=pbt.policy_overwrite_threshold,
            reward_hyper_params_explore={
                k: _torch_pe(v)
                for k, v in pbt.reward_hyper_params_explore.items()}),
        dreamer_v3_critic=False)


def _explore_keys(rng, num_reward, entropy_searched=True):
    """The keys of JAX's explore_param calls in pbt_explore_hyperparams,
    in the port's order: the reward hyperparameters, lr, then PPO's
    entropy coefficient (if it is searched)."""
    lr_rnd, algo_rnd, reward_rnd = random.split(rng, 3)
    reward = list(random.split(reward_rnd, num_reward)) if num_reward else []
    return reward + [lr_rnd] + ([algo_rnd] if entropy_searched else [])


@pytest.mark.parametrize("chance", [0.2, 1.0])
def test_explore_hyperparams_matches_jax(chance):
    reward_explore = {"a": mlt.ParamExplore(1.0, 0.5, 2.0),
                      "b": mlt.ParamExplore(0.1, 0.1, 10.0,
                                            log10_scale=True)}
    jcfg = _jax_cfg(SPECS["log10"], mlt.ParamExplore(0.01, 0.5, 2.0),
                    reward_explore)
    tcfg = _torch_cfg(jcfg)
    hp = mlt.ppo.PPO().init_hyperparams(jcfg)
    start = np.array([1.3, 0.4], np.float32)
    j_policy = SimpleNamespace(
        reward_hyper_params=jnp.asarray(start),
        update=lambda **kw: SimpleNamespace(**kw))
    j_train = SimpleNamespace(
        hyper_params=hp, update=lambda **kw: SimpleNamespace(**kw))
    for i in range(4):
        rng = random.PRNGKey(40 + i)
        j_pol, j_tr = j_pbt.pbt_explore_hyperparams(jcfg, rng, j_policy,
                                                    j_train, chance)
        population = SimpleNamespace(
            reward_hyper_params=torch.from_numpy(np.stack([start, start])))
        t_train = SimpleNamespace(
            hyper_params=tlt.ppo.PPO().init_hyperparams(tcfg))
        mp = pytest.MonkeyPatch()
        replay = _UniformReplay(_explore_keys(rng, 2))
        mp.setattr(t_pbt, "uniform", replay)
        try:
            t_pbt.pbt_explore_hyperparams(tcfg, None, population, 1, t_train,
                                          chance)
        finally:
            mp.undo()
        assert not replay.keys
        np.testing.assert_allclose(population.reward_hyper_params[1].numpy(),
                                   np.asarray(j_pol.reward_hyper_params),
                                   rtol=1e-6)
        np.testing.assert_array_equal(
            population.reward_hyper_params[0].numpy(), start)
        for name in ("lr", "entropy_coef"):
            np.testing.assert_allclose(
                _np(getattr(t_train.hyper_params, name)),
                np.asarray(getattr(j_tr.hyper_params, name)), rtol=1e-6,
                err_msg=name)


# -- Cull and past snapshots ------------------------------------------------

class _Tiny(torch.nn.Module):
    def __init__(self, w):
        super().__init__()
        self.kernel = torch.nn.Parameter(torch.tensor(w))


def _populations(jcfg, fitness, rng):
    """The same small population in both packages: per-policy weights,
    Adam moments, hyperparameters drawn at init and the given fitness
    (``{"elo": [P]}`` or ``{"mean", "var", "N"}``)."""
    tcfg = _torch_cfg(jcfg)
    P = jcfg.pbt.num_train_policies
    total = P + jcfg.pbt.num_past_policies
    w = rng.standard_normal((total, 3)).astype(np.float32)
    mu = rng.standard_normal((P, 3)).astype(np.float32)
    hp = jax.tree.map(lambda x: jnp.broadcast_to(jnp.asarray(x), (P,)),
                      mlt.ppo.PPO().init_hyperparams(jcfg))
    lrs = rng.uniform(1e-4, 1e-2, P).astype(np.float32)
    hp = hp.replace(lr=jnp.asarray(lrs))
    if "elo" in fitness:
        j_mmr, j_score = JaxMMR(elo=jnp.asarray(fitness["elo"])), None
        t_mmr, t_score = MMR(elo=torch.tensor(fitness["elo"])), None
    else:
        j_mmr, t_mmr = None, None
        j_score = JaxScore(**{k: jnp.asarray(v) for k, v in fitness.items()})
        t_score = MovingEpisodeScore(
            **{k: torch.tensor(v) for k, v in fitness.items()})
    j_mgr = JaxTrainStateManager(
        policy_states=JaxPolicyState(
            apply_fn=None, rnn_reset_fn=None,
            params={"kernel": jnp.asarray(w)}, batch_stats={},
            obs_preprocess=None, obs_preprocess_state={},
            reward_hyper_params=None, get_episode_scores_fn=None,
            episode_score=j_score, mmr=j_mmr),
        train_states=JaxPolicyTrainState(
            value_normalizer=None, max_advantage_est=None, tx=None,
            initial_weight_norms={}, value_normalizer_state=None,
            max_advantage_est_state={}, hyper_params=hp,
            opt_state={"mu": jnp.asarray(mu)}, scaler=None,
            update_prng_key=random.split(random.PRNGKey(1), P)),
        pbt_rng=random.PRNGKey(77), user_state=None)

    modules = [_Tiny(w[p]) for p in range(total)]
    train_states = []
    for p in range(P):
        ts = _make_train_state(tcfg, tlt.ppo.PPO(), modules[p], "cpu",
                               torch.Generator().manual_seed(p))
        ts.opt_state.mu["kernel"].copy_(torch.from_numpy(mu[p]))
        ts.hyper_params.lr = torch.tensor(lrs[p])
        train_states.append(ts)
    population = Population(
        policies=[PolicyState(m, None, {}) for m in modules],
        reward_hyper_params=None, get_episode_scores_fn=None,
        episode_score=t_score, mmr=t_mmr)
    t_mgr = TrainStateManager(policy_states=population,
                              train_states=train_states, user_state=None,
                              pbt_generator=torch.Generator())
    return tcfg, j_mgr, t_mgr


def _evolve_both(jcfg, fitness, seed=0):
    """Cull then past snapshot in both packages, the port replaying JAX's
    draws; returns (JAX managers, port manager, port copies, the port's
    generators before)."""
    tcfg, j_mgr, t_mgr = _populations(jcfg, fitness,
                                      np.random.default_rng(seed))
    j_culled = j_pbt.pbt_cull_update(jcfg, j_mgr, 1)
    recorder = _RandintRecorder()
    mp = pytest.MonkeyPatch()
    mp.setattr(j_pbt, "random", recorder)
    try:
        j_past = j_pbt.pbt_past_update(jcfg, j_culled)
    finally:
        mp.undo()
    # JAX's key flow: the cull splits pbt_rng and draws one mutate key per
    # culled policy; each mutation is an explore of lr then PPO's.
    _, mutate_base = random.split(j_mgr.pbt_rng)
    mutate = random.split(mutate_base, 1)
    gens = [ts.generator for ts in t_mgr.train_states]
    mp = pytest.MonkeyPatch()
    replay = _UniformReplay(_explore_keys(
        mutate[0], 0, isinstance(jcfg.algo.entropy_coef, mlt.ParamExplore)))
    mp.setattr(t_pbt, "uniform", replay)
    queue = _replay_randint(mp, recorder.draws)
    try:
        copies = (t_pbt.pbt_cull_update(tcfg, t_mgr, 1)
                  + t_pbt.pbt_past_update(tcfg, t_mgr))
    finally:
        mp.undo()
    assert not queue
    return j_mgr, j_culled, j_past, t_mgr, copies, gens, replay


def _check_against_jax(j_mgr, j_past, t_mgr, copies, gens):
    want_w = np.asarray(j_past.policy_states.params["kernel"])
    before_w = np.asarray(j_mgr.policy_states.params["kernel"])
    want_copies = []
    for dst in range(want_w.shape[0]):
        if not np.array_equal(want_w[dst], before_w[dst]):
            src = [s for s in range(want_w.shape[0])
                   if np.array_equal(before_w[s], want_w[dst])]
            want_copies.append((src[0], dst))
    assert sorted(d for _, d in copies) == [d for _, d in want_copies]
    population = t_mgr.policy_states
    for p, policy in enumerate(population.policies):
        # Copies are bitwise.
        np.testing.assert_array_equal(_np(policy.actor_critic.kernel),
                                      want_w[p], err_msg=f"policy {p}")
    P = len(t_mgr.train_states)
    j_ts = j_past.train_states
    for p, ts in enumerate(t_mgr.train_states):
        np.testing.assert_array_equal(_np(ts.opt_state.mu["kernel"]),
                                      np.asarray(j_ts.opt_state["mu"][p]))
        np.testing.assert_allclose(_np(ts.hyper_params.lr),
                                   np.asarray(j_ts.hyper_params.lr[p]),
                                   rtol=1e-6, err_msg=f"lr {p}")
        assert ts.generator is gens[p]
    fitness = (("elo",) if population.mmr is not None
               else ("mean", "var", "N"))
    for name in fitness:
        got = (population.mmr.elo if name == "elo"
               else getattr(population.episode_score, name))
        want = (j_past.policy_states.mmr.elo if name == "elo"
                else getattr(j_past.policy_states.episode_score, name))
        np.testing.assert_array_equal(_np(got), np.asarray(want))
    return P


@pytest.mark.parametrize("case", ["elo_copies", "elo_refused",
                                  "welch_copies", "welch_refused"])
def test_cull_and_past_update_match_jax(case):
    if case.startswith("elo"):
        # 4 train policies, 2 past: policy 2 leads by 400, so it overwrites
        # policy 0 at a threshold of 0.7 and not at 0.95.
        fitness = {"elo": np.array([1300, 1500, 1700, 1450, 1100, 1600],
                                   np.float32)}
        threshold = 0.7 if case == "elo_copies" else 0.95
    else:
        # Policy 2 leads policy 0 by 1.9 (p ~ 0) or by 0.02 (p ~ 0.44).
        lead = 2.0 if case == "welch_copies" else 0.32
        fitness = {
            "mean": np.array([0.3, 0.31, lead, 0.305, -1.0, 0.2],
                             np.float32),
            "var": np.array([0.5, 0.4, 0.3, 0.6, 0.2, 0.1], np.float32),
            "N": np.array([40, 30, 50, 20, 10, 60], np.int32)}
        threshold = 0.7
    jcfg = _jax_cfg(SPECS["log10"], 0.01, threshold=threshold)
    j_mgr, j_culled, j_past, t_mgr, copies, gens, replay = _evolve_both(
        jcfg, fitness)
    _check_against_jax(j_mgr, j_past, t_mgr, copies, gens)
    culled = [c for c in copies if c[1] < len(t_mgr.train_states)]
    if case.endswith("copies"):
        assert culled and culled[0][0] == 2 and not replay.keys
    else:
        assert not culled


def test_cull_keeps_the_destination_generator_and_copies_moments():
    fitness = {"elo": np.array([1300, 1500, 1700, 1450, 1100, 1600],
                               np.float32)}
    jcfg = _jax_cfg(SPECS["log10"], 0.01)
    _, _, _, t_mgr, copies, gens, _ = _evolve_both(jcfg, fitness, seed=3)
    (src, dst), = [c for c in copies if c[1] < 4]
    src_ts, dst_ts = t_mgr.train_states[src], t_mgr.train_states[dst]
    assert dst_ts.generator is gens[dst] and dst_ts.generator is not \
        src_ts.generator
    assert dst_ts.opt_state.mu["kernel"] is not src_ts.opt_state.mu["kernel"]
    np.testing.assert_array_equal(_np(dst_ts.opt_state.mu["kernel"]),
                                  _np(src_ts.opt_state.mu["kernel"]))
    # The copied lr was mutated apart from the source's.
    assert float(dst_ts.hyper_params.lr) != float(src_ts.hyper_params.lr)


# -- The all-pairs tournament layout ------------------------------------------

@pytest.mark.parametrize("args", [
    (4, [], 64, 2, 1, 0), (4, [], 64, 2, 1, 3), (3, [9], 48, 2, 2, 5),
    (6, [], 32, 2, 1, 0), (6, [], 32, 2, 1, 7)], ids=str)
def test_all_pairs_assignments_match_jax(args):
    num_policies, custom, batch, teams, size, offset = args
    underfilled = batch // (teams * size) < (
        (num_policies + len(custom)) ** 2)
    with warnings.catch_warnings(record=True) as j_warn:
        warnings.simplefilter("always")
        want = jax_all_pairs(num_policies, custom, batch, teams, size,
                             pair_offset=jnp.asarray(offset, jnp.int32))
    with warnings.catch_warnings(record=True) as t_warn:
        warnings.simplefilter("always")
        got = _build_all_pairs_assignments(num_policies, custom, batch,
                                           teams, size, pair_offset=offset)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32
    for rec in (j_warn, t_warn):
        msgs = [str(w.message) for w in rec if "underfilled" in
                str(w.message)]
        assert bool(msgs) == underfilled
        if underfilled:
            dropped = (num_policies + len(custom)) ** 2 - batch // (
                teams * size)
            assert f"drops {dropped} pairings" in msgs[0]
            assert "pair_offset" in msgs[0]


# -- A self-play population ---------------------------------------------------

def test_self_play_population_trains_each_policy_on_its_block():
    """Pure self-play over 2 train policies on the gridworld: no reorder,
    each policy plays its own contiguous half of the batch and learns on
    it with its own optimizer; fitness is the episode score (one team)."""
    from madrona_learn_tpu_torch.envs import ToyEnvConfig, make_toy_env
    from test_torch_models import _torch_actor_critic

    cfg = tlt.TrainConfig(
        num_worlds=16, num_agents_per_world=1,
        actions={"move": tlt.DiscreteActionsConfig(actions_num_buckets=[5])},
        steps_per_update=8, num_bptt_chunks=2, lr=1e-3, gamma=0.99,
        seed=1, metrics_buffer_size=1,
        algo=tlt.PPOConfig(num_epochs=1, minibatch_size=8, clip_coef=0.2,
                           value_loss_coef=0.5, entropy_coef=0.01,
                           max_grad_norm=0.5),
        pbt=tlt.PBTConfig(num_teams=1, team_size=1, num_train_policies=2,
                          num_past_policies=0, self_play_portion=1.0,
                          cross_play_portion=0.0, past_play_portion=0.0),
        dreamer_v3_critic=False)
    policy = tlt.Policy(
        lambda p: _torch_actor_critic(torch.float32, 16),
        tlt.ObservationsEMANormalizer.create(decay=0.99999,
                                             dtype=torch.float32))
    mgr = tlt.init_training("cpu", cfg, make_toy_env(
        ToyEnvConfig(num_worlds=16, episode_len=5, seed=1), device="cpu"),
        policy, torch.zeros((1,), dtype=torch.int32))
    population = mgr.state.policy_states
    assert population.mmr is None and population.episode_score is not None
    assert not mgr.rollout.cfg.pbt.complex_matchmaking
    np.testing.assert_array_equal(mgr.rollout.policy_assignments.numpy(),
                                  np.repeat([0, 1], 8))
    before = [p.actor_critic.critic.Dense_0.kernel.detach().clone()
              for p in population.policies]
    collected = []
    orig_collect = tlt.RolloutManager.collect

    def recording_collect(self, *args, **kwargs):
        out = orig_collect(self, *args, **kwargs)
        collected.append(out[0].all())
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(tlt.RolloutManager, "collect", recording_collect)
    try:
        mgr.update_iter()
    finally:
        mp.undo()
    data = collected[0]
    # [P, sequences (8 agents x 2 chunks), T/C, ...]
    assert data["rewards"].shape == (2, 16, 4, 1)
    assert len(mgr.first_minibatch_stats) == 2
    for p, stats in enumerate(mgr.first_minibatch_stats):
        assert float(stats["max_abs_ratio_dev"]) < 1e-5
        assert torch.isfinite(stats["loss"])
        assert not torch.equal(
            population[p].actor_critic.critic.Dense_0.kernel, before[p])
        assert int(mgr.state.train_states[p].opt_state.count) == 2
    # Each policy's obs normalizer folded its own half of the batch, once.
    states = [p.obs_preprocess_state["delta"] for p in population.policies]
    assert [int(st["N"]) for st in states] == [1, 1]
    assert not torch.equal(states[0]["mu"], states[1]["mu"])


def _override_cfg(override):
    return tlt.TrainConfig(
        num_worlds=8, num_agents_per_world=2,
        actions={"move": tlt.DiscreteActionsConfig(actions_num_buckets=[5])},
        steps_per_update=4, num_bptt_chunks=1, lr=1e-3, gamma=0.99,
        seed=1, metrics_buffer_size=1,
        algo=tlt.PPOConfig(num_epochs=1, minibatch_size=3, clip_coef=0.2,
                           value_loss_coef=0.5, entropy_coef=0.01,
                           max_grad_norm=0.5),
        pbt=tlt.PBTConfig(num_teams=2, team_size=1, num_train_policies=2,
                          num_past_policies=1, self_play_portion=0.5,
                          cross_play_portion=0.25, past_play_portion=0.25,
                          rollout_policy_chunk_size_override=override),
        dreamer_v3_critic=False)


def _override_trainer(override, rnn):
    """A duel population over 8 worlds whose tower is an MLP of 16 and
    ``rnn(16)``."""
    from madrona_learn_tpu_torch.envs import ToyEnvConfig, make_duel_env
    import madrona_learn_tpu_torch.models as tm

    def actor_critic(p):
        return tm.ActorCritic(
            backbone=tm.BackboneShared(
                prefix=lambda obs: torch.cat([obs["time"], obs["acc"]], -1),
                encoder=tm.RecurrentBackboneEncoder(
                    net=tm.MLP(2, 16, 1, torch.float32), rnn=rnn(16))),
            actor=tm.DictActor({"move": tm.DenseLayerDiscreteActor(
                tlt.DiscreteActionsConfig(actions_num_buckets=[5]), 16,
                torch.float32)}),
            critic=tm.DenseLayerCritic(16, torch.float32))

    policy = tlt.Policy(actor_critic,
                        tlt.ObservationsCaster.create(torch.float32),
                        lambda er: (er[0].float(), 1.0 - er[0].float()))
    return tlt.init_training("cpu", _override_cfg(override), make_duel_env(
        ToyEnvConfig(num_worlds=8, episode_len=4, num_teams=2, team_size=1,
                     seed=1), device="cpu"),
        policy, torch.zeros((1,), dtype=torch.int32))


@pytest.mark.parametrize("override", [0, 4, 3])
def test_chunk_size_override_honoured(override):
    """``rollout_policy_chunk_size_override`` sets the policy-chunk size of
    an MLP + LSTM population, as in JAX (0: the heuristic's 16, the whole
    batch here), and the rollout's layout uses it: ceil(16 / C) + 3 - 1
    chunks of C."""
    import madrona_learn_tpu_torch.models as tm

    mgr = _override_trainer(
        override, lambda h: tm.LSTM(h, h, 1, torch.float32))
    cfg = mgr.rollout.cfg
    C = override or 16
    assert cfg.policy_chunked
    assert (cfg.policy_chunk_size, cfg.num_policy_chunks) == \
        (C, -(-16 // C) + 2)
    mgr.update_iter()
    layout = mgr.rollout.reorder_state
    assert layout.to_policy_idxs.shape == (cfg.num_policy_chunks, C)
    assert layout.assignments is mgr.rollout.policy_assignments
    for stats in mgr.first_minibatch_stats:
        assert float(stats["max_abs_ratio_dev"]) < 1e-5


def test_chunk_size_override_refused_without_a_batched_form():
    """A float64 GRU has no policy-batched form (the batched forms take
    float32, bfloat16 and float16; a GRU of any width has one since its
    plain twins serve the widths no kernel is built for): the population
    keeps the per-policy loop, which reads no chunk size, and
    init_training refuses a forced one, naming the module."""
    import madrona_learn_tpu_torch.models as tm

    gru = lambda h: tm.GRU(h, h, 1, torch.float64)
    with pytest.raises(ValueError, match=r"rollout_policy_chunk_size"
                       r"_override: backbone\.encoder\.rnn \(GRU\)"):
        _override_trainer(8, gru)
    mgr = _override_trainer(0, gru)
    assert not mgr.rollout.cfg.policy_chunked
