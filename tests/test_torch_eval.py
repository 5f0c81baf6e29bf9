"""Checkpoints of the JAX package carried over to the port, and offline
evaluation in both packages.

The JAX package trains and saves an orbax checkpoint: the slice test's
single policy (16 toy worlds, MLP 2x32 + LSTM 32, the EMA obs normalizer,
2 updates) and ``tests/test_pbt_e2e.py``'s population (4 train + 2 past
policies, 32 duel worlds, an MLP of 32, 1 update).
``scripts/torch_import_jax_checkpoint.py`` carries each over, and
``init_training(..., restore_ckpt=...)`` must then hold exactly the
arrays of the JAX package's ``TrainStateManager.restore_host``:
parameters, Adam state, normalizers, hyperparameters and Elo. Then
``eval_policies`` with the deterministic policy runs in both packages from
the same checkpoint: the single policy playing itself on the toy env (the
port given the JAX env's start state) and the population's train policies
in a competitive all-pairs eval over the duel. The actions must be equal
at every step and the values within 1e-5; the competitive eval's Elo
reads 1500.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import madrona_learn_tpu as mlt
import madrona_learn_tpu_torch as tlt
from madrona_learn_tpu.envs import ToyEnvConfig as JaxToyEnvConfig
from madrona_learn_tpu.envs import make_duel_env as jax_make_duel_env
from madrona_learn_tpu.envs import make_toy_env as jax_make_toy_env
from madrona_learn_tpu.train_state import TrainStateManager as JaxTSM
from madrona_learn_tpu_torch.compat.from_jax import (
    _seed, actor_critic_state_dict, initial_weight_norms, policy_slice)
from madrona_learn_tpu_torch.envs import (ToyEnvConfig, make_duel_env,
                                          make_toy_env)
from test_pbt_e2e import EPISODE_LEN, NUM_TRAIN, NUM_WORLDS
from test_pbt_e2e import build_training_mgr as jax_pbt_trainer
from test_pbt_e2e import make_policy as jax_duel_policy
from test_torch_models import _jax_actor_critic, _torch_actor_critic
from test_torch_pbt_slice import _get_episode_scores, _torch_cfg, _torch_model
from test_torch_slice import ENV, H, W, _jax_config, _torch_config

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "torch_import_jax_checkpoint",
    os.path.join(ROOT, "scripts", "torch_import_jax_checkpoint.py"))
importer = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(importer)

EVAL_STEPS = 12
MOVE_T = {"move": tlt.DiscreteActionsConfig(actions_num_buckets=[5])}
MOVE_J = {"move": mlt.DiscreteActionsConfig(actions_num_buckets=[5])}


def _jax_single_policy():
    return mlt.Policy(
        actor_critic=_jax_actor_critic(jnp.float32, H),
        obs_preprocess=mlt.ObservationsEMANormalizer.create(
            decay=0.99999, dtype=jnp.float32))


def _torch_single_policy():
    return tlt.Policy(_torch_actor_critic(torch.float32, H),
                      tlt.ObservationsEMANormalizer.create(
                          decay=0.99999, dtype=torch.float32))


def _torch_duel_policy():
    return tlt.Policy(lambda p: _torch_model("mlp"),
                      tlt.ObservationsCaster.create(torch.float32),
                      _get_episode_scores)


def _torch_duel_env():
    return make_duel_env(ToyEnvConfig(num_worlds=NUM_WORLDS,
                                      episode_len=EPISODE_LEN, num_teams=2,
                                      team_size=1, seed=3), device="cpu")


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """Each kind's JAX checkpoint, the port's conversion of it and the JAX
    package's host arrays of it."""
    root = tmp_path_factory.mktemp("jax_ckpts")
    update = jax.jit(lambda m: m.update_iter())
    single = mlt.init_training(
        None, _jax_config(), jax_make_toy_env(JaxToyEnvConfig(**ENV)),
        _jax_single_policy(), init_sim_ctrl=jnp.zeros((1,), jnp.int32))
    for _ in range(2):
        single = update(single)
    pbt = jax.jit(lambda m: m.update_iter())(jax_pbt_trainer(seed=41))
    out = {}
    for kind, mgr in (("single", single), ("pbt", pbt)):
        mgr.save_ckpt(str(root / kind))
        src = str(root / kind / str(int(mgr.update_idx)))
        dst = str(root / f"{kind}_torch" / str(int(mgr.update_idx)))
        importer.main([src, dst])
        out[kind] = dict(src=src, dst=dst, host=JaxTSM.restore_host(src),
                         update_idx=int(mgr.update_idx))
    return out


def _torch_trainer(kind, restore_ckpt):
    if kind == "single":
        return tlt.init_training(
            "cpu", _torch_config(),
            make_toy_env(ToyEnvConfig(**ENV), device="cpu"),
            _torch_single_policy(), torch.zeros((1,), dtype=torch.int32),
            restore_ckpt=restore_ckpt)
    return tlt.init_training("cpu", _torch_cfg(), _torch_duel_env(),
                             _torch_duel_policy(),
                             torch.zeros((1,), dtype=torch.int32),
                             restore_ckpt=restore_ckpt)


def _equal(got, want, what):
    np.testing.assert_array_equal(np.asarray(got.detach()), np.asarray(want),
                                  err_msg=what)


@pytest.mark.parametrize("kind", ["single", "pbt"])
def test_converted_checkpoint_holds_the_jax_arrays(checkpoints, kind):
    ckpt = checkpoints[kind]
    host = ckpt["host"]
    mgr = _torch_trainer(kind, ckpt["dst"])
    assert mgr.update_idx == ckpt["update_idx"]
    assert mgr.metrics.update_idx == ckpt["update_idx"]
    policies = mgr.state._policies()
    for p, policy in enumerate(policies):
        want = actor_critic_state_dict(
            policy_slice(host["policy_states"]["params"], p))
        got = dict(policy.actor_critic.named_parameters())
        assert sorted(got) == sorted(want)
        for name, w in want.items():
            _equal(got[name], w, f"policy {p} {name}")
        obs = policy_slice(host["policy_states"]["obs_preprocess_state"], p)
        for key, est in obs.items():
            if est is None:
                assert policy.obs_preprocess_state[key] is None
                continue
            for name, w in est.items():
                _equal(policy.obs_preprocess_state[key][name], w,
                       f"policy {p} obs {key}.{name}")
    train_states = mgr.state._train_state_list()
    assert len(train_states) == (1 if kind == "single" else NUM_TRAIN)
    for p, ts in enumerate(train_states):
        jts = policy_slice(host["train_states"], p)
        adam = jts["opt_state"][1]
        _equal(ts.opt_state.count, adam["count"], "count")
        assert int(ts.opt_state.count) > 0
        for moment in ("mu", "nu"):
            want = actor_critic_state_dict(adam[moment])
            got = getattr(ts.opt_state, moment)
            assert sorted(got) == sorted(want)
            for name, w in want.items():
                _equal(got[name], w, f"{moment} {name}")
        want = initial_weight_norms(jts["initial_weight_norms"])
        assert sorted(ts.initial_weight_norms) == sorted(want)
        for name, w in want.items():
            _equal(ts.initial_weight_norms[name], w, name)
        for name, w in jts["max_advantage_est_state"].items():
            _equal(ts.max_advantage_est_state[name], w, name)
        for name, w in jts["hyper_params"].items():
            assert np.asarray(getattr(ts.hyper_params, name)).item() == \
                np.asarray(w).item(), name
        assert ts.generator.initial_seed() == _seed(jts["update_prng_key"])
    # The converted tree keeps JAX's fitness, a single policy's too, and
    # a single-policy manager does not load it.
    converted = tlt.TrainStateManager.restore_host(ckpt["dst"])["population"]
    for key in ("mmr", "episode_score"):
        want = host["policy_states"][key]
        assert (converted[key] is None) == (want is None), key
        for name, w in (want or {}).items():
            _equal(converted[key][name], w, f"{key}.{name}")
    assert (host["policy_states"]["episode_score"] is None) == \
        (kind == "pbt")
    if kind == "pbt":
        population = mgr.state.policy_states
        _equal(population.mmr.elo, host["policy_states"]["mmr"]["elo"],
               "elo")
        assert population.reward_hyper_params is None
        assert mgr.state.pbt_generator.initial_seed() == _seed(
            host["pbt_rng"])
    # Training goes on from it.
    mgr.update_iter()
    assert mgr.update_idx == ckpt["update_idx"] + 1
    for m in mgr.metrics.metrics.values():
        assert bool(torch.isfinite(m.mean).all())


def _jax_eval(eval_cfg, sim_fns, policy, policy_states):
    seen = []

    def step_cb(step_data):
        jax.debug.callback(
            lambda a, v: seen.append((np.asarray(a), np.asarray(v))),
            step_data["actions"]["move"], step_data["critic"],
            ordered=True)
        return step_data["sim_state"]

    result = mlt.eval_policies(None, eval_cfg, sim_fns, policy,
                               jnp.zeros((1,), jnp.int32), policy_states,
                               step_cb)
    jax.effects_barrier()
    return seen, result


def _torch_eval(eval_cfg, sim_fns, policy, policy_states):
    seen = []

    def step_cb(step_data):
        seen.append((step_data["actions"]["move"].numpy(),
                     step_data["critic"].numpy()))
        assert "log_probs" not in step_data
        return step_data["sim_state"]

    result = tlt.eval_policies("cpu", eval_cfg, sim_fns, policy,
                               torch.zeros((1,), dtype=torch.int32),
                               policy_states, step_cb)
    return seen, result


def _assert_same_steps(got, want):
    assert len(got) == len(want) == EVAL_STEPS
    for step, ((ga, gv), (wa, wv)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(ga, wa, err_msg=f"step {step}")
        np.testing.assert_allclose(gv, wv, rtol=0, atol=1e-5,
                                   err_msg=f"step {step}")


def _eval_cfg(pkg, **kwargs):
    return pkg.EvalConfig(
        num_eval_steps=EVAL_STEPS,
        actions=MOVE_J if pkg is mlt else MOVE_T, reward_gamma=0.95,
        policy_dtype=jnp.float32 if pkg is mlt else torch.float32,
        **kwargs)


def test_deterministic_eval_matches_jax(checkpoints):
    ckpt = checkpoints["single"]
    j_states, n = mlt.eval_load_ckpt(_jax_single_policy(), ckpt["src"])
    assert n == 1
    kwargs = dict(num_worlds=W, num_teams=1, team_size=1,
                  eval_competitive=False)
    j_env = jax_make_toy_env(JaxToyEnvConfig(**ENV))
    want, j_result = _jax_eval(_eval_cfg(mlt, **kwargs), j_env,
                               _jax_single_policy(), j_states)

    t_policy = _torch_single_policy()
    t_states, n = tlt.eval_load_ckpt(t_policy, ckpt["dst"])
    assert n == 1
    # The JAX env's start state (its init draws from jax.random).
    start = jax.tree.map(lambda x: torch.from_numpy(np.array(x)),
                         j_env["init"]())
    t_env = dict(make_toy_env(ToyEnvConfig(**ENV), device="cpu"),
                 init=lambda: start)
    got, t_result = _torch_eval(_eval_cfg(tlt, **kwargs), t_env, t_policy,
                                t_states)
    _assert_same_steps(got, want)
    # JAX's episode score is carried across, and cleared by the eval in
    # both packages.
    for name in ("mean", "var", "N"):
        assert getattr(t_result, name).tolist() == \
            np.asarray(getattr(j_result, name)).tolist() == [0], name


def test_competitive_eval_of_a_jax_population_matches_jax(checkpoints):
    ckpt = checkpoints["pbt"]
    actions = {"move": mlt.DiscreteActionsConfig(actions_num_buckets=[5])}
    j_policy = jax_duel_policy(actions)
    j_states, n = mlt.eval_load_ckpt(j_policy, ckpt["src"])
    assert n == NUM_TRAIN
    kwargs = dict(num_worlds=NUM_WORLDS, num_teams=2, team_size=1,
                  eval_competitive=True)
    want, j_mmr = _jax_eval(
        _eval_cfg(mlt, **kwargs),
        jax_make_duel_env(JaxToyEnvConfig(num_worlds=NUM_WORLDS,
                                          episode_len=EPISODE_LEN,
                                          num_teams=2, team_size=1,
                                          seed=3)),
        j_policy, j_states)

    t_policy = _torch_duel_policy()
    t_states, n = tlt.eval_load_ckpt(t_policy, ckpt["dst"])
    assert n == len(t_states) == NUM_TRAIN
    got, t_mmr = _torch_eval(_eval_cfg(tlt, **kwargs), _torch_duel_env(),
                             t_policy, t_states)
    _assert_same_steps(got, want)
    assert t_mmr.elo.tolist() == [1500.0] * NUM_TRAIN
    assert np.asarray(j_mmr.elo).tolist() == [1500.0] * NUM_TRAIN
    # The eval cleared copies: the loaded population keeps its Elo.
    np.testing.assert_array_equal(
        t_states.mmr.elo.numpy(),
        ckpt["host"]["policy_states"]["mmr"]["elo"][:NUM_TRAIN])


def test_eval_refuses_a_policy_dtype_its_policies_do_not_compute_in(
        checkpoints):
    t_policy = _torch_single_policy()
    t_states, _ = tlt.eval_load_ckpt(t_policy, checkpoints["single"]["dst"])
    eval_cfg = tlt.EvalConfig(
        num_worlds=W, num_teams=1, team_size=1, num_eval_steps=EVAL_STEPS,
        actions=MOVE_T, reward_gamma=0.95, policy_dtype=torch.bfloat16,
        eval_competitive=False)
    with pytest.raises(ValueError, match="policy_dtype"):
        _torch_eval(eval_cfg, make_toy_env(ToyEnvConfig(**ENV),
                                           device="cpu"),
                    t_policy, t_states)


@pytest.mark.parametrize("sample_actions", [True, False])
def test_single_policy_rollout_loop_samples_or_takes_the_best(
        sample_actions):
    """``rollout_loop`` with no population: with ``sample_actions=False``
    every step's actions are the same whatever the generator, with no
    ``log_probs``; sampling draws from the generator."""
    from madrona_learn_tpu_torch.rollouts import (RolloutConfig,
                                                  RolloutState, rollout_loop)
    from madrona_learn_tpu_torch.train_state import PolicyState

    def run(seed):
        torch.manual_seed(0)
        model = _torch_actor_critic(torch.float32, H)
        caster = tlt.ObservationsCaster.create(torch.float32)
        env = make_toy_env(ToyEnvConfig(**ENV), device="cpu")
        state = RolloutState.create(
            RolloutConfig.setup(num_worlds=W, agents_per_world=1,
                                actions_cfg=MOVE_T),
            env, torch.Generator().manual_seed(seed),
            model.init_recurrent_state(W),
            torch.zeros((1,), dtype=torch.int32))
        policy_state = PolicyState(
            model, caster,
            caster.init_state({k: v[0:1] for k, v in state.cur_obs.items()}))
        seen = []

        def post_inference_cb(step_idx, obs, preprocessed, policy_out, cb):
            seen.append(policy_out)
            return cb, {}

        rollout_loop(state, policy_state, EVAL_STEPS, post_inference_cb,
                     lambda i, rs, d, r, cb: (rs, cb, {}), None,
                     sample_actions=sample_actions)
        return seen

    first, second = run(1), run(2)
    for a, b in zip(first, second):
        assert ("log_probs" in a) == sample_actions
    same = [torch.equal(a["actions"]["move"], b["actions"]["move"])
            for a, b in zip(first, second)]
    assert all(same) != sample_actions
