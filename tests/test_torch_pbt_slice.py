"""The PBT slice as a whole: the port's population trainer against the JAX
package's.

``tests/test_pbt_e2e.py``'s trainer (4 train + 2 past policies, 32 duel
worlds, 16 steps in 2 BPTT chunks, an MLP of 32 in float32, 25% self, 50%
cross and 25% past play, lr searched in log10 space) is built in both
packages, as it stands, with an LSTM of 32 after the MLP (BASELINE
config #4's tower), with a GRU of 128 after the MLP (``gru``: the
chunk-indexed GRU kernels' widths), as the fused trunk (``fused``: an MLP
of 128 into an LSTM of 128 with ``use_fused_step`` and
``fuse_input_proj``, the widths the fused step and the projection kernels
take; the port's rollout step through ``fused_policy_step_chunked`` and
its batched learn through ``lstm_sequence_proj_chunked``, JAX's through
their jnp twins) and with the DreamerV3 two-hot critic
in the dense critic's place (``dreamer``; its head's kernel drawn small
and its bias falling off from the middle bin, as the flagship slice test
sets it, so that its values differ between rows). The port gets the JAX
population's weights, policy by policy, and replays the JAX run's draws,
in this test only:

- actions: the JAX sim step reports its sim-order actions through an
  ordered ``jax.debug.callback``; the port's population runs in the
  policy-chunk layout (``rollouts.chunked_rollout_loop``), and its
  ``categorical`` returns the step's actions gathered into the step's
  chunks (read from the layout that ``PopulationStack.rollout`` is given);
- matchmaking and the past snapshot's source: ``random.randint`` as
  ``madrona_learn_tpu.pbt`` calls it reports through an ordered callback,
  and the port's ``pbt.randint`` returns the draws;
- hyperparameters (init and the cull's mutation): the port's
  ``pbt.uniform`` returns ``jax.random.uniform`` of the keys JAX splits;
- minibatch order: the port's ``ppo.permutation`` returns JAX's
  permutation of each policy's update key.

Two ``update_iter`` calls must then give equal rollout data, per-policy
parameters, optimizer state and metrics (float32; the slice test's
tolerances), then ``eval_elo`` equal Elo (1e-5 relative) and
``update_population`` the same copies, bitwise within the port, all
through the chunked path. The port's side runs on both learn paths
(``learn``): the batched learn its models take, and the per-policy loop,
forced by the path rule; the JAX run is computed once a model for both.
On both, the ``optimize_metrics`` hook records a parameter and the Adam
count of each train policy after every minibatch's step, as JAX's hook
(reporting through an ordered ``jax.debug.callback``) records them.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import random

import madrona_learn_tpu as mlt
import madrona_learn_tpu.models as jm
import madrona_learn_tpu.pbt as j_pbt
import madrona_learn_tpu_torch as tlt
import madrona_learn_tpu_torch.models as tm
import madrona_learn_tpu_torch.ops.dists as t_dists
import madrona_learn_tpu_torch.pbt as t_pbt
import madrona_learn_tpu_torch.ppo as t_ppo
import madrona_learn_tpu_torch.train_state as t_train_state
from madrona_learn_tpu.envs import make_duel_env as jax_make_duel_env
from madrona_learn_tpu.train import TrainHooks as JaxTrainHooks
from madrona_learn_tpu_torch.compat.from_jax import (
    actor_critic_state_dict,
    fitness,
    hyper_params,
    policy_slice,
    reward_hyper_params,
)
from madrona_learn_tpu_torch.config import DiscreteActionsConfig
from madrona_learn_tpu_torch.envs import ToyEnvConfig, make_duel_env
from madrona_learn_tpu_torch.train_state import initial_weight_norms
from test_pbt_e2e import (
    EPISODE_LEN,
    NUM_PAST,
    NUM_TRAIN,
    NUM_WORLDS,
    build_training_mgr,
    get_episode_scores,
    make_policy,
)
from test_torch_pbt import _UniformReplay
from test_torch_flagship import CRITIC_BIAS
from test_torch_slice import _leaves, _np

torch.set_num_threads(1)

SEED, H, LR = 3, 32, 1e-3
# The GRU's width: the chunk-indexed GRU kernels take H = 128 or 256, so a
# GRU of 32 would take the per-policy loop. The fused trunk's likewise: a
# fused tower of 32 would run unfused.
GRU_H = FUSED_H = 128
STEPS, CHUNKS, MINIBATCH = 16, 2, 10
# Train agents a policy: 64 * (0.25 + 0.5 / 2 + 0.25 / 2) / 4 = 10.
NUM_SEQS = CHUNKS * 10
EVAL_STEPS = 2 * EPISODE_LEN
NUM_POLICIES = NUM_TRAIN + NUM_PAST
F32_TOL = dict(data=(1e-4, 1e-5), mu=(1e-4, 1e-7), nu=(1e-3, 1e-10),
               close=(1e-5, 1e-6), metrics=(1e-4, 1e-5))


class _OrderedRandint:
    """``jax.random`` whose ``randint`` reports its draws, in order,
    through an ordered ``jax.debug.callback``."""

    def __init__(self, sink):
        self.sink = sink

    def __getattr__(self, name):
        fn = getattr(random, name)
        if name != "randint":
            return fn

        def reporting(key, shape, minval, maxval, *args, **kwargs):
            out = fn(key, shape, minval, maxval, *args, **kwargs)
            jax.debug.callback(
                lambda o: self.sink.append(
                    (tuple(shape), int(minval), int(maxval), np.asarray(o))),
                out, ordered=True)
            return out

        return reporting


class _CaptureRollouts(JaxTrainHooks):
    def __init__(self, sink, hook_sink):
        self.sink = sink
        self.hook_sink = hook_sink

    def rollout_metrics(self, metrics, rollouts, user_state):
        jax.debug.callback(
            lambda r: self.sink.append(jax.tree.map(np.asarray, r)),
            rollouts)
        return metrics

    def optimize_metrics(self, metrics, epoch_idx, minibatch, policy_state,
                         train_state):
        """The critic's middle bias entry and the Adam count after the
        minibatch's step: once a train policy, in policy order, inside
        JAX's vmap of the update."""
        params = policy_state.params
        bias = params.get("params", params)["critic"]["Dense_0"]["bias"]
        jax.debug.callback(
            lambda b, c: self.hook_sink.append((float(b), int(c))),
            bias[bias.shape[0] // 2],
            _adam_state(train_state.opt_state).count, ordered=True)
        return metrics


def _recording_env(env, sink):
    """The duel env whose step reports (actions, resets) in order."""
    step = env["step"]

    def recording_step(step_input):
        jax.debug.callback(
            lambda a, r: sink.append((np.asarray(a), bool(np.asarray(r)
                                                          .any()))),
            step_input["actions"]["move"], step_input["resets"],
            ordered=True)
        return step(step_input)

    return dict(env, step=recording_step)


def _jax_policy(model, actions):
    """test_pbt_e2e's policy with an LSTM of 32 or a GRU of 128 after its
    MLP, as the fused trunk of 128, or with the DreamerV3 critic."""
    dtype = jnp.float32
    fused = model == "fused"
    net = jm.MLP(num_channels=FUSED_H if fused else H, num_layers=1,
                 dtype=dtype)
    rnn = (jm.LSTM(num_hidden_channels=H, num_layers=1, dtype=dtype,
                   use_pallas=True) if model == "lstm" else
           jm.LSTM(num_hidden_channels=FUSED_H, num_layers=1, dtype=dtype,
                   use_pallas=True, fuse_input_proj=True) if fused else
           jm.GRU(num_hidden_channels=GRU_H, num_layers=1, dtype=dtype,
                  use_pallas=True) if model == "gru" else None)
    return mlt.Policy(
        actor_critic=jm.ActorCritic(
            backbone=jm.BackboneShared(
                prefix=lambda obs, train: jnp.concatenate(
                    [obs["time"], obs["acc"]], axis=-1),
                encoder=(jm.BackboneEncoder(net=net) if rnn is None else
                         jm.RecurrentBackboneEncoder(
                             net=net, rnn=rnn, use_fused_step=fused))),
            actor=jm.DictActor(heads={"move": jm.DenseLayerDiscreteActor(
                cfg=actions["move"], dtype=dtype)}),
            critic=(jm.DreamerV3Critic(dtype=dtype) if model == "dreamer"
                    else jm.DenseLayerCritic(dtype=dtype))),
        obs_preprocess=mlt.ObservationsCaster.create(dtype=dtype),
        get_episode_scores=get_episode_scores)


def _dreamer_critic_params(mgr):
    """The population's two-hot heads: the bias falling off from the
    middle bin (test_torch_flagship's CRITIC_BIAS) and the kernel drawn
    with scale 0.05, so that values differ between rows and policies."""
    rng = np.random.default_rng(SEED)

    def head(path, p):
        keys = [k.key for k in path[-3:]]
        if keys == ["critic", "Dense_0", "bias"]:
            return jnp.broadcast_to(jnp.asarray(CRITIC_BIAS), p.shape)
        if keys == ["critic", "Dense_0", "kernel"]:
            return jnp.asarray(0.05 * rng.normal(size=p.shape), p.dtype)
        return p

    params = jax.tree_util.tree_map_with_path(
        head, mgr.state.policy_states.params)
    return mgr.replace(state=mgr.state.replace(
        policy_states=mgr.state.policy_states.replace(params=params)))


@pytest.fixture(scope="module",
                params=["mlp", "lstm", "gru", "dreamer", "fused"])
def model(request):
    return request.param


@pytest.fixture(scope="module", params=["batched", "loop"])
def learn(request):
    return request.param


@pytest.fixture(scope="module")
def jax_run(model):
    records = dict(steps=[], randint=[], data=[], hook=[])
    mp = pytest.MonkeyPatch()
    mp.setattr(j_pbt, "random", _OrderedRandint(records["randint"]))
    mp.setattr("test_pbt_e2e.make_policy",
               make_policy if model == "mlp" else
               lambda actions: _jax_policy(model, actions))
    mp.setattr("test_pbt_e2e.make_duel_env",
               lambda cfg: _recording_env(jax_make_duel_env(cfg),
                                          records["steps"]))
    real_init = mlt.init_training

    def init(model_, cfg, *a, **kw):
        if model == "dreamer":
            cfg = dataclasses.replace(cfg, dreamer_v3_critic=True)
        return real_init(model_, cfg, *a, **dict(
            kw, user_hooks=_CaptureRollouts(records["data"],
                                            records["hook"])))

    mp.setattr(mlt, "init_training", init)
    try:
        mgr = build_training_mgr(seed=SEED)
        if model == "dreamer":
            mgr = _dreamer_critic_params(mgr)
        update = jax.jit(lambda m: m.update_iter())
        mgrs = [mgr]
        for _ in range(2):
            mgr = update(mgr)
            jax.block_until_ready(mgr)
            mgrs.append(mgr)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            evaluated, deltas = mlt.eval_elo(
                mgr, EVAL_STEPS, jnp.zeros((1,), jnp.int32),
                jnp.zeros((1,), jnp.int32))
        evolved = mlt.update_population(evaluated)
        jax.block_until_ready(evolved)
        jax.effects_barrier()
    finally:
        mp.undo()
    records["steps"] = [a for a, reset in records["steps"] if not reset]
    assert len(records["steps"]) == 2 * STEPS + EVAL_STEPS
    assert len(records["data"]) == 2
    return dict(records, mgrs=mgrs, evaluated=evaluated, deltas=deltas,
                evolved=evolved)


def _torch_model(model):
    move = DiscreteActionsConfig(actions_num_buckets=[5])
    f32 = torch.float32
    fused = model == "fused"
    net = tm.MLP(2, FUSED_H if fused else H, 1, f32)
    rnn = {"lstm": lambda: tm.LSTM(H, H, 1, f32),
           "fused": lambda: tm.LSTM(FUSED_H, FUSED_H, 1, f32,
                                    fuse_input_proj=True),
           "gru": lambda: tm.GRU(H, GRU_H, 1, f32)}.get(model)
    out = GRU_H if model == "gru" else FUSED_H if fused else H
    return tm.ActorCritic(
        backbone=tm.BackboneShared(
            prefix=lambda obs: torch.cat([obs["time"], obs["acc"]], -1),
            encoder=(tm.BackboneEncoder(net=net) if rnn is None else
                     tm.RecurrentBackboneEncoder(net=net, rnn=rnn(),
                                                 use_fused_step=fused))),
        actor=tm.DictActor({"move": tm.DenseLayerDiscreteActor(
            move, out, f32)}),
        critic=(tm.DreamerV3Critic(out, f32) if model == "dreamer" else
                tm.DenseLayerCritic(out, f32)))


def _recording_hooks(sink, generators):
    """Hooks whose ``optimize_metrics`` records (train policy, the critic's
    middle bias entry, the Adam count) after every minibatch's step; the
    policy is known by its generator (``generators``, filled once the
    trainer is built)."""

    class Recording(tlt.TrainHooks):
        def optimize_metrics(self, metrics, epoch_idx, minibatch,
                             policy_state, train_state):
            p = [g is train_state.generator for g in generators].index(True)
            bias = policy_state.actor_critic.critic.Dense_0.bias.detach()
            sink.append((p, float(bias[bias.shape[0] // 2]),
                         int(train_state.opt_state.count)))
            return metrics

    return Recording()


def _get_episode_scores(er):
    winner = er[0]
    a_score = torch.where(winner == 0, 1.0,
                          torch.where(winner == 1, 0.0, 0.5))
    return a_score, 1.0 - a_score


def _torch_cfg(model="mlp"):
    return tlt.TrainConfig(
        num_worlds=NUM_WORLDS, num_agents_per_world=2,
        actions={"move": DiscreteActionsConfig(actions_num_buckets=[5])},
        steps_per_update=STEPS, num_bptt_chunks=CHUNKS,
        lr=tlt.ParamExplore(base=LR, min_scale=0.1, max_scale=10.0,
                            log10_scale=True),
        gamma=0.99, gae_lambda=0.95, seed=SEED, metrics_buffer_size=1,
        algo=tlt.PPOConfig(num_epochs=1, minibatch_size=MINIBATCH,
                           clip_coef=0.2, value_loss_coef=0.5,
                           entropy_coef=0.01, max_grad_norm=0.5),
        pbt=tlt.PBTConfig(num_teams=2, team_size=1,
                          num_train_policies=NUM_TRAIN,
                          num_past_policies=NUM_PAST,
                          self_play_portion=0.25, cross_play_portion=0.5,
                          past_play_portion=0.25,
                          policy_overwrite_threshold=0.5),
        dreamer_v3_critic=model == "dreamer")


def _policy_params(tree, p):
    return {k: np.asarray(v) for k, v in actor_critic_state_dict(
        policy_slice(tree, p)).items()}


def _adam_state(opt_state):
    return [s for s in jax.tree.leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]


def _adam(j_mgr):
    return _adam_state(j_mgr.state.train_states.opt_state)


def _install_replays(mp, jax_run):
    """The port's draws return the JAX run's (see the module docstring)."""
    steps = list(jax_run["steps"])
    pending = []
    real_rollout = t_train_state.PopulationStack.rollout

    def replay_rollout(self, layout, *args, **kwargs):
        actions = torch.from_numpy(steps.pop(0).astype(np.int64))
        pending[:] = [layout.to_policy(actions)]
        return real_rollout(self, layout, *args, **kwargs)

    mp.setattr(t_train_state.PopulationStack, "rollout", replay_rollout)
    mp.setattr(t_dists, "categorical",
               lambda logits, generator: pending.pop(0))

    randints = list(jax_run["randint"])

    def randint(generator, shape, low, high):
        want_shape, want_low, want_high, out = randints.pop(0)
        assert (tuple(shape), low, high) == (want_shape, want_low, want_high)
        return torch.from_numpy(out.astype(np.int32))

    mp.setattr(t_pbt, "randint", randint)

    # init_training draws each train policy's lr from its own key of
    # split(pbt_rng, P + 1) (explore_param: the coin, then the value).
    init_rng = random.split(random.key(SEED))[1]
    pbt_rng = random.split(init_rng)[1]
    explore = random.split(pbt_rng, NUM_TRAIN + 1)[1:]
    uniform = _UniformReplay([random.split(k, 3)[0] for k in explore])
    mp.setattr(t_pbt, "uniform", uniform)

    perms = []
    for j_mgr in jax_run["mgrs"][:2]:
        for p in range(NUM_TRAIN):
            mb_rnd = random.split(j_mgr.state.train_states.update_prng_key[p])[0]
            perms.append(np.asarray(random.permutation(
                mb_rnd, jnp.arange(NUM_SEQS))))

    def permutation(gen, x):
        out = perms.pop(0)
        assert x.shape == out.shape
        return x[torch.from_numpy(out.astype(np.int64))]

    mp.setattr(t_ppo, "permutation", permutation)
    return dict(steps=steps, randints=randints, uniform=uniform, perms=perms)


@pytest.fixture(scope="module")
def torch_run(model, learn, jax_run):
    j0 = jax_run["mgrs"][0]
    mp = pytest.MonkeyPatch()
    queues = _install_replays(mp, jax_run)
    if learn == "loop":
        mp.setattr(tlt.train, "batched_learn_missing",
                   lambda cfg, actor_critic: "the test")
    snapshots, hook_records, generators = [], [], []
    try:
        policy = tlt.Policy(lambda p: _torch_model(model),
                            tlt.ObservationsCaster.create(torch.float32),
                            _get_episode_scores)
        mgr = tlt.init_training(
            "cpu", _torch_cfg(model),
            make_duel_env(ToyEnvConfig(num_worlds=NUM_WORLDS,
                                       episode_len=EPISODE_LEN, num_teams=2,
                                       team_size=1, seed=SEED),
                          device="cpu"),
            policy, torch.zeros((1,), dtype=torch.int32),
            user_hooks=_recording_hooks(hook_records, generators))
        generators.extend(ts.generator for ts in mgr.state.train_states)
        assert mgr.rollout.cfg.policy_chunked
        assert mgr.batched_learn == (learn == "batched")
        population = mgr.state.policy_states
        for p in range(NUM_POLICIES):
            population[p].actor_critic.load_state_dict({
                k: torch.from_numpy(v) for k, v in _policy_params(
                    j0.state.policy_states.params, p).items()})
        for p, ts in enumerate(mgr.state.train_states):
            ts.initial_weight_norms = initial_weight_norms(
                population[p].actor_critic)
        lrs = [float(ts.hyper_params.lr) for ts in mgr.state.train_states]
        collected = []
        orig_collect = tlt.RolloutManager.collect

        def recording_collect(self, *args, **kwargs):
            out = orig_collect(self, *args, **kwargs)
            collected.append(out[0].all())
            return out

        mp.setattr(tlt.RolloutManager, "collect", recording_collect)
        for _ in range(2):
            mgr.update_iter()
            snapshots.append(dict(
                params=[{k: v.detach().clone() for k, v in
                         population[p].actor_critic.named_parameters()}
                        for p in range(NUM_POLICIES)],
                adam=[(ts.opt_state.mu, ts.opt_state.nu,
                       int(ts.opt_state.count))
                      for ts in mgr.state.train_states],
                stats=mgr.first_minibatch_stats,
                metrics={name: mgr.metrics.latest(name).mean.clone()
                         for name in mgr.metrics.metrics}))
            snapshots[-1]["adam"] = [
                ({k: v.clone() for k, v in mu.items()},
                 {k: v.clone() for k, v in nu.items()}, count)
                for mu, nu, count in snapshots[-1]["adam"]]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            _, deltas = tlt.eval_elo(mgr, EVAL_STEPS,
                                     torch.zeros((1,), dtype=torch.int32),
                                     torch.zeros((1,), dtype=torch.int32))
        elos = population.mmr.elo.clone()
        before = [{k: v.detach().clone() for k, v in
                   population[p].actor_critic.named_parameters()}
                  for p in range(NUM_POLICIES)]
        # The cull's mutation explores lr from JAX's mutate key.
        j_rng = jax_run["evaluated"].state.pbt_rng
        mutate = random.split(random.split(j_rng)[1], 1)[0]
        queues["uniform"].keys.append(random.split(mutate, 3)[0])
        gens = [ts.generator for ts in mgr.state.train_states]
        tlt.update_population(mgr)
    finally:
        mp.undo()
    return dict(mgr=mgr, lrs=lrs, collected=collected, snapshots=snapshots,
                deltas=deltas, elos=elos, before=before, gens=gens,
                queues=queues, hook=hook_records)


def test_hyperparameters_drawn_as_jax(jax_run, torch_run):
    hp = jax_run["mgrs"][0].state.train_states.hyper_params
    want = [hyper_params(hp, p)["lr"] for p in range(NUM_TRAIN)]
    np.testing.assert_allclose(torch_run["lrs"], want, rtol=1e-6)
    assert len(set(torch_run["lrs"])) == NUM_TRAIN


@pytest.mark.parametrize("update", [0, 1])
def test_rollout_data_matches_jax(jax_run, torch_run, update):
    got = dict(_leaves({k: v for k, v in
                        torch_run["collected"][update].items()
                        if k != "rnn_start_states"}))
    want = dict(_leaves(jax_run["data"][update]))
    assert sorted(got) == sorted(want)
    rtol, atol = F32_TOL["data"]
    for name, w in want.items():
        g = _np(got[name])
        assert g.shape == np.shape(w), name
        if name in ("dones", "actions/move", "rewards"):
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
        else:
            np.testing.assert_allclose(g, np.asarray(w), rtol=rtol,
                                       atol=atol, err_msg=name)


@pytest.mark.parametrize("update", [0, 1])
def test_parameters_and_optimizer_match_jax(jax_run, torch_run, update):
    snap = torch_run["snapshots"][update]
    j_mgr = jax_run["mgrs"][update + 1]
    adam = _adam(j_mgr)
    for p in range(NUM_POLICIES):
        want = _policy_params(j_mgr.state.policy_states.params, p)
        got = snap["params"][p]
        assert sorted(got) == sorted(want)
        for name, w in want.items():
            g = _np(got[name])
            if p >= NUM_TRAIN:
                # Past policies do not learn.
                np.testing.assert_array_equal(g, w, err_msg=name)
                continue
            # Adam's first steps are about lr * sign(g): where a gradient
            # is near 0 the sign may differ and the entry moves up to
            # 2 lr the other way (this policy's lr).
            lr = torch_run["lrs"][p]
            np.testing.assert_allclose(g, w, rtol=0, atol=2 * lr + 1e-5,
                                       err_msg=f"policy {p} {name}")
            close = np.isclose(g, w, rtol=F32_TOL["close"][0],
                               atol=F32_TOL["close"][1])
            assert close.mean() > 0.99, (p, name, close.mean())
        if p >= NUM_TRAIN:
            continue
        mu, nu, count = snap["adam"][p]
        # Two minibatches of 10 of the 20 sequences an update.
        assert count == int(np.asarray(adam.count)[p]) == 2 * (update + 1)
        j_mu, j_nu = _policy_params(adam.mu, p), _policy_params(adam.nu, p)
        for name in j_mu:
            np.testing.assert_allclose(_np(mu[name]), j_mu[name],
                                       rtol=F32_TOL["mu"][0],
                                       atol=F32_TOL["mu"][1],
                                       err_msg=f"policy {p} mu {name}")
            np.testing.assert_allclose(_np(nu[name]), j_nu[name],
                                       rtol=F32_TOL["nu"][0],
                                       atol=F32_TOL["nu"][1],
                                       err_msg=f"policy {p} nu {name}")


# Recorded outside the per-policy learn step, from the [P, ...] rollout data.
ROLLOUT_METRICS = ("Rewards", "Values", "Est Returns", "Bootstrap Values",
                   "Advantages", "Env Returns")
ROLLOUT_DATA = {"Rewards": "rewards", "Values": "values",
                "Est Returns": "returns", "Advantages": "advantages"}


def test_metrics_match_jax(jax_run, torch_run):
    """The learn step's metrics for every policy; the rollout's for the
    last policy (see the next test), and for each policy against its own
    rollout data."""
    for update in (0, 1):
        got = torch_run["snapshots"][update]["metrics"]
        j_metrics = jax_run["mgrs"][update + 1].metrics.metrics
        assert sorted(got) == sorted(j_metrics)
        for name, m in j_metrics.items():
            rows = slice(-1, None) if name in ROLLOUT_METRICS else slice(None)
            np.testing.assert_allclose(
                _np(got[name])[rows], np.asarray(m.mean)[rows, -1],
                rtol=F32_TOL["metrics"][0], atol=F32_TOL["metrics"][1],
                err_msg=name)
        data = torch_run["collected"][update]
        for name, key in ROLLOUT_DATA.items():
            want = data[key].reshape(NUM_TRAIN, -1).mean(dim=1)
            torch.testing.assert_close(got[name][:, 0] if got[name].dim() > 1
                                       else got[name], want, rtol=1e-6,
                                       atol=1e-6, msg=name)
        for stats in torch_run["snapshots"][update]["stats"]:
            # The update's first minibatch scores the rollout's policy.
            assert float(stats["max_abs_ratio_dev"]) < 1e-5


def test_jax_rollout_metrics_keep_only_the_last_policy(jax_run, torch_run):
    """A fault of the JAX package that the port does not copy: outside the
    vmapped learn step, ``TrainingMetrics.record`` / ``update_metrics``
    write ``x.at[:, cur_buffer_offset]`` with the [P] offset vector, so
    every policy's slot of a rollout metric holds the last policy's value.
    The port records each train policy's own."""
    got = torch_run["snapshots"][0]["metrics"]
    j_metrics = jax_run["mgrs"][1].metrics.metrics
    for name in ROLLOUT_METRICS:
        want = np.asarray(j_metrics[name].mean)[:, -1]
        assert (want == want[-1]).all(), name
        # Every episode ends at the last step here, so the bootstrap obs
        # are zeros and every policy's bootstrap value is its critic bias.
        if name != "Bootstrap Values":
            assert np.ptp(_np(got[name])) > 0, name


def test_eval_elo_matches_jax(jax_run, torch_run):
    want = np.asarray(jax_run["evaluated"].state.policy_states.mmr.elo)
    got = _np(torch_run["elos"])
    assert got[0] == 1500.0 and want[0] == 1500.0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    np.testing.assert_allclose(_np(torch_run["deltas"]),
                               np.asarray(jax_run["deltas"]), rtol=0,
                               atol=1500 * 1e-5)
    assert np.ptp(want) > 0.1, "the tournament moved no rating"


def test_update_population_matches_jax(jax_run, torch_run):
    j_before = jax_run["evaluated"].state.policy_states.params
    j_after = jax_run["evolved"].state.policy_states.params
    want_copies = []
    for dst in range(NUM_POLICIES):
        a, b = _policy_params(j_after, dst), _policy_params(j_before, dst)
        if any(not np.array_equal(a[k], b[k]) for k in a):
            src = [s for s in range(NUM_POLICIES) if all(
                np.array_equal(a[k], _policy_params(j_before, s)[k])
                for k in a)]
            want_copies.append((src[0], dst))
    mgr = torch_run["mgr"]
    assert mgr.population_copies == want_copies
    assert want_copies, "no copy to check"
    population = mgr.state.policy_states
    evolved = jax_run["evolved"].state
    for src, dst in mgr.population_copies:
        # The past snapshot may read the cull's destination: a source is
        # compared as it stood after the copies before its own.
        source = (torch_run["before"][src] if src not in
                  [d for _, d in mgr.population_copies] else
                  dict(population[src].actor_critic.named_parameters()))
        for name, p in population[dst].actor_critic.named_parameters():
            torch.testing.assert_close(p, source[name], rtol=0, atol=0)
        if dst < NUM_TRAIN:
            ts = mgr.state.train_states[dst]
            assert ts.generator is torch_run["gens"][dst]
            np.testing.assert_allclose(
                _np(ts.hyper_params.lr),
                hyper_params(evolved.train_states.hyper_params, dst)["lr"],
                rtol=1e-6)
    np.testing.assert_array_equal(_np(population.mmr.elo),
                                  fitness(evolved.policy_states)["elo"])
    assert reward_hyper_params(evolved.policy_states) is None
    assert population.reward_hyper_params is None
    queues = torch_run["queues"]
    assert not queues["steps"] and not queues["randints"]
    assert not queues["perms"]


def test_optimize_metrics_hook_sees_each_step_as_jax(jax_run, torch_run):
    """The ``optimize_metrics`` hook after every minibatch's step, on both
    learn paths: each train policy's middle critic bias entry as the step
    left it (within the parameter test's tolerance of JAX's: 2 lr) and its
    Adam count, one more each call (1 to 4 over the two updates of two
    minibatches), as JAX's hook sees them."""
    got = {}
    for p, bias, count in torch_run["hook"]:
        got.setdefault(p, []).append((bias, count))
    want = {}
    # JAX calls the hook inside its vmap over the train policies: each
    # minibatch's calls come in policy order.
    for i, (bias, count) in enumerate(jax_run["hook"]):
        want.setdefault(i % NUM_TRAIN, []).append((bias, count))
    assert sorted(got) == sorted(want) == list(range(NUM_TRAIN))
    for p in range(NUM_TRAIN):
        assert [c for _, c in got[p]] == [c for _, c in want[p]] == [
            1, 2, 3, 4]
        lr = torch_run["lrs"][p]
        np.testing.assert_allclose([b for b, _ in got[p]],
                                   [b for b, _ in want[p]], rtol=0,
                                   atol=2 * lr + 1e-5, err_msg=f"policy {p}")
        # Each record is the step's own: the bias moves every minibatch.
        assert len({b for b, _ in got[p]}) == 4, got[p]
