"""The flagship actor-critic in the port against the JAX package.

The flagship (``__graft_entry__.py``) is EntitySelfAttentionNet -> LSTM ->
a [5, 3] dict actor and the DreamerV3 two-hot critic, over ``self`` /
``allies`` / ``enemies`` entity observations. The JAX package has no
simulator that emits entity sets, so these tests wrap the toy gridworld,
as tests/test_hooks_and_entity_net.py does: with f = concat(delta, time),
``self = f @ A_self`` and each ally / enemy row is ``f @ A[j]``, the
matrices drawn once from numpy.

A tiny configuration (entity net 16 -> 32 with 2 heads, LSTM 32, 16 worlds,
T=8 in 2 BPTT chunks, float32, ``dreamer_v3_critic=True``) is built in both
packages, as tests/test_torch_slice.py does for the headline model: the
port gets the JAX run's parameters and start state, its action sampler
returns the JAX run's recorded actions (in this test only), and two
update_iter calls must give equal rollout data, gradients, parameters and
optimizer state. The JAX attention takes its CPU route (flax's masked
``dot_product_attention``); tests/test_torch_attention.py holds the port
against the Pallas route too. ``run_jax`` / ``run_torch`` and the three
``check_*`` functions take the entity counts, so that
tests/test_torch_mha_flash.py runs the same two updates over a set large
enough for ``mha_flash``.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import FrozenDict
from jax import random

import madrona_learn_tpu as mlt
import madrona_learn_tpu.models as jm
import madrona_learn_tpu_torch as tlt
import madrona_learn_tpu_torch.models as tm
import madrona_learn_tpu_torch.ops.dists as t_dists
import madrona_learn_tpu_torch.train as t_train
from madrona_learn_tpu.envs import ToyEnvConfig as JaxToyEnvConfig
from madrona_learn_tpu.envs import make_toy_env as jax_make_toy_env
from madrona_learn_tpu.rollouts import RolloutManager as JaxRolloutManager
from madrona_learn_tpu.train import TrainHooks as JaxTrainHooks
from madrona_learn_tpu_torch.compat.from_jax import actor_critic_state_dict
from madrona_learn_tpu_torch.config import DiscreteActionsConfig
from madrona_learn_tpu_torch.envs import ToyEnvConfig, make_toy_env
from madrona_learn_tpu_torch.rollouts import RolloutManager
from test_torch_models import _torch_actor_critic
from test_torch_slice import _adam_state, _flat_state, _leaves

torch.set_num_threads(1)

W, STEPS, CHUNKS, LR, SEED = 16, 8, 2, 1e-3, 11
EMBED, OUT, HEADS, HIDDEN = 16, 32, 2, 32
ENV = dict(num_worlds=W, episode_len=5, grid_size=5, seed=SEED)
OBS_FEATURES = {"self": 16, "allies": 12, "enemies": 12}
BUCKETS = [5, 3]


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
    return np.asarray(x)


def _entity_mats(allies, enemies):
    rng = np.random.default_rng(0)
    scale = np.float32(3 ** -0.5)
    return [(rng.standard_normal(shape) * scale).astype(np.float32)
            for shape in ((3, 16), (allies, 3, 12), (enemies, 3, 12))]


def _jax_entity_env(base, allies=5, enemies=6):
    a_self, a_ally, a_enemy = (jnp.asarray(m)
                               for m in _entity_mats(allies, enemies))

    def wrap(obs):
        f = jnp.concatenate([obs["delta"], obs["time"]], axis=-1)
        return FrozenDict({
            "self": f @ a_self,
            "allies": jnp.einsum("bf,jfe->bje", f, a_ally),
            "enemies": jnp.einsum("bf,jfe->bje", f, a_enemy)})

    def init_fn():
        out = base["init"]()
        return {"state": out["state"], "obs": wrap(out["obs"])}

    def step_fn(step_input):
        out = dict(base["step"](step_input))
        out["obs"] = wrap(out["obs"])
        return out

    return {"init": init_fn, "step": step_fn}


def _torch_entity_env(base, allies=5, enemies=6):
    a_self, a_ally, a_enemy = (torch.from_numpy(m)
                               for m in _entity_mats(allies, enemies))

    def wrap(obs):
        f = torch.cat([obs["delta"], obs["time"]], dim=-1)
        return {"self": f @ a_self,
                "allies": torch.einsum("bf,jfe->bje", f, a_ally),
                "enemies": torch.einsum("bf,jfe->bje", f, a_enemy)}

    def init_fn():
        out = base["init"]()
        return {"state": out["state"], "obs": wrap(out["obs"])}

    def step_fn(step_input):
        out = dict(base["step"](step_input))
        out["obs"] = wrap(out["obs"])
        return out

    return {"init": init_fn, "step": step_fn}


def _jax_flagship(dtype):
    actions = mlt.DiscreteActionsConfig(actions_num_buckets=BUCKETS)
    return jm.ActorCritic(
        backbone=jm.BackboneShared(
            prefix=lambda obs, train: obs,
            encoder=jm.RecurrentBackboneEncoder(
                net=jm.EntitySelfAttentionNet(
                    num_embed_channels=EMBED, num_out_channels=OUT,
                    num_heads=HEADS, dtype=dtype),
                rnn=jm.LSTM(num_hidden_channels=HIDDEN, num_layers=1,
                            dtype=dtype, use_pallas=True))),
        actor=jm.DictActor(heads={"move": jm.DenseLayerDiscreteActor(
            cfg=actions, dtype=dtype)}),
        critic=jm.DreamerV3Critic(dtype=dtype))


def _torch_flagship(dtype):
    return tm.ActorCritic(
        backbone=tm.BackboneShared(
            prefix=lambda obs: obs,
            encoder=tm.RecurrentBackboneEncoder(
                net=tm.EntitySelfAttentionNet(OBS_FEATURES, EMBED, OUT,
                                              HEADS, dtype),
                rnn=tm.LSTM(OUT, HIDDEN, 1, dtype))),
        actor=tm.DictActor({"move": tm.DenseLayerDiscreteActor(
            DiscreteActionsConfig(actions_num_buckets=BUCKETS), HIDDEN,
            dtype)}),
        critic=tm.DreamerV3Critic(HIDDEN, dtype))


def _algo(cfg_mod):
    return cfg_mod.PPOConfig(num_epochs=1, minibatch_size=W * CHUNKS,
                             clip_coef=0.2, value_loss_coef=0.5,
                             entropy_coef=0.01, max_grad_norm=0.5)


def _jax_config():
    return mlt.TrainConfig(
        num_worlds=W, num_agents_per_world=1, num_updates=2,
        actions={"move": mlt.DiscreteActionsConfig(
            actions_num_buckets=BUCKETS)},
        steps_per_update=STEPS, num_bptt_chunks=CHUNKS, lr=LR, gamma=0.99,
        gae_lambda=0.95, seed=SEED, metrics_buffer_size=1, algo=_algo(mlt),
        dreamer_v3_critic=True, compute_advantages=True)


def _torch_config(**kwargs):
    return tlt.TrainConfig(
        num_worlds=W, num_agents_per_world=1,
        actions={"move": tlt.DiscreteActionsConfig(
            actions_num_buckets=BUCKETS)},
        steps_per_update=STEPS, num_bptt_chunks=CHUNKS, lr=LR, gamma=0.99,
        gae_lambda=0.95, seed=SEED, metrics_buffer_size=1, algo=_algo(tlt),
        **kwargs)


def _torch_manager(actor_critic, cfg=None, dev="cpu", allies=5, enemies=6):
    return tlt.init_training(
        dev, cfg or _torch_config(),
        _torch_entity_env(make_toy_env(ToyEnvConfig(**ENV), device="cpu"),
                          allies, enemies),
        tlt.Policy(actor_critic), torch.zeros((1,), dtype=torch.int32))


def test_entry_points_default_to_the_card(monkeypatch):
    """make_toy_env and init_training build on the CUDA card unless the
    caller asks for another device; nothing falls back to the CPU."""
    assert inspect.signature(make_toy_env).parameters["device"].default \
        == "cuda"
    assert t_train.resolve_device(None) == torch.device("cuda")
    assert t_train.resolve_device("cpu") == torch.device("cpu")
    seen = []

    def resolve(dev):
        seen.append(dev)
        return torch.device("cpu")

    monkeypatch.setattr(t_train, "resolve_device", resolve)
    mgr = _torch_manager(_torch_flagship(torch.float32), dev=None)
    assert seen == [None]
    assert mgr.rollout.sim_ctrl.device.type == "cpu"
    if not torch.cuda.is_available():
        # Without a card, torch raises rather than building on the CPU.
        with pytest.raises((AssertionError, RuntimeError)):
            make_toy_env(ToyEnvConfig(num_worlds=4))["init"]()


def test_scalar_critic_with_the_distributional_flag_raises():
    actor_critic = _torch_actor_critic(torch.float32, 32)
    mgr = tlt.init_training(
        "cpu", tlt.TrainConfig(
            num_worlds=W, num_agents_per_world=1,
            actions={"move": tlt.DiscreteActionsConfig(
                actions_num_buckets=[5])},
            steps_per_update=STEPS, num_bptt_chunks=CHUNKS, lr=LR,
            gamma=0.99, seed=SEED, metrics_buffer_size=1, algo=_algo(tlt)),
        make_toy_env(ToyEnvConfig(**ENV), device="cpu"),
        tlt.Policy(actor_critic), torch.zeros((1,), dtype=torch.int32))
    assert mgr.cfg.dreamer_v3_critic  # the JAX package's default
    with pytest.raises(TypeError, match="dreamer_v3_critic"):
        mgr.update_iter()


def _obs(rng, *lead):
    return {"self": rng.normal(size=(*lead, 16)).astype(np.float32),
            "allies": rng.normal(size=(*lead, 5, 12)).astype(np.float32),
            "enemies": rng.normal(size=(*lead, 6, 12)).astype(np.float32)}


def test_converted_flagship_matches_flax():
    """JAX flagship parameters, converted by compat.from_jax, give the same
    rollout step, critic and update pass (with gradients) in the port."""
    rng = np.random.default_rng(5)
    N, T = 12, 5
    ac_j = _jax_flagship(jnp.float32)
    obs = _obs(rng, N)
    j_obs = FrozenDict({k: jnp.asarray(v) for k, v in obs.items()})
    params = ac_j.init(random.PRNGKey(1), random.PRNGKey(0),
                       ac_j.init_recurrent_state(N), j_obs,
                       method="rollout")["params"]
    # Non-zero critic head and biases, so the checks see them.
    params = jax.tree_util.tree_map_with_path(
        lambda path, p: (p + 0.1 * jnp.asarray(rng.normal(size=p.shape),
                                               jnp.float32)
                         if path[-1].key == "bias"
                         or path[0].key == "critic" else p), params)
    ac_t = _torch_flagship(torch.float32)
    ac_t.load_state_dict({k: torch.from_numpy(v) for k, v in
                          actor_critic_state_dict(params).items()})
    tol = dict(rtol=1e-4, atol=1e-5)

    c0 = rng.normal(size=(N, 1, HIDDEN)).astype(np.float32)
    h0 = rng.normal(size=(N, 1, HIDDEN)).astype(np.float32)
    out_j, rnn_j = ac_j.apply({"params": params}, random.PRNGKey(0),
                              (jnp.asarray(c0), jnp.asarray(h0)), j_obs,
                              sample_actions=False, method="rollout")
    with torch.no_grad():
        out_t, rnn_t = ac_t.rollout(
            None, (torch.from_numpy(c0), torch.from_numpy(h0)),
            {k: torch.from_numpy(v) for k, v in obs.items()},
            sample_actions=False)
    np.testing.assert_array_equal(_np(out_t["actions"]["move"]),
                                  np.asarray(out_j["actions"]["move"]))
    np.testing.assert_allclose(_np(out_t["critic"].mean()),
                               np.asarray(out_j["critic"].mean()), **tol)
    for got, want in zip(rnn_t, rnn_j):
        np.testing.assert_allclose(_np(got), np.asarray(want), **tol)

    seq_obs = _obs(rng, T, N)
    dones = rng.random((T, N, 1)) < 0.2
    actions = np.stack([rng.integers(0, 5, (T, N)),
                        rng.integers(0, 3, (T, N))], axis=-1).astype(np.int32)
    returns = rng.normal(0, 3, size=(T, N, 1)).astype(np.float32)

    def loss_j(p):
        out = ac_j.apply({"params": p}, (jnp.asarray(c0), jnp.asarray(h0)),
                         jnp.asarray(dones), {"move": jnp.asarray(actions)},
                         FrozenDict({k: jnp.asarray(v)
                                     for k, v in seq_obs.items()}),
                         method="update")
        return (jnp.sum(out["log_probs"]["move"])
                + jnp.sum(out["entropies"]["move"])
                + jnp.sum(out["critic"].two_hot_cross_entropy_loss(
                    jnp.asarray(returns)))), out

    (lj, out_j), g_j = jax.value_and_grad(loss_j, has_aux=True)(params)
    out_t = ac_t.update((torch.from_numpy(c0), torch.from_numpy(h0)),
                        torch.from_numpy(dones),
                        {"move": torch.from_numpy(actions)},
                        {k: torch.from_numpy(v) for k, v in seq_obs.items()})
    lt = (out_t["log_probs"]["move"].sum() + out_t["entropies"]["move"].sum()
          + out_t["critic"].two_hot_cross_entropy_loss(
              torch.from_numpy(returns)).sum())
    assert out_t["critic"].logits.shape == (T, N, 63)
    for key in ("log_probs", "entropies"):
        np.testing.assert_allclose(_np(out_t[key]["move"]),
                                   np.asarray(out_j[key]["move"]), **tol)
    np.testing.assert_allclose(_np(out_t["critic"].mean()),
                               np.asarray(out_j["critic"].mean()), **tol)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)

    names, tensors = zip(*ac_t.named_parameters())
    g_t = dict(zip(names, torch.autograd.grad(lt, tensors)))
    g_want = actor_critic_state_dict(g_j)
    assert sorted(g_t) == sorted(g_want)
    for name, want in g_want.items():
        np.testing.assert_allclose(_np(g_t[name]), want, rtol=1e-4,
                                   atol=1e-5, err_msg=name)


# The critic's starting bias: logits fall off as -|i - 31| from the middle
# bin. The zero init gives a uniform distribution whose mean is exactly 0
# only if every mirrored pair p_i * b_i cancels; under jit, XLA's CPU
# backend fuses and contracts those products (rounding the pair's halves
# differently), and the bins reach 1.2e6, so the JAX package's mean there
# carries an error near 2e-4 that the eager port does not make. With the
# mass on the middle bins both packages compute the mean to f32 rounding.
# tests/test_torch_attention.py checks the exact 0 at zero logits.
CRITIC_BIAS = -np.abs(np.arange(63) - 31).astype(np.float32)


def run_jax(allies=5, enemies=6):
    """Two JAX updates of the tiny flagship over ``allies`` and ``enemies``
    entity rows, with the rollout data each one trained on."""
    cfg = _jax_config()
    policy = mlt.Policy(actor_critic=_jax_flagship(jnp.float32))
    mgr = mlt.init_training(
        None, cfg, _jax_entity_env(jax_make_toy_env(JaxToyEnvConfig(**ENV)),
                                   allies, enemies),
        policy, init_sim_ctrl=jnp.zeros((1,), jnp.int32))
    params = jax.tree_util.tree_map_with_path(
        lambda path, p: (jnp.broadcast_to(jnp.asarray(CRITIC_BIAS), p.shape)
                         if [k.key for k in path[-3:]]
                         == ["critic", "Dense_0", "bias"] else p),
        mgr.state.policy_states.params)
    mgr = mgr.replace(state=mgr.state.replace(
        policy_states=mgr.state.policy_states.replace(params=params)))
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
    """[P, B*C, T/C, heads] b-major training rows -> the per-step, per-head
    [B, 1] samples in the order the port's sampler draws them."""
    a = np.asarray(data["actions"]["move"])
    P, BC, TC, heads = a.shape
    a = a.reshape(P, BC // CHUNKS, CHUNKS, TC, heads).transpose(2, 3, 0, 1, 4)
    return [torch.from_numpy(a[c, t, 0, :, h:h + 1].astype(np.int64))
            for c in range(CHUNKS) for t in range(TC) for h in range(heads)]


def run_torch(jax_run, allies=5, enemies=6):
    """The same two updates in the port, from the JAX run's parameters and
    start state, with its recorded actions."""
    jax_mgrs, jax_data = jax_run
    j0 = jax_mgrs[0]
    actor_critic = _torch_flagship(torch.float32)
    actor_critic.load_state_dict({
        k: torch.from_numpy(v)
        for k, v in _flat_state(j0.state.policy_states.params).items()})
    assert (actor_critic.critic.Dense_0.bias.detach().numpy()
            == CRITIC_BIAS).all()
    mgr = _torch_manager(actor_critic, allies=allies, enemies=enemies)
    # Inject the JAX start state.
    mgr.rollout.sim_state = {k: torch.from_numpy(np.array(v))
                             for k, v in j0.rollout.sim_state.items()}
    mgr.rollout.cur_obs = {k: torch.from_numpy(np.array(v))
                           for k, v in j0.rollout.cur_obs.items()}

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
                "metrics": {name: mgr.metrics.latest(name).mean.clone()
                            for name in mgr.metrics.metrics},
            })
    finally:
        mp.undo()
    assert not queue
    return collected, snapshots


@pytest.fixture(scope="module")
def jax_run():
    return run_jax()


@pytest.fixture(scope="module")
def torch_run(jax_run):
    return run_torch(jax_run)


@pytest.mark.parametrize("update", [0, 1])
def test_flagship_rollout_data_matches_jax(jax_run, torch_run, update):
    check_rollout_data(jax_run, torch_run, update)


@pytest.mark.parametrize("update", [0, 1])
def test_flagship_gradients_and_optimizer_state_match_jax(jax_run, torch_run,
                                                          update):
    check_gradients_and_optimizer_state(jax_run, torch_run, update)


@pytest.mark.parametrize("update", [0, 1])
def test_flagship_parameters_and_metrics_match_jax(jax_run, torch_run,
                                                   update):
    check_parameters_and_metrics(jax_run, torch_run, update)


def check_rollout_data(jax_run, torch_run, update):
    got = dict(_leaves(torch_run[0][update]))
    want = dict(_leaves(jax_run[1][update]))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = _np(got[name])
        assert g.shape == np.shape(w), name
        if name in ("dones", "actions/move", "rewards"):
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
        else:
            # Same float32 math on the same inputs; products and reductions
            # sum in another order, and the second update's inputs carry
            # the first update's last-bit parameter differences.
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4,
                                       atol=1e-5, err_msg=name)


def check_gradients_and_optimizer_state(jax_run, torch_run, update):
    snap = torch_run[1][update]
    adam = _adam_state(jax_run[0][update + 1])
    assert snap["count"] == int(np.asarray(adam.count)[0]) == update + 1
    mu = _flat_state(adam.mu)
    nu = _flat_state(adam.nu)
    assert sorted(mu) == sorted(snap["mu"])
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


def check_parameters_and_metrics(jax_run, torch_run, update):
    snap = torch_run[1][update]
    j_mgr = jax_run[0][update + 1]
    want = _flat_state(j_mgr.state.policy_states.params)
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
    for name in ("Loss", "Value Loss", "Value Errors", "Entropy", "Rewards",
                 "Advantages", "Est Returns", "Values"):
        np.testing.assert_allclose(
            _np(snap["metrics"][name]),
            np.asarray(j_mgr.metrics.metrics[name].mean)[:, -1],
            rtol=1e-4, atol=1e-5, err_msg=name)


def test_flagship_rollout_log_probs_equal_update_log_probs():
    """At the rollout's weights the update pass recomputes the recorded
    log-probs and values: PPO's ratio starts at 1."""
    actor_critic = _torch_flagship(torch.float32)
    mgr = _torch_manager(actor_critic)
    hooks = tlt.TrainHooks()
    data, _ = mgr.rollout_mgr.collect(
        mgr.state, mgr.rollout, mgr.metrics, hooks.start_rollouts,
        hooks.finish_rollouts, hooks.rollout_metrics)
    data = data.policy(0)
    assert data.all()["obs"]["allies"].shape == (W * CHUNKS, STEPS // CHUNKS,
                                                 5, 12)
    mb = data.minibatch(torch.arange(W * CHUNKS))
    with torch.no_grad():
        out = actor_critic.update(mb["rnn_start_states"], mb["dones"],
                                  mb["actions"], mb["obs"])
    np.testing.assert_allclose(_np(out["log_probs"]["move"]),
                               _np(mb["log_probs"]["move"]), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(_np(out["critic"].mean()), _np(mb["values"]),
                               rtol=1e-4, atol=1e-5)
