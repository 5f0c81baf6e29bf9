"""The value side of PPO: the port against the JAX package.

- The value normalizer: ``EMANormalizer.invert`` and
  ``normalize_and_update_estimates`` over 5 successive batches.
- The dense critic's value loss term by term against JAX's (``jnp.clip``
  in normalized space, ``optax.huber_loss`` / ``optax.l2_loss``, the
  normalizer inverted and updated), with inputs that put the prediction
  on both sides of the clip range and the error in both regions of the
  Huber loss, and its gradient against ``jax.grad``.
- The refused combinations: a distributional critic (DreamerV3 or
  HL-Gauss) with value clipping, the Huber value loss or value
  normalization raises in both packages.
- Two ``update_iter`` calls in both packages, as ``tests/test_torch_slice.py``
  runs them (the same size, the JAX run's parameters, start state and
  obs-normalizer state given to the port, its actions replayed by a sampler
  patched in this test only), for five configurations
  (``check_two_update_iters``; the two HL-Gauss ones run from
  ``tests/test_torch_hlgauss.py``):
  - ``valuenorm``: value normalization, the clipped value loss and the
    Huber loss;
  - ``hlgauss``: ``HLGaussCritic``;
  - ``hlgauss_twopart``: ``HLGaussTwoPartCritic``;
  - ``returns``: ``compute_advantages=False`` with z-scored returns, so no
    GAE;
  - ``entropy_weights``: two action heads, one with entropy weight 0.5,
    and advantages not z-scored.
  Rollout data (the JAX side's read by a hook inside the jitted update),
  gradients (Adam's first moment), parameters, optimizer state, metrics
  and the value normalizer's state must agree at the slice test's
  tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import madrona_learn_tpu as mlt
import madrona_learn_tpu.models as jm
import madrona_learn_tpu_torch as tlt
import madrona_learn_tpu_torch.models as tm
import madrona_learn_tpu_torch.ops.dists as t_dists
from madrona_learn_tpu.envs import ToyEnvConfig as JaxToyEnvConfig
from madrona_learn_tpu.envs import make_toy_env as jax_make_toy_env
from madrona_learn_tpu.ops import ema as jax_ema
from madrona_learn_tpu.ppo import PPO as JaxPPO
from madrona_learn_tpu.train import TrainHooks as JaxTrainHooks
from madrona_learn_tpu_torch.compat.from_jax import (
    ema_state,
    obs_preprocess_state,
    policy_slice,
)
from madrona_learn_tpu_torch.config import DiscreteActionsConfig
from madrona_learn_tpu_torch.envs import ToyEnvConfig, make_toy_env
from madrona_learn_tpu_torch.ops import ema
from madrona_learn_tpu_torch.ppo import PPO, _value_loss
from madrona_learn_tpu_torch.rollouts import RolloutManager
from test_torch_slice import (
    CHUNKS,
    ENV,
    LR,
    SEED,
    STEPS,
    W,
    H,
    _adam_state,
    _flat_state,
    _leaves,
    _np,
)

torch.set_num_threads(1)

DECAY = 0.99


def _batches(seed=0, n=5):
    """5 batches [T, N, 1] of returns-like data, mean and spread drifting."""
    rng = np.random.default_rng(seed)
    return [(rng.normal(loc=2.0 * i - 3.0, scale=1.0 + i, size=(8, 24, 1))
             .astype(np.float32)) for i in range(n)]


def test_value_normalizer_matches_jax():
    j_norm = jax_ema.EMANormalizer(decay=DECAY, norm_dtype=jnp.float32,
                                   inv_dtype=jnp.float32)
    t_norm = ema.EMANormalizer(decay=DECAY, norm_dtype=torch.float32)
    batches = _batches()
    j_est = j_norm.init_estimates(jnp.asarray(batches[0]))
    t_est = t_norm.init_estimates(torch.from_numpy(batches[0]))
    probe = np.random.default_rng(1).normal(size=(40, 1)).astype(np.float32)
    for i, x in enumerate(batches):
        # invert with the estimates before the update, as the rollout does.
        np.testing.assert_allclose(
            _np(t_norm.invert(t_est, torch.from_numpy(probe))),
            np.asarray(j_norm.invert(j_est, jnp.asarray(probe))),
            rtol=1e-6, atol=1e-6, err_msg=f"invert {i}")
        j_est, j_out = j_norm.normalize_and_update_estimates(
            j_est, jnp.asarray(x))
        t_est, t_out = t_norm.normalize_and_update_estimates(
            t_est, torch.from_numpy(x))
        np.testing.assert_allclose(_np(t_out), np.asarray(j_out), rtol=1e-5,
                                   atol=1e-6, err_msg=f"normalized {i}")
        for name, w in ema_state(j_est).items():
            g = _np(t_est[name])
            assert g.dtype == w.dtype, name
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{name} {i}")
    assert int(t_est["N"]) == len(batches)
    # The new estimates normalize: the last batch comes out near zero mean.
    assert abs(float(t_out.mean())) < abs(float(batches[-1].mean()))


def test_invert_undoes_normalize():
    t_norm = ema.EMANormalizer(decay=DECAY, norm_dtype=torch.float32)
    x = torch.from_numpy(_batches(seed=2)[3])
    est, out = t_norm.normalize_and_update_estimates(
        t_norm.init_estimates(x), x)
    torch.testing.assert_close(t_norm.invert(est, out), x, rtol=1e-5,
                               atol=1e-5)


class _State:
    """The fields of the port's train state that ``_value_loss`` reads."""

    def __init__(self, value_normalizer, value_normalizer_state):
        self.value_normalizer = value_normalizer
        self.value_normalizer_state = value_normalizer_state
        self.hyper_params = PPO().init_hyperparams(_torch_cfg(
            dreamer_v3_critic=False))


@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("huber", [False, True])
@pytest.mark.parametrize("normalize", [False, True])
def test_dense_value_loss_matches_jax(clip, huber, normalize):
    """JAX's dense-critic branch (ppo.py's loss_fn) written with its own
    functions, against the port's ``_value_loss``: losses, value errors,
    the normalizer's new state and d(mean loss)/d(prediction)."""
    rng = np.random.default_rng(7)
    T, N = 4, 30
    returns = rng.normal(loc=3.0, scale=4.0, size=(T, N, 1)).astype(
        np.float32)
    old = rng.normal(size=(T, N, 1)).astype(np.float32)
    # Predictions up to 0.5 from the rollout's, across the clip range of
    # 0.2, and errors on both sides of the Huber loss's delta of 1.
    new = (old + rng.uniform(-0.5, 0.5, size=old.shape)).astype(np.float32)
    clip_coef = np.float32(0.2)

    j_norm = jax_ema.EMANormalizer(decay=DECAY, norm_dtype=jnp.float32,
                                   inv_dtype=jnp.float32)
    j_state = j_norm.init_estimates(jnp.zeros((1, 1), jnp.float32))
    if normalize:
        # A state away from the identity.
        j_state, _ = j_norm.normalize_and_update_estimates(
            j_state, jnp.asarray(returns[:2]))

    def jax_loss(new_values_norm):
        if normalize:
            value_errs = (j_norm.invert(j_state, new_values_norm)
                          - jnp.asarray(returns))
        else:
            value_errs = new_values_norm - jnp.asarray(returns)
        if clip:
            new_values_norm = jnp.clip(new_values_norm,
                                       jnp.asarray(old) - clip_coef,
                                       jnp.asarray(old) + clip_coef)
        if normalize:
            new_state, targets = j_norm.normalize_and_update_estimates(
                j_state, jnp.asarray(returns))
        else:
            new_state, targets = None, jnp.asarray(returns)
        losses = (optax.huber_loss(new_values_norm, targets) if huber
                  else optax.l2_loss(new_values_norm, targets))
        return jnp.mean(losses), (losses, value_errs, new_state)

    (_, (j_losses, j_errs, j_new_state)), j_grad = jax.value_and_grad(
        jax_loss, has_aux=True)(jnp.asarray(new))

    t_norm = ema.EMANormalizer(decay=DECAY, norm_dtype=torch.float32)
    t_state = ({k: torch.from_numpy(v) for k, v in ema_state(j_state).items()}
               if normalize else None)
    cfg = _torch_cfg(dict(clip_value_loss=clip, huber_value_loss=huber),
                     dreamer_v3_critic=False, normalize_values=normalize)
    t_new = torch.from_numpy(new).requires_grad_()
    mb = {"returns": torch.from_numpy(returns),
          "values": torch.from_numpy(old)}
    losses, errs, new_state = _value_loss(
        cfg, mb, t_new, _State(t_norm if normalize else None, t_state))
    (t_grad,) = torch.autograd.grad(losses.mean(), t_new)

    tol = dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(losses), np.asarray(j_losses), **tol)
    np.testing.assert_allclose(_np(errs), np.asarray(j_errs), **tol)
    np.testing.assert_allclose(_np(t_grad), np.asarray(j_grad), **tol)
    if normalize:
        for name, w in ema_state(j_new_state).items():
            np.testing.assert_allclose(_np(new_state[name]), w, **tol,
                                       err_msg=name)
    else:
        assert new_state is None
    if clip:
        # The clip range binds somewhere: those predictions get no
        # gradient.
        assert (np.abs(new - old) > clip_coef).any()
        assert (_np(t_grad)[np.abs(new - old) > clip_coef] == 0).all()


def _refusal_kwargs(critic, option):
    cfg = {"critic": dict(dreamer_v3_critic=critic == "dreamer",
                          hlgauss_critic=critic == "hlgauss")}
    algo = {}
    if option == "normalize_values":
        cfg["critic"]["normalize_values"] = True
    else:
        algo[option] = True
    return cfg["critic"], algo


def _jax_cfg(algo_kwargs=None, actions=None, **kwargs):
    return mlt.TrainConfig(
        num_worlds=W, num_agents_per_world=1, num_updates=2,
        actions=actions or {"move": mlt.DiscreteActionsConfig(
            actions_num_buckets=[5])},
        steps_per_update=STEPS, num_bptt_chunks=CHUNKS, lr=LR, gamma=0.99,
        gae_lambda=0.95, seed=SEED, metrics_buffer_size=1,
        algo=mlt.PPOConfig(num_epochs=1, minibatch_size=W * CHUNKS,
                           clip_coef=0.2, value_loss_coef=0.5,
                           entropy_coef=0.01, max_grad_norm=0.5,
                           **(algo_kwargs or {})),
        **kwargs)


def _torch_cfg(algo_kwargs=None, actions=None, **kwargs):
    return tlt.TrainConfig(
        num_worlds=W, num_agents_per_world=1,
        actions=actions or {"move": tlt.DiscreteActionsConfig(
            actions_num_buckets=[5])},
        steps_per_update=STEPS, num_bptt_chunks=CHUNKS, lr=LR, gamma=0.99,
        gae_lambda=0.95, seed=SEED, metrics_buffer_size=1,
        algo=tlt.PPOConfig(num_epochs=1, minibatch_size=W * CHUNKS,
                           clip_coef=0.2, value_loss_coef=0.5,
                           entropy_coef=0.01, max_grad_norm=0.5,
                           **(algo_kwargs or {})),
        **kwargs)


@pytest.mark.parametrize("critic", ["dreamer", "hlgauss"])
@pytest.mark.parametrize("option", ["clip_value_loss", "huber_value_loss",
                                    "normalize_values"])
def test_distributional_critic_refusals_match_jax(critic, option):
    cfg_kwargs, algo_kwargs = _refusal_kwargs(critic, option)
    with pytest.raises(AssertionError):
        JaxPPO().init_hyperparams(_jax_cfg(algo_kwargs, **cfg_kwargs))
    with pytest.raises(ValueError, match=option):
        PPO().init_hyperparams(_torch_cfg(algo_kwargs, **cfg_kwargs))


def test_scalar_critic_accepts_every_value_option():
    hp = PPO().init_hyperparams(_torch_cfg(
        dict(clip_value_loss=True, huber_value_loss=True),
        dreamer_v3_critic=False, normalize_values=True,
        value_normalizer_decay=0.9))
    assert hp.normalize_values and hp.value_normalizer_decay == 0.9


# The five configurations: TrainConfig and PPOConfig options, the critic,
# and whether the actor has a second action head ("aux", 3 buckets).
CONFIGS = {
    "valuenorm": dict(cfg=dict(normalize_values=True),
                      algo=dict(clip_value_loss=True,
                                huber_value_loss=True),
                      critic="dense"),
    "hlgauss": dict(cfg=dict(hlgauss_critic=True), algo={},
                    critic="hlgauss"),
    "hlgauss_twopart": dict(cfg=dict(hlgauss_critic=True), algo={},
                            critic="hlgauss_twopart"),
    "returns": dict(cfg=dict(compute_advantages=False,
                             normalize_returns=True),
                    algo={}, critic="dense"),
    "entropy_weights": dict(cfg=dict(normalize_advantages=False),
                            algo=dict(entropy_key_weights={"aux": 0.5}),
                            critic="dense", aux=True),
}


def _jax_model(spec):
    dtype = jnp.float32
    heads = {"move": jm.DenseLayerDiscreteActor(
        cfg=mlt.DiscreteActionsConfig(actions_num_buckets=[5]), dtype=dtype)}
    if spec.get("aux"):
        heads["aux"] = jm.DenseLayerDiscreteActor(
            cfg=mlt.DiscreteActionsConfig(actions_num_buckets=[3]),
            dtype=dtype)
    critic = {"dense": lambda: jm.DenseLayerCritic(dtype=dtype),
              "hlgauss": lambda: jm.HLGaussCritic.create(dtype=dtype),
              "hlgauss_twopart":
                  lambda: jm.HLGaussTwoPartCritic.create(dtype=dtype),
              }[spec["critic"]]()
    return jm.ActorCritic(
        backbone=jm.BackboneShared(
            prefix=lambda obs, train: jnp.concatenate(
                [obs["delta"], obs["time"]], axis=-1),
            encoder=jm.RecurrentBackboneEncoder(
                net=jm.MLP(num_channels=H, num_layers=2, dtype=dtype),
                rnn=jm.LSTM(num_hidden_channels=H, num_layers=1,
                            dtype=dtype, use_pallas=True))),
        actor=jm.DictActor(heads=heads),
        critic=critic)


def _torch_model(spec):
    dtype = torch.float32
    heads = {"move": tm.DenseLayerDiscreteActor(
        DiscreteActionsConfig(actions_num_buckets=[5]), H, dtype)}
    if spec.get("aux"):
        heads["aux"] = tm.DenseLayerDiscreteActor(
            DiscreteActionsConfig(actions_num_buckets=[3]), H, dtype)
    critic = {"dense": lambda: tm.DenseLayerCritic(H, dtype),
              "hlgauss": lambda: tm.HLGaussCritic.create(H, dtype),
              "hlgauss_twopart":
                  lambda: tm.HLGaussTwoPartCritic.create(H, dtype),
              }[spec["critic"]]()
    return tm.ActorCritic(
        backbone=tm.BackboneShared(
            prefix=lambda obs: torch.cat([obs["delta"], obs["time"]], -1),
            encoder=tm.RecurrentBackboneEncoder(
                net=tm.MLP(3, H, 2, dtype),
                rnn=tm.LSTM(H, H, 1, dtype))),
        actor=tm.DictActor(heads),
        critic=critic)


def _actions(pkg, spec):
    actions = {"move": pkg.DiscreteActionsConfig(actions_num_buckets=[5])}
    if spec.get("aux"):
        actions["aux"] = pkg.DiscreteActionsConfig(actions_num_buckets=[3])
    return actions


class _CaptureRollouts(JaxTrainHooks):
    """Hands each update's finished rollout data to the host from inside
    the jitted update (one compile, not a second one for a collect)."""

    def __init__(self, sink):
        self.sink = sink

    def rollout_metrics(self, metrics, rollouts, user_state):
        jax.debug.callback(
            lambda r: self.sink.append(jax.tree.map(np.asarray, r)),
            rollouts)
        return metrics


def _jax_run(spec):
    """Two JAX updates, with the rollout data each one trained on (all
    but the recurrent start states, which the hooks do not see; the update
    pass starts from them, so the gradients check them)."""
    cfg = _jax_cfg(spec["algo"], _actions(mlt, spec),
                   **dict(dict(dreamer_v3_critic=False), **spec["cfg"]))
    policy = mlt.Policy(
        actor_critic=_jax_model(spec),
        obs_preprocess=mlt.ObservationsEMANormalizer.create(
            decay=0.99999, dtype=jnp.float32))
    data = []
    mgr = mlt.init_training(None, cfg, jax_make_toy_env(JaxToyEnvConfig(
        **ENV)), policy, init_sim_ctrl=jnp.zeros((1,), jnp.int32),
        user_hooks=_CaptureRollouts(data))
    update = jax.jit(lambda m: m.update_iter())
    mgrs = [mgr]
    for _ in range(2):
        mgr = update(mgr)
        jax.block_until_ready(mgr)
        mgrs.append(mgr)
    jax.effects_barrier()
    assert len(data) == 2
    return mgrs, data


def _recorded_actions(data):
    """[P, B*C, T/C, heads] b-major training rows of every action key ->
    the per-step [B, 1] samples in the order the port's sampler draws
    them: keys sorted, then each key's heads."""
    per_key = {}
    for name, a in data["actions"].items():
        a = np.asarray(a)
        P, BC, TC, heads = a.shape
        per_key[name] = a.reshape(P, BC // CHUNKS, CHUNKS, TC,
                                  heads).transpose(2, 3, 0, 1, 4)
    TC = next(iter(per_key.values())).shape[1]
    return [torch.from_numpy(per_key[name][c, t, 0, :, h:h + 1]
                             .astype(np.int64))
            for c in range(CHUNKS) for t in range(TC)
            for name in sorted(per_key)
            for h in range(per_key[name].shape[-1])]


def _torch_run(spec, jax_run):
    """The same two updates in the port from the JAX run's start."""
    jax_mgrs, jax_data = jax_run
    j0 = jax_mgrs[0]
    actor_critic = _torch_model(spec)
    actor_critic.load_state_dict({
        k: torch.from_numpy(v)
        for k, v in _flat_state(j0.state.policy_states.params).items()})
    policy = tlt.Policy(actor_critic, tlt.ObservationsEMANormalizer.create(
        decay=0.99999, dtype=torch.float32))
    cfg = _torch_cfg(spec["algo"], _actions(tlt, spec),
                     **dict(dict(dreamer_v3_critic=False), **spec["cfg"]))
    mgr = tlt.init_training("cpu", cfg,
                            make_toy_env(ToyEnvConfig(**ENV), device="cpu"),
                            policy, torch.zeros((1,), dtype=torch.int32))
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
                "value_norm": (None if ts.value_normalizer_state is None
                               else {k: v.clone() for k, v in
                                     ts.value_normalizer_state.items()}),
                "metrics": {name: mgr.metrics.latest(name).mean.clone()
                            for name in mgr.metrics.metrics},
            })
    finally:
        mp.undo()
    assert not queue
    return collected, snapshots


def check_two_update_iters(name):
    """Two update_iters of configuration ``name`` in both packages."""
    spec = CONFIGS[name]
    jax_mgrs, jax_data = jax_run = _jax_run(spec)
    collected, snapshots = _torch_run(spec, jax_run)
    for update in (0, 1):
        _check_rollout_data(collected[update], jax_data[update])
        _check_optimizer(snapshots[update], jax_mgrs[update + 1], update)
        _check_parameters(snapshots[update], jax_mgrs[update + 1])
        _check_value_normalizer(snapshots[update], jax_mgrs[update + 1])
        _check_metrics(snapshots[update], jax_mgrs[update + 1])
    if name == "returns":
        assert "advantages" not in collected[0]
    if name == "valuenorm":
        # The normalizer moved, and the store keeps the critic's normalized
        # outputs, not the inverted values that GAE took.
        vn = snapshots[1]["value_norm"]
        assert int(vn["N"]) == 2 and float(vn["mu"].abs().max()) > 0


# The HL-Gauss configurations run in tests/test_torch_hlgauss.py.
@pytest.mark.parametrize("name", ["valuenorm", "returns", "entropy_weights"])
def test_two_update_iters_match_jax(name):
    check_two_update_iters(name)


def _check_rollout_data(got_tree, want_tree):
    got = dict(_leaves({k: v for k, v in got_tree.items()
                        if k != "rnn_start_states"}))
    want = dict(_leaves(want_tree))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = _np(got[name])
        assert g.shape == np.shape(w), name
        if name in ("dones", "rewards") or name.startswith("actions/"):
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
        else:
            # Same float32 math on the same inputs; products and reductions
            # sum in another order. The second update's inputs also carry
            # the first update's last-bit parameter differences.
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4,
                                       atol=1e-5, err_msg=name)


def _check_optimizer(snap, j_mgr, update):
    adam = _adam_state(j_mgr)
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


def _check_parameters(snap, j_mgr):
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


def _check_value_normalizer(snap, j_mgr):
    j_state = j_mgr.state.train_states.value_normalizer_state
    if j_state is None:
        assert snap["value_norm"] is None
        return
    want = ema_state(policy_slice(j_state))
    assert sorted(snap["value_norm"]) == sorted(want)
    for name, w in want.items():
        np.testing.assert_allclose(_np(snap["value_norm"][name]), w,
                                   rtol=1e-5, atol=1e-6,
                                   err_msg=f"value normalizer {name}")


def _check_metrics(snap, j_mgr):
    j_metrics = j_mgr.metrics.metrics
    assert sorted(snap["metrics"]) == sorted(j_metrics)
    for name, m in j_metrics.items():
        np.testing.assert_allclose(
            _np(snap["metrics"][name]), np.asarray(m.mean)[:, -1],
            rtol=1e-4, atol=1e-5, err_msg=name)
