"""Continuous actions: the port against the JAX package.

- ``ContinuousActionDistributions``: the log-prob of stored actions, the
  closed-form entropy, ``best()`` and a sample drawn from given noise,
  within 1e-6, on fixed raw means and stds of two heads.
- Two ``update_iter`` calls in both packages
  (``test_torch_advantage_side.run_two_update_iters``) of the slice
  test's MLP + LSTM trunk with a 2-dimensional ``ContinuousActionsConfig(
  0.05, 0.5, 2)`` head (``tests/test_train_variants.py``'s ``SteerActor``:
  one Dense to raw means and stds) over the toy gridworld behind that
  test's adapter (a coordinate past +-0.3 moves the agent). The port
  replays the JAX run's sampling noise.
- Importance sampling with a continuous head, in closed form (the hand-made
  linear policy of ``tests/test_ppo_weights.py`` with [T, mb, 1, dims]
  log-probs and entropies, non-uniform weights): the port's recorded loss
  is the per-trajectory weighted mean(w * x) within 1e-6. The JAX
  package's is mean(w) * mean(x) for the action and entropy terms (its
  [mb, 1] weights broadcast against [T, mb, 1, dims] to [T, mb, mb, dims]),
  also within 1e-6, and the two differ: this pins both.
"""

import flax.linen as nn
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
import madrona_learn_tpu_torch.ops.dists as t_dists
from madrona_learn_tpu.ops.dists import (
    ContinuousActionDistributions as JaxContinuous,
)
from madrona_learn_tpu_torch.models.common import Dense
from madrona_learn_tpu_torch.ops.dists import ContinuousActionDistributions
from test_ppo_weights import MB as WMB
from test_ppo_weights import N as WN
from test_ppo_weights import T as WT
from test_ppo_weights import _make_cfg as _jax_weights_cfg
from test_ppo_weights import _make_states_and_data, _run_ppo
from test_torch_advantage_side import (
    F32_TOL,
    _patch_draws,
    _run_torch_ppo,
    _spec,
    _torch_fake_run,
    _torch_weights_cfg,
    run_two_update_iters,
)
from test_torch_models import _jax_actor_critic, _torch_actor_critic
from test_torch_slice import H, _np

torch.set_num_threads(1)

STEER = dict(stddev_min=0.05, stddev_max=0.5, num_dims=2)


def _raw(seed, *shape):
    return np.random.default_rng(seed).normal(
        scale=2.0, size=shape).astype(np.float32)


def test_continuous_distributions_match_jax():
    cfgs_j = [mlt.ContinuousActionsConfig(**STEER),
              mlt.ContinuousActionsConfig(0.1, 1.0, 2)]
    cfgs_t = [tlt.ContinuousActionsConfig(**STEER),
              tlt.ContinuousActionsConfig(0.1, 1.0, 2)]
    means, stds = _raw(0, 40, 2, 2), _raw(1, 40, 2, 2)
    actions = _raw(2, 40, 2, 2) / 2
    j = JaxContinuous(cfgs=cfgs_j, means=jnp.asarray(means),
                      stds=jnp.asarray(stds))
    t = ContinuousActionDistributions(cfgs_t, torch.from_numpy(means),
                                      torch.from_numpy(stds))
    j_lp, j_ent = j.action_stats(jnp.asarray(actions))
    t_lp, t_ent = t.action_stats(torch.from_numpy(actions))
    tol = dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(t_lp), np.asarray(j_lp), **tol)
    np.testing.assert_allclose(_np(t_ent), np.asarray(j_ent), **tol)
    np.testing.assert_allclose(_np(t.best()), np.asarray(j.best()), **tol)
    assert t_lp.shape == t_ent.shape == (40, 2, 2)

    # A sample from JAX's noise: the same actions and log-probs.
    key = random.key(4)
    j_actions, j_sample_lp = j.sample(key)
    noise = [np.asarray(random.normal(k, (40, 1, 2), jnp.float32))
             for k in random.split(key, 2)]
    mp = pytest.MonkeyPatch()
    mp.setattr(t_dists, "normal_noise",
               lambda shape, gen, device: torch.tensor(noise.pop(0)))
    try:
        t_actions, t_sample_lp = t.sample(None)
    finally:
        mp.undo()
    assert not noise and t_actions.dtype == torch.float32
    np.testing.assert_allclose(_np(t_actions), np.asarray(j_actions), **tol)
    np.testing.assert_allclose(_np(t_sample_lp), np.asarray(j_sample_lp),
                               **tol)


class JaxSteerActor(nn.Module):
    """tests/test_train_variants.py's continuous head."""

    cfg: mlt.ContinuousActionsConfig

    @nn.compact
    def __call__(self, features, train=False):
        out = nn.Dense(2 * self.cfg.num_dims)(features)
        return JaxContinuous(cfgs=[self.cfg],
                             means=out[..., None, :self.cfg.num_dims],
                             stds=out[..., None, self.cfg.num_dims:])


class TorchSteerActor(torch.nn.Module):
    def __init__(self, cfg, in_features):
        super().__init__()
        self.cfg = cfg
        self.Dense_0 = Dense(in_features, 2 * cfg.num_dims, torch.float32)

    def forward(self, features):
        out = self.Dense_0(features)
        d = self.cfg.num_dims
        return ContinuousActionDistributions(
            [self.cfg], out[..., None, :d], out[..., None, d:])


def _jax_steer_env(base):
    def step_fn(step_input):
        cont = step_input["actions"]["steer"][:, 0, :]
        dx = jnp.where(jnp.abs(cont[:, 0]) > 0.3,
                       jnp.where(cont[:, 0] > 0, 3, 4), 0)
        dy = jnp.where(jnp.abs(cont[:, 1]) > 0.3,
                       jnp.where(cont[:, 1] > 0, 1, 2), 0)
        move = jnp.where(dx > 0, dx, dy).astype(jnp.int32)[:, None]
        return base["step"](dict(step_input, actions={"move": move}))

    return {"init": base["init"], "step": step_fn}


def _torch_steer_env(base):
    def step_fn(step_input):
        cont = step_input["actions"]["steer"][:, 0, :]
        dx = torch.where(cont[:, 0].abs() > 0.3,
                         torch.where(cont[:, 0] > 0, 3, 4), 0)
        dy = torch.where(cont[:, 1].abs() > 0.3,
                         torch.where(cont[:, 1] > 0, 1, 2), 0)
        move = torch.where(dx > 0, dx, dy).to(torch.int32)[:, None]
        return base["step"](dict(step_input, actions={"move": move}))

    return {"init": base["init"], "step": step_fn}


def _continuous_spec():
    def jax_model():
        ac = _jax_actor_critic(jnp.float32, H)
        return ac.clone(actor=jm.DictActor(heads={"steer": JaxSteerActor(
            cfg=mlt.ContinuousActionsConfig(**STEER))}))

    def torch_model():
        ac = _torch_actor_critic(torch.float32, H)
        ac.actor = tm.DictActor({"steer": TorchSteerActor(
            tlt.ContinuousActionsConfig(**STEER), H)})
        return ac

    return dict(_spec("stratified"), cfg={}, mb=16, tol=F32_TOL,
                jax_model=jax_model, torch_model=torch_model,
                jax_env=_jax_steer_env, torch_env=_torch_steer_env,
                jax_actions={"steer": mlt.ContinuousActionsConfig(**STEER)},
                torch_actions={"steer": tlt.ContinuousActionsConfig(
                    **STEER)})


def test_two_update_iters_continuous():
    _, snaps, draws = run_two_update_iters(_continuous_spec())
    # One noise draw a rollout step: 2 updates x 8 steps.
    assert [o.shape for n, _, o in draws if n == "normal"] == \
        [(16, 1, 2)] * 16
    for s in snaps:
        assert s["stats"]["max_abs_ratio_dev"] < 0.2


def _continuous_weights_data(rd, dims=2):
    """The linear policy's data with a continuous head's [N, T, 1, dims]
    actions, log-probs and entropies (the stored log-probs are the obs'
    ``old_lp``, so the ratio is 1)."""
    rng = np.random.default_rng(5)

    def f32(*shape):
        return jnp.asarray(rng.standard_normal(shape), jnp.float32)

    lp = f32(WN, WT, 1, dims)
    data = rd.data.copy({
        "actions": {"a": f32(WN, WT, 1, dims)},
        "log_probs": {"a": lp},
        "obs": dict(rd.data["obs"], old_lp=lp, ent=f32(WN, WT, 1, dims)),
    })
    return rd.replace(data=data)


def test_importance_sampling_continuous_loss_closed_form():
    head = {"a": mlt.ContinuousActionsConfig(**STEER)}
    jcfg = _jax_weights_cfg(actions=head)
    ps, ts, rd = _make_states_and_data(jcfg)
    rd = _continuous_weights_data(rd)
    data = rd.data
    adv = np.asarray(data["advantages"], np.float32)
    err = np.abs(np.asarray(data["values"]) - np.asarray(data["returns"]))
    scores = (np.abs(adv).reshape(WN, -1).mean(1)
              + err.reshape(WN, -1).mean(1))
    probs = jax.nn.softmax(jnp.asarray(scores, jnp.float32))
    weights = (1.0 / WN) / np.asarray(probs, np.float64)
    sample_rnd, next_key = random.split(ts.update_prng_key)
    drawn = random.choice(sample_rnd, WN, shape=(WMB,), replace=False,
                          p=probs)
    mb_rnd, _ = random.split(next_key)
    perm = np.asarray(random.permutation(mb_rnd, drawn))
    rows = perm[:WMB]
    w = weights[rows]
    assert np.std(w) > 1e-3

    def gather(x):  # -> time-major [T, mb, ...]
        return np.swapaxes(np.asarray(x, np.float64)[rows], 0, 1)

    c_v, c_e = jcfg.algo.value_loss_coef, jcfg.algo.entropy_coef
    adv_t = gather(data["advantages"])[..., None]  # [T, mb, 1, 1]
    ent_t = gather(data["obs"]["ent"])  # [T, mb, 1, dims]
    value = c_v * np.mean(w[:, None] * 0.5 * (
        gather(data["obs"]["vbase"]) - gather(data["returns"])) ** 2)
    w4 = w[:, None, None]
    per_trajectory = (-np.mean(w4 * np.broadcast_to(adv_t, ent_t.shape))
                      + value - c_e * np.mean(w4 * ent_t))
    mean_w_times_mean = (-np.mean(w) * np.mean(adv_t) + value
                         - c_e * np.mean(w) * np.mean(ent_t))
    assert abs(per_trajectory - mean_w_times_mean) > 1e-2

    _, _, j_metrics = _run_ppo(jcfg, ps, ts, rd)
    j_loss = float(np.asarray(j_metrics.metrics["Loss"].mean)[0, 0])

    tcfg = _torch_weights_cfg(actions={
        "a": tlt.ContinuousActionsConfig(**STEER)})
    mp = pytest.MonkeyPatch()
    perms, picks = _patch_draws(mp, [perm], [np.asarray(drawn)])
    try:
        t_ps, t_ts, t_data, t_metrics = _torch_fake_run(tcfg, rd)
        stats = _run_torch_ppo(tcfg, t_ps, t_ts, t_data, t_metrics)
    finally:
        mp.undo()
    assert not perms and not picks and stats["num_minibatches"] == 1
    t_loss = float(t_metrics.latest("Loss").mean)
    np.testing.assert_allclose(t_loss, per_trajectory, rtol=0, atol=1e-6)
    np.testing.assert_allclose(j_loss, mean_w_times_mean, rtol=0, atol=1e-6)
