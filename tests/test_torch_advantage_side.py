"""The advantage side of PPO: the port against the JAX package.

- Closed-form weights (``tests/test_ppo_weights.py``'s hand-made linear
  policy through both packages' ``_ppo``): the recorded loss of importance
  sampling and of advantage filtering equals the hand-computed
  per-trajectory weighted loss, in both packages, within 1e-6.
- Selection: advantage filtering's sorted rows, threshold, minibatch count
  and max-|advantage| EMA over 3 updates; importance sampling's
  probabilities and weights; ``torch.multinomial``'s draw without
  replacement against the Gumbel-top-k rule of ``jax.random.choice``
  (inclusion rates over 20000 draws, within 4 sigma); stratified
  minibatches' composition, block-major order and one visit an epoch; and
  ``resolve_stratify`` with its warning, against JAX's.
- ``DynamicScale`` against flax's, step for step through both packages'
  ``_ppo`` over 6 updates, one of them with a non-finite gradient (the
  backoff, the ``fin_steps`` reset, and the parameters and Adam state
  kept), at flax's growth interval and at 2 (the growth).
- The refusals: a float16 LSTM or GRU off the CPU and the card,
  importance sampling that would draw every sequence, and advantage
  filtering over a recurrent tower.
- Two ``update_iter`` calls in both packages (``run_two_update_iters``,
  the pattern of ``tests/test_torch_value_side.py``: the slice test's
  size, the JAX run's parameters, start state, obs-normalizer state,
  max-|advantage| EMA and loss-scaler state given to the port) for
  ``filter`` (feed-forward), ``importance``, ``stratified`` (2 blocks, 2
  minibatches) and ``fp16`` (feed-forward, float16). The port replays the
  JAX run's draws: ``jax.random``'s ``permutation`` and ``choice`` as
  ``madrona_learn_tpu.ppo`` calls them report their results through
  ``jax.debug.callback`` (a proxy installed in this test only), and the
  port's module-level ``permutation`` / ``choice`` (and its action
  sampler) return them. The replayed permutation also checks that the
  port permuted the same rows (filtering's kept set and -1 entries), and
  the replayed draw of importance sampling that the port drew with JAX's
  probabilities. ``tests/test_torch_continuous.py`` runs ``continuous``.
"""

import warnings
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.training.dynamic_scale import DynamicScale as FlaxDynamicScale
from jax import random

import madrona_learn_tpu as mlt
import madrona_learn_tpu.models as jm
import madrona_learn_tpu.ops.dists as j_dists
import madrona_learn_tpu.ppo as j_ppo
import madrona_learn_tpu_torch as tlt
import madrona_learn_tpu_torch.models as tm
import madrona_learn_tpu_torch.ops.dists as t_dists
import madrona_learn_tpu_torch.ppo as t_ppo
from madrona_learn_tpu.envs import ToyEnvConfig as JaxToyEnvConfig
from madrona_learn_tpu.envs import make_toy_env as jax_make_toy_env
from madrona_learn_tpu.ops.ema import EMAEstimate as JaxEMAEstimate
from madrona_learn_tpu_torch.compat.from_jax import (
    dynamic_scale_state,
    ema_state,
    obs_preprocess_state,
    policy_slice,
)
from madrona_learn_tpu_torch.config import DiscreteActionsConfig
from madrona_learn_tpu_torch.envs import ToyEnvConfig, make_toy_env
from madrona_learn_tpu_torch.ops.dynamic_scale import DynamicScale
from madrona_learn_tpu_torch.ops.ema import EMAEstimate
from madrona_learn_tpu_torch.ops.metrics import TrainingMetrics
from madrona_learn_tpu_torch.rollouts import RolloutData, RolloutManager
from madrona_learn_tpu_torch.train_state import PolicyTrainState
from test_ppo_weights import MB as WMB
from test_ppo_weights import N as WN
from test_ppo_weights import T as WT
from test_ppo_weights import _make_cfg as _jax_weights_cfg
from test_ppo_weights import _make_states_and_data, _run_ppo
from test_torch_models import _jax_actor_critic, _torch_actor_critic
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
from test_torch_value_side import _CaptureRollouts, _recorded_actions

torch.set_num_threads(1)


# -- the hand-made linear policy of tests/test_ppo_weights.py ---------------

class _FakeActorCritic(torch.nn.Module):
    """test_ppo_weights._fake_apply: the stored log-probs (ratio 1), the
    obs' entropies and a critic of obs["vbase"] times one parameter."""

    def __init__(self):
        super().__init__()
        self.dense = torch.nn.Module()
        self.dense.kernel = torch.nn.Parameter(torch.ones(1))

    def update(self, rnn_states, dones, actions, obs):
        w = self.dense.kernel[0]
        return {"log_probs": {"a": obs["old_lp"] + 0.0 * w},
                "entropies": {"a": obs["ent"] + 0.0 * w},
                "critic": obs["vbase"] * w}


def _torch_weights_cfg(**overrides):
    """The port's twin of test_ppo_weights._make_cfg."""
    base = dict(
        num_worlds=WN, num_agents_per_world=1,
        actions={"a": DiscreteActionsConfig(actions_num_buckets=[3])},
        steps_per_update=WT, num_bptt_chunks=1, lr=1e-3, gamma=0.99,
        gae_lambda=0.95, seed=0, metrics_buffer_size=1,
        algo=tlt.PPOConfig(num_epochs=1, minibatch_size=WMB, clip_coef=0.2,
                           value_loss_coef=0.7, entropy_coef=0.013,
                           max_grad_norm=10.0),
        dreamer_v3_critic=False, normalize_advantages=False,
        normalize_values=False, importance_sample_trajectories=True,
        importance_sample_num_minibatches=1)
    base.update(overrides)
    return tlt.TrainConfig(**base)


def _torch_fake_run(cfg, jax_data, scaler=None, scaler_state=None):
    """The port's state for the linear policy, from the JAX data."""
    ac = _FakeActorCritic()
    algo = t_ppo.PPO()
    hp = algo.init_hyperparams(cfg)
    tx = algo.make_optimizer(hp)
    est = EMAEstimate(decay=cfg.max_advantage_est_decay)
    train_state = PolicyTrainState(
        hyper_params=hp, tx=tx,
        opt_state=tx.init({k: p.detach() for k, p in
                           ac.named_parameters()}),
        initial_weight_norms={}, generator=torch.Generator(),
        max_advantage_est=est,
        max_advantage_est_state=est.init_estimates(torch.zeros(1)),
        scaler=scaler, scaler_state=scaler_state)

    def to_torch(tree):
        if hasattr(tree, "items"):
            return {k: to_torch(v) for k, v in tree.items()}
        return torch.from_numpy(np.array(tree))

    # The linear policy keeps no recurrent state, like BackboneEncoder.
    data = RolloutData(dict(to_torch(jax_data.data), rnn_start_states=()))
    metrics = TrainingMetrics(algo.add_metrics(cfg, {}), 1, 0, 1, "cpu")
    return SimpleNamespace(actor_critic=ac), train_state, data, metrics


def _run_torch_ppo(cfg, policy_state, train_state, data, metrics):
    return t_ppo._ppo(cfg, policy_state, train_state, data,
                      lambda *args: None, metrics)


def _patch_draws(mp, permutations=(), choices=()):
    """The port's draws return these, in order."""
    perms, picks = list(permutations), list(choices)
    mp.setattr(t_ppo, "permutation", lambda gen, x: torch.from_numpy(
        np.asarray(perms.pop(0), np.int64)))
    mp.setattr(t_ppo, "choice", lambda gen, probs, k: torch.from_numpy(
        np.asarray(picks.pop(0), np.int64)))
    return perms, picks


def _weighted_loss(cfg, data, rows, weights):
    """-mean(w * adv) + c_v * mean(w * l2(vbase, returns)) - c_e * mean(w *
    ent) over the time-major gather of ``rows``, with the linear policy's
    parameter at its initial 1."""
    def gather(x):
        return np.swapaxes(np.asarray(x, np.float64)[rows], 0, 1)

    w = np.asarray(weights, np.float64)[rows]
    rets = gather(data["returns"])
    l2 = 0.5 * (gather(data["obs"]["vbase"]) - rets) ** 2
    return (-np.mean(w * gather(data["advantages"]))
            + cfg.algo.value_loss_coef * np.mean(w * l2)
            - cfg.algo.entropy_coef * np.mean(w * gather(data["obs"]["ent"])))


def test_importance_sampling_loss_closed_form():
    jcfg = _jax_weights_cfg()
    ps, ts, rd = _make_states_and_data(jcfg)
    data = rd.data
    # JAX's key threading: the draw, then the epoch's permutation.
    adv = np.asarray(data["advantages"], np.float32)
    err = np.abs(np.asarray(data["values"]) - np.asarray(data["returns"]))
    scores = (np.abs(adv).reshape(WN, -1).mean(1)
              + err.reshape(WN, -1).mean(1))
    probs = jax.nn.softmax(jnp.asarray(scores, jnp.float32))
    weights = ((1.0 / WN) / np.asarray(probs, np.float64))[:, None]
    sample_rnd, next_key = random.split(ts.update_prng_key)
    drawn = random.choice(sample_rnd, WN, shape=(WMB,), replace=False,
                          p=probs)
    mb_rnd, _ = random.split(next_key)
    perm = np.asarray(random.permutation(mb_rnd, drawn))
    expected = _weighted_loss(jcfg, data, perm[:WMB], weights)
    assert np.std(weights[perm[:WMB]]) > 1e-3

    _, _, j_metrics = _run_ppo(jcfg, ps, ts, rd)
    j_loss = float(np.asarray(j_metrics.metrics["Loss"].mean)[0, 0])

    tcfg = _torch_weights_cfg()
    mp = pytest.MonkeyPatch()
    perms, picks = _patch_draws(mp, [perm], [np.asarray(drawn)])
    try:
        t_ps, t_ts, t_data, t_metrics = _torch_fake_run(tcfg, rd)
        stats = _run_torch_ppo(tcfg, t_ps, t_ts, t_data, t_metrics)
    finally:
        mp.undo()
    assert not perms and not picks and stats["num_minibatches"] == 1
    t_loss = float(t_metrics.latest("Loss").mean)
    np.testing.assert_allclose(j_loss, expected, rtol=0, atol=1e-6)
    np.testing.assert_allclose(t_loss, expected, rtol=0, atol=1e-6)
    np.testing.assert_allclose(t_loss, j_loss, rtol=0, atol=1e-6)


def _filter_data(rd):
    """Advantages with 10 large rows among tiny ones, so one minibatch of
    16 rows holds every row above 1% of the largest."""
    rng = np.random.default_rng(11)
    adv = (1e-4 * rng.standard_normal((WN, WT, 1))).astype(np.float32)
    big = rng.choice(WN * WT, size=10, replace=False)
    adv.reshape(-1)[big] = rng.uniform(0.5, 2.0, size=10) * rng.choice(
        [-1, 1], size=10)
    return rd.replace(data=rd.data.copy({"advantages": jnp.asarray(adv)}))


def test_filter_advantages_loss_closed_form():
    overrides = dict(importance_sample_trajectories=False,
                     importance_sample_num_minibatches=0,
                     filter_advantages=True,
                     algo=None)
    jalgo = mlt.PPOConfig(num_epochs=1, minibatch_size=16, clip_coef=0.2,
                          value_loss_coef=0.7, entropy_coef=0.013,
                          max_grad_norm=10.0)
    jcfg = _jax_weights_cfg(**dict(overrides, algo=jalgo))
    ps, ts, rd = _make_states_and_data(jcfg)
    rd = _filter_data(rd)
    flat = rd.flatten_time().data
    adv_flat = np.abs(np.asarray(flat["advantages"])).reshape(-1)
    kept = np.argsort(-adv_flat, kind="stable")[:16]
    assert (adv_flat >= 0.01 * adv_flat.max()).sum() == 10
    valid = np.full(WN * WT, -1)
    valid[:16] = kept
    # No draw precedes the epoch's permutation.
    mb_rnd, _ = random.split(ts.update_prng_key)
    perm = np.asarray(random.permutation(mb_rnd, jnp.asarray(valid)))
    perm = perm[np.argsort(perm == -1, kind="stable")]
    assert sorted(perm[:16]) == sorted(kept)
    expected = _weighted_loss(jcfg, flat, perm[:16],
                              np.ones((WN * WT, 1)))

    _, j_ts, j_metrics = _run_ppo(jcfg, ps, ts, rd)
    j_loss = float(np.asarray(j_metrics.metrics["Loss"].mean)[0, 0])

    tcfg = _torch_weights_cfg(**dict(overrides, algo=tlt.PPOConfig(
        num_epochs=1, minibatch_size=16, clip_coef=0.2, value_loss_coef=0.7,
        entropy_coef=0.013, max_grad_norm=10.0)))
    mp = pytest.MonkeyPatch()
    seen = []

    def permutation(gen, x):
        seen.append(_np(x))
        return torch.from_numpy(
            np.asarray(random.permutation(mb_rnd, jnp.asarray(_np(x))),
                       np.int64))

    mp.setattr(t_ppo, "permutation", permutation)
    try:
        t_ps, t_ts, t_data, t_metrics = _torch_fake_run(tcfg, rd)
        stats = _run_torch_ppo(tcfg, t_ps, t_ts, t_data, t_metrics)
    finally:
        mp.undo()
    np.testing.assert_array_equal(seen[0], valid)
    assert stats["num_minibatches"] == 1
    t_loss = float(t_metrics.latest("Loss").mean)
    np.testing.assert_allclose(j_loss, expected, rtol=0, atol=1e-6)
    np.testing.assert_allclose(t_loss, expected, rtol=0, atol=1e-6)
    np.testing.assert_allclose(t_loss, j_loss, rtol=0, atol=1e-6)
    for name, w in ema_state(policy_slice(
            j_ts.max_advantage_est_state)).items():
        np.testing.assert_allclose(_np(t_ts.max_advantage_est_state[name]),
                                   w, rtol=1e-6, atol=0, err_msg=name)


# -- selection ---------------------------------------------------------------

def _jax_filter_selection(est, est_state, advantages, mb):
    """JAX's filtering lines (ppo.py:_ppo) on one advantage array."""
    advantages_abs = jnp.abs(advantages)
    est_state = est.update_estimates(est_state, jnp.max(advantages_abs))
    adv_flat = advantages_abs.reshape(-1)
    sorted_idxs = jnp.argsort(adv_flat, descending=True)
    num_above = jnp.sum(jnp.where(adv_flat >= 0.01 * est_state["mu"], 1, 0))
    num_minibatches = jnp.minimum((num_above + mb - 1) // mb,
                                  adv_flat.size // mb)
    valid = jnp.where(jnp.arange(adv_flat.size) < num_minibatches * mb,
                      sorted_idxs, -1)
    return est_state, valid, int(num_minibatches)


def test_filter_selection_matches_jax_over_three_updates():
    rng = np.random.default_rng(5)
    mb = 32
    cfg = _torch_weights_cfg(
        importance_sample_trajectories=False,
        importance_sample_num_minibatches=0, filter_advantages=True,
        max_advantage_est_decay=0.9,
        algo=tlt.PPOConfig(num_epochs=1, minibatch_size=mb, clip_coef=0.2,
                           value_loss_coef=0.5, entropy_coef=0.01,
                           max_grad_norm=0.5))
    j_est = JaxEMAEstimate(decay=0.9)
    j_state = j_est.init_estimates(jnp.zeros((1,)))
    t_state = SimpleNamespace(
        max_advantage_est=EMAEstimate(decay=0.9),
        max_advantage_est_state=EMAEstimate(decay=0.9).init_estimates(
            torch.zeros(1)))
    counts = []
    for update, scale in enumerate((3.0, 1.0, 0.05)):
        # Heavy tails: the largest |advantage| shrinks from update to
        # update, so the EMA keeps more rows below its 1% threshold.
        adv = (scale * rng.standard_t(1.5, size=(256, 1, 1))).astype(
            np.float32)
        j_state, j_valid, j_num = _jax_filter_selection(
            j_est, j_state, jnp.asarray(adv), mb)
        t_valid, t_num, t_state.max_advantage_est_state = \
            t_ppo.filter_selection(cfg, t_state, torch.from_numpy(adv))
        assert t_num == j_num, update
        np.testing.assert_array_equal(_np(t_valid), np.asarray(j_valid))
        for name, w in ema_state(j_state).items():
            np.testing.assert_allclose(
                _np(t_state.max_advantage_est_state[name]), w, rtol=1e-6,
                atol=0, err_msg=f"{name} {update}")
        counts.append(t_num)
    assert int(t_state.max_advantage_est_state["N"]) == 3
    # The threshold binds: the last update keeps fewer minibatches.
    assert counts[-1] < 256 // mb


def test_importance_weights_match_jax():
    rng = np.random.default_rng(3)
    n = 48
    data = {k: rng.normal(size=(n, 4, 1)).astype(np.float32)
            for k in ("advantages", "values", "returns")}
    adv, vals, rets = (jnp.asarray(data[k])
                       for k in ("advantages", "values", "returns"))
    # JAX's lines (ppo.py:_ppo).
    scores = (jnp.mean(jnp.abs(adv).reshape(n, -1), axis=1)
              + jnp.mean(jnp.abs(vals - rets).reshape(n, -1), axis=1))
    j_probs = jax.nn.softmax(scores, axis=0)
    j_weights = ((1.0 / n) / j_probs)[:, None]
    t_probs, t_weights = t_ppo.importance_weights(
        {k: torch.from_numpy(v) for k, v in data.items()})
    np.testing.assert_allclose(_np(t_probs), np.asarray(j_probs),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(t_weights), np.asarray(j_weights),
                               rtol=1e-6, atol=1e-6)
    assert t_weights.shape == (n, 1)


def test_multinomial_draw_matches_gumbel_top_k_rates():
    """torch.multinomial without replacement against the rule of
    jax.random.choice(..., replace=False, p=): the k smallest
    -gumbel - log p. The generators cannot agree, so the inclusion rate
    of every index over 20000 draws must agree within 4 sigma."""
    draws, k = 20000, 4
    logits = np.random.default_rng(2).normal(size=16).astype(np.float32)
    p = torch.softmax(torch.from_numpy(logits), dim=0)
    gen = torch.Generator().manual_seed(0)
    got = t_ppo.choice(gen, p.expand(draws, -1).contiguous(), k)
    assert all(len(set(row)) == k for row in got.tolist())
    t_rate = np.bincount(got.reshape(-1).numpy(), minlength=16) / draws

    rng = np.random.default_rng(1)
    g = rng.gumbel(size=(draws, 16))
    picks = np.argsort(-g - np.log(p.numpy().astype(np.float64)),
                       axis=1)[:, :k]
    np_rate = np.bincount(picks.reshape(-1), minlength=16) / draws
    sigma = np.sqrt(2 * np_rate * (1 - np_rate) / draws)
    assert (np.abs(t_rate - np_rate) <= 4 * sigma + 1e-12).all(), (
        t_rate, np_rate)
    assert abs(t_rate.sum() - k) < 1e-9


def _stratify_cfgs(stratify, mb=16, **kwargs):
    common = dict(num_epochs=1, minibatch_size=mb, clip_coef=0.2,
                  value_loss_coef=0.5, entropy_coef=0.01, max_grad_norm=0.5)
    j = mlt.TrainConfig(
        num_worlds=W, num_agents_per_world=1, num_updates=1,
        actions={"move": mlt.DiscreteActionsConfig([5])},
        steps_per_update=STEPS, num_bptt_chunks=CHUNKS, lr=LR, gamma=0.99,
        seed=0, metrics_buffer_size=1, algo=mlt.PPOConfig(**common),
        minibatch_stratify=stratify, **kwargs)
    t = tlt.TrainConfig(
        num_worlds=W, num_agents_per_world=1,
        actions={"move": DiscreteActionsConfig([5])},
        steps_per_update=STEPS, num_bptt_chunks=CHUNKS, lr=LR, gamma=0.99,
        seed=0, metrics_buffer_size=1, algo=tlt.PPOConfig(**common),
        minibatch_stratify=stratify, **kwargs)
    return j, t


@pytest.mark.parametrize("stratify,num_seqs,mb,kwargs,want", [
    (None, 32, 16, {}, 1),
    (1, 32, 16, {}, 1),
    (2, 32, 16, {}, 2),
    (4, 32, 16, {}, 4),
    (3, 32, 16, {}, 1),        # 3 divides neither: warns
    (4, 32, 6, {}, 1),         # divides the sequences, not the minibatch
    (2, 32, 16, dict(filter_advantages=True), 1),
    (2, 32, 16, dict(importance_sample_trajectories=True,
                     importance_sample_num_minibatches=1), 1),
])
def test_resolve_stratify_matches_jax(stratify, num_seqs, mb, kwargs, want):
    j_cfg, t_cfg = _stratify_cfgs(stratify, mb, **kwargs)
    warns = want == 1 and stratify not in (None, 1) and not kwargs
    with warnings.catch_warnings(record=True) as j_warn:
        warnings.simplefilter("always")
        j = j_ppo.resolve_stratify(j_cfg, num_seqs)
    with warnings.catch_warnings(record=True) as t_warn:
        warnings.simplefilter("always")
        t = t_ppo.resolve_stratify(t_cfg, num_seqs)
    assert j == t == want
    assert bool(j_warn) == bool(t_warn) == warns
    if warns:
        assert "stratification disabled" in str(t_warn[0].message)


@pytest.mark.parametrize("stratify,num_minibatches", [(2, 2), (4, 8)])
def test_stratified_epoch_indices(stratify, num_minibatches):
    """Every minibatch takes minibatch_size / stratify rows from each
    block, block-major, and the epoch visits every sequence once; two
    epochs draw different orders."""
    mb = 16
    num_seqs = mb * num_minibatches
    _, cfg = _stratify_cfgs(stratify, mb)
    gen = torch.Generator().manual_seed(4)
    valid = torch.arange(num_seqs)
    inds = t_ppo.epoch_indices(cfg, gen, valid, stratify, num_minibatches)
    assert sorted(inds.tolist()) == list(range(num_seqs))
    block, per_mb = num_seqs // stratify, mb // stratify
    for i in range(num_minibatches):
        rows = inds[i * mb:(i + 1) * mb].reshape(stratify, per_mb)
        for b in range(stratify):
            assert ((rows[b] // block) == b).all(), (i, b)
    again = t_ppo.epoch_indices(cfg, gen, valid, stratify, num_minibatches)
    assert not torch.equal(inds, again)


def test_stratified_stream_matches_jax_layout():
    """The port's stream from JAX's per-block permutations equals JAX's
    uniform_stratified_inds (ppo.py:_ppo) on the same keys."""
    stratify, num_minibatches, mb = 4, 3, 8
    num_seqs = mb * num_minibatches
    block, per_mb = num_seqs // stratify, mb // stratify
    keys = random.split(random.key(3), stratify)
    perms = jax.vmap(lambda key: random.permutation(key, block))(keys)
    ids = jnp.arange(stratify)[:, None] * block + perms
    j_inds = ids.reshape(stratify, num_minibatches, per_mb).transpose(
        1, 0, 2).reshape(-1)
    _, cfg = _stratify_cfgs(stratify, mb)
    mp = pytest.MonkeyPatch()
    _patch_draws(mp, list(np.asarray(perms)))
    try:
        t_inds = t_ppo.epoch_indices(cfg, None, torch.arange(num_seqs),
                                     stratify, num_minibatches)
    finally:
        mp.undo()
    np.testing.assert_array_equal(_np(t_inds), np.asarray(j_inds))


# -- DynamicScale ------------------------------------------------------------

NONFINITE_STEP = 3


def _scaler_steps(growth_interval):
    """6 single-minibatch updates of the linear policy in both packages,
    the 4th with an infinite obs["vbase"] (so an infinite gradient)."""
    # One minibatch of all WN sequences an update.
    algo = dict(num_epochs=1, minibatch_size=WN, clip_coef=0.2,
                value_loss_coef=0.7, entropy_coef=0.013, max_grad_norm=10.0)
    jcfg = _jax_weights_cfg(importance_sample_trajectories=False,
                            importance_sample_num_minibatches=0,
                            algo=mlt.PPOConfig(**algo))
    ps, ts, rd = _make_states_and_data(jcfg)
    ts = ts.replace(scaler=FlaxDynamicScale(growth_interval=growth_interval))
    tcfg = _torch_weights_cfg(importance_sample_trajectories=False,
                              importance_sample_num_minibatches=0,
                              algo=tlt.PPOConfig(**algo))
    scaler = DynamicScale(growth_interval=growth_interval)
    t_ps, t_ts, t_data, t_metrics = _torch_fake_run(
        tcfg, rd, scaler, scaler.init_state("cpu"))
    vbase = np.asarray(rd.data["obs"]["vbase"])
    j_steps, t_steps = [], []
    for step in range(6):
        bad = vbase.copy()
        if step == NONFINITE_STEP:
            bad[0, 0, 0] = np.inf
        j_rd = rd.replace(data=rd.data.copy({"obs": dict(
            rd.data["obs"], vbase=jnp.asarray(bad))}))
        ps, ts, _ = jax.tree.map(lambda x: x[0],
                                 _run_ppo(jcfg, ps, ts, j_rd))
        adam = [s for s in jax.tree.leaves(
            ts.opt_state, is_leaf=lambda x: isinstance(
                x, optax.ScaleByAdamState))
            if isinstance(s, optax.ScaleByAdamState)][0]
        j_steps.append(dict(
            **dynamic_scale_state(ts.scaler),
            w=np.asarray(ps.params["dense"]["kernel"]),
            mu=np.asarray(adam.mu["dense"]["kernel"]),
            nu=np.asarray(adam.nu["dense"]["kernel"]),
            count=np.asarray(adam.count)))
        t_data.data["obs"]["vbase"] = torch.from_numpy(bad)
        stats = _run_torch_ppo(tcfg, t_ps, t_ts, t_data, t_metrics)
        opt = t_ts.opt_state
        t_steps.append(dict(
            scale=_np(t_ts.scaler_state["scale"]),
            fin_steps=_np(t_ts.scaler_state["fin_steps"]),
            w=_np(t_ps.actor_critic.dense.kernel).copy(),
            mu=_np(opt.mu["dense.kernel"]), nu=_np(opt.nu["dense.kernel"]),
            count=_np(opt.count),
            nonfinite=int(stats["nonfinite_steps"])))
    return j_steps, t_steps


@pytest.mark.parametrize("growth_interval", [2000, 2])
def test_dynamic_scale_matches_flax(growth_interval):
    j_steps, t_steps = _scaler_steps(growth_interval)
    for step, (j, t) in enumerate(zip(j_steps, t_steps)):
        assert t["scale"].dtype == np.float32 and t["fin_steps"].dtype == \
            np.int32
        np.testing.assert_array_equal(t["scale"], j["scale"],
                                      err_msg=f"scale {step}")
        np.testing.assert_array_equal(t["fin_steps"], j["fin_steps"],
                                      err_msg=f"fin_steps {step}")
        assert int(t["count"]) == int(j["count"]), step
        for name in ("w", "mu", "nu"):
            np.testing.assert_allclose(t[name], j[name], rtol=1e-6,
                                       atol=1e-9, err_msg=f"{name} {step}")
        assert t["nonfinite"] == (step == NONFINITE_STEP)
    prev, bad = t_steps[NONFINITE_STEP - 1], t_steps[NONFINITE_STEP]
    # The non-finite step backs the scale off, resets fin_steps and keeps
    # the parameter and the Adam state (its count included).
    assert bad["scale"] == prev["scale"] * 0.5 and bad["fin_steps"] == 0
    for name in ("w", "mu", "nu", "count"):
        np.testing.assert_array_equal(bad[name], prev[name], err_msg=name)
    assert t_steps[-1]["w"] != t_steps[NONFINITE_STEP]["w"]
    scales = [float(t["scale"]) for t in t_steps]
    if growth_interval == 2:
        # fin_steps reaches 2 at the 2nd step, so the 3rd grows the scale.
        assert scales[:3] == [65536.0, 65536.0, 131072.0]
    else:
        assert scales[:3] == [65536.0] * 3
    assert [int(t["fin_steps"]) for t in t_steps][NONFINITE_STEP:] == [0, 1,
                                                                       2]


# -- refusals ----------------------------------------------------------------

@pytest.mark.parametrize("module", ["LSTM", "GRU"])
def test_float16_recurrent_module_raises(module):
    """A float16 recurrence takes its kernels' float16 instances on any
    device but the CPU: a tensor that is on neither the CPU nor a card is
    refused, never sent to the plain twin."""
    rnn = getattr(tm, module)(128, 128, 1, torch.float16).to("meta")
    state = rnn.init_recurrent_state(8, device="meta")
    with pytest.raises(ValueError, match="float16"):
        rnn.sequence(state, torch.zeros(2, 8, 1, dtype=torch.bool,
                                        device="meta"),
                     torch.empty(2, 8, 128, dtype=torch.float16,
                                 device="meta"))


@pytest.mark.parametrize("num_minibatches", [0, WN // WMB])
def test_importance_sampling_refuses_every_sequence(num_minibatches):
    """num_sampled must be above 0 and below the sequence count: JAX
    asserts it, the port raises."""
    jcfg = _jax_weights_cfg(importance_sample_num_minibatches=num_minibatches)
    ps, ts, rd = _make_states_and_data(jcfg)
    with pytest.raises(AssertionError):
        _run_ppo(jcfg, ps, ts, rd)
    tcfg = _torch_weights_cfg(
        importance_sample_num_minibatches=num_minibatches)
    with pytest.raises(ValueError, match="importance"):
        _run_torch_ppo(tcfg, *_torch_fake_run(tcfg, rd))


def test_filtering_refuses_a_recurrent_tower():
    """flatten_time cannot split recurrent start states into steps (JAX's
    fails inside the LSTM's re-scan, scripts/parity_curves.py:30-38); the
    port says so."""
    data = {"dones": torch.zeros(4, 3, 1, dtype=torch.bool),
            "rnn_start_states": (torch.zeros(4, 1, 8), torch.zeros(4, 1, 8))}
    with pytest.raises(ValueError, match="feed-forward"):
        RolloutData(data).flatten_time()
    flat = RolloutData(dict(data, rnn_start_states=())).flatten_time()
    assert flat.all()["dones"].shape == (12, 1, 1)
    assert flat.all()["rnn_start_states"] == ()


# -- two update_iters against JAX -------------------------------------------

class _RandomProxy:
    """``jax.random`` whose functions in ``names`` report (name, input,
    result) to ``sink`` through ``jax.debug.callback`` as they run on the
    device: the input is permutation's array, choice's probabilities."""

    def __init__(self, names, sink):
        self._names = names
        self._sink = sink

    def __getattr__(self, name):
        fn = getattr(random, name)
        if name not in self._names:
            return fn

        def reporting(*args, **kwargs):
            out = fn(*args, **kwargs)
            inp = kwargs.get("p") if name == "choice" else (
                args[1] if name == "permutation" else None)
            jax.debug.callback(
                lambda i, o: self._sink.append(
                    (name, None if i is None else np.asarray(i),
                     np.asarray(o))),
                None if inp is None else jnp.asarray(inp), out)
            return out

        return reporting


def _jax_mlp_model(dtype):
    actions = mlt.DiscreteActionsConfig(actions_num_buckets=[5])
    return jm.ActorCritic(
        backbone=jm.BackboneShared(
            prefix=lambda obs, train: jnp.concatenate(
                [obs["delta"], obs["time"]], axis=-1),
            encoder=jm.BackboneEncoder(
                net=jm.MLP(num_channels=H, num_layers=2, dtype=dtype))),
        actor=jm.DictActor(heads={"move": jm.DenseLayerDiscreteActor(
            cfg=actions, dtype=dtype)}),
        critic=jm.DenseLayerCritic(dtype=dtype))


def _torch_mlp_model(dtype):
    return tm.ActorCritic(
        backbone=tm.BackboneShared(
            prefix=lambda obs: torch.cat([obs["delta"], obs["time"]], -1),
            encoder=tm.BackboneEncoder(net=tm.MLP(3, H, 2, dtype))),
        actor=tm.DictActor({"move": tm.DenseLayerDiscreteActor(
            DiscreteActionsConfig(actions_num_buckets=[5]), H, dtype)}),
        critic=tm.DenseLayerCritic(H, dtype))


def _lstm_models():
    return (lambda: _jax_actor_critic(jnp.float32, H),
            lambda: _torch_actor_critic(torch.float32, H))


def _discrete(pkg):
    return {"move": pkg.DiscreteActionsConfig(actions_num_buckets=[5])}


# Float32 runs: the slice test's tolerances (same float32 math, sums in
# another order; Adam's first steps about lr * sign(g) where g is near 0).
F32_TOL = dict(data=(1e-4, 1e-5), mu=(1e-4, 1e-7), nu=(1e-3, 1e-10),
               close=(1e-5, 1e-6), metrics=(1e-4, 1e-5), est=(1e-5, 1e-6))
# float16 runs: XLA and PyTorch round the float16 products, LayerNorms and
# activations at other points, a float16 ulp (2^-10 relative) at a time,
# so the two packages agree to about 1e-2 relative (atol 1e-3, a float16
# ulp at 1, where values cross 0).
F16_TOL = dict(data=(1e-2, 1e-3), mu=(1e-2, 1e-5), nu=(2e-2, 1e-8),
               close=(1e-2, 1e-4), metrics=(1e-2, 1e-3), est=(1e-2, 1e-3))


def _same(env):
    return env


def _spec(name):
    lstm_jax, lstm_torch = _lstm_models()
    f32 = dict(jax_model=lstm_jax, torch_model=lstm_torch,
               jax_actions=_discrete(mlt), torch_actions=_discrete(tlt),
               tol=F32_TOL, jax_obs=lambda: mlt.ObservationsEMANormalizer
               .create(decay=0.99999, dtype=jnp.float32),
               torch_obs=lambda: tlt.ObservationsEMANormalizer.create(
                   decay=0.99999, dtype=torch.float32),
               cfg={}, mb=W * CHUNKS, jax_env=_same, torch_env=_same)
    mlp = dict(jax_model=lambda: _jax_mlp_model(jnp.float32),
               torch_model=lambda: _torch_mlp_model(torch.float32))
    return {
        # Flattened rows: W * STEPS = 128, minibatches of 32 rows.
        "filter": dict(f32, **mlp, cfg=dict(filter_advantages=True), mb=32),
        # 2 minibatches of 8 of the 32 sequences.
        "importance": dict(f32, cfg=dict(
            importance_sample_trajectories=True,
            importance_sample_num_minibatches=2), mb=8),
        "stratified": dict(f32, cfg=dict(minibatch_stratify=2), mb=16),
        "fp16": dict(
            f32, tol=F16_TOL, mb=16,
            jax_model=lambda: _jax_mlp_model(jnp.float16),
            torch_model=lambda: _torch_mlp_model(torch.float16),
            jax_obs=lambda: mlt.ObservationsCaster.create(dtype=jnp.float16),
            torch_obs=lambda: tlt.ObservationsCaster.create(
                dtype=torch.float16),
            cfg=dict(compute_dtype="float16")),
    }[name]


def _cfg(pkg, spec):
    kwargs = dict(spec["cfg"])
    if kwargs.get("compute_dtype") == "float16":
        kwargs["compute_dtype"] = (jnp.float16 if pkg is mlt
                                   else torch.float16)
    extra = {"num_updates": 2} if pkg is mlt else {}
    return pkg.TrainConfig(
        num_worlds=W, num_agents_per_world=1,
        actions=spec["jax_actions" if pkg is mlt else "torch_actions"],
        steps_per_update=STEPS, num_bptt_chunks=CHUNKS, lr=LR, gamma=0.99,
        gae_lambda=0.95, seed=SEED, metrics_buffer_size=1,
        algo=pkg.PPOConfig(num_epochs=1, minibatch_size=spec["mb"],
                           clip_coef=0.2, value_loss_coef=0.5,
                           entropy_coef=0.01, max_grad_norm=0.5),
        dreamer_v3_critic=False, **extra, **kwargs)


def _jax_run(spec):
    """Two JAX updates: the managers, the rollout data of each and the
    draws of jax.random that ppo.py and the action sampler made."""
    policy = mlt.Policy(actor_critic=spec["jax_model"](),
                        obs_preprocess=spec["jax_obs"]())
    data, draws = [], []
    mgr = mlt.init_training(
        None, _cfg(mlt, spec),
        spec["jax_env"](jax_make_toy_env(JaxToyEnvConfig(**ENV))), policy,
        init_sim_ctrl=jnp.zeros((1,), jnp.int32),
        user_hooks=_CaptureRollouts(data))
    mp = pytest.MonkeyPatch()
    mp.setattr(j_ppo, "random", _RandomProxy(("permutation", "choice"),
                                             draws))
    mp.setattr(j_dists, "random", _RandomProxy(("normal",), draws))
    try:
        update = jax.jit(lambda m: m.update_iter())
        mgrs = [mgr]
        for _ in range(2):
            mgr = update(mgr)
            jax.block_until_ready(mgr)
            mgrs.append(mgr)
        jax.effects_barrier()
    finally:
        mp.undo()
    assert len(data) == 2
    return mgrs, data, draws


def _replay(mp, draws, jax_data):
    """Patch the port's draws to return the JAX run's."""
    queues = {name: [(i, o) for n, i, o in draws if n == name]
              for name in ("permutation", "choice", "normal")}

    def permutation(gen, x):
        inp, out = queues["permutation"].pop(0)
        # The port permuted the same rows (filtering: the same kept set
        # and as many -1 entries).
        want = inp if inp.ndim else np.arange(int(inp))
        np.testing.assert_array_equal(np.sort(_np(x)), np.sort(want))
        return torch.from_numpy(out.astype(np.int64))

    def choice(gen, probs, k):
        inp, out = queues["choice"].pop(0)
        np.testing.assert_allclose(_np(probs), inp, rtol=1e-5, atol=1e-7)
        assert k == out.shape[0]
        return torch.from_numpy(out.astype(np.int64))

    def normal_noise(shape, gen, device):
        _, out = queues["normal"].pop(0)
        assert tuple(shape) == out.shape
        return torch.tensor(out)

    mp.setattr(t_ppo, "permutation", permutation)
    mp.setattr(t_ppo, "choice", choice)
    mp.setattr(t_dists, "normal_noise", normal_noise)
    if not queues["normal"]:
        actions = [a for d in jax_data for a in _recorded_actions(d)]
        mp.setattr(t_dists, "categorical",
                   lambda logits, generator: actions.pop(0))
        queues["categorical"] = actions
    return queues


def _torch_run(spec, jax_run):
    jax_mgrs, jax_data, draws = jax_run
    j0 = jax_mgrs[0]
    actor_critic = spec["torch_model"]()
    actor_critic.load_state_dict({
        k: torch.from_numpy(v)
        for k, v in _flat_state(j0.state.policy_states.params).items()})
    policy = tlt.Policy(actor_critic, spec["torch_obs"]())
    mgr = tlt.init_training(
        "cpu", _cfg(tlt, spec),
        spec["torch_env"](make_toy_env(ToyEnvConfig(**ENV), device="cpu")),
        policy, torch.zeros((1,), dtype=torch.int32))
    mgr.rollout.sim_state = {k: torch.from_numpy(np.array(v))
                             for k, v in j0.rollout.sim_state.items()}
    mgr.rollout.cur_obs = {k: torch.from_numpy(np.array(v))
                           for k, v in j0.rollout.cur_obs.items()}
    if isinstance(policy.obs_preprocess, tlt.ObservationsEMANormalizer):
        mgr.state.policy_states.obs_preprocess_state = {
            key: {n: torch.from_numpy(np.array(v)) for n, v in est.items()}
            for key, est in obs_preprocess_state(policy_slice(
                j0.state.policy_states.obs_preprocess_state)).items()}
    j_ts = j0.state.train_states
    ts = mgr.state.train_states
    ts.max_advantage_est_state = {
        k: torch.from_numpy(v) for k, v in ema_state(policy_slice(
            j_ts.max_advantage_est_state)).items()}
    assert (ts.scaler is None) == (j_ts.scaler is None)
    if ts.scaler is not None:
        # One policy: the scalars, with or without the policy axis.
        ts.scaler_state = {k: torch.from_numpy(v.reshape(())) for k, v in
                           dynamic_scale_state(j_ts.scaler).items()}

    collected, snapshots = [], []
    mp = pytest.MonkeyPatch()
    queues = _replay(mp, draws, jax_data)
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
                "est": {k: v.clone() for k, v in
                        ts.max_advantage_est_state.items()},
                "scaler": (None if ts.scaler_state is None else
                           {k: v.clone() for k, v in
                            ts.scaler_state.items()}),
                "stats": dict(mgr.first_minibatch_stats),
                "metrics": {name: mgr.metrics.latest(name).mean.clone()
                            for name in mgr.metrics.metrics},
            })
    finally:
        mp.undo()
    assert not any(queues.values()), {k: len(v) for k, v in queues.items()}
    return collected, snapshots


def run_two_update_iters(spec):
    """Two update_iters of ``spec`` in both packages, checked against each
    other; returns (JAX managers, port snapshots)."""
    tol = spec["tol"]
    jax_mgrs, jax_data, draws = jax_run = _jax_run(spec)
    collected, snapshots = _torch_run(spec, jax_run)
    for update in (0, 1):
        snap, j_mgr = snapshots[update], jax_mgrs[update + 1]
        _check_rollout_data(collected[update], jax_data[update], tol)
        _check_optimizer(snap, j_mgr, update, tol)
        _check_parameters(snap, j_mgr, tol)
        _check_states(snap, j_mgr, tol)
        _check_metrics(snap, j_mgr, tol)
    return jax_mgrs, snapshots, draws


def _check_rollout_data(got_tree, want_tree, tol):
    got = dict(_leaves({k: v for k, v in got_tree.items()
                        if k != "rnn_start_states"}))
    want = dict(_leaves(want_tree))
    assert sorted(got) == sorted(want)
    rtol, atol = tol["data"]
    for name, w in want.items():
        g = _np(got[name])
        assert g.shape == np.shape(w), name
        if name in ("dones", "rewards", "actions/move"):
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
        else:
            np.testing.assert_allclose(g.astype(np.float32),
                                       np.asarray(w, np.float32), rtol=rtol,
                                       atol=atol, err_msg=name)


def _check_optimizer(snap, j_mgr, update, tol):
    adam = _adam_state(j_mgr)
    # Adam's step count: the finite steps so far.
    assert snap["count"] == int(np.asarray(adam.count)[0]) > update
    mu, nu = _flat_state(adam.mu), _flat_state(adam.nu)
    assert sorted(mu) == sorted(snap["mu"])
    for name in mu:
        np.testing.assert_allclose(_np(snap["mu"][name]), mu[name],
                                   rtol=tol["mu"][0], atol=tol["mu"][1],
                                   err_msg=name)
        np.testing.assert_allclose(_np(snap["nu"][name]), nu[name],
                                   rtol=tol["nu"][0], atol=tol["nu"][1],
                                   err_msg=name)


def _check_parameters(snap, j_mgr, tol):
    want = _flat_state(j_mgr.state.policy_states.params)
    assert sorted(snap["params"]) == sorted(want)
    for name, w in want.items():
        g = _np(snap["params"][name])
        # Where a gradient is near 0 its sign may differ between the
        # packages and Adam moves the entry up to 2 * lr the other way.
        np.testing.assert_allclose(g, w, rtol=0, atol=2 * LR + 1e-5,
                                   err_msg=name)
        close = np.isclose(g, w, rtol=tol["close"][0], atol=tol["close"][1])
        assert close.mean() > 0.99, (name, close.mean())


def _check_states(snap, j_mgr, tol):
    j_ts = j_mgr.state.train_states
    for name, w in ema_state(policy_slice(
            j_ts.max_advantage_est_state)).items():
        np.testing.assert_allclose(_np(snap["est"][name]), w,
                                   rtol=tol["est"][0], atol=tol["est"][1],
                                   err_msg=f"max advantage estimate {name}")
    if j_ts.scaler is None:
        assert snap["scaler"] is None
    else:
        for name, w in dynamic_scale_state(j_ts.scaler).items():
            np.testing.assert_array_equal(_np(snap["scaler"][name]),
                                          w.reshape(()),
                                          err_msg=f"scaler {name}")


def _check_metrics(snap, j_mgr, tol):
    j_metrics = j_mgr.metrics.metrics
    assert sorted(snap["metrics"]) == sorted(j_metrics)
    for name, m in j_metrics.items():
        np.testing.assert_allclose(
            _np(snap["metrics"][name]), np.asarray(m.mean)[:, -1],
            rtol=tol["metrics"][0], atol=tol["metrics"][1], err_msg=name)


def test_two_update_iters_filter():
    j_mgrs, snaps, draws = run_two_update_iters(_spec("filter"))
    # The estimate moved once an update; the minibatch count came from
    # the threshold and each epoch permuted the kept rows.
    assert [int(s["est"]["N"]) for s in snaps] == [1, 2]
    perms = [i for n, i, _ in draws if n == "permutation"]
    assert len(perms) == 2
    for inp, snap in zip(perms, snaps):
        assert (inp >= 0).sum() == snap["stats"]["num_minibatches"] * 32
    assert all(s["stats"]["num_minibatches"] >= 1 for s in snaps)


def test_two_update_iters_importance():
    _, snaps, draws = run_two_update_iters(_spec("importance"))
    picks = [o for n, _, o in draws if n == "choice"]
    assert len(picks) == 2 and all(len(set(p.tolist())) == 16
                                   for p in picks)
    assert all(s["stats"]["num_minibatches"] == 2 for s in snaps)


def test_two_update_iters_stratified():
    _, snaps, draws = run_two_update_iters(_spec("stratified"))
    # One permutation a block an epoch.
    assert [o.shape for n, _, o in draws if n == "permutation"] == \
        [(16,)] * 4
    assert all(s["stats"]["num_minibatches"] == 2 for s in snaps)


def test_two_update_iters_fp16():
    _, snaps, _ = run_two_update_iters(_spec("fp16"))
    # 2 steps an update, fewer than the growth interval: the scale only
    # backs off, once a non-finite step.
    nonfinite = sum(int(s["stats"]["nonfinite_steps"]) for s in snaps)
    assert float(snaps[-1]["scaler"]["scale"]) == 65536.0 * 0.5 ** nonfinite
    for s in snaps:
        assert all(p.dtype == torch.float32 and bool(p.isfinite().all())
                   for p in s["params"].values())
