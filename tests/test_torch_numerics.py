"""The port's numeric primitives against the JAX package and its oracles.

EMA statistics, Welford metrics, discrete distributions, GAE / returns and
z-scoring: the same numpy-seeded inputs go through the JAX function and its
port, and the port also meets the float64 oracles of tests/test_ema.py and
tests/test_gae.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_learn_tpu.ops import dists as jax_dists
from madrona_learn_tpu.ops import ema as jax_ema
from madrona_learn_tpu.ops import gae as jax_gae
from madrona_learn_tpu.ops.metrics import Metric as JaxMetric
from madrona_learn_tpu_torch.ops import dists, ema, gae
from madrona_learn_tpu_torch.ops.metrics import Metric, TrainingMetrics
from test_ema import CHUNK, DECAY, DIM, NUM_SUBCHUNKS, naive_oracle
from test_gae import make_data, naive_gae, naive_returns

torch.set_num_threads(1)


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def test_ema_normalizer_matches_jax_and_float64_oracle():
    j_norm = jax_ema.EMANormalizer(decay=DECAY, norm_dtype=jnp.float32,
                                   inv_dtype=jnp.float32)
    t_norm = ema.EMANormalizer(decay=DECAY, norm_dtype=torch.float32)
    rng = np.random.default_rng(7)
    j_est = j_norm.init_estimates(jnp.zeros((1, DIM)))
    t_est = t_norm.init_estimates(torch.zeros(1, DIM))
    batches = []
    for it in range(40):
        loc = 5.0 * np.sin(it / 20.0) + np.arange(DIM)
        chunks = rng.normal(loc, 1.0 + 0.5 * np.cos(it / 15.0),
                            size=(NUM_SUBCHUNKS, CHUNK, DIM)).astype(
                                np.float32)
        batches.append(chunks.reshape(-1, DIM))
        j_stats = j_norm.init_input_stats(j_est)
        t_stats = t_norm.init_input_stats(t_est)
        for i in range(NUM_SUBCHUNKS):
            j_stats = j_norm.update_input_stats(j_stats, i,
                                                jnp.asarray(chunks[i]))
            t_stats = t_norm.update_input_stats(t_stats, i,
                                                torch.from_numpy(chunks[i]))
        j_est = j_norm.update_estimates(j_est, j_stats)
        t_est = t_norm.update_estimates(t_est, t_stats)

    # Same float32 formulas; reductions may sum in another order.
    for key in ("mu", "inv_sigma", "sigma", "mu_biased", "sigma_sq_biased"):
        np.testing.assert_allclose(_np(t_est[key]), _np(j_est[key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    assert int(t_est["N"]) == int(j_est["N"]) == 40
    # The float64 oracle, with tests/test_ema.py's tolerances.
    mu_ref, var_ref = naive_oracle(batches, DECAY)
    np.testing.assert_allclose(_np(t_est["mu"]), mu_ref, rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(_np(t_est["sigma"]), np.sqrt(var_ref),
                               rtol=2e-3, atol=2e-3)

    x = rng.normal(size=(32, DIM)).astype(np.float32)
    t_x = t_norm.normalize(t_est, torch.from_numpy(x))
    np.testing.assert_allclose(_np(t_x), _np(j_norm.normalize(
        j_est, jnp.asarray(x))), rtol=1e-6, atol=1e-6)


def test_ema_normalizer_bf16_output_matches_jax():
    j_norm = jax_ema.EMANormalizer(decay=0.99999, norm_dtype=jnp.bfloat16,
                                   inv_dtype=jnp.bfloat16)
    t_norm = ema.EMANormalizer(decay=0.99999, norm_dtype=torch.bfloat16)
    x = np.random.default_rng(1).normal(2.0, 3.0, size=(64, 5)).astype(
        np.float32)
    j_est = j_norm.update_estimates(
        j_norm.init_estimates(jnp.asarray(x)),
        j_norm.update_input_stats(j_norm.init_input_stats(
            j_norm.init_estimates(jnp.asarray(x))), 0, jnp.asarray(x)))
    t_est = t_norm.update_estimates(
        t_norm.init_estimates(torch.from_numpy(x)),
        t_norm.update_input_stats(t_norm.init_input_stats(
            t_norm.init_estimates(torch.from_numpy(x))), 0,
            torch.from_numpy(x)))
    got = t_norm.normalize(t_est, torch.from_numpy(x))
    want = j_norm.normalize(j_est, jnp.asarray(x))
    assert got.dtype == torch.bfloat16
    # Rounded once to bf16 from nearly equal f32 values: at most one ulp.
    np.testing.assert_allclose(_np(got.float()),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -7, atol=1e-6)


def test_ema_estimate_matches_jax():
    j_cfg = jax_ema.EMAEstimate(decay=0.9)
    t_cfg = ema.EMAEstimate(decay=0.9)
    j_est = j_cfg.init_estimates(jnp.zeros((1,)))
    t_est = t_cfg.init_estimates(torch.zeros(1))
    rng = np.random.default_rng(2)
    for _ in range(6):
        x = rng.normal(size=(16,)).astype(np.float32)
        j_est = j_cfg.update_estimates(j_est, jnp.asarray(x))
        t_est = t_cfg.update_estimates(t_est, torch.from_numpy(x))
    # The batch means sum in another order: a few f32 ulps.
    np.testing.assert_allclose(_np(t_est["mu"]), _np(j_est["mu"]),
                               rtol=1e-5)
    # Constant input comes back exactly (bias corrected).
    t_est = t_cfg.init_estimates(torch.zeros(1))
    for _ in range(5):
        t_est = t_cfg.update_estimates(t_est, torch.full((16,), 3.5))
    np.testing.assert_allclose(_np(t_est["mu"]), 3.5, rtol=1e-6)


def test_welford_metrics_match_jax():
    rng = np.random.default_rng(4)
    a = rng.normal(size=(7, 3)).astype(np.float32)
    b = rng.normal(size=(5, 3)).astype(np.float32)
    mask = rng.random((5, 3)) < 0.6
    j = JaxMetric.init_from_data(True, jnp.asarray(a)).merge(
        JaxMetric.init_from_data_masked(True, jnp.asarray(b),
                                        jnp.asarray(mask)))
    t = Metric.init_from_data(True, torch.from_numpy(a)).merge(
        Metric.init_from_data_masked(True, torch.from_numpy(b),
                                     torch.from_numpy(mask)))
    for field in ("mean", "m2", "min", "max"):
        np.testing.assert_allclose(_np(getattr(t, field)),
                                   _np(getattr(j, field)), rtol=1e-5,
                                   atol=1e-6, err_msg=field)
    assert int(t.count) == int(j.count) == 7 * 3 + int(mask.sum())
    # The merge is exact: equal to the statistics of the union.
    union = np.concatenate([a.ravel(), b[mask]])
    np.testing.assert_allclose(float(t.mean), union.mean(), rtol=1e-5)
    np.testing.assert_allclose(float(t.m2),
                               ((union - union.mean()) ** 2).sum(),
                               rtol=1e-4)


def test_training_metrics_ring_buffer():
    m = TrainingMetrics({"Loss": Metric.init(True), "Step": Metric.init(False)},
                        buffer_size=2, start_update_idx=0, num_policies=1)
    m.record({"Loss": torch.tensor([[1.0, 3.0]]), "Step": torch.tensor(5.0)})
    m.advance()
    m.record({"Loss": torch.tensor([[10.0]]), "Step": torch.tensor(6.0)})
    m.advance()
    assert m.update_idx == 2 and m.cur_buffer_offset == 0
    assert m.metrics["Loss"].mean.shape == (1, 2)
    np.testing.assert_allclose(_np(m.metrics["Loss"].mean), [[2.0, 10.0]])
    np.testing.assert_allclose(_np(m.latest("Step").mean), 6.0)
    np.testing.assert_allclose(_np(m.latest("Loss").m2), [0.0])


def test_discrete_action_stats_match_jax():
    buckets = [3, 5]
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(64, 8)).astype(np.float32)
    actions = np.stack([rng.integers(0, 3, 64), rng.integers(0, 5, 64)], -1)
    j = jax_dists.DiscreteActionDistributions(buckets, jnp.asarray(logits))
    t = dists.DiscreteActionDistributions(buckets, torch.from_numpy(logits))
    j_lp, j_ent = j.action_stats(jnp.asarray(actions, jnp.int32))
    t_lp, t_ent = t.action_stats(torch.from_numpy(actions))
    np.testing.assert_allclose(_np(t_lp), _np(j_lp), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(t_ent), _np(j_ent), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(_np(t.best()), _np(j.best()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_discrete_sample_consistent_with_stats(dtype):
    """Sampled log-probs equal action_stats' (so PPO's ratio starts at 1),
    samples lie in range, bf16 logits are upcast."""
    buckets = [3, 5]
    logits = torch.from_numpy(np.random.default_rng(1).normal(
        size=(256, 8)).astype(np.float32)).to(dtype)
    d = dists.DictActionDistributions(
        {"move": dists.DiscreteActionDistributions(buckets, logits)})
    gen = torch.Generator().manual_seed(0)
    actions, log_probs = d.sample(gen)
    a = actions["move"]
    assert a.shape == (256, 2) and a.dtype == torch.int32
    assert (a[:, 0] < 3).all() and (a[:, 1] < 5).all() and (a >= 0).all()
    assert log_probs["move"].dtype == torch.float32
    stats_lp, ent = d.action_stats(actions)
    torch.testing.assert_close(stats_lp["move"], log_probs["move"], rtol=0,
                               atol=0)
    assert (ent["move"] >= 0).all()
    # The same generator state draws the same actions.
    gen2 = torch.Generator().manual_seed(0)
    torch.testing.assert_close(d.sample(gen2)[0]["move"], a)


def test_discrete_sample_frequencies():
    logits = torch.log(torch.tensor([[0.1, 0.2, 0.7]])).repeat(20000, 1)
    d = dists.DiscreteActionDistributions([3], logits)
    a, _ = d.sample(torch.Generator().manual_seed(5))
    freq = torch.bincount(a[:, 0].long(), minlength=3).float() / 20000
    np.testing.assert_allclose(_np(freq), [0.1, 0.2, 0.7], atol=0.015)


def test_gae_and_returns_match_jax_and_oracle():
    gamma, lam = 0.99, 0.95
    rewards, values, dones, bootstrap = make_data()
    C, TC, P, B, _ = rewards.shape
    T, N = C * TC, P * B
    t_args = [torch.from_numpy(x) for x in (rewards, values, dones,
                                            bootstrap)]
    j_args = [jnp.asarray(x) for x in (rewards, values, dones, bootstrap)]

    adv = gae.compute_advantages(gamma, lam, *t_args)
    np.testing.assert_allclose(
        _np(adv), _np(jax_gae.compute_advantages(gamma, lam, *j_args)),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        _np(adv).reshape(T, N),
        naive_gae(gamma, lam, rewards.reshape(T, N), values.reshape(T, N),
                  dones.reshape(T, N), bootstrap.reshape(N)),
        rtol=1e-4, atol=1e-4)

    ret = gae.compute_returns(gamma, t_args[0], t_args[2], t_args[3])
    np.testing.assert_allclose(
        _np(ret), _np(jax_gae.compute_returns(gamma, j_args[0], j_args[2],
                                              j_args[3])),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        _np(ret).reshape(T, N),
        naive_returns(gamma, rewards.reshape(T, N), dones.reshape(T, N),
                      bootstrap.reshape(N)), rtol=1e-4, atol=1e-4)


def test_zscore_matches_jax():
    x = np.random.default_rng(0).normal(3, 2, size=(16, 8, 1)).astype(
        np.float32)
    got = gae.zscore_data(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), _np(jax_gae.zscore_data(
        jnp.asarray(x))), rtol=1e-5, atol=1e-5)
    assert abs(float(got.mean())) < 1e-4
