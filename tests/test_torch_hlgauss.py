"""The port's HL-Gauss critics against the JAX package.

- The two bin-table functions give float32 tables bitwise equal to JAX's.
- ``HLGaussDist`` and ``HLGaussTwoPartDist``: ``mean``, ``loss`` and the
  loss's gradient with respect to the logits (torch autograd against
  ``jax.grad``) in float32, for targets on bin bounds and centers, outside
  the bins' range, negative, and on both sides of the two-part split at
  |t| = 2. The gradient agrees within 1e-6 absolute; the loss and the
  mean within 1e-6 plus a stated share of their terms' size (``LOSS_TOL``,
  ``MEAN_ULPS``).
- ``HLGaussCritic`` and ``HLGaussTwoPartCritic`` with flax parameters
  carried over by ``compat.from_jax``: same names and shapes both ways, and
  the same distribution from the same features.
- Two ``update_iter`` calls with each critic against the JAX package
  (``hlgauss``, ``hlgauss_twopart``), through
  ``test_torch_value_side.check_two_update_iters``.

Inputs come from a numpy seed and go to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

import madrona_learn_tpu.models as jm
import madrona_learn_tpu_torch.models as tm
from madrona_learn_tpu.ops import dists as jax_dists
from madrona_learn_tpu_torch.compat.from_jax import actor_critic_state_dict
from madrona_learn_tpu_torch.ops import dists
from test_torch_value_side import check_two_update_iters

torch.set_num_threads(1)

# The same float32 math on both sides; torch.erf and XLA's erf differ by up
# to 3e-7 (a few ulp) and the soft labels, their neighbours' differences,
# by up to 2.4e-7.
ATOL = 1e-6
# The loss is a sum over 127 bins of size ~log(127) = 4.84, where one f32
# ulp is 4.8e-7: summed in XLA's order and in torch's, identical labels
# and log-probs already give losses 9.5e-7 apart (2 ulp). So the loss gets
# 2^-22 of its size beside the 1e-6 (2.2e-6 at 4.84).
LOSS_TOL = dict(rtol=2 ** -22, atol=ATOL)
# The mean sums p_i * c_i over centers up to 100 (1920 in the two-part
# large table). torch's and XLA's exp and softmax differ by a few ulp of
# each p_i, more at larger logits (measured: up to 10 ulp of
# S = sum p_i |c_i| at logits of scale 3, 1.03 at scale 1), so the mean is
# held to 1e-6 + 16 ulp of S, row by row.
MEAN_ULPS = 16


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("args", [(), (127, -100, 100), (63, -20, 20),
                                  (9, -3.5, 3.5)])
def test_hlgauss_bins_bitwise_jax(args):
    want = jm.make_hlgauss_bins(*args)
    got = tm.make_hlgauss_bins(*args)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(_np(g), np.asarray(w))


def test_hlgauss_two_part_bins_bitwise_jax():
    want = jm.make_hlgauss_two_part_bins()
    got = tm.make_hlgauss_two_part_bins()
    for g_part, w_part in zip(got, want):
        for g, w in zip(g_part, w_part):
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(_np(g), np.asarray(w))


def _edge_targets(centers, bounds, rng):
    """Every interior bound and center, the outer ones, targets past both
    ends, 0 and -0, and random ones of both signs."""
    centers, bounds = np.asarray(centers), np.asarray(bounds)
    span = float(bounds[-1])
    t = np.concatenate([
        bounds, centers,
        [0.0, -0.0, 1.5 * span, -1.5 * span, 10 * span, -10 * span,
         np.nextafter(centers[0], -np.inf), np.nextafter(centers[-1], np.inf),
         np.nextafter(bounds[1], np.inf), np.nextafter(bounds[1], -np.inf)],
        rng.normal(scale=span / 4, size=64),
    ]).astype(np.float32)
    return t[:, None]


def _split_targets(rng):
    """Around the two-part split: |t| < 2, |t| = 2 and |t| >= 2, both
    signs, on integers and halves, and far out."""
    t = np.concatenate([
        [0.0, -0.0, 2.0, -2.0, 1.9999999, -1.9999999, 2.0000002, -2.0000002,
         1.0, -1.0, 3.0, -3.0, 4.0, -4.0, 0.5, -0.5, 2.5, -2.5, 1e-6, -1e-6,
         1919.0, -1919.0, 1920.0, -1920.0, 5000.0, -5000.0],
        rng.uniform(-2, 2, size=32),
        rng.normal(scale=30, size=32),
        rng.normal(scale=600, size=16),
    ]).astype(np.float32)
    return t[:, None]


def _jax_dist(logits, centers, bounds):
    return jax_dists.HLGaussDist(logits=logits, smoothness=0.75,
                                 centers=centers, bounds=bounds)


def _torch_dist(logits, centers, bounds):
    return dists.HLGaussDist(logits, 0.75, centers, bounds)


def _term_scale(dist):
    """sum_i p_i |c_i| of a JAX distribution, row by row: the size of the
    terms its mean sums."""
    if hasattr(dist, "small_dist"):
        return _term_scale(dist.small_dist) + _term_scale(dist.large_dist)
    probs = np.asarray(jax.nn.softmax(dist.logits))
    return (probs * np.abs(np.asarray(dist.centers))).sum(-1, keepdims=True)


def _check_dist(make_jax, make_torch, logits, targets):
    """mean, loss and d(sum loss)/d(logits), torch against JAX."""
    j_logits, j_targets = jnp.asarray(logits), jnp.asarray(targets)
    j_dist = make_jax(j_logits)
    j_grad = jax.grad(lambda lg: make_jax(lg).loss(j_targets).sum())(
        j_logits)

    t_logits = _t(logits).requires_grad_()
    t_dist = make_torch(t_logits)
    t_loss = t_dist.loss(_t(targets))
    (t_grad,) = torch.autograd.grad(t_loss.sum(), t_logits)

    err = np.abs(_np(t_dist.mean()) - np.asarray(j_dist.mean()))
    limit = ATOL + MEAN_ULPS * 2 ** -24 * _term_scale(j_dist)
    assert (err <= limit).all(), ("mean", err.max(), (err / limit).max())
    np.testing.assert_allclose(_np(t_loss),
                               np.asarray(j_dist.loss(j_targets)),
                               err_msg="loss", **LOSS_TOL)
    np.testing.assert_allclose(_np(t_grad), np.asarray(j_grad), rtol=0,
                               atol=ATOL, err_msg="grad")


@pytest.mark.parametrize("logit_scale", [0.0, 1.0, 3.0])
def test_hlgauss_dist_matches_jax(logit_scale):
    rng = np.random.default_rng(1)
    centers, bounds = jm.make_hlgauss_bins()
    t_centers, t_bounds = tm.make_hlgauss_bins()
    targets = _edge_targets(centers, bounds, rng)
    logits = (logit_scale * rng.normal(size=(targets.shape[0], 127))
              ).astype(np.float32)
    _check_dist(lambda lg: _jax_dist(lg, centers, bounds),
                lambda lg: _torch_dist(lg, t_centers, t_bounds),
                logits, targets)


@pytest.mark.parametrize("part", ["small", "large"])
def test_hlgauss_dist_on_float_format_bins_matches_jax(part):
    """One HL-Gauss head on each two-part table, whose bin widths vary."""
    rng = np.random.default_rng(2)
    index = ("small", "large").index(part)
    centers, bounds = jm.make_hlgauss_two_part_bins()[index]
    t_centers, t_bounds = tm.make_hlgauss_two_part_bins()[index]
    targets = _edge_targets(centers, bounds, rng)
    logits = rng.normal(size=(targets.shape[0], 127)).astype(np.float32)
    _check_dist(lambda lg: _jax_dist(lg, centers, bounds),
                lambda lg: _torch_dist(lg, t_centers, t_bounds),
                logits, targets)


def test_two_part_split_matches_jax():
    """JAX's % is a floored modulo by 2 with the target's sign; the port's
    split gives the same parts, bitwise."""
    t = _split_targets(np.random.default_rng(3))
    j_t = jnp.asarray(t)
    j_small = j_t % (jnp.where(j_t >= 0, 1, -1) * 2)
    t_t = _t(t)
    t_small = torch.remainder(t_t, torch.where(t_t >= 0, 2.0, -2.0))
    np.testing.assert_array_equal(_np(t_small), np.asarray(j_small))
    np.testing.assert_array_equal(_np(t_t - t_small),
                                  np.asarray(j_t - j_small))
    assert (np.abs(_np(t_small)) < 2).all()


@pytest.mark.parametrize("logit_scale", [0.0, 1.0])
def test_hlgauss_two_part_dist_matches_jax(logit_scale):
    rng = np.random.default_rng(4)
    (sc, sb), (lc, lb) = jm.make_hlgauss_two_part_bins()
    (tsc, tsb), (tlc, tlb) = tm.make_hlgauss_two_part_bins()
    targets = _split_targets(rng)
    n = targets.shape[0]
    logits = (logit_scale * rng.normal(size=(n, 2 * 127))).astype(np.float32)

    def make_jax(lg):
        return jax_dists.HLGaussTwoPartDist(
            small_dist=_jax_dist(lg[:, :127], sc, sb),
            large_dist=_jax_dist(lg[:, 127:], lc, lb))

    def make_torch(lg):
        return dists.HLGaussTwoPartDist(
            small_dist=_torch_dist(lg[:, :127], tsc, tsb),
            large_dist=_torch_dist(lg[:, 127:], tlc, tlb))

    _check_dist(make_jax, make_torch, logits, targets)


def test_merge_time_keeps_the_bins():
    rng = np.random.default_rng(5)
    (sc, sb), (lc, lb) = tm.make_hlgauss_two_part_bins()
    logits = _t(rng.normal(size=(6, 127)).astype(np.float32))
    dist = dists.HLGaussTwoPartDist(_torch_dist(logits, sc, sb),
                                    _torch_dist(2 * logits, lc, lb))
    merged = dist.merge_time(2, 3)
    np.testing.assert_array_equal(_np(merged.mean()).reshape(6, 1),
                                  _np(dist.mean()))
    targets = _t(rng.normal(scale=5, size=(6, 1)).astype(np.float32))
    np.testing.assert_array_equal(
        _np(merged.loss(targets.reshape(2, 3, 1))).reshape(6, 1),
        _np(dist.loss(targets)))


def _flax_params(module, features, rng):
    """The module's flax parameters, moved off their zero init."""
    params = module.init(random.PRNGKey(0), jnp.asarray(features))["params"]
    return jax.tree.map(
        lambda p: jnp.asarray(0.1 * rng.normal(size=p.shape), jnp.float32),
        params)


def _critics(kind, dtype_name, in_features):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype_name]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype_name]
    if kind == "hlgauss":
        return (jm.HLGaussCritic.create(dtype=jdt),
                tm.HLGaussCritic.create(in_features, tdt))
    return (jm.HLGaussTwoPartCritic.create(dtype=jdt),
            tm.HLGaussTwoPartCritic.create(in_features, tdt))


@pytest.mark.parametrize("kind", ["hlgauss", "two_part"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_critic_from_jax_matches_flax(kind, dtype):
    rng = np.random.default_rng(6)
    features = rng.normal(size=(40, 24)).astype(np.float32)
    targets = rng.normal(scale=8, size=(40, 1)).astype(np.float32)
    j_critic, t_critic = _critics(kind, dtype, 24)
    params = _flax_params(j_critic, features, rng)

    state = actor_critic_state_dict({"params": params})
    names = {"hlgauss": ["Dense_0.bias", "Dense_0.kernel"],
             "two_part": ["large.bias", "large.kernel", "small.bias",
                          "small.kernel"]}[kind]
    assert sorted(state) == names
    assert sorted(t_critic.state_dict()) == names
    t_critic.load_state_dict({k: torch.from_numpy(v)
                              for k, v in state.items()})
    # Back the other way: the port's parameters are flax's.
    for name, p in t_critic.named_parameters():
        np.testing.assert_array_equal(_np(p), state[name], err_msg=name)

    j_dist = j_critic.apply({"params": params}, jnp.asarray(features))
    with torch.no_grad():
        t_dist = t_critic(_t(features))
    # float32: the same products summed in another order; bfloat16: both
    # round the same f32 products to bf16 once, one ulp apart at most.
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == "float32"
           else dict(rtol=2 ** -7, atol=2e-2))
    np.testing.assert_allclose(_np(t_dist.mean()), np.asarray(j_dist.mean()),
                               **tol)
    np.testing.assert_allclose(
        _np(t_dist.loss(_t(targets))),
        np.asarray(j_dist.loss(jnp.asarray(targets))), **tol)


@pytest.mark.parametrize("kind", ["hlgauss", "two_part"])
def test_zero_init_critic_mean_is_zero(kind):
    _, t_critic = _critics(kind, "float32", 16)
    features = torch.randn(8, 16, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        dist = t_critic(features)
    assert dist.mean().shape == (8, 1)
    assert bool((dist.mean() == 0).all())


@pytest.mark.parametrize("name", ["hlgauss", "hlgauss_twopart"])
def test_two_update_iters_match_jax(name):
    check_two_update_iters(name)
