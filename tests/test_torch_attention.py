"""The port's attention kernel module, two-hot critic and entity net against
the JAX package.

- ``mha``: on the CPU the wrapper takes its plain version, which is held
  against the Pallas kernel run in interpret mode (as
  tests/test_pallas_kernels.py runs it) and against ``mha_reference``,
  forward and gradients.
- symlog / symexp, ``SymExpTwoHotDistribution`` and ``DreamerV3Critic``.
- ``SelfAttention`` and ``EntitySelfAttentionNet`` with flax parameters
  carried over by ``compat.from_jax``. The JAX side runs once through its
  Pallas route (``_pallas_backend_ok`` patched to True and ``mha`` in
  interpret mode, in the test only) and once through its CPU route (flax's
  masked ``dot_product_attention``).

Inputs come from a numpy seed and go to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import FrozenDict
from jax import random

import madrona_learn_tpu.models as jm
import madrona_learn_tpu.models.attention as mattn
import madrona_learn_tpu.ops.pallas.attention as pattn
import madrona_learn_tpu_torch.models as tm
from madrona_learn_tpu.ops import dists as jax_dists
from madrona_learn_tpu.utils import math as jax_math
from madrona_learn_tpu_torch import utils
from madrona_learn_tpu_torch.compat.from_jax import actor_critic_state_dict
from madrona_learn_tpu_torch.ops import dists
from madrona_learn_tpu_torch.ops.cuda import KERNELS
from madrona_learn_tpu_torch.ops.cuda.mha import (
    mha,
    mha_fwd,
    mha_reference,
)

torch.set_num_threads(1)

# Same float32 math in both packages; products and reductions sum in
# another order, which moves the last bits.
F32 = dict(rtol=1e-5, atol=1e-5)
# bfloat16 outputs: both sides compute in f32 from the same bf16 inputs and
# round once, so they differ by at most one bf16 ulp (2^-7 relative).
BF16 = dict(rtol=2 ** -7, atol=1e-6)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _launches():
    return {k.name: k.launches for k in KERNELS}


def _qkv(seed, B, S, H, D):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, S, H, D)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("valid_len", [11, 16])
def test_mha_plain_matches_pallas_and_reference(dtype, valid_len):
    # B*H = 14 is not a multiple of the TPU kernel's 8-row block.
    arrays = _qkv(valid_len, 7, 16, 2, 16)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    j_in = [jnp.asarray(a, jdt) for a in arrays]
    t_in = [torch.from_numpy(a).to(tdt) for a in arrays]
    before = _launches()
    got = mha(*t_in, valid_len=valid_len)
    assert _launches() == before  # CPU tensors never launch a kernel
    assert got.dtype == tdt and got.shape == t_in[0].shape
    tol = F32 if dtype == "float32" else BF16
    for want in (pattn.mha(*j_in, valid_len=valid_len, interpret=True),
                 pattn.mha_reference(*j_in, valid_len=valid_len)):
        np.testing.assert_allclose(_np(got), _np(want), **tol)


def test_mha_masked_keys_have_no_effect():
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 5, 16, 2, 32))
    out = mha(q, k, v, valid_len=9)
    k[:, 9:] = 1e4
    v[:, 9:] = -1e4
    torch.testing.assert_close(mha(q, k, v, valid_len=9), out, rtol=0,
                               atol=0)


def test_mha_plain_gradients_match_pallas():
    B, S, H, D, valid_len = 6, 16, 2, 16, 12
    arrays = _qkv(21, B, S, H, D)
    probe = np.random.default_rng(22).normal(size=(B, S, H, D)).astype(
        np.float32)

    def loss_jax(q, k, v):
        out = pattn.mha(q, k, v, valid_len=valid_len, interpret=True)
        return jnp.sum(out * jnp.asarray(probe))

    want = jax.grad(loss_jax, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in arrays))
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = mha(*leaves, valid_len=valid_len)
    got = torch.autograd.grad((out * torch.from_numpy(probe)).sum(), leaves)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(_np(g), _np(w), err_msg=name, **F32)
    # Padded keys get no gradient.
    assert not got[1][:, valid_len:].any() and not got[2][:, valid_len:].any()


def test_mha_wrapper_refuses_what_the_kernel_cannot_take():
    """Tensors that are not on the CPU go to the kernel path, which raises
    on operands it has no instantiation for instead of taking the plain
    version."""
    before = _launches()

    def meta(*shape, dtype=torch.float32):
        return torch.empty(*shape, dtype=dtype, device="meta")

    for shape, dtype, valid_len in (
            ((4, 16, 2, 32), torch.float32, 12),     # not on the card
            ((4, 16, 2, 48), torch.float32, 12),     # D not instantiated
            ((4, 12, 2, 32), torch.float32, 12),     # S not a multiple of 8
            ((4, 264, 2, 32), torch.float32, 12),    # S past the route
            ((4, 16, 2, 32), torch.float16, 12),     # dtype
            ((4, 16, 2, 32), torch.float32, 17)):    # valid_len > S
        qkv = [meta(*shape, dtype=dtype) for _ in range(3)]
        with pytest.raises(ValueError):
            mha(*qkv, valid_len=valid_len)
        with pytest.raises(ValueError):
            mha_fwd(*qkv, valid_len)
    assert _launches() == before


def test_symlog_symexp_match_jax():
    x = np.concatenate([np.linspace(-1e6, 1e6, 101), [0.0, -0.5, 3e-8]])
    x = x.astype(np.float32)
    for fn in ("symlog", "symexp"):
        arg = x if fn == "symlog" else np.clip(x, -20, 20)
        got = getattr(utils, fn)(torch.from_numpy(arg))
        want = getattr(jax_math, fn)(jnp.asarray(arg))
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=0,
                                   err_msg=fn)
    roundtrip = utils.symexp(utils.symlog(torch.from_numpy(x)))
    np.testing.assert_allclose(roundtrip.numpy(), x, rtol=1e-5, atol=1e-6)


def test_two_hot_mean_is_exactly_zero_at_zero_logits():
    dist = dists.SymExpTwoHotDistribution.create(torch.zeros(9, 63))
    assert dist.logits.dtype == torch.float32
    assert (dist.mean() == 0).all()
    assert dist.mean().shape == (9, 1)


def test_two_hot_mean_and_loss_match_jax():
    rng = np.random.default_rng(4)
    logits = (3 * rng.normal(size=(40, 63))).astype(np.float32)
    j_bins = np.asarray(jax_dists.SymExpTwoHotDistribution.create(
        jnp.zeros((63,)))._compute_bins())
    t_bins = dists.SymExpTwoHotDistribution.create(
        torch.zeros(63))._compute_bins()
    np.testing.assert_allclose(t_bins.numpy(), j_bins, rtol=1e-6, atol=0)
    targets = np.concatenate([
        rng.normal(0, 50, size=20),
        j_bins[[0, 5, 31, 40, 62]],            # exactly on a bin
        [0.0, 2e6, -2e6, 1e9, -1e9],           # on 0 and past either edge
        rng.normal(0, 1, size=10),
    ]).astype(np.float32)[:, None]
    j_dist = jax_dists.SymExpTwoHotDistribution.create(jnp.asarray(logits))
    t_dist = dists.SymExpTwoHotDistribution.create(torch.from_numpy(logits))
    np.testing.assert_allclose(_np(t_dist.mean()), _np(j_dist.mean()),
                               rtol=1e-5, atol=1e-5)
    got = t_dist.two_hot_cross_entropy_loss(torch.from_numpy(targets))
    want = j_dist.two_hot_cross_entropy_loss(jnp.asarray(targets))
    assert got.shape == (40, 1)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


def test_two_hot_encoding_mean_reproduces_the_target():
    """With the closer bin weighted more, a distribution that puts the
    two-hot weights on the bins has the target as its mean."""
    targets = torch.tensor([[0.3], [-7.0], [123.0], [0.0]])
    dist = dists.SymExpTwoHotDistribution.create(torch.zeros(4, 63))
    bins = dist._compute_bins()
    loss_grad = torch.func.grad(lambda lg: dists.SymExpTwoHotDistribution
                                .create(lg)
                                .two_hot_cross_entropy_loss(targets).sum())
    # d loss / d logits = softmax(logits) - two_hot, so at zero logits the
    # two-hot weights are uniform - grad.
    two_hot = torch.full((4, 63), 1 / 63) - loss_grad(torch.zeros(4, 63))
    torch.testing.assert_close((two_hot * bins).sum(-1, keepdim=True),
                               targets, rtol=1e-4, atol=1e-4)


def test_dreamer_v3_critic_matches_flax():
    rng = np.random.default_rng(6)
    feats = rng.normal(size=(10, 24)).astype(np.float32)
    critic_j = jm.DreamerV3Critic(dtype=jnp.float32)
    params = critic_j.init(random.PRNGKey(0), jnp.asarray(feats))["params"]
    critic_t = tm.DreamerV3Critic(24, torch.float32)
    # Zero init in both: the mean starts at exactly 0.
    assert (critic_t(torch.from_numpy(feats)).mean() == 0).all()
    params = jax.tree.map(
        lambda p: jnp.asarray(rng.normal(size=p.shape), jnp.float32) * 0.1,
        params)
    critic_t.load_state_dict({k: torch.from_numpy(v) for k, v in
                              actor_critic_state_dict(params).items()})
    got = critic_t(torch.from_numpy(feats))
    want = critic_j.apply({"params": params}, jnp.asarray(feats))
    np.testing.assert_allclose(_np(got.logits), _np(want.logits), **F32)
    np.testing.assert_allclose(_np(got.mean()), _np(want.mean()), **F32)


@pytest.fixture(params=["pallas_interpret", "cpu_route"])
def jax_route(request, monkeypatch):
    """The JAX attention route: the Pallas kernel in interpret mode, or the
    CPU route flax takes when the kernel gate is closed."""
    if request.param == "pallas_interpret":
        orig = pattn.mha

        def mha_interp(*args, **kwargs):
            kwargs["interpret"] = True
            return orig(*args, **kwargs)

        monkeypatch.setattr(mattn, "_pallas_backend_ok", lambda: True)
        monkeypatch.setattr(pattn, "mha", mha_interp)
    else:
        assert not mattn._pallas_backend_ok()
    return request.param


def _perturb(params, rng):
    """Random LayerNorm affine and attention biases, so the comparisons do
    not rest on their identity / zero init."""
    def walk(tree):
        return {k: walk(v) if hasattr(v, "items") else
                (jnp.asarray(np.asarray(v) + 0.3 * rng.normal(size=v.shape),
                             jnp.float32) if k in ("scale", "bias") else v)
                for k, v in tree.items()}
    return walk(params)


def _load(module, params):
    module.load_state_dict({k: torch.from_numpy(v) for k, v in
                            actor_critic_state_dict(params).items()})
    return module


def test_self_attention_matches_flax(jax_route):
    # 13 entities pad to 16; two leading batch dims fold into the kernel's.
    rng = np.random.default_rng(8)
    x = rng.normal(size=(3, 4, 13, 16)).astype(np.float32)
    attn_j = mattn.SelfAttention(num_heads=2, qkv_features=32,
                                 out_features=24, dtype=jnp.float32,
                                 use_pallas=True)
    params = _perturb(attn_j.init(random.PRNGKey(1), jnp.asarray(x))
                      ["params"], rng)
    attn_t = _load(tm.SelfAttention(16, 2, 32, 24, torch.float32), params)
    got = attn_t(torch.from_numpy(x))
    want = attn_j.apply({"params": params}, jnp.asarray(x))
    assert got.shape == (3, 4, 13, 24)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


OBS_FEATURES = {"self": 16, "allies": 12, "enemies": 12}


def _entity_obs(rng, *lead):
    return {"self": rng.normal(size=(*lead, 16)).astype(np.float32),
            "allies": rng.normal(size=(*lead, 5, 12)).astype(np.float32),
            "enemies": rng.normal(size=(*lead, 6, 12)).astype(np.float32)}


@pytest.mark.parametrize("embed,out", [(16, 32), (16, 16)])
def test_entity_net_matches_flax(jax_route, embed, out):
    rng = np.random.default_rng(9 + out)
    obs = _entity_obs(rng, 10)
    net_j = jm.EntitySelfAttentionNet(num_embed_channels=embed,
                                      num_out_channels=out, num_heads=2,
                                      dtype=jnp.float32)
    j_obs = FrozenDict({k: jnp.asarray(v) for k, v in obs.items()})
    params = _perturb(net_j.init(random.PRNGKey(2), j_obs, False)["params"],
                      rng)
    net_t = tm.EntitySelfAttentionNet(OBS_FEATURES, embed, out, 2,
                                      torch.float32)
    # Every flax parameter has a counterpart of the same shape.
    want_shapes = {k: v.shape for k, v in
                   actor_critic_state_dict(params).items()}
    assert {k: tuple(p.shape) for k, p in net_t.named_parameters()} == \
        want_shapes
    _load(net_t, params)
    got = net_t({k: torch.from_numpy(v) for k, v in obs.items()})
    want = net_j.apply({"params": params}, j_obs, False)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_entity_net_matches_flax_in_bfloat16():
    rng = np.random.default_rng(12)
    obs = _entity_obs(rng, 10)
    net_j = jm.EntitySelfAttentionNet(num_embed_channels=16,
                                      num_out_channels=32, num_heads=2,
                                      dtype=jnp.bfloat16)
    j_obs = FrozenDict({k: jnp.asarray(v) for k, v in obs.items()})
    params = _perturb(net_j.init(random.PRNGKey(3), j_obs, False)["params"],
                      rng)
    net_t = _load(tm.EntitySelfAttentionNet(OBS_FEATURES, 16, 32, 2,
                                            torch.bfloat16), params)
    got = net_t({k: torch.from_numpy(v) for k, v in obs.items()})
    want = net_j.apply({"params": params}, j_obs, False)
    assert got.dtype == torch.bfloat16
    # bf16 products and roundings after each layer: a one-ulp difference
    # inside the net moves the LayerNorm-ed output by a few bf16 ulp
    # (outputs are O(1), ulp 2^-7).
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=6e-2)
    assert np.mean(np.abs(_np(got) - _np(want)) <= 2 ** -6) > 0.9


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_entity_net_hands_the_kernel_valid_operands(monkeypatch, dtype):
    """The CPU path does not check what the CUDA wrapper checks: q, k, v
    of one dtype and shape, contiguous, from minibatch slices (transposed
    views) of stored [T, N, E, F] obs."""
    import madrona_learn_tpu_torch.models.attention as attention_mod
    from madrona_learn_tpu_torch.rollouts import RolloutData

    seen = []

    def checking_mha(q, k, v, valid_len):
        for x in (q, k, v):
            assert x.is_contiguous() and x.dtype == dtype
            assert x.shape == q.shape and x.dim() == 4
        seen.append((tuple(q.shape), valid_len))
        return mha(q, k, v, valid_len)

    monkeypatch.setattr(attention_mod, "mha", checking_mha)
    net = tm.EntitySelfAttentionNet(OBS_FEATURES, 16, 32, 2, dtype)
    rng = np.random.default_rng(13)
    data = RolloutData({"obs": {k: torch.from_numpy(v) for k, v in
                                _entity_obs(rng, 6, 4).items()}})
    obs = {k: v[torch.tensor([4, 1, 3])].transpose(0, 1)
           for k, v in data.all()["obs"].items()}
    out = net(obs)
    assert out.shape == (4, 3, 32) and out.dtype == dtype
    assert seen == [((12, 16, 2, 8), 12)]
