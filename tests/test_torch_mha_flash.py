"""The port's mha_flash (plain versions of the ``mha_flash_*`` kernels), the
large-entity route of ``SelfAttention`` and a large-entity flagship trainer
against the JAX package.

- ``mha_flash_reference`` (out and lse) against the Pallas flash kernel run
  in interpret mode (``_mha_flash_impl(..., interpret=True,
  return_lse=True)``, as tests/test_pallas_kernels.py runs it) and against
  ``mha_reference``; the gradients through ``mha_flash`` on the CPU (the
  plain FlashAttention-2 backward) against ``jax.grad`` of the Pallas
  ``mha_flash`` with its two backward kernels.
- ``SelfAttention`` sends a padded set past 256 to ``mha_flash`` and a small
  one to ``mha``; on a 300-entity set it is held against flax's, on the
  JAX package's Pallas flash route (interpret mode) and on its CPU route.
- Two ``update_iter``s of a tiny flagship over 281 entities (padded to
  288), through tests/test_torch_flagship.py's ``run_jax`` / ``run_torch``.

Inputs come from numpy seeds and go to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

import madrona_learn_tpu.models.attention as mattn
import madrona_learn_tpu.ops.pallas.attention as pattn
import madrona_learn_tpu_torch.models as tm
import madrona_learn_tpu_torch.models.attention as attention_mod
from madrona_learn_tpu_torch.compat.from_jax import actor_critic_state_dict
from madrona_learn_tpu_torch.ops.cuda import KERNELS
from madrona_learn_tpu_torch.ops.cuda.mha_flash import (
    mha_flash,
    mha_flash_bwd_dkdv,
    mha_flash_bwd_dq,
    mha_flash_delta,
    mha_flash_fwd,
    mha_flash_reference,
)
from test_torch_flagship import (
    check_gradients_and_optimizer_state,
    check_parameters_and_metrics,
    check_rollout_data,
    run_jax,
    run_torch,
)

torch.set_num_threads(1)

# float32: the same math, with the softmax and the products summed in
# another order (online over 128-key chunks on the JAX side).
F32 = dict(rtol=1e-5, atol=1e-5)
# bfloat16 outputs: both sides compute in f32 from the same bf16 inputs and
# round once, so they differ by at most one bf16 ulp (2^-7 relative).
BF16 = dict(rtol=2 ** -7, atol=1e-6)
# Gradients: f32 sums over up to 300 rows in another order, and, through a
# model, over the projections' rows as well.
GRAD = dict(rtol=1e-4, atol=1e-5)

# tests/test_pallas_kernels.py's forward and backward shapes and masks.
FWD_CASES = [((2, 256, 2, 32), None), ((2, 256, 2, 32), 200),
             ((1, 300, 4, 64), 300), ((3, 130, 2, 32), 97)]
BWD_CASES = [((2, 256, 2, 32), 250), ((2, 256, 2, 32), None),
             ((1, 300, 4, 64), 300), ((3, 130, 2, 32), 97)]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _launches():
    return {k.name: k.launches for k in KERNELS}


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,valid", FWD_CASES)
def test_mha_flash_plain_matches_pallas_and_reference(shape, valid, dtype):
    arrays = _qkv(8, shape)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    j_in = [jnp.asarray(a, jdt) for a in arrays]
    t_in = [torch.from_numpy(a).to(tdt) for a in arrays]
    valid_len = shape[1] if valid is None else valid
    before = _launches()
    out, lse = mha_flash_reference(*t_in, valid_len)
    assert torch.equal(mha_flash(*t_in, valid_len=valid), out)
    assert _launches() == before  # CPU tensors never launch a kernel
    assert out.dtype == tdt and out.shape == shape
    assert lse.dtype == torch.float32
    assert lse.shape == (shape[0], shape[2], shape[1])
    tol = F32 if dtype == "float32" else BF16
    want_out, want_lse = pattn._mha_flash_impl(*j_in, valid, True,
                                               return_lse=True)
    np.testing.assert_allclose(_np(out), _np(want_out), **tol)
    # lse is f32 on both sides, from the same (rounded) inputs.
    np.testing.assert_allclose(_np(lse), _np(want_lse), **F32)
    np.testing.assert_allclose(
        _np(out), _np(pattn.mha_reference(*j_in, valid_len=valid)), **tol)


@pytest.mark.parametrize("shape,valid", BWD_CASES)
def test_mha_flash_plain_gradients_match_pallas(shape, valid):
    arrays = _qkv(9, shape)
    probe = np.random.default_rng(10).normal(size=shape).astype(np.float32)

    def loss_jax(q, k, v):
        out = pattn.mha_flash(q, k, v, valid_len=valid, interpret=True)
        return jnp.sum(out * jnp.asarray(probe))

    want = jax.grad(loss_jax, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in arrays))
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
    before = _launches()
    out = mha_flash(*leaves, valid_len=valid)
    got = torch.autograd.grad((out * torch.from_numpy(probe)).sum(), leaves)
    assert _launches() == before
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(_np(g), _np(w), err_msg=name, **F32)
    if valid is not None and valid < shape[1]:
        # Masked keys get no gradient.
        assert not got[1][:, valid:].any() and not got[2][:, valid:].any()


def test_mha_flash_masked_keys_have_no_effect():
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _qkv(3, (2, 300, 2, 16)))
    probe = torch.randn(2, 300, 2, 16, generator=torch.Generator()
                        .manual_seed(0))

    def run(k_, v_):
        out = mha_flash(q, k_, v_, valid_len=270)
        return (out, *torch.autograd.grad((out * probe).sum(), (q, k_, v_)))

    clean = run(k, v)
    with torch.no_grad():
        k_p, v_p = k.detach().clone(), v.detach().clone()
        k_p[:, 270:] = 1e4
        v_p[:, 270:] = -1e4
    poisoned = run(k_p.requires_grad_(), v_p.requires_grad_())
    for a, b, name in zip(poisoned, clean, ("out", "dq", "dk", "dv")):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


def test_mha_flash_wrapper_refuses_what_the_kernel_cannot_take():
    """Tensors that are not on the CPU go to the kernel path, which raises
    on operands it has no instantiation for instead of taking the plain
    version."""
    before = _launches()

    def meta(*shape, dtype=torch.float32):
        return torch.empty(*shape, dtype=dtype, device="meta")

    for shape, dtype, valid_len in (
            ((4, 300, 2, 32), torch.float32, 300),   # not on the card
            ((4, 300, 2, 48), torch.float32, 300),   # D not instantiated
            ((4, 300, 2, 32), torch.float16, 300),   # dtype
            ((4, 300, 2, 32), torch.float32, 301),   # valid_len > S
            ((4, 300, 2, 32), torch.float32, 0),     # no key
            ((0, 300, 2, 32), torch.float32, 300)):  # empty batch
        qkv = [meta(*shape, dtype=dtype) for _ in range(3)]
        with pytest.raises(ValueError):
            mha_flash(*qkv, valid_len=valid_len)
        with pytest.raises(ValueError):
            mha_flash_fwd(*qkv, valid_len)
        B, S, H, _ = shape
        lse = meta(B, H, S)
        delta = meta(B, S, H)
        with pytest.raises(ValueError):
            mha_flash_bwd_dkdv(*qkv, qkv[0], lse, delta, valid_len)
        with pytest.raises(ValueError):
            mha_flash_bwd_dq(*qkv, qkv[0], lse, delta, valid_len)
    assert _launches() == before


def test_mha_flash_delta_is_the_row_sum():
    rng = np.random.default_rng(13)
    out, dout = (torch.from_numpy(rng.normal(size=(2, 5, 3, 16))
                                  .astype(np.float32)) for _ in range(2))
    want = np.sum(out.numpy() * dout.numpy(), axis=-1)
    np.testing.assert_allclose(mha_flash_delta(out, dout).numpy(), want,
                               rtol=1e-6, atol=1e-6)


def test_self_attention_routes_by_padded_length(monkeypatch):
    calls = []

    def spy(name, fn):
        def wrapped(q, k, v, valid_len):
            calls.append((name, q.shape[1], valid_len))
            return fn(q, k, v, valid_len)
        return wrapped

    monkeypatch.setattr(attention_mod, "mha", spy("mha", attention_mod.mha))
    monkeypatch.setattr(attention_mod, "mha_flash",
                        spy("mha_flash", attention_mod.mha_flash))
    attn = tm.SelfAttention(24, 2, 32, 24, torch.float32)
    x = torch.randn(3, 300, 24)
    assert attn(x).shape == (3, 300, 24)
    assert attn(x[:, :16]).shape == (3, 16, 24)
    assert attn(x[:, :256]).shape == (3, 256, 24)
    assert attn(x[:, :257]).shape == (3, 257, 24)
    assert calls == [("mha_flash", 304, 300), ("mha", 16, 16),
                     ("mha", 256, 256), ("mha_flash", 264, 257)]


@pytest.fixture(params=["pallas_interpret", "cpu_route"])
def jax_route(request, monkeypatch):
    """The JAX attention route: the Pallas kernels in interpret mode, or the
    CPU route flax takes when the kernel gate is closed."""
    if request.param == "pallas_interpret":
        for name in ("mha", "mha_flash"):
            orig = getattr(pattn, name)
            monkeypatch.setattr(
                pattn, name,
                lambda *a, _orig=orig, **kw: _orig(*a, **{**kw,
                                                        "interpret": True}))
        monkeypatch.setattr(mattn, "_pallas_backend_ok", lambda: True)
    else:
        assert not mattn._pallas_backend_ok()
    return request.param


def test_large_self_attention_matches_flax(jax_route):
    """300 entities pad to 304 (past 256): the port's mha_flash route against
    flax's SelfAttention, output and parameter gradients."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(4, 300, 24)).astype(np.float32)
    attn_j = mattn.SelfAttention(num_heads=2, qkv_features=32,
                                 out_features=24, dtype=jnp.float32,
                                 use_pallas=True)
    params = attn_j.init(random.PRNGKey(0), jnp.asarray(x))["params"]
    params = jax.tree.map(
        lambda p: p + 0.3 * jnp.asarray(rng.normal(size=p.shape),
                                        jnp.float32), params)
    attn_t = tm.SelfAttention(24, 2, 32, 24, torch.float32)
    attn_t.load_state_dict({k: torch.from_numpy(v) for k, v in
                            actor_critic_state_dict(params).items()})

    def loss_j(p):
        out = attn_j.apply({"params": p}, jnp.asarray(x))
        return jnp.sum(out ** 2), out

    (_, want), g_j = jax.value_and_grad(loss_j, has_aux=True)(params)
    got = attn_t(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    names, tensors = zip(*attn_t.named_parameters())
    g_t = dict(zip(names, torch.autograd.grad((got ** 2).sum(), tensors)))
    g_want = actor_critic_state_dict(g_j)
    assert sorted(g_t) == sorted(g_want)
    # The key bias's gradient is 0 in exact arithmetic (a constant added to
    # every score of a row leaves its softmax unchanged), so both sides hold
    # rounding noise of sums as large as the other gradients: the absolute
    # tolerance is 1e-6 of the largest gradient.
    scale = max(np.abs(w).max() for w in g_want.values())
    for name, w in g_want.items():
        np.testing.assert_allclose(_np(g_t[name]), w, err_msg=name,
                                   rtol=GRAD["rtol"], atol=1e-6 * scale)


# The tiny flagship of tests/test_torch_flagship.py over 150 allies and 130
# enemies: 281 entities, padded to 288, take mha_flash in the port; the JAX
# package takes its CPU route (flax's masked dot_product_attention).
LARGE = dict(allies=150, enemies=130)


@pytest.fixture(scope="module")
def large_jax_run():
    return run_jax(**LARGE)


@pytest.fixture(scope="module")
def large_torch_run(large_jax_run):
    calls = []
    orig = attention_mod.mha_flash

    def counting(*args):
        calls.append(args[0].shape)
        return orig(*args)

    mp = pytest.MonkeyPatch()
    mp.setattr(attention_mod, "mha_flash", counting)
    try:
        result = run_torch(large_jax_run, **LARGE)
    finally:
        mp.undo()
    # Every rollout step, the bootstrap and the update pass went through it.
    assert len(calls) >= 8 and all(s[1] == 288 for s in calls)
    return result


@pytest.mark.parametrize("update", [0, 1])
def test_large_entity_rollout_data_matches_jax(large_jax_run,
                                               large_torch_run, update):
    check_rollout_data(large_jax_run, large_torch_run, update)


@pytest.mark.parametrize("update", [0, 1])
def test_large_entity_gradients_and_optimizer_state_match_jax(
        large_jax_run, large_torch_run, update):
    check_gradients_and_optimizer_state(large_jax_run, large_torch_run,
                                        update)


@pytest.mark.parametrize("update", [0, 1])
def test_large_entity_parameters_and_metrics_match_jax(
        large_jax_run, large_torch_run, update):
    check_parameters_and_metrics(large_jax_run, large_torch_run, update)
