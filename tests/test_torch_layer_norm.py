"""The port's layer_norm (plain twin of the ``layer_norm_fwd`` /
``layer_norm_bwd`` kernels) and ``LayerNorm(use_kernel=True)`` against the
JAX package.

The JAX ``layer_norm`` Pallas kernel runs in interpret mode, as
tests/test_pallas_kernels.py runs it; flax's ``LayerNorm(use_pallas=True)``
is routed through it by a monkeypatch, as
``test_layer_norm_module_param_structure_invariant`` does. Inputs are made
with numpy from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import madrona_learn_tpu.ops.pallas.layer_norm as jax_ln
import madrona_learn_tpu.ops.pallas.runtime as jax_runtime
import madrona_learn_tpu_torch.models as tm
import madrona_learn_tpu_torch.models.common as common_mod
from madrona_learn_tpu.models.common import LayerNorm as JaxLayerNorm
from madrona_learn_tpu_torch.ops.cuda import KERNELS
from madrona_learn_tpu_torch.ops.cuda.layer_norm import (
    layer_norm,
    layer_norm_bwd,
    layer_norm_fwd,
    layer_norm_reference,
)

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# float32: the same math, with row sums in another order. bfloat16: the
# output is rounded once from f32, so a last-bit difference may move it by
# one bf16 ulp (2^-7 of the value at most); dw / db are f32 sums.
FWD_TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
           "bfloat16": dict(rtol=2.0 ** -7, atol=1e-6)}
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _launches():
    return {k.name: k.launches for k in KERNELS}


def _inputs(seed, N, D, jdt):
    """x rounded to ``jdt`` (as float32 numpy), weight near 1, bias."""
    rng = np.random.default_rng(seed)
    x = np.asarray(jnp.asarray(rng.normal(size=(N, D)), jnp.float32)
                   .astype(jdt).astype(jnp.float32))
    w = (rng.normal(size=(D,)) + 1.0).astype(np.float32)
    b = rng.normal(size=(D,)).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_forward_matches_pallas(dtype):
    jdt, tdt = DTYPES[dtype]
    x, w, b = _inputs(1, 300, 128, jdt)
    before = _launches()
    got = layer_norm(torch.tensor(x).to(tdt), torch.tensor(w),
                     torch.tensor(b))
    assert _launches() == before  # CPU tensors never launch a kernel
    assert got.dtype == tdt
    twin = layer_norm_reference(torch.tensor(x).to(tdt), torch.tensor(w),
                                torch.tensor(b))
    torch.testing.assert_close(got, twin, rtol=0, atol=0)
    xj = jnp.asarray(x, jdt)
    for want in (jax_ln.layer_norm(xj, jnp.asarray(w), jnp.asarray(b), 1e-6,
                                   True),
                 jax_ln.layer_norm_reference(xj, jnp.asarray(w),
                                             jnp.asarray(b))):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   **FWD_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_gradients_match_pallas(dtype):
    jdt, tdt = DTYPES[dtype]
    x, w, b = _inputs(2, 200, 64, jdt)

    def loss_jax(x_, w_, b_):
        y = jax_ln.layer_norm(x_, w_, b_, 1e-6, True)
        return jnp.sum(jnp.sin(y.astype(jnp.float32)))

    want = jax.grad(loss_jax, argnums=(0, 1, 2))(
        jnp.asarray(x, jdt), jnp.asarray(w), jnp.asarray(b))
    leaves = [torch.tensor(x).to(tdt).requires_grad_(),
              torch.tensor(w, requires_grad=True),
              torch.tensor(b, requires_grad=True)]
    got = torch.autograd.grad(
        torch.sin(layer_norm(*leaves).float()).sum(), leaves)
    assert got[0].dtype == tdt
    tols = (FWD_TOL[dtype] if dtype == "bfloat16" else GRAD_TOL, GRAD_TOL,
            GRAD_TOL)
    for name, g, wv, tol in zip(("dx", "dw", "db"), got, want, tols):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(wv.astype(jnp.float32)),
                                   err_msg=name, **tol)


def test_plain_version_is_two_pass_not_flax():
    """The kernel's twin takes mean((x - mu)^2); the flax-style module takes
    E[x^2] - E[x]^2, which cancels on rows with a large mean."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy((1e3 + rng.normal(size=(16, 64))).astype(np.float32))
    w, b = torch.ones(64), torch.zeros(64)
    x64 = x.double()
    exact = ((x64 - x64.mean(-1, keepdim=True))
             / torch.sqrt(x64.var(-1, unbiased=False, keepdim=True) + 1e-6))
    two_pass = layer_norm_reference(x, w, b).double()
    flax_style = tm.LayerNorm(64, torch.float32)(x).double()
    two_pass_err = (two_pass - exact).abs().max()
    assert two_pass_err < 1e-3  # the f32 mean of values near 1e3
    assert (flax_style - exact).abs().max() > 10 * two_pass_err


@pytest.fixture
def jax_kernel_route():
    """Route flax's LayerNorm(use_pallas=True) through the Pallas kernel in
    interpret mode."""
    orig_ln, orig_ok = jax_ln.layer_norm, jax_runtime.pallas_backend_ok
    jax_ln.layer_norm = lambda *a, **kw: orig_ln(*a, **{**kw,
                                                        "interpret": True})
    jax_runtime.pallas_backend_ok = lambda: True
    try:
        yield
    finally:
        jax_ln.layer_norm = orig_ln
        jax_runtime.pallas_backend_ok = orig_ok


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_module_kernel_option_matches_jax(jax_kernel_route, dtype):
    """LayerNorm(use_kernel=True) over a [B, E, D] input against flax's
    LayerNorm(use_pallas=True): the output, in x's dtype, and the gradients
    of x and of the impl parameters."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(4)
    D = 128
    x = np.asarray(jnp.asarray(rng.normal(size=(6, 5, D)), jnp.float32)
                   .astype(jdt).astype(jnp.float32))
    params = {"impl": {
        "scale": (1 + 0.2 * rng.normal(size=D)).astype(np.float32),
        "bias": (0.3 * rng.normal(size=D)).astype(np.float32)}}
    module = JaxLayerNorm(dtype=jdt, use_pallas=True)

    def loss_jax(p, x_):
        y = module.apply({"params": p}, x_)
        return jnp.sum(jnp.sin(y.astype(jnp.float32))), y

    (_, want), (g_p, g_x) = jax.value_and_grad(
        loss_jax, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x, jdt))

    ln = tm.LayerNorm(D, tdt, use_kernel=True)
    ln.load_state_dict({"impl.scale": torch.from_numpy(params["impl"]
                                                       ["scale"]),
                        "impl.bias": torch.from_numpy(params["impl"]
                                                      ["bias"])})
    xt = torch.tensor(x).to(tdt).requires_grad_()
    got = ln(xt)
    assert got.dtype == tdt and got.shape == xt.shape
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **FWD_TOL[dtype])
    grads = torch.autograd.grad(torch.sin(got.float()).sum(),
                                [xt, ln.impl.scale, ln.impl.bias])
    for name, g, wv in (("x", grads[0], g_x),
                        ("scale", grads[1], g_p["impl"]["scale"]),
                        ("bias", grads[2], g_p["impl"]["bias"])):
        tol = FWD_TOL[dtype] if name == "x" and dtype == "bfloat16" \
            else GRAD_TOL
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(wv.astype(jnp.float32)),
                                   err_msg=name, **tol)


def test_kernel_option_keeps_the_parameter_tree():
    """use_kernel changes the route, not the state: the same keys and
    shapes (PPO's renorm finds impl.scale / impl.bias by name)."""
    on = tm.LayerNorm(48, torch.float32, use_kernel=True)
    off = tm.LayerNorm(48, torch.float32)
    assert ({k: v.shape for k, v in on.state_dict().items()}
            == {k: v.shape for k, v in off.state_dict().items()}
            == {"impl.scale": (48,), "impl.bias": (48,)})
    on.load_state_dict(off.state_dict(), strict=True)


def test_kernel_option_routes_through_layer_norm(monkeypatch):
    """Only use_kernel=True calls layer_norm, and the trunks leave it off,
    as the JAX package's MLP and attention nets do."""
    calls = []

    def counting(*args):
        calls.append(args[0].shape)
        return layer_norm(*args)

    monkeypatch.setattr(common_mod, "layer_norm", counting)
    x = torch.randn(4, 3, 32)
    tm.LayerNorm(32, torch.float32)(x)
    assert calls == []
    tm.LayerNorm(32, torch.float32, use_kernel=True)(x)
    assert calls == [(12, 32)]
    nets = (tm.MLP(3, 32, 2, torch.float32),
            tm.EntitySelfAttentionNet({"self": 4, "others": 5}, 16, 32, 2,
                                      torch.float32))
    for net in nets:
        norms = [m for m in net.modules() if isinstance(m, tm.LayerNorm)]
        assert norms and not any(m.use_kernel for m in norms)


def test_kernel_wrappers_never_fall_back():
    """Tensors on a device that is not the CPU go to the kernel path, which
    refuses anything it cannot launch instead of taking the plain
    version."""
    before = _launches()
    meta = lambda *shape, dtype=torch.float32: torch.empty(
        *shape, dtype=dtype, device="meta")
    N, D = 8, 64
    with pytest.raises(ValueError):
        layer_norm(meta(N, D), meta(D), meta(D))
    with pytest.raises(ValueError):
        layer_norm_fwd(meta(N, D), meta(D), meta(D))
    with pytest.raises(ValueError):
        layer_norm_bwd(meta(N, D), meta(D), meta(N), meta(N), meta(N, D))
    # Widths past the kernels' register rows are refused.
    with pytest.raises(ValueError):
        layer_norm(meta(N, 2048), meta(2048), meta(2048))
    assert _launches() == before
