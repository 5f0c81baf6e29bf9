"""The chunk-indexed LayerNorm pair (``layer_norm_fwd_chunked`` /
``layer_norm_bwd_chunked``) and the populations whose trunk uses
``LayerNorm(use_kernel=True)``.

- The plain twin ``layer_norm_chunked_reference`` over a shuffled chunk
  order with C = 37 rows (not a multiple of the backward's 128-row
  partials), a policy that owns two chunks, one that owns none and a chunk
  of index P (a custom policy's: NaN rows): y, dx and each policy's
  dscale / dbias against ``jax.vmap`` of JAX's ``layer_norm`` over the
  chunks, its Pallas kernel in interpret mode (the ``jax_kernel_route``
  idea of ``test_torch_layer_norm.py``: ``interpret=True`` by keyword), a
  policy's gradients the sum of its chunks' (zeros for the policy without
  a chunk), within ``test_torch_layer_norm``'s tolerances; every row
  bitwise ``layer_norm_reference`` with its policy's weights, as each row
  of the kernel is one ``layer_norm_fwd`` launch's.
- ``LayerNorm(use_kernel=True)``'s ``chunked`` and ``batched`` forms go
  through ``layer_norm_chunked`` and equal each policy's own forward.
- A population of MLP + LSTM whose MLP LayerNorms use the kernel (the
  parameters unchanged): the chunked rollout equals the per-policy loop
  and the batched learn equals the loop (``test_torch_chunk_layout``'s and
  ``test_torch_batched_learn``'s checks).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import madrona_learn_tpu_torch.models as tm
import madrona_learn_tpu_torch.models.common as common_mod
import test_torch_batched_learn as batched_learn
import test_torch_chunk_layout as chunk_layout
from madrona_learn_tpu.ops.pallas.layer_norm import layer_norm as jax_ln
from madrona_learn_tpu_torch.models.common import StackedParams
from madrona_learn_tpu_torch.ops.cuda import KERNELS
from madrona_learn_tpu_torch.ops.cuda.layer_norm import (
    LAYER_NORM_BWD_CHUNKED,
    LAYER_NORM_FWD_CHUNKED,
    layer_norm_chunked,
    layer_norm_chunked_reference,
    layer_norm_reference,
)
from test_torch_layer_norm import DTYPES, FWD_TOL, GRAD_TOL

torch.set_num_threads(1)

# Chunks of C = 37 rows: policy 3 of P = 4 owns none, index P is a custom
# policy's chunk (NaN rows), policy 2 owns two.
ORDER, P, C, D = [2, 0, 4, 1, 2], 4, 37, 48


def _case(seed, jdt):
    """x [B * C, D] rounded to ``jdt`` (float32 numpy), the [P, D] scale
    (near 1) and bias stacks, a probe."""
    rng = np.random.default_rng(seed)
    N = len(ORDER) * C
    x = np.asarray(jnp.asarray(rng.normal(size=(N, D)), jnp.float32)
                   .astype(jdt).astype(jnp.float32))
    scale = (rng.normal(size=(P, D)) + 1.0).astype(np.float32)
    bias = rng.normal(size=(P, D)).astype(np.float32)
    probe = rng.normal(size=(N, D)).astype(np.float32)
    return x, scale, bias, probe


def _valid():
    return [b for b, p in enumerate(ORDER) if p < P]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_twin_matches_jax_vmap(dtype):
    """y over every chunk of a policy, dx, and dscale[p] / dbias[p] against
    ``jax.vmap`` of the Pallas ``layer_norm`` (interpret mode) over those
    chunks with each chunk's policy's weights, a policy's weight gradients
    the sum of its chunks'; the chunk of index P NaN; policy 3, which owns
    no chunk, zero gradients."""
    jdt, tdt = DTYPES[dtype]
    x, scale, bias, probe = _case(1, jdt)
    valid = _valid()
    idx = np.asarray(ORDER)
    xc = jnp.asarray(x.reshape(len(ORDER), C, D)[valid], jdt)

    def loss(xc, w, b):
        y = jax.vmap(lambda x, w, b: jax_ln(x, w, b, interpret=True))(
            xc, w, b)
        pr = probe.reshape(len(ORDER), C, D)[valid]
        return jnp.sum(y.astype(jnp.float32) * pr), y

    (_, y_j), (dx_j, dw_j, db_j) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
            xc, jnp.asarray(scale[idx[valid]]), jnp.asarray(bias[idx[valid]]))

    xt = torch.from_numpy(x.copy()).to(tdt).requires_grad_()
    st = torch.from_numpy(scale).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    chunk_policy = torch.tensor(ORDER, dtype=torch.int32)
    y = layer_norm_chunked(xt, st, bt, chunk_policy)
    assert y.dtype == tdt and y.shape == (len(ORDER) * C, D)
    rows = torch.arange(len(ORDER) * C).reshape(len(ORDER), C)
    good = rows[valid].reshape(-1)
    bad = rows[[b for b in range(len(ORDER)) if b not in valid]].reshape(-1)
    assert y[bad].isnan().all()
    np.testing.assert_allclose(
        y[good].float().detach().numpy(),
        np.asarray(y_j.astype(jnp.float32)).reshape(-1, D), **FWD_TOL[dtype])
    (y[good].float() * torch.from_numpy(probe)[good]).sum().backward()
    np.testing.assert_allclose(
        xt.grad[good].float().numpy(),
        np.asarray(dx_j.astype(jnp.float32)).reshape(-1, D), **GRAD_TOL)
    for got, per_chunk in ((st.grad, dw_j), (bt.grad, db_j)):
        per_chunk = np.asarray(per_chunk)
        for p in range(P):
            own = [i for i, b in enumerate(valid) if ORDER[b] == p]
            want = (per_chunk[own].sum(0) if own
                    else np.zeros(D, np.float32))
            np.testing.assert_allclose(got[p].numpy(), want, **GRAD_TOL)
    assert not st.grad[3].any() and not bt.grad[3].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_twin_rows_are_each_policys_layer_norm(dtype):
    """Every valid chunk's rows bitwise ``layer_norm_reference`` on its rows
    with its policy's scale and bias."""
    jdt, tdt = DTYPES[dtype]
    x, scale, bias, _ = _case(2, jdt)
    xt = torch.from_numpy(x.copy()).to(tdt)
    st, bt = torch.from_numpy(scale), torch.from_numpy(bias)
    y = layer_norm_chunked_reference(xt, st, bt,
                                     torch.tensor(ORDER, dtype=torch.int32))
    for b, p in enumerate(ORDER):
        rows = slice(b * C, (b + 1) * C)
        if p == P:
            assert y[rows].isnan().all()
            continue
        assert torch.equal(y[rows],
                           layer_norm_reference(xt[rows], st[p], bt[p]))


def test_chunked_kernels_are_registered_and_refuse_what_they_do_not_take():
    """Both kernels are in KERNELS beside their plain twin; on meta tensors
    (never on the card) the wrappers raise on ragged chunks, a wrong stack
    and float16, and count no launch."""
    from madrona_learn_tpu_torch.ops.cuda.layer_norm import (
        layer_norm_bwd_chunked, layer_norm_fwd_chunked)

    assert LAYER_NORM_FWD_CHUNKED in KERNELS
    assert LAYER_NORM_BWD_CHUNKED in KERNELS
    assert LAYER_NORM_FWD_CHUNKED.replaces == \
        "madrona_learn_tpu/ops/pallas/layer_norm.py:76"
    assert LAYER_NORM_BWD_CHUNKED.replaces == \
        "madrona_learn_tpu/ops/pallas/layer_norm.py:116"
    before = [k.launches for k in (LAYER_NORM_FWD_CHUNKED,
                                   LAYER_NORM_BWD_CHUNKED)]

    def meta(*shape, dtype=torch.float32):
        return torch.empty(*shape, dtype=dtype, device="meta")

    idx = meta(3, dtype=torch.int32)
    for x, w in ((meta(10, 8), meta(2, 8)),          # 10 rows, 3 chunks
                 (meta(9, 8), meta(8)),               # scale not [P, D]
                 (meta(9, 8, dtype=torch.float16), meta(2, 8))):
        with pytest.raises(ValueError):
            layer_norm_fwd_chunked(x, w, w, idx)
        with pytest.raises(ValueError):
            layer_norm_bwd_chunked(x, w, idx, meta(x.shape[0]),
                                   meta(x.shape[0]), x)
    assert [k.launches for k in (LAYER_NORM_FWD_CHUNKED,
                                 LAYER_NORM_BWD_CHUNKED)] == before


def test_kernel_layer_norm_forms_equal_each_policys_forward(monkeypatch):
    """``LayerNorm(use_kernel=True).chunked`` over chunks [1, 0, 2, 1] and
    ``batched`` over 3 policies call ``layer_norm_chunked`` and equal each
    policy's own forward bitwise (the row's arithmetic is the same)."""
    calls = []
    orig = common_mod.layer_norm_chunked
    monkeypatch.setattr(common_mod, "layer_norm_chunked",
                        lambda *a: calls.append(1) or orig(*a))
    rng = np.random.default_rng(3)
    mods = []
    for _ in range(3):
        ln = tm.LayerNorm(D, torch.float32, use_kernel=True)
        with torch.no_grad():
            ln.impl.scale.copy_(torch.from_numpy(
                rng.normal(size=D).astype(np.float32) + 1.0))
            ln.impl.bias.copy_(torch.from_numpy(
                rng.normal(size=D).astype(np.float32)))
        mods.append(ln)
    assert common_mod.chunked_form_missing(mods[0]) is None
    assert common_mod.batched_form_missing(mods[0]) is None
    params = StackedParams.of(mods)
    order = [1, 0, 2, 1]
    x = torch.from_numpy(rng.normal(size=(4, 5, D)).astype(np.float32))
    idx = torch.tensor(order, dtype=torch.int32)
    layout = types.SimpleNamespace(chunk_policy=idx, chunk_index=idx.long())
    with torch.no_grad():
        got = mods[0].chunked(params, layout, x)
        for b, p in enumerate(order):
            assert torch.equal(got[b], mods[p](x[b]))
        xs = x[:3]
        got = mods[0].batched(params, xs)
        for p in range(3):
            assert torch.equal(got[p], mods[p](xs[p]))
    assert len(calls) == 2


def _kernel_layer_norms(model):
    """``model`` with every MLP LayerNorm switched to the kernel route, its
    parameters unchanged."""
    for m in model.modules():
        if isinstance(m, tm.LayerNorm):
            m.use_kernel = True
    return model


def test_kernel_layer_norm_population_collects_chunked_as_the_loop(
        monkeypatch):
    """``test_torch_chunk_layout``'s MLP + LSTM population with the kernel
    LayerNorm: the chunked rollout takes the layout and equals the
    per-policy loop."""
    model = chunk_layout._model
    monkeypatch.setattr(chunk_layout, "_model", lambda lstm, seed:
                        _kernel_layer_norms(model(lstm, seed)))
    chunk_layout.test_chunked_rollout_equals_the_per_policy_loop(True, False)


def test_kernel_layer_norm_population_learns_batched_as_the_loop(
        monkeypatch):
    """``test_torch_batched_learn``'s MLP + LSTM population with the kernel
    LayerNorm: the batched learn is taken and equals the loop."""
    model = batched_learn._actor_critic
    monkeypatch.setattr(batched_learn, "_actor_critic",
                        lambda p, tower="lstm", dtype=torch.float32:
                        _kernel_layer_norms(model(p, tower, dtype)))
    batched, _, _ = batched_learn.check_batched_learn("uniform")
    assert batched.batched_learn
