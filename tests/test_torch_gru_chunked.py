"""The chunk-indexed GRU kernels (``gru_sequence_fwd_chunked``,
``gru_sequence_bwd_chunked``): JAX's ``vmap`` over policies of its GRU
kernel and cell, in the port.

- ``gru_sequence_chunked_reference``, the plain twin whose autograd
  defines the backward: at T = 16 against ``jax.vmap`` over policies of
  JAX's Pallas ``gru_sequence`` in interpret mode (each policy's
  minibatch one chunk, as in learn), its gradients against ``jax.vmap`` of
  ``jax.vjp`` of that kernel, within 1e-5;
- the rollout step (``gru_step_chunked``, T = 1) against ``jax.vmap`` over
  chunks of JAX's GRU cell with each chunk's policy's weights, as JAX's
  collect ``vmap``s a policy over its chunks;
- chunk by chunk at C = 37 in a shuffled order: each chunk bitwise
  ``gru_sequence_reference`` and its gradients with its policy's weights,
  a policy's weight gradients the sum over its chunks, zeros for a policy
  without a chunk, NaN rows for a chunk of index P or -1;
- the wrappers' routes, arguments and launch counts against a stand-in
  library, and their refusals.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import madrona_learn_tpu_torch.ops.cuda.gru as gru_mod
from madrona_learn_tpu.models.gru import _PackedGRULayer as JaxGRULayer
from madrona_learn_tpu.ops.pallas.gru import gru_sequence as jax_gru_seq
from madrona_learn_tpu_torch.ops.cuda import (GRU_BWD_CHUNKED,
                                              GRU_FWD_CHUNKED, KERNELS)
from madrona_learn_tpu_torch.ops.cuda.gru import (
    gru_sequence_bwd_chunked,
    gru_sequence_chunked,
    gru_sequence_chunked_reference,
    gru_sequence_fwd_chunked,
    gru_sequence_fwd_chunked_reference,
    gru_sequence_reference,
    gru_step_chunked,
)
from test_torch_lstm_fwd_tc_numerics import _FakeLibrary

torch.set_num_threads(1)

F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16


def _chunked_inputs(seed, T, B, C, H, P):
    """x_proj [T, B * C, 3H], keep, wh [P, H, 3H], bias_h [P, H], h0 and a
    probe [T, B * C, H], float32."""
    rng = np.random.default_rng(seed)
    N = B * C
    f = lambda *shape, scale=1.0: torch.from_numpy(
        (rng.normal(size=shape) * scale).astype(np.float32))
    keep = torch.from_numpy((rng.random((T, N)) > 0.3).astype(np.float32))
    return (f(T, N, 3 * H), keep, f(P, H, 3 * H, scale=H ** -0.5),
            f(P, H, scale=0.1), f(N, H), f(T, N, H))


def _per_policy(t, T, P, C):
    """[T, P * C, ...] -> [P, T, C, ...]; [P * C, ...] -> [P, C, ...]."""
    a = t.numpy()
    if a.shape[0] == P * C:
        return jnp.asarray(a.reshape(P, C, *a.shape[1:]))
    return jnp.asarray(a.reshape(T, P, C, *a.shape[2:]).swapaxes(0, 1))


def _from_policies(a, T, P, C):
    """[P, T, C, ...] -> [T, P * C, ...]; [P, C, ...] -> [P * C, ...]."""
    a = np.asarray(a)
    if a.ndim == 3 and a.shape[1] == C:
        return a.reshape(P * C, *a.shape[2:])
    return a.swapaxes(0, 1).reshape(T, P * C, *a.shape[3:])


def _twin_grads(x, keep, wh, bias_h, chunk_policy, h0, probe):
    """(dx_proj, dwh, dbh, dh0) by autograd of the plain twin."""
    leaves = [t.clone().requires_grad_() for t in (x, wh, bias_h, h0)]
    ys = gru_sequence_chunked_reference(leaves[0], keep, leaves[1],
                                        leaves[2], chunk_policy, leaves[3])
    return torch.autograd.grad((ys * probe).sum(), leaves)


T_LEARN, P_LEARN, C_LEARN, H_TWIN = 16, 3, 8, 128


def test_chunked_forward_twin_matches_jax_vmapped_pallas():
    """Each policy's minibatch one chunk (chunk_policy = arange(P)), T =
    16: the twin's ys against ``jax.vmap`` over the policies of the Pallas
    ``gru_sequence`` in interpret mode, within 1e-5."""
    T, P, C, H = T_LEARN, P_LEARN, C_LEARN, H_TWIN
    x, keep, wh, bh, h0, _ = _chunked_inputs(3, T, P, C, H, P)
    got = gru_sequence_fwd_chunked_reference(
        x, keep, wh, bh, torch.arange(P, dtype=torch.int32), h0)
    want = jax.vmap(lambda x, keep, wh, bh, h0: jax_gru_seq(
        x, keep, wh, bh, h0, True))(
        _per_policy(x, T, P, C), _per_policy(keep, T, P, C),
        jnp.asarray(wh.numpy()), jnp.asarray(bh.numpy()),
        _per_policy(h0, T, P, C))
    np.testing.assert_allclose(got.numpy(), _from_policies(want, T, P, C),
                               rtol=1e-5, atol=1e-5)


def test_chunked_backward_twin_matches_jax_vmapped_pallas_vjp():
    """The twin's dx_proj, dwh[p], dbh[p] and dh0 against ``jax.vmap`` over
    the policies of ``jax.vjp`` of the Pallas ``gru_sequence`` in
    interpret mode (its backward kernel's dxp, dwh and dbh8 row 0), within
    1e-5."""
    T, P, C, H = T_LEARN, P_LEARN, C_LEARN, H_TWIN
    x, keep, wh, bh, h0, probe = _chunked_inputs(4, T, P, C, H, P)
    got = _twin_grads(x, keep, wh, bh, torch.arange(P, dtype=torch.int32),
                      h0, probe)

    def vjp(x, keep, wh, bh, h0, probe):
        _, pull = jax.vjp(
            lambda x, wh, bh, h0: jax_gru_seq(x, keep, wh, bh, h0, True),
            x, wh, bh, h0)
        return pull(probe)

    want = jax.vmap(vjp)(
        _per_policy(x, T, P, C), _per_policy(keep, T, P, C),
        jnp.asarray(wh.numpy()), jnp.asarray(bh.numpy()),
        _per_policy(h0, T, P, C), _per_policy(probe, T, P, C))
    dx, dwh, dbh, dh0 = (np.asarray(w) for w in want)
    wants = (_from_policies(dx, T, P, C), dwh, dbh,
             _from_policies(dh0, T, P, C))
    for name, g, w in zip(("dx_proj", "dwh", "dbh", "dh0"), got, wants):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_chunked_step_matches_jax_vmapped_cell():
    """The rollout step at T = 1 over chunks in a shuffled order (a policy
    owning several chunks, as collect's layout gives): ``gru_step_chunked``
    (on the CPU, the twin) against ``jax.vmap`` over the chunks of JAX's
    GRU cell (``models/gru.py:_PackedGRULayer``) with each chunk's
    policy's recurrent kernel and bias, within 1e-5."""
    B, C, H, P = 7, 5, H_TWIN, 3
    order = [1, 0, 2, 1, 1, 0, 2]
    x, _, wh, bh, h, _ = _chunked_inputs(5, 1, B, C, H, P)
    idx = torch.tensor(order, dtype=torch.int32)
    got = gru_step_chunked(x[0], wh, bh, idx, h)
    cell = JaxGRULayer(hidden=H, dtype=jnp.float32)

    def step(wh_b, bh_b, h_b, xp_b):
        params = {"params": {"recurrent_kernel": wh_b, "bias_h": bh_b}}
        return cell.apply(params, h_b, None, xp_b)[1]

    gather = lambda t: jnp.asarray(t.numpy()[np.asarray(order)])
    want = jax.vmap(step)(gather(wh), gather(bh),
                          jnp.asarray(h.numpy().reshape(B, C, H)),
                          jnp.asarray(x[0].numpy().reshape(B, C, 3 * H)))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want).reshape(B * C, H),
                               rtol=1e-5, atol=1e-5)


def test_chunked_twin_is_each_chunks_reference():
    """At C = 37 (no multiple of a tile) in a shuffled chunk order: each
    chunk's ys, dx_proj and dh0 bitwise ``gru_sequence_reference`` and its
    gradients on its rows with its policy's weights; a policy's dwh / dbh
    the sum over its chunks; zeros for policy 4, which owns no chunk; a
    chunk of index P or -1 NaN rows, the others unchanged."""
    T, C, H, P = 4, 37, 16, 5
    order = [2, 0, 3, 2, 1, 0]
    idx = torch.tensor(order, dtype=torch.int32)
    x, keep, wh, bh, h0, probe = _chunked_inputs(6, T, len(order), C, H, P)
    ys = gru_sequence_fwd_chunked_reference(x, keep, wh, bh, idx, h0)
    dx, dwh, dbh, dh0 = _twin_grads(x, keep, wh, bh, idx, h0, probe)
    sums = {}
    for b, p in enumerate(order):
        rows = slice(b * C, (b + 1) * C)
        leaves = [t.clone().requires_grad_() for t in (
            x[:, rows], wh[p], bh[p], h0[rows])]
        y1 = gru_sequence_reference(leaves[0], keep[:, rows], *leaves[1:])
        assert torch.equal(ys[:, rows], y1)
        g = torch.autograd.grad((y1 * probe[:, rows]).sum(), leaves)
        assert torch.equal(dx[:, rows], g[0]) and torch.equal(dh0[rows], g[3])
        w, b_ = sums.get(p, (0.0, 0.0))
        sums[p] = (w + g[1], b_ + g[2])
    for p in range(P):
        if p not in sums:
            assert not dwh[p].any() and not dbh[p].any()
            continue
        torch.testing.assert_close(dwh[p], sums[p][0], rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(dbh[p], sums[p][1], rtol=1e-6, atol=1e-6)
    bad = idx.clone()
    bad[1], bad[3] = P, -1
    yb = gru_sequence_fwd_chunked_reference(x, keep, wh, bh, bad, h0)
    skipped = torch.zeros(len(order), dtype=torch.bool)
    skipped[[1, 3]] = True
    rows = skipped.repeat_interleave(C)
    assert yb[:, rows].isnan().all()
    assert torch.equal(yb[:, ~rows], ys[:, ~rows])
    # On the CPU the differentiable entry point is the twin.
    assert torch.equal(gru_sequence_chunked(x, keep, wh, bh, idx, h0), ys)


# -- The wrappers on a stand-in card -----------------------------------------

def _stand_in_card(monkeypatch):
    """A stand-in library, operand check, stream and SM count for CPU
    operands."""
    lib = _FakeLibrary()
    monkeypatch.setattr(gru_mod, "library", lambda: lib)
    monkeypatch.setattr(gru_mod, "_check", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: types.SimpleNamespace(
                            multi_processor_count=132))
    for kernel in (GRU_FWD_CHUNKED, GRU_BWD_CHUNKED):
        monkeypatch.setattr(kernel, "launches", 0)
        monkeypatch.setattr(kernel, "tc_launches", 0)
    return lib


ROUTES = [(BF16, 256, True), (BF16, 128, True), (F32, 256, False),
          (F32, 128, False), (F16, 256, False), (F16, 128, False)]


@pytest.mark.parametrize("dtype,H,tensor_core", ROUTES)
def test_chunked_forward_wrapper_routes(monkeypatch, dtype, H, tensor_core):
    """The forward takes ``gru_sequence_fwd``'s path rule, hands the kernel
    the stacks as they stand, the chunk indices, the chunk count, the chunk
    size and the policy count, and counts one launch (and a tensor-core
    one on that route); ``gru_step_chunked`` is the forward at T = 1."""
    lib = _stand_in_card(monkeypatch)
    T, B, C, P = 16, 3, 96, 4
    wh = torch.zeros(P, H, 3 * H, dtype=dtype)
    bias_h = torch.zeros(P, H, dtype=dtype)
    idx = torch.tensor([1, 3, 0], dtype=torch.int32)
    ys = gru_sequence_fwd_chunked(
        torch.zeros(T, B * C, 3 * H, dtype=dtype),
        torch.ones(T, B * C, dtype=dtype), wh, bias_h, idx,
        torch.zeros(B * C, H, dtype=dtype))
    assert ys.shape == (T, B * C, H)
    assert lib.calls == ["mlt_gru_fwd_chunked"]
    (args,) = lib.args
    assert args[:3] == (int(tensor_core), {F32: 0, BF16: 1, F16: 2}[dtype],
                        H)
    assert args[5] == wh.data_ptr() and args[6] == bias_h.data_ptr()
    assert args[7] == idx.data_ptr()
    assert args[10:14] == (T, B, C, P)
    step = gru_step_chunked(torch.zeros(B * C, 3 * H, dtype=dtype), wh,
                            bias_h, idx, torch.zeros(B * C, H, dtype=dtype))
    # On the CPU the step is the twin: no launch.
    assert step.shape == (B * C, H) and len(lib.calls) == 1
    assert (GRU_FWD_CHUNKED.launches, GRU_FWD_CHUNKED.tc_launches) == (
        1, int(tensor_core))


@pytest.mark.parametrize("dtype,H,tensor_core", ROUTES)
def test_chunked_backward_wrapper_routes(monkeypatch, dtype, H, tensor_core):
    """The backward takes ``gru_sequence_bwd``'s path rule, hands the
    kernel the stacks, a transposed copy of the Wh stack, the chunk count,
    the chunk size, the policy count and the splits a chunk (the
    single-policy rule over one chunk's rows alone: the tensor-core
    backward's ``_num_splits_tc``, the CUDA-core one's ``_num_splits``,
    both at three gates), its h_in scratch on the tensor-core route, and
    counts one launch; dbh is [P, H] on both routes (the CUDA-core pass
    sums all 3H columns of dhp and the wrapper keeps the last H)."""
    lib = _stand_in_card(monkeypatch)
    T, B, C, P = 16, 3, 1280, 4
    wh = torch.zeros(P, H, 3 * H, dtype=dtype)
    bias_h = torch.zeros(P, H, dtype=dtype)
    seq = torch.zeros(T, B * C, H, dtype=dtype)
    out = gru_sequence_bwd_chunked(
        torch.zeros(T, B * C, 3 * H, dtype=dtype),
        torch.ones(T, B * C, dtype=dtype), wh, bias_h,
        torch.tensor([1, 3, 0], dtype=torch.int32),
        torch.zeros(B * C, H, dtype=dtype), seq, seq)
    assert lib.calls == ["mlt_gru_bwd_chunked"]
    (args,) = lib.args
    assert args[:3] == (int(tensor_core), {F32: 0, BF16: 1, F16: 2}[dtype],
                        H)
    assert args[5] == wh.data_ptr() and args[7] == bias_h.data_ptr()
    assert args[6] != wh.data_ptr()   # Wh^T of every policy, a copy
    splits = (gru_mod._num_splits_tc(T * C, H, H, 132, gates=3)
              if tensor_core else gru_mod._num_splits(T, C, H, 132,
                                                       gates=3))
    assert args[20:25] == (T, B, C, P, splits)
    assert (args[14] != 0) == tensor_core   # the h_in scratch
    dxp, dwh, dbh, dh0 = out
    assert dxp.shape == (T, B * C, 3 * H) and dwh.shape == (P, H, 3 * H)
    assert dbh.shape == (P, H) and dbh.is_contiguous()
    assert dh0.shape == (B * C, H)
    assert (GRU_BWD_CHUNKED.launches, GRU_BWD_CHUNKED.tc_launches) == (
        1, int(tensor_core))


def test_chunked_wrappers_refuse_what_no_kernel_takes():
    """Off the CPU, both wrappers raise on what no kernel takes (meta
    tensors are on no card; float16 or float32 at a hidden size other than
    128 or 256; rows that are not whole chunks) and count no launch; the
    kernels are registered against the Pallas GRU's forward and
    backward."""
    assert GRU_FWD_CHUNKED in KERNELS and GRU_BWD_CHUNKED in KERNELS
    assert len(KERNELS) == 24
    assert GRU_FWD_CHUNKED.replaces == \
        "madrona_learn_tpu/ops/pallas/gru.py:192"
    assert GRU_BWD_CHUNKED.replaces == \
        "madrona_learn_tpu/ops/pallas/gru.py:211"
    before = [(k.launches, k.tc_launches)
              for k in (GRU_FWD_CHUNKED, GRU_BWD_CHUNKED)]

    def meta(*shape, dtype=BF16):
        return torch.empty(*shape, dtype=dtype, device="meta")

    idx = meta(3, dtype=torch.int32)
    for rows, H, dtype in ((96, 256, BF16), (96, 96, F16),
                           (95, 256, BF16), (96, 96, F32)):
        x = meta(2, rows, 3 * H, dtype=dtype)
        keep, seq = meta(2, rows, dtype=dtype), meta(2, rows, H, dtype=dtype)
        wh, bh = meta(2, H, 3 * H, dtype=dtype), meta(2, H, dtype=dtype)
        h0 = meta(rows, H, dtype=dtype)
        with pytest.raises(ValueError):
            gru_sequence_fwd_chunked(x, keep, wh, bh, idx, h0)
        with pytest.raises(ValueError):
            gru_sequence_bwd_chunked(x, keep, wh, bh, idx, h0, seq, seq)
    assert [(k.launches, k.tc_launches)
            for k in (GRU_FWD_CHUNKED, GRU_BWD_CHUNKED)] == before
