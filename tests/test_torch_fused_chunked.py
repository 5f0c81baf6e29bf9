"""The fused trunk's policy-batched instances: ``fused_policy_step_chunked``
(the population's rollout step) and ``lstm_sequence_proj_{fwd,bwd}_chunked``
(its learn step), the chunk-indexed kernels JAX runs when it ``vmap``s the
fused step over policy chunks and ``lstm_sequence_proj`` with
``algo.update`` over the train policies.

- Each plain twin against ``jax.vmap`` of the Pallas kernel in interpret
  mode: over chunks of ``fused_policy_step`` (each chunk with its policy's
  weights), and over policies of ``jax.vjp`` of ``lstm_sequence_proj``
  (each policy's minibatch one chunk, as in learn), within 1e-5 (float32).
- Each twin chunk by chunk against the single-policy twin, bitwise, at a
  chunk of 37 rows (no multiple of a kernel's row tile) in a shuffled
  order; a chunk of policy P or -1 gives NaN rows and adds to no
  gradient; a policy without a chunk gets zero gradients.
- The wrappers' routes, arguments and launch counts against a stand-in
  library, and their refusals of what no kernel takes.

The population-level checks (a fused-trunk population's chunked rollout
and batched learn against the per-policy loop, and the whole slice
against JAX's population update) are cases of
``test_torch_chunk_layout.py``, ``test_torch_batched_learn.py`` and
``test_torch_pbt_slice.py``.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import madrona_learn_tpu_torch.ops.cuda.lstm as lstm_mod
import madrona_learn_tpu_torch.ops.cuda.policy_step as step_mod
from madrona_learn_tpu.ops.pallas.lstm import (
    lstm_sequence_proj as jax_lstm_seq_proj,
)
from madrona_learn_tpu.ops.pallas.policy_step import (
    fused_policy_step as jax_fused_policy_step,
)
from madrona_learn_tpu_torch.ops.cuda import (
    KERNELS,
    LSTM_PROJ_BWD_CHUNKED,
    LSTM_PROJ_FWD_CHUNKED,
    POLICY_STEP_CHUNKED,
)
from madrona_learn_tpu_torch.ops.cuda.lstm import (
    lstm_sequence_proj_bwd_chunked,
    lstm_sequence_proj_chunked,
    lstm_sequence_proj_chunked_reference,
    lstm_sequence_proj_fwd_chunked,
    lstm_sequence_proj_fwd_chunked_reference,
    lstm_sequence_proj_reference,
)
from madrona_learn_tpu_torch.ops.cuda.policy_step import (
    fused_policy_step_chunked,
    fused_policy_step_chunked_reference,
    fused_policy_step_reference,
)
from test_torch_lstm_fwd_tc_numerics import _FakeLibrary, _stand_in_card

torch.set_num_threads(1)

F32, BF16 = torch.float32, torch.bfloat16
H = 128
ROUTES = [(BF16, 256, True), (BF16, 128, True), (F32, 256, False),
          (F32, 128, False)]
SHUFFLED = [2, 0, 3, 2, 1, 0]     # policy 4 of 5 owns no chunk


def _rng_tensor(rng):
    return lambda *shape, scale=1.0: torch.from_numpy(
        (rng.normal(size=shape) * scale).astype(np.float32))


def _step_inputs(seed, B, C, F, P, layers=2):
    """x [B * C, F], the MLP's (W [P, F_in, H], ln_scale [P, H], ln_bias
    [P, H]) stacks, wi / wr [P, H, 4H], bias [P, 4H], c, h [B * C, H]."""
    f = _rng_tensor(np.random.default_rng(seed))
    mlp, fin = [], F
    for _ in range(layers):
        mlp.append((f(P, fin, H, scale=(2 / fin) ** 0.5),
                    1 + f(P, H, scale=0.1), f(P, H, scale=0.1)))
        fin = H
    N = B * C
    return (f(N, F), mlp, f(P, H, 4 * H, scale=H ** -0.5),
            f(P, H, 4 * H, scale=H ** -0.5), f(P, 4 * H, scale=0.1),
            f(N, H, scale=0.5), f(N, H, scale=0.5))


def _j(t):
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("F", [3, 128])
def test_fused_step_twin_matches_jax_vmapped_pallas(F):
    """Four chunks of 24 rows in a shuffled order of 3 policies: the twin
    against ``jax.vmap`` over the chunks of the Pallas fused step in
    interpret mode, each chunk given its policy's weights, within 1e-5."""
    P, C = 3, 24
    order = [2, 0, 1, 2]
    B = len(order)
    x, mlp, wi, wr, bias, c, h = _step_inputs(4, B, C, F, P)
    idx = torch.tensor(order, dtype=torch.int32)
    feats, (c1, h1) = fused_policy_step_chunked_reference(
        x, mlp, wi, wr, bias, idx, c, h)

    pick = lambda t: _j(t[idx.long()])
    chunks = lambda t: _j(t.reshape(B, C, -1))
    want_f, (want_c, want_h) = jax.vmap(
        lambda x, mlp, wi, wr, b, c, h: jax_fused_policy_step(
            x, mlp, wi, wr, b, c, h, interpret=True))(
        chunks(x), [tuple(pick(t) for t in layer) for layer in mlp],
        pick(wi), pick(wr), pick(bias), chunks(c), chunks(h))
    for name, g, w in (("feats", feats, want_f), ("c'", c1, want_c),
                       ("h'", h1, want_h)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w).reshape(B * C, H),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_fused_step_twin_is_each_chunks_reference():
    """Chunks of 37 rows in a shuffled order, with chunks of index P and
    -1: each chunk bitwise ``fused_policy_step_reference`` on its rows with
    its policy's weights, the other two NaN; the entry point on the CPU is
    the twin."""
    P, C, F = 5, 37, 3
    order = [2, 0, P, 3, -1, 2]
    B = len(order)
    x, mlp, wi, wr, bias, c, h = _step_inputs(5, B, C, F, P, layers=1)
    idx = torch.tensor(order, dtype=torch.int32)
    feats, (c1, h1) = fused_policy_step_chunked_reference(
        x, mlp, wi, wr, bias, idx, c, h)
    assert feats.shape == c1.shape == h1.shape == (B * C, H)
    for b, p in enumerate(order):
        rows = slice(b * C, (b + 1) * C)
        if not 0 <= p < P:
            assert all(t[rows].isnan().all() for t in (feats, c1, h1))
            continue
        want_f, (want_c, want_h) = fused_policy_step_reference(
            x[rows], [tuple(t[p] for t in layer) for layer in mlp], wi[p],
            wr[p], bias[p], c[rows], h[rows])
        assert torch.equal(feats[rows], want_f)
        assert torch.equal(c1[rows], want_c) and torch.equal(h1[rows], want_h)
    got = fused_policy_step_chunked(x, mlp, wi, wr, bias, idx, c, h)
    torch.testing.assert_close(got[0], feats, rtol=0, atol=0, equal_nan=True)


def _proj_inputs(seed, T, B, C, F, P):
    """x [T, B * C, F], keep, wi [P, F, 4H], wr [P, H, 4H], bias [P, 4H],
    c0, h0 [B * C, H] and a probe [T, B * C, H]."""
    rng = np.random.default_rng(seed)
    f = _rng_tensor(rng)
    N = B * C
    keep = torch.from_numpy((rng.random((T, N)) > 0.3).astype(np.float32))
    return (f(T, N, F), keep, f(P, F, 4 * H, scale=F ** -0.5),
            f(P, H, 4 * H, scale=H ** -0.5), f(P, 4 * H, scale=0.1),
            f(N, H), f(N, H), f(T, N, H))


def _twin_grads(x, keep, wi, wr, bias, idx, c0, h0, probe):
    """(ys, (dx, dwi, dwr, db, dc0, dh0)) by autograd of the plain twin."""
    leaves = [t.clone().requires_grad_() for t in (x, wi, wr, bias, c0, h0)]
    ys = lstm_sequence_proj_chunked_reference(leaves[0], keep, *leaves[1:4],
                                              idx, *leaves[4:])
    return ys, torch.autograd.grad((ys * probe).sum(), leaves)


def test_proj_twin_matches_jax_vmapped_pallas_vjp():
    """Each policy's minibatch one chunk of 24 rows (chunk_policy =
    arange(P)): the twin's ys and its autograd's dx, dwi[p], dwr[p], db[p],
    dc0 and dh0 against ``jax.vmap`` over the policies of ``jax.vjp`` of
    the Pallas ``lstm_sequence_proj`` in interpret mode, within 1e-5."""
    T, P, C, F = 3, 3, 24, 128
    x, keep, wi, wr, bias, c0, h0, probe = _proj_inputs(3, T, P, C, F, P)
    ys, got = _twin_grads(x, keep, wi, wr, bias,
                          torch.arange(P, dtype=torch.int32), c0, h0, probe)

    def per_policy(t):
        """[T, P * C, ...] -> [P, T, C, ...]; [P * C, ...] -> [P, C, ...]."""
        a = t.numpy()
        if a.shape[0] == P * C:
            return jnp.asarray(a.reshape(P, C, *a.shape[1:]))
        return jnp.asarray(a.reshape(T, P, C, *a.shape[2:]).swapaxes(0, 1))

    def vjp(x, keep, wi, wr, bias, c0, h0, probe):
        out, pull = jax.vjp(
            lambda x, wi, wr, bias, c0, h0: jax_lstm_seq_proj(
                x, keep, wi, wr, bias, c0, h0, True),
            x, wi, wr, bias, c0, h0)
        return out, pull(probe)

    want_ys, want = jax.vmap(vjp)(
        per_policy(x), per_policy(keep), _j(wi), _j(wr), _j(bias),
        per_policy(c0), per_policy(h0), per_policy(probe))
    time_major = lambda a: np.asarray(a).swapaxes(0, 1).reshape(
        T, P * C, -1)
    np.testing.assert_allclose(ys.detach().numpy(), time_major(want_ys),
                               rtol=1e-5, atol=1e-5, err_msg="ys")
    dx, dwi, dwr, db, dc0, dh0 = (np.asarray(w) for w in want)
    wants = (time_major(dx), dwi, dwr, db, dc0.reshape(P * C, H),
             dh0.reshape(P * C, H))
    for name, g, w in zip(("dx", "dwi", "dwr", "db", "dc0", "dh0"), got,
                          wants):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_proj_twin_is_each_chunks_reference():
    """At C = 37 in a shuffled order: the forward twin's ys / cs and the
    differentiable twin's ys bitwise, chunk by chunk, the single-policy
    twin's; each chunk's dx, dc0 and dh0 bitwise the gradients of
    ``lstm_sequence_proj_reference`` on its rows with its policy's
    weights; a policy's dwi / dwr / db the sum over its chunks; zeros for
    policy 4, which owns no chunk; chunks of index P and -1 NaN in the
    forward. On the CPU the entry point is the twin."""
    T, C, F, P = 4, 37, 128, 5
    idx = torch.tensor(SHUFFLED, dtype=torch.int32)
    x, keep, wi, wr, bias, c0, h0, probe = _proj_inputs(
        5, T, len(SHUFFLED), C, F, P)
    ys, (dx, dwi, dwr, db, dc0, dh0) = _twin_grads(
        x, keep, wi, wr, bias, idx, c0, h0, probe)
    fwd_ys, fwd_cs = lstm_sequence_proj_fwd_chunked_reference(
        x, keep, wi, wr, bias, idx, c0, h0)
    assert torch.equal(fwd_ys, ys.detach())
    sums = {}
    for b, p in enumerate(SHUFFLED):
        rows = slice(b * C, (b + 1) * C)
        leaves = [t.clone().requires_grad_() for t in (
            x[:, rows], wi[p], wr[p], bias[p], c0[rows], h0[rows])]
        want = lstm_sequence_proj_reference(leaves[0], keep[:, rows],
                                            *leaves[1:])
        assert torch.equal(ys[:, rows], want)
        g = torch.autograd.grad((want * probe[:, rows]).sum(), leaves)
        assert torch.equal(dx[:, rows], g[0])
        assert torch.equal(dc0[rows], g[4]) and torch.equal(dh0[rows], g[5])
        sums[p] = [a + b_ for a, b_ in zip(sums.get(p, (0.0,) * 3), g[1:4])]
    for p in range(P):
        got = (dwi[p], dwr[p], db[p])
        if p not in sums:
            assert not any(t.any() for t in got)
            continue
        for g, w in zip(got, sums[p]):
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)
    bad = idx.clone()
    bad[1], bad[3] = P, -1
    yb, cb = lstm_sequence_proj_fwd_chunked_reference(x, keep, wi, wr, bias,
                                                      bad, c0, h0)
    skipped = torch.zeros(len(SHUFFLED), dtype=torch.bool)
    skipped[[1, 3]] = True
    rows = skipped.repeat_interleave(C)
    assert yb[:, rows].isnan().all() and cb[:, rows].isnan().all()
    assert torch.equal(yb[:, ~rows], fwd_ys[:, ~rows])
    assert torch.equal(cb[:, ~rows], fwd_cs[:, ~rows])
    assert torch.equal(lstm_sequence_proj_chunked(
        x, keep, wi, wr, bias, idx, c0, h0), ys.detach())


# -- The wrappers on the card's path, against a stand-in library ------------

def _stand_in_step_card(monkeypatch):
    """``_stand_in_card`` for the fused step's module."""
    lib = _FakeLibrary()
    monkeypatch.setattr(step_mod, "library", lambda: lib)
    monkeypatch.setattr(step_mod, "_check", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    return lib


@pytest.mark.parametrize("dtype,H_,tensor_core", ROUTES)
def test_fused_step_chunked_wrapper_routes(monkeypatch, dtype, H_,
                                           tensor_core):
    """The wrapper takes ``fused_policy_step``'s path rule, hands the
    kernel its route, the dtype, the widths, the chunk count, the chunk
    size, the policy count, the chunk indices and the stacks as they
    stand, and counts one launch (and a tensor-core one on that route)."""
    lib = _stand_in_step_card(monkeypatch)
    monkeypatch.setattr(POLICY_STEP_CHUNKED, "launches", 0)
    monkeypatch.setattr(POLICY_STEP_CHUNKED, "tc_launches", 0)
    B, C, P, F = 3, 40, 5, 3
    mlp = [(torch.zeros(P, F, H_, dtype=dtype), torch.ones(P, H_),
            torch.zeros(P, H_)),
           (torch.zeros(P, H_, H_, dtype=dtype), torch.ones(P, H_),
            torch.zeros(P, H_))]
    wi = torch.zeros(P, H_, 4 * H_, dtype=dtype)
    bias = torch.zeros(P, 4 * H_, dtype=dtype)
    idx = torch.tensor([1, 4, 0], dtype=torch.int32)
    state = torch.zeros(B * C, H_, dtype=dtype)
    # The operands lie on the CPU: call the launch that the wrapper makes
    # for CUDA tensors.
    with torch.no_grad():
        feats, (c, h) = step_mod._launch_chunked(
            torch.zeros(B * C, F, dtype=dtype), mlp, wi, wi, bias, idx,
            state, state)
    assert lib.calls == ["mlt_policy_step_chunked"]
    (args,) = lib.args
    assert args[:9] == (int(tensor_core), {F32: 0, BF16: 1}[dtype], H_, 2, F,
                        B, C, P, idx.data_ptr())
    assert args[10] == mlp[0][0].data_ptr()
    assert args[11:13] == (mlp[0][1].data_ptr(), mlp[0][2].data_ptr())
    assert args[16:22] == (None,) * 6    # layers 2 and 3: none
    assert args[22:25] == (wi.data_ptr(), wi.data_ptr(), bias.data_ptr())
    assert feats.shape == c.shape == h.shape == (B * C, H_)
    assert (POLICY_STEP_CHUNKED.launches, POLICY_STEP_CHUNKED.tc_launches) \
        == (1, int(tensor_core))


@pytest.mark.parametrize("dtype,H_,tensor_core", ROUTES)
def test_proj_chunked_wrapper_routes(monkeypatch, dtype, H_, tensor_core):
    """The forward and backward take the projection kernels' path rule,
    hand the kernels the stacks (and transposed copies of the Wi and Wr
    stacks to the backward), the chunk count, the chunk size, the policy
    count and the backward's splits a chunk (the single-policy rule over
    one chunk's rows alone: ``_num_splits_tc`` over [x | h_in], or
    ``_num_splits``), the tensor-core backward its h_in scratch and one
    [P, F + H, 4H] weight gradient whose two row blocks are dwi and dwr,
    and count one launch each (and a tensor-core one on that route)."""
    lib = _stand_in_card(monkeypatch)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: types.SimpleNamespace(
                            multi_processor_count=132))
    for k in (LSTM_PROJ_FWD_CHUNKED, LSTM_PROJ_BWD_CHUNKED):
        monkeypatch.setattr(k, "launches", 0)
        monkeypatch.setattr(k, "tc_launches", 0)
    T, B, C, P, F = 16, 3, 1280, 4, 256
    x = torch.zeros(T, B * C, F, dtype=dtype)
    keep = torch.ones(T, B * C, dtype=dtype)
    wi = torch.zeros(P, F, 4 * H_, dtype=dtype)
    wr = torch.zeros(P, H_, 4 * H_, dtype=dtype)
    bias = torch.zeros(P, 4 * H_, dtype=dtype)
    idx = torch.tensor([1, 3, 0], dtype=torch.int32)
    state = torch.zeros(B * C, H_, dtype=dtype)
    seq = torch.zeros(T, B * C, H_, dtype=dtype)
    ys, cs = lstm_sequence_proj_fwd_chunked(x, keep, wi, wr, bias, idx,
                                            state, state)
    out = lstm_sequence_proj_bwd_chunked(x, keep, wi, wr, bias, idx, state,
                                         state, seq, seq, seq)
    assert lib.calls == ["mlt_lstm_proj_fwd_chunked",
                         "mlt_lstm_proj_bwd_chunked"]
    fwd, bwd = lib.args
    head = (int(tensor_core), {F32: 0, BF16: 1}[dtype], H_, F)
    assert fwd[:4] == head and bwd[:4] == head
    assert fwd[6:10] == (wi.data_ptr(), wr.data_ptr(), bias.data_ptr(),
                         idx.data_ptr())
    assert fwd[14:18] == (T, B, C, P)
    assert bwd[6] == wi.data_ptr() and bwd[8] == wr.data_ptr()
    assert bwd[7] not in (0, wi.data_ptr())     # Wi^T of every policy
    assert bwd[9] not in (0, wr.data_ptr())     # Wr^T of every policy
    assert bwd[10:12] == (bias.data_ptr(), idx.data_ptr())
    splits = (lstm_mod._num_splits_tc(T * C, F + H_, H_, 132) if tensor_core
              else lstm_mod._num_splits(T, C, H_, 132))
    assert bwd[28:33] == (T, B, C, P, splits)
    assert (bwd[19] != 0) == tensor_core       # the h_in scratch
    assert (bwd[22] != 0) != tensor_core       # part_wi: CUDA cores only
    assert (bwd[25] != 0) != tensor_core       # dwi: CUDA cores only
    dx, dwi, dwr, db, dc0, dh0 = out
    assert ys.shape == cs.shape == (T, B * C, H_)
    assert dx.shape == x.shape and dwi.shape == wi.shape
    assert dwr.shape == wr.shape and db.shape == bias.shape
    assert dc0.shape == dh0.shape == (B * C, H_)
    if tensor_core:
        assert dwi.data_ptr() == bwd[26]
        assert dwr.data_ptr() == bwd[26] + F * 4 * H_ * dwr.element_size()
    for k in (LSTM_PROJ_FWD_CHUNKED, LSTM_PROJ_BWD_CHUNKED):
        assert (k.launches, k.tc_launches) == (1, int(tensor_core))


def _meta(*shape, dtype=BF16):
    return torch.empty(*shape, dtype=dtype, device="meta")


def test_chunked_wrappers_refuse_what_no_kernel_takes():
    """Off the CPU, the three wrappers raise on what no kernel takes (meta
    tensors are on no card; float16; a hidden size of 192; rows that are
    not whole chunks; F past 128 for the step, F no multiple of 128 for
    the projection), count no launch, and are registered against the
    Pallas kernels' pallas_calls."""
    kernels = (POLICY_STEP_CHUNKED, LSTM_PROJ_FWD_CHUNKED,
               LSTM_PROJ_BWD_CHUNKED)
    assert all(k in KERNELS for k in kernels) and len(KERNELS) == 24
    assert [k.replaces for k in kernels] == [
        "madrona_learn_tpu/ops/pallas/policy_step.py:168",
        "madrona_learn_tpu/ops/pallas/lstm.py:516",
        "madrona_learn_tpu/ops/pallas/lstm.py:581"]
    before = [(k.launches, k.tc_launches) for k in kernels]
    idx = _meta(3, dtype=torch.int32)
    for rows, F, H_, dtype in ((96, 3, 256, BF16), (96, 3, 256, F32),
                               (96, 3, 256, torch.float16),
                               (96, 3, 192, BF16), (95, 3, 256, BF16),
                               (96, 129, 256, BF16)):
        mlp = [(_meta(2, F, H_, dtype=dtype), _meta(2, H_, dtype=F32),
                _meta(2, H_, dtype=F32))]
        with pytest.raises(ValueError):
            fused_policy_step_chunked(
                _meta(rows, F, dtype=dtype), mlp,
                _meta(2, H_, 4 * H_, dtype=dtype),
                _meta(2, H_, 4 * H_, dtype=dtype),
                _meta(2, 4 * H_, dtype=dtype), idx,
                _meta(rows, H_, dtype=dtype), _meta(rows, H_, dtype=dtype))
    for rows, F, H_, dtype in ((96, 256, 256, BF16), (96, 256, 256, F32),
                               (96, 256, 256, torch.float16),
                               (96, 256, 192, BF16), (95, 256, 256, BF16),
                               (96, 200, 256, BF16)):
        args = (_meta(2, rows, F, dtype=dtype), _meta(2, rows, dtype=dtype),
                _meta(2, F, 4 * H_, dtype=dtype),
                _meta(2, H_, 4 * H_, dtype=dtype),
                _meta(2, 4 * H_, dtype=dtype), idx,
                _meta(rows, H_, dtype=dtype), _meta(rows, H_, dtype=dtype))
        with pytest.raises(ValueError):
            lstm_sequence_proj_fwd_chunked(*args)
        seq = _meta(2, rows, H_, dtype=dtype)
        with pytest.raises(ValueError):
            lstm_sequence_proj_bwd_chunked(*args, seq, seq, seq)
    assert [(k.launches, k.tc_launches) for k in kernels] == before
