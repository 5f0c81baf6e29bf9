"""The arithmetic of the bf16 LSTM backward on tensor cores
(``csrc/lstm.cu``: lstm_bwd_tc_kernel, ``csrc/weight_grad_tc.cuh``:
weight_grad_tc_kernel), held on the CPU to the contracts that define it,
and the rule that routes a call to it.

A plain-torch emulation of the kernels' arithmetic: bf16 operands with f32
products summed 64 deep at a time in the kernels' K order (the ring's
slices), ``round(x . Wi)`` before ``+ h_in . Wr`` in the projection, gate
math in f32, dgates rounded to bf16 before ``dh_prev = dgates . Wr^T``,
``dx = round(dgates . Wi^T)`` and the weight gradients; dW as f32 partials
over splits of the T * N rows (a multiple of 64 each), summed in split
order, and db as per-block partials over R rows summed in block order. It
is held

- against ``lstm_sequence_reference`` / ``lstm_sequence_proj_reference``'s
  autograd gradients under the chip check's bf16 rule (chip_smoke.py
  ``TOL[("bwd", "bfloat16")]``: max |diff| <= 3.2e-2 max |plain|);
- against the JAX package's ``lstm_sequence`` / ``lstm_sequence_proj``
  custom VJP (the Pallas backward kernels in interpret mode, which define
  the same bf16 contract) under the same rule.

Inputs come from numpy seeds, at N = 70 (ragged against the kernels' R = 16
rows a block, 32 with the projection), H = 128, F = 128 and 256.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_learn_tpu.ops.pallas.lstm import lstm_sequence as jax_lstm_seq
from madrona_learn_tpu.ops.pallas.lstm import (
    lstm_sequence_proj as jax_lstm_proj,
)
from madrona_learn_tpu_torch.ops.cuda import KERNELS
from madrona_learn_tpu_torch.ops.cuda.lstm import (
    _cell,
    _num_splits_tc,
    lstm_sequence_bwd,
    lstm_sequence_proj_bwd,
    lstm_sequence_proj_reference,
    lstm_sequence_reference,
    on_16_bytes,
    tc_rows,
    uses_tensor_cores,
)

torch.set_num_threads(1)

BF16 = torch.bfloat16
F32 = torch.float32
K_SLICE = 64        # depth of a weight slice in the recurrence's ring
M_SLICE = 64        # rows of a stage in the weight-gradient pass
# The chip check's backward rule in bf16 (chip_smoke.py TOL[("bwd",
# "bfloat16")]): max |diff| <= 3.2e-2 max |plain|.
BWD_RTOL = 3.2e-2
H100_SMS = 132


def _inputs(seed, T, N, H, F=None):
    """bf16 operands (the distribution chip_smoke.py draws) and a bf16
    cotangent, as numpy f32 arrays holding bf16 values."""
    rng = np.random.default_rng(seed)

    def bf(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(BF16)

    width = 4 * H if F is None else F
    args = dict(
        x=bf(rng.normal(size=(T, N, width))),
        keep=bf(rng.random((T, N)) > 0.2),
        wi=None if F is None else bf(rng.normal(size=(F, 4 * H)) / np.sqrt(F)),
        wr=bf(rng.normal(size=(H, 4 * H)) / np.sqrt(H)),
        bias=bf(rng.normal(size=(4 * H,))),
        c0=bf(rng.normal(size=(N, H))),
        h0=bf(rng.normal(size=(N, H))))
    probe = bf(rng.normal(size=(T, N, H)))
    return args, probe


def _chunked(a, b):
    """a [M, K] . b [K, N] of bf16 values in f32, K_SLICE deep at a time,
    the slices added in K order."""
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=F32)
    for k0 in range(0, a.shape[1], K_SLICE):
        acc = acc + a[:, k0:k0 + K_SLICE].float() @ b[k0:k0 + K_SLICE].float()
    return acc


def _forward_states(x, keep, wi, wr, bias, c0, h0):
    """ys and cs of the plain forward (the states the backward reads)."""
    x_proj = x if wi is None else (x.float() @ wi.float()).to(BF16)
    c, h = c0, h0
    ys, cs = [], []
    for t in range(x.shape[0]):
        new_c, new_h = _cell(x_proj[t], wr.float(), bias.float(), c, h)
        ys.append(new_h)
        cs.append(new_c)
        mask = keep[t][:, None] > 0.5
        c = torch.where(mask, new_c, torch.zeros((), dtype=BF16))
        h = torch.where(mask, new_h, torch.zeros((), dtype=BF16))
    return torch.stack(ys), torch.stack(cs)


def emulate_tc_bwd(x, keep, wi, wr, bias, c0, h0, ys, cs, dys,
                   sms=H100_SMS):
    """The tensor-core backward's arithmetic: (dx, dwi, dwr, db, dc0, dh0),
    dx the dgates without the projection (dwi then None)."""
    T, N, _ = x.shape
    rows = tc_rows(wi is not None)
    H = wr.shape[0]
    b32 = bias.float()
    dh = torch.zeros(N, H, dtype=F32)
    dc = torch.zeros(N, H, dtype=F32)
    zero = torch.zeros((), dtype=BF16)
    dgs, dxs, hins = [None] * T, [None] * T, [None] * T
    dh0 = dc0 = None
    for t in reversed(range(T)):
        if t == 0:
            h_in, c_in = h0, c0
            kept = torch.zeros(N, 1, dtype=torch.bool)
        else:
            kept = keep[t - 1][:, None] > 0.5
            h_in = torch.where(kept, ys[t - 1], zero)
            c_in = torch.where(kept, cs[t - 1], zero)
        hins[t] = h_in
        if wi is None:
            pre = (x[t].float() + _chunked(h_in, wr)) + b32
        else:
            xp = _chunked(x[t], wi).to(BF16).float()
            pre = xp
            for k0 in range(0, H, K_SLICE):
                pre = pre + (h_in[:, k0:k0 + K_SLICE].float()
                             @ wr[k0:k0 + K_SLICE].float())
            pre = pre + b32
        gi, gf, gg, go = pre.chunk(4, dim=-1)
        si, sf, tg, so = (torch.sigmoid(gi), torch.sigmoid(gf),
                          torch.tanh(gg), torch.sigmoid(go))
        tanh_c = torch.tanh(cs[t].float())
        dh_total = dys[t].float() + dh
        dc_total = dc + dh_total * so * (1 - tanh_c * tanh_c)
        dg = torch.cat([
            dc_total * tg * si * (1 - si),
            dc_total * c_in.float() * sf * (1 - sf),
            dc_total * si * (1 - tg * tg),
            dh_total * tanh_c * so * (1 - so)], dim=-1).to(BF16)
        dgs[t] = dg
        dh_prev = _chunked(dg, wr.t())
        if wi is not None:
            dxs[t] = _chunked(dg, wi.t()).to(BF16)
        dc_prev = dc_total * sf
        if t == 0:
            dh0, dc0 = dh_prev.to(BF16), dc_prev.to(BF16)
        dh = torch.where(kept, dh_prev, torch.zeros(()))
        dc = torch.where(kept, dc_prev, torch.zeros(()))

    M = T * N
    dg_all = torch.stack(dgs).reshape(M, 4 * H)
    a = torch.stack(hins).reshape(M, H)
    if wi is not None:
        a = torch.cat([x.reshape(M, -1), a], dim=1)
    splits = _num_splits_tc(M, a.shape[1], H, sms)
    per = -(-M // splits)
    per = -(-per // M_SLICE) * M_SLICE
    dw = torch.zeros(a.shape[1], 4 * H, dtype=F32)
    for m0 in range(0, M, per):
        part = torch.zeros_like(dw)
        for s0 in range(m0, min(M, m0 + per), M_SLICE):
            part = part + (a[s0:s0 + M_SLICE].float().t()
                           @ dg_all[s0:s0 + M_SLICE].float())
        dw = dw + part
    dgs_t = torch.stack(dgs).float()      # [T, N, 4H]
    db = torch.zeros(4 * H, dtype=F32)
    for n0 in range(0, N, rows):
        block = torch.zeros(4 * H, dtype=F32)
        for t in reversed(range(T)):
            block = block + dgs_t[t, n0:n0 + rows].sum(0)
        db = db + block
    dw = dw.to(BF16)
    if wi is None:
        return torch.stack(dgs), None, dw, db.to(BF16), dc0, dh0
    F = x.shape[2]
    return (torch.stack(dxs), dw[:F], dw[F:], db.to(BF16), dc0, dh0)


def _plain_grads(args, probe):
    names = ("x", "wi", "wr", "bias", "c0", "h0")
    leaves = {k: args[k].clone().requires_grad_() for k in names
              if args[k] is not None}
    if args["wi"] is None:
        ys = lstm_sequence_reference(
            leaves["x"], args["keep"], leaves["wr"], leaves["bias"],
            leaves["c0"], leaves["h0"])
    else:
        ys = lstm_sequence_proj_reference(
            leaves["x"], args["keep"], leaves["wi"], leaves["wr"],
            leaves["bias"], leaves["c0"], leaves["h0"])
    grads = torch.autograd.grad((ys.float() * probe.float()).sum(),
                                list(leaves.values()))
    got = dict(zip(leaves, grads))
    return tuple(got.get(k) for k in names)


def _jax_grads(args, probe):
    def j(t):
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)

    keep = j(args["keep"])
    probe_j = j(probe).astype(jnp.float32)
    if args["wi"] is None:
        def loss(x, wr, b, c0, h0):
            ys = jax_lstm_seq(x, keep, wr, b, c0, h0, True)
            return jnp.sum(ys.astype(jnp.float32) * probe_j)

        diff = ("x", "wr", "bias", "c0", "h0")
    else:
        def loss(x, wi, wr, b, c0, h0):
            ys = jax_lstm_proj(x, keep, wi, wr, b, c0, h0, True)
            return jnp.sum(ys.astype(jnp.float32) * probe_j)

        diff = ("x", "wi", "wr", "bias", "c0", "h0")
    grads = jax.grad(loss, argnums=tuple(range(len(diff))))(
        *(j(args[k]) for k in diff))
    got = {k: torch.from_numpy(np.asarray(g, np.float32))
           for k, g in zip(diff, grads)}
    return tuple(got.get(k) for k in ("x", "wi", "wr", "bias", "c0", "h0"))


def _emulated(args, probe):
    ys, cs = _forward_states(**args)
    return emulate_tc_bwd(**args, ys=ys, cs=cs, dys=probe)


def _check(got, want, what):
    for name, g, w in zip(("dx", "dwi", "dwr", "db", "dc0", "dh0"), got,
                          want):
        if g is None:
            assert w is None, name
            continue
        err = (g.float() - w.float()).abs().max().item()
        scale = w.float().abs().max().item()
        assert err <= BWD_RTOL * scale, (
            f"{what} {name}: max |diff| {err:.3e} above {BWD_RTOL} x "
            f"max |want| {scale:.3e}")


CASES = [(5, 70, 128, None), (4, 70, 128, 128), (4, 70, 128, 256)]


@pytest.mark.parametrize("T,N,H,F", CASES)
def test_tc_lstm_bwd_arithmetic_meets_the_plain_contract(T, N, H, F):
    args, probe = _inputs(40 + T + (F or 0), T, N, H, F)
    _check(_emulated(args, probe), _plain_grads(args, probe), "vs plain")


@pytest.mark.parametrize("T,N,H,F", CASES)
def test_tc_lstm_bwd_arithmetic_matches_the_pallas_backward(T, N, H, F):
    args, probe = _inputs(50 + T + (F or 0), T, N, H, F)
    _check(_emulated(args, probe), _jax_grads(args, probe), "vs Pallas")


def test_tc_weight_gradients_do_not_depend_on_the_split_count():
    """dW summed over a few splits or many stays within the rule: the
    split count is a tuning choice (``_num_splits_tc``), not part of the
    contract."""
    args, probe = _inputs(60, 4, 70, 128)
    ys, cs = _forward_states(**args)
    one = emulate_tc_bwd(**args, ys=ys, cs=cs, dys=probe, sms=1)
    many = emulate_tc_bwd(**args, ys=ys, cs=cs, dys=probe, sms=H100_SMS)
    _check(many, one, "splits")


def _aligned_at(shape, dtype, shift):
    """A contiguous tensor whose first element lies ``shift`` elements past
    a 16-byte boundary."""
    n = int(np.prod(shape))
    buf = torch.zeros(n + 16, dtype=dtype)
    start = (-buf.data_ptr() // buf.element_size()) % (
        16 // buf.element_size()) + shift
    return buf[start:start + n].view(shape)


@pytest.mark.parametrize("dtype,H,shift,tensor_core", [
    (BF16, 256, 0, True),     # the update minibatch
    (BF16, 128, 0, True),
    (BF16, 256, 1, True),     # an operand off a 16-byte boundary: copied
    (BF16, 256, 8, True),     # 8 bf16 past it: on the next one
    (BF16, 192, 0, False),    # no kernel at this width
    (F32, 256, 0, False),     # float32 stays on CUDA cores
    (F32, 128, 0, False),
])
def test_lstm_bwd_path_rule(dtype, H, shift, tensor_core):
    """The route depends on dtype and H alone; the tensor-core wrapper puts
    an operand off a 16-byte boundary onto one, the same values, and leaves
    one on a boundary as it is."""
    assert uses_tensor_cores(dtype, H) is tensor_core
    x = _aligned_at((2, 3, 4 * H), dtype, shift)
    x.copy_(torch.arange(x.numel(), dtype=dtype).view(x.shape))
    on = on_16_bytes(x)
    assert on.data_ptr() % 16 == 0 and on.is_contiguous()
    assert torch.equal(on, x)
    assert (on is x) == (x.data_ptr() % 16 == 0)


def test_lstm_bwd_wrappers_refuse_what_no_kernel_takes():
    """Tensors off the CPU go to the kernel wrappers, which raise on what
    neither path takes (meta tensors are never on the card) instead of
    falling back."""
    before = {k.name: k.launches for k in KERNELS}

    def meta(*shape, dtype=BF16):
        return torch.empty(*shape, dtype=dtype, device="meta")

    T, N = 2, 8
    for H in (256, 192):       # operand on no card; no kernel at H = 192
        state = meta(T, N, H)
        with pytest.raises(ValueError):
            lstm_sequence_bwd(meta(T, N, 4 * H), meta(T, N), meta(H, 4 * H),
                              meta(4 * H), meta(N, H), meta(N, H), state,
                              state, state)
    for F in (256, 192):       # operand on no card; F not a multiple of 128
        state = meta(T, N, 256)
        with pytest.raises(ValueError):
            lstm_sequence_proj_bwd(
                meta(T, N, F), meta(T, N), meta(F, 1024), meta(256, 1024),
                meta(1024), meta(N, 256), meta(N, 256), state, state, state)
    assert {k.name: k.launches for k in KERNELS} == before
