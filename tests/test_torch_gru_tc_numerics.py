"""The arithmetic of the bf16 GRU backward on tensor cores (``csrc/gru.cu``:
gru_bwd_tc_kernel, ``csrc/weight_grad_tc.cuh``: weight_grad_tc_kernel),
held on the CPU to the contracts that define it, and the rule that routes a
call to it.

A plain-torch emulation of the kernels' arithmetic: bf16 operands with f32
products summed 64 deep at a time in the kernels' K order (the ring's
slices; the recomputed ``h_in . Wh`` through the forward emulation's slice
sums, ``test_torch_gru_fwd_tc_numerics._slices``), that product kept apart
from x_proj's n slice (linear before reset), gate math in f32,
dhp = [dr_pre, dz_pre, dn_pre * r]
and dxp = [dr_pre, dz_pre, dn_pre] rounded to bf16, dhp rounded before
``dh_prev = dhp . Wh^T + dh_total * z``; dWh = h_in^T . dhp as f32 partials
over splits of the T * N rows (a multiple of 64 each), summed in split
order, and dbh as per-block partials of dhp's n slice over R rows, summed
in block order. At H = 384 and 512 the kernel splits the units over a
cluster of two blocks, which the emulation follows rank by rank. It is
held

- against ``gru_sequence_reference``'s autograd gradients under the chip
  check's bf16 rule (chip_smoke.py ``TOL[("gru_bwd", "bfloat16")]``:
  max |diff| <= 3.2e-2 max |plain|);
- against the JAX package's ``gru_sequence`` custom VJP (the Pallas
  backward kernel in interpret mode, which defines the same bf16 contract)
  under the same rule.

Inputs come from numpy seeds, at N = 70 (ragged against the kernel's R =
32 rows a block) and H = 128.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_learn_tpu.ops.pallas.gru import gru_sequence as jax_gru_seq
from madrona_learn_tpu_torch.ops.cuda import KERNELS
from madrona_learn_tpu_torch.ops.cuda.gru import (
    _cell,
    bwd_uses_tensor_cores,
    gru_sequence_bwd,
    gru_sequence_reference,
    tc_rows,
)
from madrona_learn_tpu_torch.ops.cuda.lstm import _num_splits_tc
from test_torch_gru_fwd_tc_numerics import _slices

torch.set_num_threads(1)

BF16 = torch.bfloat16
F32 = torch.float32
K_SLICE = 64        # depth of a weight slice in the recurrence's ring
M_SLICE = 64        # rows of a stage in the weight-gradient pass
# The chip check's GRU backward rule in bf16 (chip_smoke.py TOL[("gru_bwd",
# "bfloat16")]): max |diff| <= 3.2e-2 max |plain|.
BWD_RTOL = 3.2e-2
H100_SMS = 132
NAMES = ("dxp", "dwh", "dbh", "dh0")


def _inputs(seed, T, N, H, dtype=BF16):
    """Operands of ``dtype`` (bf16 by default; the distribution
    chip_smoke.py draws) and a cotangent of it, from numpy f32 draws."""
    rng = np.random.default_rng(seed)

    def bf(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)

    args = dict(
        x_proj=bf(rng.normal(size=(T, N, 3 * H))),
        keep=bf(rng.random((T, N)) > 0.2),
        wh=bf(rng.normal(size=(H, 3 * H)) / np.sqrt(H)),
        bias_h=bf(rng.normal(size=(H,))),
        h0=bf(rng.normal(size=(N, H))))
    probe = bf(rng.normal(size=(T, N, H)))
    return args, probe


def _chunked(a, b):
    """a [M, K] . b [K, N] of bf16 (or f16) values in f32, K_SLICE deep at
    a time, the slices added in K order."""
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=F32)
    for k0 in range(0, a.shape[1], K_SLICE):
        acc = acc + a[:, k0:k0 + K_SLICE].float() @ b[k0:k0 + K_SLICE].float()
    return acc


def _forward_states(x_proj, keep, wh, bias_h, h0):
    """ys of the plain forward (the states the backward reads), in the
    operands' dtype."""
    h = h0
    ys = []
    for t in range(x_proj.shape[0]):
        new_h = _cell(x_proj[t], wh.float(), bias_h.float(), h)
        ys.append(new_h)
        h = torch.where(keep[t][:, None] > 0.5, new_h,
                        torch.zeros((), dtype=x_proj.dtype))
    return torch.stack(ys)


def emulate_tc_bwd(x_proj, keep, wh, bias_h, h0, ys, dys, sms=H100_SMS,
                   rows=None, hps=None, state=None):
    """The tensor-core backward's arithmetic: (dxp, dwh, dbh, dh0), each in
    the operands' element type (bf16, or float16: the f16 ``wgmma``
    instance), at ``rows`` rows a row tile (``tc_rows`` by default). The
    recomputed h_in . Wh is the forward's product
    (``test_torch_gru_fwd_tc_numerics._slices``, the helper both kernels
    share). At H = 384 and 512 rank r of the two-block cluster owns units
    r H / 2 .. of each gate: it recomputes their h_in . Wh over all H (the
    forward's slices), and dh_prev of its units over all 3H columns of
    dhp, both blocks'. ``hps``, where given, is a list that receives the
    recomputed product [N, 3H] (f32) step by step, in reverse step order;
    ``state``, a dict that receives the rounded dhp ``dhp`` [T, N, 3H],
    ``hin`` [T, N, H] as each step used it and the dbh partials of the row
    tiles ``db_blocks`` (f32, in tile order)."""
    dt = x_proj.dtype
    T, N, G3 = x_proj.shape
    H = G3 // 3
    rows = tc_rows(H) if rows is None else rows
    ranks = 2 if H > 256 else 1
    U = H // ranks
    # Rank r's columns of the 3H gates, and its rows of Wh (its units).
    cols = [torch.cat([torch.arange(g * H + r * U, g * H + (r + 1) * U)
                       for g in range(3)]) for r in range(ranks)]
    units = [slice(r * U, (r + 1) * U) for r in range(ranks)]
    bh = bias_h.float()
    dh = torch.zeros(N, H, dtype=F32)
    zero = torch.zeros((), dtype=dt)
    dxps, dhps, hins = [None] * T, [None] * T, [None] * T
    dh0 = None
    for t in reversed(range(T)):
        if t == 0:
            h_in = h0
            kept = torch.zeros(N, 1, dtype=torch.bool)
        else:
            kept = keep[t - 1][:, None] > 0.5
            h_in = torch.where(kept, ys[t - 1], zero)
        hins[t] = h_in
        hp = torch.empty(N, G3, dtype=F32)
        for c in cols:
            hp[:, c] = _slices(h_in, wh[:, c])
        if hps is not None:
            hps.append(hp)
        xp = x_proj[t].float()
        hn_lin = hp[:, 2 * H:] + bh
        r = torch.sigmoid(xp[:, :H] + hp[:, :H])
        z = torch.sigmoid(xp[:, H:2 * H] + hp[:, H:2 * H])
        n = torch.tanh(xp[:, 2 * H:] + r * hn_lin)
        dh_total = dys[t].float() + dh
        dn_pre = dh_total * (1 - z) * (1 - n * n)
        dz_pre = dh_total * (h_in.float() - n) * z * (1 - z)
        dr_pre = dn_pre * hn_lin * r * (1 - r)
        dxps[t] = torch.cat([dr_pre, dz_pre, dn_pre], dim=-1).to(dt)
        dhps[t] = torch.cat([dr_pre, dz_pre, dn_pre * r], dim=-1).to(dt)
        dh_prev = torch.cat([_chunked(dhps[t], wh[u].t()) for u in units],
                            dim=1) + dh_total * z
        if t == 0:
            dh0 = dh_prev.to(dt)
        dh = torch.where(kept, dh_prev, torch.zeros(()))

    M = T * N
    dhp_all = torch.stack(dhps).reshape(M, G3)
    a = torch.stack(hins).reshape(M, H)
    splits = _num_splits_tc(M, H, H, sms, gates=3)
    per = -(-M // splits)
    per = -(-per // M_SLICE) * M_SLICE
    dw = torch.zeros(H, G3, dtype=F32)
    for m0 in range(0, M, per):
        part = torch.zeros_like(dw)
        for s0 in range(m0, min(M, m0 + per), M_SLICE):
            part = part + (a[s0:s0 + M_SLICE].float().t()
                           @ dhp_all[s0:s0 + M_SLICE].float())
        dw = dw + part
    dn_slices = torch.stack(dhps).float()[..., 2 * H:]   # [T, N, H]
    db = torch.zeros(H, dtype=F32)
    blocks = []
    for n0 in range(0, N, rows):
        block = torch.zeros(H, dtype=F32)
        for t in reversed(range(T)):
            block = block + dn_slices[t, n0:n0 + rows].sum(0)
        blocks.append(block)
        db = db + block
    if state is not None:
        state.update(dhp=torch.stack(dhps), hin=torch.stack(hins),
                     db_blocks=blocks)
    return torch.stack(dxps), dw.to(dt), db.to(dt), dh0


def _plain_grads(args, probe):
    names = ("x_proj", "wh", "bias_h", "h0")
    leaves = {k: args[k].clone().requires_grad_() for k in names}
    ys = gru_sequence_reference(leaves["x_proj"], args["keep"], leaves["wh"],
                                leaves["bias_h"], leaves["h0"])
    return torch.autograd.grad((ys.float() * probe.float()).sum(),
                               list(leaves.values()))


def _jax_grads(args, probe):
    def j(t):
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)

    keep = j(args["keep"])
    probe_j = j(probe).astype(jnp.float32)

    def loss(x_proj, wh, bh, h0):
        ys = jax_gru_seq(x_proj, keep, wh, bh, h0, True)
        return jnp.sum(ys.astype(jnp.float32) * probe_j)

    diff = ("x_proj", "wh", "bias_h", "h0")
    grads = jax.grad(loss, argnums=(0, 1, 2, 3))(*(j(args[k]) for k in diff))
    return tuple(torch.from_numpy(np.asarray(g, np.float32)) for g in grads)


def _emulated(args, probe, **kw):
    return emulate_tc_bwd(**args, ys=_forward_states(**args), dys=probe, **kw)


def _check(got, want, what):
    for name, g, w in zip(NAMES, got, want):
        err = (g.float() - w.float()).abs().max().item()
        scale = w.float().abs().max().item()
        assert err <= BWD_RTOL * scale, (
            f"{what} {name}: max |diff| {err:.3e} above {BWD_RTOL} x "
            f"max |want| {scale:.3e}")


CASES = [(5, 70, 128), (4, 70, 128)]


@pytest.mark.parametrize("T,N,H", CASES)
def test_tc_gru_bwd_arithmetic_meets_the_plain_contract(T, N, H):
    args, probe = _inputs(70 + T, T, N, H)
    _check(_emulated(args, probe), _plain_grads(args, probe), "vs plain")


@pytest.mark.parametrize("T,N,H", CASES)
def test_tc_gru_bwd_arithmetic_matches_the_pallas_backward(T, N, H):
    args, probe = _inputs(80 + T, T, N, H)
    _check(_emulated(args, probe), _jax_grads(args, probe), "vs Pallas")


def test_tc_gru_weight_gradients_do_not_depend_on_the_split_count():
    """dWh summed over a few splits or many stays within the rule: the
    split count is a tuning choice (``_num_splits_tc``), not part of the
    contract; dbh does not depend on R's blocks either."""
    args, probe = _inputs(60, 4, 70, 128)
    one = _emulated(args, probe, sms=1, rows=16)
    many = _emulated(args, probe, sms=H100_SMS, rows=tc_rows(128))
    _check(many, one, "splits")
    assert torch.equal(many[0], one[0]) and torch.equal(many[3], one[3])


@pytest.mark.parametrize("dtype,H,tensor_core", [
    (BF16, 256, True),      # the headline_gru update minibatch
    (BF16, 128, True),
    (BF16, 192, False),     # no kernel at this width
    (BF16, 384, True),      # the two-block cluster
    (F32, 256, False),      # float32 stays on CUDA cores
    (F32, 128, False),
    (torch.float16, 256, True),    # headline_gru_fp16's f16 wgmma
    (torch.float16, 128, True),
    (torch.float16, 384, True),    # f16 in the cluster
])
def test_gru_bwd_path_rule(dtype, H, tensor_core):
    """The route depends on dtype and H alone."""
    assert bwd_uses_tensor_cores(dtype, H) is tensor_core


def test_gru_bwd_wrapper_refuses_what_no_kernel_takes():
    """Tensors off the CPU go to the kernel wrapper, which raises on what
    neither path takes (meta tensors are never on the card; no kernel at H
    = 192) instead of falling back, and counts no launch."""
    before = {k.name: (k.launches, k.tc_launches) for k in KERNELS}

    def meta(*shape, dtype=BF16):
        return torch.empty(*shape, dtype=dtype, device="meta")

    T, N = 2, 8
    for H, dtype in ((256, BF16), (128, F32), (192, BF16)):
        state = meta(T, N, H, dtype=dtype)
        with pytest.raises(ValueError):
            gru_sequence_bwd(meta(T, N, 3 * H, dtype=dtype),
                             meta(T, N, dtype=dtype),
                             meta(H, 3 * H, dtype=dtype), meta(H, dtype=dtype),
                             meta(N, H, dtype=dtype), state, state)
    assert {k.name: (k.launches, k.tc_launches) for k in KERNELS} == before
