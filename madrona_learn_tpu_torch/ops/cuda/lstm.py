"""K2 / K3: the fused LSTM sequence pass as CUDA kernels, with plain twins.

Replaces ``madrona_learn_tpu/ops/pallas/lstm.py:lstm_sequence`` (forward
``_fwd_kernel``, backward ``_bwd_kernel`` with its fused dWr/db epilogue).
``csrc/lstm.cu`` explains the Hopper design: a block owns a tile of batch
rows and loops over time, Wr is read from L2 every step (it does not fit in
shared memory at H = 256), and the weight gradients are per-split f32
partials summed by a second pass instead of one accumulator shared by the
whole grid. On this card the first version is bound by CUDA-core FMA issue,
not by bytes.

Contract (all operands in the storage dtype, float32 or bfloat16):

- ``x_proj`` [T, N, 4H] pre-projected inputs, gates (i, f, g, o);
- ``keep`` [T, N]: 0 clears the carry after step t;
- ``wr`` [H, 4H], ``bias`` [4H], ``c0``/``h0`` [N, H];
- gate math in f32, ``h . Wr`` accumulated in f32, ``ys``/``cs`` rounded to
  the storage dtype.

CPU tensors take the plain versions; CUDA tensors launch the kernels or
raise.
"""

from __future__ import annotations

import torch

from .build import Kernel, check, library

LSTM_FWD = Kernel(
    name="lstm_sequence_fwd",
    source="madrona_learn_tpu_torch/csrc/lstm.cu",
    replaces="madrona_learn_tpu/ops/pallas/lstm.py:264",
)
LSTM_BWD = Kernel(
    name="lstm_sequence_bwd",
    source="madrona_learn_tpu_torch/csrc/lstm.cu",
    replaces="madrona_learn_tpu/ops/pallas/lstm.py:283",
)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HIDDEN_SIZES = (128, 256)


def _cell(x_proj_t, wr32, b32, c, h):
    """One step of the precise-gates cell: f32 math, storage-dtype carry."""
    f32 = torch.float32
    gates = x_proj_t.to(f32) + h.to(f32) @ wr32 + b32
    gi, gf, gg, go = gates.chunk(4, dim=-1)
    new_c = torch.sigmoid(gf) * c.to(f32) + torch.sigmoid(gi) * torch.tanh(gg)
    new_h = torch.sigmoid(go) * torch.tanh(new_c)
    return new_c.to(x_proj_t.dtype), new_h.to(x_proj_t.dtype)


def lstm_sequence_reference(x_proj, keep, wr, bias, c0, h0):
    """Plain twin of ``lstm_sequence_reference`` (ops/pallas/lstm.py:643).

    Differentiable by autograd; its gradients are the plain version of K3.
    """
    wr32, b32 = wr.float(), bias.float()
    c, h = c0, h0
    ys = []
    for t in range(x_proj.shape[0]):
        new_c, new_h = _cell(x_proj[t], wr32, b32, c, h)
        mask = keep[t][:, None] > 0.5
        c = torch.where(mask, new_c, torch.zeros((), dtype=new_c.dtype,
                                                 device=new_c.device))
        h = torch.where(mask, new_h, torch.zeros((), dtype=new_h.dtype,
                                                 device=new_h.device))
        ys.append(new_h)
    return torch.stack(ys)


def _check(name, x, dtype, shape):
    if (x.device.type != "cuda" or x.dtype != dtype
            or tuple(x.shape) != tuple(shape) or not x.is_contiguous()):
        raise ValueError(
            f"lstm kernel: {name} must be a contiguous {dtype} CUDA tensor "
            f"of shape {tuple(shape)}, got {x.dtype} {tuple(x.shape)} on "
            f"{x.device} (contiguous={x.is_contiguous()})")


def _check_inputs(x_proj, keep, wr, bias, c0, h0):
    if x_proj.dim() != 3 or x_proj.shape[-1] % 4:
        raise ValueError(f"lstm kernel: x_proj must be [T, N, 4H], got "
                         f"{tuple(x_proj.shape)}")
    steps, n, g4 = x_proj.shape
    hidden = g4 // 4
    dtype = x_proj.dtype
    if dtype not in _DTYPE_CODES or hidden not in _HIDDEN_SIZES:
        raise ValueError(
            f"lstm kernel: supports float32/bfloat16 with H in "
            f"{_HIDDEN_SIZES}, got {dtype} H={hidden}")
    if steps == 0 or n == 0:
        raise ValueError(f"lstm kernel: empty input {tuple(x_proj.shape)}")
    _check("x_proj", x_proj, dtype, (steps, n, g4))
    _check("keep", keep, dtype, (steps, n))
    _check("wr", wr, dtype, (hidden, g4))
    _check("bias", bias, dtype, (g4,))
    _check("c0", c0, dtype, (n, hidden))
    _check("h0", h0, dtype, (n, hidden))
    return steps, n, hidden


def lstm_sequence_fwd(x_proj, keep, wr, bias, c0, h0):
    """K2: (ys, cs), each [T, N, H] in the storage dtype."""
    steps, n, hidden = _check_inputs(x_proj, keep, wr, bias, c0, h0)
    ys = torch.empty((steps, n, hidden), dtype=x_proj.dtype,
                     device=x_proj.device)
    cs = torch.empty_like(ys)
    err = library().mlt_lstm_fwd(
        _DTYPE_CODES[x_proj.dtype], hidden, x_proj.data_ptr(),
        keep.data_ptr(), wr.data_ptr(), bias.data_ptr(), c0.data_ptr(),
        h0.data_ptr(), ys.data_ptr(), cs.data_ptr(), steps, n,
        torch.cuda.current_stream(x_proj.device).cuda_stream)
    check(err, "lstm_sequence_fwd")
    LSTM_FWD.launches += 1
    return ys, cs


def _num_splits(steps, n, hidden, num_sms):
    """Row splits for the weight-gradient partials: about four blocks per
    SM, and at least 32 rows per split."""
    tiles = (4 * hidden // 64) * (hidden // 64)
    return max(1, min(-(-4 * num_sms // tiles), (steps * n) // 32))


def lstm_sequence_bwd(x_proj, keep, wr, bias, c0, h0, ys, cs, dys):
    """K3: (dx_proj, dwr, db, dc0, dh0) given the forward's ys / cs."""
    steps, n, hidden = _check_inputs(x_proj, keep, wr, bias, c0, h0)
    dtype, device = x_proj.dtype, x_proj.device
    _check("ys", ys, dtype, (steps, n, hidden))
    _check("cs", cs, dtype, (steps, n, hidden))
    _check("dys", dys, dtype, (steps, n, hidden))
    wr_t = wr.t().contiguous()
    splits = _num_splits(
        steps, n, hidden,
        torch.cuda.get_device_properties(device).multi_processor_count)
    dxp = torch.empty_like(x_proj)
    dh0 = torch.empty_like(h0)
    dc0 = torch.empty_like(c0)
    part_w = torch.empty((splits, hidden, 4 * hidden), dtype=torch.float32,
                         device=device)
    part_b = torch.empty((splits, 4 * hidden), dtype=torch.float32,
                         device=device)
    dwr = torch.empty_like(wr)
    db = torch.empty_like(bias)
    err = library().mlt_lstm_bwd(
        _DTYPE_CODES[dtype], hidden, x_proj.data_ptr(), keep.data_ptr(),
        wr.data_ptr(), wr_t.data_ptr(), bias.data_ptr(), c0.data_ptr(),
        h0.data_ptr(), ys.data_ptr(), cs.data_ptr(), dys.data_ptr(),
        dxp.data_ptr(), dh0.data_ptr(), dc0.data_ptr(), part_w.data_ptr(),
        part_b.data_ptr(), dwr.data_ptr(), db.data_ptr(), steps, n, splits,
        torch.cuda.current_stream(device).cuda_stream)
    check(err, "lstm_sequence_bwd")
    LSTM_BWD.launches += 1
    return dxp, dwr, db, dc0, dh0


class _LSTMSequence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_proj, keep, wr, bias, c0, h0):
        ys, cs = lstm_sequence_fwd(x_proj, keep, wr, bias, c0, h0)
        ctx.save_for_backward(x_proj, keep, wr, bias, c0, h0, ys, cs)
        return ys

    @staticmethod
    def backward(ctx, dys):
        x_proj, keep, wr, bias, c0, h0, ys, cs = ctx.saved_tensors
        dxp, dwr, db, dc0, dh0 = lstm_sequence_bwd(
            x_proj, keep, wr, bias, c0, h0, ys, cs,
            dys.to(x_proj.dtype).contiguous())
        # keep is a mask: its cotangent is zero, as in the JAX VJP.
        return dxp, None, dwr, db, dc0, dh0


def lstm_sequence(x_proj, keep, wr, bias, c0, h0):
    """ys [T, N, H]: the fused sequence pass, differentiable."""
    if x_proj.device.type == "cpu":
        return lstm_sequence_reference(x_proj, keep, wr, bias, c0, h0)
    return _LSTMSequence.apply(x_proj, keep, wr, bias, c0, h0)


def lstm_step(x_proj, wr, bias, c, h):
    """One rollout step, (new_c, new_h) [N, H], no clearing.

    On the card this is K2 with T = 1, so the rollout forward and the
    update-pass sequence forward share gate math and rounding points and
    PPO's ratio can start at 1.
    """
    if x_proj.device.type == "cpu":
        return _cell(x_proj, wr.float(), bias.float(), c, h)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x_proj, wr, bias, c, h)):
        raise RuntimeError("lstm_step has no backward on CUDA; run the "
                           "rollout step under torch.no_grad()")
    keep = torch.ones((1, x_proj.shape[0]), dtype=x_proj.dtype,
                      device=x_proj.device)
    ys, cs = lstm_sequence_fwd(x_proj.unsqueeze(0), keep, wr, bias, c, h)
    return cs[0], ys[0]
