"""gru_sequence_fwd / gru_sequence_bwd: the fused GRU sequence pass as CUDA
kernels, with a plain twin.

Replaces ``madrona_learn_tpu/ops/pallas/gru.py:gru_sequence`` (forward
``_fwd_kernel``, backward ``_bwd_kernel`` with its fused dWh/dbh
epilogue). ``csrc/gru.cu`` explains the Hopper design, which is the LSTM
kernels': a block owns a tile of batch rows and loops over time, Wh is read
from L2 every step (384 KiB in bf16 at H = 256, more than a block's shared
memory), and dWh/dbh are per-split f32 partials summed in a fixed order by
the pass the LSTM backward uses (``csrc/weight_grad.cuh``). On this card
the first version is bound by CUDA-core FMA issue, not by bytes.

Contract (all operands in the storage dtype, float32 or bfloat16):

- ``x_proj`` [T, N, 3H] pre-projected inputs including the input bias,
  gates packed ``[r | z | n]``;
- ``keep`` [T, N]: 0 clears the carry after step t (step-then-reset);
- ``wh`` [H, 3H]; ``bias_h`` [H], the candidate gate's recurrent bias,
  already rounded to the storage dtype; ``h0`` [N, H];
- linear-before-reset gate math in f32 (``n = tanh(x_n + r * (h . W_hn +
  b_hn))``), ``h . Wh`` accumulated in f32, ``ys`` rounded to the storage
  dtype; the backward rounds ``dxp`` and ``dhp`` to the storage dtype and
  returns ``dwh`` / ``dbh`` in it.

CPU tensors take the plain version; CUDA tensors launch the kernels or
raise.
"""

from __future__ import annotations

import functools

import torch

from .build import Kernel, check, check_operand, library
from .lstm import _num_splits

GRU_FWD = Kernel(
    name="gru_sequence_fwd",
    source="madrona_learn_tpu_torch/csrc/gru.cu",
    replaces="madrona_learn_tpu/ops/pallas/gru.py:192",
)
GRU_BWD = Kernel(
    name="gru_sequence_bwd",
    source="madrona_learn_tpu_torch/csrc/gru.cu",
    replaces="madrona_learn_tpu/ops/pallas/gru.py:211",
)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HIDDEN_SIZES = (128, 256)
_check = functools.partial(check_operand, "gru kernel")


def gru_supported(hidden, dtype):
    """Whether the kernels serve this layer shape (JAX:
    ``ops/pallas/gru.py:47``, which takes any multiple of 128; the kernels
    here are built for 128 and 256)."""
    return hidden in _HIDDEN_SIZES and dtype in _DTYPE_CODES


def _cell(x_proj_t, wh32, bh32, h):
    """One step of the GRU cell (``_gates_fp32``): f32 math, storage-dtype
    result."""
    f32 = torch.float32
    H = h.shape[-1]
    h32 = h.to(f32)
    hp = h32 @ wh32
    xp = x_proj_t.to(f32)
    hn_lin = hp[..., 2 * H:] + bh32
    r = torch.sigmoid(xp[..., :H] + hp[..., :H])
    z = torch.sigmoid(xp[..., H:2 * H] + hp[..., H:2 * H])
    n = torch.tanh(xp[..., 2 * H:] + r * hn_lin)
    return ((1.0 - z) * n + z * h32).to(x_proj_t.dtype)


def gru_sequence_reference(x_proj, keep, wh, bias_h, h0):
    """Plain twin of ``gru_sequence_reference`` (ops/pallas/gru.py:272).

    Differentiable by autograd; its gradients are the plain version of
    ``gru_sequence_bwd``.
    """
    wh32, bh32 = wh.float(), bias_h.float()
    h = h0
    ys = []
    for t in range(x_proj.shape[0]):
        new_h = _cell(x_proj[t], wh32, bh32, h)
        mask = keep[t][:, None] > 0.5
        h = torch.where(mask, new_h, torch.zeros((), dtype=new_h.dtype,
                                                 device=new_h.device))
        ys.append(new_h)
    return torch.stack(ys)


def _check_inputs(x_proj, keep, wh, bias_h, h0):
    if x_proj.dim() != 3 or x_proj.shape[-1] % 3:
        raise ValueError(f"gru kernel: x_proj must be [T, N, 3H], got "
                         f"{tuple(x_proj.shape)}")
    steps, n, g3 = x_proj.shape
    hidden = g3 // 3
    dtype = x_proj.dtype
    if not gru_supported(hidden, dtype):
        raise ValueError(
            f"gru kernel: supports float32/bfloat16 with H in "
            f"{_HIDDEN_SIZES}, got {dtype} H={hidden}")
    if steps == 0 or n == 0:
        raise ValueError(f"gru kernel: empty input {tuple(x_proj.shape)}")
    _check("x_proj", x_proj, dtype, (steps, n, g3))
    _check("keep", keep, dtype, (steps, n))
    _check("wh", wh, dtype, (hidden, g3))
    _check("bias_h", bias_h, dtype, (hidden,))
    _check("h0", h0, dtype, (n, hidden))
    return steps, n, hidden


def gru_sequence_fwd(x_proj, keep, wh, bias_h, h0):
    """The forward kernel: ys [T, N, H] in the storage dtype."""
    steps, n, hidden = _check_inputs(x_proj, keep, wh, bias_h, h0)
    ys = torch.empty((steps, n, hidden), dtype=x_proj.dtype,
                     device=x_proj.device)
    err = library().mlt_gru_fwd(
        _DTYPE_CODES[x_proj.dtype], hidden, x_proj.data_ptr(),
        keep.data_ptr(), wh.data_ptr(), bias_h.data_ptr(), h0.data_ptr(),
        ys.data_ptr(), steps, n,
        torch.cuda.current_stream(x_proj.device).cuda_stream)
    check(err, "gru_sequence_fwd")
    GRU_FWD.launches += 1
    return ys


def gru_sequence_bwd(x_proj, keep, wh, bias_h, h0, ys, dys):
    """The backward kernel: (dxp, dwh, dbh, dh0) given the forward's ys.
    ``dhp`` [T, N, 3H] goes through a scratch to the weight-gradient
    pass."""
    steps, n, hidden = _check_inputs(x_proj, keep, wh, bias_h, h0)
    dtype, device = x_proj.dtype, x_proj.device
    _check("ys", ys, dtype, (steps, n, hidden))
    _check("dys", dys, dtype, (steps, n, hidden))
    wh_t = wh.t().contiguous()
    splits = _num_splits(
        steps, n, hidden,
        torch.cuda.get_device_properties(device).multi_processor_count,
        gates=3)
    dxp = torch.empty_like(x_proj)
    dhp = torch.empty_like(x_proj)
    dh0 = torch.empty_like(h0)
    part_w = torch.empty((splits, hidden, 3 * hidden), dtype=torch.float32,
                         device=device)
    part_b = torch.empty((splits, 3 * hidden), dtype=torch.float32,
                         device=device)
    dwh = torch.empty_like(wh)
    db3 = torch.empty((3 * hidden,), dtype=dtype, device=device)
    err = library().mlt_gru_bwd(
        _DTYPE_CODES[dtype], hidden, x_proj.data_ptr(), keep.data_ptr(),
        wh.data_ptr(), wh_t.data_ptr(), bias_h.data_ptr(), h0.data_ptr(),
        ys.data_ptr(), dys.data_ptr(), dxp.data_ptr(), dhp.data_ptr(),
        dh0.data_ptr(), part_w.data_ptr(), part_b.data_ptr(),
        dwh.data_ptr(), db3.data_ptr(), steps, n, splits,
        torch.cuda.current_stream(device).cuda_stream)
    check(err, "gru_sequence_bwd")
    GRU_BWD.launches += 1
    # bias_h feeds only the candidate gate: its cotangent is dhp's n slice.
    return dxp, dwh, db3[2 * hidden:], dh0


class _GRUSequence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_proj, keep, wh, bias_h, h0):
        ys = gru_sequence_fwd(x_proj, keep, wh, bias_h, h0)
        ctx.save_for_backward(x_proj, keep, wh, bias_h, h0, ys)
        return ys

    @staticmethod
    def backward(ctx, dys):
        x_proj, keep, wh, bias_h, h0, ys = ctx.saved_tensors
        dxp, dwh, dbh, dh0 = gru_sequence_bwd(
            x_proj, keep, wh, bias_h, h0, ys,
            dys.to(x_proj.dtype).contiguous())
        # keep is a mask: its cotangent is zero, as in the JAX VJP.
        return dxp, None, dwh, dbh, dh0


def gru_sequence(x_proj, keep, wh, bias_h, h0):
    """ys [T, N, H]: the fused sequence pass, differentiable."""
    if x_proj.device.type == "cpu":
        return gru_sequence_reference(x_proj, keep, wh, bias_h, h0)
    return _GRUSequence.apply(x_proj, keep, wh, bias_h, h0)


def gru_step(x_proj, wh, bias_h, h):
    """One rollout step, new h [N, H], no clearing.

    On the card this is ``gru_sequence_fwd`` with T = 1, so the rollout
    forward and the update-pass sequence forward share gate math and
    rounding points and PPO's ratio can start at 1.
    """
    if x_proj.device.type == "cpu":
        return _cell(x_proj, wh.float(), bias_h.float(), h)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x_proj, wh, bias_h, h)):
        raise RuntimeError("gru_step has no backward on CUDA; run the "
                           "rollout step under torch.no_grad()")
    keep = torch.ones((1, x_proj.shape[0]), dtype=x_proj.dtype,
                      device=x_proj.device)
    return gru_sequence_fwd(x_proj.unsqueeze(0), keep, wh, bias_h, h)[0]
