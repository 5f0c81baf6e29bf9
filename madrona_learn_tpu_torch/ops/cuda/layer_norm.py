"""layer_norm_fwd / layer_norm_bwd: row LayerNorm as CUDA kernels, with a
plain twin.

Replaces ``madrona_learn_tpu/ops/pallas/layer_norm.py:layer_norm`` (forward
``_fwd_kernel``, backward ``_bwd_kernel`` with its dw/db accumulation).
``csrc/layer_norm.cu`` explains the Hopper design: one warp per row with the
row in registers, mu and rsigma saved for the backward, and dw/db as f32
partials over fixed blocks of ``BWD_PART_ROWS`` rows summed by a second
launch in a fixed order, where the TPU kernel accumulated into one block
across its sequential grid. The kernels are bound by device-memory bytes.

Contract: ``x`` [N, D] float32 or bfloat16 with 0 < D <= 1024, ``weight``
and ``bias`` [D] float32; statistics in float32 with a two-pass variance,
``y`` rounded to x's dtype; ``dx`` in x's dtype, ``dw`` / ``db`` in
float32. This is the JAX kernel's math, which differs in the last bits from
the flax-style ``models.common.LayerNorm`` (``E[x^2] - E[x]^2``).

CPU tensors take the plain version; CUDA tensors launch the kernels or
raise.
"""

from __future__ import annotations

import functools

import torch

from .build import Kernel, check, check_operand, library

LAYER_NORM_FWD = Kernel(
    name="layer_norm_fwd",
    source="madrona_learn_tpu_torch/csrc/layer_norm.cu",
    replaces="madrona_learn_tpu/ops/pallas/layer_norm.py:76",
)
LAYER_NORM_BWD = Kernel(
    name="layer_norm_bwd",
    source="madrona_learn_tpu_torch/csrc/layer_norm.cu",
    replaces="madrona_learn_tpu/ops/pallas/layer_norm.py:116",
)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_WIDTH = 1024
_check = functools.partial(check_operand, "layer_norm kernel")


def layer_norm_reference(x, weight, bias, eps=1e-6):
    """Plain twin of ``layer_norm_reference`` (ops/pallas/layer_norm.py:154),
    two-pass variance. Differentiable by autograd; its gradients are the
    plain version of ``layer_norm_bwd``."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def _check_inputs(x, weight):
    if x.dim() != 2:
        raise ValueError(f"layer_norm kernel: x must be [N, D], got "
                         f"{tuple(x.shape)}")
    n, d = x.shape
    if x.dtype not in _DTYPE_CODES or not 0 < d <= MAX_WIDTH or n == 0:
        raise ValueError(
            f"layer_norm kernel: supports float32/bfloat16 x with 0 < D <= "
            f"{MAX_WIDTH} and N > 0, got {x.dtype} {tuple(x.shape)}")
    _check("x", x, x.dtype, (n, d))
    _check("weight", weight, torch.float32, (d,))
    return n, d


def layer_norm_fwd(x, weight, bias, eps=1e-6):
    """The forward kernel: (y [N, D] in x's dtype, mu [N], rsigma [N])."""
    n, d = _check_inputs(x, weight)
    _check("bias", bias, torch.float32, (d,))
    y = torch.empty_like(x)
    mu = torch.empty((n,), dtype=torch.float32, device=x.device)
    rsigma = torch.empty_like(mu)
    err = library().mlt_layer_norm_fwd(
        _DTYPE_CODES[x.dtype], d, x.data_ptr(), weight.data_ptr(),
        bias.data_ptr(), y.data_ptr(), mu.data_ptr(), rsigma.data_ptr(), n,
        float(eps), torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "layer_norm_fwd")
    LAYER_NORM_FWD.launches += 1
    return y, mu, rsigma


# Rows of one dw / db partial, the main pass's block (kPartRows in
# csrc/layer_norm.cu): a constant, so dw and db depend on the inputs alone,
# not on the card's SM count.
BWD_PART_ROWS = 128


def bwd_partials(n):
    """The dw / db partials of an [n, D] backward."""
    return -(-n // BWD_PART_ROWS)


def _bwd_buffers(x):
    """Outputs and scratch of :func:`_bwd` for this x."""
    n, d = x.shape
    f32, device = torch.float32, x.device
    return dict(
        dx=torch.empty_like(x),
        part=torch.empty((2, bwd_partials(n), d), dtype=f32, device=device),
        dw=torch.empty((d,), dtype=f32, device=device),
        db=torch.empty((d,), dtype=f32, device=device))


def _bwd(x, weight, mu, rsigma, dy, *, phases=3, buffers=None):
    """The backward in its two launches, phases bit 0 the main pass (dx and
    the partials) and bit 1 the reduction (dw, db); the buffers of
    :func:`_bwd_buffers`, filled."""
    n, d = x.shape
    b = _bwd_buffers(x) if buffers is None else buffers
    err = library().mlt_layer_norm_bwd(
        _DTYPE_CODES[x.dtype], d, x.data_ptr(), weight.data_ptr(),
        mu.data_ptr(), rsigma.data_ptr(), dy.data_ptr(), b["dx"].data_ptr(),
        b["part"].data_ptr(), b["dw"].data_ptr(), b["db"].data_ptr(), n,
        b["part"].shape[1], phases,
        torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "layer_norm_bwd")
    return b


def layer_norm_bwd(x, weight, mu, rsigma, dy):
    """The backward kernel: (dx, dw, db) given the forward's statistics."""
    n, d = _check_inputs(x, weight)
    _check("mu", mu, torch.float32, (n,))
    _check("rsigma", rsigma, torch.float32, (n,))
    _check("dy", dy, x.dtype, (n, d))
    b = _bwd(x, weight, mu, rsigma, dy)
    LAYER_NORM_BWD.launches += 1
    return b["dx"], b["dw"], b["db"]


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        y, mu, rsigma = layer_norm_fwd(x, weight, bias, eps)
        ctx.save_for_backward(x, weight, mu, rsigma)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, mu, rsigma = ctx.saved_tensors
        dx, dw, db = layer_norm_bwd(x, weight, mu, rsigma,
                                    dy.to(x.dtype).contiguous())
        return dx, dw, db, None


def layer_norm(x, weight, bias, eps=1e-6):
    """y [N, D] in x's dtype: the LayerNorm kernel pair, differentiable."""
    if x.device.type == "cpu":
        return layer_norm_reference(x, weight, bias, eps)
    return _LayerNorm.apply(x, weight, bias, eps)
