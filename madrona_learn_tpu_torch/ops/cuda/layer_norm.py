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

``layer_norm_fwd_chunked`` / ``layer_norm_bwd_chunked`` are the
chunk-indexed instances of the pair, the LayerNorm of a population's
policy-batched passes (JAX ``vmap``s the kernel-backed LayerNorm over
policy chunks in collect, ``madrona_learn_tpu/rollouts.py:580``, and over
the train policies in learn, ``madrona_learn_tpu/train.py:315``): ``x``
holds B chunks of C rows, ``scale`` / ``bias`` are float32 ``[P, D]``
stacks, and chunk b runs with policy ``chunk_policy[b]``'s, each row
bitwise ``layer_norm_fwd``'s with them (a chunk whose policy lies outside
[0, P) gets NaN rows); the backward's ``dscale[p]`` / ``dbias[p]`` sum
fixed ``BWD_PART_ROWS``-row partials of policy p's chunks in chunk order
(zeros for a policy without a chunk). ``layer_norm_chunked`` is the
differentiable pair, whose plain twin ``layer_norm_chunked_reference``
runs ``layer_norm_reference``'s arithmetic with each row's policy's
weights.

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

# The chunk-indexed instances: the LayerNorm of a population's
# policy-batched collect step and learn pass.
LAYER_NORM_FWD_CHUNKED = Kernel(
    name="layer_norm_fwd_chunked",
    source="madrona_learn_tpu_torch/csrc/layer_norm.cu",
    replaces="madrona_learn_tpu/ops/pallas/layer_norm.py:76",
)
LAYER_NORM_BWD_CHUNKED = Kernel(
    name="layer_norm_bwd_chunked",
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


def _per_row(stack, chunk_policy, rows):
    """Each row's policy's row of a [P, D] stack, [B * C, D] (zeros for a
    chunk of no policy), and the rows' validity mask [B * C, 1]."""
    P = stack.shape[0]
    valid = (chunk_policy >= 0) & (chunk_policy < P)
    idx = torch.where(valid, chunk_policy, 0).long()
    per_chunk = stack[idx] * valid[:, None]
    B = chunk_policy.shape[0]
    return (per_chunk.repeat_interleave(rows // B, dim=0),
            valid.repeat_interleave(rows // B)[:, None])


def layer_norm_chunked_reference(x, scale, bias, chunk_policy, eps=1e-6):
    """Plain twin of ``layer_norm_chunked``: ``layer_norm_reference``'s
    arithmetic, each row with its chunk's policy's scale and bias of the
    [P, D] stacks, NaN rows for a chunk of no policy. Differentiable by
    autograd, whose gradients are the plain version of
    ``layer_norm_bwd_chunked``: a policy's ``scale`` / ``bias`` gradients
    sum over its chunks' rows, and a policy without a chunk gets zeros."""
    w, valid = _per_row(scale, chunk_policy, x.shape[0])
    b, _ = _per_row(bias, chunk_policy, x.shape[0])
    y = layer_norm_reference(x, w, b, eps)
    return torch.where(valid, y, torch.full((), float("nan"), dtype=y.dtype,
                                            device=y.device))


def _check_chunked(what, x, scale, chunk_policy):
    """The chunked instances' operand checks: (N, D, B, C, P)."""
    if scale.dim() != 2 or chunk_policy.dim() != 1:
        raise ValueError(f"{what}: scale must be [P, D] and chunk_policy "
                         f"[B], got {tuple(scale.shape)}, "
                         f"{tuple(chunk_policy.shape)}")
    n, d = _check_inputs(x, scale[0])
    P, B = scale.shape[0], chunk_policy.shape[0]
    if B == 0 or P == 0 or n % B:
        raise ValueError(f"{what}: {n} rows are not {B} whole chunks of {P} "
                         f"policies")
    _check("scale", scale, torch.float32, (P, d))
    _check("chunk_policy", chunk_policy, torch.int32, (B,))
    return n, d, B, n // B, P


def layer_norm_fwd_chunked(x, scale, bias, chunk_policy, eps=1e-6):
    """The chunk-indexed forward kernel: ``x`` [B * C, D] of B chunks of C
    rows, ``scale`` / ``bias`` float32 [P, D] stacks, ``chunk_policy`` [B]
    int32 -> (y [B * C, D] in x's dtype, mu [B * C], rsigma [B * C]); chunk
    b with policy ``chunk_policy[b]``'s scale and bias, every row bitwise
    ``layer_norm_fwd``'s with them; a chunk whose policy lies outside [0,
    P) gets NaN rows."""
    what = "layer_norm_fwd_chunked"
    n, d, B, C, P = _check_chunked(what, x, scale, chunk_policy)
    _check("bias", bias, torch.float32, (P, d))
    y = torch.empty_like(x)
    mu = torch.empty((n,), dtype=torch.float32, device=x.device)
    rsigma = torch.empty_like(mu)
    err = library().mlt_layer_norm_fwd_chunked(
        _DTYPE_CODES[x.dtype], d, x.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), chunk_policy.data_ptr(), y.data_ptr(),
        mu.data_ptr(), rsigma.data_ptr(), B, C, P, float(eps),
        torch.cuda.current_stream(x.device).cuda_stream)
    check(err, what)
    LAYER_NORM_FWD_CHUNKED.launches += 1
    return y, mu, rsigma


def bwd_partials_chunked(B, C):
    """The dscale / dbias partials of a chunked backward: a
    ``BWD_PART_ROWS``-row tile of one chunk each."""
    return B * -(-C // BWD_PART_ROWS)


def layer_norm_bwd_chunked(x, scale, chunk_policy, mu, rsigma, dy):
    """The chunk-indexed backward kernel, given ``layer_norm_fwd_chunked``'s
    statistics: (dx [B * C, D], dscale [P, D], dbias [P, D]); every row's dx
    equal to ``layer_norm_bwd``'s with its chunk's policy's scale bitwise
    (NaN for a chunk of no policy), and ``dscale[p]`` / ``dbias[p]`` the
    sums of fixed ``BWD_PART_ROWS``-row partials of policy p's chunks in
    chunk order, float32 (zeros for a policy without a chunk)."""
    what = "layer_norm_bwd_chunked"
    n, d, B, C, P = _check_chunked(what, x, scale, chunk_policy)
    _check("mu", mu, torch.float32, (n,))
    _check("rsigma", rsigma, torch.float32, (n,))
    _check("dy", dy, x.dtype, (n, d))
    f32, device = torch.float32, x.device
    partials = bwd_partials_chunked(B, C)
    dx = torch.empty_like(x)
    part = torch.empty((2, partials, d), dtype=f32, device=device)
    dscale = torch.empty((P, d), dtype=f32, device=device)
    dbias = torch.empty_like(dscale)
    err = library().mlt_layer_norm_bwd_chunked(
        _DTYPE_CODES[x.dtype], d, x.data_ptr(), scale.data_ptr(),
        chunk_policy.data_ptr(), mu.data_ptr(), rsigma.data_ptr(),
        dy.data_ptr(), dx.data_ptr(), part.data_ptr(), dscale.data_ptr(),
        dbias.data_ptr(), B, C, P, partials,
        torch.cuda.current_stream(device).cuda_stream)
    check(err, what)
    LAYER_NORM_BWD_CHUNKED.launches += 1
    return dx, dscale, dbias


class _LayerNormChunked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, chunk_policy, eps):
        y, mu, rsigma = layer_norm_fwd_chunked(x, scale, bias, chunk_policy,
                                               eps)
        ctx.save_for_backward(x, scale, chunk_policy, mu, rsigma)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, chunk_policy, mu, rsigma = ctx.saved_tensors
        dx, dscale, dbias = layer_norm_bwd_chunked(
            x, scale, chunk_policy, mu, rsigma, dy.to(x.dtype).contiguous())
        return dx, dscale, dbias, None, None


def layer_norm_chunked(x, scale, bias, chunk_policy, eps=1e-6):
    """y [B * C, D] in x's dtype: the chunk-indexed LayerNorm pair,
    differentiable, chunk b with policy ``chunk_policy[b]``'s scale and bias
    of the float32 [P, D] stacks. CPU tensors take the plain twin."""
    if x.device.type == "cpu":
        return layer_norm_chunked_reference(x, scale, bias, chunk_policy,
                                            eps)
    return _LayerNormChunked.apply(x, scale, bias, chunk_policy, eps)
