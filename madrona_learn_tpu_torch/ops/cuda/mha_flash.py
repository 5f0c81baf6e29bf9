"""mha_flash: flash attention for large entity sets as CUDA kernels, with
plain versions.

Replaces ``madrona_learn_tpu/ops/pallas/attention.py:mha_flash``, the route
``SelfAttention`` takes for entity sets padded past 256: the forward
(``_mha_flash_kernel`` through ``_mha_flash_impl``) and the two kernels of
its flash-structured backward (``_mha_flash_bwd_dkdv_kernel`` and
``_mha_flash_bwd_dq_kernel``, wired by ``_mha_flash_bwd_rule``).
``csrc/mha_flash.cu`` explains the Hopper design. Every kernel writes only
its own block's rows, so no atomics and no [B, H, S, S] tensor, and runs
each (b, h) problem the same way whatever B is (batch invariance). In
bfloat16 all three run on Hopper's warpgroup tensor cores
(FlashAttention-2's shape on ``wgmma``, the streamed operand as bf16 tiles
filled by ``cp.async``): the forward keeps the online softmax in registers
and takes P . V in f32 from p split into two bf16 halves; dK/dV works
transposed, a block owning keys and streaming queries, and dQ a block
owning queries and streaming keys, each rebuilding p with ``exp2`` and
splitting p and dS into bf16 halves for their f32 products. In float32
(tensor cores would round its f32 products) the kernels keep one thread
per row of one problem with f32 FMAs on CUDA cores. Each C entry point
picks its kernel by dtype.

Contract: ``q``, ``k``, ``v`` ``[B, S, H, D]`` in float32 or bfloat16, any
S >= 1, D one of 16, 32, 64; f32 scores ``(q . k) * D^-0.5``; keys at
``valid_len`` and above take no part; the forward returns the output in the
storage dtype and ``lse`` ``[B, H, S]`` float32 (natural log). The backward
rebuilds ``p = exp(s - lse)`` and returns ``dq``, ``dk``, ``dv`` in the
storage dtype, from f32 accumulators. ``delta = rowsum(dO * out)`` is one
torch op (``mha_flash_delta``) before the two backward kernels, as JAX
computes it outside Pallas.

``mha_flash`` is differentiable. CPU tensors take the plain versions
(forward and the FlashAttention-2 backward on the materialized score
tensor); CUDA tensors launch the kernels or raise.
"""

from __future__ import annotations

import torch

from .build import Kernel, check, check_operand, library

MHA_FLASH_FWD = Kernel(
    name="mha_flash_fwd",
    source="madrona_learn_tpu_torch/csrc/mha_flash.cu",
    replaces="madrona_learn_tpu/ops/pallas/attention.py:208",
)
MHA_FLASH_BWD_DKDV = Kernel(
    name="mha_flash_bwd_dkdv",
    source="madrona_learn_tpu_torch/csrc/mha_flash.cu",
    replaces="madrona_learn_tpu/ops/pallas/attention.py:273",
)
MHA_FLASH_BWD_DQ = Kernel(
    name="mha_flash_bwd_dq",
    source="madrona_learn_tpu_torch/csrc/mha_flash.cu",
    replaces="madrona_learn_tpu/ops/pallas/attention.py:318",
)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64)
_NEG_INF = -1e30


def _scores(q, k, valid_len):
    """f32 [B, H, S, S] scores, keys at valid_len and above at -1e30."""
    S = q.shape[1]
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    if valid_len < S:
        key_mask = torch.arange(S, device=q.device) < valid_len
        s = torch.where(key_mask, s, _NEG_INF)
    return s


def mha_flash_reference(q, k, v, valid_len):
    """Plain forward: (out [B, S, H, D] in q's dtype, lse [B, H, S] f32)."""
    s = _scores(q, k, valid_len)
    lse = torch.logsumexp(s, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", torch.exp(s - lse[..., None]),
                       v.float())
    return out.to(q.dtype), lse


def mha_flash_delta(out, dout):
    """delta = rowsum(dO * out) in f32, [B, S, H]."""
    return (dout.float() * out.float()).sum(dim=-1)


def mha_flash_bwd_reference(q, k, v, out, lse, dout, valid_len):
    """Plain backward: the FlashAttention-2 formulas of
    ``_mha_flash_bwd_rule`` on the materialized f32 score tensor; (dq, dk,
    dv) in the input dtypes."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    p = torch.exp(_scores(q, k, valid_len) - lse[..., None])   # [B, H, S, S]
    do32 = dout.float()
    dv = torch.einsum("bhst,bshd->bthd", p, do32)
    dp = torch.einsum("bshd,bthd->bhst", do32, v.float())
    delta = mha_flash_delta(out, dout).transpose(1, 2)         # [B, H, S]
    ds = p * (dp - delta[..., None]) * scale
    dk = torch.einsum("bhst,bshd->bthd", ds, q.float())
    dq = torch.einsum("bhst,bthd->bshd", ds, k.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_inputs(q, k, v, valid_len):
    if q.dim() != 4:
        raise ValueError(f"mha_flash kernel: q must be [B, S, H, D], got "
                         f"{tuple(q.shape)}")
    B, S, H, D = q.shape
    if q.dtype not in _DTYPE_CODES or D not in _HEAD_DIMS:
        raise ValueError(
            f"mha_flash kernel: supports float32/bfloat16 with D in "
            f"{_HEAD_DIMS}, got {q.dtype} D={D}")
    if B == 0 or S == 0 or H == 0:
        raise ValueError(f"mha_flash kernel: empty input {tuple(q.shape)}")
    if not 0 < valid_len <= S:
        raise ValueError(f"mha_flash kernel: valid_len must be in [1, {S}], "
                         f"got {valid_len}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if (x.device.type != "cuda" or x.dtype != q.dtype
                or x.shape != q.shape or not x.is_contiguous()
                or x.data_ptr() % 16):
            raise ValueError(
                f"mha_flash kernel: {name} must be a contiguous, 16-byte "
                f"aligned {q.dtype} CUDA tensor of shape {tuple(q.shape)}, "
                f"got {x.dtype} {tuple(x.shape)} on {x.device} "
                f"(contiguous={x.is_contiguous()})")
    return B, S, H, D


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def mha_flash_fwd(q, k, v, valid_len):
    """The forward kernel: (out [B, S, H, D] in the storage dtype, lse
    [B, H, S] float32)."""
    B, S, H, D = _check_inputs(q, k, v, valid_len)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    err = library().mlt_mha_flash_fwd(
        _DTYPE_CODES[q.dtype], D, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), lse.data_ptr(), B, S, H, valid_len, D ** -0.5,
        _stream(q))
    check(err, "mha_flash_fwd")
    MHA_FLASH_FWD.launches += 1
    return out, lse


def _check_bwd(q, k, v, dout, lse, delta, valid_len):
    B, S, H, D = _check_inputs(q, k, v, valid_len)
    check_operand("mha_flash kernel", "dout", dout, q.dtype, q.shape)
    check_operand("mha_flash kernel", "lse", lse, torch.float32, (B, H, S))
    check_operand("mha_flash kernel", "delta", delta, torch.float32,
                  (B, S, H))
    if dout.data_ptr() % 16:
        raise ValueError("mha_flash kernel: dout must be 16-byte aligned")
    return B, S, H, D


def mha_flash_bwd_dkdv(q, k, v, dout, lse, delta, valid_len):
    """The dK/dV kernel: (dk, dv) in the storage dtype."""
    B, S, H, D = _check_bwd(q, k, v, dout, lse, delta, valid_len)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = library().mlt_mha_flash_bwd_dkdv(
        _DTYPE_CODES[q.dtype], D, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B, S, H, valid_len, D ** -0.5, _stream(q))
    check(err, "mha_flash_bwd_dkdv")
    MHA_FLASH_BWD_DKDV.launches += 1
    return dk, dv


def mha_flash_bwd_dq(q, k, v, dout, lse, delta, valid_len):
    """The dQ kernel: dq in the storage dtype."""
    B, S, H, D = _check_bwd(q, k, v, dout, lse, delta, valid_len)
    dq = torch.empty_like(q)
    err = library().mlt_mha_flash_bwd_dq(
        _DTYPE_CODES[q.dtype], D, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        B, S, H, valid_len, D ** -0.5, _stream(q))
    check(err, "mha_flash_bwd_dq")
    MHA_FLASH_BWD_DQ.launches += 1
    return dq


def mha_flash_bwd(q, k, v, out, lse, dout, valid_len):
    """The backward on the card: delta, then the two kernels; (dq, dk,
    dv)."""
    delta = mha_flash_delta(out, dout)
    dk, dv = mha_flash_bwd_dkdv(q, k, v, dout, lse, delta, valid_len)
    dq = mha_flash_bwd_dq(q, k, v, dout, lse, delta, valid_len)
    return dq, dk, dv


class _MHAFlash(torch.autograd.Function):
    """Saves q, k, v, out and lse, as ``_mha_flash_fwd_rule`` does."""

    @staticmethod
    def forward(ctx, q, k, v, valid_len):
        fwd = mha_flash_reference if q.device.type == "cpu" else mha_flash_fwd
        out, lse = fwd(q, k, v, valid_len)
        ctx.valid_len = valid_len
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = (mha_flash_bwd_reference if q.device.type == "cpu"
               else mha_flash_bwd)
        dq, dk, dv = bwd(q, k, v, out, lse, g.to(q.dtype).contiguous(),
                         ctx.valid_len)
        return dq, dk, dv, None


def mha_flash(q, k, v, valid_len=None):
    """q, k, v [B, S, H, D] -> [B, S, H, D]; only the first ``valid_len``
    keys take part. Differentiable."""
    if valid_len is None:
        valid_len = q.shape[1]
    return _MHAFlash.apply(q, k, v, valid_len)
