"""mha: entity self-attention as a CUDA kernel, with its plain version.

Replaces ``madrona_learn_tpu/ops/pallas/attention.py:mha`` (``_mha_kernel``
through ``_mha_impl``), the single-pass kernel that ``SelfAttention`` routes
entity sets of up to 256 (padded) to. ``csrc/mha.cu`` explains the Hopper
design. It reads ``[B, S, H, D]`` in place; the TPU's transpose to
``[B*H, S, D]`` and its 8-row padding are not needed here. Two paths,
picked by :func:`uses_tensor_cores` from the dtype alone (no fallback: the
kernel a call is routed to runs or raises):

- bfloat16: ``mma.sync`` tensor cores. A block stages whole batch items
  (q, and the valid rows of k and v) in shared memory as bf16 with 16-byte
  copies, one warp owns 16 query rows of one (b, h) problem, the softmax
  runs online over key tiles of 16 with p kept in f32 as three bf16 parts,
  and the output leaves as coalesced 16-byte stores. Bound by bytes;
- float32, whose products tensor cores would round: CUDA cores, one
  thread a query row, the valid keys and values staged as f32.

Contract: ``q``, ``k``, ``v`` ``[B, S, H, D]`` in float32 or bfloat16; f32
scores ``(q . k) * D^-0.5``; keys at ``valid_len`` and above masked out; f32
softmax and ``P . V``; the output in the storage dtype. S is a multiple of
8 up to 256, D one of 16, 32, 64.

Like the JAX package's, the gradient has no kernel of its own: the backward
recomputes through the plain version (``_mha_bwd_rule``). CPU tensors take
the plain version; CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import torch

from .build import Kernel, check, library

MHA = Kernel(
    name="mha",
    source="madrona_learn_tpu_torch/csrc/mha.cu",
    replaces="madrona_learn_tpu/ops/pallas/attention.py:68",
)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64)
# The longest padded set the kernel takes; SelfAttention routes longer
# ones to mha_flash.
MAX_SEQ = 256
_NEG_INF = -1e30
_LOG2E = 1.4426950408889634


def mha_reference(q, k, v, valid_len=None):
    """Plain version of ``mha_reference`` (ops/pallas/attention.py:457):
    [B, S, H, D] attention with an f32 softmax and key masking."""
    S = q.shape[1]
    scale = 1.0 / (q.shape[-1] ** 0.5)
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    if valid_len is not None and valid_len < S:
        key_mask = torch.arange(S, device=q.device) < valid_len
        scores = torch.where(key_mask, scores, _NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", weights, v.float())
    return out.to(q.dtype)


def _check_inputs(q, k, v, valid_len):
    if q.dim() != 4:
        raise ValueError(f"mha kernel: q must be [B, S, H, D], got "
                         f"{tuple(q.shape)}")
    B, S, H, D = q.shape
    if q.dtype not in _DTYPE_CODES or D not in _HEAD_DIMS:
        raise ValueError(
            f"mha kernel: supports float32/bfloat16 with D in {_HEAD_DIMS}, "
            f"got {q.dtype} D={D}")
    if S % 8 or not 0 < S <= MAX_SEQ:
        raise ValueError(f"mha kernel: S must be a multiple of 8 up to "
                         f"{MAX_SEQ}, got {S}")
    if not 0 < valid_len <= S:
        raise ValueError(f"mha kernel: valid_len must be in [1, {S}], got "
                         f"{valid_len}")
    if B == 0 or H == 0:
        raise ValueError(f"mha kernel: empty input {tuple(q.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if (x.device.type != "cuda" or x.dtype != q.dtype
                or x.shape != q.shape or not x.is_contiguous()
                or x.data_ptr() % 16):
            raise ValueError(
                f"mha kernel: {name} must be a contiguous, 16-byte aligned "
                f"{q.dtype} CUDA tensor of shape {tuple(q.shape)}, got "
                f"{x.dtype} {tuple(x.shape)} on {x.device} "
                f"(contiguous={x.is_contiguous()})")
    return B, S, H, D


def uses_tensor_cores(dtype):
    """The path rule: bfloat16 takes the tensor-core kernel (``mma.sync``)
    at every shape the wrapper takes; float32, whose products tensor cores
    would round, the CUDA-core one."""
    return dtype == torch.bfloat16


def mha_fwd(q, k, v, valid_len):
    """The kernel: [B, S, H, D] attention output in the storage dtype."""
    B, S, H, D = _check_inputs(q, k, v, valid_len)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    if uses_tensor_cores(q.dtype):
        err = library().mlt_mha_fwd_tc(
            D, *ptrs, B, S, H, valid_len, _LOG2E / (D ** 0.5), stream)
        check(err, "mha")
        MHA.launches += 1
        MHA.tc_launches += 1
        return out
    err = library().mlt_mha_fwd(
        _DTYPE_CODES[q.dtype], D, *ptrs, B, S, H, valid_len,
        1.0 / (D ** 0.5), stream)
    check(err, "mha")
    MHA.launches += 1
    return out


class _MHA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, valid_len):
        ctx.valid_len = valid_len
        ctx.save_for_backward(q, k, v)
        return mha_fwd(q, k, v, valid_len)

    @staticmethod
    def backward(ctx, g):
        # Recompute through the plain version, as _mha_bwd_rule does.
        q, k, v = (x.detach().requires_grad_() for x in ctx.saved_tensors)
        with torch.enable_grad():
            out = mha_reference(q, k, v, ctx.valid_len)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None


def mha(q, k, v, valid_len=None):
    """q, k, v [B, S, H, D] -> [B, S, H, D]; only the first ``valid_len``
    keys take part. Differentiable."""
    if valid_len is None:
        valid_len = q.shape[1]
    if q.device.type == "cpu":
        return mha_reference(q, k, v, valid_len)
    return _MHA.apply(q, k, v, valid_len)
