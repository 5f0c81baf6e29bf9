"""grouped_matmul: per-chunk policy weights without a gather, as a CUDA
kernel with its plain version.

Replaces ``madrona_learn_tpu/ops/pallas/grouped_matmul.py:grouped_matmul``
(``_kernel``): ``y[c] = x[c] . weights[chunk_policy[c]]`` for each
policy-pure chunk ``c``, the grouped GEMM of multi-policy inference.
Every product of the population rollout's batched pass goes through it
(the policy-batched forms of ``models/common.py``); the JAX package routes
it nowhere.
``csrc/grouped_matmul.cu`` explains the Hopper design: a block reads its
chunk's policy index and addresses that policy's weight tiles directly, so
no ``[B, IN, OUT]`` copy of the weights is gathered. Two paths, picked by
:func:`uses_tensor_cores` from the dtype, the shape and the alignment alone:

- bfloat16 or float16 with IN and OUT multiples of 8 and x and weights on
  16-byte boundaries (16-byte rows at 16-byte addresses, which TMA needs):
  128 x 128 output tiles on Hopper's warpgroup tensor cores (``wgmma``,
  f32 accumulators), fed by TMA through a 3-stage ring in shared memory;
- float32 (tensor cores would round its products), and any other bfloat16
  or float16 operands (the IN = 2 first layer, heads of 5 or 1 outputs):
  64 x 64 output tiles, f32 FMAs on CUDA cores.

Contract: ``x`` [B, C, IN] and ``weights`` [P, IN, OUT] in one dtype
(float32, bfloat16 or float16), ``chunk_policy`` [B] int32 in [0, P); the
product summed in f32 and rounded once to x's dtype; a chunk whose index lies
outside [0, P) gets NaN rows. Forward only, as in JAX (no VJP). CPU tensors
take the plain version; CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import torch

from .build import Kernel, check, check_operand, library

GROUPED_MATMUL = Kernel(
    name="grouped_matmul",
    source="madrona_learn_tpu_torch/csrc/grouped_matmul.cu",
    replaces="madrona_learn_tpu/ops/pallas/grouped_matmul.py:36",
)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def grouped_matmul_reference(x, weights, chunk_policy):
    """Plain version of ``grouped_matmul_reference``
    (ops/pallas/grouped_matmul.py:74): gather each chunk's weights, a
    batched f32 product, one rounding to x's dtype; NaN rows for a chunk
    whose index lies outside [0, P), as the kernel."""
    P = weights.shape[0]
    idx = chunk_policy.long()
    valid = (idx >= 0) & (idx < P)
    w = weights[idx.clamp(0, P - 1)]   # [B, IN, OUT]
    y = torch.bmm(x.float(), w.float())
    return torch.where(valid[:, None, None], y, float("nan")).to(x.dtype)


def uses_tensor_cores(x, weights):
    """The path rule: bfloat16 or float16 x [B, C, IN] and weights [P, IN,
    OUT] with IN and OUT multiples of 8, both starting on a 16-byte
    boundary, take the tensor-core kernel; everything else takes the
    CUDA-core one."""
    return (x.dtype in (torch.bfloat16, torch.float16)
            and x.shape[-1] % 8 == 0
            and weights.shape[-1] % 8 == 0 and x.data_ptr() % 16 == 0
            and weights.data_ptr() % 16 == 0)


def _check_inputs(x, weights, chunk_policy):
    if x.dim() != 3 or weights.dim() != 3:
        raise ValueError(f"grouped_matmul kernel: x must be [B, C, IN] and "
                         f"weights [P, IN, OUT], got {tuple(x.shape)} and "
                         f"{tuple(weights.shape)}")
    B, C, IN = x.shape
    P, _, OUT = weights.shape
    if x.dtype not in _DTYPE_CODES or min(B, C, IN, P, OUT) == 0:
        raise ValueError(
            f"grouped_matmul kernel: supports non-empty float32/bfloat16/"
            f"float16 operands, got {x.dtype} x {tuple(x.shape)}, weights "
            f"{tuple(weights.shape)}")
    check_operand("grouped_matmul kernel", "x", x, x.dtype, (B, C, IN))
    check_operand("grouped_matmul kernel", "weights", weights, x.dtype,
                  (P, IN, OUT))
    check_operand("grouped_matmul kernel", "chunk_policy", chunk_policy,
                  torch.int32, (B,))
    return B, C, IN, P, OUT


def grouped_matmul(x, weights, chunk_policy):
    """x [B, C, IN], weights [P, IN, OUT], chunk_policy [B] int32 -> [B, C,
    OUT] with ``y[i] = x[i] @ weights[chunk_policy[i]]``."""
    if x.device.type == "cpu":
        return grouped_matmul_reference(x, weights, chunk_policy)
    return _launch(x, weights, chunk_policy)


def _launch(x, weights, chunk_policy):
    """The kernel launch of :func:`grouped_matmul` for operands on the
    card, on the route :func:`uses_tensor_cores` names."""
    B, C, IN, P, OUT = _check_inputs(x, weights, chunk_policy)
    tensor_core = uses_tensor_cores(x, weights)
    y = torch.empty((B, C, OUT), dtype=x.dtype, device=x.device)
    err = library().mlt_grouped_matmul(
        _DTYPE_CODES[x.dtype], int(tensor_core), x.data_ptr(),
        weights.data_ptr(), chunk_policy.data_ptr(), y.data_ptr(), B, C, IN,
        P, OUT, torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "grouped_matmul")
    GROUPED_MATMUL.launches += 1
    GROUPED_MATMUL.tc_launches += int(tensor_core)
    return y
