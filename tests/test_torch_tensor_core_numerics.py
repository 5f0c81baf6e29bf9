"""The arithmetic of the port's bf16 tensor-core kernels, held on the CPU to
the contracts their plain versions define, and the rules that route a call
to them.

- ``mha_flash_fwd`` in bf16 (``csrc/mha_flash.cu``, flash_fwd_tc_kernel):
  a plain-torch emulation of its arithmetic (64-key tiles, the online
  softmax on scores pre-scaled by ``D^-0.5 log2(e)`` with exp2, p split into
  bf16 hi + lo with P . V in f32, one rounding of the output) against
  ``mha_flash_reference`` under the chip check's per-element rule (|diff| <=
  2^-7 |plain| + 1e-6) and its lse tolerance. Rounding p to bf16 alone
  breaks that rule, which is why the kernel splits it.
- ``grouped_matmul``'s path rule, by dtype, shape and alignment.
- The wrappers still raise ``ValueError`` on what neither path can take.

Inputs come from numpy seeds.
"""

import math

import numpy as np
import pytest
import torch

from madrona_learn_tpu_torch.ops.cuda import KERNELS
from madrona_learn_tpu_torch.ops.cuda.grouped_matmul import (
    grouped_matmul,
    uses_tensor_cores,
)
from madrona_learn_tpu_torch.ops.cuda.mha_flash import (
    mha_flash_fwd,
    mha_flash_reference,
)

torch.set_num_threads(1)

KEYS_PER_TILE = 64
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
# The chip check's lse tolerance (chip_smoke.py TOL["flash_lse"]).
LSE_TOL = dict(atol=1e-5, rtol=1e-5)


def _launches():
    return {k.name: k.launches for k in KERNELS}


def emulate_flash_fwd(q, k, v, valid_len, split_p=True):
    """The tensor-core forward's arithmetic in plain torch: f32 scores of
    bf16 inputs over tiles of 64 keys (the last one cut at valid_len), the
    online softmax in the exp2 domain, P . V in f32 from p = p_hi + p_lo
    (both bf16; p_hi alone if not ``split_p``), out rounded once."""
    D = q.shape[-1]
    # The wrapper passes D^-0.5 as a float; the kernel's launcher multiplies
    # it by log2(e) in f32.
    scale_log2 = float(np.float32(D ** -0.5) * np.float32(LOG2E))
    qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k, v))  # [B, H, S, D]
    m = torch.full(qf.shape[:-1], -math.inf)
    l = torch.zeros(qf.shape[:-1])
    acc = torch.zeros(qf.shape)
    for j0 in range(0, valid_len, KEYS_PER_TILE):
        j1 = min(j0 + KEYS_PER_TILE, valid_len)
        s = qf @ kf[:, :, j0:j1].transpose(-1, -2)
        m_new = torch.maximum(m, s.amax(-1) * scale_log2)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s * scale_log2 - m_new[..., None])
        l = l * alpha + p.sum(-1)
        hi = p.to(torch.bfloat16).float()
        pv = hi @ vf[:, :, j0:j1]
        if split_p:
            lo = (p - hi).to(torch.bfloat16).float()
            pv = pv + lo @ vf[:, :, j0:j1]
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = (acc / l[..., None]).to(torch.bfloat16).transpose(1, 2)
    return out, (m + torch.log2(l)) * LN2


def _inputs(seed, B, S, H, D):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=(B, S, H, D))
                                  .astype(np.float32)).to(torch.bfloat16)
                 for _ in range(3))


def _worst_ulp_ratio(got, want):
    """max |got - want| / (2^-7 |want| + 1e-6): at most 1 passes."""
    diff = (got.float() - want.float()).abs()
    return (diff / (want.float().abs() * 2 ** -7 + 1e-6)).max().item()


@pytest.mark.parametrize("B,S,H,D,valid_len", [
    (2, 130, 2, 16, 97),    # S not a multiple of 64, valid_len mid-tile
    (2, 130, 2, 32, 97),
    (2, 130, 2, 64, 97),
    (2, 512, 4, 32, 511),   # flagship_large's problem shape
])
def test_tensor_core_flash_arithmetic_meets_the_plain_contract(B, S, H, D,
                                                               valid_len):
    q, k, v = _inputs(B * S + D, B, S, H, D)
    want_out, want_lse = mha_flash_reference(q, k, v, valid_len)
    out, lse = emulate_flash_fwd(q, k, v, valid_len)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert _worst_ulp_ratio(out, want_out) <= 1.0
    torch.testing.assert_close(lse, want_lse, **LSE_TOL)


def test_p_rounded_to_bf16_alone_breaks_the_contract():
    """P . V from p rounded once to bf16 misses outputs near 0 by several
    bf16 ulps at flagship_large's shape: the split into hi + lo is
    needed."""
    q, k, v = _inputs(7, 2, 512, 4, 32)
    want_out, _ = mha_flash_reference(q, k, v, 511)
    out, _ = emulate_flash_fwd(q, k, v, 511, split_p=False)
    assert _worst_ulp_ratio(out, want_out) > 2.0


def _aligned_at(shape, dtype, shift):
    """A contiguous tensor whose first element lies ``shift`` elements past
    a 16-byte boundary."""
    n = math.prod(shape)
    buf = torch.zeros(n + 16, dtype=dtype)
    start = (-buf.data_ptr() // buf.element_size()) % (
        16 // buf.element_size()) + shift
    return buf[start:start + n].view(shape)


@pytest.mark.parametrize("dtype,IN,OUT,x_shift,w_shift,tensor_core", [
    (torch.bfloat16, 512, 2048, 0, 0, True),    # grouped_matmul_bench.py
    (torch.bfloat16, 1024, 1024, 0, 0, True),
    (torch.bfloat16, 72, 136, 0, 0, True),      # ragged, but 16-byte rows
    (torch.bfloat16, 70, 96, 0, 0, False),      # IN not a multiple of 8
    (torch.bfloat16, 72, 130, 0, 0, False),     # OUT not a multiple of 8
    (torch.bfloat16, 72, 136, 1, 0, False),     # x off a 16-byte boundary
    (torch.bfloat16, 72, 136, 0, 4, False),     # weights off one
    (torch.float32, 512, 2048, 0, 0, False),    # f32 stays on CUDA cores
])
def test_grouped_matmul_path_rule(dtype, IN, OUT, x_shift, w_shift,
                                  tensor_core):
    x = _aligned_at((2, 3, IN), dtype, x_shift)
    w = _aligned_at((2, IN, OUT), dtype, w_shift)
    assert x.is_contiguous() and w.is_contiguous()
    assert uses_tensor_cores(x, w) is tensor_core


def test_wrappers_refuse_what_neither_path_can_take():
    """Tensors off the CPU go to a kernel wrapper, which raises on what no
    kernel takes instead of falling back. Each case is labelled by the check
    it meets first; a meta tensor is never on the card, so it fails the
    operand check (device, dtype, shape, contiguity in one test) when it
    reaches it."""
    before = _launches()

    def meta(*shape, dtype=torch.bfloat16):
        return torch.empty(*shape, dtype=dtype, device="meta")

    for q, k, valid_len in (
            (meta(4, 300, 2, 32), meta(4, 300, 2, 32), 300),   # operand
            (meta(4, 300, 2, 48), meta(4, 300, 2, 48), 300),   # head dim
            (meta(4, 300, 2, 32), meta(4, 300, 2, 32,
                                       dtype=torch.float32), 300),  # operand
            (meta(4, 300, 2, 32, dtype=torch.float16),
             meta(4, 300, 2, 32, dtype=torch.float16), 300),   # dtype
            (meta(4, 300, 2, 32), meta(4, 300, 2, 32), 0)):    # valid_len
        with pytest.raises(ValueError):
            mha_flash_fwd(q, k, k, valid_len)

    idx = meta(4, dtype=torch.int32)
    for x, w in (
            (meta(4, 8, 64), meta(3, 64, 32)),                 # operand
            (meta(4, 64), meta(3, 64, 32)),                    # rank
            (meta(4, 8, 64), meta(3, 64, 32, dtype=torch.float32)),  # operand
            (meta(4, 8, 64, dtype=torch.float16),
             meta(3, 64, 32, dtype=torch.float16)),            # dtype
            (meta(4, 8, 0), meta(3, 0, 32))):                  # empty
        with pytest.raises(ValueError):
            grouped_matmul(x, w, idx)
    assert _launches() == before
