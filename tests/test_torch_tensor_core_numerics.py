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
- ``mha_flash_bwd_dkdv`` and ``mha_flash_bwd_dq`` in bf16 (flash_bwd_dkdv_tc_kernel,
  flash_bwd_dq_tc_kernel): a plain-torch emulation of their arithmetic
  (64-query tiles for dK/dV, 64-key tiles for dQ, p by exp2 of pre-scaled
  scores minus lse log2(e), bf16-exact S and dP, p and dS split into bf16
  hi + lo with each half's product in f32, one rounding of each output)
  against ``mha_flash_bwd_reference`` from the same out and lse, under the
  chip check's rule (|diff| <= 2^-7 max |plain|). The per-element rule is
  met at flagship_large's problem shape but missed where a gradient
  cancels to near 0 (hi + lo keeps ~16 bits), so the chip check does not
  hold the backward to it; rounding p or dS to bf16 alone misses it by
  more.
- ``grouped_matmul``'s path rule, by dtype (bfloat16 and float16 alike),
  shape and alignment.
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
    mha_flash_bwd_reference,
    mha_flash_delta,
    mha_flash_fwd,
    mha_flash_reference,
)

torch.set_num_threads(1)

KEYS_PER_TILE = 64
QUERIES_PER_TILE = 64
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
# The chip check's lse tolerance (chip_smoke.py TOL["flash_lse"]).
LSE_TOL = dict(atol=1e-5, rtol=1e-5)
# The chip check's backward rule in bf16 (chip_smoke.py
# TOL[("flash_bwd", "bfloat16")]): max |diff| <= 2^-7 max |plain|.
BWD_RTOL = 2 ** -7


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


def _fma(a, b, c):
    """fmaf(a, b, c) on f32 tensors: the exact product plus c, rounded
    once (through float64)."""
    return (a.double() * b + c.double()).float()


def _split_product(x, b, split):
    """x . b in f32 from x as bf16 hi + lo (hi alone if not ``split``)."""
    hi = x.to(torch.bfloat16).float()
    if not split:
        return hi @ b
    return hi @ b + (x - hi).to(torch.bfloat16).float() @ b


def emulate_flash_bwd(q, k, v, out, lse, dout, valid_len, split_p=True,
                      split_ds=True):
    """The tensor-core backward's arithmetic in plain torch: dK/dV over
    tiles of 64 queries and dQ over tiles of 64 keys, f32 scores and dP of
    bf16 inputs, p = exp2(fma(s, D^-0.5 log2(e), -lse log2(e))), dS = p (dP
    - delta) D^-0.5 in f32, each of p and dS split into bf16 hi + lo as an
    operand of f32 products (hi alone if not ``split_p`` / ``split_ds``),
    every output rounded once; dK and dV of keys past valid_len are 0."""
    D, S = q.shape[-1], q.shape[1]
    scale = float(np.float32(D ** -0.5))
    scale_log2 = float(np.float32(D ** -0.5) * np.float32(LOG2E))
    qf, kf, vf, dof = (x.float().transpose(1, 2) for x in (q, k, v, dout))
    nl = -(lse * np.float32(LOG2E))                           # [B, H, S]
    delta = mha_flash_delta(out, dout).transpose(1, 2)        # [B, H, S]
    kv, vv = kf[:, :, :valid_len], vf[:, :, :valid_len]

    dk, dv = torch.zeros(kf.shape), torch.zeros(vf.shape)
    for i0 in range(0, S, QUERIES_PER_TILE):
        i1 = min(i0 + QUERIES_PER_TILE, S)
        qt, dot = qf[:, :, i0:i1], dof[:, :, i0:i1]
        p = torch.exp2(_fma(kv @ qt.transpose(-1, -2), scale_log2,
                            nl[:, :, None, i0:i1]))
        ds = p * (vv @ dot.transpose(-1, -2) -
                  delta[:, :, None, i0:i1]) * scale
        dv[:, :, :valid_len] += _split_product(p, dot, split_p)
        dk[:, :, :valid_len] += _split_product(ds, qt, split_ds)

    dq = torch.zeros(qf.shape)
    for j0 in range(0, valid_len, KEYS_PER_TILE):
        j1 = min(j0 + KEYS_PER_TILE, valid_len)
        kt, vt = kf[:, :, j0:j1], vf[:, :, j0:j1]
        p = torch.exp2(_fma(qf @ kt.transpose(-1, -2), scale_log2,
                            nl[..., None]))
        ds = p * (dof @ vt.transpose(-1, -2) - delta[..., None]) * scale
        dq += _split_product(ds, kt, split_ds)
    return tuple(x.to(torch.bfloat16).transpose(1, 2) for x in (dq, dk, dv))


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


def _bwd_case(seed, B, S, H, D, valid_len):
    """Inputs, the plain backward from the plain forward's out and lse, and
    what the emulation needs besides."""
    q, k, v = _inputs(seed, B, S, H, D)
    dout = _inputs(seed + 1, B, S, H, D)[0]
    out, lse = mha_flash_reference(q, k, v, valid_len)
    want = mha_flash_bwd_reference(q, k, v, out, lse, dout, valid_len)
    return (q, k, v, out, lse, dout, valid_len), want


@pytest.mark.parametrize("B,S,H,D,valid_len", [
    (2, 130, 2, 16, 97),    # S not a multiple of 64, valid_len mid-tile
    (2, 130, 2, 32, 97),
    (2, 130, 2, 64, 97),
    (2, 512, 4, 32, 511),   # flagship_large's problem shape
])
def test_tensor_core_flash_bwd_arithmetic_meets_the_plain_contract(
        B, S, H, D, valid_len):
    args, want = _bwd_case(B * S + D, B, S, H, D, valid_len)
    got = emulate_flash_bwd(*args)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape, name
        err = (g.float() - w.float()).abs().max().item()
        assert err <= BWD_RTOL * w.float().abs().max().item(), name
    # Keys past valid_len get exactly 0.
    assert not got[1][:, valid_len:].any() and not got[2][:, valid_len:].any()


def test_split_bwd_misses_the_per_element_rule_where_a_gradient_cancels():
    """At D = 64 a dK element near 0 (~6e-5) misses 2^-7 of itself plus
    1e-6: its terms reach ~1, and hi + lo carries each to ~2^-18 of
    itself, against 2^-24 in the plain version's f32."""
    args, want = _bwd_case(2 * 130 + 64, 2, 130, 2, 64, 97)
    _, dk, _ = emulate_flash_bwd(*args)
    assert _worst_ulp_ratio(dk, want[1]) > 1.2


@pytest.mark.parametrize("split_p,split_ds,broken", [
    (False, True, ("dv",)),         # p rounded to bf16 alone
    (True, False, ("dq", "dk")),    # dS rounded to bf16 alone
])
def test_p_or_ds_rounded_to_bf16_alone_breaks_the_bwd_contract(
        split_p, split_ds, broken):
    """At flagship_large's problem shape the split meets the per-element
    rule here; dV from p, and dK and dQ from dS, rounded once to bf16 miss
    gradients near 0 by several bf16 ulps: each needs its split."""
    args, want = _bwd_case(7, 2, 512, 4, 32, 511)
    got = dict(zip(("dq", "dk", "dv"), emulate_flash_bwd(
        *args, split_p=split_p, split_ds=split_ds)))
    for name, w in zip(("dq", "dk", "dv"), want):
        ratio = _worst_ulp_ratio(got[name], w)
        assert ratio > 2.0 if name in broken else ratio <= 1.0, (name, ratio)


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
    (torch.float16, 512, 2048, 0, 0, True),     # float16 like bf16
    (torch.float16, 70, 96, 0, 0, False),       # IN not a multiple of 8
    (torch.float16, 72, 136, 1, 0, False),      # x off a 16-byte boundary
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
