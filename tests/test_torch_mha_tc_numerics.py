"""The arithmetic of the bf16 ``mha`` forward on tensor cores (``csrc/mha.cu``:
mha_fwd_tc_kernel), held on the CPU to the contracts that define it, and
the rule that routes a call to it.

A plain-torch emulation of the kernel's arithmetic: bf16 q and k with f32
scores, pre-scaled by ``D^-0.5 log2(e)``; an online softmax over key tiles
of 16 (a running max, exp2, the sum and the output accumulators rescaled
tile by tile), keys at and past ``valid_len`` read as zero rows with p = 0;
p split into three bf16 parts (hi, mid, lo), each part's product with V
in f32; the output rounded once. It is held

- against ``mha_reference`` under the chip check's per-element rule
  (chip_smoke.py ``compare_ulp``: |diff| <= 2^-7 |plain| + 1e-6);
- against the JAX package's ``mha`` (the Pallas kernel in interpret mode)
  under the same rule;

at S in {8, 16, 256}, with valid_len at S, below it and no multiple of the
key tile, and D in {16, 32, 64}. Keys past valid_len, poisoned, must not
change it. Two parts of p (``mha_flash``'s hi + lo, ~16 bits) miss the
per-element rule at the flagship's problem shape, where three meet it.

Inputs come from numpy seeds, at small B.
"""

import math
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_learn_tpu.ops.pallas import attention as pattn
from madrona_learn_tpu_torch.ops.cuda import KERNELS
from madrona_learn_tpu_torch.ops.cuda import mha as mha_mod
from madrona_learn_tpu_torch.ops.cuda.mha import (
    MHA,
    mha_fwd,
    mha_reference,
    uses_tensor_cores,
)

torch.set_num_threads(1)

BF16 = torch.bfloat16
F32 = torch.float32
KEYS_PER_TILE = 16
LOG2E = 1.4426950408889634


def _qkv(seed, B, S, H, D):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(B, S, H, D)).astype(np.float32))
            .to(BF16) for _ in range(3)]


def _bf16_parts(p, n):
    """p as n bf16 parts, each the rounded remainder of the ones before."""
    parts = []
    for _ in range(n):
        parts.append(p.to(BF16).float())
        p = p - parts[-1]
    return parts


def _split3(p):
    """The kernel's split: hi + mid + lo (~24 bits together)."""
    return _bf16_parts(p, 3)


def emulate_tc_mha(q, k, v, valid_len, split=_split3):
    """The tensor-core kernel's arithmetic: [B, S, H, D] bf16; ``split``
    gives p's bf16 parts."""
    D = q.shape[-1]
    qh, kh, vh = (x.float().permute(0, 2, 1, 3) for x in (q, k, v))
    B, H, S, _ = qh.shape
    m = torch.full((B, H, S, 1), -math.inf)
    l = torch.zeros(B, H, S, 1)
    acc = torch.zeros(B, H, S, D)
    for k0 in range(0, valid_len, KEYS_PER_TILE):
        keys = torch.arange(k0, k0 + KEYS_PER_TILE)
        valid = keys < valid_len
        idx = keys.clamp(max=S - 1)
        # Keys past valid_len read the zero chunk.
        kt = torch.where(valid[:, None], kh[:, :, idx], 0.0)
        vt = torch.where(valid[:, None], vh[:, :, idx], 0.0)
        s = (qh @ kt.transpose(-1, -2)) * (LOG2E / math.sqrt(D))
        s = torch.where(valid, s, -math.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha
        for part in split(p):
            acc = acc + part @ vt
        m = m_new
    return (acc / l).permute(0, 2, 1, 3).to(BF16)


def _within_ulp(got, want, what):
    """chip_smoke.py compare_ulp: |diff| <= 2^-7 |plain| + 1e-6 per
    element."""
    diff = (got.float() - want.float()).abs()
    worst = (diff / (want.float().abs() * 2 ** -7 + 1e-6)).max().item()
    assert worst <= 1.0, f"{what}: worst |diff| / (2^-7 |plain|) {worst:.3f}"


# (B, S, H, D, valid_len): the flagship's problem (S = 16, valid_len 12)
# and at valid_len = S; S = 8 (a half-filled 16-row query tile); S = 256
# over 13 key tiles (valid_len 200, the last tile partly masked) and at
# valid_len = S; S = 24 with valid_len 20; every head width.
CASES = [
    (6, 16, 4, 32, 12),
    (6, 16, 4, 32, 16),
    (6, 8, 4, 32, 6),
    (6, 8, 2, 16, 8),
    (2, 256, 2, 64, 200),
    (2, 256, 1, 16, 256),
    (4, 24, 2, 64, 20),
]


@pytest.mark.parametrize("B,S,H,D,valid_len", CASES)
def test_tc_mha_arithmetic_meets_the_plain_contract(B, S, H, D, valid_len):
    q, k, v = _qkv(200 + S + D + valid_len, B, S, H, D)
    _within_ulp(emulate_tc_mha(q, k, v, valid_len),
                mha_reference(q, k, v, valid_len), "tensor-core vs plain")


@pytest.mark.parametrize("B,S,H,D,valid_len", CASES[::2])
def test_tc_mha_arithmetic_matches_the_pallas_kernel(B, S, H, D, valid_len):
    q, k, v = _qkv(300 + S + D + valid_len, B, S, H, D)
    jq, jk, jv = (jnp.asarray(x.float().numpy(), jnp.bfloat16)
                  for x in (q, k, v))
    want = torch.from_numpy(np.asarray(
        pattn.mha(jq, jk, jv, valid_len=valid_len, interpret=True),
        np.float32))
    _within_ulp(emulate_tc_mha(q, k, v, valid_len), want,
                "tensor-core vs Pallas")


@pytest.mark.parametrize("poison", [1e4, math.inf, math.nan])
def test_tc_mha_keys_past_valid_len_have_no_effect(poison):
    """Keys and values at and past valid_len, poisoned, leave the output
    bitwise as it was: they are never read (a partial key tile reads
    zeros there, with p = 0)."""
    B, S, H, D, valid_len = 4, 24, 2, 32, 13
    q, k, v = _qkv(400, B, S, H, D)
    want = emulate_tc_mha(q, k, v, valid_len)
    k[:, valid_len:] = poison
    v[:, valid_len:] = -poison
    assert torch.equal(emulate_tc_mha(q, k, v, valid_len), want)


def test_tc_mha_three_parts_of_p_are_what_meet_the_rule():
    """At the flagship's problem shape (B = 1024: 2.1M outputs) three bf16
    parts of p meet the per-element rule; two (``mha_flash``'s hi + lo)
    and one miss it, where an output that nearly cancels shows their
    error: why the kernel takes three products per 16 keys."""
    B, S, H, D, valid_len = 1024, 16, 4, 32, 12
    q, k, v = _qkv(600, B, S, H, D)
    want = mha_reference(q, k, v, valid_len)
    _within_ulp(emulate_tc_mha(q, k, v, valid_len), want, "three parts")
    for n in (2, 1):
        with pytest.raises(AssertionError):
            _within_ulp(emulate_tc_mha(
                q, k, v, valid_len, split=lambda p: _bf16_parts(p, n)),
                want, f"{n} parts")


class _FakeLibrary:
    """Records which entry point a wrapper called, and with what."""

    def __init__(self):
        self.calls = []
        self.args = []

    def __getattr__(self, name):
        if not name.startswith("mlt_"):
            raise AttributeError(name)

        def call(*args):
            self.calls.append(name)
            self.args.append(args)
            return 0

        return call


@pytest.mark.parametrize("dtype,D,tensor_core", [
    (BF16, 32, True),      # the flagship's rollout step and update pass
    (BF16, 16, True),
    (BF16, 64, True),
    (F32, 32, False),      # float32 stays on CUDA cores
])
def test_mha_path_rule(monkeypatch, dtype, D, tensor_core):
    """The wrapper takes the route the rule names and counts a launch, and
    a tensor-core launch where it took that route, handing the tensor-core
    kernel D^-0.5 log2(e). The operands stand on the CPU here: the
    library, the operand check and the stream are stand-ins."""
    assert uses_tensor_cores(dtype) is tensor_core
    lib = _FakeLibrary()
    monkeypatch.setattr(mha_mod, "library", lambda: lib)
    monkeypatch.setattr(mha_mod, "_check_inputs",
                        lambda q, k, v, valid_len: tuple(q.shape))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    monkeypatch.setattr(MHA, "launches", 0)
    monkeypatch.setattr(MHA, "tc_launches", 0)
    B, S, H = 3, 16, 4
    qkv = [torch.zeros(B, S, H, D, dtype=dtype) for _ in range(3)]
    out = mha_fwd(*qkv, 12)
    assert out.shape == (B, S, H, D) and out.dtype == dtype
    assert (MHA.launches, MHA.tc_launches) == (1, int(tensor_core))
    (args,) = lib.args
    if tensor_core:
        assert lib.calls == ["mlt_mha_fwd_tc"]
        # D, q, k, v, out, B, S, H, valid_len, scale * log2(e), stream
        assert args[0] == D and args[5:9] == (B, S, H, 12)
        assert args[9] == pytest.approx(LOG2E / math.sqrt(D))
    else:
        assert lib.calls == ["mlt_mha_fwd"]


def test_mha_wrapper_refuses_bf16_no_kernel_takes():
    """bf16 tensors off the CPU go to the kernel wrapper, which raises on
    what no route takes instead of falling back."""
    before = {k.name: (k.launches, k.tc_launches) for k in KERNELS}

    def meta(*shape):
        return torch.empty(*shape, dtype=BF16, device="meta")

    for shape, valid_len in (((4, 16, 2, 32), 12),     # not on the card
                             ((4, 16, 2, 48), 12),     # D not instantiated
                             ((4, 12, 2, 32), 12),     # S no multiple of 8
                             ((4, 264, 2, 32), 12)):   # S past the route
        with pytest.raises(ValueError):
            mha_fwd(*[meta(*shape) for _ in range(3)], valid_len)
    assert {k.name: (k.launches, k.tc_launches) for k in KERNELS} == before
