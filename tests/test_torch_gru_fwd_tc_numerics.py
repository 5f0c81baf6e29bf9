"""The arithmetic of the bf16 GRU forward on tensor cores (``csrc/gru.cu``:
gru_fwd_tc_kernel), held on the CPU to the contracts that define it, and
the rule that routes a call to it.

A plain-torch emulation of the kernel's arithmetic: bf16 operands, f32
products summed one 64-deep slice at a time in the ring's K order (each
slice's products added in k order, element by element, so that a row's
result depends on nothing but its own inputs), x_n kept apart from
``h . W_hn + b_hn`` (linear before reset), gate math in f32, ys rounded to
bf16 and the carry cleared after a step whose keep is 0. It is held

- against ``gru_sequence_reference`` under the chip check's forward rule
  in bf16 (chip_smoke.py ``TOL[("gru_fwd", "bfloat16")]``: max |diff| <=
  3.2e-2);
- against the JAX package's ``gru_sequence`` (the Pallas forward kernel in
  interpret mode) under the same rule;
- to itself, bitwise: a T = 1 step from the cleared state equals step t of
  the T = 16 pass, and N = 70 equals N = 16 on the rows they share.

Inputs come from numpy seeds, at N <= 70 (ragged against the kernel's rows
a block), H = 128 and 256, T <= 16.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_learn_tpu.ops.pallas.gru import gru_sequence as jax_gru_seq
from madrona_learn_tpu_torch.ops.cuda import KERNELS
from madrona_learn_tpu_torch.ops.cuda import gru as gru_mod
from madrona_learn_tpu_torch.ops.cuda.gru import (
    GRU_FWD,
    gru_sequence_fwd,
    fwd_uses_tensor_cores,
    gru_sequence_reference,
)

torch.set_num_threads(1)

BF16 = torch.bfloat16
F32 = torch.float32
K_SLICE = 64        # depth of a weight slice in the kernel's ring
# The chip check's GRU forward rule in bf16 (chip_smoke.py TOL[("gru_fwd",
# "bfloat16")]): max |diff| <= 3.2e-2.
FWD_ATOL = 3.2e-2


def _inputs(seed, T, N, H):
    """bf16 operands (the distribution chip_smoke.py draws)."""
    rng = np.random.default_rng(seed)

    def bf(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(BF16)

    return dict(
        x_proj=bf(rng.normal(size=(T, N, 3 * H))),
        keep=bf(rng.random((T, N)) > 0.2),
        wh=bf(rng.normal(size=(H, 3 * H)) / np.sqrt(H)),
        bias_h=bf(rng.normal(size=(H,))),
        h0=bf(rng.normal(size=(N, H))))


def _slices(a, b):
    """a [N, K] . b [K, M] of bf16 (or f16) values in f32: one K_SLICE-deep
    slice at a time in K order, each slice's products summed in k order and
    then added to the running sum."""
    a, b = a.float(), b.float()
    acc = None
    for k0 in range(0, a.shape[1], K_SLICE):
        part = a[:, k0:k0 + 1] * b[k0]
        for k in range(k0 + 1, min(k0 + K_SLICE, a.shape[1])):
            part = part + a[:, k:k + 1] * b[k]
        acc = part if acc is None else acc + part
    return acc


def emulate_tc_fwd(x_proj, keep, wh, bias_h, h0, hps=None):
    """The tensor-core forward's arithmetic: ys [T, N, H] in the operands'
    element type (bf16; float16 at H = 128 / 256, the f16 ``wgmma``
    instance). The two-block cluster at H = 384 / 512 computes the same:
    each block sums its units' products over all H in the same slices.
    ``hps``, where given, is a list that receives each step's h . Wh [N, 3H]
    (f32), in step order."""
    H = wh.shape[0]
    dt = x_proj.dtype
    bn = bias_h.float()
    zero = torch.zeros((), dtype=dt)
    h = h0
    ys = []
    for t in range(x_proj.shape[0]):
        hp = _slices(h, wh)
        if hps is not None:
            hps.append(hp)
        xp = x_proj[t].float()
        hn_lin = hp[:, 2 * H:] + bn
        r = torch.sigmoid(xp[:, :H] + hp[:, :H])
        z = torch.sigmoid(xp[:, H:2 * H] + hp[:, H:2 * H])
        n = torch.tanh(xp[:, 2 * H:] + r * hn_lin)
        h_t = ((1.0 - z) * n + z * h.float()).to(dt)
        ys.append(h_t)
        h = torch.where(keep[t][:, None] > 0.5, h_t, zero)
    return torch.stack(ys)


def _jax_ys(args):
    def j(t):
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)

    ys = jax_gru_seq(j(args["x_proj"]), j(args["keep"]), j(args["wh"]),
                     j(args["bias_h"]), j(args["h0"]), True)
    return torch.from_numpy(np.asarray(ys, np.float32))


def _within(got, want, what):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= FWD_ATOL, f"{what}: max |diff| {err:.3e} above {FWD_ATOL}"


CASES = [(5, 70, 128), (4, 40, 256), (16, 33, 128)]


@pytest.mark.parametrize("T,N,H", CASES)
def test_tc_gru_fwd_arithmetic_meets_the_plain_contract(T, N, H):
    args = _inputs(110 + T + H, T, N, H)
    _within(emulate_tc_fwd(**args), gru_sequence_reference(**args),
            "ys vs plain")


@pytest.mark.parametrize("T,N,H", CASES[:2])
def test_tc_gru_fwd_arithmetic_matches_the_pallas_forward(T, N, H):
    args = _inputs(120 + T + H, T, N, H)
    _within(emulate_tc_fwd(**args), _jax_ys(args), "ys vs Pallas")


def test_tc_gru_fwd_step_equals_its_sequence_step():
    """A T = 1 call from the cleared state after step t - 1 gives bitwise
    step t of the T = 16 call: the rollout step and the update pass are one
    kernel, so PPO's ratio starts at exactly 1."""
    T, N, H = 16, 70, 128
    args = _inputs(130, T, N, H)
    ys = emulate_tc_fwd(**args)
    keep = args["keep"]
    zero = torch.zeros((), dtype=BF16)
    after_clear = next(t for t in range(1, T) if (keep[t - 1] < 0.5).any())
    for t in sorted({0, 1, after_clear, T // 2, T - 1}):
        h_in = args["h0"] if t == 0 else torch.where(
            keep[t - 1][:, None] > 0.5, ys[t - 1], zero)
        step = dict(args, x_proj=args["x_proj"][t:t + 1],
                    keep=keep[t:t + 1], h0=h_in)
        assert torch.equal(emulate_tc_fwd(**step)[0], ys[t]), t


@pytest.mark.parametrize("H", [128, 256])
def test_tc_gru_fwd_rows_do_not_depend_on_the_batch(H):
    """N = 70 (ragged against the kernel's rows a block) and N = 16 give
    bitwise the same ys on the rows they share."""
    T, N, rows = 4, 70, 16
    args = _inputs(140 + H, T, N, H)
    ys = emulate_tc_fwd(**args)
    sub = dict(args, x_proj=args["x_proj"][:, :rows],
               keep=args["keep"][:, :rows], h0=args["h0"][:rows])
    assert torch.equal(ys[:, :rows], emulate_tc_fwd(**sub))


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


def _stand_in_card(monkeypatch):
    """A stand-in library, operand check and stream for CPU operands."""
    lib = _FakeLibrary()
    monkeypatch.setattr(gru_mod, "library", lambda: lib)
    monkeypatch.setattr(gru_mod, "_check", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    monkeypatch.setattr(GRU_FWD, "launches", 0)
    monkeypatch.setattr(GRU_FWD, "tc_launches", 0)
    return lib


@pytest.mark.parametrize("dtype,H,tensor_core", [
    (BF16, 256, True),     # headline_gru's update minibatch and step
    (BF16, 128, True),
    (F32, 256, False),     # float32 stays on CUDA cores
    (F32, 128, False),
    (torch.float16, 256, True),    # float16's forward on f16 wgmma
])
def test_gru_fwd_path_rule(monkeypatch, dtype, H, tensor_core):
    """The forward wrapper takes the route the rule names and counts a
    launch, and a tensor-core launch where it took that route; the
    tensor-core route hands the kernel the dtype code, the weight's own
    storage (its TMA boxes are wgmma's MN-major A operand). The operands
    stand on the CPU here: the library, the operand check and the stream
    are stand-ins."""
    assert fwd_uses_tensor_cores(dtype, H) is tensor_core
    lib = _stand_in_card(monkeypatch)
    T, N = 2, 8
    wh = torch.zeros(H, 3 * H, dtype=dtype)
    ys = gru_sequence_fwd(torch.zeros(T, N, 3 * H, dtype=dtype),
                          torch.ones(T, N, dtype=dtype), wh,
                          torch.zeros(H, dtype=dtype),
                          torch.zeros(N, H, dtype=dtype))
    assert ys.shape == (T, N, H) and ys.dtype == dtype
    assert (GRU_FWD.launches, GRU_FWD.tc_launches) == (1, int(tensor_core))
    (args,) = lib.args
    if tensor_core:
        assert lib.calls == ["mlt_gru_fwd_tc"]
        # dtype, hidden, xp, keep, wh, ...
        code = {BF16: 1, torch.float16: 2}[dtype]
        assert args[:2] == (code, H)
        assert args[4] == wh.data_ptr()
    else:
        assert lib.calls == ["mlt_gru_fwd"]


def test_gru_fwd_wrapper_refuses_what_no_kernel_takes():
    """bf16 tensors off the CPU go to the forward kernel wrapper, which
    raises on what no route takes (meta tensors are never on the card)
    instead of falling back."""
    before = {k.name: (k.launches, k.tc_launches) for k in KERNELS}

    def meta(*shape):
        return torch.empty(*shape, dtype=BF16, device="meta")

    T, N = 2, 8
    for H in (256, 192):       # operand on no card; no kernel at H = 192
        with pytest.raises(ValueError):
            gru_sequence_fwd(meta(T, N, 3 * H), meta(T, N), meta(H, 3 * H),
                             meta(H), meta(N, H))
    assert {k.name: (k.launches, k.tc_launches) for k in KERNELS} == before
