"""grouped_matmul in float16 on Hopper's tensor cores (``csrc/
grouped_matmul.cu``: grouped_matmul_tc_kernel<__half>), held on the CPU to
the contract its plain version defines, and the rule that routes a call to
it.

- The path rule: float16 x and weights with IN and OUT multiples of 8, on
  16-byte boundaries, take the tensor-core kernel; the IN = 2 first layer,
  a head of 5 outputs and an operand off a 16-byte boundary take the
  CUDA-core one.
- The wrapper on a stand-in card: the tensor-core route hands the kernel
  ``tensor_core = 1`` and dtype code 2 and counts a launch and a
  tensor-core launch; the CUDA-core route ``tensor_core = 0`` and no
  tensor-core launch.
- A plain-torch emulation of the kernel's arithmetic (float16 operands,
  exact in f32; f32 sums of 64-deep slices of IN added in K order; one
  rounding to float16; NaN rows for a chunk of index P) against
  ``grouped_matmul_reference`` under the chip check's rule (chip_smoke.py
  ``TOL[("gmm", "float16")]``: max |diff| <= 2^-10 max |plain|, one
  float16 rounding of f32 sums taken in another order) and against the
  JAX package's ``grouped_matmul`` (the Pallas kernel in interpret mode)
  on the chunks of a policy under the same rule; each chunk's rows bitwise
  the emulation over that chunk alone (no split over IN).

Inputs come from numpy seeds: B = 5 chunks of C = 70 rows, IN = 256, OUT =
72, P = 3 policies, one chunk of index P.
"""

import math
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_learn_tpu.ops.pallas.grouped_matmul import \
    grouped_matmul as jax_grouped_matmul
from madrona_learn_tpu_torch.ops.cuda import grouped_matmul as gmm_mod
from madrona_learn_tpu_torch.ops.cuda.grouped_matmul import (
    GROUPED_MATMUL,
    grouped_matmul_reference,
    uses_tensor_cores,
)

torch.set_num_threads(1)

F16 = torch.float16
K_SLICE = 64        # depth of a slice in the kernel's TMA ring
# The chip check's rule (chip_smoke.py TOL[("gmm", "float16")]).
RTOL = 2 ** -10
B, C, IN, OUT, P = 5, 70, 256, 72, 3
ORDER = [2, 0, P, 1, 2]     # chunk 2 of index P: NaN rows


def _aligned_at(shape, dtype, shift):
    """A contiguous tensor whose first element lies ``shift`` elements past
    a 16-byte boundary."""
    n = math.prod(shape)
    buf = torch.zeros(n + 16, dtype=dtype)
    start = (-buf.data_ptr() // buf.element_size()) % (
        16 // buf.element_size()) + shift
    return buf[start:start + n].view(shape)


@pytest.mark.parametrize("IN_,OUT_,x_shift,w_shift,tensor_core", [
    (256, 256, 0, 0, True),     # headline_pbt_fp16's hidden layer
    (256, 1024, 0, 0, True),    # its LSTM's input projection
    (512, 2048, 0, 0, True),
    (72, 136, 0, 0, True),      # ragged, but 16-byte rows
    (2, 256, 0, 0, False),      # the first layer, IN = 2
    (256, 5, 0, 0, False),      # the actor's head, OUT = 5
    (256, 1, 0, 0, False),      # the critic's head
    (72, 136, 1, 0, False),     # x off a 16-byte boundary
    (72, 136, 0, 4, False),     # the weights off one
])
def test_float16_path_rule(IN_, OUT_, x_shift, w_shift, tensor_core):
    x = _aligned_at((2, 3, IN_), F16, x_shift)
    w = _aligned_at((2, IN_, OUT_), F16, w_shift)
    assert uses_tensor_cores(x, w) is tensor_core


class _Library:
    """Records each entry point's name and arguments, and returns 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.mark.parametrize("IN_,OUT_,tensor_core", [
    (256, 1024, True), (256, 5, False), (2, 256, False)])
def test_float16_wrapper_route_and_counts(monkeypatch, IN_, OUT_,
                                          tensor_core):
    """The card path of the wrapper (``_launch``) on CPU operands standing
    in for the card's: the library, the operand check and the stream are
    stand-ins."""
    lib = _Library()
    monkeypatch.setattr(gmm_mod, "library", lambda: lib)
    monkeypatch.setattr(gmm_mod, "check_operand", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    monkeypatch.setattr(GROUPED_MATMUL, "launches", 0)
    monkeypatch.setattr(GROUPED_MATMUL, "tc_launches", 0)
    x = _aligned_at((4, 8, IN_), F16, 0)
    w = _aligned_at((3, IN_, OUT_), F16, 0)
    idx = torch.tensor([0, 2, 1, 0], dtype=torch.int32)
    y = gmm_mod._launch(x, w, idx)
    assert y.shape == (4, 8, OUT_) and y.dtype == F16
    ((name, args),) = lib.calls
    assert name == "mlt_grouped_matmul"
    # (dtype, tensor_core, x, w, chunk_policy, y, B, C, IN, P, OUT, stream)
    assert args[:4] == (2, int(tensor_core), x.data_ptr(), w.data_ptr())
    assert args[6:11] == (4, 8, IN_, 3, OUT_)
    assert (GROUPED_MATMUL.launches, GROUPED_MATMUL.tc_launches) == (
        1, int(tensor_core))


def emulate_tc(x, w, idx):
    """The tensor-core kernel's arithmetic: y [B, C, OUT] float16."""
    n_pol = w.shape[0]
    y = torch.empty(x.shape[0], x.shape[1], w.shape[2], dtype=F16)
    for b, p in enumerate(idx.tolist()):
        if not 0 <= p < n_pol:
            y[b] = float("nan")
            continue
        xb, wp = x[b].float(), w[p].float()
        acc = None
        for k0 in range(0, xb.shape[1], K_SLICE):
            part = xb[:, k0:k0 + K_SLICE] @ wp[k0:k0 + K_SLICE]
            acc = part if acc is None else acc + part
        y[b] = acc.to(F16)
    return y


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(B, C, IN)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(P, IN, OUT)) * IN ** -0.5)
                         .astype(np.float32))
    return x.to(F16), w.to(F16), torch.tensor(ORDER, dtype=torch.int32)


def _within(got, want, what):
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    assert math.isfinite(err) and err <= RTOL * scale, (
        f"{what}: max |diff| {err:.3e} above 2^-10 of {scale:.3e}")


def test_float16_tc_arithmetic_meets_the_plain_contract():
    x, w, idx = _inputs(26)
    got = emulate_tc(x, w, idx)
    want = grouped_matmul_reference(x, w, idx)
    bad = torch.tensor([p == P for p in ORDER])
    assert got[bad].isnan().all() and want[bad].isnan().all()
    _within(got[~bad], want[~bad], "emulation vs plain")


def test_float16_tc_arithmetic_matches_the_pallas_kernel():
    x, w, idx = _inputs(27)
    got = emulate_tc(x, w, idx)
    valid = [i for i, p in enumerate(ORDER) if p < P]
    want = jax_grouped_matmul(jnp.asarray(x[valid].numpy()),
                              jnp.asarray(w.numpy()),
                              jnp.asarray(idx[valid].numpy()), True)
    assert want.dtype == jnp.float16
    _within(got[valid], torch.from_numpy(np.asarray(want, np.float32)),
            "emulation vs Pallas")


def test_float16_tc_chunk_rows_do_not_depend_on_the_others():
    """No split over IN: a chunk's rows are the same alone as among the
    others, so each policy's rows are one single-policy launch's."""
    x, w, idx = _inputs(28)
    y = emulate_tc(x, w, idx)
    for b, p in enumerate(ORDER):
        if p == P:
            continue
        alone = emulate_tc(x[b:b + 1], w[p:p + 1],
                           torch.zeros(1, dtype=torch.int32))
        assert torch.equal(alone[0], y[b])
