"""The schedule of the gae kernel (``csrc/gae.cu``), held on the CPU to the
contracts that define it, and its wrapper against a stand-in library.

A plain-torch emulation of the kernel's schedule: agent columns in blocks
of ``columns``; time in chunks of ``chunk`` steps from the end (the first
chunk in time may be partial), each chunk's rewards, values and dones
copied into a staged tile with zeros before t = 0; each column's
recurrence run t = T-1 .. 0 from the tiles with the kernel's sequence of
roundings (select where done, then a separately rounded multiply and add
for each term). It is held

- bitwise to ``gae_reference``, the plain version the card's check holds
  the kernel to bitwise;
- to the JAX package's ``gae_pallas`` in interpret mode within the 1e-6 of
  ``tests/test_torch_kernels.py``, taken as the chip check's rule does
  (max |diff| <= 1e-6 + 1e-6 max |pallas|): the TPU kernel multiplies by
  notdones where the plain version selects, and XLA may fuse a
  multiply-add, so over T = 100 steps an advantage near 0 can differ by a
  little more than 1e-6 of itself;
- to itself, bitwise, at every pair of chunk and block widths the kernel
  is built for.

Inputs come from numpy seeds, at T in {1, 7, 32, 33, 100} and N in {1, 70,
600}, so that T crosses chunk edges and N crosses block edges.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_learn_tpu.ops.pallas.gae import gae_pallas
from madrona_learn_tpu_torch.ops.cuda import build
from madrona_learn_tpu_torch.ops.cuda import gae as gae_mod
from madrona_learn_tpu_torch.ops.cuda.gae import (
    CHUNK,
    CHUNKS,
    COLUMNS,
    COLUMNS_CHOICES,
    GAE,
    gae_cuda,
    gae_reference,
)

torch.set_num_threads(1)

GAMMA, LAM = 0.99, 0.95


def _inputs(seed, T, N):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.normal(size=(T, N)).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(T, N)).astype(np.float32)),
            torch.from_numpy(rng.random((T, N)) < 0.1),
            torch.from_numpy(rng.normal(size=(N,)).astype(np.float32)))


def emulate_gae(rewards, values, dones, bootstrap, chunk, columns):
    """The kernel's schedule: one block a ``columns`` slice of agents, its
    tiles staged ``chunk`` steps at a time from the end."""
    T, N = rewards.shape
    gamma = torch.tensor(GAMMA, dtype=torch.float32)
    gamma_lambda = torch.tensor(GAMMA * LAM, dtype=torch.float32)
    out = torch.full((T, N), float("nan"))
    for n0 in range(0, N, columns):
        cols = slice(n0, min(n0 + columns, N))
        width = cols.stop - n0
        next_adv = torch.zeros(width)
        next_val = bootstrap[cols].clone()
        for k in range(-(-T // chunk)):
            t0 = T - (k + 1) * chunk
            r_tile = torch.zeros(chunk, width)
            v_tile = torch.zeros(chunk, width)
            d_tile = torch.zeros(chunk, width, dtype=torch.bool)
            first = max(t0, 0)
            for tile, src in ((r_tile, rewards), (v_tile, values),
                              (d_tile, dones)):
                tile[first - t0:] = src[first:t0 + chunk, cols]
            for row in range(chunk - 1, -1, -1):
                if t0 + row < 0:
                    continue
                done = d_tile[row]
                nv = torch.where(done, 0.0, next_val)
                na = torch.where(done, 0.0, next_adv)
                td = (r_tile[row] + gamma * nv) - v_tile[row]
                adv = td + gamma_lambda * na
                out[t0 + row, cols] = adv
                next_adv, next_val = adv, v_tile[row]
    return out


@pytest.mark.parametrize("N", [1, 70, 600])
@pytest.mark.parametrize("T", [1, 7, 32, 33, 100])
def test_emulated_schedule_matches_plain_and_pallas(T, N):
    """The wrapper's pair: bitwise the plain version, and the Pallas kernel
    within 1e-6."""
    args = _inputs(T * 1000 + N, T, N)
    got = emulate_gae(*args, CHUNK, COLUMNS)
    assert torch.equal(got, gae_reference(GAMMA, LAM, *args))
    want = np.asarray(gae_pallas(
        GAMMA, LAM, *(jnp.asarray(a.numpy()) for a in args), interpret=True))
    assert np.abs(got.numpy() - want).max() <= 1e-6 + 1e-6 * np.abs(
        want).max()


@pytest.mark.parametrize("T,N", [(33, 70), (100, 600)])
def test_every_built_pair_gives_the_same_advantages(T, N):
    """The sweep's variants of chip_smoke.py: chunk and block widths change
    the schedule, not a single rounding."""
    args = _inputs(7 + T + N, T, N)
    want = emulate_gae(*args, CHUNK, COLUMNS)
    for chunk in CHUNKS:
        for columns in COLUMNS_CHOICES:
            assert torch.equal(emulate_gae(*args, chunk, columns), want), (
                chunk, columns)


class _FakeLibrary:
    """Records the gae entry point's arguments."""

    def __init__(self):
        self.args = []

    def mlt_gae(self, *args):
        self.args.append(args)
        return 0


def _as_card(x):
    """x as the operand check sees a CUDA tensor: its dtype, shape and
    contiguity, on the card."""
    return types.SimpleNamespace(device=types.SimpleNamespace(type="cuda"),
                                 dtype=x.dtype, shape=x.shape,
                                 is_contiguous=x.is_contiguous)


@pytest.fixture
def stand_in_card(monkeypatch):
    """A stand-in library and stream, and the real operand check applied to
    CPU operands as if they lay on the card."""
    lib = _FakeLibrary()
    monkeypatch.setattr(gae_mod, "library", lambda: lib)
    monkeypatch.setattr(
        gae_mod, "check_operand",
        lambda kernel, name, x, dtype, shape: build.check_operand(
            kernel, name, _as_card(x), dtype, shape))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    monkeypatch.setattr(GAE, "launches", 0)
    return lib


@pytest.mark.parametrize("pair", [None, (8, 128), (16, 64)])
def test_wrapper_hands_the_kernel_its_chunk_and_block(stand_in_card, pair):
    """T, N, gamma, gamma * lambda, the steps a chunk and the columns a
    block reach the entry point; each call counts one launch."""
    T, N = 33, 70
    args = _inputs(3, T, N)
    kwargs = {} if pair is None else dict(chunk=pair[0], columns=pair[1])
    out = gae_cuda(GAMMA, LAM, *args, **kwargs)
    gae_cuda(GAMMA, LAM, *args, **kwargs)
    assert out.shape == (T, N) and out.dtype == torch.float32
    assert GAE.launches == 2
    call = stand_in_card.args[0]
    assert call[5:7] == (T, N)
    assert call[7] == pytest.approx(GAMMA)
    assert call[8] == pytest.approx(GAMMA * LAM)
    assert call[9:11] == (pair or (CHUNK, COLUMNS))
    assert call[2] == args[2].data_ptr()  # dones as the bool tensor's bytes


def _refused_cases():
    r, v, d, b = _inputs(4, 6, 40)
    return {
        "float64 rewards": (r.double(), v, d, b),
        "float dones": (r, v, d.float(), b),
        "non-contiguous values": (r, v.t().contiguous().t(), d, b),
        "bootstrap of another width": (r, v, d, b[:39]),
        "T = 0": (r[:0], v[:0], d[:0], b),
    }


@pytest.mark.parametrize("case", sorted(_refused_cases()))
def test_wrapper_refuses_what_the_kernel_cannot_take(stand_in_card, case):
    with pytest.raises(ValueError):
        gae_cuda(GAMMA, LAM, *_refused_cases()[case])
    assert GAE.launches == 0 and stand_in_card.args == []


def test_wrapper_refuses_a_pair_that_is_not_built(stand_in_card):
    with pytest.raises(ValueError, match="no kernel built"):
        gae_cuda(GAMMA, LAM, *_inputs(5, 4, 8), chunk=12)
    assert GAE.launches == 0 and stand_in_card.args == []
