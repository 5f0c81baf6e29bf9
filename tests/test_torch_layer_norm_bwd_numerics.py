"""The arithmetic of the layer_norm backward kernel (``csrc/layer_norm.cu``:
layer_norm_bwd_kernel and layer_norm_wgrad_kernel), held on the CPU to the
contracts that define it, and its wrapper against a stand-in library.

A plain-torch emulation of the kernel's arithmetic:

- dx: xhat = (x - mu) rsigma and wdy = w dy in f32; the row sums of
  xhat wdy and wdy as a warp takes them (lane l holds the 16-byte pieces
  j of a row, columns (32 j + l) V .. + V - 1 with V = 16 / itemsize, and
  sums its columns in that order; the warp's xor butterfly adds the
  lanes); c1 and c2 those sums over D; dx = (wdy - c2 - xhat c1) rsigma
  rounded once to x's dtype;
- dw / db: rows in partials of ``BWD_PART_ROWS``; in a partial, warp w
  sums rows w, w + 8, ... in order and the block adds its warps in order;
  the reduction launch's group g sums partials g, g + 32, ... in order and
  a fixed tree adds the 32 groups.

It is held against ``layer_norm_reference`` autograd and against the JAX
package's ``layer_norm`` VJP (its Pallas backward in interpret mode) under
the chip check's rule (chip_smoke.py ``TOL``: max |diff| <= atol + rtol
max |want|; dx to 2^-7 in bf16 and 1e-5 in f32, dw / db to rtol 1e-4), at
N in {1, 300, 1000} and D in {48, 128, 256} in f32 and bf16. The kernel's
own sums may contract a multiply and an add into an FMA, so the emulation
stands for its order, not its last bits.

dw / db are a function of the inputs alone: the wrapper hands the kernel
the same partials on a card of any SM count, where the parent kernel's
partition (8 blocks an SM) changed them.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import madrona_learn_tpu.ops.pallas.layer_norm as jax_ln
from madrona_learn_tpu_torch.ops.cuda import build
from madrona_learn_tpu_torch.ops.cuda import layer_norm as ln_mod
from madrona_learn_tpu_torch.ops.cuda.layer_norm import (
    BWD_PART_ROWS,
    LAYER_NORM_BWD,
    bwd_partials,
    layer_norm_bwd,
    layer_norm_reference,
)

torch.set_num_threads(1)

BF16, F32 = torch.bfloat16, torch.float32
DTYPES = {"float32": (jnp.float32, F32), "bfloat16": (jnp.bfloat16, BF16)}
WARPS = 8          # warps a block of the main pass (kBwdWarps)
RED_GROUPS = 32    # partial strides a block of the reduction (kRedGroups)
EPS = 1e-6
# chip_smoke.py TOL[("ln_bwd", dtype)] for dx and TOL["ln_dwdb"].
DX_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (0.0, 2.0 ** -7)}
DWDB_TOL = (0.0, 1e-4)


def _inputs(seed, N, D, tdt):
    """x, w, b, dy as chip_smoke.py draws them, from numpy; mu and rsigma
    from the forward's two-pass math in f32."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((2 * rng.normal(size=(N, D)) + 0.5)
                         .astype(np.float32)).to(tdt)
    w = torch.from_numpy((1 + 0.1 * rng.normal(size=D)).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.normal(size=D)).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(N, D)).astype(np.float32)).to(tdt)
    x32 = x.float()
    mu = x32.mean(dim=1)
    var = (x32 - mu[:, None]).square().mean(dim=1)
    return x, w, b, dy, mu, torch.rsqrt(var + EPS)


def _row_sums(a, vec):
    """Row sums of [N, D] f32 in a warp's order: each lane over its pieces'
    columns in order, then the xor butterfly (lane 0's order: lanes l and
    l + 16, then l and l + 8, ...)."""
    N, D = a.shape
    pieces = -(-D // (32 * vec))
    padded = torch.zeros(N, pieces * 32 * vec)
    padded[:, :D] = a
    lanes = (padded.reshape(N, pieces, 32, vec).permute(0, 2, 1, 3)
             .reshape(N, 32, pieces * vec))
    s = torch.zeros(N, 32)
    for i in range(pieces * vec):
        s = s + lanes[:, :, i]
    while s.shape[1] > 1:
        half = s.shape[1] // 2
        s = s[:, :half] + s[:, half:]
    return s[:, 0]


def _column_sums(a, part_rows, groups):
    """Column sums of [N, D] f32 as the two launches take them: partials of
    ``part_rows`` rows (warp w: rows w, w + WARPS, ... in order, then the
    warps in order), then ``groups`` strided sums of the partials and a
    tree over the groups (groups = 1: the partials in order)."""
    N, D = a.shape
    part_rows = -(-part_rows // WARPS) * WARPS
    P = -(-N // part_rows)
    rows = torch.zeros(P * part_rows, D)
    rows[:N] = a
    by_warp = rows.reshape(P, part_rows // WARPS, WARPS, D)
    warp_sums = torch.zeros(P, WARPS, D)
    for i in range(part_rows // WARPS):
        warp_sums = warp_sums + by_warp[:, i]
    part = torch.zeros(P, D)
    for w in range(WARPS):
        part = part + warp_sums[:, w]
    strided = torch.zeros(-(-P // groups) * groups, D)
    strided[:P] = part
    strided = strided.reshape(-1, groups, D)
    g = torch.zeros(groups, D)
    for q in range(strided.shape[0]):
        g = g + strided[q]
    while g.shape[0] > 1:
        half = g.shape[0] // 2
        g = g[:half] + g[half:]
    return g[0]


def emulate_ln_bwd(x, w, mu, rsigma, dy, part_rows=BWD_PART_ROWS,
                   groups=RED_GROUPS):
    """(dx, dw, db) as the kernel computes them."""
    vec = 16 // x.element_size()
    x32, g = x.float(), dy.float()
    xhat = (x32 - mu[:, None]) * rsigma[:, None]
    wdy = w * g
    D = x.shape[1]
    c1 = _row_sums(xhat * wdy, vec) / D
    c2 = _row_sums(wdy, vec) / D
    dx = ((wdy - c2[:, None] - xhat * c1[:, None])
          * rsigma[:, None]).to(x.dtype)
    return (dx, _column_sums(g * xhat, part_rows, groups),
            _column_sums(g, part_rows, groups))


def _within(name, got, want, atol, rtol):
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    assert err <= atol + rtol * scale, (name, err, scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [48, 128, 256])
@pytest.mark.parametrize("N", [1, 300, 1000])
def test_emulated_bwd_matches_plain_and_pallas(N, D, dtype):
    jdt, tdt = DTYPES[dtype]
    x, w, b, dy, mu, rsigma = _inputs(N * 7 + D, N, D, tdt)
    got = emulate_ln_bwd(x, w, mu, rsigma, dy)
    assert got[0].dtype == tdt

    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    out = layer_norm_reference(*leaves, EPS)
    plain = torch.autograd.grad((out.float() * dy.float()).sum(), leaves)

    xj = jnp.asarray(x.float().numpy(), jdt)
    _, vjp = jax.vjp(
        lambda x_, w_, b_: jax_ln.layer_norm(x_, w_, b_, EPS, True), xj,
        jnp.asarray(w.numpy()), jnp.asarray(b.numpy()))
    pallas = [torch.from_numpy(np.array(g.astype(jnp.float32)))
              for g in vjp(jnp.asarray(dy.float().numpy(), jdt))]

    for want_name, want in (("plain", plain), ("pallas", pallas)):
        _within(f"dx against {want_name}", got[0], want[0], *DX_TOL[dtype])
        for name, g, wv in zip(("dw", "db"), got[1:], want[1:]):
            _within(f"{name} against {want_name}", g, wv, *DWDB_TOL)


def test_emulated_row_sums_are_the_layout_not_the_width():
    """A bf16 row of 256 is one piece a lane, f32 two: the lane layout
    changes the order of the row sums, which stay sums of the same
    terms."""
    a = torch.from_numpy(np.random.default_rng(3).normal(size=(5, 256))
                         .astype(np.float32))
    exact = a.double().sum(dim=1)
    for vec in (4, 8):
        np.testing.assert_allclose(_row_sums(a, vec).double().numpy(),
                                   exact.numpy(), rtol=1e-5, atol=1e-5)


class _FakeLibrary:
    """Records the backward entry point's arguments."""

    def __init__(self):
        self.args = []

    def mlt_layer_norm_bwd(self, *args):
        self.args.append(args)
        return 0


def _as_card(x):
    """x as the operand check sees a CUDA tensor of its dtype, shape and
    contiguity."""
    return types.SimpleNamespace(device=types.SimpleNamespace(type="cuda"),
                                 dtype=x.dtype, shape=x.shape,
                                 is_contiguous=x.is_contiguous)


@pytest.fixture
def stand_in_card(monkeypatch):
    """A stand-in library and stream, and the real operand check applied to
    CPU operands as if they lay on the card."""
    lib = _FakeLibrary()
    monkeypatch.setattr(ln_mod, "library", lambda: lib)
    monkeypatch.setattr(
        ln_mod, "_check", lambda name, x, dtype, shape: build.check_operand(
            "layer_norm kernel", name, _as_card(x), dtype, shape))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    monkeypatch.setattr(LAYER_NORM_BWD, "launches", 0)
    return lib


@pytest.mark.parametrize("N,D,dtype", [(131072, 256, BF16), (1000, 256, BF16),
                                       (300, 100, BF16), (1, 48, F32)])
def test_wrapper_hands_the_kernel_fixed_partials(stand_in_card, N, D, dtype):
    """Scratch [2, ceil(N / 128), D] f32 and its row count, both launches
    (phases 3), and one launch counted a call."""
    x = torch.zeros(N, D, dtype=dtype)
    stat = torch.zeros(N)
    dx, dw, db = layer_norm_bwd(x, torch.ones(D), stat, stat, x)
    assert LAYER_NORM_BWD.launches == 1
    assert dx.shape == (N, D) and dx.dtype == dtype
    assert dw.shape == db.shape == (D,) and dw.dtype == db.dtype == F32
    (args,) = stand_in_card.args
    partials = -(-N // BWD_PART_ROWS)
    assert args[0:2] == (1 if dtype == BF16 else 0, D)
    assert args[11:14] == (N, partials, 3)
    assert args[7] == dx.data_ptr()
    assert args[9:11] == (dw.data_ptr(), db.data_ptr())


def test_dw_db_do_not_depend_on_the_sm_count(stand_in_card, monkeypatch):
    """The wrapper hands the kernel the same partials on cards of 66, 114
    and 132 SMs, so the emulated dw / db are bitwise equal whatever count
    is given; the parent's partition, 8 blocks an SM, gave other sums on
    each card."""
    N, D = 20000, 64
    x, w, _, dy, mu, rsigma = _inputs(11, N, D, BF16)
    handed, old = [], []
    for sms in (66, 114, 132):
        monkeypatch.setattr(
            torch.cuda, "get_device_properties",
            lambda device=None, sms=sms: types.SimpleNamespace(
                multi_processor_count=sms))
        stand_in_card.args.clear()
        layer_norm_bwd(x, w, mu, rsigma, dy)
        partials = stand_in_card.args[0][12]
        assert partials == bwd_partials(N)
        handed.append(emulate_ln_bwd(x, w, mu, rsigma, dy,
                                     part_rows=-(-N // partials))[1:])
        blocks = max(1, min(8 * sms, -(-N // 8)))
        old.append(emulate_ln_bwd(x, w, mu, rsigma, dy,
                                  part_rows=-(-N // blocks), groups=1)[1:])
    for dw_db in handed[1:]:
        assert all(torch.equal(a, b) for a, b in zip(dw_db, handed[0]))
    assert not torch.equal(old[0][0], old[2][0])


def _refused_cases():
    N, D = 8, 64
    x = torch.zeros(N, D, dtype=BF16)
    w, stat = torch.ones(D), torch.zeros(N)
    return {
        "float32 dy with bf16 x": (x, w, stat, stat, x.float()),
        "non-contiguous x": (x.t().contiguous().t(), w, stat, stat, x),
        "float64 mu": (x, w, stat.double(), stat, x),
        "rsigma of another length": (x, w, stat, stat[:7], x),
        "D past 1024": (torch.zeros(N, 1032, dtype=BF16), torch.ones(1032),
                        stat, stat, torch.zeros(N, 1032, dtype=BF16)),
        "N = 0": (x[:0], w, stat[:0], stat[:0], x[:0]),
    }


@pytest.mark.parametrize("case", sorted(_refused_cases()))
def test_wrapper_refuses_what_the_kernel_cannot_take(stand_in_card, case):
    with pytest.raises(ValueError):
        layer_norm_bwd(*_refused_cases()[case])
    assert LAYER_NORM_BWD.launches == 0 and stand_in_card.args == []
