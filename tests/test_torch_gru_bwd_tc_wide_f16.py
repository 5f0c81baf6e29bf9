"""The GRU backward on tensor cores at H = 384 / 512 in a two-block cluster
(``csrc/gru.cu``: gru_bwd_tc_kernel with kSplit = 2), in bf16 and
float16, with the float16 forward there (gru_fwd_tc_kernel's ``__half``
cluster instance), held on the CPU to the contracts that define them, and
the rules that route a call to them.

Each block of a cluster owns H / 2 units of the same rows: it recomputes
h_in . Wh for its units through the forward's helper in the forward
cluster's slice order, writes its units' dhp into both blocks' dhp tiles
and computes dh_prev of its units over all 3H gate columns.
``test_torch_gru_tc_numerics.emulate_tc_bwd`` follows it rank by rank.
Held here:

- bf16 against ``gru_sequence_reference``'s autograd and JAX's Pallas
  ``gru_sequence`` VJP in interpret mode under the chip check's bf16 rule
  (``TOL[("gru_bwd", "bfloat16")]``: 3.2e-2 of the largest value);
- the emulation's recomputed h_in . Wh, rank by rank, bitwise the
  forward's emulation (``test_torch_gru_fwd_tc_numerics.emulate_tc_fwd``),
  in bf16 and float16. This holds by construction (the emulation's
  columns are independent sums); that the kernels' ``wgmma`` sums agree,
  the backward's K-major Wh^T boxes against the forward's MN-major Wh
  boxes, is held on the card (chip_smoke.py ``_gru_product_witness``,
  through the entry points' ``hp`` witness, whose wiring is held here);
- the chunk-indexed form's rows, and each policy's dWh / dbh where 64
  divides the chunk, bitwise the single-policy emulation's; a chunk of no
  policy NaN and in no policy's gradient;
- float16 (the port's own: JAX sends float16 to its jnp twin), forward and
  backward, against the plain twin and JAX's float16
  ``gru_sequence_reference`` (``jax.vjp`` for the backward) under the chip
  check's float16 rules (2^-8, of the largest value for the backward);
- the backward wrappers' routes on a stand-in library: bf16 and float16
  at 384 / 512 on the tensor-core entry points (no witness), float32 on
  the CUDA-core ones.

All at T <= 4 and N <= 70 (ragged against the row tiles).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_learn_tpu.ops.pallas.gru import (
    gru_sequence_reference as jax_gru_reference,
)
from madrona_learn_tpu_torch.ops.cuda import gru as gru_mod
from madrona_learn_tpu_torch.ops.cuda.gru import (
    GRU_BWD,
    GRU_BWD_CHUNKED,
    bwd_uses_tensor_cores,
    gru_sequence_bwd,
    gru_sequence_bwd_chunked,
    gru_sequence_chunked_reference,
    gru_sequence_reference,
    tc_rows,
)
from madrona_learn_tpu_torch.ops.cuda.lstm import _num_splits_tc
from test_torch_gru_fwd_tc_numerics import emulate_tc_fwd
from test_torch_gru_tc_numerics import (
    H100_SMS,
    M_SLICE,
    _emulated,
    _inputs,
    _jax_grads,
    _plain_grads,
    emulate_tc_bwd,
)

torch.set_num_threads(1)

BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32
NAMES = ("dxp", "dwh", "dbh", "dh0")
# The chip check's GRU rules (chip_smoke.py TOL[("gru_bwd", dtype)]: max
# |diff| <= rtol * max |want|, tensor by tensor; TOL[("gru_fwd",
# "float16")]: max |diff| <= 2^-8).
RTOL = {BF16: 3.2e-2, F16: 2 ** -8}
FWD_ATOL = 2 ** -8
WIDE = [(3, 40, 384), (2, 40, 512)]


def _check(got, want, rtol, what):
    for name, g, w in zip(NAMES, got, want):
        err = (g.float() - w.float()).abs().max().item()
        scale = w.float().abs().max().item()
        assert err <= rtol * scale, (
            f"{what} {name}: max |diff| {err:.3e} above {rtol} x max |want| "
            f"{scale:.3e}")


# -- bf16: the cluster backward against its contracts -------------------------

@pytest.mark.parametrize("T,N,H", WIDE)
def test_wide_gru_bwd_arithmetic_meets_the_plain_contract(T, N, H):
    args, probe = _inputs(600 + H, T, N, H)
    got = _emulated(args, probe)
    assert all(g.dtype == BF16 for g in got)
    _check(got, _plain_grads(args, probe), RTOL[BF16], "vs plain")


@pytest.mark.parametrize("T,N,H", WIDE)
def test_wide_gru_bwd_arithmetic_matches_the_pallas_backward(T, N, H):
    args, probe = _inputs(610 + H, T, N, H)
    _check(_emulated(args, probe), _jax_grads(args, probe), RTOL[BF16],
           "vs Pallas")


@pytest.mark.parametrize("dtype", [BF16, F16])
@pytest.mark.parametrize("H", [384, 512])
def test_wide_gru_bwd_recomputes_the_forwards_products(H, dtype):
    """The emulated cluster backward recomputes through the forward's
    helper, each rank its units' columns over all H: every step's
    recomputed h_in . Wh bitwise the emulated forward's product from the
    same carry. The emulation sums each column on its own, so this holds
    for any split of the columns; the kernels' sums are held against each
    other on the card (chip_smoke.py ``_gru_product_witness``)."""
    T, N = 3, 40
    args, probe = _inputs(620 + H, T, N, H, dtype=dtype)
    fwd_hps = []
    ys = emulate_tc_fwd(**args, hps=fwd_hps)
    bwd_hps = []
    got = emulate_tc_bwd(**args, ys=ys, dys=probe, hps=bwd_hps)
    assert got[0].dtype == dtype and len(bwd_hps) == T
    for t in range(T):
        assert torch.equal(bwd_hps[T - 1 - t], fwd_hps[t]), t


# -- The chunk-indexed form ---------------------------------------------------

def _emulate_chunked(x, keep, wh, bias_h, idx, h0, ys, dys):
    """The chunk-indexed backward's arithmetic: chunk b's rows through
    ``emulate_tc_bwd`` with policy idx[b]'s weights; its dWh partials over
    its own rows, 64 rows of one step a box (no box of two steps or two
    chunks), in ``_num_splits_tc`` splits of the chunk's boxes, and its row
    tiles' dbh partials; a policy's partials summed in f32 in chunk order
    and rounded once. A chunk of no policy gets NaN rows and adds to no
    policy. Returns (dxp, dwh [P, ...], dbh [P, ...], dh0)."""
    B, P = idx.shape[0], wh.shape[0]
    C = x.shape[1] // B
    T, N, H = ys.shape
    dxp = torch.full((T, N, 3 * H), float("nan"), dtype=x.dtype)
    dh0 = torch.full((N, H), float("nan"), dtype=x.dtype)
    dw = torch.zeros(P, H, 3 * H, dtype=F32)
    db = torch.zeros(P, H, dtype=F32)
    for b, p in enumerate(idx.tolist()):
        if not 0 <= p < P:
            continue
        r = slice(b * C, (b + 1) * C)
        inner = {}
        got = emulate_tc_bwd(x[:, r], keep[:, r], wh[p], bias_h[p], h0[r],
                             ys[:, r], dys[:, r], state=inner)
        dxp[:, r], dh0[r] = got[0], got[3]
        hin, dhp = inner["hin"], inner["dhp"]
        boxes = [(hin[t, m:m + M_SLICE], dhp[t, m:m + M_SLICE])
                 for t in range(T) for m in range(0, C, M_SLICE)]
        per = -(-len(boxes) // _num_splits_tc(T * C, H, H, H100_SMS,
                                              gates=3))
        for k in range(0, len(boxes), per):
            part = torch.zeros(H, 3 * H, dtype=F32)
            for a, g in boxes[k:k + per]:
                part = part + a.float().t() @ g.float()
            dw[p] = dw[p] + part
        for block in inner["db_blocks"]:
            db[p] = db[p] + block
    return dxp, dw.to(x.dtype), db.to(x.dtype), dh0


@pytest.mark.parametrize("dtype", [BF16, F16])
@pytest.mark.parametrize("H", [384, 512])
def test_wide_gru_bwd_chunked_rows_are_single_rows(H, dtype):
    """The chunk-indexed form at H = 384 / 512 (chunks of 64 rows, a chunk
    of index P, policy 1 owning two chunks): within the dtype's rule of its
    plain twin's autograd, its NaN chunk NaN in both and in no policy's
    gradient, every other chunk's dxp / dh0 bitwise the single-policy
    emulation over that chunk alone, and policy 0 (one chunk; 64 divides
    the chunk, so its boxes and splits are the single-policy pass's) its
    chunk's dWh and dbh bitwise."""
    T, C, P = 2, 64, 2
    order = [1, 0, P, 1]
    rng = np.random.default_rng(630 + H)

    def cast(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)

    N = C * len(order)
    x, keep = cast(rng.normal(size=(T, N, 3 * H))), cast(rng.random((T, N))
                                                          > 0.2)
    wh = cast(rng.normal(size=(P, H, 3 * H)) / np.sqrt(H))
    bias_h = cast(rng.normal(size=(P, H)))
    h0, dys = cast(rng.normal(size=(N, H))), cast(rng.normal(size=(T, N, H)))
    idx = torch.tensor(order, dtype=torch.int32)
    ys = gru_sequence_chunked_reference(x, keep, wh, bias_h, idx, h0)
    got = _emulate_chunked(x, keep, wh, bias_h, idx, h0, ys, dys)

    leaves = [t.clone().requires_grad_() for t in (x, wh, bias_h, h0)]
    out = gru_sequence_chunked_reference(leaves[0], keep, leaves[1],
                                         leaves[2], idx, leaves[3])
    bad = torch.tensor([p == P for p in order]).repeat_interleave(C)
    assert out[:, bad].isnan().all()
    loss = (out[:, ~bad].float() * dys[:, ~bad].float()).sum()
    want = torch.autograd.grad(loss, leaves)
    assert got[0][:, bad].isnan().all() and got[3][bad].isnan().all()
    assert torch.isfinite(got[1]).all() and torch.isfinite(got[2]).all()
    _check([got[0][:, ~bad], got[1], got[2], got[3][~bad]],
           [want[0][:, ~bad], want[1], want[2], want[3][~bad]], RTOL[dtype],
           "chunked vs plain")
    for b, p in enumerate(order):
        if p == P:
            continue
        r = slice(b * C, (b + 1) * C)
        one = emulate_tc_bwd(x[:, r], keep[:, r], wh[p], bias_h[p], h0[r],
                             ys[:, r], dys[:, r])
        assert torch.equal(one[0], got[0][:, r]), b
        assert torch.equal(one[3], got[3][r]), b
        if order.count(p) == 1:
            assert torch.equal(one[1], got[1][p])
            assert torch.equal(one[2], got[2][p])


# -- float16 at H = 384 / 512 -------------------------------------------------

def _j16(t):
    return jnp.asarray(t.float().numpy(), jnp.float16)


@pytest.mark.parametrize("T,N,H", WIDE)
def test_f16_wide_gru_fwd_meets_the_plain_and_jax_contracts(T, N, H):
    args, _ = _inputs(640 + H, T, N, H, dtype=F16)
    ys = emulate_tc_fwd(**args)
    assert ys.dtype == F16
    jax_ys = torch.from_numpy(np.asarray(jax_gru_reference(
        *(_j16(args[k]) for k in ("x_proj", "keep", "wh", "bias_h", "h0"))),
        np.float32))
    for what, want in (("plain", gru_sequence_reference(**args)),
                       ("JAX float16", jax_ys)):
        err = (ys.float() - want.float()).abs().max().item()
        assert err <= FWD_ATOL, f"ys vs {what}: max |diff| {err:.3e}"


def _jax_float16_grads(args, probe):
    """``jax.vjp`` of JAX's jnp twin in float16, JAX's float16 route."""
    keep = _j16(args["keep"])
    diff = ("x_proj", "wh", "bias_h", "h0")
    ys, vjp = jax.vjp(lambda x, wh, bh, h0: jax_gru_reference(
        x, keep, wh, bh, h0), *(_j16(args[k]) for k in diff))
    return tuple(torch.from_numpy(np.asarray(g, np.float32))
                 for g in vjp(_j16(probe).astype(ys.dtype)))


@pytest.mark.parametrize("T,N,H", WIDE)
def test_f16_wide_gru_bwd_meets_the_plain_contract(T, N, H):
    args, probe = _inputs(650 + H, T, N, H, dtype=F16)
    got = _emulated(args, probe)
    assert all(g.dtype == F16 for g in got)
    _check(got, _plain_grads(args, probe), RTOL[F16], "vs plain")


@pytest.mark.parametrize("T,N,H", WIDE)
def test_f16_wide_gru_bwd_matches_jaxs_float16_route(T, N, H):
    args, probe = _inputs(660 + H, T, N, H, dtype=F16)
    _check(_emulated(args, probe), _jax_float16_grads(args, probe),
           RTOL[F16], "vs JAX float16")


# -- The routes, on a stand-in library ----------------------------------------

class _Lib:
    """A stand-in for the kernels' library: records each entry point's name
    and arguments, and returns 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.mark.parametrize("dtype,H,tensor_core", [
    (BF16, 384, True), (BF16, 512, True),    # the two-block cluster
    (F16, 384, True), (F16, 512, True),
    (F32, 384, False), (F32, 512, False)])   # CUDA cores
def test_wide_gru_backwards_take_their_routes(monkeypatch, dtype, H,
                                              tensor_core):
    """``gru_sequence_bwd`` and its chunk-indexed instance launch the
    tensor-core entry points where ``bwd_uses_tensor_cores`` says
    (``mlt_gru_bwd_tc``: the dtype code, H, phases 3 and no witness;
    tensor_core 1 and an h_in scratch in the chunked one) and count a
    launch and a tensor-core launch each; float32 their CUDA-core entry
    points. The operands stand on the CPU: the
    library, the operand check, the SM count and the stream are
    stand-ins."""
    assert bwd_uses_tensor_cores(dtype, H) is tensor_core
    lib = _Lib()
    monkeypatch.setattr(gru_mod, "library", lambda: lib)
    monkeypatch.setattr(gru_mod, "_check", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device=None: types.SimpleNamespace(
                            multi_processor_count=132))
    for k in (GRU_BWD, GRU_BWD_CHUNKED):
        monkeypatch.setattr(k, "launches", 0)
        monkeypatch.setattr(k, "tc_launches", 0)
    code = {F32: 0, BF16: 1, F16: 2}[dtype]
    T, N, P = 2, 70, 2
    z = lambda *s: torch.zeros(*s, dtype=dtype)
    seq = z(T, N, H)
    gru_sequence_bwd(z(T, N, 3 * H), z(T, N), z(H, 3 * H), z(H), z(N, H),
                     seq, seq)
    gru_sequence_bwd_chunked(z(T, N, 3 * H), z(T, N), z(P, H, 3 * H),
                             z(P, H), torch.tensor([1, 0], dtype=torch.int32),
                             z(N, H), seq, seq)
    (single, s_args), (chunked, c_args) = lib.calls
    if tensor_core:
        assert single == "mlt_gru_bwd_tc"
        assert s_args[:3] == (code, H, 3)   # (dtype, hidden, phases)
        assert s_args[-2] is None           # no witness
    else:
        assert single == "mlt_gru_bwd" and s_args[:2] == (code, H)
    assert chunked == "mlt_gru_bwd_chunked"
    assert c_args[:3] == (int(tensor_core), code, H)
    assert (c_args[14] != 0) == tensor_core     # the h_in scratch
    assert [(k.launches, k.tc_launches) for k in (GRU_BWD,
                                                  GRU_BWD_CHUNKED)] == \
        [(1, int(tensor_core))] * 2


@pytest.mark.parametrize("dtype", [BF16, F16])
@pytest.mark.parametrize("H", [384, 512])
def test_product_witness_reaches_both_entry_points(monkeypatch, dtype, H):
    """``_fwd_tc(hp=...)`` and ``_bwd_tc(hp=...)`` hand their f32 witness
    to ``mlt_gru_fwd_tc`` / ``mlt_gru_bwd_tc`` (the argument before the
    stream), the buffers the card check compares bitwise; the backward's
    dbh partials take ``tc_rows(H)`` row tiles."""
    lib = _Lib()
    monkeypatch.setattr(gru_mod, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device=None: types.SimpleNamespace(
                            multi_processor_count=132))
    T, N = 2, 70
    z = lambda *s: torch.zeros(*s, dtype=dtype)
    args = (z(T, N, 3 * H), z(T, N), z(H, 3 * H), z(H), z(N, H))
    fwd_hp, bwd_hp = torch.zeros(T, N, 3 * H), torch.zeros(T, N, 3 * H)
    ys = gru_mod._fwd_tc(*args, hp=fwd_hp)
    b = gru_mod._bwd_tc(*args, ys, z(T, N, H), phases=1, hp=bwd_hp)
    (f, f_args), (g, g_args) = lib.calls
    assert f == "mlt_gru_fwd_tc" and f_args[-2] == fwd_hp.data_ptr()
    assert g == "mlt_gru_bwd_tc" and g_args[:3] == (
        {BF16: 1, F16: 2}[dtype], H, 1)
    assert g_args[-2] == bwd_hp.data_ptr()
    assert b["part_b"].shape == (-(-N // tc_rows(H)), H)
