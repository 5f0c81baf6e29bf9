"""The LSTM backward's tensor-core instances beyond bf16 at H = 128 / 256
(``csrc/lstm.cu``: lstm_bwd_tc_kernel), held on the CPU to the contracts
that define them, and the rule that routes a call to them.

- bf16 at H = 384 and 512, a cluster of two blocks: each block recomputes
  the pre-activations of its H / 2 units through the forward's helper in
  the forward's slice order, writes its units' dgates into both blocks'
  dgates tiles, and computes dh_prev of its units over all 4H gates.
  ``test_torch_lstm_tc_numerics.emulate_tc_bwd`` follows it rank by rank;
  held here against ``lstm_sequence_reference``'s autograd and JAX's
  Pallas VJP in interpret mode under the chip check's bf16 rule (3.2e-2 of
  the largest value), its recomputed pre-activations bitwise those of the
  forward's emulation (``test_torch_lstm_fwd_tc_numerics.emulate_tc_fwd``),
  and its chunk-indexed form's rows bitwise its single-policy rows.
- float16 at H = 128 and 256 (the port's own: JAX sends float16 to its jnp
  twin): f16 operands, 64-deep f32 slice sums, dgates, dh0, dc0, dWr and
  db rounded once to float16. Held against the plain twin's autograd in
  float16 and against ``jax.vjp`` of JAX's ``lstm_sequence_reference`` in
  float16 under the chip check's float16 rule (2^-8 of the largest value).
- The wrappers launch these instances' tensor-core entry points with the
  tensor's dtype code and count a tensor-core launch each; float32, and
  float16 at 384 / 512, stay on the CUDA-core entry points.

All at T <= 3, N <= 20 (the kernels' R = 16 rows a block: ragged), one or
two policies.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_learn_tpu.ops.pallas.lstm import lstm_sequence as jax_lstm_seq
from madrona_learn_tpu.ops.pallas.lstm import (
    lstm_sequence_reference as jax_lstm_reference,
)
from madrona_learn_tpu_torch.ops.cuda import lstm as lstm_mod
from madrona_learn_tpu_torch.ops.cuda.lstm import (
    LSTM_BWD,
    LSTM_BWD_CHUNKED,
    _num_splits_tc,
    bwd_uses_tensor_cores,
    lstm_sequence_bwd,
    lstm_sequence_bwd_chunked,
    lstm_sequence_chunked_reference,
)
from test_torch_lstm_fwd_tc_numerics import emulate_tc_fwd
from test_torch_lstm_tc_numerics import (
    H100_SMS,
    M_SLICE,
    _forward_states,
    _inputs,
    _plain_grads,
    emulate_tc_bwd,
)

torch.set_num_threads(1)

BF16 = torch.bfloat16
F16 = torch.float16
F32 = torch.float32
NAMES = ("dx", "dwi", "dwr", "db", "dc0", "dh0")
# The chip check's backward rules (chip_smoke.py TOL[("bwd", dtype)]): max
# |diff| <= rtol * max |want|, tensor by tensor.
RTOL = {BF16: 3.2e-2, F16: 2 ** -8}


def _check(got, want, rtol, what):
    for name, g, w in zip(NAMES, got, want):
        if g is None:
            assert w is None, name
            continue
        err = (g.float() - w.float()).abs().max().item()
        scale = w.float().abs().max().item()
        assert err <= rtol * scale, (
            f"{what} {name}: max |diff| {err:.3e} above {rtol} x max |want| "
            f"{scale:.3e}")


def _emulated(args, probe, pres=None):
    ys, cs = _forward_states(**args)
    return emulate_tc_bwd(**args, ys=ys, cs=cs, dys=probe, pres=pres)


# -- bf16 at H = 384 / 512: the two-block cluster -----------------------------

WIDE = [(3, 20, 384), (2, 20, 512)]


@pytest.mark.parametrize("T,N,H", WIDE)
def test_wide_bwd_arithmetic_meets_the_plain_contract(T, N, H):
    args, probe = _inputs(200 + H, T, N, H)
    _check(_emulated(args, probe), _plain_grads(args, probe), RTOL[BF16],
           "vs plain")


def _jax_pallas_grads(args, probe):
    """JAX's Pallas backward (interpret mode) of the sequence pass."""
    def j(t):
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)

    keep, probe_j = j(args["keep"]), j(probe).astype(jnp.float32)

    def loss(x, wr, b, c0, h0):
        ys = jax_lstm_seq(x, keep, wr, b, c0, h0, True)
        return jnp.sum(ys.astype(jnp.float32) * probe_j)

    diff = ("x", "wr", "bias", "c0", "h0")
    grads = jax.grad(loss, argnums=tuple(range(5)))(
        *(j(args[k]) for k in diff))
    got = {k: torch.from_numpy(np.asarray(g, np.float32))
           for k, g in zip(diff, grads)}
    return tuple(got.get(k) for k in ("x", "wi", "wr", "bias", "c0", "h0"))


@pytest.mark.parametrize("T,N,H", WIDE)
def test_wide_bwd_arithmetic_matches_the_pallas_backward(T, N, H):
    args, probe = _inputs(210 + H, T, N, H)
    _check(_emulated(args, probe), _jax_pallas_grads(args, probe),
           RTOL[BF16], "vs Pallas")


@pytest.mark.parametrize("H", [384, 512])
def test_wide_bwd_recomputes_the_forwards_preactivations(H):
    """The backward's recompute goes through the forward's helper in the
    forward's slice order: every step's pre-activations bitwise those the
    tensor-core forward computed from the same carry, so the ys / cs it
    reads are the ones its gates give."""
    T, N = 3, 20
    args, probe = _inputs(220 + H, T, N, H)
    fwd_pres = []
    ys, cs = emulate_tc_fwd(**args, pres=fwd_pres)
    bwd_pres = []
    emulate_tc_bwd(**args, ys=ys, cs=cs, dys=probe, pres=bwd_pres)
    assert len(bwd_pres) == T
    for t in range(T):
        assert torch.equal(bwd_pres[T - 1 - t], fwd_pres[t]), t


def _emulate_chunked(x, keep, wr, bias, idx, c0, h0, ys, cs, dys):
    """The chunk-indexed backward's arithmetic: chunk b's rows through
    ``emulate_tc_bwd`` with policy idx[b]'s weights; its dWr partials over
    its own rows, 64 rows of one step a box (no box of two steps or two
    chunks), in ``_num_splits_tc`` splits of the chunk's boxes, and its row
    tiles' db partials; a policy's partials summed in f32 in chunk order
    and rounded once. A chunk of no policy gets NaN rows and adds to no
    policy. Returns (dx, dwr [P, ...], db [P, ...], dc0, dh0)."""
    B, P = idx.shape[0], wr.shape[0]
    C = x.shape[1] // B
    T, N, H = ys.shape
    dx = torch.full((T, N, 4 * H), float("nan"), dtype=x.dtype)
    dc0 = torch.full((N, H), float("nan"), dtype=x.dtype)
    dh0 = dc0.clone()
    dw = torch.zeros(P, H, 4 * H, dtype=F32)
    db = torch.zeros(P, 4 * H, dtype=F32)
    for b, p in enumerate(idx.tolist()):
        if not 0 <= p < P:
            continue
        r = slice(b * C, (b + 1) * C)
        inner = {}
        got = emulate_tc_bwd(x[:, r], keep[:, r], None, wr[p], bias[p],
                             c0[r], h0[r], ys[:, r], cs[:, r], dys[:, r],
                             state=inner)
        dx[:, r], dc0[r], dh0[r] = got[0], got[4], got[5]
        hin, dg = inner["hin"], inner["dg"]
        boxes = [(hin[t, m:m + M_SLICE], dg[t, m:m + M_SLICE])
                 for t in range(T) for m in range(0, C, M_SLICE)]
        per = -(-len(boxes) // _num_splits_tc(T * C, H, H, H100_SMS))
        for k in range(0, len(boxes), per):
            part = torch.zeros(H, 4 * H, dtype=F32)
            for a, g in boxes[k:k + per]:
                part = part + a.float().t() @ g.float()
            dw[p] = dw[p] + part
        for block in inner["db_blocks"]:
            db[p] = db[p] + block
    return dx, dw.to(x.dtype), db.to(x.dtype), dc0, dh0


@pytest.mark.parametrize("H", [384, 512])
def test_wide_bwd_chunked_rows_are_single_rows(H):
    """The chunk-indexed form at H = 384 / 512 (chunks of 20 rows, ragged
    against the 16-row tile, a chunk of index P, policy 1 owning two
    chunks): within the bf16 rule of its plain twin's autograd, its NaN
    chunk NaN in both and in no policy's gradient, and every other chunk's
    dx_proj / dh0 / dc0 bitwise the single-policy emulation over that chunk
    alone; policy 0 (one chunk) has its chunk's db bitwise, and its dWr
    within the rule (64 does not divide the chunk, so its boxes are not
    the single-policy pass's)."""
    T, C, P = 2, 20, 2
    order = [1, 0, P, 1]
    rng = np.random.default_rng(230 + H)

    def bf(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(BF16)

    N = C * len(order)
    x, keep = bf(rng.normal(size=(T, N, 4 * H))), bf(rng.random((T, N)) > 0.2)
    wr = bf(rng.normal(size=(P, H, 4 * H)) / np.sqrt(H))
    bias = bf(rng.normal(size=(P, 4 * H)))
    c0, h0 = bf(rng.normal(size=(N, H))), bf(rng.normal(size=(N, H)))
    dys = bf(rng.normal(size=(T, N, H)))
    idx = torch.tensor(order, dtype=torch.int32)
    ys, cs = (t.detach() for t in lstm_mod._chunked(
        lstm_mod._sequence, x, keep, (wr, bias), idx, (c0, h0)))
    got = _emulate_chunked(x, keep, wr, bias, idx, c0, h0, ys, cs, dys)

    leaves = [t.clone().requires_grad_() for t in (x, wr, bias, c0, h0)]
    out = lstm_sequence_chunked_reference(leaves[0], keep, leaves[1],
                                          leaves[2], idx, leaves[3],
                                          leaves[4])
    bad = torch.tensor([p == P for p in order]).repeat_interleave(C)
    assert out[:, bad].isnan().all()
    loss = (out[:, ~bad].float() * dys[:, ~bad].float()).sum()
    want = torch.autograd.grad(loss, leaves)
    assert got[0][:, bad].isnan().all()
    assert got[3][bad].isnan().all() and got[4][bad].isnan().all()
    for name, g, w in zip(("dx", "dc0", "dh0"), (got[0], got[3], got[4]),
                          (want[0], want[3], want[4])):
        _check([g[:, ~bad] if g.dim() == 3 else g[~bad]],
               [w[:, ~bad] if w.dim() == 3 else w[~bad]], RTOL[BF16],
               f"chunked {name} vs plain")
    for p in range(P):
        _check([got[1][p], got[2][p]], [want[1][p], want[2][p]], RTOL[BF16],
               f"chunked dwr / db[{p}] vs plain")
    for b, p in enumerate(order):
        if p == P:
            continue
        r = slice(b * C, (b + 1) * C)
        one = emulate_tc_bwd(x[:, r], keep[:, r], None, wr[p], bias[p],
                             c0[r], h0[r], ys[:, r], cs[:, r], dys[:, r])
        assert torch.equal(one[0], got[0][:, r])
        assert torch.equal(one[4], got[3][r])
        assert torch.equal(one[5], got[4][r])
        if order.count(p) == 1:
            assert torch.equal(one[3], got[2][p])
            _check([got[1][p]], [one[2]], RTOL[BF16], "chunked dwr vs single")


# -- float16 at H = 128 / 256: f16 wgmma --------------------------------------

def _jax_float16_grads(args, probe):
    """``jax.vjp`` of JAX's jnp twin in float16, JAX's float16 route."""
    def j(t):
        return jnp.asarray(t.float().numpy(), jnp.float16)

    keep = j(args["keep"])
    diff = ("x", "wr", "bias", "c0", "h0")
    ys, vjp = jax.vjp(lambda *a: jax_lstm_reference(a[0], keep, *a[1:]),
                      *(j(args[k]) for k in diff))
    grads = vjp(j(probe).astype(ys.dtype))
    got = {k: torch.from_numpy(np.asarray(g, np.float32))
           for k, g in zip(diff, grads)}
    return tuple(got.get(k) for k in ("x", "wi", "wr", "bias", "c0", "h0"))


F16_CASES = [(3, 20, 128), (2, 20, 256)]


@pytest.mark.parametrize("T,N,H", F16_CASES)
def test_f16_bwd_arithmetic_meets_the_plain_contract(T, N, H):
    args, probe = _inputs(240 + H, T, N, H, dtype=F16)
    got = _emulated(args, probe)
    assert all(g is None or g.dtype == F16 for g in got)
    _check(got, _plain_grads(args, probe), RTOL[F16], "vs plain")


@pytest.mark.parametrize("T,N,H", F16_CASES)
def test_f16_bwd_arithmetic_matches_jaxs_float16_route(T, N, H):
    args, probe = _inputs(250 + H, T, N, H, dtype=F16)
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
    (BF16, 384, True), (BF16, 512, True), (F16, 128, True),
    (F16, 256, True), (F16, 384, False), (F16, 512, False),
    (F32, 256, False), (F32, 512, False)])
def test_backwards_take_their_routes(monkeypatch, dtype, H, tensor_core):
    """``lstm_sequence_bwd`` and its chunk-indexed instance launch the
    tensor-core entry points where ``bwd_uses_tensor_cores`` says (the
    tensor's dtype code first; tensor_core 1 in the chunked one) and count
    a launch and a tensor-core launch each; elsewhere their CUDA-core entry
    points, counting no tensor-core launch. The operands stand on the CPU:
    the library, the operand check, the SM count and the stream are
    stand-ins."""
    assert bwd_uses_tensor_cores(dtype, H) is tensor_core
    lib = _Lib()
    monkeypatch.setattr(lstm_mod, "library", lambda: lib)
    monkeypatch.setattr(lstm_mod, "_check", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device=None: types.SimpleNamespace(
                            multi_processor_count=132))
    for k in (LSTM_BWD, LSTM_BWD_CHUNKED):
        monkeypatch.setattr(k, "launches", 0)
        monkeypatch.setattr(k, "tc_launches", 0)
    code = {F32: 0, BF16: 1, F16: 2}[dtype]
    T, N, P = 2, 4, 2
    z = lambda *s: torch.zeros(*s, dtype=dtype)
    seq = z(T, N, H)
    lstm_sequence_bwd(z(T, N, 4 * H), z(T, N), z(H, 4 * H), z(4 * H),
                      z(N, H), z(N, H), seq, seq, seq)
    lstm_sequence_bwd_chunked(z(T, N, 4 * H), z(T, N), z(P, H, 4 * H),
                              z(P, 4 * H), torch.tensor([1, 0],
                                                        dtype=torch.int32),
                              z(N, H), z(N, H), seq, seq, seq)
    (single, s_args), (chunked, c_args) = lib.calls
    if tensor_core:
        assert single == "mlt_lstm_bwd_tc"
        assert s_args[:4] == (code, H, 0, 3)   # dtype, hidden, f_in, phases
    else:
        assert single == "mlt_lstm_bwd" and s_args[:2] == (code, H)
    assert chunked == "mlt_lstm_bwd_chunked"
    assert c_args[:3] == (int(tensor_core), code, H)
    assert (c_args[15] != 0) == tensor_core    # the h_in scratch
    assert [(k.launches, k.tc_launches) for k in (LSTM_BWD,
                                                  LSTM_BWD_CHUNKED)] == \
        [(1, int(tensor_core))] * 2
