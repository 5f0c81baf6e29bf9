"""The float16 LSTM forward and GRU backward on tensor cores at H = 128
and 256 (``csrc/lstm.cu``: lstm_fwd_tc_kernel; ``csrc/gru.cu``:
gru_bwd_tc_kernel), held on the CPU to the contracts that define them, and
the rules that route a call to them.

Both are the bf16 instances' schedules with f16 operands (the port's own
route: JAX sends float16 to its jnp twins): f16 ``wgmma`` products summed
in f32 64 deep at a time, one rounding to float16 where the CUDA-core
kernels and the plain twins round. The emulations are
``test_torch_lstm_fwd_tc_numerics.emulate_tc_fwd`` and
``test_torch_gru_tc_numerics.emulate_tc_bwd``, in the operands' element
type. Held here:

- the LSTM forward against ``lstm_sequence_reference`` (the plain twin)
  and JAX's ``lstm_sequence_reference`` in float16 under the chip check's
  float16 forward rule (``TOL[("fwd", "float16")]``: max |diff| <= 2^-8);
- to itself, bitwise: a T = 1 step from the cleared state is step t of the
  sequence (the rollout step is the update pass's forward, so PPO's ratio
  starts at exactly 1), and a chunk-indexed row is the single-policy row;
- the float16 LSTM backward's recomputed pre-activations bitwise those of
  the forward, now that both run on f16 ``wgmma``;
- the GRU backward against the plain twin's autograd and ``jax.vjp`` of
  JAX's ``gru_sequence_reference`` in float16 under the chip check's
  float16 backward rule (``TOL[("gru_bwd", "float16")]``: max |diff| <=
  2^-8 of the largest value);
- the wrappers' routes on a stand-in library: the LSTM forwards (and the
  rollout steps) and the GRU backwards and forward on their tensor-core
  entry points with dtype code 2 (the float16 GRU forward's arithmetic:
  ``test_torch_gru_fwd_tc_f16_wide.py``).

All at T <= 3 and N <= 20 (ragged against the kernels' 32 rows a block),
one or two policies.
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
from madrona_learn_tpu.ops.pallas.lstm import (
    lstm_sequence_reference as jax_lstm_reference,
)
from madrona_learn_tpu_torch.ops.cuda import gru as gru_mod
from madrona_learn_tpu_torch.ops.cuda import lstm as lstm_mod
from madrona_learn_tpu_torch.ops.cuda.gru import (
    GRU_BWD,
    GRU_BWD_CHUNKED,
    GRU_FWD,
    gru_sequence_bwd,
    gru_sequence_bwd_chunked,
    gru_sequence_fwd,
)
from madrona_learn_tpu_torch.ops.cuda.lstm import (
    LSTM_FWD,
    LSTM_FWD_CHUNKED,
    fwd_uses_tensor_cores,
    lstm_sequence_fwd,
    lstm_sequence_fwd_chunked,
    lstm_sequence_fwd_chunked_reference,
    lstm_sequence_reference,
)
from test_torch_gru_tc_numerics import _emulated as gru_emulated
from test_torch_gru_tc_numerics import _inputs as gru_inputs
from test_torch_gru_tc_numerics import _plain_grads as gru_plain_grads
from test_torch_lstm_fwd_tc_numerics import (
    emulate_tc_fwd,
    emulate_tc_fwd_chunked,
)
from test_torch_lstm_tc_numerics import _inputs as lstm_inputs
from test_torch_lstm_tc_numerics import emulate_tc_bwd as lstm_emulate_bwd

torch.set_num_threads(1)

F16 = torch.float16
# The chip check's float16 rules (chip_smoke.py TOL): the forward's max
# |diff| <= 2^-8, the backward's max |diff| <= 2^-8 max |want|, tensor by
# tensor.
FWD_ATOL = 2 ** -8
BWD_RTOL = 2 ** -8
CASES = [(3, 20, 128), (2, 20, 256)]


def _j(t):
    return jnp.asarray(t.float().numpy(), jnp.float16)


def _lstm_args(seed, T, N, H):
    args, _ = lstm_inputs(seed, T, N, H, dtype=F16)
    return args


def _within(got, want, what):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= FWD_ATOL, f"{what}: max |diff| {err:.3e} above {FWD_ATOL}"


# -- The float16 LSTM forward -------------------------------------------------

@pytest.mark.parametrize("T,N,H", CASES)
def test_f16_lstm_fwd_arithmetic_meets_the_plain_and_jax_contracts(T, N, H):
    args = _lstm_args(300 + H, T, N, H)
    ys, cs = emulate_tc_fwd(**args)
    assert ys.dtype == cs.dtype == F16
    seq = (args["x"], args["keep"], args["wr"], args["bias"], args["c0"],
           args["h0"])
    want_ys, want_cs = lstm_mod._sequence(*seq)
    assert torch.equal(want_ys, lstm_sequence_reference(*seq))
    _within(ys, want_ys, "ys vs plain")
    _within(cs, want_cs, "cs vs plain")
    jax_ys = jax_lstm_reference(*(_j(t) for t in seq))
    _within(ys, torch.from_numpy(np.asarray(jax_ys, np.float32)),
            "ys vs JAX float16")


@pytest.mark.parametrize("H", [128, 256])
def test_f16_lstm_fwd_step_equals_its_sequence_step(H):
    """A T = 1 call from the cleared state after step t - 1 gives bitwise
    step t of the T = 3 call, at every step (step 1 after rows cleared by
    keep = 0)."""
    T, N = 3, 20
    args = _lstm_args(310 + H, T, N, H)
    keep = args["keep"]
    assert (keep[0] < 0.5).any()
    ys, cs = emulate_tc_fwd(**args)
    zero = torch.zeros((), dtype=F16)
    for t in range(T):
        if t == 0:
            c_in, h_in = args["c0"], args["h0"]
        else:
            kept = keep[t - 1][:, None] > 0.5
            c_in = torch.where(kept, cs[t - 1], zero)
            h_in = torch.where(kept, ys[t - 1], zero)
        one = emulate_tc_fwd(**dict(args, x=args["x"][t:t + 1],
                                    keep=keep[t:t + 1], c0=c_in, h0=h_in))
        assert torch.equal(one[0][0], ys[t]) and torch.equal(one[1][0], cs[t])


@pytest.mark.parametrize("H", [128, 256])
def test_f16_lstm_fwd_chunked_rows_are_single_rows(H):
    """The chunk-indexed form (chunks of 10 rows, a chunk of index P, policy
    1 owning two chunks): within the float16 rule of its plain twin, its NaN
    chunk NaN in both, every other chunk's rows bitwise the single-policy
    emulation over that chunk alone, and the first chunk's rows bitwise a
    call over it alone (batch invariance)."""
    T, C, P = 2, 10, 2
    order = [1, 0, P, 1]
    rng = np.random.default_rng(320 + H)

    def f16(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(F16)

    N = C * len(order)
    x, keep = f16(rng.normal(size=(T, N, 4 * H))), f16(rng.random((T, N))
                                                      > 0.2)
    wr = f16(rng.normal(size=(P, H, 4 * H)) / np.sqrt(H))
    bias = f16(rng.normal(size=(P, 4 * H)))
    c0, h0 = f16(rng.normal(size=(N, H))), f16(rng.normal(size=(N, H)))
    idx = torch.tensor(order, dtype=torch.int32)
    ys, cs = emulate_tc_fwd_chunked(x, keep, wr, bias, idx, c0, h0)
    want = lstm_sequence_fwd_chunked_reference(x, keep, wr, bias, idx, c0, h0)
    bad = torch.tensor([p == P for p in order]).repeat_interleave(C)
    for got, ref in zip((ys, cs), want):
        assert got.dtype == F16
        assert got[:, bad].isnan().all() and ref[:, bad].isnan().all()
        _within(got[:, ~bad], ref[:, ~bad], "chunked vs plain")
    for b, p in enumerate(order):
        if p == P:
            continue
        r = slice(b * C, (b + 1) * C)
        one = emulate_tc_fwd(x[:, r], keep[:, r], None, wr[p], bias[p],
                             c0[r], h0[r])
        assert torch.equal(one[0], ys[:, r]) and torch.equal(one[1], cs[:, r])
    first = emulate_tc_fwd_chunked(x[:, :C], keep[:, :C], wr, bias, idx[:1],
                                   c0[:C], h0[:C])
    assert torch.equal(first[0], ys[:, :C]) and torch.equal(first[1],
                                                             cs[:, :C])


@pytest.mark.parametrize("T,N,H", CASES)
def test_f16_lstm_bwd_recomputes_the_forwards_preactivations(T, N, H):
    """The float16 backward's recompute and the float16 forward now run the
    same f16 products through one helper: every step's recomputed
    pre-activations bitwise those the forward computed from the same carry,
    so the backward differentiates the forward that ran."""
    args, probe = lstm_inputs(330 + H, T, N, H, dtype=F16)
    fwd_pres = []
    ys, cs = emulate_tc_fwd(**args, pres=fwd_pres)
    bwd_pres = []
    got = lstm_emulate_bwd(**args, ys=ys, cs=cs, dys=probe, pres=bwd_pres)
    assert got[0].dtype == F16 and len(bwd_pres) == T
    for t in range(T):
        assert torch.equal(bwd_pres[T - 1 - t], fwd_pres[t]), t


# -- The float16 GRU backward -------------------------------------------------

def _check_grads(got, want, what):
    for name, g, w in zip(("dxp", "dwh", "dbh", "dh0"), got, want):
        err = (g.float() - w.float()).abs().max().item()
        scale = w.float().abs().max().item()
        assert err <= BWD_RTOL * scale, (
            f"{what} {name}: max |diff| {err:.3e} above {BWD_RTOL} x "
            f"max |want| {scale:.3e}")


def _jax_float16_gru_grads(args, probe):
    """``jax.vjp`` of JAX's jnp twin in float16, JAX's float16 route."""
    keep = _j(args["keep"])
    diff = ("x_proj", "wh", "bias_h", "h0")
    ys, vjp = jax.vjp(lambda x, wh, bh, h0: jax_gru_reference(
        x, keep, wh, bh, h0), *(_j(args[k]) for k in diff))
    return tuple(torch.from_numpy(np.asarray(g, np.float32))
                 for g in vjp(_j(probe).astype(ys.dtype)))


@pytest.mark.parametrize("T,N,H", CASES)
def test_f16_gru_bwd_arithmetic_meets_the_plain_contract(T, N, H):
    args, probe = gru_inputs(340 + H, T, N, H, dtype=F16)
    got = gru_emulated(args, probe)
    assert all(g.dtype == F16 for g in got)
    _check_grads(got, gru_plain_grads(args, probe), "vs plain")


@pytest.mark.parametrize("T,N,H", CASES)
def test_f16_gru_bwd_arithmetic_matches_jaxs_float16_route(T, N, H):
    args, probe = gru_inputs(350 + H, T, N, H, dtype=F16)
    _check_grads(gru_emulated(args, probe),
                 _jax_float16_gru_grads(args, probe), "vs JAX float16")


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


def _stand_in_card(monkeypatch, kernels):
    lib = _Lib()
    for mod in (lstm_mod, gru_mod):
        monkeypatch.setattr(mod, "library", lambda: lib)
        monkeypatch.setattr(mod, "_check", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device=None: types.SimpleNamespace(
                            multi_processor_count=132))
    for k in kernels:
        monkeypatch.setattr(k, "launches", 0)
        monkeypatch.setattr(k, "tc_launches", 0)
    return lib


@pytest.mark.parametrize("H", [128, 256])
def test_f16_lstm_forwards_take_tensor_cores(monkeypatch, H):
    """``lstm_sequence_fwd`` and its chunk-indexed instance (which the
    rollout steps run at T = 1 on the card) launch the tensor-core entry
    points in float16 at H = 128 / 256 (dtype code 2; tensor_core 1 in the
    chunked one) and count a tensor-core launch each. The operands stand on
    the CPU: the library, the operand check and the stream are
    stand-ins."""
    assert fwd_uses_tensor_cores(F16, H)
    lib = _stand_in_card(monkeypatch, (LSTM_FWD, LSTM_FWD_CHUNKED))
    T, N, P = 2, 8, 2
    z = lambda *s: torch.zeros(*s, dtype=F16)
    idx = torch.tensor([1, 0], dtype=torch.int32)
    lstm_sequence_fwd(z(T, N, 4 * H), z(T, N), z(H, 4 * H), z(4 * H),
                      z(N, H), z(N, H))
    lstm_sequence_fwd_chunked(z(T, N, 4 * H), z(T, N), z(P, H, 4 * H),
                              z(P, 4 * H), idx, z(N, H), z(N, H))
    (single, s_args), (chunked, c_args) = lib.calls
    assert single == "mlt_lstm_fwd_tc"
    assert s_args[:3] == (2, H, 0)            # dtype, hidden, f_in
    assert chunked == "mlt_lstm_fwd_chunked"
    assert c_args[:3] == (1, 2, H)            # tensor_core, dtype, hidden
    assert [(k.launches, k.tc_launches) for k in (LSTM_FWD,
                                                  LSTM_FWD_CHUNKED)] == \
        [(1, 1), (1, 1)]


@pytest.mark.parametrize("H", [128, 256])
def test_f16_gru_backwards_take_tensor_cores_forward_cuda_cores(
        monkeypatch, H):
    """In float16 at H = 128 / 256 ``gru_sequence_bwd`` and its
    chunk-indexed instance launch the tensor-core entry points (dtype code
    2 first; tensor_core 1 and an h_in scratch in the chunked one) and
    count a tensor-core launch each, and so, since its forward moved onto
    f16 ``wgmma`` too, does ``gru_sequence_fwd`` (``mlt_gru_fwd_tc``:
    dtype code 2, then H). The
    operands stand on the CPU: the library, the operand check, the SM
    count and the stream are stand-ins."""
    assert gru_mod.bwd_uses_tensor_cores(F16, H)
    assert gru_mod.fwd_uses_tensor_cores(F16, H)
    lib = _stand_in_card(monkeypatch, (GRU_FWD, GRU_BWD, GRU_BWD_CHUNKED))
    T, N, P = 2, 8, 2
    z = lambda *s: torch.zeros(*s, dtype=F16)
    idx = torch.tensor([1, 0], dtype=torch.int32)
    seq = z(T, N, H)
    gru_sequence_fwd(z(T, N, 3 * H), z(T, N), z(H, 3 * H), z(H), z(N, H))
    gru_sequence_bwd(z(T, N, 3 * H), z(T, N), z(H, 3 * H), z(H), z(N, H),
                     seq, seq)
    gru_sequence_bwd_chunked(z(T, N, 3 * H), z(T, N), z(P, H, 3 * H),
                             z(P, H), idx, z(N, H), seq, seq)
    (f, a1), (b1, a2), (b2, a3) = lib.calls
    assert f == "mlt_gru_fwd_tc" and a1[:2] == (2, H)
    assert b1 == "mlt_gru_bwd_tc" and a2[:3] == (2, H, 3)  # phases 3
    assert b2 == "mlt_gru_bwd_chunked" and a3[:3] == (1, 2, H)
    assert a3[14] != 0                         # the h_in scratch
    assert [(k.launches, k.tc_launches) for k in (GRU_FWD, GRU_BWD,
                                                  GRU_BWD_CHUNKED)] == \
        [(1, 1), (1, 1), (1, 1)]
