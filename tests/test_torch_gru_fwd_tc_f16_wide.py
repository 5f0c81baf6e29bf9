"""The GRU forward on tensor cores in float16 at H = 128 / 256 and in bf16
at H = 384 / 512 (``csrc/gru.cu``: gru_fwd_tc_kernel, the latter in a
two-block cluster), held on the CPU to the contracts that define it, and
the rules that route a call to it.

Both are the bf16 instance's schedule: float16 with f16 operands (the
port's own route: JAX sends float16 to its jnp twin), 384 / 512 with each
block of a cluster summing its units' products over all H in the same
64-deep slices, so the arithmetic of both is
``test_torch_gru_fwd_tc_numerics.emulate_tc_fwd`` in the operands' element
type. Held here:

- float16 against ``gru_sequence_reference`` (the plain twin) and JAX's
  ``gru_sequence_reference`` in float16 under the chip check's float16
  forward rule (``TOL[("gru_fwd", "float16")]``: max |diff| <= 2^-8);
- bf16 at 384 / 512 against the plain twin and JAX's Pallas
  ``gru_sequence`` in interpret mode under its bf16 rule (3.2e-2);
- to itself, bitwise: a T = 1 step from the cleared state is step t of the
  sequence (the rollout step is the update pass's forward, so PPO's ratio
  starts at exactly 1), rows do not depend on N, and a chunk-indexed row
  is the single-policy row; chunks of no policy NaN;
- the float16 backward's recomputed h . Wh bitwise the forward's, now
  that both run on f16 ``wgmma`` through one helper;
- the wrappers' routes on a stand-in library: float16 and bf16 at every
  width on the tensor-core entry points with their dtype codes (the
  float16 instances at 384 / 512 in the cluster too), float32 on the
  CUDA-core ones.

All at T <= 4 and N <= 70 (ragged against the kernel's 32 rows a block).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_learn_tpu.ops.pallas.gru import (
    gru_sequence_reference as jax_gru_reference,
)
from madrona_learn_tpu_torch.ops.cuda import gru as gru_mod
from madrona_learn_tpu_torch.ops.cuda.gru import (
    GRU_FWD,
    GRU_FWD_CHUNKED,
    fwd_uses_tensor_cores,
    gru_sequence_fwd,
    gru_sequence_fwd_chunked,
    gru_sequence_fwd_chunked_reference,
    gru_sequence_reference,
)
from test_torch_gru_fwd_tc_numerics import _jax_ys, emulate_tc_fwd
from test_torch_gru_tc_numerics import _inputs as gru_inputs
from test_torch_gru_tc_numerics import emulate_tc_bwd

torch.set_num_threads(1)

BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32
# The chip check's GRU forward rules (chip_smoke.py TOL[("gru_fwd", ...)]):
# max |diff| <= 2^-8 in float16, 3.2e-2 in bf16.
ATOL = {F16: 2 ** -8, BF16: 3.2e-2}
F16_CASES = [(3, 70, 128), (2, 70, 256)]
WIDE = [384, 512]


def _args(seed, T, N, H, dtype):
    return gru_inputs(seed, T, N, H, dtype=dtype)[0]


def _within(got, want, what, dtype):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= ATOL[dtype], (
        f"{what}: max |diff| {err:.3e} above {ATOL[dtype]}")


def _step_equals_sequence_step(args):
    """A T = 1 call from the cleared state after step t - 1 gives bitwise
    step t of the sequence, at every step (one after rows cleared by
    keep = 0)."""
    keep = args["keep"]
    T = keep.shape[0]
    assert (keep[0] < 0.5).any()
    ys = emulate_tc_fwd(**args)
    zero = torch.zeros((), dtype=ys.dtype)
    for t in range(T):
        h_in = args["h0"] if t == 0 else torch.where(
            keep[t - 1][:, None] > 0.5, ys[t - 1], zero)
        one = emulate_tc_fwd(**dict(args, x_proj=args["x_proj"][t:t + 1],
                                    keep=keep[t:t + 1], h0=h_in))
        assert torch.equal(one[0], ys[t]), t


def emulate_tc_fwd_chunked(x_proj, keep, wh, bias_h, idx, h0):
    """The chunk-indexed forward's arithmetic: chunk b of C rows through
    ``emulate_tc_fwd`` with policy idx[b]'s weights, NaN rows for an index
    outside [0, P)."""
    C = x_proj.shape[1] // idx.shape[0]
    ys = torch.full((x_proj.shape[0], x_proj.shape[1], wh.shape[1]),
                    float("nan"), dtype=x_proj.dtype)
    for b, p in enumerate(idx.tolist()):
        if not 0 <= p < wh.shape[0]:
            continue
        r = slice(b * C, (b + 1) * C)
        ys[:, r] = emulate_tc_fwd(x_proj[:, r], keep[:, r], wh[p], bias_h[p],
                                  h0[r])
    return ys


def _chunked_rows_are_single_rows(seed, T, C, H, dtype):
    """Chunks of C rows in the order [1, 0, P, 1] (a chunk of index P,
    policy 1 owning two): within the forward rule of the plain twin, the
    NaN chunk NaN in both, every other chunk bitwise the single-policy
    emulation over that chunk alone, and the first chunk bitwise a call
    over it alone (batch invariance)."""
    P = 2
    order = [1, 0, P, 1]
    rng = np.random.default_rng(seed)

    def cast(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)

    N = C * len(order)
    x = cast(rng.normal(size=(T, N, 3 * H)))
    keep = cast(rng.random((T, N)) > 0.2)
    wh = cast(rng.normal(size=(P, H, 3 * H)) / np.sqrt(H))
    bias_h = cast(rng.normal(size=(P, H)))
    h0 = cast(rng.normal(size=(N, H)))
    idx = torch.tensor(order, dtype=torch.int32)
    ys = emulate_tc_fwd_chunked(x, keep, wh, bias_h, idx, h0)
    want = gru_sequence_fwd_chunked_reference(x, keep, wh, bias_h, idx, h0)
    bad = torch.tensor([p == P for p in order]).repeat_interleave(C)
    assert ys.dtype == dtype
    assert ys[:, bad].isnan().all() and want[:, bad].isnan().all()
    _within(ys[:, ~bad], want[:, ~bad], "chunked vs plain", dtype)
    for b, p in enumerate(order):
        if p == P:
            continue
        r = slice(b * C, (b + 1) * C)
        one = emulate_tc_fwd(x[:, r], keep[:, r], wh[p], bias_h[p], h0[r])
        assert torch.equal(one, ys[:, r]), b
    first = emulate_tc_fwd_chunked(x[:, :C], keep[:, :C], wh, bias_h,
                                   idx[:1], h0[:C])
    assert torch.equal(first, ys[:, :C])


# -- float16 at H = 128 / 256 -------------------------------------------------

@pytest.mark.parametrize("T,N,H", F16_CASES)
def test_f16_gru_fwd_arithmetic_meets_the_plain_and_jax_contracts(T, N, H):
    args = _args(400 + H, T, N, H, F16)
    ys = emulate_tc_fwd(**args)
    assert ys.dtype == F16
    _within(ys, gru_sequence_reference(**args), "ys vs plain", F16)
    jax_ys = jax_gru_reference(*(jnp.asarray(args[k].float().numpy(),
                                             jnp.float16)
                                 for k in ("x_proj", "keep", "wh", "bias_h",
                                           "h0")))
    _within(ys, torch.from_numpy(np.asarray(jax_ys, np.float32)),
            "ys vs JAX float16", F16)


@pytest.mark.parametrize("H", [128, 256])
def test_f16_gru_fwd_step_equals_its_sequence_step(H):
    _step_equals_sequence_step(_args(410 + H, 3, 20, H, F16))


@pytest.mark.parametrize("H", [128, 256])
def test_f16_gru_fwd_chunked_rows_are_single_rows(H):
    _chunked_rows_are_single_rows(420 + H, 2, 10, H, F16)


@pytest.mark.parametrize("T,N,H", F16_CASES)
def test_f16_gru_bwd_recomputes_the_forwards_products(T, N, H):
    """The float16 backward's recompute and the float16 forward now run the
    same f16 products through one helper (``hidden_products``): every
    step's recomputed h_in . Wh bitwise the product the forward computed
    from the same carry, so the backward differentiates the forward that
    ran."""
    args, probe = gru_inputs(430 + H, T, N, H, dtype=F16)
    fwd_hps = []
    ys = emulate_tc_fwd(**args, hps=fwd_hps)
    bwd_hps = []
    got = emulate_tc_bwd(**args, ys=ys, dys=probe, hps=bwd_hps)
    assert got[0].dtype == F16 and len(bwd_hps) == T
    for t in range(T):
        assert torch.equal(bwd_hps[T - 1 - t], fwd_hps[t]), t


# -- bf16 at H = 384 / 512: the two-block cluster ------------------------------

@pytest.mark.parametrize("H", WIDE)
def test_wide_gru_fwd_arithmetic_meets_the_plain_contract(H):
    args = _args(440 + H, 4, 70, H, BF16)
    _within(emulate_tc_fwd(**args), gru_sequence_reference(**args),
            "ys vs plain", BF16)


@pytest.mark.parametrize("H", WIDE)
def test_wide_gru_fwd_arithmetic_matches_the_pallas_forward(H):
    args = _args(450 + H, 3, 70, H, BF16)
    _within(emulate_tc_fwd(**args), _jax_ys(args), "ys vs Pallas", BF16)


@pytest.mark.parametrize("H", WIDE)
def test_wide_gru_fwd_step_equals_its_sequence_step(H):
    _step_equals_sequence_step(_args(460 + H, 4, 70, H, BF16))


@pytest.mark.parametrize("H", WIDE)
def test_wide_gru_fwd_rows_do_not_depend_on_the_batch(H):
    """N = 70 (ragged against the cluster's 32-row tile) and N = 16 give
    bitwise the same ys on the rows they share."""
    rows = 16
    args = _args(470 + H, 3, 70, H, BF16)
    sub = dict(args, x_proj=args["x_proj"][:, :rows],
               keep=args["keep"][:, :rows], h0=args["h0"][:rows])
    assert torch.equal(emulate_tc_fwd(**args)[:, :rows],
                       emulate_tc_fwd(**sub))


@pytest.mark.parametrize("H", WIDE)
def test_wide_gru_fwd_chunked_rows_are_single_rows(H):
    _chunked_rows_are_single_rows(480 + H, 3, 35, H, BF16)


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
    (F16, 128, True), (F16, 256, True),      # f16 wgmma
    (BF16, 384, True), (BF16, 512, True),    # the two-block cluster
    (F32, 384, False), (F32, 512, False),    # CUDA cores
    (F16, 384, True), (F16, 512, True),      # f16 in the cluster
])
def test_gru_fwd_routes(monkeypatch, dtype, H, tensor_core):
    """``gru_sequence_fwd`` and its chunk-indexed instance (which the
    rollout steps run at T = 1 on the card) take the route the rule names:
    the tensor-core entry points with the dtype code (``mlt_gru_fwd_tc``:
    dtype, H;
    ``mlt_gru_fwd_chunked`` with tensor_core 1), counting a tensor-core
    launch each, or the CUDA-core ones. The operands stand on the CPU: the
    library, the operand check and the stream are stand-ins."""
    assert fwd_uses_tensor_cores(dtype, H) is tensor_core
    lib = _Lib()
    monkeypatch.setattr(gru_mod, "library", lambda: lib)
    monkeypatch.setattr(gru_mod, "_check", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    for k in (GRU_FWD, GRU_FWD_CHUNKED):
        monkeypatch.setattr(k, "launches", 0)
        monkeypatch.setattr(k, "tc_launches", 0)
    T, N, P = 2, 8, 2
    code = {F32: 0, BF16: 1, F16: 2}[dtype]
    z = lambda *s: torch.zeros(*s, dtype=dtype)
    idx = torch.tensor([1, 0], dtype=torch.int32)
    gru_sequence_fwd(z(T, N, 3 * H), z(T, N), z(H, 3 * H), z(H), z(N, H))
    gru_sequence_fwd_chunked(z(T, N, 3 * H), z(T, N), z(P, H, 3 * H),
                             z(P, H), idx, z(N, H))
    (single, s_args), (chunked, c_args) = lib.calls
    if tensor_core:
        assert single == "mlt_gru_fwd_tc"
        assert s_args[:2] == (code, H)
    else:
        assert single == "mlt_gru_fwd" and s_args[:2] == (code, H)
    assert chunked == "mlt_gru_fwd_chunked"
    assert c_args[:3] == (int(tensor_core), code, H)
    assert [(k.launches, k.tc_launches) for k in (GRU_FWD,
                                                  GRU_FWD_CHUNKED)] == \
        [(1, int(tensor_core))] * 2
