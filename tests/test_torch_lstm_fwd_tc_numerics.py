"""The arithmetic of the bf16 LSTM forwards on tensor cores (``csrc/lstm.cu``:
lstm_fwd_tc_kernel), held on the CPU to the contracts that define it, and
the rule that routes a call to it.

A plain-torch emulation of the kernel's arithmetic: bf16 operands, f32
products summed one 64-deep slice at a time in the ring's K order (each
slice's products added in k order, element by element, so that a row's
result depends on nothing but its own inputs), ``round(x . Wi)`` to bf16
before ``+ h . Wr`` in the projection, then ``x_proj + acc + b``; gate math
in f32, ys and cs rounded to bf16, the carry cleared after a step whose
keep is 0. It is held

- against ``lstm_sequence_reference`` / ``lstm_sequence_proj_reference``
  under the chip check's forward rule in bf16 (chip_smoke.py
  ``TOL[("fwd", "bfloat16")]``: max |diff| <= 3.2e-2);
- against the JAX package's ``lstm_sequence`` / ``lstm_sequence_proj``
  (the Pallas forward kernels in interpret mode) under the same rule;
- to itself, bitwise: a T = 1 step from the cleared state equals step t of
  the T = 16 pass, and N = 70 equals N = 16 on the rows they share.

At H = 384 and 512 the kernel splits the units over a cluster of two
blocks, each summing the full K = H of h . Wr in the same slice order, so
a row's arithmetic is the same emulation; the wide cases hold it to the
plain forward and to JAX at T <= 4, to itself bitwise (the T = 1 step
against step t of T = 8, N = 70 against N = 16, a chunk's rows of the
chunk-indexed form against the single-policy form), and the wrappers'
routes: the forwards and the backwards on the tensor-core entry points.

Inputs come from numpy seeds, at N = 70 (ragged against the kernel's rows
a block), H = 128, 384 and 512, F = 128 and 256.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_learn_tpu.ops.pallas.lstm import lstm_sequence as jax_lstm_seq
from madrona_learn_tpu.ops.pallas.lstm import (
    lstm_sequence_proj as jax_lstm_proj,
)
from madrona_learn_tpu_torch.ops.cuda import KERNELS
from madrona_learn_tpu_torch.ops.cuda import lstm as lstm_mod
from madrona_learn_tpu_torch.ops.cuda.lstm import (
    LSTM_BWD,
    LSTM_BWD_CHUNKED,
    LSTM_FWD,
    LSTM_FWD_CHUNKED,
    LSTM_PROJ_FWD,
    _cell,
    bwd_uses_tensor_cores,
    fwd_uses_tensor_cores,
    lstm_sequence_bwd,
    lstm_sequence_bwd_chunked,
    lstm_sequence_fwd,
    lstm_sequence_fwd_chunked,
    lstm_sequence_fwd_chunked_reference,
    lstm_sequence_proj_fwd,
    lstm_sequence_proj_reference,
    lstm_sequence_reference,
    uses_tensor_cores,
)

torch.set_num_threads(1)

BF16 = torch.bfloat16
F32 = torch.float32
K_SLICE = 64        # depth of a weight slice in the kernel's ring
# The chip check's forward rule in bf16 (chip_smoke.py TOL[("fwd",
# "bfloat16")]): max |diff| <= 3.2e-2.
FWD_ATOL = 3.2e-2


def _inputs(seed, T, N, H, F=None):
    """bf16 operands (the distribution chip_smoke.py draws)."""
    rng = np.random.default_rng(seed)

    def bf(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(BF16)

    width = 4 * H if F is None else F
    return dict(
        x=bf(rng.normal(size=(T, N, width))),
        keep=bf(rng.random((T, N)) > 0.2),
        wi=None if F is None else bf(rng.normal(size=(F, 4 * H)) / np.sqrt(F)),
        wr=bf(rng.normal(size=(H, 4 * H)) / np.sqrt(H)),
        bias=bf(rng.normal(size=(4 * H,))),
        c0=bf(rng.normal(size=(N, H))),
        h0=bf(rng.normal(size=(N, H))))


def _slices(a, b, acc=None):
    """acc (+)= a [N, K] . b [K, M] of bf16 (or f16) values in f32, whose
    products are exact: one K_SLICE-deep
    slice at a time in K order, each slice's products summed in k order and
    then added to acc."""
    a, b = a.float(), b.float()
    for k0 in range(0, a.shape[1], K_SLICE):
        part = a[:, k0:k0 + 1] * b[k0]
        for k in range(k0 + 1, min(k0 + K_SLICE, a.shape[1])):
            part = part + a[:, k:k + 1] * b[k]
        acc = part if acc is None else acc + part
    return acc


def emulate_tc_fwd(x, keep, wi, wr, bias, c0, h0, pres=None):
    """The tensor-core forward's arithmetic: (ys, cs), each [T, N, H] in
    the operands' element type (bf16; float16 without the projection, the
    f16 ``wgmma`` instance). ``pres``, where given, is a list that receives
    each step's pre-activations [N, 4H] (f32), in step order."""
    dt = x.dtype
    b32 = bias.float()
    zero = torch.zeros((), dtype=dt)
    c, h = c0, h0
    ys, cs = [], []
    for t in range(x.shape[0]):
        if wi is None:
            pre = (x[t].float() + _slices(h, wr)) + b32
        else:
            xp = _slices(x[t], wi).to(dt).float()
            pre = _slices(h, wr, acc=xp) + b32
        if pres is not None:
            pres.append(pre)
        gi, gf, gg, go = pre.chunk(4, dim=-1)
        new_c = torch.sigmoid(gf) * c.float() + torch.sigmoid(gi) * torch.tanh(
            gg)
        new_h = torch.sigmoid(go) * torch.tanh(new_c)
        c_t, h_t = new_c.to(dt), new_h.to(dt)
        ys.append(h_t)
        cs.append(c_t)
        kept = keep[t][:, None] > 0.5
        c = torch.where(kept, c_t, zero)
        h = torch.where(kept, h_t, zero)
    return torch.stack(ys), torch.stack(cs)


def _plain_states(x, keep, wi, wr, bias, c0, h0):
    """ys and cs of the plain forward."""
    x_proj = x if wi is None else (x.float() @ wi.float()).to(BF16)
    c, h = c0, h0
    ys, cs = [], []
    for t in range(x.shape[0]):
        new_c, new_h = _cell(x_proj[t], wr.float(), bias.float(), c, h)
        ys.append(new_h)
        cs.append(new_c)
        mask = keep[t][:, None] > 0.5
        c = torch.where(mask, new_c, torch.zeros((), dtype=BF16))
        h = torch.where(mask, new_h, torch.zeros((), dtype=BF16))
    return torch.stack(ys), torch.stack(cs)


def _jax_ys(args):
    def j(t):
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)

    if args["wi"] is None:
        ys = jax_lstm_seq(j(args["x"]), j(args["keep"]), j(args["wr"]),
                          j(args["bias"]), j(args["c0"]), j(args["h0"]), True)
    else:
        ys = jax_lstm_proj(j(args["x"]), j(args["keep"]), j(args["wi"]),
                           j(args["wr"]), j(args["bias"]), j(args["c0"]),
                           j(args["h0"]), True)
    return torch.from_numpy(np.asarray(ys, np.float32))


def _within(got, want, what):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= FWD_ATOL, f"{what}: max |diff| {err:.3e} above {FWD_ATOL}"


CASES = [(5, 70, 128, None), (4, 70, 128, 128), (4, 70, 128, 256),
         (4, 70, 384, None), (3, 70, 512, None), (3, 70, 384, 384),
         (2, 70, 512, 512)]


@pytest.mark.parametrize("T,N,H,F", CASES)
def test_tc_lstm_fwd_arithmetic_meets_the_plain_contract(T, N, H, F):
    args = _inputs(70 + T + (F or 0), T, N, H, F)
    ys, cs = emulate_tc_fwd(**args)
    if F is None:
        plain = lstm_sequence_reference(args["x"], args["keep"], args["wr"],
                                        args["bias"], args["c0"], args["h0"])
    else:
        plain = lstm_sequence_proj_reference(**args)
    _within(ys, plain, "ys vs plain")
    want_ys, want_cs = _plain_states(**args)
    assert torch.equal(want_ys, plain)
    _within(cs, want_cs, "cs vs plain")


@pytest.mark.parametrize("T,N,H,F", CASES)
def test_tc_lstm_fwd_arithmetic_matches_the_pallas_forward(T, N, H, F):
    args = _inputs(80 + T + (F or 0), T, N, H, F)
    ys, _ = emulate_tc_fwd(**args)
    _within(ys, _jax_ys(args), "ys vs Pallas")


def _step_equals_sequence_step(T, N, H, F, seed):
    args = _inputs(seed, T, N, H, F)
    ys, cs = emulate_tc_fwd(**args)
    keep = args["keep"]
    zero = torch.zeros((), dtype=BF16)
    after_clear = next(t for t in range(1, T) if (keep[t - 1] < 0.5).any())
    for t in sorted({0, 1, after_clear, T // 2, T - 1}):
        if t == 0:
            c_in, h_in = args["c0"], args["h0"]
        else:
            kept = keep[t - 1][:, None] > 0.5
            c_in = torch.where(kept, cs[t - 1], zero)
            h_in = torch.where(kept, ys[t - 1], zero)
        step = dict(args, x=args["x"][t:t + 1], keep=keep[t:t + 1], c0=c_in,
                    h0=h_in)
        ys_1, cs_1 = emulate_tc_fwd(**step)
        assert torch.equal(ys_1[0], ys[t]), t
        assert torch.equal(cs_1[0], cs[t]), t


@pytest.mark.parametrize("F", [None, 256])
def test_tc_lstm_fwd_step_equals_its_sequence_step(F):
    """A T = 1 call from the cleared state after step t - 1 gives bitwise
    step t of the T = 16 call: the rollout step and the update pass are one
    kernel, so PPO's ratio starts at exactly 1."""
    _step_equals_sequence_step(16, 70, 128, F, 90 + (F or 0))


@pytest.mark.parametrize("H", [384, 512])
def test_tc_lstm_fwd_wide_step_equals_its_sequence_step(H):
    """The same at H = 384 and 512 (the two-block cluster's rows), T = 8."""
    _step_equals_sequence_step(8, 70, H, None, 90 + H)


@pytest.mark.parametrize("H,F", [(384, 1536), (512, 512)])
def test_tc_lstm_proj_fwd_wide_step_equals_its_sequence_step(H, F):
    """The projection forward's cluster the same way, T = 6 (F = 4H: one
    x buffer; F = H: two)."""
    _step_equals_sequence_step(6, 40, H, F, 91 + H)


def _rows_do_not_depend_on_the_batch(H, F, seed):
    T, N, rows = 4, 70, 16
    args = _inputs(seed, T, N, H, F)
    ys, cs = emulate_tc_fwd(**args)
    sub = dict(args, x=args["x"][:, :rows], keep=args["keep"][:, :rows],
               c0=args["c0"][:rows], h0=args["h0"][:rows])
    ys_s, cs_s = emulate_tc_fwd(**sub)
    assert torch.equal(ys[:, :rows], ys_s)
    assert torch.equal(cs[:, :rows], cs_s)


@pytest.mark.parametrize("F", [None, 256])
def test_tc_lstm_fwd_rows_do_not_depend_on_the_batch(F):
    """N = 70 (ragged against the kernel's rows a block) and N = 16 give
    bitwise the same ys and cs on the rows they share."""
    _rows_do_not_depend_on_the_batch(128, F, 95 + (F or 0))


@pytest.mark.parametrize("H", [384, 512])
def test_tc_lstm_fwd_wide_rows_do_not_depend_on_the_batch(H):
    _rows_do_not_depend_on_the_batch(H, None, 95 + H)


@pytest.mark.parametrize("H", [384, 512])
def test_tc_lstm_proj_fwd_wide_rows_do_not_depend_on_the_batch(H):
    """The projection forward's cluster the same way (F = H)."""
    _rows_do_not_depend_on_the_batch(H, H, 96 + H)


def emulate_tc_fwd_chunked(x, keep, wr, bias, idx, c0, h0):
    """The chunk-indexed forward's arithmetic: chunk b of C rows through
    ``emulate_tc_fwd`` with policy idx[b]'s weights, NaN rows for an index
    outside [0, P)."""
    C = x.shape[1] // idx.shape[0]
    ys = torch.full((x.shape[0], x.shape[1], wr.shape[1]), float("nan"),
                    dtype=x.dtype)
    cs = ys.clone()
    for b, p in enumerate(idx.tolist()):
        if not 0 <= p < wr.shape[0]:
            continue
        r = slice(b * C, (b + 1) * C)
        ys[:, r], cs[:, r] = emulate_tc_fwd(x[:, r], keep[:, r], None, wr[p],
                                            bias[p], c0[r], h0[r])
    return ys, cs


@pytest.mark.parametrize("H", [384, 512])
def test_tc_lstm_fwd_wide_chunked_rows_are_single_rows(H):
    """The chunk-indexed form at H = 384 / 512 (chunks of 35 rows, ragged
    against the 32-row tile, a chunk of index P): within the forward rule of
    its plain twin, its NaN chunk NaN in both, and every other chunk's rows
    bitwise the single-policy emulation over that chunk alone."""
    T, C, P = 3, 35, 2
    order = [1, 0, P, 1]
    rng = np.random.default_rng(H)

    def bf(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(BF16)

    N = C * len(order)
    x, keep = bf(rng.normal(size=(T, N, 4 * H))), bf(rng.random((T, N)) > 0.2)
    wr = bf(rng.normal(size=(P, H, 4 * H)) / np.sqrt(H))
    bias = bf(rng.normal(size=(P, 4 * H)))
    c0, h0 = bf(rng.normal(size=(N, H))), bf(rng.normal(size=(N, H)))
    idx = torch.tensor(order, dtype=torch.int32)
    ys, cs = emulate_tc_fwd_chunked(x, keep, wr, bias, idx, c0, h0)
    want = lstm_sequence_fwd_chunked_reference(x, keep, wr, bias, idx, c0, h0)
    bad = torch.tensor([p == P for p in order]).repeat_interleave(C)
    for got, ref in zip((ys, cs), want):
        assert got[:, bad].isnan().all() and ref[:, bad].isnan().all()
        _within(got[:, ~bad], ref[:, ~bad], "chunked vs plain")
    for b, p in enumerate(order):
        if p == P:
            continue
        r = slice(b * C, (b + 1) * C)
        one = emulate_tc_fwd(x[:, r], keep[:, r], None, wr[p], bias[p],
                             c0[r], h0[r])
        assert torch.equal(one[0], ys[:, r]) and torch.equal(one[1], cs[:, r])


class _FakeLibrary:
    """Records which forward entry point a wrapper called, and with what."""

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
    monkeypatch.setattr(lstm_mod, "library", lambda: lib)
    monkeypatch.setattr(lstm_mod, "_check", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    return lib


@pytest.mark.parametrize("dtype,H,F,tensor_core", [
    (BF16, 256, None, True),     # the update minibatch and rollout step
    (BF16, 128, None, True),
    (BF16, 256, 256, True),      # the fused trunk's update minibatch
    (BF16, 128, 512, True),      # F = 4H: one x buffer
    (F32, 256, None, False),     # float32 stays on CUDA cores
    (F32, 128, 256, False),
    (BF16, 384, None, True),     # the two-block cluster
    (BF16, 512, None, True),     # infer_512's rollout step
    (F32, 512, None, False),
    (BF16, 384, 384, True),      # the projection's two-block cluster
    (BF16, 512, 512, True),      # headline_pbt_fused_512's learn step
    (F32, 512, 2048, False),
    (torch.float16, 384, None, False),   # float16 at 384 / 512: CUDA cores
    (torch.float16, 256, None, True),    # headline_fp16's f16 wgmma
    (torch.float16, 128, None, True),
])
def test_lstm_fwd_path_rule(monkeypatch, dtype, H, F, tensor_core):
    """The forward wrappers take the route the rule names, and count a
    launch, and a tensor-core launch where they took that route. The
    operands stand on the CPU here: the library, the operand check and the
    stream are stand-ins."""
    rule = fwd_uses_tensor_cores if F is None else uses_tensor_cores
    assert rule(dtype, H) is tensor_core
    lib = _stand_in_card(monkeypatch)
    kernel = LSTM_FWD if F is None else LSTM_PROJ_FWD
    monkeypatch.setattr(kernel, "launches", 0)
    monkeypatch.setattr(kernel, "tc_launches", 0)
    T, N = 2, 8
    state = torch.zeros(N, H, dtype=dtype)
    if F is None:
        ys, cs = lstm_sequence_fwd(
            torch.zeros(T, N, 4 * H, dtype=dtype),
            torch.ones(T, N, dtype=dtype), torch.zeros(H, 4 * H, dtype=dtype),
            torch.zeros(4 * H, dtype=dtype), state, state)
        want = "mlt_lstm_fwd_tc" if tensor_core else "mlt_lstm_fwd"
    else:
        ys, cs = lstm_sequence_proj_fwd(
            torch.zeros(T, N, F, dtype=dtype), torch.ones(T, N, dtype=dtype),
            torch.zeros(F, 4 * H, dtype=dtype),
            torch.zeros(H, 4 * H, dtype=dtype),
            torch.zeros(4 * H, dtype=dtype), state, state)
        want = "mlt_lstm_fwd_tc" if tensor_core else "mlt_lstm_proj_fwd"
    assert lib.calls == [want]
    assert ys.shape == cs.shape == (T, N, H) and ys.dtype == dtype
    assert (kernel.launches, kernel.tc_launches) == (1, int(tensor_core))


@pytest.mark.parametrize("F", [None, 256])
def test_tc_lstm_fwd_reads_the_weights_as_they_stand(monkeypatch, F):
    """The tensor-core forward hands the kernel the weights' own storage
    (its TMA boxes are wgmma's MN-major A operand): a rollout step makes no
    transposed copy of Wr (or Wi)."""
    lib = _stand_in_card(monkeypatch)
    T, N, H = 1, 8, 256
    wr = torch.zeros(H, 4 * H, dtype=BF16)
    state = torch.zeros(N, H, dtype=BF16)
    keep = torch.ones(T, N, dtype=BF16)
    bias = torch.zeros(4 * H, dtype=BF16)
    if F is None:
        lstm_sequence_fwd(torch.zeros(T, N, 4 * H, dtype=BF16), keep, wr,
                          bias, state, state)
        wi = wr
    else:
        wi = torch.zeros(F, 4 * H, dtype=BF16)
        lstm_sequence_proj_fwd(torch.zeros(T, N, F, dtype=BF16), keep, wi,
                               wr, bias, state, state)
    (args,) = lib.args
    # dtype, hidden, f_in, x, keep, wi, wr, ...
    assert args[:3] == (1, H, F or 0)
    assert args[5:7] == (wi.data_ptr(), wr.data_ptr())


def test_lstm_fwd_wrappers_refuse_what_no_kernel_takes():
    """Tensors off the CPU go to the forward kernel wrappers, which raise on
    what neither path takes (meta tensors are never on the card) instead of
    falling back."""
    before = {k.name: (k.launches, k.tc_launches) for k in KERNELS}

    def meta(*shape, dtype=BF16):
        return torch.empty(*shape, dtype=dtype, device="meta")

    T, N = 2, 8
    for H in (256, 192):       # operand on no card; no kernel at H = 192
        with pytest.raises(ValueError):
            lstm_sequence_fwd(meta(T, N, 4 * H), meta(T, N), meta(H, 4 * H),
                              meta(4 * H), meta(N, H), meta(N, H))
    for F in (256, 192):       # operand on no card; F not a multiple of 128
        with pytest.raises(ValueError):
            lstm_sequence_proj_fwd(
                meta(T, N, F), meta(T, N), meta(F, 1024), meta(256, 1024),
                meta(1024), meta(N, 256), meta(N, 256))
    assert {k.name: (k.launches, k.tc_launches) for k in KERNELS} == before


@pytest.mark.parametrize("H", [384, 512])
def test_wide_bf16_forwards_take_tensor_cores_backwards_cuda_cores(
        monkeypatch, H):
    """At H = 384 and 512 in bf16 the two forwards launch their
    tensor-core entry points (the chunk-indexed one with tensor_core 1) and
    count a tensor-core launch each; so do the two backwards (the
    two-block cluster's instances: dtype code 1, the chunk-indexed one with
    tensor_core 1). Operands stand on the CPU: the library, the operand
    check, the SM count and the stream are stand-ins."""
    lib = _stand_in_card(monkeypatch)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device=None: types.SimpleNamespace(
                            multi_processor_count=132))
    kernels = (LSTM_FWD, LSTM_FWD_CHUNKED, LSTM_BWD, LSTM_BWD_CHUNKED)
    for k in kernels:
        monkeypatch.setattr(k, "launches", 0)
        monkeypatch.setattr(k, "tc_launches", 0)
    assert fwd_uses_tensor_cores(BF16, H) and bwd_uses_tensor_cores(BF16, H)
    assert uses_tensor_cores(BF16, H)     # the projection's cluster too
    T, N, P = 2, 8, 2

    def z(*shape):
        return torch.zeros(*shape, dtype=BF16)

    idx = torch.tensor([1, 0], dtype=torch.int32)
    seq = z(T, N, H)
    lstm_sequence_fwd(z(T, N, 4 * H), z(T, N), z(H, 4 * H), z(4 * H),
                      z(N, H), z(N, H))
    lstm_sequence_fwd_chunked(z(T, N, 4 * H), z(T, N), z(P, H, 4 * H),
                              z(P, 4 * H), idx, z(N, H), z(N, H))
    lstm_sequence_bwd(z(T, N, 4 * H), z(T, N), z(H, 4 * H), z(4 * H),
                      z(N, H), z(N, H), seq, seq, seq)
    lstm_sequence_bwd_chunked(z(T, N, 4 * H), z(T, N), z(P, H, 4 * H),
                              z(P, 4 * H), idx, z(N, H), z(N, H), seq, seq,
                              seq)
    assert lib.calls == ["mlt_lstm_fwd_tc", "mlt_lstm_fwd_chunked",
                         "mlt_lstm_bwd_tc", "mlt_lstm_bwd_chunked"]
    fwd_tc, fwd_chunked, bwd, bwd_chunked = lib.args
    assert fwd_tc[:3] == (1, H, 0)            # dtype, hidden, f_in
    assert fwd_chunked[:3] == (1, 1, H)
    assert bwd[:4] == (1, H, 0, 3)          # dtype, hidden, f_in, phases
    assert bwd_chunked[:3] == (1, 1, H)
    assert [(k.launches, k.tc_launches) for k in kernels] == [
        (1, 1), (1, 1), (1, 1), (1, 1)]
