"""The LSTM and GRU at every width the JAX package takes.

JAX's kernel gates send a recurrent layer whose width is a multiple of
128 (float32 or bfloat16) to its Pallas kernel and every other width, and
float16, to the kernel's jnp twin (``madrona_learn_tpu/models/lstm.py``,
``models/gru.py``). The port's gates (``lstm_supported``,
``gru_supported``) are true exactly where a kernel instance is built, H in
(128, 256, 384, 512) in float32, bfloat16 and float16; its modules pick
the kernels or their plain twins by JAX's gate before any launch, on the
card as on the CPU, and keep the kernels' route (which raises on the
card) at a multiple of 128 without an instance. The projection kernels
and the fused step are built at the same four widths: their gates are
JAX's there, and a wider layer takes the unfused sequence route.

- The gates against JAX's for H in {32, 64, 96, 128, 256, 384, 512} and
  each dtype (float16: the port's own choice); the modules' routes (the step, the sequence and both
  policy-batched forms) against JAX's gate up to H = 640, read by
  recording which of the kernel wrappers and twins each form calls.
- The chunked twins' card form (one gathered batched product a step, no
  host sync) against their CPU form (a loop over the chunks).
- The wrappers' operand checks take H = 384 and 512 in every dtype, and
  their launches go to the CUDA-core entry points (a stand-in library),
  but for the bfloat16 LSTM and the bfloat16 and float16 GRU forwards and
  backwards, which take their tensor-core ones; a width without an
  instance is refused.
- An H = 96 GRU and an H = 384 LSTM (float32), carried over from flax
  (``compat/from_jax.py``): the rollout step and the sequence against the
  JAX module, the chunked step and the batched sequence against
  ``jax.vmap`` of the JAX module over the stacked parameters, all within
  1e-5 (float32 sums in another order; JAX runs its jnp twin on the CPU at
  both widths), each chunk bitwise its own policy's step.
- An MLP 32 -> GRU 96 population collects in the policy-chunk layout as on
  the per-policy loop, and learns on the batched path as on the loop
  (``test_torch_chunk_layout``'s and ``test_torch_batched_learn``'s
  checks).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

import madrona_learn_tpu.models as jm
import madrona_learn_tpu_torch as tlt
import madrona_learn_tpu_torch.models as tm
import madrona_learn_tpu_torch.models.gru as gru_model
import madrona_learn_tpu_torch.models.lstm as lstm_model
import madrona_learn_tpu_torch.ops.cuda.gru as gru_mod
import madrona_learn_tpu_torch.ops.cuda.lstm as lstm_mod
import test_torch_batched_learn as batched_learn
import test_torch_chunk_layout as chunk_layout
from madrona_learn_tpu.ops.pallas.gru import gru_supported as jax_gru_supported
from madrona_learn_tpu.ops.pallas.lstm import (
    lstm_proj_supported as jax_lstm_proj_supported,
    lstm_supported as jax_lstm_supported,
)
from madrona_learn_tpu.ops.pallas.policy_step import \
    policy_step_supported as jax_policy_step_supported
from madrona_learn_tpu_torch.compat.from_jax import actor_critic_state_dict
from madrona_learn_tpu_torch.models.common import StackedParams
from madrona_learn_tpu_torch.ops.cuda import KERNELS
from madrona_learn_tpu_torch.ops.cuda.gru import gru_supported
from madrona_learn_tpu_torch.ops.cuda.lstm import (
    bwd_uses_tensor_cores,
    fwd_uses_tensor_cores,
    lstm_proj_supported,
    lstm_supported,
    uses_tensor_cores,
)
from madrona_learn_tpu_torch.ops.cuda.policy_step import \
    policy_step_supported

torch.set_num_threads(1)

F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16
WIDTHS = (32, 64, 96, 128, 256, 384, 512)
DTYPES = {"float32": (F32, jnp.float32), "bfloat16": (BF16, jnp.bfloat16),
          "float16": (F16, jnp.float16)}
INSTANCES = (128, 256, 384, 512)


# -- The gates ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("H", WIDTHS)
def test_gates_are_jaxs(H, dtype):
    """The recurrences' gates equal JAX's in float32 and bfloat16 (true
    where H % 128 == 0); in float16, where JAX takes its twin, they are
    true at the kernels' widths (the float16 instances). The
    projection kernels' and the fused step's gates are JAX's at every
    width up to 512, where their instances are built."""
    tdt, jdt = DTYPES[dtype]
    for port, jax_gate in ((lstm_supported, jax_lstm_supported),
                           (gru_supported, jax_gru_supported)):
        want = H in INSTANCES if tdt == F16 else bool(jax_gate(H, jdt))
        assert port(H, tdt) is want
    for f_in in (128, 256, 512):
        assert lstm_proj_supported(f_in, H, tdt) is (
            H in INSTANCES and bool(jax_lstm_proj_supported(f_in, H, jdt)))
    for f_in in (3, 128, 129):
        assert policy_step_supported(H, f_in, tdt) is (
            H in INSTANCES
            and bool(jax_policy_step_supported(H, f_in, jdt)))
    # bfloat16 takes tensor cores where the wgmma instances are built: the
    # LSTM and GRU forwards and backwards and the projection at every
    # instance's width; float16 the GRU forwards and backwards at every
    # instance's width, the LSTM's at 128 and 256.
    lstm_tc = ((tdt == BF16 and H in INSTANCES)
               or (tdt == F16 and H in (128, 256)))
    gru_tc = tdt in (BF16, F16) and H in INSTANCES
    assert fwd_uses_tensor_cores(tdt, H) is lstm_tc
    assert bwd_uses_tensor_cores(tdt, H) is lstm_tc
    assert uses_tensor_cores(tdt, H) is (tdt == BF16 and H in INSTANCES)
    assert gru_mod.fwd_uses_tensor_cores(tdt, H) is gru_tc
    assert gru_mod.bwd_uses_tensor_cores(tdt, H) is gru_tc


class _Recorder:
    """Stand-ins for the kernel wrappers and twins a module imports: each
    records its name and runs the plain twin (the CPU route)."""

    def __init__(self, monkeypatch, module, names):
        self.calls = []
        for name in names:
            fn = getattr(module, name)
            monkeypatch.setattr(module, name, self._wrap(name, fn))

    def _wrap(self, name, fn):
        def run(*args, **kwargs):
            self.calls.append(name)
            return fn(*args, **kwargs)
        return run


_LSTM_ROUTES = ("lstm_step", "lstm_step_reference", "lstm_sequence",
                "lstm_sequence_reference", "lstm_step_chunked",
                "lstm_step_chunked_reference", "lstm_sequence_chunked",
                "lstm_sequence_chunked_reference")
_GRU_ROUTES = tuple(n.replace("lstm", "gru") for n in _LSTM_ROUTES)


def _drive(kind, H, dtype):
    """A one-layer recurrence of width H over 3 input features, driven
    through its step, sequence, chunked step and batched sequence on tiny
    inputs (2 policies, 2 chunks of 2 rows, T = 2)."""
    torch.manual_seed(0)
    cls = tm.LSTM if kind == "lstm" else tm.GRU
    mods = [cls(3, H, 1, dtype) for _ in range(2)]
    mod = mods[0]
    N, T = 4, 2
    state = mod.init_recurrent_state(N)
    x = torch.randn(N, 3)
    ends = torch.zeros(T, N, 1, dtype=torch.bool)
    with torch.no_grad():
        mod(state, x)
        mod.sequence(state, ends, torch.randn(T, N, 3))
        idx = torch.tensor([1, 0], dtype=torch.int32)
        layout = types.SimpleNamespace(chunk_policy=idx,
                                       chunk_index=idx.long())
        chunked = jax.tree.map(lambda s: s.reshape(2, 2, *s.shape[1:]),
                               state)
        mod.chunked(StackedParams.of(mods), layout, chunked,
                    x.reshape(2, 2, 3))
        mod.batched(StackedParams.of(mods), chunked,
                    torch.zeros(2, T, 2, 1, dtype=torch.bool),
                    torch.randn(2, T, 2, 3))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("H", WIDTHS + (640,))
@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_module_routes_follow_the_gates(monkeypatch, kind, H, dtype):
    """Each form of the module calls the kernel wrapper where JAX's gate
    holds (float16 as float32) and the plain twin where it does not, JAX's
    choice between its kernel and its jnp twin; up to 512 that is the
    port's gate, and at 640, where no instance is built, the layer keeps
    the kernel route (whose wrappers raise on the card) instead of taking
    the twin. Every population form exists at every width."""
    tdt, jdt = DTYPES[dtype]
    module = lstm_model if kind == "lstm" else gru_model
    routes = _LSTM_ROUTES if kind == "lstm" else _GRU_ROUTES
    rec = _Recorder(monkeypatch, module, routes)
    _drive(kind, H, tdt)
    route = (lstm_mod.lstm_kernel_route if kind == "lstm"
             else gru_mod.gru_kernel_route)(H, tdt)
    jax_gate = jax_lstm_supported if kind == "lstm" else jax_gru_supported
    assert route is bool(jax_gate(H, jnp.float32 if tdt == F16 else jdt))
    if H <= 512:
        assert route is (lstm_supported if kind == "lstm"
                         else gru_supported)(H, tdt)
    want = list(routes[0::2] if route else routes[1::2])
    assert rec.calls == want
    mod = (tm.LSTM if kind == "lstm" else tm.GRU)(3, H, 1, tdt)
    assert mod.chunked_supported() and mod.batched_supported()


@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_card_twins_batch_the_chunks(monkeypatch, kind):
    """The chunked twins' card form (``_chunk_batch``: each chunk's weights
    gathered, one batched product a step) against their CPU form (a loop
    over the chunks) at H = 32 over 6 chunks of 5 rows in a shuffled order
    with chunks of index P and -1: ys (and the LSTM's cs) and every
    gradient within 1e-6, the dead chunks' rows NaN and adding to no
    policy, and no host sync (``tolist`` / ``item`` raise while it
    runs)."""
    H, C, T, P = 32, 5, 3, 4
    order = [2, 0, 4, 2, -1, 1]           # policy 3 owns no chunk
    g = torch.Generator().manual_seed(7)
    gates = 4 if kind == "lstm" else 3
    B, N = len(order), len(order) * C
    x = torch.randn(T, N, gates * H, generator=g)
    keep = (torch.rand(T, N, generator=g) > 0.3).float()
    w = torch.randn(P, H, gates * H, generator=g) * H ** -0.5
    b = torch.randn(P, gates * H if kind == "lstm" else H, generator=g)
    states = [torch.randn(N, H, generator=g)
              for _ in range(2 if kind == "lstm" else 1)]
    idx = torch.tensor(order, dtype=torch.int32)
    fn = lstm_mod._sequence if kind == "lstm" else gru_mod._sequence
    live = torch.tensor([0 <= p < P for p in order]).repeat_interleave(C)
    probe = torch.randn(T, N, H, generator=g)

    def run(form):
        leaves = [t.clone().requires_grad_() for t in (x, w, b, *states)]
        outs = form(fn, leaves[0], keep, tuple(leaves[1:3]), idx,
                    tuple(leaves[3:]))
        grads = torch.autograd.grad(
            (outs[0][:, live] * probe[:, live]).sum(), leaves)
        return outs, grads

    want_outs, want_grads = run(lstm_mod._chunked)
    with monkeypatch.context() as m:
        for name in ("tolist", "item"):
            m.setattr(torch.Tensor, name, _no_sync)
        got_outs, got_grads = run(lstm_mod._chunk_batch)
    for got, want in zip(got_outs, want_outs):
        assert got[:, ~live].isnan().all()
        torch.testing.assert_close(got[:, live], want[:, live], rtol=1e-6,
                                   atol=1e-6)
    for got, want in zip(got_grads, want_grads):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert not got_grads[1][3].any() and not got_grads[2][3].any()


def _no_sync(*args, **kwargs):
    raise AssertionError("a host sync in the card's chunked twin")


@pytest.mark.parametrize("H", [256, 384, 512])
def test_fused_options_take_the_unfused_kernels_past_256(H):
    """``fuse_input_proj`` and ``use_fused_step`` hold where their kernels
    are built, H = 128 to 512 as JAX's gates take them; only past 512
    (H = 640, no instance) does the layer take the unfused route."""
    for width, fused in ((H, True), (640, False)):
        lstm = tm.LSTM(width, width, 1, BF16, fuse_input_proj=True)
        assert lstm._fuses_proj(width) is fused
        encoder = tm.RecurrentBackboneEncoder(
            net=tm.MLP(3, width, 1, BF16), rnn=lstm, use_fused_step=True)
        assert encoder._fused_step_applicable(torch.zeros(2, 3)) is fused


# -- The wrappers at H = 384 and 512 -------------------------------------------

def _meta(*shape, dtype):
    return torch.empty(*shape, dtype=dtype, device="meta")


def _shape_check(name, x, dtype, shape):
    """The operand check but for the device (meta tensors stand in)."""
    if x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(name)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("H", [384, 512])
def test_operand_checks_take_the_wide_instances(monkeypatch, H, dtype):
    """The sequence kernels' operand checks take H = 384 and 512 in every
    dtype, single-policy and chunk-indexed (every operand's dtype and
    shape; the device check stands aside for meta tensors), and so do the
    projection kernels' in float32 and bfloat16 (float16 has no projection
    instance, as JAX's gate refuses it); every check refuses H = 640."""
    for mod in (lstm_mod, gru_mod):
        monkeypatch.setattr(mod, "_check", _shape_check)
    tdt = DTYPES[dtype][0]
    T, N, B, P = 2, 8, 2, 3
    m = lambda *s: _meta(*s, dtype=tdt)
    idx = _meta(B, dtype=torch.int32)
    assert lstm_mod._check_inputs(m(T, N, 4 * H), m(T, N), m(H, 4 * H),
                                  m(4 * H), m(N, H), m(N, H)) == (T, N, H)
    assert lstm_mod._check_chunked(
        "lstm", m(T, N, 4 * H), m(T, N), m(P, H, 4 * H), m(P, 4 * H), idx,
        m(N, H), m(N, H)) == (T, N, H, B, N // B, P)
    assert gru_mod._check_inputs(m(T, N, 3 * H), m(T, N), m(H, 3 * H),
                                 m(H), m(N, H)) == (T, N, H)
    assert gru_mod._check_chunked(
        "gru", m(T, N, 3 * H), m(T, N), m(P, H, 3 * H), m(P, H), idx,
        m(N, H)) == (T, N, H, B, N // B, P)
    proj = (m(T, N, 128), m(T, N), m(128, 4 * H), m(H, 4 * H), m(4 * H),
            m(N, H), m(N, H))
    if tdt != F16:
        assert lstm_mod._check_proj_inputs(*proj) == (T, N, 128, H)
    else:
        with pytest.raises(ValueError):
            lstm_mod._check_proj_inputs(*proj)
    W = 640
    with pytest.raises(ValueError):
        lstm_mod._check_inputs(m(T, N, 4 * W), m(T, N), m(W, 4 * W),
                               m(4 * W), m(N, W), m(N, W))
    with pytest.raises(ValueError):
        gru_mod._check_inputs(m(T, N, 3 * W), m(T, N), m(W, 3 * W), m(W),
                              m(N, W))


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


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("H", [384, 512])
def test_wide_launches_take_the_cuda_core_entry_points(monkeypatch, H,
                                                       dtype):
    """At H = 384 and 512 each of the eight wrappers launches its
    CUDA-core entry point with the tensor's dtype code and counts the
    launch, none on tensor cores; but the four LSTM wrappers in bfloat16
    and the four GRU wrappers in bfloat16 and float16 launch their
    tensor-core entry points (the two-block cluster; the chunk-indexed
    ones with tensor_core 1, the single-policy ones with the dtype code)
    and count a tensor-core launch each. The operands stand on the CPU
    here: the library, the operand check, the SM count and the stream are
    stand-ins."""
    tdt = DTYPES[dtype][0]
    code = {F32: 0, BF16: 1, F16: 2}[tdt]
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
    names = ("lstm_sequence_fwd", "lstm_sequence_bwd",
             "lstm_sequence_fwd_chunked", "lstm_sequence_bwd_chunked",
             "gru_sequence_fwd", "gru_sequence_bwd",
             "gru_sequence_fwd_chunked", "gru_sequence_bwd_chunked")
    kernels = {k.name: k for k in KERNELS if k.name in names}
    for k in kernels.values():
        monkeypatch.setattr(k, "launches", 0)
        monkeypatch.setattr(k, "tc_launches", 0)
    T, N, P = 2, 4, 2
    z = lambda *s: torch.zeros(*s, dtype=tdt)
    idx = torch.tensor([1, 0], dtype=torch.int32)
    seq = z(T, N, H)
    lstm_mod.lstm_sequence_fwd(z(T, N, 4 * H), z(T, N), z(H, 4 * H),
                               z(4 * H), z(N, H), z(N, H))
    lstm_mod.lstm_sequence_bwd(z(T, N, 4 * H), z(T, N), z(H, 4 * H),
                               z(4 * H), z(N, H), z(N, H), seq, seq, seq)
    lstm_mod.lstm_sequence_fwd_chunked(z(T, N, 4 * H), z(T, N),
                                       z(P, H, 4 * H), z(P, 4 * H), idx,
                                       z(N, H), z(N, H))
    lstm_mod.lstm_sequence_bwd_chunked(z(T, N, 4 * H), z(T, N),
                                       z(P, H, 4 * H), z(P, 4 * H), idx,
                                       z(N, H), z(N, H), seq, seq, seq)
    gru_mod.gru_sequence_fwd(z(T, N, 3 * H), z(T, N), z(H, 3 * H), z(H),
                             z(N, H))
    gru_mod.gru_sequence_bwd(z(T, N, 3 * H), z(T, N), z(H, 3 * H), z(H),
                             z(N, H), seq, seq)
    gru_mod.gru_sequence_fwd_chunked(z(T, N, 3 * H), z(T, N),
                                     z(P, H, 3 * H), z(P, H), idx, z(N, H))
    gru_mod.gru_sequence_bwd_chunked(z(T, N, 3 * H), z(T, N),
                                     z(P, H, 3 * H), z(P, H), idx, z(N, H),
                                     seq, seq)
    tc_lstm = tdt == BF16
    tc_gru = tdt in (BF16, F16)
    tc_names = ((("lstm_sequence_fwd", "lstm_sequence_bwd",
                  "lstm_sequence_fwd_chunked", "lstm_sequence_bwd_chunked")
                 if tc_lstm else ())
                + (("gru_sequence_fwd", "gru_sequence_bwd",
                    "gru_sequence_fwd_chunked", "gru_sequence_bwd_chunked")
                   if tc_gru else ()))
    assert [c[0] for c in lib.calls] == [
        "mlt_lstm_fwd_tc" if tc_lstm else "mlt_lstm_fwd",
        "mlt_lstm_bwd_tc" if tc_lstm else "mlt_lstm_bwd",
        "mlt_lstm_fwd_chunked", "mlt_lstm_bwd_chunked",
        "mlt_gru_fwd_tc" if tc_gru else "mlt_gru_fwd",
        "mlt_gru_bwd_tc" if tc_gru else "mlt_gru_bwd",
        "mlt_gru_fwd_chunked", "mlt_gru_bwd_chunked"]
    for (name, args), kernel in zip(lib.calls, names):
        if name in ("mlt_lstm_fwd_tc", "mlt_lstm_bwd_tc"):
            assert args[:3] == (code, H, 0), name   # (dtype, hidden, f_in)
            continue
        # (dtype, hidden, ...) or, chunked, (tensor_core, dtype, hidden).
        head = args[1:3] if name.endswith("_chunked") else args[:2]
        assert head == (code, H), name
        if name.endswith("_chunked"):
            assert args[0] == int(kernel in tc_names), name
    assert {n: (k.launches, k.tc_launches) for n, k in kernels.items()} == \
        {n: (1, int(n in tc_names)) for n in names}


# -- An H = 96 GRU and an H = 384 LSTM against JAX ------------------------------

F_IN = 16
CASES = [("gru", 96), ("lstm", 384)]
TOL = dict(rtol=1e-5, atol=1e-5)


def _recurrence(kind, H, seed, policies=3):
    """JAX's float32 module, its parameters for ``policies`` policies
    (nonzero biases) stacked, and the port's module a policy, carried
    over."""
    cls = jm.LSTM if kind == "lstm" else jm.GRU
    mod_j = cls(num_hidden_channels=H, num_layers=1, dtype=jnp.float32,
                use_pallas=True)
    rng = np.random.default_rng(seed)
    params, mods = [], []
    for p in range(policies):
        state = mod_j.init_recurrent_state(2)
        flax = mod_j.init(random.PRNGKey(seed + p), state,
                          jnp.zeros((2, F_IN), jnp.float32), False)["params"]
        flax = jax.tree.map(
            lambda l: jnp.asarray(np.asarray(l) + 0.3 * rng.normal(
                size=l.shape), jnp.float32) if l.ndim == 1 else l, flax)
        params.append(flax)
        mod_t = getattr(tm, kind.upper())(F_IN, H, 1, F32)
        mod_t.load_state_dict({k: torch.from_numpy(v) for k, v in
                               actor_critic_state_dict(flax).items()})
        mods.append(mod_t)
    return (mod_j, jax.tree.map(lambda *l: jnp.stack(l), *params), mods,
            rng)


def _state(kind, H, rng, *lead):
    """A float32 start state [*lead, 1, H] (a (c, h) pair for the LSTM)."""
    make = lambda: (0.5 * rng.normal(size=(*lead, 1, H))).astype(np.float32)
    np_state = (make(), make()) if kind == "lstm" else make()
    return (jax.tree.map(jnp.asarray, np_state),
            jax.tree.map(torch.from_numpy, np_state))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kind,H", CASES)
def test_single_policy_step_and_sequence_match_jax(kind, H):
    """The rollout step and the sequence (clearing after ``seq_ends``) of
    one policy against the JAX module's, and the step bitwise the
    sequence's first step."""
    mod_j, stacked, mods, rng = _recurrence(kind, H, 1, policies=1)
    params = jax.tree.map(lambda l: l[0], stacked)
    N, T = 6, 5
    j_state, t_state = _state(kind, H, rng, N)
    xs = rng.normal(size=(T, N, F_IN)).astype(np.float32)
    ends = rng.random((T, N, 1)) < 0.25
    out_j, new_j = mod_j.apply({"params": params}, j_state,
                               jnp.asarray(xs[0]), False)
    seq_j = mod_j.apply({"params": params}, j_state, jnp.asarray(ends),
                        jnp.asarray(xs), False, method="sequence")
    with torch.no_grad():
        out_t, new_t = mods[0](t_state, torch.from_numpy(xs[0]))
        seq_t = mods[0].sequence(t_state, torch.from_numpy(ends),
                                 torch.from_numpy(xs))
    _close(out_t, out_j)
    for g, w in zip(jax.tree.leaves(new_t), jax.tree.leaves(new_j)):
        _close(g, w)
    _close(seq_t, seq_j)
    assert torch.equal(out_t, seq_t[0])


@pytest.mark.parametrize("kind,H", CASES)
def test_chunked_step_matches_jax_vmap(kind, H):
    """The rollout step over 4 chunks of 5 rows in the order [2, 0, 1, 2]
    against ``jax.vmap`` of the JAX module over each chunk's policy's
    parameters, and each chunk bitwise its policy's own step."""
    mod_j, stacked, mods, rng = _recurrence(kind, H, 10)
    order = [2, 0, 1, 2]
    B, C = len(order), 5
    j_state, t_state = _state(kind, H, rng, B, C)
    x = rng.normal(size=(B, C, F_IN)).astype(np.float32)
    per_chunk = jax.tree.map(lambda l: l[jnp.asarray(order)], stacked)
    out_j, new_j = jax.jit(jax.vmap(
        lambda p, s, x: mod_j.apply({"params": p}, s, x, False)))(
            per_chunk, j_state, jnp.asarray(x))
    idx = torch.tensor(order, dtype=torch.int32)
    layout = types.SimpleNamespace(chunk_policy=idx, chunk_index=idx.long())
    with torch.no_grad():
        out_t, new_t = mods[0].chunked(StackedParams.of(mods), layout,
                                       t_state, torch.from_numpy(x))
    assert out_t.shape == (B, C, H)
    _close(out_t, out_j)
    for g, w in zip(jax.tree.leaves(new_t), jax.tree.leaves(new_j)):
        _close(g, w)
    for b, p in enumerate(order):
        with torch.no_grad():
            own, _ = mods[p](jax.tree.map(lambda s: s[b], t_state),
                             torch.from_numpy(x[b]))
        assert torch.equal(out_t[b], own)


@pytest.mark.parametrize("kind,H", CASES)
def test_batched_sequence_and_gradients_match_jax_vmap(kind, H):
    """The sequence over 3 policies' [T = 4, mb = 5] minibatches, clearing
    after ``seq_ends``, against ``jax.vmap`` of the JAX sequence, with the
    gradients of a probe's dot product against ``jax.vjp``'s (every
    parameter of every policy, 1e-5 relative + 1e-5 of the largest)."""
    mod_j, stacked, mods, rng = _recurrence(kind, H, 20)
    Pn, T, mb = 3, 4, 5
    j_state, t_state = _state(kind, H, rng, Pn, mb)
    xs = rng.normal(size=(Pn, T, mb, F_IN)).astype(np.float32)
    ends = rng.random((Pn, T, mb, 1)) < 0.25
    probe = rng.normal(size=(Pn, T, mb, H)).astype(np.float32)

    def loss(params):
        ys = jax.vmap(lambda p, s, e, x: mod_j.apply(
            {"params": p}, s, e, x, False, method="sequence"))(
                params, j_state, jnp.asarray(ends), jnp.asarray(xs))
        return jnp.sum(ys * probe), ys

    (_, want), grads_j = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        stacked)
    params = StackedParams.of(mods)
    leaves = {k: v.clone().requires_grad_() for k, v in
              params.leaves.items()}
    got = mods[0].batched(StackedParams(leaves), t_state,
                          torch.from_numpy(ends), torch.from_numpy(xs))
    _close(got.detach(), want)
    (got * torch.from_numpy(probe)).sum().backward()
    flat_j = actor_critic_state_dict(grads_j)
    for name, leaf in leaves.items():
        want_g = np.asarray(flat_j[name])
        scale = np.abs(want_g).max()
        np.testing.assert_allclose(leaf.grad.numpy(), want_g, rtol=1e-5,
                                   atol=1e-5 * max(scale, 1.0), err_msg=name)
    for p in range(Pn):
        with torch.no_grad():
            own = mods[p].sequence(jax.tree.map(lambda s: s[p], t_state),
                                   torch.from_numpy(ends[p]),
                                   torch.from_numpy(xs[p]))
        assert torch.equal(got[p].detach(), own)


# -- An H = 96 GRU population ------------------------------------------------

MLP_H, GRU_H = 32, 96


def _gru96_model(generator=None):
    """MLP 32 -> GRU 96, float32."""
    net = tm.MLP(2, MLP_H, 1, F32, generator=generator)
    return tm.ActorCritic(
        backbone=tm.BackboneShared(
            prefix=lambda obs: torch.cat([obs["time"], obs["acc"]], -1),
            encoder=tm.RecurrentBackboneEncoder(
                net=net, rnn=tm.GRU(MLP_H, GRU_H, 1, F32,
                                    generator=generator))),
        actor=tm.DictActor({"move": tm.DenseLayerDiscreteActor(
            tlt.DiscreteActionsConfig(actions_num_buckets=[5]), GRU_H, F32,
            weight_init=tm.common.orthogonal(1.0), generator=generator)}),
        critic=tm.DenseLayerCritic(GRU_H, F32, generator=generator))


def test_gru96_population_collects_chunked_as_the_loop(monkeypatch):
    """``test_torch_chunk_layout``'s population (the duel, per-policy obs
    normalizers, matchmaking) with MLP 32 -> GRU 96: the chunked rollout
    takes the layout, on the twins, and equals the per-policy loop."""
    monkeypatch.setattr(chunk_layout, "_model", lambda lstm, seed:
                        _gru96_model(torch.Generator().manual_seed(seed)))
    chunk_layout.test_chunked_rollout_equals_the_per_policy_loop(True, False)


def test_gru96_population_learns_batched_as_the_loop(monkeypatch):
    """``test_torch_batched_learn``'s population (4 train and 2 past
    policies, two epochs of two minibatches) with MLP 32 -> GRU 96: the
    batched learn is taken, on the twins, and equals the loop."""
    monkeypatch.setattr(batched_learn, "_actor_critic",
                        lambda p, tower="lstm", dtype=F32: _gru96_model())
    batched, _, _ = batched_learn.check_batched_learn("uniform")
    assert batched.batched_learn
