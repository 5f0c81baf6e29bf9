"""The fused trunk's kernels at H = 384 and 512 against the JAX package.

The fused rollout step (``fused_policy_step`` and its chunk-indexed
instance) and the projection LSTM (``lstm_sequence_proj`` forward and
backward, and their chunk-indexed instances) are built at every width
JAX's gates take up to 512 (``policy_step_supported``,
``lstm_proj_supported``). On the CPU the port's entry points take their
plain twins, and the JAX package runs its Pallas kernels in interpret
mode. Inputs are made with numpy from a seed, at small sizes (8-16 rows,
chunks of 4-8 rows of 3 policies, T = 3, one or two MLP layers).

Tolerances:

- float32: 1e-5, times the largest |value| compared where that exceeds 1
  (the same f32 math, with products and row sums added in another order;
  the gradients are sums over every row and step);
- bfloat16: one bf16 ulp of the largest value compared (2^(e - 7) for a
  largest |value| in [2^e, 2^(e + 1))): the two sides round to bf16 at the
  same points, and a last-bit f32 difference before a rounding can move a
  value by one ulp.

A test carries a ``RecurrentBackboneEncoder`` with ``use_fused_step``
and ``fuse_input_proj`` at H = 512 over from flax (``compat/from_jax.py``),
holds its rollout step and its sequence pass to JAX's module, and counts
the calls that show the port routes both to the fused functions at that
width. The last holds the projection's product witness (the card's
recompute-order check) to its entry points on a stand-in library.
"""

import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

import madrona_learn_tpu.models as jm
import madrona_learn_tpu_torch.models as tm
import madrona_learn_tpu_torch.ops.cuda.lstm as lstm_mod
import madrona_learn_tpu_torch.models.actor_critic as ac_mod
import madrona_learn_tpu_torch.models.lstm as lstm_models
from madrona_learn_tpu.ops.pallas.lstm import (
    lstm_sequence_proj as jax_lstm_seq_proj,
)
from madrona_learn_tpu.ops.pallas.policy_step import (
    fused_policy_step as jax_fused_policy_step,
)
from madrona_learn_tpu_torch.ops.cuda.lstm import (
    lstm_proj_supported,
    tc_rows,
    lstm_sequence_proj,
    lstm_sequence_proj_chunked,
    lstm_sequence_proj_fwd_chunked_reference,
)
from madrona_learn_tpu_torch.ops.cuda.policy_step import (
    fused_policy_step,
    fused_policy_step_chunked,
    policy_step_supported,
)
from test_torch_lstm_fwd_tc_numerics import _FakeLibrary
from test_torch_models import _load, _np, _perturb

torch.set_num_threads(1)

WIDE = (384, 512)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
F32_TOL = 1e-5


def _close(got, want, dtype, what):
    """got (torch) against want (numpy, f32 values) under the dtype's
    rule."""
    g = _np(got.float())
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape, what
    err = float(np.abs(g - w).max())
    top = float(np.abs(w).max())
    if dtype == "float32":
        tol = F32_TOL * max(1.0, top)
    else:
        tol = 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0
    assert err <= tol, f"{what}: max |diff| {err:.3e} above {tol:.3e}"


def _weights(rng, dt, *shape, scale=1.0):
    """numpy f32 values that are exact in dt."""
    a = (rng.normal(size=shape) * scale).astype(np.float32)
    return np.asarray(jnp.asarray(a).astype(dt).astype(jnp.float32))


def _to_torch(a, dt):
    return torch.from_numpy(np.array(a, np.float32)).to(dt)


def _step_inputs(seed, N, F, H, layers, jdt, stack=()):
    """x, the MLP's (W, ln_scale, ln_bias) layers, Wi, Wr, bias, c, h as
    numpy arrays, every weight with the leading dims ``stack``."""
    rng = np.random.default_rng(seed)
    mlp, fin = [], F
    for _ in range(layers):
        mlp.append((_weights(rng, jdt, *stack, fin, H,
                             scale=(2 / fin) ** 0.5),
                    (1 + 0.1 * rng.normal(size=(*stack, H)))
                    .astype(np.float32),
                    (0.1 * rng.normal(size=(*stack, H))).astype(np.float32)))
        fin = H
    return (_weights(rng, jdt, N, F), mlp,
            _weights(rng, jdt, *stack, H, 4 * H, scale=H ** -0.5),
            _weights(rng, jdt, *stack, H, 4 * H, scale=H ** -0.5),
            _weights(rng, jdt, *stack, 4 * H, scale=0.1),
            _weights(rng, jdt, N, H, scale=0.5),
            _weights(rng, jdt, N, H, scale=0.5))


def _torch_step_args(args, tdt):
    x, mlp, wi, wr, bias, c, h = args
    return (_to_torch(x, tdt),
            [(_to_torch(w, tdt), torch.from_numpy(s), torch.from_numpy(lb))
             for w, s, lb in mlp],
            *(_to_torch(a, tdt) for a in (wi, wr, bias, c, h)))


def _jax_step_args(args, jdt):
    x, mlp, wi, wr, bias, c, h = args
    return (jnp.asarray(x, jdt),
            [(jnp.asarray(w, jdt), jnp.asarray(s), jnp.asarray(lb))
             for w, s, lb in mlp],
            *(jnp.asarray(a, jdt) for a in (wi, wr, bias, c, h)))


@pytest.mark.parametrize("H,F,layers,dtype", [
    (384, 3, 2, "bfloat16"), (384, 3, 2, "float32"),
    (512, 3, 2, "bfloat16"), (512, 128, 1, "float32")])
def test_fused_step_matches_pallas(H, F, layers, dtype):
    """``fused_policy_step`` against JAX's ``fused_policy_step`` in
    interpret mode, at N = 12."""
    jdt, tdt = DTYPES[dtype]
    assert policy_step_supported(H, F, tdt)
    args = _step_inputs(H + F + layers, 12, F, H, layers, jdt)
    want_f, (want_c, want_h) = jax_fused_policy_step(
        *_jax_step_args(args, jdt), interpret=True)
    got_f, (got_c, got_h) = fused_policy_step(*_torch_step_args(args, tdt))
    for name, g, w in (("feats", got_f, want_f), ("c'", got_c, want_c),
                       ("h'", got_h, want_h)):
        assert g.dtype == tdt
        _close(g, w.astype(jnp.float32), dtype, f"{name} H={H}")


@pytest.mark.parametrize("H,dtype", [(384, "bfloat16"), (512, "float32")])
def test_fused_step_chunked_matches_vmapped_pallas(H, dtype):
    """``fused_policy_step_chunked`` over three chunks of 6 rows of three
    policies in a shuffled order against ``jax.vmap`` over the chunks of
    JAX's Pallas step in interpret mode, each chunk given its policy's
    weights."""
    jdt, tdt = DTYPES[dtype]
    P, C, order = 3, 6, [2, 0, 1]
    B = len(order)
    args = _step_inputs(H + 1, B * C, 3, H, 2, jdt, stack=(P,))
    idx = torch.tensor(order, dtype=torch.int32)
    x, mlp, wi, wr, bias, c, h = _torch_step_args(args, tdt)
    got_f, (got_c, got_h) = fused_policy_step_chunked(x, mlp, wi, wr, bias,
                                                      idx, c, h)
    pick = lambda a: jnp.asarray(np.asarray(a)[order])
    chunks = lambda a: jnp.asarray(a, jdt).reshape(B, C, -1)
    jx, jmlp, jwi, jwr, jb, jc, jh = args
    want_f, (want_c, want_h) = jax.vmap(
        lambda x, mlp, wi, wr, b, c, h: jax_fused_policy_step(
            x, mlp, wi, wr, b, c, h, interpret=True))(
        chunks(jx),
        [(pick(w).astype(jdt), pick(s), pick(lb)) for w, s, lb in jmlp],
        pick(jwi).astype(jdt), pick(jwr).astype(jdt), pick(jb).astype(jdt),
        chunks(jc), chunks(jh))
    for name, g, w in (("feats", got_f, want_f), ("c'", got_c, want_c),
                       ("h'", got_h, want_h)):
        _close(g, np.asarray(w.astype(jnp.float32)).reshape(B * C, H), dtype,
               f"{name} H={H}")


def _proj_inputs(seed, T, N, F, H, jdt, P=None):
    """x, keep, Wi, Wr, bias, c0, h0 and a probe (numpy), the weights
    stacked over P policies where given."""
    rng = np.random.default_rng(seed)
    stack = () if P is None else (P,)
    keep = (rng.random((T, N)) > 0.3).astype(np.float32)
    return (_weights(rng, jdt, T, N, F), keep,
            _weights(rng, jdt, *stack, F, 4 * H, scale=F ** -0.5),
            _weights(rng, jdt, *stack, H, 4 * H, scale=H ** -0.5),
            _weights(rng, jdt, *stack, 4 * H, scale=0.5),
            _weights(rng, jdt, N, H), _weights(rng, jdt, N, H),
            _weights(rng, jdt, T, N, H))


def _jax_proj_vjp(x, keep, wi, wr, bias, c0, h0, probe):
    """ys and (dx, dWi, dWr, db, dc0, dh0) of JAX's Pallas
    ``lstm_sequence_proj`` in interpret mode (``jax.vjp``)."""
    out, pull = jax.vjp(
        lambda x, wi, wr, bias, c0, h0: jax_lstm_seq_proj(
            x, keep, wi, wr, bias, c0, h0, True),
        x, wi, wr, bias, c0, h0)
    return out, pull(probe)


def _torch_proj_grads(fn, x, keep, wi, wr, bias, *rest):
    """ys and (dx, dWi, dWr, db, dc0, dh0) of ``fn`` by autograd; ``rest``
    holds the chunk indices where fn takes them, then c0, h0, probe."""
    *idx, c0, h0, probe = rest
    leaves = [t.clone().requires_grad_() for t in (x, wi, wr, bias, c0, h0)]
    ys = fn(leaves[0], keep, *leaves[1:4], *idx, *leaves[4:])
    return ys, torch.autograd.grad((ys.float() * probe.float()).sum(),
                                   leaves)


GRADS = ("dx", "dWi", "dWr", "db", "dc0", "dh0")


@pytest.mark.parametrize("H,F,dtype", [
    (384, 384, "float32"), (512, 512, "bfloat16"), (512, 128, "float32"),
    (384, 1536, "bfloat16")])
def test_proj_matches_pallas_vjp(H, F, dtype):
    """``lstm_sequence_proj`` and its gradients against ``jax.vjp`` of
    JAX's Pallas ``lstm_sequence_proj`` in interpret mode, at T = 3,
    N = 8 (F = H the fused trunk's, F = 128 and F = 4H the narrowest and
    widest x tiles)."""
    jdt, tdt = DTYPES[dtype]
    assert lstm_proj_supported(F, H, tdt)
    args = _proj_inputs(H + F, 3, 8, F, H, jdt)
    want_ys, want = _jax_proj_vjp(
        *(jnp.asarray(a, jdt) for a in args[:1]), jnp.asarray(args[1], jdt),
        *(jnp.asarray(a, jdt) for a in args[2:]))
    t = [_to_torch(a, tdt) for a in args]
    ys, got = _torch_proj_grads(lstm_sequence_proj, *t)
    _close(ys, want_ys.astype(jnp.float32), dtype, f"ys H={H} F={F}")
    for name, g, w in zip(GRADS, got, want):
        _close(g, w.astype(jnp.float32), dtype, f"{name} H={H} F={F}")


@pytest.mark.parametrize("H", [512])
def test_proj_chunked_matches_vmapped_pallas_vjp(H):
    """``lstm_sequence_proj_chunked`` (and the forward's chunk-indexed
    twin) with each of 3 policies' minibatch one chunk of 4 rows, float32:
    ys and the gradients (dx, dWi[p], dWr[p], db[p], dc0, dh0) against
    ``jax.vmap`` over the policies of ``jax.vjp`` of JAX's Pallas
    ``lstm_sequence_proj`` in interpret mode."""
    T, P, C, F = 3, 3, 4, H
    args = _proj_inputs(H + 7, T, P * C, F, H, jnp.float32, P=P)
    x, keep, wi, wr, bias, c0, h0, probe = (torch.from_numpy(np.array(a))
                                            for a in args)
    idx = torch.arange(P, dtype=torch.int32)
    ys, got = _torch_proj_grads(lstm_sequence_proj_chunked, x, keep, wi, wr,
                                bias, idx, c0, h0, probe)
    fwd_ys, _ = lstm_sequence_proj_fwd_chunked_reference(x, keep, wi, wr,
                                                         bias, idx, c0, h0)
    assert torch.equal(fwd_ys, ys.detach())

    def per_policy(a):
        """[T, P * C, ...] -> [P, T, C, ...]; [P * C, ...] -> [P, C, ...]."""
        if a.shape[0] == P * C:
            return jnp.asarray(a.reshape(P, C, *a.shape[1:]))
        return jnp.asarray(a.reshape(T, P, C, *a.shape[2:]).swapaxes(0, 1))

    jx, jkeep, jwi, jwr, jb, jc0, jh0, jprobe = args
    want_ys, want = jax.vmap(_jax_proj_vjp)(
        per_policy(jx), per_policy(jkeep), jnp.asarray(jwi),
        jnp.asarray(jwr), jnp.asarray(jb), per_policy(jc0), per_policy(jh0),
        per_policy(jprobe))
    time_major = lambda a: np.asarray(a).swapaxes(0, 1).reshape(
        T, P * C, -1)
    _close(ys, time_major(want_ys), "float32", f"ys H={H}")
    dx, dwi, dwr, db, dc0, dh0 = (np.asarray(w) for w in want)
    wants = (time_major(dx), dwi, dwr, db, dc0.reshape(P * C, H),
             dh0.reshape(P * C, H))
    for name, g, w in zip(GRADS, got, wants):
        _close(g, w, "float32", f"{name} H={H}")


# -- The 512-wide fused trunk, carried over from flax ----------------------

def _jax_encoder(H, dtype, layers):
    return jm.RecurrentBackboneEncoder(
        net=jm.MLP(num_channels=H, num_layers=layers, dtype=dtype),
        rnn=jm.LSTM(num_hidden_channels=H, num_layers=1, dtype=dtype,
                    use_pallas=True, fuse_input_proj=True),
        use_fused_step=True)


def _torch_encoder(H, dtype, layers):
    return tm.RecurrentBackboneEncoder(
        net=tm.MLP(3, H, layers, dtype),
        rnn=tm.LSTM(H, H, 1, dtype, fuse_input_proj=True),
        use_fused_step=True)


class _Counted:
    """A stand-in that counts its calls and runs the function it wraps."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args):
        self.calls += 1
        return self.fn(*args)


def test_fused_trunk_512_matches_jax_and_takes_the_fused_functions(
        monkeypatch):
    """An MLP 1 x 512 + LSTM 512 encoder with ``use_fused_step`` and
    ``fuse_input_proj`` (float32), its flax parameters through the port's
    converter: the rollout step (one ``fused_policy_step`` call) against
    JAX's module's step, and the sequence pass (one
    ``lstm_sequence_proj`` call, the LSTM's input width 512 passing
    ``lstm_proj_supported``) against JAX's module's ``sequence``, within
    1e-5 (the kernels' gradients at 512: the tests above)."""
    H, N, T = 512, 8, 3
    rng = np.random.default_rng(31)
    enc_j = _jax_encoder(H, jnp.float32, layers=1)
    rnn0 = enc_j.init_recurrent_state(N)
    params = _perturb(enc_j.init(random.PRNGKey(3), rnn0,
                                 jnp.zeros((N, 3), jnp.float32),
                                 train=False)["params"], rng)
    enc = _load(_torch_encoder(H, torch.float32, layers=1), params)
    step = _Counted(fused_policy_step)
    proj = _Counted(lstm_sequence_proj)
    monkeypatch.setattr(ac_mod, "fused_policy_step", step)
    monkeypatch.setattr(lstm_models, "lstm_sequence_proj", proj)

    x = rng.normal(size=(N, 3)).astype(np.float32)
    c0, h0 = (0.5 * rng.normal(size=(N, 1, H)).astype(np.float32)
              for _ in range(2))
    want, (want_c, want_h) = enc_j.apply(
        {"params": params}, (jnp.asarray(c0), jnp.asarray(h0)),
        jnp.asarray(x), train=False)
    with torch.no_grad():
        got, (got_c, got_h) = enc((torch.from_numpy(c0),
                                   torch.from_numpy(h0)),
                                  torch.from_numpy(x))
    assert step.calls == 1
    for name, g, w in (("out", got, want), ("c", got_c, want_c),
                       ("h", got_h, want_h)):
        _close(g, w, "float32", f"step {name}")

    xs = rng.normal(size=(T * N, 3)).astype(np.float32)
    ends = rng.random((T, N, 1)) < 0.3
    want_seq = enc_j.apply({"params": params},
                           (jnp.asarray(c0), jnp.asarray(h0)),
                           jnp.asarray(ends), jnp.asarray(xs), train=False,
                           method="sequence")
    with torch.no_grad():
        seq = enc.sequence((torch.from_numpy(c0), torch.from_numpy(h0)),
                           torch.from_numpy(ends), torch.from_numpy(xs))
    assert proj.calls == 1
    _close(seq, np.asarray(want_seq), "float32", "sequence")


@pytest.mark.parametrize("H", WIDE)
def test_projection_witness_reaches_both_entry_points(monkeypatch, H):
    """``_fwd_tc(wit=...)`` and ``_bwd_tc(wit=...)`` of the projection hand
    their f32 [2, T, N, 4H] witness to ``mlt_lstm_proj_fwd_witness`` /
    ``mlt_lstm_proj_bwd_witness`` (the argument before the stream; H and
    F first), the buffers ``chip_smoke.py``'s ``_lstm_proj_witness``
    compares bitwise; without it the wrappers take the path's entry
    points, and the backward's db partials take ``tc_rows(True, H)`` row
    tiles (16 at 512, 32 at 384). A stand-in library, stream and SM count
    stand in for the card."""
    lib = _FakeLibrary()
    monkeypatch.setattr(lstm_mod, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device=None: types.SimpleNamespace(
                            multi_processor_count=132))
    T, N, F = 2, 70, 128
    z = lambda *s: torch.zeros(*s, dtype=torch.bfloat16)
    args = (z(T, N, F), z(T, N), z(F, 4 * H), z(H, 4 * H), z(4 * H),
            z(N, H), z(N, H))
    seq = z(T, N, H)
    wits = [torch.zeros(2, T, N, 4 * H) for _ in range(2)]
    lstm_mod._fwd_tc(*args, wit=wits[0])
    b = lstm_mod._bwd_tc(*args, seq, seq, seq, phases=1, wit=wits[1])
    lstm_mod._fwd_tc(*args)
    lstm_mod._bwd_tc(*args, seq, seq, seq, phases=1)
    assert lib.calls == ["mlt_lstm_proj_fwd_witness",
                         "mlt_lstm_proj_bwd_witness", "mlt_lstm_fwd_tc",
                         "mlt_lstm_bwd_tc"]
    fwd, bwd = lib.args[:2]
    assert fwd[:2] == bwd[:2] == (H, F)
    assert fwd[-2] == wits[0].data_ptr() and bwd[-2] == wits[1].data_ptr()
    assert b["part_b"].shape == (-(-N // tc_rows(True, H)), 4 * H)
