"""Float16 populations on the policy-batched paths: the chunk-indexed
kernels' float16 twins, the float16 recurrences' policy-batched forms
against JAX's ``vmap``, and float16 populations collecting in the
policy-chunk layout and learning one PPO step a minibatch over every train
policy with one loss scaler a policy.

- The plain twins of the float16 instances (``lstm_sequence_fwd_chunked``,
  ``lstm_sequence_bwd_chunked``, ``gru_sequence_fwd_chunked``,
  ``gru_sequence_bwd_chunked``, ``grouped_matmul``), chunk by chunk over a
  shuffled chunk order with a chunk of no policy (index P: NaN rows), a
  policy without a chunk (zero weight gradients) and C = 37 rows (not a
  multiple of a tile): each chunk's rows bitwise the single-policy float16
  reference with its policy's weights; ``grouped_matmul`` also against the
  Pallas kernel in interpret mode (within one float16 rounding).
- ``LSTM`` / ``GRU`` (float16, H = 128, the width the kernels take):
  ``chunked`` (the rollout step over shuffled chunks) and ``batched`` (the
  sequence over policies, clearing after ``seq_ends``) against
  ``jax.vmap`` of the JAX float16 module over the stacked parameters,
  within ``test_torch_float16_recurrences``'s tolerances (two float16
  ulps). Each JAX case jits once.
- Populations of MLP 32 -> LSTM 128 and MLP 32 -> GRU 128 in float16:
  the chunked rollout equals the per-policy loop
  (``test_torch_chunk_layout``'s check, matchmaking and a static
  tournament with custom rows), and the batched learn with
  ``compute_dtype=float16`` equals the loop (``test_torch_batched_learn``'s
  check; the LSTM also with value normalization), each policy's scaler
  state and non-finite step count bitwise the loop's.
- A policy whose scale is forced to 2^40 overflows its float16 backward
  at every step: on the batched path its Adam state stays bitwise as it
  was, its parameters too except where the per-step projections (the
  tracked kernels' norm, the LayerNorms' joint norm) apply again to the
  kept values, and its scale halves a step, while every policy steps as
  on the loop.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

import madrona_learn_tpu.models as jm
import madrona_learn_tpu_torch as tlt
import madrona_learn_tpu_torch.models as tm
import madrona_learn_tpu_torch.ops.cuda.lstm as lstm_mod
import test_torch_batched_learn as batched_learn
import test_torch_chunk_layout as chunk_layout
from madrona_learn_tpu.ops.pallas.grouped_matmul import \
    grouped_matmul as jax_grouped_matmul
from madrona_learn_tpu_torch.compat.from_jax import actor_critic_state_dict
from madrona_learn_tpu_torch.models.common import StackedParams
from madrona_learn_tpu_torch.ops.cuda.grouped_matmul import \
    grouped_matmul_reference
from madrona_learn_tpu_torch.ops.cuda.gru import (
    gru_sequence_chunked_reference,
    gru_sequence_fwd_chunked_reference,
    gru_sequence_reference,
)
from madrona_learn_tpu_torch.ops.cuda.lstm import (
    lstm_sequence_chunked_reference,
    lstm_sequence_fwd_chunked_reference,
    lstm_sequence_reference,
)
from test_torch_float16_recurrences import FWD_TOL

torch.set_num_threads(1)

F16, F32 = torch.float16, torch.float32
HIDDEN = 128
GATES = {"lstm": 4, "gru": 3}
# Chunks of C = 37 rows: policy 3 of P = 4 owns none, index P is a custom
# policy's chunk (NaN rows), policy 2 owns two.
ORDER, P, C = [2, 0, 4, 1, 2], 4, 37


def _f16(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.normal(size=shape) * scale)
                            .astype(np.float32)).to(F16)


def _twin_case(kind, seed, T=3):
    """x_proj, keep, the [P, H, gH] / bias stacks, chunk_policy, the start
    state(s) and a probe, float16."""
    rng = np.random.default_rng(seed)
    g, N = GATES[kind], len(ORDER) * C
    keep = torch.from_numpy((rng.random((T, N)) > 0.3)
                            .astype(np.float32)).to(F16)
    bias_width = 4 * HIDDEN if kind == "lstm" else HIDDEN
    states = [_f16(rng, N, HIDDEN, scale=0.5)
              for _ in range(2 if kind == "lstm" else 1)]
    return (_f16(rng, T, N, g * HIDDEN), keep,
            _f16(rng, P, HIDDEN, g * HIDDEN, scale=HIDDEN ** -0.5),
            _f16(rng, P, bias_width, scale=0.1),
            torch.tensor(ORDER, dtype=torch.int32), states,
            torch.from_numpy(rng.normal(size=(T, N, HIDDEN))
                             .astype(np.float32)))


def _rows(b):
    return slice(b * C, (b + 1) * C)


@pytest.mark.parametrize("kind", sorted(GATES))
def test_float16_chunked_forward_twin_is_each_chunks_reference(kind):
    """Each chunk's ys (and the LSTM's cs) bitwise the single-policy
    float16 forward on its rows with its policy's weights; the chunk of
    index P NaN."""
    x, keep, w, b, idx, states, _ = _twin_case(kind, 1)
    if kind == "lstm":
        ys, cs = lstm_sequence_fwd_chunked_reference(x, keep, w, b, idx,
                                                     *states)
    else:
        ys = gru_sequence_fwd_chunked_reference(x, keep, w, b, idx,
                                                *states)
    assert ys.dtype == F16
    for i, p in enumerate(ORDER):
        r = _rows(i)
        if p == P:
            assert ys[:, r].isnan().all()
            continue
        if kind == "lstm":
            want_ys, want_cs = lstm_mod._sequence(
                x[:, r], keep[:, r], w[p], b[p], states[0][r], states[1][r])
            assert torch.equal(cs[:, r], want_cs)
        else:
            want_ys = gru_sequence_reference(x[:, r], keep[:, r], w[p], b[p],
                                             states[0][r])
        assert torch.equal(ys[:, r], want_ys)


@pytest.mark.parametrize("kind", sorted(GATES))
def test_float16_chunked_backward_twin_is_each_chunks_reference(kind):
    """The twin's autograd (the plain version of the chunked backward):
    each chunk's input and start-state gradients bitwise the single-policy
    float16 reference's on its rows; a policy's weight gradients those of
    its chunks' rows (policy 2's two chunks summed in float16, as the twin
    sums them); policy 3, which owns no chunk, zeros; the NaN chunk adds
    to no policy."""
    x, keep, w, b, idx, states, probe = _twin_case(kind, 2)
    good = torch.tensor([p != P for p in ORDER]).repeat_interleave(C)
    twin = (lstm_sequence_chunked_reference if kind == "lstm"
            else gru_sequence_chunked_reference)
    single = (lstm_sequence_reference if kind == "lstm"
              else gru_sequence_reference)
    leaves = [t.clone().requires_grad_() for t in (x, w, b, *states)]
    ys = twin(leaves[0], keep, leaves[1], leaves[2], idx, *leaves[3:])
    grads = torch.autograd.grad((ys[:, good].float() * probe[:, good])
                                .sum(), leaves)
    sums = {}
    for i, p in enumerate(ORDER):
        if p == P:
            continue
        r = _rows(i)
        own = [t.clone().requires_grad_() for t in (
            x[:, r], w[p], b[p], *(s[r] for s in states))]
        want = torch.autograd.grad(
            (single(own[0], keep[:, r], *own[1:]).float()
             * probe[:, r]).sum(), own)
        assert torch.equal(grads[0][:, r], want[0])
        for got_s, want_s in zip(grads[3:], want[3:]):
            assert torch.equal(got_s[r], want_s)
        dw, db = sums.get(p, (0, 0))
        sums[p] = (dw + want[1], db + want[2])
    for p in range(P):
        if p not in sums:
            assert not grads[1][p].any() and not grads[2][p].any()
            continue
        assert torch.equal(grads[1][p], sums[p][0])
        assert torch.equal(grads[2][p], sums[p][1])


def test_float16_grouped_matmul_twin_is_each_chunks_product():
    """Each chunk's rows bitwise the single-policy product (f32 sums
    rounded once to float16) with its policy's weights; the chunk of index
    P NaN; within one float16 rounding of the Pallas kernel (interpret
    mode) on the chunks of a policy."""
    rng = np.random.default_rng(3)
    IN, OUT = 48, 40
    x = _f16(rng, len(ORDER), C, IN)
    w = _f16(rng, P, IN, OUT, scale=IN ** -0.5)
    idx = torch.tensor(ORDER, dtype=torch.int32)
    y = grouped_matmul_reference(x, w, idx)
    assert y.dtype == F16
    zero = torch.zeros(1, dtype=torch.int32)
    for i, p in enumerate(ORDER):
        if p == P:
            assert y[i].isnan().all()
            continue
        own = grouped_matmul_reference(x[i:i + 1], w[p:p + 1], zero)[0]
        assert torch.equal(y[i], own)
        assert torch.equal(own, (x[i].float() @ w[p].float()).to(F16))
    valid = [i for i, p in enumerate(ORDER) if p < P]
    want = jax_grouped_matmul(jnp.asarray(x[valid].numpy()),
                              jnp.asarray(w.numpy()),
                              jnp.asarray(idx[valid].numpy()), True)
    np.testing.assert_allclose(y[valid].float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2 ** -10, atol=2 ** -14)


# -- The float16 recurrences' policy-batched forms against JAX's vmap --------

F_IN = 16


def _recurrence(kind, seed, policies=3):
    """JAX's float16 module, its parameters for ``policies`` policies
    (nonzero biases) stacked, and the port's module a policy."""
    cls = jm.LSTM if kind == "lstm" else jm.GRU
    mod_j = cls(num_hidden_channels=HIDDEN, num_layers=1, dtype=jnp.float16,
                use_pallas=True)
    rng = np.random.default_rng(seed)
    params, mods = [], []
    for p in range(policies):
        state = mod_j.init_recurrent_state(2)
        flax = mod_j.init(random.PRNGKey(seed + p), state,
                          jnp.zeros((2, F_IN), jnp.float16), False)["params"]
        flax = jax.tree.map(
            lambda l: jnp.asarray(np.asarray(l) + 0.3 * rng.normal(
                size=l.shape), jnp.float32) if l.ndim == 1 else l, flax)
        params.append(flax)
        mod_t = getattr(tm, kind.upper())(F_IN, HIDDEN, 1, F16)
        mod_t.load_state_dict({k: torch.from_numpy(v) for k, v in
                               actor_critic_state_dict(flax).items()})
        mods.append(mod_t)
    return (mod_j, jax.tree.map(lambda *l: jnp.stack(l), *params), mods,
            rng)


def _state(kind, rng, *lead):
    """A float16 start state [*lead, 1, H] (a (c, h) pair for the LSTM)."""
    make = lambda: (0.5 * rng.normal(size=(*lead, 1, HIDDEN))).astype(
        np.float16)
    np_state = (make(), make()) if kind == "lstm" else make()
    return (jax.tree.map(jnp.asarray, np_state),
            jax.tree.map(torch.from_numpy, np_state))


def _close16(got, want):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **FWD_TOL)


@pytest.mark.parametrize("kind", sorted(GATES))
def test_float16_chunked_step_matches_jax_vmap(kind):
    """The rollout step over 4 chunks of 5 rows in the order [2, 0, 1, 2]:
    the output and the new state against ``jax.vmap`` of the JAX float16
    module over each chunk's policy's parameters, and each chunk bitwise
    its policy's own step."""
    mod_j, stacked, mods, rng = _recurrence(kind, 10)
    order = [2, 0, 1, 2]
    B, Cr = len(order), 5
    j_state, t_state = _state(kind, rng, B, Cr)
    x = rng.normal(size=(B, Cr, F_IN)).astype(np.float16)
    per_chunk = jax.tree.map(lambda l: l[jnp.asarray(order)], stacked)
    out_j, new_j = jax.jit(jax.vmap(
        lambda p, s, x: mod_j.apply({"params": p}, s, x, False)))(
            per_chunk, j_state, jnp.asarray(x))

    idx = torch.tensor(order, dtype=torch.int32)
    layout = type("Layout", (), dict(chunk_policy=idx,
                                     chunk_index=idx.long()))
    with torch.no_grad():
        out_t, new_t = mods[0].chunked(StackedParams.of(mods), layout,
                                       t_state, torch.from_numpy(x))
    assert out_t.dtype == F16 and out_t.shape == (B, Cr, HIDDEN)
    _close16(out_t, out_j)
    for g, w in zip(jax.tree.leaves(new_t), jax.tree.leaves(new_j)):
        assert g.dtype == F16
        _close16(g, w)
    for b, p in enumerate(order):
        with torch.no_grad():
            own, _ = mods[p](jax.tree.map(lambda s: s[b], t_state),
                             torch.from_numpy(x[b]))
        assert torch.equal(out_t[b], own)


@pytest.mark.parametrize("kind", sorted(GATES))
def test_float16_batched_sequence_matches_jax_vmap(kind):
    """The sequence over 3 policies' [T = 5, mb = 6] minibatches, clearing
    after ``seq_ends``, against ``jax.vmap`` of the JAX float16 sequence,
    and each policy bitwise its own module's sequence."""
    mod_j, stacked, mods, rng = _recurrence(kind, 20)
    Pn, T, mb = 3, 5, 6
    j_state, t_state = _state(kind, rng, Pn, mb)
    xs = rng.normal(size=(Pn, T, mb, F_IN)).astype(np.float16)
    ends = rng.random((Pn, T, mb, 1)) < 0.25
    want = jax.jit(jax.vmap(lambda p, s, e, x: mod_j.apply(
        {"params": p}, s, e, x, False, method="sequence")))(
            stacked, j_state, jnp.asarray(ends), jnp.asarray(xs))
    with torch.no_grad():
        got = mods[0].batched(StackedParams.of(mods), t_state,
                              torch.from_numpy(ends), torch.from_numpy(xs))
    assert got.dtype == F16 and got.shape == (Pn, T, mb, HIDDEN)
    _close16(got, want)
    for p in range(Pn):
        with torch.no_grad():
            own = mods[p].sequence(jax.tree.map(lambda s: s[p], t_state),
                                   torch.from_numpy(ends[p]),
                                   torch.from_numpy(xs[p]))
        assert torch.equal(got[p], own)


# -- Float16 populations against the per-policy loop -------------------------

MLP_H = 32


def _f16_model(kind, generator=None):
    """MLP 32 -> LSTM 128 or GRU 128, float16."""
    net = tm.MLP(2, MLP_H, 1, F16, generator=generator)
    rnn = (tm.LSTM if kind == "lstm" else tm.GRU)(MLP_H, HIDDEN, 1, F16,
                                                  generator=generator)
    return tm.ActorCritic(
        backbone=tm.BackboneShared(
            prefix=lambda obs: torch.cat([obs["time"], obs["acc"]], -1),
            encoder=tm.RecurrentBackboneEncoder(net=net, rnn=rnn)),
        actor=tm.DictActor({"move": tm.DenseLayerDiscreteActor(
            tlt.DiscreteActionsConfig(actions_num_buckets=[5]), HIDDEN, F16,
            weight_init=tm.common.orthogonal(1.0), generator=generator)}),
        critic=tm.DenseLayerCritic(HIDDEN, F16, generator=generator))


@pytest.mark.parametrize("static", [False, True], ids=["matchmade",
                                                       "custom"])
@pytest.mark.parametrize("kind", sorted(GATES))
def test_float16_chunked_rollout_equals_the_per_policy_loop(monkeypatch,
                                                            kind, static):
    """``test_torch_chunk_layout``'s population (7 steps of the duel,
    per-policy obs normalizers) with each float16 model: the chunked
    rollout takes the layout and equals the per-policy loop (that test's
    check)."""
    monkeypatch.setattr(chunk_layout, "_model", lambda lstm, seed:
                        _f16_model(kind, torch.Generator().manual_seed(seed)))
    chunk_layout.test_chunked_rollout_equals_the_per_policy_loop(True,
                                                                 static)


def _f16_learn(monkeypatch, kind):
    monkeypatch.setattr(batched_learn, "_actor_critic",
                        lambda p, tower="lstm", dtype=F32: _f16_model(kind))
    make_cfg = batched_learn._cfg
    monkeypatch.setattr(batched_learn, "_cfg", lambda variant, tower="lstm":
                        dataclasses.replace(make_cfg(variant, tower),
                                            compute_dtype=F16))


def _check_scalers(batched, loop):
    """Each train policy's scaler state and non-finite step count bitwise
    the loop's; returns the batched run's states."""
    for p, (tb, tl) in enumerate(zip(batched.state.train_states,
                                     loop.state.train_states)):
        for k, v in tb.scaler_state.items():
            assert v.shape == () and torch.equal(v, tl.scaler_state[k]), \
                (p, k)
        assert torch.equal(
            batched.first_minibatch_stats[p]["nonfinite_steps"],
            loop.first_minibatch_stats[p]["nonfinite_steps"])
    return [ts.scaler_state for ts in batched.state.train_states]


@pytest.mark.parametrize("kind,variant", [("lstm", "uniform"),
                                          ("lstm", "valuenorm"),
                                          ("gru", "uniform")])
def test_float16_batched_learn_equals_the_per_policy_loop(monkeypatch, kind,
                                                          variant):
    """``test_torch_batched_learn``'s population (4 train and 2 past
    policies, two epochs of two minibatches) with each float16 model and
    ``compute_dtype=float16``: the batched learn is taken and equals the
    per-policy loop (that test's check), each policy's scaler bitwise the
    loop's; its scale is 2^16 halved once a non-finite step."""
    _f16_learn(monkeypatch, kind)
    batched, loop, _ = batched_learn.check_batched_learn(variant)
    for p, state in enumerate(_check_scalers(batched, loop)):
        nonfinite = int(batched.first_minibatch_stats[p]["nonfinite_steps"])
        assert float(state["scale"]) == 65536.0 * 0.5 ** nonfinite


def test_a_nonfinite_policy_keeps_its_state_while_the_others_step(
        monkeypatch):
    """Train policy 1's scale set to 2^40 before the update: its scaled
    float16 backward overflows at each of the 4 steps, so on the batched
    path its Adam state stays bitwise as it was and its scale halves a
    step (2^36, 4 non-finite steps), while every policy, that one
    included, equals the loop's (``check_batched_learn``). Its parameters
    are kept before the projections that follow every step, as on the
    loop and in JAX: those that no projection touches stay bitwise, the
    tracked kernels and the LayerNorm affines within a rounding a step
    (1e-6 relative)."""
    _f16_learn(monkeypatch, "lstm")

    def force(mgr):
        mgr.state.train_states[1].scaler_state["scale"].fill_(2.0 ** 40)

    batched, loop, before = batched_learn.check_batched_learn(
        "uniform", prepare=force)
    states = _check_scalers(batched, loop)
    assert float(states[1]["scale"]) == 2.0 ** 36
    assert int(states[1]["fin_steps"]) == 0
    assert int(batched.first_minibatch_stats[1]["nonfinite_steps"]) == 4
    assert not bool(batched.first_minibatch_stats[1]["finite"])
    ts = batched.state.train_states[1]
    for name, got in batched.state.policy_states[1].actor_critic \
            .named_parameters():
        if name in ts.initial_weight_norms or "LayerNorm" in name:
            torch.testing.assert_close(got, before[1][name], rtol=1e-6,
                                       atol=0, msg=name)
        else:
            assert torch.equal(got, before[1][name]), name
    assert int(ts.opt_state.count) == 0
    for field in ("mu", "nu"):
        for name, v in getattr(ts.opt_state, field).items():
            assert not v.any(), (field, name)
    # The others stepped.
    for p in (0, 2, 3):
        assert int(batched.state.train_states[p].opt_state.count) > 0
