"""Policy-batched forms of ``WindowAttentionMemory``: a population whose
recurrence is the windowed-attention memory collects in the policy-chunk
layout and learns one PPO step a minibatch over every train policy, as JAX
``vmap``s the flax step.

- ``chunked`` (one step over [B, C] chunk-order rows, chunks in a shuffled
  order, a policy with two chunks, from a state of random caches, ages and
  positions) and ``batched`` (the sequence over [P, T, mb] policy-major
  rows, clearing after ``seq_ends``) against ``jax.vmap`` of the flax
  module over the stacked parameters, in float32 and bfloat16 at
  ``test_torch_window_memory``'s tolerances (``age`` and ``pos``
  exactly), and the sequence's gradients in float32 (1e-4 relative, 1e-5
  absolute). Each JAX case jits once.
- A population of MLP 32 -> WindowAttentionMemory(32, window 4, 2 heads)
  collects through the chunked path as through the per-policy loop
  (``test_torch_chunk_layout``'s check, under matchmaking and a static
  tournament with custom rows), its four-tensor state (mixed dtypes, a
  [window, H] trailing shape) in chunk order across steps
  (``chunkwise_rnn``) bitwise the sim-order carry, and learns on the
  batched path as on the loop (``test_torch_batched_learn``'s check).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

import madrona_learn_tpu.models as jm
import madrona_learn_tpu_torch as tlt
import madrona_learn_tpu_torch.models as tm
import test_torch_batched_learn as batched_learn
import test_torch_chunk_layout as chunk_layout
from madrona_learn_tpu_torch.compat.from_jax import actor_critic_state_dict
from madrona_learn_tpu_torch.models.common import StackedParams
from test_torch_models import _load, _np
from test_torch_window_memory import DTYPES, _check_state, _close

torch.set_num_threads(1)

F32 = torch.float32
H, WINDOW, HEADS = 32, 4, 2
P = 3


def _stacked_pair(dtype, seed):
    """P flax parameter sets, stacked for ``jax.vmap``, and the port's
    modules loaded from each (with a LayerNorm affine off its init)."""
    jdt, tdt = DTYPES[dtype]
    mem_j = jm.WindowAttentionMemory(num_hidden_channels=H, window=WINDOW,
                                     num_heads=HEADS, dtype=jdt)
    rng = np.random.default_rng(seed)
    params, mems = [], []
    for p in range(P):
        flax = mem_j.init(random.PRNGKey(seed + p),
                          mem_j.init_recurrent_state(2),
                          jnp.zeros((2, H), jdt), False)["params"]
        flax = jax.tree.map(
            lambda l: jnp.asarray(np.asarray(l) + 0.3 * rng.normal(
                size=l.shape), jnp.float32) if l.ndim == 1 else l, flax)
        params.append({"params": flax})
        mems.append(_load(tm.WindowAttentionMemory(H, WINDOW, HEADS, tdt),
                          params[-1]))
    stacked = jax.tree.map(lambda *l: jnp.stack(l), *params)
    return mem_j, stacked, mems, rng


def _random_state(rng, lead, tdt):
    """Caches, ages in [0, window] (0 an empty slot) and positions."""
    caches = [rng.normal(size=(*lead, WINDOW, H)).astype(np.float32)
              for _ in range(2)]
    age = rng.integers(0, WINDOW + 1, size=(*lead, WINDOW)).astype(np.int32)
    pos = rng.integers(0, 3 * WINDOW, size=(*lead, 1)).astype(np.int32)
    np_state = (*caches, age, pos)
    t_state = (*(torch.from_numpy(c).to(tdt) for c in caches),
               torch.from_numpy(age), torch.from_numpy(pos))
    return np_state, t_state


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_chunked_step_matches_jax_vmap(dtype):
    """One step over 4 chunks of 5 rows in the order [2, 0, 1, 2]: the
    output and the new state against ``jax.vmap`` of the flax step over
    each chunk's policy's parameters."""
    jdt, tdt = DTYPES[dtype]
    mem_j, stacked, mems, rng = _stacked_pair(dtype, 10)
    order = [2, 0, 1, 2]
    B, C = len(order), 5
    np_state, t_state = _random_state(rng, (B, C), tdt)
    x = rng.normal(size=(B, C, H)).astype(np.float32)

    per_chunk = jax.tree.map(lambda l: l[jnp.asarray(order)], stacked)
    step = jax.jit(jax.vmap(lambda p, s, x: mem_j.apply(p, s, x, False)))
    j_state = tuple(jnp.asarray(s, jdt if s.dtype == np.float32 else None)
                    for s in np_state)
    out_j, new_j = step(per_chunk, j_state, jnp.asarray(x, jdt))

    idx = torch.tensor(order, dtype=torch.int32)
    layout = type("Layout", (), dict(chunk_policy=idx,
                                     chunk_index=idx.long()))
    with torch.no_grad():
        out_t, new_t = mems[0].chunked(StackedParams.of(mems), layout,
                                       t_state, torch.from_numpy(x).to(tdt))
    assert out_t.dtype == tdt and out_t.shape == (B, C, H)
    _close(out_t, out_j, dtype)
    _check_state(new_t, new_j, dtype)
    # Each chunk is its policy's own step over its rows.
    for b, p in enumerate(order):
        with torch.no_grad():
            own, _ = mems[p](tuple(s[b] for s in t_state),
                             torch.from_numpy(x[b]).to(tdt))
        _close(out_t[b], _np(own.float()), dtype)


def _sequence_case(dtype, seed, T=6, mb=4):
    jdt, tdt = DTYPES[dtype]
    mem_j, stacked, mems, rng = _stacked_pair(dtype, seed)
    xs = rng.normal(size=(P, T, mb, H)).astype(np.float32)
    ends = rng.random((P, T, mb, 1)) < 0.25
    np_state, t_state = _random_state(rng, (P, mb), tdt)
    j_state = tuple(jnp.asarray(s, jdt if s.dtype == np.float32 else None)
                    for s in np_state)

    def seq_j(params, state, ends, x):
        return mem_j.apply(params, state, ends, x, False, method="sequence")

    return (mem_j, stacked, mems, xs, ends, j_state, t_state,
            jax.vmap(seq_j), rng)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_batched_sequence_matches_jax_vmap(dtype):
    """The sequence over 3 policies' [T = 6, mb = 4] minibatches, clearing
    after ``seq_ends``, against ``jax.vmap`` of the flax sequence."""
    jdt, tdt = DTYPES[dtype]
    (_, stacked, mems, xs, ends, j_state, t_state, seq_j,
     _) = _sequence_case(dtype, 20)
    want = jax.jit(seq_j)(stacked, j_state, jnp.asarray(ends),
                          jnp.asarray(xs, jdt))
    with torch.no_grad():
        got = mems[0].batched(StackedParams.of(mems), t_state,
                              torch.from_numpy(ends),
                              torch.from_numpy(xs).to(tdt))
    assert got.dtype == tdt and got.shape == xs.shape
    _close(got, want, dtype)


def test_batched_sequence_gradients_match_jax_vmap():
    """Every stacked parameter's gradient and the input's, float32."""
    (_, stacked, mems, xs, ends, j_state, t_state, seq_j,
     rng) = _sequence_case("float32", 30)
    probe = rng.normal(size=xs.shape).astype(np.float32)

    def loss_j(params, x):
        return jnp.sum(seq_j(params, j_state, jnp.asarray(ends), x) * probe)

    g_params, g_x = jax.jit(jax.grad(loss_j, argnums=(0, 1)))(
        stacked, jnp.asarray(xs))
    params = StackedParams.of(mems)
    for leaf in params.leaves.values():
        leaf.requires_grad_()
    x_t = torch.from_numpy(xs).requires_grad_()
    out = mems[0].batched(params, t_state, torch.from_numpy(ends), x_t)
    names, tensors = zip(*params.leaves.items())
    grads = torch.autograd.grad((out * torch.from_numpy(probe)).sum(),
                                (*tensors, x_t))
    want = actor_critic_state_dict(g_params)
    assert sorted(names) == sorted(want)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(_np(g), want[name], rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    np.testing.assert_allclose(_np(grads[-1]), np.asarray(g_x), rtol=1e-4,
                               atol=1e-5)


# -- The population against the per-policy loop ------------------------------

def _window_model(generator=None):
    """MLP 32 -> WindowAttentionMemory(32, window 4, 2 heads)."""
    net = tm.MLP(2, H, 1, F32, generator=generator)
    return tm.ActorCritic(
        backbone=tm.BackboneShared(
            prefix=lambda obs: torch.cat([obs["time"], obs["acc"]], -1),
            encoder=tm.RecurrentBackboneEncoder(
                net=net, rnn=tm.WindowAttentionMemory(
                    H, WINDOW, HEADS, F32, generator=generator))),
        actor=tm.DictActor({"move": tm.DenseLayerDiscreteActor(
            tlt.DiscreteActionsConfig(actions_num_buckets=[5]), H, F32,
            weight_init=tm.common.orthogonal(1.0), generator=generator)}),
        critic=tm.DenseLayerCritic(H, F32, generator=generator))


@pytest.fixture
def window_rollout(monkeypatch):
    monkeypatch.setattr(chunk_layout, "_model", lambda lstm, seed:
                        _window_model(torch.Generator().manual_seed(seed)))


@pytest.mark.parametrize("static", [False, True], ids=["matchmade",
                                                       "custom"])
def test_chunked_rollout_equals_the_per_policy_loop(window_rollout, static):
    """``test_torch_chunk_layout``'s population (7 steps of the duel,
    per-policy obs normalizers) with the window memory: the chunked
    rollout takes the layout and equals the per-policy loop (actions,
    preprocessed obs and custom rows bitwise; values, log-probs and the
    four state tensors within 1e-6)."""
    chunk_layout.test_chunked_rollout_equals_the_per_policy_loop(True,
                                                                 static)


@pytest.mark.parametrize("static", [False, True], ids=["matchmade",
                                                       "custom"])
def test_chunkwise_rnn_is_bitwise_the_sim_order_carry(window_rollout,
                                                      static):
    """The caches, ages and positions kept in chunk order across steps
    (cleared by chunk-order dones, joined across layouts by
    ``_chunk_remap``) give bitwise the outputs of the sim-order carry."""
    chunk_layout.test_chunkwise_rnn_is_bitwise_the_sim_order_carry(static)


def test_batched_learn_equals_the_per_policy_loop(monkeypatch):
    """``test_torch_batched_learn``'s population (4 train and 2 past
    policies, two epochs of two minibatches of [T = 4] sequences) with
    the window memory: the batched learn is taken and equals the
    per-policy loop, at that test's tolerances except for the metrics:
    their second moments sum 40 squared deviations of values that agree
    within 1e-6 (the attention's f32 sums and the batched products run in
    another order than the loop's, over four steps), and are held to 1e-5
    relative (1.6e-6 measured)."""
    monkeypatch.setattr(batched_learn, "_actor_critic",
                        lambda p, tower="lstm", dtype=F32: _window_model())
    batched_learn.check_batched_learn("uniform", metric_rtol=1e-5)
