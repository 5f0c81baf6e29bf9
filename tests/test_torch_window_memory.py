"""WindowAttentionMemory against the JAX package's, on the CPU.

- A step from a filled state and the sequence pass (clearing after
  ``seq_ends``), outputs and every state leaf, in float32 (1e-5) and
  bfloat16 (the caches and outputs within two bf16 ulps of the largest
  value, 2^-6 of it: both round the same f32 math once, after sums in
  another order; ``age`` and ``pos`` exactly), and the sequence's gradients
  in float32 (1e-4 relative, 1e-5 absolute, as the model tests'), with
  parameters carried across by ``compat/from_jax.py``.
- The protocol of JAX's ``tests/test_window_attention.py`` in the port: the
  sequence equals the step loop with clears, the output depends on the
  last ``window`` inputs only, and a clear empties ``age`` and ``pos`` and
  keeps the caches.
- Two ``update_iter``s of an MLP 2 x 32 -> WindowAttentionMemory(32,
  window 4, 2 heads) trainer against JAX's, with the slice test's checks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

import madrona_learn_tpu as mlt
import madrona_learn_tpu.models as jm
import madrona_learn_tpu_torch.models as tm
import test_torch_slice as slice_test
from madrona_learn_tpu_torch.compat.from_jax import actor_critic_state_dict
from madrona_learn_tpu_torch.config import DiscreteActionsConfig
from test_torch_models import F32, _load, _np

# Two update_iters of the window-memory trainer, with the slice test's
# checks run against this module's fixtures.
from test_torch_slice import (  # noqa: F401
    test_gradients_and_optimizer_state_match_jax,
    test_obs_normalizer_and_metrics_match_jax,
    test_parameters_match_jax,
    test_rollout_data_matches_jax,
)

torch.set_num_threads(1)

H, WINDOW, HEADS = slice_test.H, 4, 2
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(dtype, seed=0, N=6):
    jdt, tdt = DTYPES[dtype]
    mem_j = jm.WindowAttentionMemory(num_hidden_channels=H, window=WINDOW,
                                     num_heads=HEADS, dtype=jdt)
    params = mem_j.init(random.PRNGKey(seed), mem_j.init_recurrent_state(N),
                        jnp.zeros((N, H), jdt), False)
    rng = np.random.default_rng(seed)
    # A LayerNorm affine away from its identity init.
    norm = params["params"]["step"]["norm"]
    params = {"params": dict(params["params"], step=dict(
        params["params"]["step"], norm={
            k: jnp.asarray(np.asarray(v) + 0.3 * rng.normal(size=v.shape),
                           jnp.float32) for k, v in norm.items()}))}
    mem_t = _load(tm.WindowAttentionMemory(H, WINDOW, HEADS, tdt), params)
    return mem_j, params, mem_t, rng


def _close(got, want, dtype):
    got, want = _np(got.float()), np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32)
    else:
        assert np.abs(got - want).max() <= 2 ** -6 * np.abs(want).max()


def _check_state(got, want, dtype):
    for g, w in zip(got[:2], want[:2]):
        _close(g, w, dtype)
    for g, w in zip(got[2:], want[2:]):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_step_and_sequence_match_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    mem_j, params, mem_t, rng = _pair(dtype, seed=1)
    T, N = 9, 6
    xs = rng.normal(size=(T, N, H)).astype(np.float32)
    dones = rng.random((T, N, 1)) < 0.25

    seq_j = mem_j.apply(params, mem_j.init_recurrent_state(N),
                        jnp.asarray(dones), jnp.asarray(xs, jdt), False,
                        method="sequence")
    with torch.no_grad():
        seq_t = mem_t.sequence(mem_t.init_recurrent_state(N),
                               torch.from_numpy(dones),
                               torch.from_numpy(xs).to(tdt))
    assert seq_t.dtype == tdt and seq_t.shape == (T, N, H)
    _close(seq_t, seq_j, dtype)

    # A step from a state filled (and partly cleared) by the steps above.
    state_j, state_t = mem_j.init_recurrent_state(N), \
        mem_t.init_recurrent_state(N)
    for t in range(T - 1):
        _, state_j = mem_j.apply(params, state_j, jnp.asarray(xs[t], jdt),
                                 False)
        state_j = mem_j.clear_recurrent_state(state_j, jnp.asarray(dones[t]))
        with torch.no_grad():
            _, state_t = mem_t(state_t, torch.from_numpy(xs[t]).to(tdt))
        state_t = mem_t.clear_recurrent_state(state_t,
                                              torch.from_numpy(dones[t]))
    out_j, new_j = mem_j.apply(params, state_j, jnp.asarray(xs[-1], jdt),
                               False)
    with torch.no_grad():
        out_t, new_t = mem_t(state_t, torch.from_numpy(xs[-1]).to(tdt))
    _close(out_t, out_j, dtype)
    _check_state(new_t, new_j, dtype)


def test_sequence_gradients_match_jax():
    mem_j, params, mem_t, rng = _pair("float32", seed=2)
    T, N = 7, 5
    xs = rng.normal(size=(T, N, H)).astype(np.float32)
    dones = rng.random((T, N, 1)) < 0.3
    probe = rng.normal(size=(T, N, H)).astype(np.float32)

    def loss_j(p, x):
        out = mem_j.apply(p, mem_j.init_recurrent_state(N),
                          jnp.asarray(dones), x, False, method="sequence")
        return jnp.sum(out * probe)

    g_params, g_x = jax.grad(loss_j, argnums=(0, 1))(params, jnp.asarray(xs))
    x_t = torch.from_numpy(xs).requires_grad_()
    out = mem_t.sequence(mem_t.init_recurrent_state(N),
                         torch.from_numpy(dones), x_t)
    names, tensors = zip(*mem_t.named_parameters())
    grads = torch.autograd.grad((out * torch.from_numpy(probe)).sum(),
                                (*tensors, x_t))
    want = actor_critic_state_dict(g_params)
    assert sorted(names) == sorted(want)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(_np(g), want[name], rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    np.testing.assert_allclose(_np(grads[-1]), np.asarray(g_x), rtol=1e-4,
                               atol=1e-5)


# -- the protocol (JAX: tests/test_window_attention.py) ---------------------

def test_sequence_matches_stepwise():
    _, _, mem, rng = _pair("float32", seed=3)
    T, N = 10, 4
    xs = torch.from_numpy(rng.normal(size=(T, N, H)).astype(np.float32))
    dones = torch.from_numpy(rng.random((T, N, 1)) < 0.25)
    state, outs = mem.init_recurrent_state(N), []
    with torch.no_grad():
        for t in range(T):
            out, state = mem(state, xs[t])
            state = mem.clear_recurrent_state(state, dones[t])
            outs.append(out)
        seq = mem.sequence(mem.init_recurrent_state(N), dones, xs)
    np.testing.assert_allclose(_np(torch.stack(outs)), _np(seq), rtol=1e-5,
                               atol=1e-5)


def test_memory_horizon_is_window_limited():
    """The output depends on the last ``window`` inputs only."""
    _, _, mem, rng = _pair("float32", seed=4, N=2)

    def draw():
        return torch.from_numpy(rng.normal(size=(2, H)).astype(np.float32))

    def run(prefix, tail):
        state = mem.init_recurrent_state(2)
        with torch.no_grad():
            for x in prefix + tail:
                out, state = mem(state, x)
        return out

    tail = [draw() for _ in range(WINDOW)]
    out_a = run([draw() for _ in range(3)], tail)
    out_b = run([draw() for _ in range(3)], tail)
    np.testing.assert_allclose(_np(out_a), _np(out_b), rtol=1e-6, atol=1e-6)
    # One step less than the window: the older input still counts.
    assert not torch.allclose(run([draw()], tail[1:]),
                              run([draw()], tail[1:]))


def test_clear_empties_age_and_pos_and_keeps_the_caches():
    _, _, mem, rng = _pair("float32", seed=5, N=3)
    state = mem.init_recurrent_state(3)
    with torch.no_grad():
        for _ in range(WINDOW + 2):
            _, state = mem(state, torch.from_numpy(
                rng.normal(size=(3, H)).astype(np.float32)))
    assert (state[2] > 0).all() and (state[3] == WINDOW + 2).all()
    clear = torch.tensor([[True], [False], [True]])
    cleared = mem.clear_recurrent_state(state, clear)
    for got, old in zip(cleared[:2], state[:2]):
        assert torch.equal(got, old)
    assert (cleared[2][[0, 2]] == 0).all() and (cleared[3][[0, 2]] == 0).all()
    assert torch.equal(cleared[2][1], state[2][1])
    assert torch.equal(cleared[3][1], state[3][1])
    assert all(s.dtype == torch.int32 for s in cleared[2:])
    # A cleared row attends only to what it writes next, whatever its
    # stale caches hold: it matches a row started from the empty state.
    x = torch.from_numpy(rng.normal(size=(3, H)).astype(np.float32))
    with torch.no_grad():
        out, _ = mem(cleared, x)
        fresh, _ = mem(mem.init_recurrent_state(3), x)
    np.testing.assert_array_equal(_np(out[[0, 2]]), _np(fresh[[0, 2]]))


# -- two update_iters ---------------------------------------------------------

def _jax_window_actor_critic():
    actions = mlt.DiscreteActionsConfig(actions_num_buckets=[5])
    return jm.ActorCritic(
        backbone=jm.BackboneShared(
            prefix=lambda obs, train: jnp.concatenate(
                [obs["delta"], obs["time"]], axis=-1),
            encoder=jm.RecurrentBackboneEncoder(
                net=jm.MLP(num_channels=H, num_layers=2, dtype=jnp.float32),
                rnn=jm.WindowAttentionMemory(
                    num_hidden_channels=H, window=WINDOW, num_heads=HEADS,
                    dtype=jnp.float32))),
        actor=jm.DictActor(heads={"move": jm.DenseLayerDiscreteActor(
            cfg=actions, dtype=jnp.float32)}),
        critic=jm.DenseLayerCritic(dtype=jnp.float32))


def torch_window_actor_critic(dtype=torch.float32):
    return tm.ActorCritic(
        backbone=tm.BackboneShared(
            prefix=lambda obs: torch.cat([obs["delta"], obs["time"]], -1),
            encoder=tm.RecurrentBackboneEncoder(
                net=tm.MLP(3, H, 2, dtype),
                rnn=tm.WindowAttentionMemory(H, WINDOW, HEADS, dtype))),
        actor=tm.DictActor({"move": tm.DenseLayerDiscreteActor(
            DiscreteActionsConfig(actions_num_buckets=[5]), H, dtype)}),
        critic=tm.DenseLayerCritic(H, dtype))


@pytest.fixture(scope="module")
def jax_run():
    return slice_test.run_jax(_jax_window_actor_critic())


@pytest.fixture(scope="module")
def torch_run(jax_run):
    return slice_test.run_torch(jax_run, torch_window_actor_critic())
