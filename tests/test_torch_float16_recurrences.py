"""Float16 recurrences against the JAX package, on the CPU.

The JAX package sends a float16 LSTM or GRU (``use_pallas=True``) to its
jnp twin, whose rounding points are the kernels': f32 gate math from
float16 operands, the carry rounded to float16 at every step. The port
sends it to its kernels' float16 instances on the card and to their plain
twins on the CPU.

- ``LSTM`` and ``GRU`` in float16, two layers with nonzero biases: the
  rollout step and the sequence pass (outputs and carries), and every
  parameter gradient of the sequence pass through the float16 casts.
  Tolerances in float16 terms: outputs and carries within 2^-9 relative
  and 2^-10 absolute (two float16 ulps, one at 1: the input projection's
  float16 product sums in another order and may round one ulp apart, and
  the recurrence carries that on); gradients within 2^-6 relative and
  1e-3 absolute (float16 cotangents through both autodiffs, each rounded
  at the casts, summed over T * N rows).
- The fused step and the input-projection kernels refuse float16, as
  JAX's gates do, so a float16 tower runs unfused.
- Two ``update_iter``s of a float16 MLP + LSTM trainer with dynamic loss
  scaling against JAX's (``test_torch_advantage_side.py``'s float16
  tolerances, its draws of ``jax.random`` replayed), and the scaler's
  state step for step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

import madrona_learn_tpu.models as jm
import madrona_learn_tpu_torch.models as tm
import madrona_learn_tpu_torch.models.lstm as lstm_mod
from madrona_learn_tpu.ops.pallas.lstm import \
    lstm_proj_supported as jax_lstm_proj_supported
from madrona_learn_tpu.ops.pallas.policy_step import \
    policy_step_supported as jax_policy_step_supported
from madrona_learn_tpu_torch.compat.from_jax import actor_critic_state_dict
from madrona_learn_tpu_torch.ops.cuda.lstm import (bwd_uses_tensor_cores,
                                                   fwd_uses_tensor_cores,
                                                   lstm_proj_supported,
                                                   lstm_sequence_proj_fwd,
                                                   uses_tensor_cores)
from madrona_learn_tpu_torch.ops.cuda.gru import \
    bwd_uses_tensor_cores as gru_bwd_uses_tensor_cores
from madrona_learn_tpu_torch.ops.cuda.gru import \
    fwd_uses_tensor_cores as gru_fwd_uses_tensor_cores
from madrona_learn_tpu_torch.ops.cuda.policy_step import \
    policy_step_supported
from test_torch_advantage_side import (H, _spec, run_two_update_iters)
from test_torch_models import _jax_actor_critic, _np, _torch_actor_critic

torch.set_num_threads(1)

FWD_TOL = dict(rtol=2 ** -9, atol=2 ** -10)
GRAD_TOL = dict(rtol=2 ** -6, atol=1e-3)


def _jax_module(kind, hidden, layers):
    cls = jm.LSTM if kind == "LSTM" else jm.GRU
    return cls(num_hidden_channels=hidden, num_layers=layers,
               dtype=jnp.float16, use_pallas=True)


def _case(kind, seed, T=5, N=24, F=16, hidden=32, layers=2):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(T, N, F)).astype(np.float16)
    dones = rng.random((T, N, 1)) < 0.25
    shape = (N, layers, hidden)

    def carry():
        return (0.5 * rng.normal(size=shape)).astype(np.float16)

    state = (carry(), carry()) if kind == "LSTM" else carry()
    module = _jax_module(kind, hidden, layers)
    j_state = jax.tree.map(jnp.asarray, state)
    params = module.init(random.PRNGKey(seed), j_state, jnp.asarray(xs[0]),
                         False)["params"]
    # Nonzero biases (zero at init, which would hide a rounding point).
    params = jax.tree.map(
        lambda l: (jnp.asarray(np.asarray(l) + 0.3 * rng.normal(
            size=l.shape), jnp.float32) if l.ndim == 1 else l), params)
    t_module = getattr(tm, kind)(F, hidden, layers, torch.float16)
    t_module.load_state_dict({k: torch.from_numpy(v) for k, v in
                              actor_critic_state_dict(params).items()},
                             strict=True)
    t_state = (tuple(map(torch.from_numpy, state)) if kind == "LSTM"
               else torch.from_numpy(state))
    probe = rng.normal(size=(T, N, layers * hidden)).astype(np.float32)
    return module, params, t_module, xs, dones, j_state, t_state, probe


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got.float()), np.asarray(want, np.float32),
                               **tol)


@pytest.mark.parametrize("kind", ["LSTM", "GRU"])
def test_float16_module_matches_jax(kind):
    module, params, t_module, xs, dones, j_state, t_state, probe = _case(
        kind, 40)
    want_out, want_state = module.apply({"params": params}, j_state,
                                        jnp.asarray(xs[0]), False)
    with torch.no_grad():
        got_out, got_state = t_module(t_state, torch.from_numpy(xs[0]))
    assert got_out.dtype == torch.float16
    _close(got_out, want_out, **FWD_TOL)
    for g, w in zip(jax.tree.leaves(got_state), jax.tree.leaves(want_state)):
        assert g.dtype == torch.float16
        _close(g, w, **FWD_TOL)

    def loss_j(p):
        out = module.apply({"params": p}, j_state, jnp.asarray(dones),
                           jnp.asarray(xs), False, method="sequence")
        return jnp.sum(out.astype(jnp.float32) * probe), out

    (_, want), g_j = jax.value_and_grad(loss_j, has_aux=True)(params)
    out = t_module.sequence(t_state, torch.from_numpy(dones),
                            torch.from_numpy(xs))
    assert out.dtype == torch.float16
    _close(out, want, **FWD_TOL)
    names, tensors = zip(*t_module.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(
        (out.float() * torch.from_numpy(probe)).sum(), tensors)))
    want_grads = actor_critic_state_dict(g_j)
    assert sorted(grads) == sorted(want_grads)
    for name, want_g in want_grads.items():
        assert np.any(want_g != 0), name
        scale = np.abs(want_g).max()
        np.testing.assert_allclose(_np(grads[name]), want_g,
                                   rtol=GRAD_TOL["rtol"],
                                   atol=GRAD_TOL["atol"] * max(scale, 1.0),
                                   err_msg=name)


@pytest.mark.parametrize("kind", ["LSTM", "GRU"])
def test_float16_step_equals_the_first_sequence_step(kind):
    """The rollout step is the sequence pass at T = 1 (PPO's ratio starts
    at 1), bitwise."""
    _, _, t_module, xs, dones, _, t_state, _ = _case(kind, 41)
    with torch.no_grad():
        out, _ = t_module(t_state, torch.from_numpy(xs[0]))
        seq = t_module.sequence(t_state, torch.from_numpy(dones[:1]),
                                torch.from_numpy(xs[:1]))
    assert torch.equal(out, seq[0])


def test_float16_takes_no_fused_step_and_no_projection_kernel(monkeypatch):
    for hidden, feat in ((128, 3), (256, 100), (256, 128)):
        assert not policy_step_supported(hidden, feat, torch.float16)
        assert not jax_policy_step_supported(hidden, feat, jnp.float16)
        assert policy_step_supported(hidden, feat, torch.bfloat16) == \
            jax_policy_step_supported(hidden, feat, jnp.bfloat16)
    for f_in, hidden in ((128, 128), (256, 256), (512, 128)):
        assert not lstm_proj_supported(f_in, hidden, torch.float16)
        assert not jax_lstm_proj_supported(f_in, hidden, jnp.float16)
    # In float16 the LSTM and GRU forwards and backwards take tensor cores
    # (their f16 wgmma instances at 128 and 256); no projection kernel
    # serves float16.
    assert not uses_tensor_cores(torch.float16, 256)
    assert bwd_uses_tensor_cores(torch.float16, 256)
    assert fwd_uses_tensor_cores(torch.float16, 256)
    assert gru_bwd_uses_tensor_cores(torch.float16, 256)
    assert gru_fwd_uses_tensor_cores(torch.float16, 256)
    # The projection kernel refuses float16 on the card's route too.
    meta = lambda *s: torch.empty(*s, dtype=torch.float16, device="meta")
    with pytest.raises(ValueError, match="float16"):
        lstm_sequence_proj_fwd(meta(2, 8, 128), meta(2, 8), meta(128, 512),
                               meta(128, 512), meta(512), meta(8, 128),
                               meta(8, 128))

    # A float16 fused-trunk tower runs the MLP and the LSTM unfused, and a
    # float16 LSTM with fuse_input_proj the hoisted product.
    tower = tm.RecurrentBackboneEncoder(
        net=tm.MLP(3, 128, 2, torch.float16),
        rnn=tm.LSTM(128, 128, 1, torch.float16, fuse_input_proj=True),
        use_fused_step=True)
    x = torch.randn(8, 3, generator=torch.Generator().manual_seed(0))
    assert not tower._fused_step_applicable(x.half())
    calls = []
    monkeypatch.setattr(lstm_mod, "lstm_sequence_proj",
                        lambda *a: calls.append("proj"))
    orig = lstm_mod.lstm_sequence
    monkeypatch.setattr(lstm_mod, "lstm_sequence",
                        lambda *a: calls.append("seq") or orig(*a))
    with torch.no_grad():
        tower(tower.init_recurrent_state(8), x)
        # [T = 2, N = 4] sequences, their inputs flattened to [T * N, 3].
        tower.sequence(tower.init_recurrent_state(4),
                       torch.zeros(2, 4, 1, dtype=torch.bool), x)
    assert calls == ["seq"]


def test_two_update_iters_float16_lstm():
    spec = dict(_spec("fp16"),
                jax_model=lambda: _jax_actor_critic(jnp.float16, H),
                torch_model=lambda: _torch_actor_critic(torch.float16, H))
    _, snaps, _ = run_two_update_iters(spec)
    nonfinite = sum(int(s["stats"]["nonfinite_steps"]) for s in snaps)
    assert float(snaps[-1]["scaler"]["scale"]) == 65536.0 * 0.5 ** nonfinite
    for s in snaps:
        assert all(p.dtype == torch.float32 and bool(p.isfinite().all())
                   for p in s["params"].values())
