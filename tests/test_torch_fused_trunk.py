"""The fused-trunk configuration of the port against the JAX package.

Covers ``fused_policy_step`` (the whole MLP + LSTM trunk of one rollout
step), ``lstm_sequence_proj`` (the BPTT pass with the input projection
inside the kernel), the encoder's ``use_fused_step`` gate and the LSTM's
``fuse_input_proj`` option. On the CPU the port takes the plain versions
and the JAX package its jnp twins, as the JAX package's own tests run them
off the TPU. Inputs are made with numpy from a seed; comparisons are in
float32 unless stated. The last tests run two ``update_iter``s of a small
fused-trunk trainer in both packages (the machinery of
``test_torch_slice.py``).
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
import madrona_learn_tpu_torch.models.actor_critic as ac_mod
import test_torch_slice as slice_test
from madrona_learn_tpu.ops.pallas.lstm import (
    lstm_sequence_proj_reference as jax_lstm_sequence_proj_reference,
)
from madrona_learn_tpu.ops.pallas.policy_step import (
    fused_policy_step_reference as jax_fused_policy_step_reference,
)
from madrona_learn_tpu_torch.compat.from_jax import actor_critic_state_dict
from madrona_learn_tpu_torch.config import DiscreteActionsConfig
from madrona_learn_tpu_torch.ops.cuda.lstm import (
    lstm_proj_supported,
    lstm_sequence_proj,
)
from madrona_learn_tpu_torch.ops.cuda.policy_step import (
    fused_policy_step,
    policy_step_supported,
)
from test_torch_models import _load, _np, _perturb

# Two update_iters of the fused-trunk trainer, with the slice test's checks
# (rollout data, gradients and Adam state, parameters, normalizer and
# metrics) run against this module's fixtures.
from test_torch_slice import (  # noqa: F401
    test_gradients_and_optimizer_state_match_jax,
    test_obs_normalizer_and_metrics_match_jax,
    test_parameters_match_jax,
    test_rollout_data_matches_jax,
)

torch.set_num_threads(1)

H = 128
F32 = dict(rtol=1e-5, atol=1e-5)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _step_inputs(rng, N, F, layers, dt):
    """numpy inputs of the fused step, as tests/test_fused_policy_step.py
    draws them; the weights and carry pre-rounded to dt."""
    def cast(a):
        return np.asarray(jnp.asarray(a, jnp.float32).astype(dt)
                          .astype(jnp.float32))

    x = cast(rng.normal(size=(N, F)))
    mlp, fin = [], F
    for _ in range(layers):
        mlp.append((cast(0.2 * rng.normal(size=(fin, H))),
                    (1 + 0.1 * rng.normal(size=H)).astype(np.float32),
                    (0.1 * rng.normal(size=H)).astype(np.float32)))
        fin = H
    wi = cast(0.1 * rng.normal(size=(H, 4 * H)))
    wr = cast(0.1 * rng.normal(size=(H, 4 * H)))
    b = np.linspace(-0.1, 0.1, 4 * H, dtype=np.float32)
    c, h = cast(rng.normal(size=(N, H))), cast(rng.normal(size=(N, H)))
    return x, mlp, wi, wr, b, c, h


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,layers", [(64, 1), (64, 2), (300, 1), (300, 2)])
def test_policy_step_reference_matches_jax(dtype, N, layers):
    jdt, tdt = DTYPES[dtype]
    x, mlp, wi, wr, b, c, h = _step_inputs(
        np.random.default_rng(N + layers), N, 3, layers, jdt)
    want_out, (want_c, want_h) = jax_fused_policy_step_reference(
        jnp.asarray(x, jdt),
        [(jnp.asarray(w, jdt), jnp.asarray(s), jnp.asarray(lb))
         for w, s, lb in mlp],
        jnp.asarray(wi, jdt), jnp.asarray(wr, jdt), jnp.asarray(b),
        jnp.asarray(c, jdt), jnp.asarray(h, jdt))

    def t(a, dt=tdt):
        return torch.from_numpy(np.array(a)).to(dt)

    out, (c_new, h_new) = fused_policy_step(
        t(x), [(t(w), t(s, torch.float32), t(lb, torch.float32))
               for w, s, lb in mlp], t(wi), t(wr), t(b), t(c), t(h))
    assert out.dtype == c_new.dtype == h_new.dtype == tdt
    # float32: the products and row sums add in another order, and the
    # LayerNorm affine associates as flax's does; bfloat16: a last-bit f32
    # difference can flip one storage rounding (tests/test_fused_policy_
    # step.py:57).
    atol = 1e-5 if dtype == "float32" else 2e-2
    for got, want in ((out, want_out), (c_new, want_c), (h_new, want_h)):
        np.testing.assert_allclose(_np(got.float()),
                                   np.asarray(want.astype(jnp.float32)),
                                   rtol=0, atol=atol)


def _jax_encoder(dtype, fused, layers=2, fuse_input_proj=False):
    return jm.RecurrentBackboneEncoder(
        net=jm.MLP(num_channels=H, num_layers=layers, dtype=dtype),
        rnn=jm.LSTM(num_hidden_channels=H, num_layers=1, dtype=dtype,
                    use_pallas=True, fuse_input_proj=fuse_input_proj),
        use_fused_step=fused)


def _torch_encoder(dtype, fused, layers=2, fuse_input_proj=False):
    return tm.RecurrentBackboneEncoder(
        net=tm.MLP(3, H, layers, dtype),
        rnn=tm.LSTM(H, H, 1, dtype, fuse_input_proj=fuse_input_proj),
        use_fused_step=fused)


def _encoder_params(rng, N):
    """Flax parameters of the encoder, with LayerNorm affines and the LSTM
    bias away from their init."""
    enc = _jax_encoder(jnp.float32, False)
    rnn0 = enc.init_recurrent_state(N)
    x = jnp.zeros((N, 3), jnp.float32)
    return _perturb(enc.init(random.PRNGKey(1), rnn0, x, train=False)
                    ["params"], rng)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_encoder_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    N = 70
    rng = np.random.default_rng(11)
    params = _encoder_params(rng, N)
    x = rng.normal(size=(N, 3)).astype(np.float32)
    c0, h0 = (0.5 * rng.normal(size=(N, 1, H)).astype(np.float32)
              for _ in range(2))
    j_carry = (jnp.asarray(c0, jdt), jnp.asarray(h0, jdt))
    want, (want_c, want_h) = _jax_encoder(jdt, True).apply(
        {"params": params}, j_carry, jnp.asarray(x, jdt), train=False)

    enc = _load(_torch_encoder(tdt, True), params)
    assert enc._fused_step_applicable(torch.from_numpy(x).to(tdt))
    with torch.no_grad():
        got, (got_c, got_h) = enc(
            (torch.from_numpy(c0).to(tdt), torch.from_numpy(h0).to(tdt)),
            torch.from_numpy(x).to(tdt))
    tol = F32 if dtype == "float32" else dict(rtol=0, atol=2e-2)
    for g, w in ((got, want), (got_c, want_c), (got_h, want_h)):
        assert g.dtype == tdt and tuple(g.shape) == w.shape
        np.testing.assert_allclose(_np(g.float()),
                                   np.asarray(w.astype(jnp.float32)), **tol)


def test_fused_encoder_exact_fp32():
    """The fused step equals the port's unfused modules bitwise in float32
    (JAX: test_fused_encoder_exact_fp32)."""
    N = 70
    rng = np.random.default_rng(12)
    params = _encoder_params(rng, N)
    fused = _load(_torch_encoder(torch.float32, True), params)
    unfused = _load(_torch_encoder(torch.float32, False), params)
    x = torch.from_numpy(rng.normal(size=(N, 3)).astype(np.float32))
    carry = tuple(torch.from_numpy(rng.normal(size=(N, 1, H))
                                   .astype(np.float32)) for _ in range(2))
    with torch.no_grad():
        out_f, carry_f = fused(carry, x)
        out_u, carry_u = unfused(carry, x)
    torch.testing.assert_close(out_f, out_u, rtol=0, atol=0)
    for a, b in zip(carry_f, carry_u):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_fused_steps_match_sequence():
    """T fused rollout steps with clears track the update-time sequence pass
    (fused projection) within 1e-6: the PPO ratio argument."""
    T, N = 5, 33
    rng = np.random.default_rng(13)
    enc = _load(_torch_encoder(torch.float32, True, fuse_input_proj=True),
                _encoder_params(rng, N))
    xs = torch.from_numpy(rng.normal(size=(T, N, 3)).astype(np.float32))
    ends = torch.zeros((T, N, 1), dtype=torch.bool)
    ends[2, ::3] = True
    outs, carry = [], enc.init_recurrent_state(N)
    with torch.no_grad():
        for t in range(T):
            out, carry = enc(carry, xs[t])
            carry = enc.clear_recurrent_state(carry, ends[t])
            outs.append(out)
        seq = enc.sequence(enc.init_recurrent_state(N), ends,
                           xs.reshape(T * N, 3)).reshape(T, N, -1)
    torch.testing.assert_close(torch.stack(outs), seq, rtol=0, atol=1e-6)


def test_supported_gates():
    assert policy_step_supported(256, 3, torch.bfloat16)
    assert not policy_step_supported(200, 3, torch.bfloat16)   # H % 128
    assert not policy_step_supported(256, 200, torch.bfloat16)  # F > 128
    assert not policy_step_supported(256, 3, torch.float16)
    assert lstm_proj_supported(256, 256, torch.bfloat16)
    assert lstm_proj_supported(1024, 256, torch.float32)
    assert not lstm_proj_supported(3, 256, torch.bfloat16)      # F % 128
    assert not lstm_proj_supported(1152, 256, torch.bfloat16)   # F > 4H
    assert not lstm_proj_supported(256, 200, torch.bfloat16)    # H % 128
    assert not lstm_proj_supported(256, 256, torch.float16)


def test_mismatched_towers_fall_back(monkeypatch):
    """Towers the fused step cannot serve take the unfused modules and
    still run (JAX: test_mismatched_towers_fall_back)."""
    def refuse(*args):
        raise AssertionError("fused_policy_step called for a tower it "
                             "cannot serve")

    monkeypatch.setattr(ac_mod, "fused_policy_step", refuse)
    N = 16
    x32 = torch.from_numpy(
        np.random.default_rng(14).normal(size=(N, 3)).astype(np.float32))
    towers = [
        # MLP wider than the LSTM.
        (tm.MLP(3, 256, 1, torch.float32),
         tm.LSTM(256, 128, 1, torch.float32), x32),
        # Mixed dtypes across the trunk.
        (tm.MLP(3, 128, 1, torch.float32),
         tm.LSTM(128, 128, 1, torch.bfloat16), x32),
        # Two LSTM layers.
        (tm.MLP(3, 128, 1, torch.float32),
         tm.LSTM(128, 128, 2, torch.float32), x32),
        # A width without the kernel's tiling.
        (tm.MLP(3, 96, 1, torch.float32),
         tm.LSTM(96, 96, 1, torch.float32), x32),
        # An input wider than 128 features.
        (tm.MLP(200, 128, 1, torch.float32),
         tm.LSTM(128, 128, 1, torch.float32), torch.randn(N, 200)),
    ]
    for net, rnn, x in towers:
        enc = tm.RecurrentBackboneEncoder(net=net, rnn=rnn,
                                          use_fused_step=True)
        assert not enc._fused_step_applicable(x)
        with torch.no_grad():
            out, _ = enc(enc.init_recurrent_state(N), x)
        assert torch.isfinite(out.float()).all()
    # A rank-3 input (an entity axis) is not the kernel's either.
    enc = _torch_encoder(torch.float32, True)
    assert not enc._fused_step_applicable(torch.zeros(N, 4, 3))


def test_parameter_tree_unchanged():
    """The fused options only read the existing parameters: the same names
    and shapes, and the JAX package's parameters load into either."""
    N = 8
    params = _encoder_params(np.random.default_rng(15), N)
    plain = _torch_encoder(torch.float32, False)
    fused = _torch_encoder(torch.float32, True, fuse_input_proj=True)
    assert ({k: v.shape for k, v in plain.state_dict().items()}
            == {k: v.shape for k, v in fused.state_dict().items()})
    _load(fused, params)
    _load(plain, params)
    for name, value in fused.state_dict().items():
        torch.testing.assert_close(value, plain.state_dict()[name])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_trunk_hands_the_kernels_valid_operands(monkeypatch, dtype):
    """The CUDA wrappers raise on non-contiguous or mixed-dtype operands,
    which the CPU path does not check: the fused-trunk model must pass
    contiguous operands in the storage dtype (the LayerNorm parameters in
    float32), from minibatch slices too."""
    import madrona_learn_tpu_torch.models.lstm as lstm_mod
    from madrona_learn_tpu_torch.rollouts import RolloutData

    tdt = DTYPES[dtype][1]
    seen = []

    def check(*tensors, f32=()):
        for i, t in enumerate(tensors):
            assert t.is_contiguous(), i
            assert t.dtype == (torch.float32 if i in f32 else tdt), i

    def checking_step(x, mlp, wi, wr, bias, c, h):
        flat = [x] + [p for layer in mlp for p in layer] + [wi, wr, bias, c,
                                                             h]
        check(*flat, f32={2 + 3 * i for i in range(len(mlp))}
              | {3 + 3 * i for i in range(len(mlp))})
        seen.append("step")
        return fused_policy_step(x, mlp, wi, wr, bias, c, h)

    def checking_proj(*args):
        check(*args)
        seen.append("proj")
        return lstm_sequence_proj(*args)

    monkeypatch.setattr(ac_mod, "fused_policy_step", checking_step)
    monkeypatch.setattr(lstm_mod, "lstm_sequence_proj", checking_proj)
    ac = tm.ActorCritic(
        backbone=tm.BackboneShared(
            prefix=lambda obs: torch.cat([obs["delta"], obs["time"]], -1),
            encoder=_torch_encoder(tdt, True, fuse_input_proj=True)),
        actor=tm.DictActor({"move": tm.DenseLayerDiscreteActor(
            DiscreteActionsConfig(actions_num_buckets=[5]), H, tdt)}),
        critic=tm.DenseLayerCritic(H, tdt))
    rng = np.random.default_rng(18)
    S, TC = 6, 4
    data = RolloutData({
        "obs": {"delta": torch.from_numpy(
                    rng.normal(size=(S, TC, 2)).astype(np.float32)),
                "time": torch.from_numpy(
                    rng.random((S, TC, 1)).astype(np.float32))},
        "dones": torch.from_numpy(rng.random((S, TC, 1)) < 0.3),
        "actions": {"move": torch.from_numpy(
            rng.integers(0, 5, (S, TC, 1)).astype(np.int32))},
        "rnn_start_states": tuple(torch.zeros(S, 1, H, dtype=tdt)
                                  for _ in range(2)),
    })
    mb = data.minibatch(torch.tensor([4, 1, 3]))
    out = ac.update(mb["rnn_start_states"], mb["dones"], mb["actions"],
                    mb["obs"])
    out["log_probs"]["move"].float().sum().backward()
    with torch.no_grad():
        ac.rollout(torch.Generator().manual_seed(0),
                   ac.init_recurrent_state(3),
                   {k: v[0] for k, v in mb["obs"].items()})
        ac.critic_only(ac.init_recurrent_state(3),
                       {k: v[0] for k, v in mb["obs"].items()})
    assert seen == ["proj", "step", "step"]


def test_lstm_sequence_proj_reference_and_grads_match_jax():
    T, N, F = 5, 40, 128
    rng = np.random.default_rng(16)
    x = rng.normal(size=(T, N, F)).astype(np.float32)
    keep = (rng.random((T, N)) > 0.25).astype(np.float32)
    wi = (0.1 * rng.normal(size=(F, 4 * H))).astype(np.float32)
    wr = (0.1 * rng.normal(size=(H, 4 * H))).astype(np.float32)
    b = (0.1 * rng.normal(size=4 * H)).astype(np.float32)
    c0, h0 = (rng.normal(size=(N, H)).astype(np.float32) for _ in range(2))
    probe = rng.normal(size=(T, N, H)).astype(np.float32)

    diff_args = (x, wi, wr, b, c0, h0)

    def jax_fn(x_, wi_, wr_, b_, c0_, h0_):
        return jax_lstm_sequence_proj_reference(
            x_, jnp.asarray(keep), wi_, wr_, b_, c0_, h0_)

    want, vjp = jax.vjp(jax_fn, *(jnp.asarray(a) for a in diff_args))
    want_grads = vjp(jnp.asarray(probe))

    leaves = [torch.from_numpy(a).requires_grad_() for a in diff_args]
    xt, wit, wrt, bt, c0t, h0t = leaves
    got = lstm_sequence_proj(xt, torch.from_numpy(keep), wit, wrt, bt, c0t,
                             h0t)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)
    got_grads = torch.autograd.grad((got * torch.from_numpy(probe)).sum(),
                                    leaves)
    for name, g, w in zip(("dx", "dWi", "dWr", "db", "dc0", "dh0"),
                          got_grads, want_grads):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_lstm_fuse_input_proj_matches_jax():
    """LSTM(fuse_input_proj=True), two layers at F = 128: the sequence
    output and every gradient, input_proj kernels included."""
    T, N, F, L = 4, 24, 128, 2
    rng = np.random.default_rng(17)
    xs = rng.normal(size=(T, N, F)).astype(np.float32)
    dones = rng.random((T, N, 1)) < 0.25
    c0, h0 = (rng.normal(size=(N, L, H)).astype(np.float32)
              for _ in range(2))
    probe = rng.normal(size=(T, N, L * H)).astype(np.float32)
    flax_lstm = jm.LSTM(num_hidden_channels=H, num_layers=L,
                        dtype=jnp.float32, use_pallas=True,
                        fuse_input_proj=True)
    params = _perturb(flax_lstm.init(
        random.PRNGKey(2), (jnp.asarray(c0), jnp.asarray(h0)),
        jnp.asarray(xs[0]), False)["params"], rng)

    def loss_j(p):
        out = flax_lstm.apply(
            {"params": p}, (jnp.asarray(c0), jnp.asarray(h0)),
            jnp.asarray(dones), jnp.asarray(xs), False, method="sequence")
        return jnp.sum(out * probe), out

    (_, want), g_j = jax.value_and_grad(loss_j, has_aux=True)(params)

    lstm = _load(tm.LSTM(F, H, L, torch.float32, fuse_input_proj=True),
                 params)
    out = lstm.sequence((torch.from_numpy(c0), torch.from_numpy(h0)),
                        torch.from_numpy(dones), torch.from_numpy(xs))
    np.testing.assert_allclose(_np(out), np.asarray(want), **F32)
    names, tensors = zip(*lstm.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(
        (out * torch.from_numpy(probe)).sum(), tensors)))
    want_grads = actor_critic_state_dict(g_j)
    assert sorted(grads) == sorted(want_grads)
    assert "layer_1.input_proj.kernel" in grads
    for name, want_g in want_grads.items():
        np.testing.assert_allclose(_np(grads[name]), want_g, rtol=1e-4,
                                   atol=1e-4, err_msg=name)


# --- two update_iters of a small fused-trunk trainer ----------------------


def _jax_fused_actor_critic():
    actions = mlt.DiscreteActionsConfig(actions_num_buckets=[5])
    return jm.ActorCritic(
        backbone=jm.BackboneShared(
            prefix=lambda obs, train: jnp.concatenate(
                [obs["delta"], obs["time"]], axis=-1),
            encoder=_jax_encoder(jnp.float32, True, fuse_input_proj=True)),
        actor=jm.DictActor(heads={"move": jm.DenseLayerDiscreteActor(
            cfg=actions, dtype=jnp.float32)}),
        critic=jm.DenseLayerCritic(dtype=jnp.float32))


def _torch_fused_actor_critic():
    return tm.ActorCritic(
        backbone=tm.BackboneShared(
            prefix=lambda obs: torch.cat([obs["delta"], obs["time"]], -1),
            encoder=_torch_encoder(torch.float32, True,
                                   fuse_input_proj=True)),
        actor=tm.DictActor({"move": tm.DenseLayerDiscreteActor(
            DiscreteActionsConfig(actions_num_buckets=[5]), H,
            torch.float32)}),
        critic=tm.DenseLayerCritic(H, torch.float32))


@pytest.fixture(scope="module")
def jax_run():
    return slice_test.run_jax(_jax_fused_actor_critic())


@pytest.fixture(scope="module")
def torch_run(jax_run):
    calls = []

    def counting_step(*args):
        calls.append(1)
        return fused_policy_step(*args)

    mp = pytest.MonkeyPatch()
    mp.setattr(ac_mod, "fused_policy_step", counting_step)
    try:
        out = slice_test.run_torch(jax_run, _torch_fused_actor_critic())
    finally:
        mp.undo()
    # Every rollout step and both bootstrap values took the fused step.
    assert len(calls) == 2 * (slice_test.STEPS + 1)
    return out
