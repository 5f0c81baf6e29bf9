"""The GRU family of the port against the JAX package.

Covers ``gru_sequence`` (the plain twin of the ``gru_sequence_fwd`` /
``gru_sequence_bwd`` kernels, which the CPU takes) against the Pallas
kernel in interpret mode and its jnp twin, the ``GRU`` module against
flax's ``GRU(use_pallas=True)`` on both of its routes, the bf16 rounding
contract that lets PPO's ratio start at 1, the parameter conversion, and
two ``update_iter``s of a small MLP + GRU trainer in both packages (the
machinery of ``test_torch_slice.py``). Inputs are made with numpy from a
seed; comparisons are in float32 unless stated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

import madrona_learn_tpu as mlt
import madrona_learn_tpu.models as jm
import madrona_learn_tpu.models.attention as jax_attention
import madrona_learn_tpu.ops.pallas.gru as jax_gru
import madrona_learn_tpu_torch.models as tm
import madrona_learn_tpu_torch.models.gru as gru_mod
import test_torch_slice as slice_test
from madrona_learn_tpu_torch.compat.from_jax import actor_critic_state_dict
from madrona_learn_tpu_torch.config import DiscreteActionsConfig
from madrona_learn_tpu_torch.ops.cuda import KERNELS
from madrona_learn_tpu_torch.ops.cuda.gru import (
    gru_sequence,
    gru_sequence_bwd,
    gru_sequence_fwd,
    gru_sequence_reference,
    gru_step,
    gru_supported,
)
from test_torch_models import _checking, _np, _obs

# Two update_iters of the MLP + GRU trainer, with the slice test's checks
# (rollout data, gradients and Adam state, parameters, normalizer and
# metrics) run against this module's fixtures.
from test_torch_slice import (  # noqa: F401
    test_gradients_and_optimizer_state_match_jax,
    test_obs_normalizer_and_metrics_match_jax,
    test_parameters_match_jax,
    test_rollout_data_matches_jax,
)

torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-5)


def _launches():
    return {k.name: k.launches for k in KERNELS}


def _gru_inputs(seed, T, N, H, jdt=jnp.float32):
    """The distribution tests/test_pallas_kernels.py:_gru_rand draws, as
    float32 numpy arrays rounded to ``jdt``."""
    rng = np.random.default_rng(seed)

    def cast(a):
        return np.asarray(jnp.asarray(a, jnp.float32).astype(jdt)
                          .astype(jnp.float32))

    return (cast(rng.normal(size=(T, N, 3 * H))),
            (rng.random((T, N)) > 0.2).astype(np.float32),
            cast(rng.normal(size=(H, 3 * H)) / np.sqrt(H)),
            cast(rng.normal(size=(H,))),
            cast(rng.normal(size=(N, H))))


@pytest.mark.parametrize("T,N,H", [(5, 70, 128), (1, 9, 128)])
def test_plain_forward_matches_pallas(T, N, H):
    args = _gru_inputs(20 + T, T, N, H)
    before = _launches()
    got = gru_sequence(*map(torch.tensor, args))
    assert _launches() == before  # CPU tensors never launch a kernel
    want_kernel = jax_gru.gru_sequence(*map(jnp.asarray, args), True)
    want_twin = jax_gru.gru_sequence_reference(*map(jnp.asarray, args))
    # Same f32 math; the products sum in another order (test_pallas_kernels
    # holds the Pallas kernel to its own twin with the same 1e-5).
    for want in (want_kernel, want_twin):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_plain_forward_bf16_within_one_ulp():
    T, N, H = 5, 70, 128
    args = _gru_inputs(25, T, N, H, jnp.bfloat16)
    got = gru_sequence(*(torch.tensor(a).to(torch.bfloat16) for a in args))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in args]
    for want in (jax_gru.gru_sequence(*jargs, True),
                 jax_gru.gru_sequence_reference(*jargs)):
        # One bf16 ulp at 1 (2^-7), the scale of the gates and of h: a
        # last-bit f32 difference in the products may flip one rounding,
        # and the carry takes it into later steps (measured: at most 2^-8).
        np.testing.assert_allclose(got, np.asarray(want.astype(jnp.float32)),
                                   rtol=0, atol=2.0 ** -7)


def test_plain_gradients_match_pallas():
    T, N, H = 4, 70, 128
    args = _gru_inputs(21, T, N, H)
    probe = np.random.default_rng(22).normal(size=(T, N, H)).astype(
        np.float32)
    keep = args[1]

    def loss_jax(xp, wh, bh, h0):
        ys = jax_gru.gru_sequence(xp, jnp.asarray(keep), wh, bh, h0, True)
        return jnp.sum(ys * jnp.asarray(probe))

    diff = (args[0],) + args[2:]
    want = jax.grad(loss_jax, argnums=tuple(range(4)))(
        *map(jnp.asarray, diff))

    leaves = [torch.tensor(a, requires_grad=True) for a in diff]
    ys = gru_sequence(leaves[0], torch.from_numpy(keep), *leaves[1:])
    got = torch.autograd.grad((ys * torch.from_numpy(probe)).sum(), leaves)
    # Tolerance of the JAX package's own kernel-vs-twin gradient test.
    for g, w, name in zip(got, want, ("dxp", "dwh", "dbh", "dh0")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gru_step_is_the_first_sequence_step(dtype):
    """The rollout step and the sequence pass round at the same points, so
    one step equals the first step of a T = 1 sequence bit for bit."""
    xp, keep, wh, bh, h0 = (torch.tensor(a).to(dtype)
                            for a in _gru_inputs(23, 1, 33, 128))
    new_h = gru_step(xp[0], wh, bh, h0)
    ys = gru_sequence_reference(xp, torch.ones_like(keep), wh, bh, h0)
    assert new_h.dtype == dtype
    torch.testing.assert_close(new_h, ys[0], rtol=0, atol=0)


def test_kernel_wrappers_never_fall_back():
    """Tensors on a device that is not the CPU go to the kernel path, which
    refuses anything it cannot launch instead of taking the plain
    version."""
    before = _launches()
    meta = lambda *shape, dtype=torch.float32: torch.empty(
        *shape, dtype=dtype, device="meta")
    T, N, H = 2, 8, 128
    seq = (meta(T, N, 3 * H), meta(T, N), meta(H, 3 * H), meta(H),
           meta(N, H))
    with pytest.raises(ValueError):
        gru_sequence(*seq)
    with pytest.raises(ValueError):
        gru_sequence_fwd(*seq)
    with pytest.raises(ValueError):
        gru_sequence_bwd(*seq, meta(T, N, H), meta(T, N, H))
    with pytest.raises(ValueError):
        gru_step(meta(N, 3 * H), meta(H, 3 * H), meta(H), meta(N, H))
    # A width without an instantiation is refused too.
    with pytest.raises(ValueError):
        gru_sequence(meta(T, N, 3 * 96), meta(T, N), meta(96, 3 * 96),
                     meta(96), meta(N, 96))
    assert _launches() == before


def test_gru_supported():
    assert gru_supported(128, torch.float32)
    assert gru_supported(256, torch.bfloat16)
    assert not gru_supported(96, torch.float32)     # no instantiation
    assert not gru_supported(384, torch.bfloat16)   # no instantiation
    # The float16 instances (CUDA cores); JAX's gate sends float16 to its
    # jnp twin instead.
    assert gru_supported(256, torch.float16)


# --- the GRU module --------------------------------------------------------


def _perturb_gru(params, rng):
    """Nonzero biases (both are zero at init, which would hide a rounding
    point)."""
    return jax.tree.map(
        lambda l: (jnp.asarray(np.asarray(l) + 0.3 * rng.normal(size=l.shape),
                               jnp.float32) if l.ndim == 1 else l), params)


def _flax_gru(H, L, jdt):
    return jm.GRU(num_hidden_channels=H, num_layers=L, dtype=jdt,
                  use_pallas=True)


def _module_case(seed, T, N, F, H, L):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(T, N, F)).astype(np.float32)
    dones = rng.random((T, N, 1)) < 0.25
    h0 = (0.5 * rng.normal(size=(N, L, H))).astype(np.float32)
    params = _perturb_gru(_flax_gru(H, L, jnp.float32).init(
        random.PRNGKey(seed), jnp.asarray(h0), jnp.asarray(xs[0]),
        False)["params"], rng)
    return xs, dones, h0, params


def _torch_gru(params, F, H, L, dtype=torch.float32):
    gru = tm.GRU(F, H, L, dtype)
    gru.load_state_dict({k: torch.from_numpy(v) for k, v in
                         actor_critic_state_dict(params).items()},
                        strict=True)
    return gru


@pytest.fixture
def gru_kernel_route():
    """Route flax's GRU(use_pallas=True) through the Pallas kernel in
    interpret mode (JAX: test_gru_kernel_module_path_matches_twin)."""
    orig_seq, orig_ok = jax_gru.gru_sequence, jax_attention._pallas_backend_ok
    jax_gru.gru_sequence = lambda *a, **kw: orig_seq(*a, True)
    jax_attention._pallas_backend_ok = lambda: True
    try:
        yield
    finally:
        jax_gru.gru_sequence = orig_seq
        jax_attention._pallas_backend_ok = orig_ok


@pytest.mark.parametrize("route", ["jax_cpu", "pallas_interpret"])
def test_gru_module_matches_jax(request, route):
    """GRU, two layers at H = 128 with nonzero biases, float32: the rollout
    step, the sequence pass and every gradient of the sequence pass."""
    if route == "pallas_interpret":
        request.getfixturevalue("gru_kernel_route")
    T, N, F, H, L = 5, 24, 16, 128, 2
    xs, dones, h0, params = _module_case(30, T, N, F, H, L)
    flax_gru = _flax_gru(H, L, jnp.float32)
    probe = np.random.default_rng(31).normal(size=(T, N, L * H)).astype(
        np.float32)
    gru = _torch_gru(params, F, H, L)

    want_out, want_h = flax_gru.apply({"params": params}, jnp.asarray(h0),
                                      jnp.asarray(xs[0]), False)
    with torch.no_grad():
        got_out, got_h = gru(torch.from_numpy(h0), torch.from_numpy(xs[0]))
    np.testing.assert_allclose(_np(got_out), np.asarray(want_out), **F32)
    np.testing.assert_allclose(_np(got_h), np.asarray(want_h), **F32)

    def loss_j(p):
        out = flax_gru.apply({"params": p}, jnp.asarray(h0),
                             jnp.asarray(dones), jnp.asarray(xs), False,
                             method="sequence")
        return jnp.sum(out * probe), out

    (_, want), g_j = jax.value_and_grad(loss_j, has_aux=True)(params)
    out = gru.sequence(torch.from_numpy(h0), torch.from_numpy(dones),
                       torch.from_numpy(xs))
    np.testing.assert_allclose(_np(out), np.asarray(want), **F32)
    names, tensors = zip(*gru.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(
        (out * torch.from_numpy(probe)).sum(), tensors)))
    want_grads = actor_critic_state_dict(g_j)
    assert sorted(grads) == sorted(want_grads)
    for name, want_g in want_grads.items():
        assert np.any(want_g != 0), name
        np.testing.assert_allclose(_np(grads[name]), want_g, rtol=1e-4,
                                   atol=1e-4, err_msg=name)


@pytest.mark.parametrize("layers", [1, 2])
def test_gru_stepwise_equals_sequence_bf16(layers):
    """bf16 with nonzero biases: the rollout steps with clears equal the
    update-time sequence pass bit for bit, the PPO-ratio contract (JAX:
    test_recurrent_module_fused_matches_stepwise_bf16)."""
    T, N, F, H = 10, 6, 8, 128
    xs, dones, _, params = _module_case(33, T, N, F, H, layers)
    gru = _torch_gru(params, F, H, layers, torch.bfloat16)
    xs_t = torch.from_numpy(xs).to(torch.bfloat16)
    ends = torch.from_numpy(dones)
    state, outs = gru.init_recurrent_state(N), []
    with torch.no_grad():
        for t in range(T):
            out, state = gru(state, xs_t[t])
            state = gru.clear_recurrent_state(state, ends[t])
            outs.append(out)
        seq = gru.sequence(gru.init_recurrent_state(N), ends, xs_t)
    assert seq.dtype == torch.bfloat16
    torch.testing.assert_close(torch.stack(outs), seq, rtol=0, atol=0)


def test_converted_gru_tree_loads_strictly():
    """compat/from_jax.py carries the flax GRU tree across unchanged: the
    names, the [r | z | n] packing and the input-projection bias."""
    H, F = 128, 16
    params = _flax_gru(H, 2, jnp.float32).init(
        random.PRNGKey(0), jnp.zeros((3, 2, H)), jnp.zeros((3, F)),
        False)["params"]
    state = actor_critic_state_dict(params)
    assert {k: v.shape for k, v in state.items()} == {
        f"layer_{k}.{name}": shape
        for k, fin in ((0, F), (1, H))
        for name, shape in (("input_proj.kernel", (fin, 3 * H)),
                            ("input_proj.bias", (3 * H,)),
                            ("recurrent_kernel", (H, 3 * H)),
                            ("bias_h", (H,)))}
    gru = tm.GRU(F, H, 2, torch.float32)
    result = gru.load_state_dict({k: torch.from_numpy(v)
                                  for k, v in state.items()}, strict=True)
    assert not result.missing_keys and not result.unexpected_keys


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gru_model_hands_the_kernels_valid_operands(monkeypatch, dtype):
    """Minibatch slices are transposed views; the GRU model must still pass
    the kernel wrappers contiguous operands of one dtype."""
    from madrona_learn_tpu_torch.rollouts import RolloutData

    seen = []

    def record(fn, kind):
        checked = _checking(fn, kind)

        def wrapped(*args):
            seen.append(kind)
            return checked(*args)
        return wrapped

    monkeypatch.setattr(gru_mod, "gru_sequence",
                        record(gru_mod.gru_sequence, "sequence"))
    monkeypatch.setattr(gru_mod, "gru_step", record(gru_mod.gru_step, "step"))
    ac = _torch_gru_actor_critic(dtype, 32)
    rng = np.random.default_rng(34)
    S, TC, H = 6, 4, 32
    data = RolloutData({
        "obs": {k: torch.from_numpy(v) for k, v in _obs(rng, S, TC).items()},
        "dones": torch.from_numpy(rng.random((S, TC, 1)) < 0.3),
        "actions": {"move": torch.from_numpy(
            rng.integers(0, 5, (S, TC, 1)).astype(np.int32))},
        "rnn_start_states": torch.zeros(S, 1, H, dtype=dtype),
    })
    mb = data.minibatch(torch.tensor([4, 1, 3]))
    out = ac.update(mb["rnn_start_states"], mb["dones"], mb["actions"],
                    mb["obs"])
    assert out["log_probs"]["move"].shape == (TC, 3, 1)
    out["log_probs"]["move"].float().sum().backward()
    with torch.no_grad():
        ac.rollout(torch.Generator().manual_seed(0),
                   ac.init_recurrent_state(3),
                   {k: v[0] for k, v in mb["obs"].items()})
    assert seen == ["sequence", "step"]


# --- two update_iters of a small MLP + GRU trainer -------------------------


def _jax_gru_actor_critic(hidden=slice_test.H):
    actions = mlt.DiscreteActionsConfig(actions_num_buckets=[5])
    return jm.ActorCritic(
        backbone=jm.BackboneShared(
            prefix=lambda obs, train: jnp.concatenate(
                [obs["delta"], obs["time"]], axis=-1),
            encoder=jm.RecurrentBackboneEncoder(
                net=jm.MLP(num_channels=hidden, num_layers=2,
                           dtype=jnp.float32),
                rnn=_flax_gru(hidden, 1, jnp.float32))),
        actor=jm.DictActor(heads={"move": jm.DenseLayerDiscreteActor(
            cfg=actions, dtype=jnp.float32)}),
        critic=jm.DenseLayerCritic(dtype=jnp.float32))


def _torch_gru_actor_critic(dtype=torch.float32, hidden=slice_test.H):
    return tm.ActorCritic(
        backbone=tm.BackboneShared(
            prefix=lambda obs: torch.cat([obs["delta"], obs["time"]], -1),
            encoder=tm.RecurrentBackboneEncoder(
                net=tm.MLP(3, hidden, 2, dtype),
                rnn=tm.GRU(hidden, hidden, 1, dtype))),
        actor=tm.DictActor({"move": tm.DenseLayerDiscreteActor(
            DiscreteActionsConfig(actions_num_buckets=[5]), hidden,
            dtype)}),
        critic=tm.DenseLayerCritic(hidden, dtype))


@pytest.fixture(scope="module")
def jax_run():
    return slice_test.run_jax(_jax_gru_actor_critic())


@pytest.fixture(scope="module")
def torch_run(jax_run):
    return slice_test.run_torch(jax_run, _torch_gru_actor_critic())
