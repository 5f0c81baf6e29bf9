"""The port's models against the JAX package's flax modules.

Parameters are initialized by flax, carried over by
``madrona_learn_tpu_torch.compat.from_jax``, and both packages get the same
numpy-seeded inputs. The JAX LSTM runs with ``use_pallas=True`` (precise
gates); on the CPU its sequence pass takes the kernel's jnp twin, as the
JAX package's own tests run it. Comparisons are in float32 unless stated.
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
from madrona_learn_tpu_torch.compat.from_jax import actor_critic_state_dict
from madrona_learn_tpu_torch.config import DiscreteActionsConfig

torch.set_num_threads(1)

# Same float32 math in both packages; matrix products and reductions sum in
# another order, which moves the last bits of each output.
F32 = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x,
                      dtype=np.float32)


def _load(module, flax_params):
    module.load_state_dict({k: torch.from_numpy(v) for k, v in
                            actor_critic_state_dict(flax_params).items()})
    return module


def _jax_actor_critic(dtype, hidden, mlp_layers=2, lstm_layers=1):
    actions = mlt.DiscreteActionsConfig(actions_num_buckets=[5])
    return jm.ActorCritic(
        backbone=jm.BackboneShared(
            prefix=lambda obs, train: jnp.concatenate(
                [obs["delta"], obs["time"]], axis=-1),
            encoder=jm.RecurrentBackboneEncoder(
                net=jm.MLP(num_channels=hidden, num_layers=mlp_layers,
                           dtype=dtype),
                rnn=jm.LSTM(num_hidden_channels=hidden,
                            num_layers=lstm_layers, dtype=dtype,
                            use_pallas=True))),
        actor=jm.DictActor(heads={"move": jm.DenseLayerDiscreteActor(
            cfg=actions, dtype=dtype)}),
        critic=jm.DenseLayerCritic(dtype=dtype))


def _torch_actor_critic(dtype, hidden, mlp_layers=2, lstm_layers=1):
    return tm.ActorCritic(
        backbone=tm.BackboneShared(
            prefix=lambda obs: torch.cat([obs["delta"], obs["time"]], -1),
            encoder=tm.RecurrentBackboneEncoder(
                net=tm.MLP(3, hidden, mlp_layers, dtype),
                rnn=tm.LSTM(hidden, hidden, lstm_layers, dtype))),
        actor=tm.DictActor({"move": tm.DenseLayerDiscreteActor(
            DiscreteActionsConfig(actions_num_buckets=[5]), hidden,
            dtype)}),
        critic=tm.DenseLayerCritic(hidden, dtype))


def _obs(rng, *lead):
    return {"delta": rng.normal(size=(*lead, 2)).astype(np.float32),
            "time": rng.random((*lead, 1)).astype(np.float32)}


def _perturb(params, rng):
    """Random LayerNorm affine and LSTM bias, so the comparisons do not
    rest on their identity / zero init."""
    def walk(tree, path=()):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = walk(v, path + (k,))
            elif k in ("scale", "bias"):
                out[k] = jnp.asarray(
                    np.asarray(v) + 0.3 * rng.normal(size=v.shape),
                    jnp.float32)
            else:
                out[k] = v
        return out
    return walk(params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_flax(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(1.0, 2.0, size=(64, 48)).astype(np.float32)
    scale = (1 + 0.2 * rng.normal(size=48)).astype(np.float32)
    bias = (0.3 * rng.normal(size=48)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jm.LayerNorm(dtype=jdt).apply(
        {"params": {"impl": {"scale": scale, "bias": bias}}},
        jnp.asarray(x, jdt))
    ln = tm.LayerNorm(48, tdt)
    ln.impl.scale.data = torch.from_numpy(scale)
    ln.impl.bias.data = torch.from_numpy(bias)
    got = ln(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    # bf16: both compute in f32 and round once at the end, so they agree up
    # to one bf16 ulp (2^-7 relative) where the f32 values straddle a
    # rounding boundary.
    tol = F32 if dtype == "float32" else dict(rtol=2 ** -7, atol=1e-6)
    np.testing.assert_allclose(_np(got.float()),
                               np.asarray(want.astype(jnp.float32)), **tol)


def test_mlp_matches_flax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(40, 3)).astype(np.float32)
    flax_mlp = jm.MLP(num_channels=32, num_layers=2, dtype=jnp.float32)
    params = _perturb(flax_mlp.init(random.PRNGKey(0), jnp.asarray(x),
                                    False)["params"], rng)
    mlp = tm.MLP(3, 32, 2, torch.float32)
    _load(mlp, params)
    np.testing.assert_allclose(
        _np(mlp(torch.from_numpy(x))),
        np.asarray(flax_mlp.apply({"params": params}, jnp.asarray(x),
                                  False)), **F32)


@pytest.mark.parametrize("layers", [1, 2])
def test_lstm_step_and_sequence_match_flax(layers):
    T, N, F, H = 6, 12, 8, 32
    rng = np.random.default_rng(2 + layers)
    xs = rng.normal(size=(T, N, F)).astype(np.float32)
    dones = rng.random((T, N, 1)) < 0.25
    c0 = rng.normal(size=(N, layers, H)).astype(np.float32)
    h0 = rng.normal(size=(N, layers, H)).astype(np.float32)
    flax_lstm = jm.LSTM(num_hidden_channels=H, num_layers=layers,
                        dtype=jnp.float32, use_pallas=True)
    params = _perturb(flax_lstm.init(
        random.PRNGKey(1), (jnp.asarray(c0), jnp.asarray(h0)),
        jnp.asarray(xs[0]), False)["params"], rng)
    lstm = _load(tm.LSTM(F, H, layers, torch.float32), params)

    out_j, (c_j, h_j) = flax_lstm.apply(
        {"params": params}, (jnp.asarray(c0), jnp.asarray(h0)),
        jnp.asarray(xs[0]), False)
    out_t, (c_t, h_t) = lstm((torch.from_numpy(c0), torch.from_numpy(h0)),
                             torch.from_numpy(xs[0]))
    for got, want in ((out_t, out_j), (c_t, c_j), (h_t, h_j)):
        np.testing.assert_allclose(_np(got), np.asarray(want), **F32)

    seq_j = flax_lstm.apply(
        {"params": params}, (jnp.asarray(c0), jnp.asarray(h0)),
        jnp.asarray(dones), jnp.asarray(xs), False, method="sequence")
    seq_t = lstm.sequence((torch.from_numpy(c0), torch.from_numpy(h0)),
                          torch.from_numpy(dones), torch.from_numpy(xs))
    np.testing.assert_allclose(_np(seq_t), np.asarray(seq_j), **F32)

    # The sequence pass equals stepping and clearing after each done.
    state = (torch.from_numpy(c0), torch.from_numpy(h0))
    outs = []
    for t in range(T):
        out, state = lstm(state, torch.from_numpy(xs[t]))
        state = lstm.clear_recurrent_state(state, torch.from_numpy(dones[t]))
        outs.append(out)
    np.testing.assert_allclose(_np(torch.stack(outs)), _np(seq_t), **F32)


def test_heads_match_flax():
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(10, 16)).astype(np.float32)
    cfg = mlt.DiscreteActionsConfig(actions_num_buckets=[3, 5])
    actor_j = jm.DenseLayerDiscreteActor(cfg=cfg, dtype=jnp.float32)
    p_actor = _perturb(actor_j.init(random.PRNGKey(2), jnp.asarray(feats))
                       ["params"], rng)
    actor_t = _load(tm.DenseLayerDiscreteActor(
        DiscreteActionsConfig(actions_num_buckets=[3, 5]), 16,
        torch.float32), p_actor)
    np.testing.assert_allclose(
        _np(actor_t(torch.from_numpy(feats)).all_logits),
        np.asarray(actor_j.apply({"params": p_actor},
                                 jnp.asarray(feats)).all_logits), **F32)

    critic_j = jm.DenseLayerCritic(dtype=jnp.float32)
    p_critic = _perturb(critic_j.init(random.PRNGKey(3), jnp.asarray(feats))
                        ["params"], rng)
    critic_t = _load(tm.DenseLayerCritic(16, torch.float32), p_critic)
    got = critic_t(torch.from_numpy(feats))
    assert got.dtype == torch.float32 and got.shape == (10, 1)
    np.testing.assert_allclose(
        _np(got), np.asarray(critic_j.apply({"params": p_critic},
                                            jnp.asarray(feats))), **F32)


def _actor_critic_pair(seed, hidden=32):
    rng = np.random.default_rng(seed)
    ac_j = _jax_actor_critic(jnp.float32, hidden)
    N = 12
    obs = _obs(rng, N)
    rnn = ac_j.init_recurrent_state(N)
    params = _perturb(ac_j.init(random.PRNGKey(seed), random.PRNGKey(0), rnn,
                                {k: jnp.asarray(v) for k, v in obs.items()},
                                method="rollout")["params"], rng)
    ac_t = _load(_torch_actor_critic(torch.float32, hidden), params)
    return ac_j, params, ac_t, rng


def test_actor_critic_rollout_and_critic_only_match_flax():
    ac_j, params, ac_t, rng = _actor_critic_pair(6)
    N, H = 12, 32
    obs = _obs(rng, N)
    c0 = rng.normal(size=(N, 1, H)).astype(np.float32)
    h0 = rng.normal(size=(N, 1, H)).astype(np.float32)
    j_obs = {k: jnp.asarray(v) for k, v in obs.items()}
    t_obs = {k: torch.from_numpy(v) for k, v in obs.items()}
    j_rnn = (jnp.asarray(c0), jnp.asarray(h0))
    t_rnn = (torch.from_numpy(c0), torch.from_numpy(h0))

    out_j, rnn_j = ac_j.apply({"params": params}, random.PRNGKey(0), j_rnn,
                              j_obs, sample_actions=False, method="rollout")
    with torch.no_grad():
        out_t, rnn_t = ac_t.rollout(None, t_rnn, t_obs, sample_actions=False)
    np.testing.assert_array_equal(_np(out_t["actions"]["move"]),
                                  np.asarray(out_j["actions"]["move"]))
    np.testing.assert_allclose(_np(out_t["critic"]),
                               np.asarray(out_j["critic"]), **F32)
    for got, want in zip(rnn_t, rnn_j):
        np.testing.assert_allclose(_np(got), np.asarray(want), **F32)

    crit_j, _ = ac_j.apply({"params": params}, j_rnn, j_obs,
                           method="critic_only")
    with torch.no_grad():
        crit_t, _ = ac_t.critic_only(t_rnn, t_obs)
    np.testing.assert_allclose(_np(crit_t["critic"]),
                               np.asarray(crit_j["critic"]), **F32)


def test_actor_critic_update_and_gradients_match_flax():
    ac_j, params, ac_t, rng = _actor_critic_pair(7)
    T, N, H = 5, 12, 32
    obs = _obs(rng, T, N)
    dones = rng.random((T, N, 1)) < 0.2
    actions = rng.integers(0, 5, size=(T, N, 1)).astype(np.int32)
    c0 = rng.normal(size=(N, 1, H)).astype(np.float32)
    h0 = rng.normal(size=(N, 1, H)).astype(np.float32)
    probe = rng.normal(size=(T, N, 1)).astype(np.float32)

    def loss_j(p):
        out = ac_j.apply({"params": p}, (jnp.asarray(c0), jnp.asarray(h0)),
                         jnp.asarray(dones), {"move": jnp.asarray(actions)},
                         {k: jnp.asarray(v) for k, v in obs.items()},
                         method="update")
        return (jnp.sum(out["log_probs"]["move"] * probe)
                + jnp.sum(out["entropies"]["move"])
                + jnp.sum(out["critic"] ** 2)), out

    (lj, out_j), g_j = jax.value_and_grad(loss_j, has_aux=True)(params)

    out_t = ac_t.update((torch.from_numpy(c0), torch.from_numpy(h0)),
                        torch.from_numpy(dones),
                        {"move": torch.from_numpy(actions)},
                        {k: torch.from_numpy(v) for k, v in obs.items()})
    lt = ((out_t["log_probs"]["move"] * torch.from_numpy(probe)).sum()
          + out_t["entropies"]["move"].sum() + (out_t["critic"] ** 2).sum())
    for key in ("log_probs", "entropies"):
        np.testing.assert_allclose(_np(out_t[key]["move"]),
                                   np.asarray(out_j[key]["move"]), **F32)
    np.testing.assert_allclose(_np(out_t["critic"]),
                               np.asarray(out_j["critic"]), **F32)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)

    names, tensors = zip(*ac_t.named_parameters())
    g_t = dict(zip(names, torch.autograd.grad(lt, tensors)))
    g_want = actor_critic_state_dict(g_j)
    assert sorted(g_t) == sorted(g_want)
    for name, want in g_want.items():
        np.testing.assert_allclose(_np(g_t[name]), want, rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def _checking(fn, kind):
    """Wrap a kernel entry point with the CUDA wrapper's operand checks
    (one dtype, contiguous), which the CPU path does not need."""
    def wrapped(*args):
        dtype = args[0].dtype
        for a in args:
            assert a.is_contiguous(), kind
            assert a.dtype == dtype, (kind, a.dtype, dtype)
        return fn(*args)
    return wrapped


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_models_hand_the_kernels_valid_operands(monkeypatch, dtype):
    """Minibatch slices are transposed views; the models must still pass
    the kernel wrappers contiguous operands of one dtype."""
    import madrona_learn_tpu_torch.models.lstm as lstm_mod
    from madrona_learn_tpu_torch.rollouts import RolloutData

    seen = []

    def record(fn, kind):
        checked = _checking(fn, kind)

        def wrapped(*args):
            seen.append(kind)
            return checked(*args)
        return wrapped

    # H = 128, a width the kernels take (at another the model takes the
    # plain twins and hands the wrappers nothing).
    monkeypatch.setattr(lstm_mod, "lstm_sequence",
                        record(lstm_mod.lstm_sequence, "sequence"))
    monkeypatch.setattr(lstm_mod, "lstm_step",
                        record(lstm_mod.lstm_step, "step"))
    ac = _torch_actor_critic(dtype, 128)
    rng = np.random.default_rng(8)
    S, TC, H = 6, 4, 128
    data = RolloutData({
        "obs": {k: torch.from_numpy(v) for k, v in _obs(rng, S, TC).items()},
        "dones": torch.from_numpy(rng.random((S, TC, 1)) < 0.3),
        "actions": {"move": torch.from_numpy(
            rng.integers(0, 5, (S, TC, 1)).astype(np.int32))},
        "rnn_start_states": tuple(torch.zeros(S, 1, H, dtype=dtype)
                                  for _ in range(2)),
    })
    mb = data.minibatch(torch.tensor([4, 1, 3]))
    out = ac.update(mb["rnn_start_states"], mb["dones"], mb["actions"],
                    mb["obs"])
    assert out["log_probs"]["move"].shape == (TC, 3, 1)
    with torch.no_grad():
        ac.rollout(torch.Generator().manual_seed(0),
                   ac.init_recurrent_state(3),
                   {k: v[0] for k, v in mb["obs"].items()})
    assert seen == ["sequence", "step"]
