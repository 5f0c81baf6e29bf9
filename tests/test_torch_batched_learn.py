"""The learn half of a population's policy batching: one PPO step a
minibatch over every train policy, on the chunk-indexed LSTM backward.

- ``lstm_sequence_chunked``'s plain twin, whose autograd defines
  ``lstm_sequence_bwd_chunked``: against ``jax.vmap`` over policies of
  ``jax.vjp`` of JAX's Pallas ``lstm_sequence`` in interpret mode (each
  policy's minibatch one chunk, as in learn), and against each chunk's
  ``lstm_sequence_reference`` gradients at C = 37 in a shuffled chunk
  order, a policy without a chunk getting zeros;
- the wrapper's routes and launch counts against a stand-in library, and
  its refusals;
- a population of 4 train and 2 past policies (MLP 32 + LSTM 32,
  float32) learning on the batched path against the per-policy loop from
  the same state, for every batched PPO variant, and a fused-trunk one
  (``fused``: MLP 128 + LSTM 128 with the fused step and
  ``fuse_input_proj``, whose learn takes ``lstm_sequence_proj_chunked``)
  under uniform minibatches;
- the learn path rule over the model zoo and the PPO options.
"""

import dataclasses
import logging
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import madrona_learn_tpu_torch as tlt
import madrona_learn_tpu_torch.models as tm
import madrona_learn_tpu_torch.ops.cuda.lstm as lstm_mod
import madrona_learn_tpu_torch.rollouts as t_rollouts
from madrona_learn_tpu.ops.pallas.lstm import lstm_sequence as jax_lstm_seq
from madrona_learn_tpu_torch.ops.cuda import KERNELS, LSTM_BWD_CHUNKED
from madrona_learn_tpu_torch.ops.cuda.lstm import (
    lstm_sequence_bwd_chunked,
    lstm_sequence_chunked,
    lstm_sequence_chunked_reference,
    lstm_sequence_reference,
)
from test_torch_lstm_fwd_tc_numerics import _stand_in_card

torch.set_num_threads(1)

F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16


def _chunked_inputs(seed, T, B, C, H, P):
    rng = np.random.default_rng(seed)
    N = B * C
    f = lambda *shape, scale=1.0: torch.from_numpy(
        (rng.normal(size=shape) * scale).astype(np.float32))
    keep = torch.from_numpy((rng.random((T, N)) > 0.3).astype(np.float32))
    return (f(T, N, 4 * H), keep, f(P, H, 4 * H, scale=H ** -0.5),
            f(P, 4 * H, scale=0.1), f(N, H), f(N, H), f(T, N, H))


def _twin_grads(x, keep, wr, bias, chunk_policy, c0, h0, probe):
    """(dx_proj, dwr, db, dc0, dh0) by autograd of the plain twin."""
    leaves = [t.clone().requires_grad_() for t in (x, wr, bias, c0, h0)]
    ys = lstm_sequence_chunked_reference(leaves[0], keep, leaves[1],
                                         leaves[2], chunk_policy, leaves[3],
                                         leaves[4])
    return torch.autograd.grad((ys * probe).sum(), leaves)


def test_chunked_backward_twin_matches_jax_vmapped_pallas_vjp():
    """Each policy's minibatch one chunk (chunk_policy = arange(P)): the
    twin's dx_proj, dwr[p], db[p], dc0 and dh0 against ``jax.vmap`` over
    the policies of ``jax.vjp`` of the Pallas ``lstm_sequence`` in
    interpret mode, within 1e-5."""
    T, P, C, H = 3, 3, 8, 128
    x, keep, wr, bias, c0, h0, probe = _chunked_inputs(3, T, P, C, H, P)
    got = _twin_grads(x, keep, wr, bias,
                      torch.arange(P, dtype=torch.int32), c0, h0, probe)

    def per_policy(t):
        """[T, P * C, ...] -> [P, T, C, ...]; [P * C, ...] -> [P, C, ...]."""
        a = t.numpy()
        if a.shape[0] == P * C:
            return jnp.asarray(a.reshape(P, C, *a.shape[1:]))
        return jnp.asarray(a.reshape(T, P, C, *a.shape[2:]).swapaxes(0, 1))

    def vjp(x, keep, wr, bias, c0, h0, probe):
        _, pull = jax.vjp(
            lambda x, wr, bias, c0, h0: jax_lstm_seq(x, keep, wr, bias, c0,
                                                     h0, True),
            x, wr, bias, c0, h0)
        return pull(probe)

    want = jax.vmap(vjp)(per_policy(x), per_policy(keep), jnp.asarray(
        wr.numpy()), jnp.asarray(bias.numpy()), per_policy(c0),
        per_policy(h0), per_policy(probe))
    dx, dwr, db, dc0, dh0 = (np.asarray(w) for w in want)
    wants = (dx.swapaxes(0, 1).reshape(T, P * C, 4 * H), dwr, db,
             dc0.reshape(P * C, H), dh0.reshape(P * C, H))
    for name, g, w in zip(("dx_proj", "dwr", "db", "dc0", "dh0"), got,
                          wants):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_chunked_backward_twin_is_each_chunks_reference():
    """At C = 37 (no multiple of a tile) in a shuffled chunk order: each
    chunk's dx_proj, dc0 and dh0 bitwise the gradients of
    ``lstm_sequence_reference`` on its rows with its policy's weights; a
    policy's dwr / db the sum over its chunks; zeros for policy 4, which
    owns no chunk."""
    T, C, H, P = 4, 37, 16, 5
    order = [2, 0, 3, 2, 1, 0]
    chunk_policy = torch.tensor(order, dtype=torch.int32)
    x, keep, wr, bias, c0, h0, probe = _chunked_inputs(5, T, len(order), C,
                                                       H, P)
    dx, dwr, db, dc0, dh0 = _twin_grads(x, keep, wr, bias, chunk_policy, c0,
                                        h0, probe)
    sums = {}
    for b, p in enumerate(order):
        rows = slice(b * C, (b + 1) * C)
        leaves = [t.clone().requires_grad_() for t in (
            x[:, rows], wr[p], bias[p], c0[rows], h0[rows])]
        ys = lstm_sequence_reference(leaves[0], keep[:, rows], *leaves[1:])
        g = torch.autograd.grad((ys * probe[:, rows]).sum(), leaves)
        assert torch.equal(dx[:, rows], g[0])
        assert torch.equal(dc0[rows], g[3]) and torch.equal(dh0[rows], g[4])
        w, b_ = sums.get(p, (0.0, 0.0))
        sums[p] = (w + g[1], b_ + g[2])
    for p in range(P):
        if p not in sums:
            assert not dwr[p].any() and not db[p].any()
            continue
        torch.testing.assert_close(dwr[p], sums[p][0], rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(db[p], sums[p][1], rtol=1e-6, atol=1e-6)
    # On the CPU the differentiable entry point is the twin.
    ys = lstm_sequence_chunked(x, keep, wr, bias, chunk_policy, c0, h0)
    assert torch.equal(ys, lstm_sequence_chunked_reference(
        x, keep, wr, bias, chunk_policy, c0, h0))


@pytest.mark.parametrize("dtype,H,tensor_core", [
    (BF16, 256, True), (BF16, 128, True), (F32, 256, False),
    (F32, 128, False), (F16, 256, False), (F16, 128, False)])
def test_chunked_backward_wrapper_routes(monkeypatch, dtype, H, tensor_core):
    """The wrapper takes ``lstm_sequence_bwd``'s path rule, hands the
    kernel the stacks, a transposed copy of the Wr stack, the chunk count,
    the chunk size, the policy count and the splits a chunk (the
    single-policy rule over one chunk's rows alone: the tensor-core
    backward's ``_num_splits_tc``, the CUDA-core one's ``_num_splits``),
    and counts one launch (and a tensor-core one on that route). Operands
    stand on the CPU: the library, the operand check, the stream and the
    SM count are stand-ins."""
    lib = _stand_in_card(monkeypatch)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: types.SimpleNamespace(
                            multi_processor_count=132))
    monkeypatch.setattr(LSTM_BWD_CHUNKED, "launches", 0)
    monkeypatch.setattr(LSTM_BWD_CHUNKED, "tc_launches", 0)
    T, B, C, P = 16, 3, 1280, 4
    wr = torch.zeros(P, H, 4 * H, dtype=dtype)
    bias = torch.zeros(P, 4 * H, dtype=dtype)
    seq = torch.zeros(T, B * C, H, dtype=dtype)
    state = torch.zeros(B * C, H, dtype=dtype)
    out = lstm_sequence_bwd_chunked(
        torch.zeros(T, B * C, 4 * H, dtype=dtype),
        torch.ones(T, B * C, dtype=dtype), wr, bias,
        torch.tensor([1, 3, 0], dtype=torch.int32), state, state, seq, seq,
        seq)
    assert lib.calls == ["mlt_lstm_bwd_chunked"]
    (args,) = lib.args
    assert args[:3] == (int(tensor_core), {F32: 0, BF16: 1, F16: 2}[dtype],
                        H)
    assert args[5] == wr.data_ptr() and args[7] == bias.data_ptr()
    assert args[6] != wr.data_ptr()   # Wr^T of every policy, a copy
    splits = (lstm_mod._num_splits_tc(T * C, H, H, 132) if tensor_core
              else lstm_mod._num_splits(T, C, H, 132))
    assert args[22:27] == (T, B, C, P, splits)
    assert (args[15] != 0) == tensor_core   # the h_in scratch
    dxp, dwr, db, dc0, dh0 = out
    assert dxp.shape == (T, B * C, 4 * H) and dwr.shape == (P, H, 4 * H)
    assert db.shape == (P, 4 * H) and dc0.shape == dh0.shape == (B * C, H)
    assert (LSTM_BWD_CHUNKED.launches, LSTM_BWD_CHUNKED.tc_launches) == (
        1, int(tensor_core))


def test_chunked_backward_wrapper_refuses_what_no_kernel_takes():
    """Off the CPU, the kernel path raises on what it cannot take (meta
    tensors are on no card; float16 at a hidden size no instance takes;
    rows that are not whole chunks), and counts no launch; the kernel is
    registered against the Pallas backward's pallas_call."""
    assert LSTM_BWD_CHUNKED in KERNELS
    assert LSTM_BWD_CHUNKED.replaces == \
        "madrona_learn_tpu/ops/pallas/lstm.py:301"
    before = (LSTM_BWD_CHUNKED.launches, LSTM_BWD_CHUNKED.tc_launches)

    def meta(*shape, dtype=BF16):
        return torch.empty(*shape, dtype=dtype, device="meta")

    idx = meta(3, dtype=torch.int32)
    for rows, H, dtype in ((96, 256, BF16), (96, 96, F16), (95, 256, BF16)):
        seq = meta(2, rows, H, dtype=dtype)
        with pytest.raises(ValueError):
            lstm_sequence_bwd_chunked(
                meta(2, rows, 4 * H, dtype=dtype), meta(2, rows, dtype=dtype),
                meta(2, H, 4 * H, dtype=dtype), meta(2, 4 * H, dtype=dtype),
                idx, meta(rows, H, dtype=dtype), meta(rows, H, dtype=dtype),
                seq, seq, seq)
    assert (LSTM_BWD_CHUNKED.launches,
            LSTM_BWD_CHUNKED.tc_launches) == before


# -- Batched learn against the per-policy loop -------------------------------

H = 32
NUM_TRAIN, NUM_PAST, NUM_WORLDS = 4, 2, 32
# Train agents a policy: 64 * (0.25 + 0.5 / 2 + 0.25 / 2) / 4 = 10, in 2
# BPTT chunks: 20 sequences, 2 minibatches of 10 an epoch.
MINIBATCH = 10

VARIANTS = {
    "uniform": {},
    "stratified": dict(cfg=dict(minibatch_stratify=2)),
    "importance": dict(cfg=dict(importance_sample_trajectories=True,
                                importance_sample_num_minibatches=1)),
    "valuenorm": dict(cfg=dict(normalize_values=True)),
    "clip_value": dict(algo=dict(clip_value_loss=True),
                       cfg=dict(normalize_values=True)),
    "huber": dict(algo=dict(huber_value_loss=True)),
    "entropy_weights": dict(algo=dict(entropy_key_weights={"move": 0.5})),
    # Uniform minibatches over the fused trunk.
    "fused": dict(tower="fused"),
}
# The fused trunk's width: the fused step and the projection kernels take
# H = 128 or 256.
FUSED_H = 128


def _actor_critic(p, tower="lstm", dtype=F32):
    """MLP + LSTM ("lstm"), MLP ("mlp") or the fused trunk ("fused")."""
    fused = tower == "fused"
    width = FUSED_H if fused else H
    net = tm.MLP(2, width, 1, dtype)
    encoder = (tm.RecurrentBackboneEncoder(
        net=net, rnn=tm.LSTM(width, width, 1, dtype, fuse_input_proj=fused),
        use_fused_step=fused)
               if tower != "mlp" else tm.BackboneEncoder(net=net))
    return tm.ActorCritic(
        backbone=tm.BackboneShared(
            prefix=lambda obs: torch.cat([obs["time"], obs["acc"]], -1),
            encoder=encoder),
        actor=tm.DictActor({"move": tm.DenseLayerDiscreteActor(
            tlt.DiscreteActionsConfig(actions_num_buckets=[5]), width,
            dtype)}),
        critic=tm.DenseLayerCritic(width, dtype))


def _cfg(variant, tower="lstm"):
    spec = VARIANTS.get(variant, {})
    return tlt.TrainConfig(
        num_worlds=NUM_WORLDS, num_agents_per_world=2,
        actions={"move": tlt.DiscreteActionsConfig(actions_num_buckets=[5])},
        steps_per_update=8 if tower != "mlp" else 2,
        num_bptt_chunks=2 if tower != "mlp" else 1,
        lr=tlt.ParamExplore(base=1e-3, min_scale=0.1, max_scale=10.0,
                            log10_scale=True),
        gamma=0.99, gae_lambda=0.95, seed=4, metrics_buffer_size=1,
        algo=tlt.PPOConfig(num_epochs=2, minibatch_size=MINIBATCH,
                           clip_coef=0.2, value_loss_coef=0.5,
                           entropy_coef=tlt.ParamExplore(
                               base=0.01, min_scale=0.5, max_scale=2.0),
                           max_grad_norm=0.5, **spec.get("algo", {})),
        pbt=tlt.PBTConfig(num_teams=2, team_size=1,
                          num_train_policies=NUM_TRAIN,
                          num_past_policies=NUM_PAST,
                          self_play_portion=0.25, cross_play_portion=0.5,
                          past_play_portion=0.25),
        dreamer_v3_critic=False, **spec.get("cfg", {}))


def _trainer(cfg, tower="lstm"):
    from madrona_learn_tpu_torch.envs import ToyEnvConfig, make_duel_env

    # The modules draw their initial weights from torch's global generator.
    torch.manual_seed(4)
    policy = tlt.Policy(lambda p: _actor_critic(p, tower),
                        tlt.ObservationsCaster.create(F32),
                        lambda er: (er[0].float(), 1.0 - er[0].float()))
    return tlt.init_training("cpu", cfg, make_duel_env(
        ToyEnvConfig(num_worlds=NUM_WORLDS, episode_len=4, num_teams=2,
                     team_size=1, seed=4), device="cpu"),
        policy, torch.zeros((1,), dtype=torch.int32))


def _learned(variant, loop, prepare=None):
    """A population after one update on the batched learn or the loop,
    and its parameters before it; ``prepare(mgr)``, where given, runs
    first."""
    mp = pytest.MonkeyPatch()
    if loop:
        mp.setattr(tlt.train, "batched_learn_missing",
                   lambda cfg, actor_critic: "the test")
    tower = VARIANTS[variant].get("tower", "lstm")
    try:
        mgr = _trainer(_cfg(variant, tower), tower)
        assert mgr.batched_learn is not loop
        if prepare is not None:
            prepare(mgr)
        before = [{k: v.detach().clone() for k, v in
                   policy.actor_critic.named_parameters()}
                  for policy in mgr.state.policy_states.policies]
        mgr.update_iter()
    finally:
        mp.undo()
    return mgr, before


# Parameters whose gradient is 0 in exact arithmetic: the attention's key
# bias adds one constant to all of a query's scores, which the softmax
# cancels. On either path its gradient is rounding noise (an RMS near
# 1e-12 at the entity population, against 4e-6 or more for every other
# parameter), which Adam (eps 1e-8) turns into steps of either sign as
# large as lr: its value is not compared after an update; its gradient
# must be that noise on both paths, an RMS below 1e-5 of every other
# parameter's largest.
ZERO_GRADIENT = ("MultiHeadDotProductAttention_0.key.bias",)


def _check_zero_gradients(nu):
    """Adam's second moments ``nu``: each ZERO_GRADIENT parameter's RMS
    below 1e-5 of every other parameter's largest."""
    floor = min(float(v.sqrt().max()) for k, v in nu.items()
                if not k.endswith(ZERO_GRADIENT))
    for name, v in nu.items():
        if name.endswith(ZERO_GRADIENT):
            assert float(v.sqrt().max()) < 1e-5 * floor, name


def _close(got, want, what):
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6, msg=what)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_batched_learn_equals_the_per_policy_loop(variant):
    """From the same state (init and collect are the same code), one
    update of two epochs on the batched learn and on the per-policy loop:
    every policy's Adam mu / nu / count, value normalizer, per-policy
    metrics and first-minibatch stats agree within 1e-6 (float32; the
    batched products and reductions sum in another order), its parameters
    within 1e-6 plus 1e-3 of their move (below; an attention key bias's
    gradient instead must be rounding noise, ``ZERO_GRADIENT``), and the
    index streams, drawn from each policy's own generator in the loop's
    order, bitwise."""
    check_batched_learn(variant)


def check_batched_learn(variant, metric_rtol=1e-6, prepare=None):
    """The check of ``test_batched_learn_equals_the_per_policy_loop``, the
    metrics within ``metric_rtol`` relative (and 1e-6 absolute), each run
    after ``prepare(mgr)`` where given; returns the (batched, loop)
    managers and the parameters before the update."""
    (batched, before), (loop, _) = (_learned(variant, False, prepare),
                                    _learned(variant, True, prepare))
    pop_b, pop_l = batched.state.policy_states, loop.state.policy_states
    for p in range(NUM_TRAIN + NUM_PAST):
        want = dict(pop_l[p].actor_critic.named_parameters())
        for name, got in pop_b[p].actor_critic.named_parameters():
            if p < NUM_TRAIN and name.endswith(ZERO_GRADIENT):
                continue
            # Adam divides each gradient by its own RMS, so where a
            # gradient stays near 0 (RMS ~1e-5) it scales the moments'
            # f32 rounding differences (mu within 1e-10 here) up to a few
            # 1e-6 of a parameter: a parameter is held to 1e-6 plus 1e-3 of
            # its move over the update.
            moved = (want[name] - before[p][name]).abs()
            diff = (got - want[name]).abs()
            assert bool((diff <= 1e-6 + 1e-3 * moved).all()), (
                f"policy {p} {name}: {diff.max().item():.3e}")
    for p, (tb, tl) in enumerate(zip(batched.state.train_states,
                                     loop.state.train_states)):
        # Two epochs of 2 minibatches (1 under importance sampling); Adam
        # counts the finite ones (all of them without loss scaling).
        steps = 2 if variant == "importance" else 4
        nonfinite = int(batched.first_minibatch_stats[p].get(
            "nonfinite_steps", 0))
        assert int(tb.opt_state.count) == int(tl.opt_state.count) == \
            steps - nonfinite
        _check_zero_gradients(tb.opt_state.nu)
        _check_zero_gradients(tl.opt_state.nu)
        for field in ("mu", "nu"):
            for name, got in getattr(tb.opt_state, field).items():
                _close(got, getattr(tl.opt_state, field)[name],
                       f"policy {p} {field} {name}")
        if variant in ("valuenorm", "clip_value"):
            assert int(tb.value_normalizer_state["N"]) == steps
            for k, got in tb.value_normalizer_state.items():
                _close(got, tl.value_normalizer_state[k],
                       f"policy {p} value normalizer {k}")
        sb, sl = (m.first_minibatch_stats[p] for m in (batched, loop))
        assert sb.keys() == sl.keys()
        assert sb["num_minibatches"] == sl["num_minibatches"]
        assert torch.equal(sb["epoch_inds"], sl["epoch_inds"])
        assert torch.equal(sb["traj_weights"], sl["traj_weights"])
        for k in ("max_abs_ratio_dev", "clip_fraction", "loss"):
            _close(sb[k], sl[k], f"policy {p} first minibatch {k}")
        assert float(sb["max_abs_ratio_dev"]) < 1e-5
    for name in batched.metrics.metrics:
        got, want = batched.metrics.latest(name), loop.metrics.latest(name)
        for field, t in got.tensors().items():
            torch.testing.assert_close(t, want.tensors()[field],
                                       rtol=metric_rtol, atol=1e-6,
                                       msg=f"metric {name} {field}")
    return batched, loop, before


def test_filtering_population_takes_the_loop(caplog):
    """Advantage filtering gives each policy its own minibatch count: the
    population learns on the per-policy loop, chosen at init and logged by
    the option's name, and still trains every policy."""
    cfg = dataclasses.replace(_cfg("uniform", tower="mlp"),
                              filter_advantages=True)
    with caplog.at_level(logging.INFO, logger="madrona_learn_tpu_torch"):
        mgr = _trainer(cfg, tower="mlp")
    assert not mgr.batched_learn
    assert any("filter_advantages" in r.getMessage() for r in caplog.records)
    mgr.update_iter()
    assert len(mgr.first_minibatch_stats) == NUM_TRAIN
    for ts in mgr.state.train_states:
        assert int(ts.max_advantage_est_state["N"]) == 1


# -- The learn path rule -------------------------------------------------------

def _zoo(kind):
    if kind in ("lstm", "mlp"):
        return _actor_critic(0, kind)
    if kind == "bf16":
        return _actor_critic(0, "lstm", BF16)
    net = tm.MLP(2, 128, 1, F32)
    prefix = ((lambda obs: obs) if kind.startswith("entity")
              else (lambda obs: obs["x"]))

    def entity_net(concat_self=False):
        return tm.EntitySelfAttentionNet(
            {"self": 16, "allies": 12}, 64, 128, 4, F32,
            embed_concat_self=concat_self)

    towers = {
        "gru": lambda: tm.RecurrentBackboneEncoder(
            net=net, rnn=tm.GRU(128, 128, 1, F32)),
        "gru_float16": lambda: tm.RecurrentBackboneEncoder(
            net=net, rnn=tm.GRU(128, 128, 1, torch.float16)),
        "gru_h96": lambda: tm.RecurrentBackboneEncoder(
            net=net, rnn=tm.GRU(128, 96, 1, F32)),
        "fused": lambda: tm.RecurrentBackboneEncoder(
            net=tm.MLP(2, 128, 1, BF16), rnn=tm.LSTM(128, 128, 1, BF16),
            use_fused_step=True),
        "remat": lambda: tm.RecurrentBackboneEncoder(
            net=net, rnn=tm.LSTM(128, 128, 1, F32),
            remat_trunk_sequence=True),
        "float16": lambda: tm.RecurrentBackboneEncoder(
            net=tm.MLP(2, 128, 1, torch.float16),
            rnn=tm.LSTM(128, 128, 1, torch.float16)),
        "proj": lambda: tm.RecurrentBackboneEncoder(
            net=net, rnn=tm.LSTM(128, 128, 1, F32, fuse_input_proj=True)),
        "window": lambda: tm.RecurrentBackboneEncoder(
            net=net, rnn=tm.WindowAttentionMemory(128, 8, 4, F32)),
        "entity": lambda: tm.RecurrentBackboneEncoder(
            net=entity_net(), rnn=tm.LSTM(128, 128, 1, F32)),
        "entity_concat_self": lambda: tm.RecurrentBackboneEncoder(
            net=entity_net(True), rnn=tm.LSTM(128, 128, 1, F32)),
        "entity_ff": lambda: tm.BackboneEncoder(entity_net()),
        "entity_remat": lambda: tm.RecurrentBackboneEncoder(
            net=entity_net(), rnn=tm.LSTM(128, 128, 1, F32),
            remat_trunk_sequence=True),
    }
    tower = towers.get(kind, lambda: tm.BackboneEncoder(net))
    backbone = (tm.BackboneSeparate(prefix, tm.BackboneEncoder(net),
                                    tm.BackboneEncoder(net))
                if kind == "separate" else tm.BackboneShared(prefix, tower()))
    critics = {"hlgauss": lambda: tm.HLGaussCritic.create(128, F32),
               "hlgauss_two_part":
                   lambda: tm.HLGaussTwoPartCritic.create(128, F32),
               "dreamer": lambda: tm.DreamerV3Critic(128, F32)}
    return tm.ActorCritic(
        backbone=backbone,
        actor=tm.DictActor({"move": tm.DenseLayerDiscreteActor(
            tlt.DiscreteActionsConfig(actions_num_buckets=[3]), 128, F32)}),
        critic=critics.get(kind, lambda: tm.DenseLayerCritic(128, F32))())


@pytest.mark.parametrize("kind,options,missing", [
    ("lstm", {}, None), ("mlp", {}, None), ("bf16", {}, None),
    ("lstm", dict(minibatch_stratify=2), None),
    ("lstm", dict(importance_sample_trajectories=True), None),
    ("lstm", dict(normalize_values=True), None),
    ("mlp", dict(filter_advantages=True), "filter_advantages"),
    ("lstm", dict(compute_dtype=torch.float16), None),
    ("gru", {}, None),
    ("gru_float16", {}, None),
    # A GRU of a width without a kernel instance takes the plain twins.
    ("gru_h96", {}, None),
    ("fused", {}, None),
    ("remat", {}, "backbone.encoder (RecurrentBackboneEncoder)"),
    ("float16", {}, None),
    ("proj", {}, None),
    ("window", {}, None),
    ("separate", {}, None),
    ("hlgauss", {}, None), ("hlgauss_two_part", {}, None),
    ("dreamer", {}, None),
    ("entity", {}, None), ("entity_concat_self", {}, None),
    ("entity_ff", {}, None),
    ("entity_remat", {}, "backbone.encoder (RecurrentBackboneEncoder)"),
])
def test_which_populations_take_the_batched_learn(kind, options, missing):
    """``batched_learn_missing``: None (the batched learn) where every
    module has a batched learn form and no option needs each policy on its
    own, else the option or the first module without a form, by name."""
    cfg = dataclasses.replace(_cfg("uniform"), **options)
    assert t_rollouts.batched_learn_missing(cfg, _zoo(kind)) == missing
