"""The population rollout's policy-chunk layout
(``rollouts.chunked_rollout_loop``) against the JAX package's sizing and
the port's per-policy loop.

- Chunk sizing: ``RolloutConfig.setup_population``'s chunk size, chunk
  count and policy batch equal the JAX ``RolloutConfig.setup``'s for every
  row of ``tests/test_rollouts.py``'s ``CONFIGS`` and ``LARGE_CONFIGS``
  (overrides included; a config-only check) and for headline_pbt's shape.
- The chunked rollout equals the per-policy loop step by step (actions,
  preprocessed obs and custom rows bitwise; values, log-probs and the
  recurrent state within 1e-6 in float32, where the products are summed
  in another order), on an MLP, an MLP + LSTM and a fused-trunk (MLP 128
  + LSTM 128 with the fused step and ``fuse_input_proj``: the chunked step
  through ``fused_policy_step_chunked``) population with per-policy obs
  normalizers, under matchmaking and under a static
  tournament with custom policy rows; actions are each row's most likely
  (``categorical`` replaced by an argmax), so both paths draw alike.
- ``chunkwise_rnn`` on and off are bitwise equal.
- Custom rows on the chunked path: zeros in every output, their recurrent
  state kept, no NaN anywhere, and the other rows as in a run where those
  rows belong to a policy.
- ``lstm_sequence_fwd_chunked``'s plain twin equals, chunk by chunk,
  ``lstm_sequence_reference`` bitwise and JAX's Pallas ``lstm_sequence``
  (interpret mode) within 1e-5, at a chunk of 37 rows (not a multiple of
  the kernel's 32-row tile); its wrapper's routes and launch counts
  against a stand-in library.
- The path rule over the model zoo, and the stacked view being a copy.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import madrona_learn_tpu_torch as tlt
import madrona_learn_tpu_torch.models as tm
import madrona_learn_tpu_torch.ops.cuda.lstm as lstm_mod
import madrona_learn_tpu_torch.ops.dists as t_dists
import madrona_learn_tpu_torch.rollouts as t_rollouts
from madrona_learn_tpu.ops.pallas.lstm import lstm_sequence as jax_lstm_seq
from madrona_learn_tpu.rollouts import RolloutConfig as JaxRolloutConfig
from madrona_learn_tpu_torch.envs import ToyEnvConfig, make_duel_env
from madrona_learn_tpu_torch.ops.cuda import LSTM_FWD_CHUNKED
from madrona_learn_tpu_torch.ops.cuda.lstm import (
    lstm_sequence_fwd_chunked,
    lstm_sequence_fwd_chunked_reference,
    lstm_sequence_reference,
)
from madrona_learn_tpu_torch.train import _build_all_pairs_assignments
from madrona_learn_tpu_torch.train_state import (MMR, PolicyState,
                                                 Population)
from madrona_learn_tpu_torch.utils import tree_map
from test_rollouts import CONFIGS as JAX_CONFIGS
from test_rollouts import LARGE_CONFIGS as JAX_LARGE_CONFIGS
from test_torch_lstm_fwd_tc_numerics import _stand_in_card

torch.set_num_threads(1)

BF16, F32, F16 = torch.bfloat16, torch.float32, torch.float16

# headline_pbt: 16384 duel worlds x 2 agents, 8 train + 4 past policies.
HEADLINE_PBT = (32, 32, 8, 4, 2, 1, 32768, 0.25, 0.5, 0.25, 0)


@pytest.mark.parametrize("cfg", JAX_CONFIGS + JAX_LARGE_CONFIGS
                         + [HEADLINE_PBT], ids=str)
def test_chunk_sizes_match_jax(cfg):
    (_, _, n_cur, n_past, teams, size, batch, self_p, cross_p, past_p,
     chunk) = cfg
    args = dict(num_current_policies=n_cur, num_past_policies=n_past,
                num_teams=teams, team_size=size, sim_batch_size=batch,
                actions_cfg={}, self_play_portion=self_p,
                cross_play_portion=cross_p, past_play_portion=past_p,
                static_play_portion=0.0, policy_chunk_size_override=chunk)
    want = JaxRolloutConfig.setup(**args)
    got = t_rollouts.RolloutConfig.setup_population(**args)
    assert (got.policy_chunk_size, got.num_policy_chunks,
            got.total_policy_batch_size) == (
                want.policy_chunk_size, want.num_policy_chunks,
                want.total_policy_batch_size)
    if cfg == HEADLINE_PBT:
        assert (got.policy_chunk_size, got.num_policy_chunks) == (512, 75)


# -- The chunked rollout against the per-policy loop ------------------------

H, NUM_TRAIN, NUM_PAST, WORLDS, CUSTOM = 32, 4, 2, 32, 100
NUM_POLICIES = NUM_TRAIN + NUM_PAST
# The fused trunk's width: the fused step and the projection kernels take
# H = 128 or 256, so a fused tower of 32 would run unfused.
FUSED_H = 128


def _model(lstm, seed):
    """An MLP (``lstm`` False), MLP + LSTM (True) or fused-trunk ("fused")
    actor-critic."""
    gen = torch.Generator().manual_seed(seed)
    fused = lstm == "fused"
    width = FUSED_H if fused else H
    net = tm.MLP(2, width, 1, F32, generator=gen)
    return tm.ActorCritic(
        backbone=tm.BackboneShared(
            prefix=lambda obs: torch.cat([obs["time"], obs["acc"]], -1),
            encoder=(tm.RecurrentBackboneEncoder(
                net=net, rnn=tm.LSTM(width, width, 1, F32, generator=gen,
                                     fuse_input_proj=fused),
                use_fused_step=fused)
                if lstm else tm.BackboneEncoder(net=net))),
        actor=tm.DictActor({"move": tm.DenseLayerDiscreteActor(
            tlt.DiscreteActionsConfig(actions_num_buckets=[5]), width, F32,
            weight_init=tm.common.orthogonal(1.0), generator=gen)}),
        critic=tm.DenseLayerCritic(width, F32, generator=gen))


def _population(lstm):
    """Policies of distinct weights and obs normalizers; every LayerNorm's
    scale and shift moved off 1 and 0."""
    norm = tlt.ObservationsEMANormalizer.create(decay=0.99, dtype=F32)
    gen = torch.Generator().manual_seed(7)
    policies = []
    for p in range(NUM_POLICIES):
        model = _model(lstm, 11 + p)
        with torch.no_grad():
            for name, param in model.named_parameters():
                if "LayerNorm" in name:
                    param.add_(0.3 * torch.randn(param.shape, generator=gen))
        state = {}
        for key in ("time", "acc"):
            est = norm.normalizer.init_estimates(torch.zeros((1, 1)))
            est["mu"] = torch.randn((1,), generator=gen)
            est["inv_sigma"] = 0.5 + torch.rand((1,), generator=gen)
            state[key] = est
        policies.append(PolicyState(model, norm, state))
    return Population(policies=policies, reward_hyper_params=None,
                      get_episode_scores_fn=lambda er: (0.0, 0.0),
                      episode_score=None,
                      mmr=MMR(elo=torch.full((NUM_POLICIES,), 1500.0)))


def _rollout_state(population, chunked, static, chunk_override=0):
    """The duel over ``WORLDS`` worlds: matchmade (25% self, 50% cross,
    25% past play), or the static all-pairs tournament with a custom
    policy."""
    portions = (0.0, 0.0, 0.0, 1.0) if static else (0.25, 0.5, 0.25, 0.0)
    cfg = t_rollouts.RolloutConfig.setup_population(
        num_current_policies=NUM_TRAIN, num_past_policies=NUM_PAST,
        num_teams=2, team_size=1, sim_batch_size=2 * WORLDS,
        actions_cfg={"move": tlt.DiscreteActionsConfig(
            actions_num_buckets=[5])},
        self_play_portion=portions[0], cross_play_portion=portions[1],
        past_play_portion=portions[2], static_play_portion=portions[3],
        custom_policy_ids=[CUSTOM] if static else [],
        policy_chunk_size_override=chunk_override, policy_chunked=chunked)
    with warnings.catch_warnings():
        # 32 of the 49 pairings: those of policies 0-4, custom ones too.
        warnings.simplefilter("ignore")
        static_assignments = (_build_all_pairs_assignments(
            NUM_POLICIES, [CUSTOM], 2 * WORLDS, 2, 1) if static else None)
    return t_rollouts.RolloutState.create(
        cfg, make_duel_env(ToyEnvConfig(num_worlds=WORLDS, episode_len=3,
                                        num_teams=2, team_size=1, seed=5),
                           device="cpu"),
        torch.Generator().manual_seed(3),
        population[0].actor_critic.init_recurrent_state(2 * WORLDS),
        torch.zeros((1,), dtype=torch.int32),
        static_play_assignments=static_assignments)


def _leaves(tree):
    """A recurrent state's tensors (a tensor, a tuple of them, nested)."""
    leaves = []
    tree_map(leaves.append, tree)
    return leaves


def _run(lstm, chunked, static, chunkwise_rnn=False, chunk_override=0,
         steps=7):
    """Every step's outputs, preprocessed obs, recurrent state and
    assignments, in sim order."""
    population = _population(lstm)
    state = _rollout_state(population, chunked, static, chunk_override)
    records = []

    def post_inference_cb(step_idx, obs, pre, out, cb):
        records.append(dict(actions=out["actions"]["move"].clone(),
                            log_probs=out["log_probs"]["move"].clone(),
                            values=out["critic"].clone(),
                            pre=torch.cat([pre["time"], pre["acc"]], -1)))
        return cb, None

    def post_step_cb(step_idx, rollout_state, dones, rewards, er, cb):
        rnn = rollout_state.rnn_states
        if chunkwise_rnn:
            rnn = rollout_state.reorder_state.to_sim(rnn)
        records[-1].update(
            rnn=[x.clone() for x in _leaves(rnn)],
            assignments=rollout_state.policy_assignments.clone())
        return rollout_state, cb, None

    mp = pytest.MonkeyPatch()
    mp.setattr(t_dists, "categorical",
               lambda logits, generator: logits.argmax(-1, keepdim=True))
    try:
        if chunked:
            t_rollouts.chunked_rollout_loop(
                state, population, steps, post_inference_cb, post_step_cb,
                None, chunkwise_rnn=chunkwise_rnn)
        else:
            t_rollouts.population_rollout_loop(
                state, population, steps, post_inference_cb, post_step_cb,
                None)
    finally:
        mp.undo()
    return records, state


@pytest.mark.parametrize("static", [False, True], ids=["matchmade",
                                                       "custom"])
@pytest.mark.parametrize("lstm", [False, True, "fused"],
                         ids=["mlp", "lstm", "fused"])
def test_chunked_rollout_equals_the_per_policy_loop(lstm, static):
    got, got_state = _run(lstm, True, static)
    want, _ = _run(lstm, False, static)
    assert got_state.cfg.policy_chunked
    custom = want[0]["assignments"] == CUSTOM
    assert bool(custom.any()) == static
    changed = False
    for t, (g, w) in enumerate(zip(got, want)):
        for name in ("actions", "pre", "assignments"):
            assert torch.equal(g[name], w[name]), (t, name)
        for name in ("values", "log_probs"):
            torch.testing.assert_close(g[name], w[name], rtol=1e-6,
                                       atol=1e-6, msg=f"{t} {name}")
        for x, y in zip(g["rnn"], w["rnn"]):
            torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-6)
        for name in ("actions", "pre", "values", "log_probs"):
            assert torch.isfinite(g[name].float()).all(), (t, name)
            assert (g[name][custom] == 0).all(), (t, name)
        changed |= not torch.equal(w["assignments"], want[0]["assignments"])
    assert changed or static, "matchmaking drew no new opponent"
    # The layout of the last step's assignments was computed on the step.
    layout = got_state.reorder_state
    assert layout.assignments is got_state.policy_assignments
    assert layout.chunk_policy.dtype == torch.int32


@pytest.mark.parametrize("static", [False, True], ids=["matchmade",
                                                       "custom"])
def test_chunkwise_rnn_is_bitwise_the_sim_order_carry(static):
    got, got_state = _run(True, True, static, chunkwise_rnn=True)
    want, want_state = _run(True, True, static)
    for t, (g, w) in enumerate(zip(got, want)):
        for name in ("actions", "pre", "values", "log_probs",
                     "assignments"):
            assert torch.equal(g[name], w[name]), (t, name)
        for x, y in zip(g["rnn"], w["rnn"]):
            assert torch.equal(x, y), t
    # Back in sim order once the loop ends.
    for x, y in zip(_leaves(got_state.rnn_states),
                    _leaves(want_state.rnn_states)):
        assert torch.equal(x, y)


def test_an_overridden_chunk_equals_the_heuristic_one():
    """An odd chunk size (5 rows, many chunks a policy) gives the rows the
    heuristic's chunk (48, one a policy) gives them."""
    got, state = _run(True, True, False, chunk_override=5, steps=4)
    want, _ = _run(True, True, False, steps=4)
    assert state.reorder_state.to_policy_idxs.shape == (
        -(-2 * WORLDS // 5) + NUM_POLICIES - 1, 5)
    for g, w in zip(got, want):
        assert torch.equal(g["actions"], w["actions"])
        torch.testing.assert_close(g["values"], w["values"], rtol=1e-6,
                                   atol=1e-6)


def test_custom_rows_are_as_a_policys_rows_left_out():
    """The custom rows keep their recurrent state and give zeros; every
    other row is as in a run where the custom rows are policy 0's."""
    population = _population(True)
    a = _rollout_state(population, True, True).policy_assignments
    custom = a == CUSTOM
    rnn = tuple(torch.randn((2 * WORLDS, 1, H), generator=torch.Generator()
                            .manual_seed(1)) for _ in range(2))
    outs = {}
    for name, assignments in (("custom", a),
                              ("policy 0", torch.where(custom, 0, a))):
        state = _rollout_state(population, True, True)
        state.policy_assignments = assignments
        state.rnn_states = rnn
        seen = {}

        def post_inference_cb(step_idx, obs, pre, out, cb):
            seen.update(out=out)
            return cb, None

        t_rollouts.chunked_rollout_loop(
            state, population, 1, post_inference_cb,
            lambda i, rs, d, r, er, cb: (rs, cb, None), None,
            sample_actions=False)
        outs[name] = (seen["out"], state.rnn_states)
    (out, rnn_after), (want, want_rnn) = outs["custom"], outs["policy 0"]
    others = (a != 0) & ~custom
    for x, y in ((out["actions"]["move"], want["actions"]["move"]),
                 (out["critic"], want["critic"])):
        assert (x[custom] == 0).all() and torch.isfinite(x.float()).all()
        assert torch.equal(x[others], y[others])
    for before, after, other in zip(rnn, rnn_after, want_rnn):
        assert torch.equal(after[custom], before[custom])
        assert torch.equal(after[others], other[others])
        assert torch.isfinite(after).all()


def test_population_stack_is_a_copy():
    """The stacked view holds copies: writing a module's parameter in
    place (as learning, copy_policy and checkpoint loads do) leaves a view
    built before unchanged, and a view built after sees the write."""
    population = _population(True)
    before = population.stacked()
    name = "critic.Dense_0.kernel"
    with torch.no_grad():
        population[2].actor_critic.critic.Dense_0.kernel.add_(1.0)
    population.copy_policy(2, 3)
    after = population.stacked()
    old, new = before.params.stack(name), after.params.stack(name)
    assert not torch.equal(old[2], new[2])
    assert torch.equal(new[3], new[2])
    assert torch.equal(old[0], new[0])
    assert torch.equal(new[2], population[2].actor_critic.critic.Dense_0
                       .kernel)


# -- The path rule ------------------------------------------------------------

def _tower(kind):
    net = tm.MLP(2, 128, 1, F32)
    if kind == "lstm":
        return tm.RecurrentBackboneEncoder(net=net,
                                           rnn=tm.LSTM(128, 128, 1, F32))
    if kind == "gru":
        return tm.RecurrentBackboneEncoder(net=net,
                                           rnn=tm.GRU(128, 128, 1, F32))
    if kind == "gru_float16":
        return tm.RecurrentBackboneEncoder(
            net=net, rnn=tm.GRU(128, 128, 1, torch.float16))
    if kind == "gru_h96":
        return tm.RecurrentBackboneEncoder(net=net,
                                           rnn=tm.GRU(128, 96, 1, F32))
    if kind == "fused":
        return tm.RecurrentBackboneEncoder(
            net=tm.MLP(2, 128, 1, BF16), rnn=tm.LSTM(128, 128, 1, BF16),
            use_fused_step=True)
    if kind == "float16":
        return tm.RecurrentBackboneEncoder(
            net=tm.MLP(2, 128, 1, torch.float16),
            rnn=tm.LSTM(128, 128, 1, torch.float16))
    if kind == "proj":
        return tm.RecurrentBackboneEncoder(
            net=net, rnn=tm.LSTM(128, 128, 1, F32, fuse_input_proj=True))
    if kind == "window":
        return tm.RecurrentBackboneEncoder(
            net=net, rnn=tm.WindowAttentionMemory(128, 8, 4, F32))
    if kind.startswith("entity"):
        net = tm.EntitySelfAttentionNet(
            {"self": 16, "allies": 12}, 64, 128, 4, F32,
            embed_concat_self=kind == "entity_concat_self")
        if kind == "entity_ff":
            return tm.BackboneEncoder(net=net)
        return tm.RecurrentBackboneEncoder(net=net,
                                           rnn=tm.LSTM(128, 128, 1, F32))
    return tm.BackboneEncoder(net=net)


@pytest.mark.parametrize("kind,missing", [
    ("mlp", None), ("lstm", None), ("gru", None),
    ("gru_float16", None),
    # A GRU of a width without a kernel instance takes the plain twins.
    ("gru_h96", None),
    ("fused", None),
    ("float16", None),
    ("proj", None),
    ("window", None),
    ("separate", None),
    ("hlgauss", None), ("hlgauss_two_part", None), ("dreamer", None),
    ("entity", None), ("entity_concat_self", None), ("entity_ff", None),
])
def test_which_populations_take_the_chunked_path(kind, missing):
    prefix = ((lambda obs: obs) if kind.startswith("entity")
              else (lambda obs: obs["x"]))
    backbone = (tm.BackboneSeparate(prefix, _tower("mlp"), _tower("mlp"))
                if kind == "separate"
                else tm.BackboneShared(prefix, _tower(kind)))
    critics = {"hlgauss": lambda: tm.HLGaussCritic.create(128, F32),
               "hlgauss_two_part":
                   lambda: tm.HLGaussTwoPartCritic.create(128, F32),
               "dreamer": lambda: tm.DreamerV3Critic(128, F32)}
    critic = critics.get(kind, lambda: tm.DenseLayerCritic(128, F32))()
    model = tm.ActorCritic(
        backbone=backbone,
        actor=tm.DictActor({"move": tm.DenseLayerDiscreteActor(
            tlt.DiscreteActionsConfig(actions_num_buckets=[3]), 128,
            F32)}),
        critic=critic)
    caster = tlt.ObservationsCaster.create(F32)
    assert t_rollouts.chunked_path_missing(model, caster) == missing


# -- lstm_sequence_fwd_chunked -----------------------------------------------

def _chunked_inputs(seed, T, B, C, H, P):
    rng = np.random.default_rng(seed)
    N = B * C
    f = lambda *shape, scale=1.0: torch.from_numpy(
        (rng.normal(size=shape) * scale).astype(np.float32))
    keep = torch.from_numpy((rng.random((T, N)) > 0.3).astype(np.float32))
    return (f(T, N, 4 * H), keep, f(P, H, 4 * H, scale=H ** -0.5),
            f(P, 4 * H, scale=0.1), f(N, H), f(N, H))


def test_chunked_lstm_twin_is_each_chunks_reference():
    """Chunk b of 37 rows with policy chunk_policy[b]'s weights, bitwise
    ``lstm_sequence_reference`` on those rows; a chunk of index P (a
    custom policy's) and one of -1 come out NaN."""
    T, C, Hd, P = 2, 37, 128, 3
    chunk_policy = torch.tensor([2, 0, P, 1, -1, 2], dtype=torch.int32)
    B = chunk_policy.shape[0]
    x, keep, wr, bias, c0, h0 = _chunked_inputs(5, T, B, C, Hd, P)
    ys, cs = lstm_sequence_fwd_chunked_reference(x, keep, wr, bias,
                                                 chunk_policy, c0, h0)
    assert ys.shape == cs.shape == (T, B * C, Hd)
    for b, p in enumerate(chunk_policy.tolist()):
        rows = slice(b * C, (b + 1) * C)
        if not 0 <= p < P:
            assert ys[:, rows].isnan().all() and cs[:, rows].isnan().all()
            continue
        want = lstm_sequence_reference(x[:, rows], keep[:, rows], wr[p],
                                       bias[p], c0[rows], h0[rows])
        assert torch.equal(ys[:, rows], want)
        if b < 2:
            jax_want = jax_lstm_seq(*(jnp.asarray(t.numpy()) for t in (
                x[:, rows], keep[:, rows], wr[p], bias[p], c0[rows],
                h0[rows])), True)
            np.testing.assert_allclose(ys[:, rows].numpy(),
                                       np.asarray(jax_want), rtol=1e-5,
                                       atol=1e-5)
    # The step is T = 1 of it.
    new_c, new_h = lstm_mod.lstm_step_chunked(x[0], wr, bias, chunk_policy,
                                              c0, h0)
    full = lstm_sequence_fwd_chunked_reference(
        x[:1], torch.ones_like(keep[:1]), wr, bias, chunk_policy, c0, h0)
    torch.testing.assert_close(new_h, full[0][0], rtol=0, atol=0,
                               equal_nan=True)
    torch.testing.assert_close(new_c, full[1][0], rtol=0, atol=0,
                               equal_nan=True)


@pytest.mark.parametrize("dtype,H,tensor_core", [
    (BF16, 256, True), (BF16, 128, True), (F32, 256, False),
    (F32, 128, False), (F16, 256, False), (F16, 128, False)])
def test_chunked_lstm_wrapper_routes(monkeypatch, dtype, H, tensor_core):
    """The wrapper takes the route of ``lstm_sequence_fwd``'s rule, hands
    the kernel the stacks' own storage, the chunk count, the chunk size
    and the policy count, and counts one launch (and a tensor-core one on
    that route). Operands stand on the CPU: the library, the operand check
    and the stream are stand-ins."""
    lib = _stand_in_card(monkeypatch)
    monkeypatch.setattr(LSTM_FWD_CHUNKED, "launches", 0)
    monkeypatch.setattr(LSTM_FWD_CHUNKED, "tc_launches", 0)
    B, C, P = 3, 40, 5
    wr = torch.zeros(P, H, 4 * H, dtype=dtype)
    bias = torch.zeros(P, 4 * H, dtype=dtype)
    state = torch.zeros(B * C, H, dtype=dtype)
    ys, cs = lstm_sequence_fwd_chunked(
        torch.zeros(1, B * C, 4 * H, dtype=dtype),
        torch.ones(1, B * C, dtype=dtype), wr, bias,
        torch.zeros(B, dtype=torch.int32), state, state)
    assert lib.calls == ["mlt_lstm_fwd_chunked"]
    (args,) = lib.args
    assert args[:3] == (int(tensor_core), {F32: 0, BF16: 1, F16: 2}[dtype],
                        H)
    assert args[5:7] == (wr.data_ptr(), bias.data_ptr())
    assert args[12:16] == (1, B, C, P)
    assert ys.shape == cs.shape == (1, B * C, H) and ys.dtype == dtype
    assert (LSTM_FWD_CHUNKED.launches, LSTM_FWD_CHUNKED.tc_launches) == (
        1, int(tensor_core))


def test_chunked_lstm_wrapper_refuses_what_no_kernel_takes():
    """Off the CPU, the kernel path raises on what it cannot take (meta
    tensors are on no card; float16 at a hidden size no instance takes;
    rows that are not whole chunks)."""
    before = (LSTM_FWD_CHUNKED.launches, LSTM_FWD_CHUNKED.tc_launches)

    def meta(*shape, dtype=BF16):
        return torch.empty(*shape, dtype=dtype, device="meta")

    idx = meta(3, dtype=torch.int32)
    for rows, H, dtype in ((96, 256, BF16), (96, 96, F16), (95, 256, BF16)):
        with pytest.raises(ValueError):
            lstm_sequence_fwd_chunked(
                meta(1, rows, 4 * H, dtype=dtype),
                meta(1, rows, dtype=dtype),
                meta(2, H, 4 * H, dtype=dtype), meta(2, 4 * H, dtype=dtype),
                idx, meta(rows, H, dtype=dtype), meta(rows, H, dtype=dtype))
    assert (LSTM_FWD_CHUNKED.launches,
            LSTM_FWD_CHUNKED.tc_launches) == before
