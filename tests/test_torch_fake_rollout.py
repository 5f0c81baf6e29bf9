"""The port's matchmade rollout loop against an integer-exact oracle.

The oracle of ``tests/test_rollouts.py``: the fake sim and the fake policy
(``envs/fake_sim.py``) are an integer recurrence whose one parameter, the
bias, is the policy's index, so every action names the policy that took
it. A numpy recomputation of every agent's trajectory must equal the
port's actions, values, rewards, dones and recurrent states exactly, over
the non-slow sweep of teams, team sizes, batches, play portions and
policy-chunk size overrides (``tests/test_rollouts.py:CONFIGS``);
assignments may change only where an episode ended, and satisfy the
matchmaking invariants after every step. The fake modules have
policy-batched forms, so the sweep runs through the rollout's policy-chunk
layout (``chunked_rollout_loop``), with the recurrent state in chunk order
too, and again through the per-policy loop. No agreement with the JAX
package's random draws is needed.
"""

import numpy as np
import pytest
import torch

from madrona_learn_tpu_torch.envs.fake_sim import (
    FakeActor,
    FakeCritic,
    FakeNet,
    FakeRNN,
    FakeSimConfig,
    make_fake_sim,
)
from madrona_learn_tpu_torch.models import (
    ActorCritic,
    BackboneShared,
    DictActor,
    RecurrentBackboneEncoder,
)
from madrona_learn_tpu_torch.observations import ObservationsPreprocessNoop
from madrona_learn_tpu_torch.rollouts import (
    RolloutConfig,
    RolloutState,
    chunked_rollout_loop,
    rollout_loop,
)
from madrona_learn_tpu_torch.train_state import Population, PolicyState


def fake_population(num_policies):
    """Policy p is the fake policy with bias p."""
    noop = ObservationsPreprocessNoop.create()
    policies = []
    for p in range(num_policies):
        actor_critic = ActorCritic(
            backbone=BackboneShared(
                prefix=lambda obs: obs,
                encoder=RecurrentBackboneEncoder(net=FakeNet(),
                                                 rnn=FakeRNN())),
            actor=DictActor({"fake": FakeActor()}),
            critic=FakeCritic())
        actor_critic.backbone.encoder.net.bias.data.fill_(p)
        policies.append(PolicyState(actor_critic, noop,
                                    {"o": None, "c": None}))
    return Population(policies=policies, reward_hyper_params=None,
                      get_episode_scores_fn=lambda er: (0.0, 0.0),
                      episode_score=None, mmr=None)


def run_fake_rollout(seed, num_steps, episode_len, num_current_policies,
                     num_past_policies, num_teams, team_size, batch_size,
                     self_play, cross_play, past_play,
                     policy_chunk_size_override=0, chunked=True,
                     chunkwise_rnn=False):
    rollout_cfg = RolloutConfig.setup_population(
        num_current_policies=num_current_policies,
        num_past_policies=num_past_policies, num_teams=num_teams,
        team_size=team_size, sim_batch_size=batch_size,
        actions_cfg={"fake": None}, self_play_portion=self_play,
        cross_play_portion=cross_play, past_play_portion=past_play,
        static_play_portion=0.0, reward_dtype=torch.int32,
        policy_chunk_size_override=policy_chunk_size_override,
        policy_chunked=chunked)
    sim_cfg = FakeSimConfig(batch_size=batch_size, episode_len=episode_len,
                            num_teams=num_teams, team_size=team_size)
    population = fake_population(rollout_cfg.pbt.total_num_policies)
    state = RolloutState.create(
        rollout_cfg, make_fake_sim(sim_cfg, device="cpu"),
        torch.Generator().manual_seed(seed),
        population[0].actor_critic.init_recurrent_state(batch_size),
        torch.zeros((1,), dtype=torch.int32))
    init_obs = {k: v.clone() for k, v in state.cur_obs.items()}
    init_assignments = state.policy_assignments.clone()

    def post_inference_cb(step_idx, obs, preprocessed_obs, policy_out,
                          cb_state):
        return cb_state, {"actions": policy_out["actions"]["fake"],
                          "values": policy_out["critic"]}

    def post_step_cb(step_idx, rollout_state, dones, rewards,
                     episode_results, cb_state):
        rnn = rollout_state.rnn_states
        if chunkwise_rnn:
            # Chunk order within the loop: the layout of the next step.
            rnn = rollout_state.reorder_state.to_sim(rnn)
        return rollout_state, cb_state, {
            "dones": dones, "rewards": rewards,
            "post_assignments": rollout_state.policy_assignments.clone(),
            "rnn_states": rnn.clone()}

    if chunkwise_rnn:
        _, _, (inf, step) = chunked_rollout_loop(
            state, population, num_steps, post_inference_cb, post_step_cb,
            None, chunkwise_rnn=True)
    else:
        _, _, (inf, step) = rollout_loop(state, population, num_steps,
                                         post_inference_cb, post_step_cb,
                                         None)
    to_np = lambda tree: {k: v.numpy() for k, v in tree.items()}
    return (sim_cfg, rollout_cfg, to_np(init_obs), init_assignments.numpy(),
            to_np(inf), to_np(step))


def verify_rollout_data(sim_cfg, init_obs, init_assignments, inf, step):
    """The numpy oracle of the integer recurrence, exactly."""
    B = sim_cfg.batch_size
    o = init_obs["o"].reshape(B).astype(np.int32)
    c = init_obs["c"].reshape(B).astype(np.int32)
    h = np.zeros(B, dtype=np.int32)
    assignment = init_assignments.reshape(B).astype(np.int32).copy()
    with np.errstate(over="ignore"):
        for t in range(inf["actions"].shape[0]):
            bias = assignment
            x0 = o + bias
            y = x0 + h
            new_h = h + np.int32(2) * x0
            actions = inf["actions"][t]
            np.testing.assert_array_equal(actions[:, 0], y, f"t={t} y")
            np.testing.assert_array_equal(actions[:, 1], bias,
                                          f"t={t} bias")
            np.testing.assert_array_equal(actions[:, 2], c, f"t={t} c")
            np.testing.assert_array_equal(inf["values"][t].reshape(B),
                                          new_h, f"t={t} value")
            np.testing.assert_array_equal(step["rewards"][t].reshape(B),
                                          y + 2, f"t={t} reward")
            c = (c + 1) % sim_cfg.episode_len
            expected_dones = c == 0
            np.testing.assert_array_equal(step["dones"][t].reshape(B),
                                          expected_dones, f"t={t} dones")
            o = y + 1
            h = np.where(expected_dones, 0, new_h)
            np.testing.assert_array_equal(step["rnn_states"][t].reshape(B),
                                          h, f"t={t} rnn")
            # Assignments change only where an episode ended.
            new_assignment = step["post_assignments"][t].reshape(B)
            np.testing.assert_array_equal(
                new_assignment[~expected_dones],
                assignment[~expected_dones],
                f"t={t} assignment changed without done")
            assignment = new_assignment


def check_assignments(rollout_cfg, assignments):
    """Matchmaking invariants (``tests/test_rollouts.py``'s
    ``check_assignments``)."""
    pbt = rollout_cfg.pbt
    a = assignments.reshape(-1, pbt.num_teams, pbt.team_size)
    assert (a == a[:, :, 0:1]).all(), "a team mixes policies"
    self_end = pbt.self_play_batch_size
    cross_end = self_end + pbt.cross_play_batch_size
    past_end = cross_end + pbt.past_play_batch_size
    flat = assignments.reshape(-1)
    P = pbt.num_current_policies
    if self_end > 0:
        assert (flat[:self_end] < P).all()
    if cross_end > self_end:
        cross = flat[self_end:cross_end].reshape(-1, pbt.num_teams,
                                                 pbt.team_size)
        assert (cross[:, 0, :] < P).all()
        assert (cross[:, 1:, :] < P).all()
        assert (cross[:, 1:, :] != cross[:, 0:1, 0:1]).all()
    if past_end > cross_end:
        past = flat[cross_end:past_end].reshape(-1, pbt.num_teams,
                                                pbt.team_size)
        assert (past[:, 0, :] < P).all()
        assert (past[:, 1:, :] >= P).all()
        assert (past[:, 1:, :] < pbt.total_num_policies).all()


# tests/test_rollouts.py:CONFIGS: (num_steps, episode_len, n_cur, n_past,
# teams, team_size, batch, self, cross, past, chunk_override), and one more
# batch of 512.
CONFIGS = [
    (8, 3, 1, 0, 1, 1, 4, 1.0, 0.0, 0.0, 0),
    (16, 5, 4, 0, 1, 1, 32, 1.0, 0.0, 0.0, 0),
    (16, 5, 4, 0, 2, 2, 64, 1.0, 0.0, 0.0, 0),
    (16, 4, 4, 0, 2, 1, 64, 0.5, 0.5, 0.0, 8),
    (16, 4, 4, 2, 2, 1, 64, 0.5, 0.25, 0.25, 8),
    (20, 7, 8, 7, 2, 2, 256, 0.25, 0.5, 0.25, 16),
    (10, 3, 2, 1, 2, 2, 32, 0.0, 0.5, 0.5, 4),
    (12, 5, 4, 2, 2, 1, 512, 0.25, 0.5, 0.25, 0),
]


@pytest.mark.parametrize("cfg_tuple", CONFIGS)
def test_fake_rollout_exact(cfg_tuple, chunked=True, chunkwise_rnn=False):
    """The policy-chunk layout (the path of every population whose modules
    have batched forms), at the chunk size of the override."""
    (num_steps, episode_len, n_cur, n_past, teams, team_size, batch,
     self_p, cross_p, past_p, chunk) = cfg_tuple
    sim_cfg, rollout_cfg, init_obs, init_assignments, inf, step = \
        run_fake_rollout(7, num_steps, episode_len, n_cur, n_past, teams,
                         team_size, batch, self_p, cross_p, past_p, chunk,
                         chunked, chunkwise_rnn)
    if chunk:
        assert rollout_cfg.policy_chunk_size == chunk
    check_assignments(rollout_cfg, init_assignments)
    verify_rollout_data(sim_cfg, init_obs, init_assignments, inf, step)
    for post in step["post_assignments"]:
        check_assignments(rollout_cfg, post)
    if (cross_p and n_cur > 2) or (past_p and n_past > 1):
        # Where an opponent has a choice, matchmaking drew new ones.
        assert (step["post_assignments"] != init_assignments).any()


@pytest.mark.parametrize("cfg_tuple", CONFIGS)
def test_fake_rollout_exact_per_policy_loop(cfg_tuple):
    """The per-policy loop (``population_rollout_loop``), which models
    without batched forms take."""
    test_fake_rollout_exact(cfg_tuple, chunked=False)


@pytest.mark.parametrize("cfg_tuple", [c for c in CONFIGS if c[7] < 1.0])
def test_fake_rollout_exact_chunkwise_rnn(cfg_tuple):
    """The recurrent state kept in chunk order across steps
    (``chunkwise_rnn``, matchmaking only)."""
    test_fake_rollout_exact(cfg_tuple, chunkwise_rnn=True)
