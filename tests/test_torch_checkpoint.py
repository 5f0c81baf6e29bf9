"""The port's checkpoints, on the CPU and the port alone (the JAX
package's ``tests/test_checkpoint.py``, ``tests/test_resume_and_profiler.py``
and ``tests/test_population_surgery.py`` for the port).

Two trainers: a single policy (the headline's MLP + LSTM at width 32 over
16 toy worlds, the EMA obs normalizer, 8 steps in 2 BPTT chunks, 2
minibatches) and ``tests/test_pbt_e2e.py``'s population (4 train + 2 past
policies, 32 duel worlds, an MLP + LSTM of 32, lr searched in log10
space). A checkpoint must round-trip every tensor and generator bitwise,
and a fresh manager that loads update 2 and takes the saved run's rollout
state must take the same next update, bitwise.
"""

import copy
import dataclasses
import os
import stat

import pytest
import torch

import madrona_learn_tpu_torch as tlt
import madrona_learn_tpu_torch.models as tm
import madrona_learn_tpu_torch.train_state as t_train_state
from madrona_learn_tpu_torch.config import DiscreteActionsConfig
from madrona_learn_tpu_torch.envs import (ToyEnvConfig, make_duel_env,
                                          make_toy_env)
from madrona_learn_tpu_torch.train_state import (PolicyState, Population,
                                                 TrainStateManager)

torch.set_num_threads(1)

H, W, STEPS, CHUNKS = 32, 16, 8, 2
DUEL_WORLDS, NUM_TRAIN, NUM_PAST = 32, 4, 2
MOVE = {"move": DiscreteActionsConfig(actions_num_buckets=[5])}


def _actor_critic(prefix, in_features):
    return tm.ActorCritic(
        backbone=tm.BackboneShared(
            prefix=prefix,
            encoder=tm.RecurrentBackboneEncoder(
                net=tm.MLP(in_features, H, 1, torch.float32),
                rnn=tm.LSTM(H, H, 1, torch.float32))),
        actor=tm.DictActor({"move": tm.DenseLayerDiscreteActor(
            MOVE["move"], H, torch.float32)}),
        critic=tm.DenseLayerCritic(H, torch.float32))


def _toy_model():
    return _actor_critic(lambda obs: torch.cat([obs["delta"], obs["time"]],
                                               -1), 3)


def _duel_model(p=0):
    return _actor_critic(lambda obs: torch.cat([obs["time"], obs["acc"]],
                                               -1), 2)


def _duel_scores(er):
    winner = er[0]
    a = torch.where(winner == 0, 1.0, torch.where(winner == 1, 0.0, 0.5))
    return a, 1.0 - a


class CountingHooks(tlt.TrainHooks):
    """A user state that counts the collect phases."""

    def init_user_state(self):
        return {"rollout_count": torch.zeros((), dtype=torch.int32)}

    def finish_rollouts(self, rollouts, bootstrap_values,
                        unnormalized_values, unnormalized_bootstrap_values,
                        user_state):
        return rollouts, {"rollout_count": user_state["rollout_count"] + 1}


def single_trainer(seed=5, hooks=tlt.TrainHooks(), restore_ckpt=None):
    cfg = tlt.TrainConfig(
        num_worlds=W, num_agents_per_world=1, actions=MOVE,
        steps_per_update=STEPS, num_bptt_chunks=CHUNKS, lr=1e-3,
        gamma=0.99, gae_lambda=0.95, seed=seed, metrics_buffer_size=1,
        algo=tlt.PPOConfig(num_epochs=1, minibatch_size=W * CHUNKS // 2,
                           clip_coef=0.2, value_loss_coef=0.5,
                           entropy_coef=0.01, max_grad_norm=0.5),
        dreamer_v3_critic=False)
    torch.manual_seed(seed)
    policy = tlt.Policy(_toy_model(), tlt.ObservationsEMANormalizer.create(
        decay=0.99999, dtype=torch.float32))
    env = make_toy_env(ToyEnvConfig(num_worlds=W, episode_len=5,
                                    grid_size=5, seed=seed), device="cpu")
    return tlt.init_training("cpu", cfg, env, policy,
                             torch.zeros((1,), dtype=torch.int32),
                             user_hooks=hooks, restore_ckpt=restore_ckpt)


def pbt_trainer(seed=3, restore_ckpt=None):
    cfg = tlt.TrainConfig(
        num_worlds=DUEL_WORLDS, num_agents_per_world=2, actions=MOVE,
        steps_per_update=16, num_bptt_chunks=2,
        lr=tlt.ParamExplore(base=1e-3, min_scale=0.1, max_scale=10.0,
                            log10_scale=True),
        gamma=0.99, gae_lambda=0.95, seed=seed, metrics_buffer_size=1,
        algo=tlt.PPOConfig(num_epochs=1, minibatch_size=10, clip_coef=0.2,
                           value_loss_coef=0.5, entropy_coef=0.01,
                           max_grad_norm=0.5),
        pbt=tlt.PBTConfig(num_teams=2, team_size=1,
                          num_train_policies=NUM_TRAIN,
                          num_past_policies=NUM_PAST,
                          self_play_portion=0.25, cross_play_portion=0.5,
                          past_play_portion=0.25,
                          policy_overwrite_threshold=0.5),
        dreamer_v3_critic=False)
    torch.manual_seed(seed)
    policy = tlt.Policy(_duel_model,
                        tlt.ObservationsCaster.create(torch.float32),
                        _duel_scores)
    env = make_duel_env(ToyEnvConfig(num_worlds=DUEL_WORLDS, episode_len=8,
                                     num_teams=2, team_size=1, seed=seed),
                        device="cpu")
    return tlt.init_training("cpu", cfg, env, policy,
                             torch.zeros((1,), dtype=torch.int32),
                             restore_ckpt=restore_ckpt)


TRAINERS = {"single": single_trainer, "pbt": pbt_trainer}


def copy_rollout(rollout):
    """A copy of a rollout state that shares no tensor or generator with
    it."""
    generator = torch.Generator(device=rollout.generator.device)
    generator.set_state(rollout.generator.get_state())
    state = copy.deepcopy(dataclasses.replace(rollout, generator=None))
    return dataclasses.replace(state, generator=generator)


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}{i}/")
    else:
        yield prefix, tree


def assert_trees_bitwise(got, want):
    got, want = dict(leaves(got)), dict(leaves(want))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        if isinstance(w, torch.Tensor):
            assert g.dtype == w.dtype and torch.equal(g, w), name
        else:
            assert g == w, name


def state_of(mgr):
    """Everything a checkpoint holds, generators included."""
    return mgr.state.checkpoint(mgr.update_idx)


@pytest.fixture(scope="module", params=sorted(TRAINERS))
def trained(request, tmp_path_factory):
    """Two updates, a checkpoint, the rollout state as it was then and the
    third update's state."""
    mgr = TRAINERS[request.param]()
    for _ in range(2):
        mgr.update_iter()
    ckpt_dir = str(tmp_path_factory.mktemp(request.param))
    mgr.save_ckpt(ckpt_dir)
    saved = state_of(mgr)
    rollout = copy_rollout(mgr.rollout)
    mgr.update_iter()
    return dict(kind=request.param, mgr=mgr, ckpt_dir=ckpt_dir, saved=saved,
                rollout=rollout, after=state_of(mgr))


def test_round_trip_is_bitwise(trained):
    fresh = TRAINERS[trained["kind"]](seed=11)
    before = [p for p in fresh.state._policies()]
    params = [dict(p.actor_critic.named_parameters()) for p in before]
    assert fresh.update_idx == 0
    with pytest.raises(AssertionError):
        assert_trees_bitwise(state_of(fresh), trained["saved"])
    fresh.load_ckpt(os.path.join(trained["ckpt_dir"], "2"))
    assert fresh.update_idx == 2
    assert_trees_bitwise(state_of(fresh), trained["saved"])
    # Loaded in place: the same modules and parameter tensors.
    for policy, old, named in zip(fresh.state._policies(), before, params):
        assert policy.actor_critic is old.actor_critic
        for name, p in policy.actor_critic.named_parameters():
            assert p is named[name]


def test_resume_equals_the_uninterrupted_run(trained):
    fresh = TRAINERS[trained["kind"]](
        seed=11, restore_ckpt=tlt.latest_checkpoint(trained["ckpt_dir"]))
    assert fresh.update_idx == 2 and fresh.metrics.update_idx == 2
    fresh.rollout = copy_rollout(trained["rollout"])
    fresh.update_iter()
    assert fresh.update_idx == 3
    assert_trees_bitwise(state_of(fresh), trained["after"])


def test_latest_checkpoint(tmp_path):
    ckpt_dir = str(tmp_path / "ck")
    assert tlt.latest_checkpoint(ckpt_dir) is None
    mgr = single_trainer()
    for _ in range(2):
        mgr.update_iter()
    mgr.save_ckpt(ckpt_dir)
    assert tlt.latest_checkpoint(ckpt_dir).endswith(f"{os.sep}2")
    mgr.update_iter()
    mgr.save_ckpt(ckpt_dir)
    # A write cut short leaves only its temporary file, which is skipped.
    open(os.path.join(ckpt_dir, "10.tmp"), "wb").close()
    assert tlt.latest_checkpoint(ckpt_dir).endswith(f"{os.sep}3")
    resumed = single_trainer(restore_ckpt=tlt.latest_checkpoint(ckpt_dir))
    assert resumed.update_idx == 3 and resumed.metrics.update_idx == 3
    resumed.update_iter()
    assert resumed.update_idx == 4


def test_a_failed_write_leaves_no_checkpoint(tmp_path, monkeypatch):
    mgr = single_trainer()
    mgr.update_iter()
    ckpt_dir = str(tmp_path / "ck")
    mgr.save_ckpt(ckpt_dir)

    def broken_save(obj, f):
        f.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(t_train_state.torch, "save", broken_save)
    mgr.update_iter()
    with pytest.raises(OSError):
        mgr.save_ckpt(ckpt_dir)
    assert sorted(os.listdir(ckpt_dir)) == ["1", "2.tmp"]
    assert tlt.latest_checkpoint(ckpt_dir).endswith(f"{os.sep}1")


def test_a_write_is_synced_before_and_after_its_rename(tmp_path,
                                                       monkeypatch):
    """The file reaches the disk before it takes its name, and the rename
    reaches the disk before the save returns."""
    events = []
    fsync, replace = os.fsync, os.replace

    def logged_fsync(fd):
        events.append(("fsync", stat.S_ISDIR(os.fstat(fd).st_mode)))
        fsync(fd)

    def logged_replace(src, dst):
        events.append(("replace", os.path.basename(dst)))
        replace(src, dst)

    monkeypatch.setattr(t_train_state.os, "fsync", logged_fsync)
    monkeypatch.setattr(t_train_state.os, "replace", logged_replace)
    mgr = single_trainer()
    mgr.save_ckpt(str(tmp_path / "ck"))
    assert events == [("fsync", False), ("replace", "0"), ("fsync", True)]


def test_async_save_snapshots_before_returning(tmp_path):
    mgr = single_trainer()
    mgr.update_iter()
    want = state_of(mgr)
    ckpt_dir = str(tmp_path / "async")
    mgr.save_ckpt(ckpt_dir, block=False)
    # Training goes on at once and writes the parameters in place.
    mgr.update_iter()
    tlt.wait_for_checkpoints()
    assert_trees_bitwise(
        TrainStateManager.restore_host(os.path.join(ckpt_dir, "1")), want)
    assert not t_train_state._WRITERS


def test_async_write_errors_reach_wait_for_checkpoints(tmp_path,
                                                       monkeypatch):
    mgr = single_trainer()
    monkeypatch.setattr(t_train_state.torch, "save",
                        lambda obj, f: (_ for _ in ()).throw(
                            OSError("disk full")))
    mgr.save_ckpt(str(tmp_path / "async"), block=False)
    with pytest.raises(OSError, match="disk full"):
        tlt.wait_for_checkpoints()
    tlt.wait_for_checkpoints()


def test_user_state_round_trip(tmp_path):
    hooks = CountingHooks()
    mgr = single_trainer(hooks=hooks)
    for _ in range(2):
        mgr.update_iter()
    assert int(mgr.state.user_state["rollout_count"]) == 2
    ckpt_dir = str(tmp_path / "ck")
    mgr.save_ckpt(ckpt_dir)
    fresh = single_trainer(hooks=hooks)
    assert int(fresh.state.user_state["rollout_count"]) == 0
    fresh.load_ckpt(tlt.latest_checkpoint(ckpt_dir))
    assert int(fresh.state.user_state["rollout_count"]) == 2


def test_checkpoint_reads_with_weights_only(trained):
    ckpt = torch.load(os.path.join(trained["ckpt_dir"], "2"),
                      weights_only=True)
    assert ckpt["next_update"] == 2
    num = NUM_TRAIN + NUM_PAST if trained["kind"] == "pbt" else 1
    assert len(ckpt["policy_states"]) == num
    assert (ckpt["population"] is None) == (trained["kind"] == "single")


def test_loading_into_another_configuration_raises(trained, tmp_path):
    other = "single" if trained["kind"] == "pbt" else "pbt"
    with pytest.raises(ValueError):
        TRAINERS[other]().load_ckpt(
            os.path.join(trained["ckpt_dir"], "2"))


@pytest.fixture(scope="module")
def pbt_ckpt(tmp_path_factory):
    mgr = pbt_trainer(seed=41)
    mgr.update_iter()
    # Distinct ratings, so a slice's order shows.
    mgr.state.policy_states.mmr.elo = torch.arange(
        NUM_TRAIN + NUM_PAST, dtype=torch.float32) * 10 + 1400
    ckpt_dir = tmp_path_factory.mktemp("surgery")
    mgr.save_ckpt(str(ckpt_dir))
    return mgr, str(ckpt_dir / "1")


def test_slice_checkpoint(pbt_ckpt, tmp_path):
    mgr, path = pbt_ckpt
    dst = str(tmp_path / "sliced")
    TrainStateManager.slice_checkpoint(path, dst, [0, 2], [1])
    src, got = (TrainStateManager.restore_host(p) for p in (path, dst))
    assert len(got["policy_states"]) == 3 and len(got["train_states"]) == 2
    for new, old in zip(got["policy_states"], [0, 2, 1]):
        assert_trees_bitwise(new, src["policy_states"][old])
    for new, old in zip(got["train_states"], [0, 2]):
        assert_trees_bitwise(new, src["train_states"][old])
    assert got["population"]["mmr"]["elo"].tolist() == [1400.0, 1420.0,
                                                        1410.0]
    assert got["population"]["episode_score"] is None
    assert torch.equal(got["pbt_generator"], src["pbt_generator"])
    assert got["next_update"] == 1


def test_load_policies_and_eval_load_ckpt(pbt_ckpt):
    mgr, path = pbt_ckpt
    policy = tlt.Policy(_duel_model,
                        tlt.ObservationsCaster.create(torch.float32),
                        _duel_scores)
    population, num_train, total = TrainStateManager.load_policies(policy,
                                                                   path)
    assert isinstance(population, Population)
    assert (num_train, total) == (NUM_TRAIN, NUM_TRAIN + NUM_PAST)
    live = mgr.state.policy_states
    for got, want in zip(population.policies, live.policies):
        assert got.actor_critic is not want.actor_critic
        assert_trees_bitwise(got.actor_critic.state_dict(),
                             want.actor_critic.state_dict())
    assert torch.equal(population.mmr.elo, live.mmr.elo)
    train, n = tlt.eval_load_ckpt(policy, path)
    assert n == NUM_TRAIN and len(train) == NUM_TRAIN
    assert torch.equal(train.mmr.elo, live.mmr.elo[:NUM_TRAIN])
    everyone, n = tlt.eval_load_ckpt(policy, path, train_only=False)
    assert n == len(everyone) == NUM_TRAIN + NUM_PAST
    one, n = tlt.eval_load_ckpt(policy, path, single_policy=5)
    assert n == len(one) == 1
    assert one.mmr.elo.tolist() == [1450.0]
    assert_trees_bitwise(one[0].actor_critic.state_dict(),
                         live[5].actor_critic.state_dict())


def test_load_policies_of_a_single_policy(tmp_path):
    mgr = single_trainer()
    mgr.update_iter()
    mgr.save_ckpt(str(tmp_path))
    path = os.path.join(str(tmp_path), "1")
    policy = tlt.Policy(_toy_model(), tlt.ObservationsEMANormalizer.create(
        decay=0.99999, dtype=torch.float32))
    untouched = copy.deepcopy(policy.actor_critic.state_dict())
    state, num_train, total = TrainStateManager.load_policies(policy, path)
    assert isinstance(state, PolicyState) and (num_train, total) == (1, 1)
    live = mgr.state.policy_states
    assert_trees_bitwise(state.actor_critic.state_dict(),
                         live.actor_critic.state_dict())
    assert_trees_bitwise(state.obs_preprocess_state,
                         live.obs_preprocess_state)
    assert_trees_bitwise(policy.actor_critic.state_dict(), untouched)
    one, n = tlt.eval_load_ckpt(policy, path)
    assert n == 1 and isinstance(one, PolicyState)
