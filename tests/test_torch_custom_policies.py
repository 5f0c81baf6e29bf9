"""Custom policies: ids outside the population that the simulator plays
itself, in the port's matchmade rollout and in the Elo tournament.

- ``eval_elo`` with ``custom_policy_ids=[100]`` on ``tests/test_pbt_e2e.py``'s
  trainer, in both packages, over a duel that plays every row assigned
  policy 100 with a fixed bid. The port takes the JAX population's weights
  and replays the JAX tournament's sampled actions (the JAX sim step
  reports them through an ordered ``jax.debug.callback``; the port runs
  the tournament in the policy-chunk layout and its ``categorical``
  returns the step's actions gathered into the step's chunks, as
  ``tests/test_torch_pbt_slice.py`` replays them). The population's Elo
  must agree to 1e-5 relative.
- ``rollouts._PolicyRows``: no module runs on a custom row, a custom row's
  outputs and preprocessed obs are zeros and its recurrent state is kept,
  and the other rows equal a run where those rows belong to a policy.
- A fault of the JAX package that the port does not copy: its chunk
  reorder sends a custom row to the slot of the last policy's first row.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import madrona_learn_tpu as mlt
import madrona_learn_tpu_torch as tlt
import madrona_learn_tpu_torch.ops.dists as t_dists
import madrona_learn_tpu_torch.rollouts as t_rollouts
import madrona_learn_tpu_torch.train_state as t_train_state
from madrona_learn_tpu.envs import make_duel_env as jax_make_duel_env
from madrona_learn_tpu.ops.reorder import compute_reorder_chunks
from madrona_learn_tpu_torch.envs import ToyEnvConfig, make_duel_env
from madrona_learn_tpu_torch.train_state import (MMR, PolicyState,
                                                 Population)
from test_pbt_e2e import (EPISODE_LEN, NUM_PAST, NUM_TRAIN, NUM_WORLDS,
                          build_training_mgr)
from test_torch_pbt_slice import (_get_episode_scores, _policy_params,
                                  _recording_env, _torch_cfg, _torch_model)
from test_torch_slice import _np

torch.set_num_threads(1)

SEED = 3
CUSTOM, BID = 100, 2
EVAL_STEPS = 2 * EPISODE_LEN
NUM_POLICIES = NUM_TRAIN + NUM_PAST


def fixed_bid(env, xp):
    """``env`` whose step plays every row assigned policy ``CUSTOM`` with
    the bid ``BID`` (``xp``: ``jnp`` or ``torch``)."""
    step = env["step"]

    def fixed_step(step_input):
        move = step_input["actions"]["move"]
        assignments = step_input["pbt"]["policy_assignments"].reshape(
            move.shape[0], 1)
        move = xp.where(assignments == CUSTOM, BID, move)
        return step(dict(step_input, actions={"move": move}))

    return dict(env, step=fixed_step)


@pytest.fixture(scope="module")
def jax_run():
    steps = []
    mp = pytest.MonkeyPatch()
    real_cfg = mlt.TrainConfig
    mp.setattr(mlt, "TrainConfig", lambda **kw: real_cfg(
        **dict(kw, custom_policy_ids=[CUSTOM])))
    mp.setattr("test_pbt_e2e.make_duel_env", lambda cfg: _recording_env(
        fixed_bid(jax_make_duel_env(cfg), jnp), steps))
    try:
        mgr = build_training_mgr(seed=SEED)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            evaluated, deltas = mlt.eval_elo(
                mgr, EVAL_STEPS, jnp.zeros((1,), jnp.int32),
                jnp.zeros((1,), jnp.int32))
        jax.block_until_ready(evaluated)
        jax.effects_barrier()
    finally:
        mp.undo()
    steps = [actions for actions, reset in steps if not reset]
    assert len(steps) == EVAL_STEPS
    return dict(mgr=mgr, evaluated=evaluated, deltas=deltas, steps=steps)


@pytest.fixture(scope="module")
def torch_run(jax_run):
    steps = list(jax_run["steps"])
    pending, custom_rows = [], []
    real_rollout = t_train_state.PopulationStack.rollout

    def replay_rollout(self, layout, *args, **kwargs):
        actions = torch.from_numpy(steps.pop(0).astype(np.int64))
        pending[:] = [layout.to_policy(actions)]
        custom_rows.append(0 if layout.custom_rows is None
                           else int(layout.custom_rows.sum()))
        return real_rollout(self, layout, *args, **kwargs)

    mp = pytest.MonkeyPatch()
    mp.setattr(t_train_state.PopulationStack, "rollout", replay_rollout)
    mp.setattr(t_dists, "categorical",
               lambda logits, generator: pending.pop(0))
    try:
        cfg = _torch_cfg()
        cfg = type(cfg)(**dict(vars(cfg), custom_policy_ids=[CUSTOM]))
        policy = tlt.Policy(lambda p: _torch_model("mlp"),
                            tlt.ObservationsCaster.create(torch.float32),
                            _get_episode_scores)
        env = make_duel_env(ToyEnvConfig(num_worlds=NUM_WORLDS,
                                         episode_len=EPISODE_LEN,
                                         num_teams=2, team_size=1,
                                         seed=SEED), device="cpu")
        mgr = tlt.init_training("cpu", cfg, fixed_bid(env, torch), policy,
                                torch.zeros((1,), dtype=torch.int32))
        assert mgr.rollout.cfg.policy_chunked
        population = mgr.state.policy_states
        j0 = jax_run["mgr"]
        for p in range(NUM_POLICIES):
            population[p].actor_critic.load_state_dict({
                k: torch.from_numpy(v) for k, v in _policy_params(
                    j0.state.policy_states.params, p).items()})
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            _, deltas = tlt.eval_elo(mgr, EVAL_STEPS,
                                     torch.zeros((1,), dtype=torch.int32),
                                     torch.zeros((1,), dtype=torch.int32))
    finally:
        mp.undo()
    assert not steps and not pending
    return dict(mgr=mgr, deltas=deltas, custom_rows=custom_rows)


def test_eval_elo_with_a_custom_policy_matches_jax(jax_run, torch_run):
    want = np.asarray(jax_run["evaluated"].state.policy_states.mmr.elo)
    got = _np(torch_run["mgr"].state.policy_states.mmr.elo)
    assert got.shape == want.shape == (NUM_POLICIES,)
    assert np.isfinite(got).all() and got[0] == 1500.0 == want[0]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    np.testing.assert_allclose(_np(torch_run["deltas"]),
                               np.asarray(jax_run["deltas"]), rtol=0,
                               atol=1500 * 1e-5)
    assert np.ptp(want) > 0.1, "the tournament moved no rating"
    # Every step of the tournament had rows of the custom policy.
    assert min(torch_run["custom_rows"]) > 0
    assert torch_run["mgr"].rollout.cfg.pbt.custom_policy_ids == (CUSTOM,)


def test_jax_reorder_sends_a_custom_row_to_the_last_policy():
    """The JAX package's ``compute_reorder_chunks`` indexes its ``[P]``
    tables with a custom id, which clamps to P - 1: the custom rows get the
    destination of the last policy's first row, so that slot runs one of
    them or that row, and the two share its outputs. The port's rows leave
    the custom rows out."""
    P, C = NUM_POLICIES, 4
    a = np.array([0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 5, 5, CUSTOM, CUSTOM,
                  0, 5], np.int32)
    B = -(-a.shape[0] // C) + P
    to_policy, to_sim = (np.asarray(x) for x in compute_reorder_chunks(
        jnp.asarray(a), P, C, B))
    first_of_last = int(np.flatnonzero(a == P - 1)[0])
    custom = np.flatnonzero(a == CUSTOM)
    assert (to_sim[custom] == to_sim[first_of_last]).all()
    assert to_policy.reshape(-1)[to_sim[first_of_last]] in {
        first_of_last, *custom.tolist()}

    rows = t_rollouts._PolicyRows(_rollout_cfg(a.shape[0] // 2),
                                  torch.from_numpy(a))
    for p, r in rows.rows:
        assert (a[r.numpy()] == p).all()
    assert sorted(np.concatenate([r.numpy() for _, r in rows.rows])) == \
        sorted(np.flatnonzero(a != CUSTOM))
    assert sorted(rows.custom.tolist()) == custom.tolist()


def _rollout_cfg(num_worlds, custom=CUSTOM):
    return t_rollouts.RolloutConfig.setup_population(
        num_current_policies=NUM_TRAIN, num_past_policies=NUM_PAST,
        num_teams=2, team_size=1, sim_batch_size=2 * num_worlds,
        actions_cfg=_torch_cfg().actions, self_play_portion=0.0,
        cross_play_portion=0.0, past_play_portion=0.0,
        static_play_portion=1.0, custom_policy_ids=[custom])


@pytest.mark.parametrize("custom", [-1, 0, NUM_POLICIES - 1])
def test_custom_ids_inside_the_population_are_refused(custom):
    with pytest.raises(ValueError, match="custom policy ids"):
        _rollout_cfg(8, custom)


def test_policy_rows_of_a_large_custom_id_are_those_of_a_small_one():
    a = _assignments()
    big = 10 ** 6
    small = t_rollouts._PolicyRows(_rollout_cfg(a.shape[0] // 2), a)
    large = t_rollouts._PolicyRows(_rollout_cfg(a.shape[0] // 2, big),
                                   torch.where(a == CUSTOM, big, a))
    assert [p for p, _ in large.rows] == list(range(NUM_POLICIES))
    for (p, x), (q, y) in zip(small.rows, large.rows):
        assert p == q and torch.equal(x, y)
    assert torch.equal(small.custom, large.custom)
    assert torch.equal(small.inverse, large.inverse)


def test_a_step_of_custom_rows_alone_is_refused():
    a = torch.full((8,), CUSTOM, dtype=torch.int32)
    with pytest.raises(ValueError, match="custom policy"):
        t_rollouts._PolicyRows(_rollout_cfg(4), a)


class _Recording(torch.nn.Module):
    """An actor-critic that records the batch of every rollout call."""

    def __init__(self, inner):
        super().__init__()
        self.inner = inner
        self.batches = []

    def rollout(self, generator, rnn_states, obs, sample_actions=True):
        self.batches.append(obs["time"].clone())
        return self.inner.rollout(generator, rnn_states, obs,
                                  sample_actions=sample_actions)

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            return getattr(self.inner, name)


def _one_step(assignments, rnn_seed=0):
    """One population step (argmax actions) over the static
    ``assignments``: (policy outputs, preprocessed obs, recurrent state
    before and after, the modules)."""
    torch.manual_seed(0)
    models = [_Recording(_torch_model("lstm")) for _ in range(NUM_POLICIES)]
    caster = tlt.ObservationsCaster.create(torch.float32)
    population = Population(
        policies=[PolicyState(m, caster, caster.init_state(
            {"time": torch.zeros((1, 1)), "acc": torch.zeros((1, 1))}))
            for m in models],
        reward_hyper_params=None, get_episode_scores_fn=_get_episode_scores,
        episode_score=None,
        mmr=MMR(elo=torch.full((NUM_POLICIES,), 1500.0)))
    B = assignments.shape[0]
    cfg = _rollout_cfg(B // 2)
    gen = torch.Generator().manual_seed(rnn_seed)
    obs = {"time": torch.rand((B, 1), generator=gen),
           "acc": torch.rand((B, 1), generator=gen)}
    rnn = tuple(torch.randn(x.shape, generator=gen).to(x.dtype)
                for x in models[0].init_recurrent_state(B))
    state = t_rollouts.RolloutState(
        cfg=cfg, step_fn=lambda step_input: {
            "state": {}, "obs": obs, "rewards": torch.zeros((B, 1)),
            "dones": torch.zeros((B, 1), dtype=torch.bool)},
        sim_state={}, cur_obs=obs, generator=torch.Generator(),
        rnn_states=rnn, policy_assignments=assignments, sim_ctrl=None,
        env_returns=torch.zeros((B, 1)))
    seen = {}

    def post_inference_cb(step_idx, obs, preprocessed, policy_out, cb):
        seen.update(out=policy_out, pre=preprocessed)
        return cb, None

    t_rollouts.population_rollout_loop(
        state, population, 1, post_inference_cb,
        lambda i, rs, d, r, er, cb: (rs, cb, None), None,
        sample_actions=False)
    return seen["out"], seen["pre"], rnn, state.rnn_states, models


def _assignments():
    """Static duel matches over 24 worlds: every policy against every
    other and against the custom policy, on either team."""
    pairs = [(a, b) for a in range(NUM_POLICIES) for b in (CUSTOM,)]
    pairs += [(CUSTOM, b) for b in range(NUM_POLICIES)]
    pairs += [(a, (a + 1) % NUM_POLICIES) for a in range(NUM_POLICIES)]
    pairs += [(a, (a + 2) % NUM_POLICIES) for a in range(NUM_POLICIES)]
    return torch.tensor(pairs, dtype=torch.int32).reshape(-1)


def test_policy_rows_run_no_module_on_custom_rows():
    a = _assignments()
    custom = a == CUSTOM
    out, pre, rnn_before, rnn_after, models = _one_step(a)
    for p, model in enumerate(models):
        assert len(model.batches) == 1
        torch.testing.assert_close(
            model.batches[0], pre["time"][a == p], rtol=0, atol=0)
    assert int(custom.sum()) == 2 * NUM_POLICIES
    assert set(out) == {"actions", "critic"}
    for name, x in [("actions", out["actions"]["move"]),
                    ("critic", out["critic"]), ("time", pre["time"]),
                    ("acc", pre["acc"])]:
        assert x.shape[0] == a.shape[0], name
        assert (x[custom] == 0).all(), name
        assert (x[~custom] != 0).any(), name
    assert out["actions"]["move"].dtype == torch.int32
    for before, after in zip(rnn_before, rnn_after):
        assert torch.equal(after[custom], before[custom])
        assert not torch.equal(after[~custom], before[~custom])


def test_policy_rows_other_rows_as_without_custom_rows():
    """Assigning the custom rows to policy 0 instead changes no other
    policy's rows; policy 0's own rows equal its module run over them."""
    a = _assignments()
    custom = a == CUSTOM
    b = torch.where(custom, 0, a)
    got = _one_step(a)
    want = _one_step(b)
    others = (a != 0) & ~custom
    for x, y in [(got[0]["actions"]["move"], want[0]["actions"]["move"]),
                 (got[0]["critic"], want[0]["critic"]),
                 (got[1]["time"], want[1]["time"])]:
        assert torch.equal(x[others], y[others])
    for x, y in zip(got[3], want[3]):
        assert torch.equal(x[others], y[others])
    # Policy 0 over its own rows only.
    model, rows = got[4][0], torch.nonzero(a == 0).reshape(-1)
    out, rnn = model.inner.rollout(
        None, tuple(x[rows] for x in got[2]),
        {k: v[rows] for k, v in got[1].items()}, sample_actions=False)
    assert torch.equal(out["actions"]["move"],
                       got[0]["actions"]["move"][rows])
    for x, y in zip(rnn, got[3]):
        assert torch.equal(x, y[rows])
