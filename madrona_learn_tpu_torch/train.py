"""Training orchestration (JAX: madrona_learn_tpu/train.py).

``init_training`` wires the rollout state, the policy and train state,
the metrics and the update step into a ``TrainingManager`` whose
``update_iter`` runs one update: collect rollouts -> fold the obs
statistics into the normalizer -> PPO -> advance the metrics ring buffer.
With ``TrainConfig.pbt`` the population's hyperparameters are drawn at
init, every train policy folds its own obs statistics and runs PPO on its
own rollout data, train state and generator, ``eval_elo`` runs the
all-pairs Elo tournament and ``update_population`` the cull and the past
snapshot. ``TrainingManager.save_ckpt`` / ``load_ckpt`` write and read
checkpoints (``train_state.py``), ``latest_checkpoint`` finds the newest,
and ``init_training(restore_ckpt=...)`` resumes from one. The port runs
eagerly on one device and updates the manager's state in place.

A population learns on one of two paths, chosen once at init by
``rollouts.batched_learn_missing``: JAX's ``vmap`` of the update over the
train policies (``ppo._ppo_population``, one PPO step a minibatch over every
train policy, on ``StackedTrainState``'s stacks), or the per-policy loop,
one ``_ppo`` a train policy in turn, which the init logs naming the module
or option that needs it.

An update opens the JAX package's named ranges ("Update Iter",
"Collect Rollouts", "Update Observations Stats", "Learn"; on the batched
learn "Set New Policy States", which writes the stacks back into the
modules and train states; ``utils/profile.py``). JAX's
``init_training(profile_port=...)`` starts an XProf server; its
counterpart here is ``init_training(profile_dir=...)``, which runs a
``torch.profiler`` trace of the whole run that ``stop_training`` writes
into ``profile_dir``. ``TrainingManager.log_metrics_tensorboard`` writes
the metrics' ring buffer through a ``TensorboardWriter``.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import warnings
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .algo import AlgoBase
from .config import TrainConfig
from .envs.sim_interface import as_sim_fns
from .ops.metrics import TrainingMetrics
from .pbt import (pbt_cull_update, pbt_explore_hyperparams, pbt_past_update,
                  pbt_update_elo)
from .policy import Policy
from .rollouts import (RolloutConfig, RolloutManager, RolloutState,
                       batched_learn_missing, chunked_path_missing,
                       rollout_loop, rollouts_reset)
from .train_state import StackedTrainState, TrainStateManager
from .utils.profile import profile

_LOG = logging.getLogger(__name__)


@dataclass(frozen=True)
class TrainHooks:
    """User extension points. Stateless; custom state lives in the object
    returned by ``init_user_state``."""

    def init_user_state(self):
        return None

    def start_rollouts(self, rollout_state: RolloutState, user_state: Any):
        return rollout_state, user_state

    def finish_rollouts(self, rollouts, bootstrap_values,
                        unnormalized_values, unnormalized_bootstrap_values,
                        user_state):
        return rollouts, user_state

    def add_metrics(self, metrics: Dict):
        return metrics

    def rollout_metrics(self, metrics, rollouts, user_state):
        return metrics

    def optimize_metrics(self, metrics, epoch_idx, minibatch, policy_state,
                         train_state):
        """Called once per minibatch, after its optimizer step (once a
        train policy, with its own views, on a population's batched learn,
        where the policy's module and train state hold what they held at
        the learn's start until the learn writes the stacks back)."""
        return metrics


class TrainingManager:
    def __init__(self, state: TrainStateManager, rollout: RolloutState,
                 metrics: TrainingMetrics, cfg: TrainConfig,
                 algo: AlgoBase, rollout_mgr: RolloutManager,
                 user_hooks: TrainHooks, update_idx: int = 0,
                 profile_dir: Optional[str] = None,
                 batched_learn: bool = False):
        self.state = state
        self.rollout = rollout
        self.metrics = metrics
        self.cfg = cfg
        self.algo = algo
        self.rollout_mgr = rollout_mgr
        self.user_hooks = user_hooks
        self.update_idx = update_idx
        # Ratio diagnostics of the last update's first minibatch, with the
        # update's minibatches an epoch and, with a loss scaler, its count
        # of non-finite steps (ppo._ppo); with PBT a list, one entry a train
        # policy.
        self.first_minibatch_stats: Any = None
        # The (source, destination) copies of the last update_population.
        self.population_copies: List[Tuple[int, int]] = []
        # A population's learn path, chosen at init: every train policy
        # in one batched PPO step a minibatch, or the per-policy loop.
        self.batched_learn = batched_learn
        # The run's torch.profiler trace, written by stop_training.
        self.profile_dir = profile_dir
        self.profiler = None
        if profile_dir is not None:
            self.profiler = _start_profiler(
                rollout.sim_ctrl.device.type == "cuda")

    def save_ckpt(self, path: str, block: bool = True):
        """Write the checkpoint ``path/<update_idx>`` (complete once it
        exists). ``block=False`` writes it on a background thread; call
        ``wait_for_checkpoints()`` before relying on the file."""
        self.state.save(self.update_idx,
                        os.path.join(path, str(self.update_idx)),
                        block=block)

    def load_ckpt(self, path: str) -> "TrainingManager":
        """Load checkpoint ``path`` in place and continue from its update
        index. The rollout state is this manager's own."""
        _, self.update_idx = self.state.load(path)
        return self

    def update_iter(self) -> "TrainingManager":
        self.first_minibatch_stats = _update_impl(
            self.algo, self.cfg, self.user_hooks, self.rollout,
            self.rollout_mgr, self.state, self.metrics, self.batched_learn)
        self.update_idx += 1
        return self

    def log_metrics_tensorboard(self, tb_writer):
        """The metrics' ring buffer through ``tb_writer``, slot ``i`` at
        step ``update_idx - 1 + i`` (``TrainingMetrics.tensorboard_log``)."""
        self.metrics.tensorboard_log(self.update_idx - 1, tb_writer)


def _start_profiler(cuda: bool):
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    profiler.start()
    return profiler


def stop_training(training_mgr: TrainingManager) -> Optional[str]:
    """End a run started with ``init_training(..., profile_dir=...)``:
    stop its profiler and write the trace to ``<profile_dir>/trace.json``
    (Chrome's trace format; ``chrome://tracing`` or Perfetto read it).
    Returns the trace's path, or ``None`` without a profiler."""
    profiler = training_mgr.profiler
    if profiler is None:
        return None
    training_mgr.profiler = None
    profiler.stop()
    os.makedirs(training_mgr.profile_dir, exist_ok=True)
    path = os.path.join(training_mgr.profile_dir, "trace.json")
    profiler.export_chrome_trace(path)
    return path


def _update_impl(algo: AlgoBase, cfg: TrainConfig, user_hooks: TrainHooks,
                 rollout_state: RolloutState, rollout_mgr: RolloutManager,
                 train_state_mgr: TrainStateManager,
                 metrics: TrainingMetrics, batched_learn: bool = False):
    with profile("Update Iter"):
        with profile("Collect Rollouts"):
            rollout_data, obs_stats = rollout_mgr.collect(
                train_state_mgr, rollout_state, metrics,
                user_hooks.start_rollouts, user_hooks.finish_rollouts,
                user_hooks.rollout_metrics)
        if cfg.pbt is not None:
            return _update_population_policies(
                algo, cfg, user_hooks, train_state_mgr, rollout_data,
                obs_stats, metrics, batched_learn)

        # Learning consumes obs preprocessed with the old state, so folding
        # the streamed statistics now only affects the next collect phase.
        policy_state = train_state_mgr.policy_states
        with profile("Update Observations Stats"):
            policy_state.obs_preprocess_state = \
                policy_state.obs_preprocess.update_state(
                    policy_state.obs_preprocess_state, obs_stats)

        with profile("Learn"):
            stats = algo.update(cfg, policy_state,
                                train_state_mgr.train_states,
                                rollout_data.policy(0),
                                user_hooks.optimize_metrics, metrics)
        metrics.advance()
        return stats


def _update_population_policies(algo, cfg, user_hooks, train_state_mgr,
                                rollout_data, obs_stats, metrics,
                                batched_learn):
    """Every train policy folds its obs statistics and runs PPO on its own
    rollout data, train state and generator: all at once on the batched
    learn, else one after another."""
    population = train_state_mgr.policy_states
    train_states = train_state_mgr.train_states
    with profile("Update Observations Stats"):
        for p, stats in enumerate(obs_stats):
            policy = population[p]
            policy.obs_preprocess_state = policy.obs_preprocess.update_state(
                policy.obs_preprocess_state, stats)
    if batched_learn:
        with profile("Learn"):
            stacked = StackedTrainState.stack(
                population.policies[:len(train_states)], train_states)
            out = algo.update_population(cfg, stacked, rollout_data,
                                         user_hooks.optimize_metrics,
                                         metrics)
        with profile("Set New Policy States"):
            stacked.write_back()
    else:
        with profile("Learn"):
            out = [algo.update(cfg, population[p], train_states[p],
                               rollout_data.policy(p),
                               user_hooks.optimize_metrics,
                               metrics.for_policy(p))
                   for p in range(len(train_states))]
    metrics.advance()
    return out


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The newest ``<update_idx>`` checkpoint under ``ckpt_dir``, or
    ``None``: ``init_training(..., restore_ckpt=latest_checkpoint(d))``
    resumes a crashed run."""
    if not os.path.isdir(ckpt_dir):
        return None
    indexed = [d for d in os.listdir(ckpt_dir) if d.isdigit()]
    if not indexed:
        return None
    return os.path.join(ckpt_dir, max(indexed, key=int))


def resolve_device(dev) -> torch.device:
    """The training device: ``None`` means the CUDA card."""
    return torch.device("cuda" if dev is None else dev)


def init_training(dev, cfg: TrainConfig, sim_fns: Dict[str, Callable],
                  policy: Policy, init_sim_ctrl: torch.Tensor,
                  user_hooks: TrainHooks = TrainHooks(),
                  restore_ckpt: Optional[str] = None,
                  profile_dir: Optional[str] = None) -> TrainingManager:
    """Build the TrainingManager on ``dev`` (a torch device; ``None`` is
    the CUDA card, and ``"cpu"`` must be asked for). With
    ``restore_ckpt``, the checkpoint is loaded (after a population's
    hyperparameter draw) and training and its metrics resume at its update
    index. With ``profile_dir`` (the counterpart of the JAX package's
    ``profile_port``), a ``torch.profiler`` trace of the CPU and, on the
    card, CUDA activity runs from here until ``stop_training(mgr)`` writes
    it to ``<profile_dir>/trace.json``.

    ``sim_fns`` (a dict or a ``SimInterface``) must produce tensors on
    ``dev``. The sampling and minibatch
    RNGs are ``torch.Generator``s on ``dev`` seeded from ``cfg.seed``.
    """
    dev = resolve_device(dev)
    if cfg.pbt is not None:
        return _init_population_training(dev, cfg, sim_fns, policy,
                                         init_sim_ctrl, user_hooks,
                                         restore_ckpt, profile_dir)
    algo = cfg.algo.setup()
    rollout_cfg = RolloutConfig.setup(
        num_worlds=cfg.num_worlds,
        agents_per_world=cfg.num_agents_per_world,
        actions_cfg=cfg.actions,
        reward_gamma=cfg.gamma,
    )
    rollout_gen = torch.Generator(device=dev).manual_seed(2 * cfg.seed)
    update_gen = torch.Generator(device=dev).manual_seed(2 * cfg.seed + 1)

    policy.actor_critic.to(dev)
    rollout_state = RolloutState.create(
        rollout_cfg=rollout_cfg,
        sim_fns=as_sim_fns(sim_fns),
        generator=rollout_gen,
        rnn_states=policy.actor_critic.init_recurrent_state(
            rollout_cfg.sim_batch_size, dev),
        init_sim_ctrl=init_sim_ctrl.to(dev),
    )
    train_state_mgr = TrainStateManager.create(
        policy=policy, cfg=cfg, algo=algo,
        init_user_state_cb=user_hooks.init_user_state,
        example_obs=rollout_state.cur_obs, device=dev,
        generator=update_gen)
    start_update_idx = _restore(train_state_mgr, restore_ckpt)

    rollout_mgr = RolloutManager(cfg, rollout_cfg)
    metrics = algo.add_metrics(cfg, {})
    metrics = rollout_mgr.add_metrics(metrics)
    metrics = user_hooks.add_metrics(metrics)
    metrics = TrainingMetrics(metrics, cfg.metrics_buffer_size,
                              start_update_idx, 1, dev)

    return TrainingManager(
        state=train_state_mgr, rollout=rollout_state, metrics=metrics,
        cfg=cfg, algo=algo, rollout_mgr=rollout_mgr, user_hooks=user_hooks,
        update_idx=start_update_idx, profile_dir=profile_dir)


def _restore(train_state_mgr: TrainStateManager,
             restore_ckpt: Optional[str]) -> int:
    """Load ``restore_ckpt``, if given; the update index to start at."""
    if restore_ckpt is None:
        return 0
    return train_state_mgr.load(restore_ckpt)[1]


def _init_population_training(dev, cfg: TrainConfig, sim_fns, policy,
                              init_sim_ctrl, user_hooks, restore_ckpt,
                              profile_dir):
    """``init_training`` of a PBT population: the matchmade rollout, the
    population and its train states, and each train policy's drawn
    hyperparameters (resample chance 1, from the PBT generator).

    The population's paths are chosen here, once. The collect's by
    ``rollouts.chunked_path_missing`` on policy 0's actor-critic and obs
    preprocessor: the policy-chunk layout when every module has a
    policy-batched form, else the per-policy loop. A population on the
    per-policy loop refuses ``rollout_policy_chunk_size_override``, naming
    the module without a form. The learn's by
    ``rollouts.batched_learn_missing`` on the configuration and policy 0's
    actor-critic: every train policy in one batched PPO step a minibatch,
    else the per-policy loop, logged with the module or option that
    needs it."""
    pbt = cfg.pbt
    if pbt.num_teams * pbt.team_size != cfg.num_agents_per_world:
        raise ValueError("num_teams * team_size must equal "
                         "num_agents_per_world")
    algo = cfg.algo.setup()
    rollout_cfg = RolloutConfig.setup_population(
        num_current_policies=pbt.num_train_policies,
        num_past_policies=pbt.num_past_policies,
        num_teams=pbt.num_teams,
        team_size=pbt.team_size,
        sim_batch_size=cfg.sim_batch_size,
        actions_cfg=cfg.actions,
        self_play_portion=pbt.self_play_portion,
        cross_play_portion=pbt.cross_play_portion,
        past_play_portion=pbt.past_play_portion,
        static_play_portion=0.0,
        reward_gamma=cfg.gamma,
        custom_policy_ids=cfg.custom_policy_ids,
        policy_chunk_size_override=pbt.rollout_policy_chunk_size_override)
    rollout_state = RolloutState.create(
        rollout_cfg=rollout_cfg,
        sim_fns=as_sim_fns(sim_fns),
        generator=torch.Generator(device=dev).manual_seed(2 * cfg.seed),
        rnn_states=None,
        init_sim_ctrl=init_sim_ctrl.to(dev))
    train_state_mgr = TrainStateManager.create_population(
        policy=policy, cfg=cfg, algo=algo,
        init_user_state_cb=user_hooks.init_user_state,
        example_obs=rollout_state.cur_obs, device=dev,
        use_competitive_mmr=rollout_cfg.pbt.complex_matchmaking)
    population = train_state_mgr.policy_states
    missing = chunked_path_missing(population[0].actor_critic,
                                   population[0].obs_preprocess)
    if missing is not None and pbt.rollout_policy_chunk_size_override:
        raise ValueError(
            f"rollout_policy_chunk_size_override: {missing} has no "
            f"policy-batched form, so the population runs the per-policy "
            f"loop, which reads no chunk size; leave it 0")
    rollout_cfg = dataclasses.replace(rollout_cfg,
                                      policy_chunked=missing is None)
    rollout_state.cfg = rollout_cfg
    rollout_state.rnn_states = population[0].actor_critic \
        .init_recurrent_state(rollout_cfg.sim_batch_size, dev)
    learn_missing = batched_learn_missing(cfg, population[0].actor_critic)
    if learn_missing is not None:
        _LOG.info("the population learns on the per-policy loop, which %s "
                  "needs", learn_missing)
    for p, train_state in enumerate(train_state_mgr.train_states):
        pbt_explore_hyperparams(cfg, train_state_mgr.pbt_generator,
                                population, p, train_state, 1.0)
    start_update_idx = _restore(train_state_mgr, restore_ckpt)

    rollout_mgr = RolloutManager(cfg, rollout_cfg)
    metrics = algo.add_metrics(cfg, {})
    metrics = rollout_mgr.add_metrics(metrics)
    metrics = user_hooks.add_metrics(metrics)
    metrics = TrainingMetrics(metrics, cfg.metrics_buffer_size,
                              start_update_idx, pbt.num_train_policies, dev)
    return TrainingManager(
        state=train_state_mgr, rollout=rollout_state, metrics=metrics,
        cfg=cfg, algo=algo, rollout_mgr=rollout_mgr, user_hooks=user_hooks,
        update_idx=start_update_idx, profile_dir=profile_dir,
        batched_learn=learn_missing is None)


# -- The PBT outer loop: the Elo tournament and the population update ------

@dataclass
class MatchmakeEvalState:
    policy_elos: torch.Tensor


def _build_all_pairs_assignments(num_eval_policies: int, custom_policy_ids,
                                 sim_batch_size: int, num_teams: int,
                                 team_size: int, pair_offset: int = 0,
                                 device=None) -> torch.Tensor:
    """Every (team 0, team 1) pairing of the population and the custom
    policies, cycled from ``pair_offset`` to fill the sim batch's match
    slots; int32 ``[sim_batch_size]``. When the batch holds fewer slots
    than pairings it warns: advance ``pair_offset`` each tournament to
    rotate which pairings are dropped."""
    pairs = []
    for a in range(num_eval_policies):
        for b in range(num_eval_policies):
            pairs.extend([a, b])
        for custom_id in custom_policy_ids:
            pairs.extend([a, custom_id])
    for custom_id in custom_policy_ids:
        for b in range(num_eval_policies):
            pairs.extend([custom_id, b])
        for other in custom_policy_ids:
            pairs.extend([custom_id, other])

    num_match_slots = sim_batch_size // (team_size * num_teams)
    pairs_arr = np.asarray(pairs, np.int32).reshape(-1, num_teams)
    if num_match_slots < pairs_arr.shape[0]:
        warnings.warn(
            f"all-pairs eval underfilled: sim batch provides "
            f"{num_match_slots} match slots but the tournament has "
            f"{pairs_arr.shape[0]} pairings — each cycle drops "
            f"{pairs_arr.shape[0] - num_match_slots} pairings (a "
            f"pair_offset-dependent contiguous run of the pair list; "
            f"advance eval_elo's pair_offset per cycle to rotate which). "
            f"Elo updates are partial. Increase num_worlds or reduce the "
            f"population for full coverage.", stacklevel=2)
    slot_idx = (np.arange(num_match_slots) + int(pair_offset)) \
        % pairs_arr.shape[0]
    assignments = np.repeat(pairs_arr[slot_idx].reshape(-1), team_size)
    if assignments.shape[0] != sim_batch_size:
        raise ValueError(f"{assignments.shape[0]} assignments for a batch "
                         f"of {sim_batch_size}")
    return torch.from_numpy(assignments).to(device)


def eval_elo(training_mgr: TrainingManager, num_eval_steps: int,
             eval_sim_ctrl: torch.Tensor, train_sim_ctrl: torch.Tensor,
             pair_offset: int = 0):
    """The all-pairs tournament over ``num_eval_steps`` steps of static
    matchmaking, from Elo 1500 for every policy; the ratings are then
    re-baselined so that ``cfg.baseline_policy_id`` reads 1500, and become
    the population's. The rollout is reset before and after, and training's
    play portions and assignments are restored. Returns
    ``(training_mgr, elo_deltas)``."""
    cfg = training_mgr.cfg
    population = training_mgr.state.policy_states
    rollout_state = training_mgr.rollout
    device = rollout_state.sim_ctrl.device
    num_eval_policies = population.mmr.elo.shape[0]
    pbt = rollout_state.cfg.pbt

    rollouts_reset(rollout_state, population)
    saved_portions = (pbt.self_play_portion, pbt.cross_play_portion,
                      pbt.past_play_portion, pbt.static_play_portion)
    saved_assignments = rollout_state.policy_assignments
    rollout_state.update_matchmaking(
        0.0, 0.0, 0.0, 1.0, _build_all_pairs_assignments(
            num_eval_policies, cfg.custom_policy_ids,
            cfg.sim_batch_size, pbt.num_teams, pbt.team_size,
            pair_offset=pair_offset, device=device))

    def post_inference_cb(step_idx, obs, preprocessed_obs, policy_out,
                          eval_state):
        return eval_state, None

    def post_step_cb(step_idx, rollout_state, dones, rewards,
                     episode_results, eval_state):
        eval_state.policy_elos = pbt_update_elo(
            population.get_episode_scores_fn,
            rollout_state.policy_assignments, dones, episode_results,
            eval_state.policy_elos, rollout_state.cfg.pbt)
        return rollout_state, eval_state, None

    eval_state = MatchmakeEvalState(policy_elos=torch.full(
        (num_eval_policies + len(cfg.custom_policy_ids),), 1500.0,
        dtype=torch.float32, device=device))
    rollout_state.sim_ctrl = eval_sim_ctrl
    rollouts_reset(rollout_state, population)
    rollout_loop(rollout_state, population, num_eval_steps,
                 post_inference_cb, post_step_cb, eval_state)
    rollout_state.sim_ctrl = train_sim_ctrl
    rollouts_reset(rollout_state, population)
    rollout_state.update_matchmaking(*saved_portions, saved_assignments)

    if 0 <= cfg.baseline_policy_id < num_eval_policies:
        baseline_idx = cfg.baseline_policy_id
    else:
        baseline_idx = num_eval_policies + list(
            cfg.custom_policy_ids).index(cfg.baseline_policy_id)
    new_elos = eval_state.policy_elos
    new_elos = (new_elos - new_elos[baseline_idx] + 1500)[:num_eval_policies]
    elo_deltas = new_elos - population.mmr.elo
    population.mmr.elo = new_elos
    return training_mgr, elo_deltas


def update_population(training_mgr: TrainingManager) -> TrainingManager:
    """The cull (the lowest-fitness train policy overwritten by a mutated
    copy of the highest) and the past snapshot; the copies made are in
    ``training_mgr.population_copies``."""
    state, cfg = training_mgr.state, training_mgr.cfg
    training_mgr.population_copies = (pbt_cull_update(cfg, state, 1)
                                      + pbt_past_update(cfg, state))
    return training_mgr
