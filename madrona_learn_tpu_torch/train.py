"""Training orchestration (JAX: madrona_learn_tpu/train.py).

``init_training`` wires the rollout state, the policy and train state,
the metrics and the update step into a ``TrainingManager`` whose
``update_iter`` runs one update: collect rollouts -> fold the obs
statistics into the normalizer -> PPO -> advance the metrics ring buffer.
The port runs eagerly on one device and updates the manager's state in
place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from .algo import AlgoBase
from .config import TrainConfig
from .envs.sim_interface import as_sim_fns
from .ops.metrics import TrainingMetrics
from .policy import Policy
from .rollouts import RolloutConfig, RolloutManager, RolloutState
from .train_state import TrainStateManager


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
        """Called once per minibatch, after its optimizer step."""
        return metrics


class TrainingManager:
    def __init__(self, state: TrainStateManager, rollout: RolloutState,
                 metrics: TrainingMetrics, cfg: TrainConfig,
                 algo: AlgoBase, rollout_mgr: RolloutManager,
                 user_hooks: TrainHooks, update_idx: int = 0):
        self.state = state
        self.rollout = rollout
        self.metrics = metrics
        self.cfg = cfg
        self.algo = algo
        self.rollout_mgr = rollout_mgr
        self.user_hooks = user_hooks
        self.update_idx = update_idx
        # Ratio diagnostics of the last update's first minibatch.
        self.first_minibatch_stats: Optional[Dict[str, torch.Tensor]] = None

    def update_iter(self) -> "TrainingManager":
        self.first_minibatch_stats = _update_impl(
            self.algo, self.cfg, self.user_hooks, self.rollout,
            self.rollout_mgr, self.state, self.metrics)
        self.update_idx += 1
        return self


def _update_impl(algo: AlgoBase, cfg: TrainConfig, user_hooks: TrainHooks,
                 rollout_state: RolloutState, rollout_mgr: RolloutManager,
                 train_state_mgr: TrainStateManager,
                 metrics: TrainingMetrics):
    rollout_data, obs_stats = rollout_mgr.collect(
        train_state_mgr, rollout_state, metrics, user_hooks.start_rollouts,
        user_hooks.finish_rollouts, user_hooks.rollout_metrics)

    # Learning consumes obs preprocessed with the old state, so folding the
    # streamed statistics now only affects the next collect phase.
    policy_state = train_state_mgr.policy_states
    policy_state.obs_preprocess_state = \
        policy_state.obs_preprocess.update_state(
            policy_state.obs_preprocess_state, obs_stats)

    stats = algo.update(cfg, policy_state, train_state_mgr.train_states,
                        rollout_data.policy(0), user_hooks.optimize_metrics,
                        metrics)
    metrics.advance()
    return stats


def init_training(dev, cfg: TrainConfig, sim_fns: Dict[str, Callable],
                  policy: Policy, init_sim_ctrl: torch.Tensor,
                  user_hooks: TrainHooks = TrainHooks()) -> TrainingManager:
    """Build the TrainingManager on ``dev`` (a torch device).

    ``sim_fns`` (a dict or a ``SimInterface``) must produce tensors on
    ``dev``. The sampling and minibatch
    RNGs are ``torch.Generator``s on ``dev`` seeded from ``cfg.seed``.
    """
    dev = torch.device(dev)
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

    rollout_mgr = RolloutManager(cfg, rollout_cfg)
    metrics = algo.add_metrics(cfg, {})
    metrics = rollout_mgr.add_metrics(metrics)
    metrics = user_hooks.add_metrics(metrics)
    metrics = TrainingMetrics(metrics, cfg.metrics_buffer_size, 0, 1, dev)

    return TrainingManager(
        state=train_state_mgr, rollout=rollout_state, metrics=metrics,
        cfg=cfg, algo=algo, rollout_mgr=rollout_mgr, user_hooks=user_hooks)
