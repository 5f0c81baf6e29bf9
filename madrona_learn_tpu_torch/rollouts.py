"""The rollout engine, single-policy path (JAX: madrona_learn_tpu/rollouts.py).

Collection is a Python loop (outer over BPTT chunks, inner over steps) whose
stacked per-step outputs form the trajectory store in the JAX package's
``[C, T/C, P, B, ...]`` layout, with P = 1 kept as an axis. After the
bootstrap value and GAE, the store is reshaped into per-policy training
sequences ``[P, B*C, T/C, ...]`` with b-major rows (row = b*C + c), as the
JAX package does.

With one train policy and no matchmaking, sim order, policy order and train
order coincide, so the reorder machinery of the PBT path is not needed
here; it is ported with PBT.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict

import torch

from .config import DiscreteActionsConfig, TrainConfig
from .ops.gae import compute_advantages, compute_returns
from .ops.metrics import Metric, TrainingMetrics
from .utils import tree_map, tree_stack

# Rewards, returns, log-probs and advantages are stored in float32.
_F32 = torch.float32


@dataclass(frozen=True)
class RolloutConfig:
    sim_batch_size: int
    num_worlds: int
    actions_cfg: Dict[str, DiscreteActionsConfig]
    reward_gamma: float

    @staticmethod
    def setup(num_worlds: int, agents_per_world: int,
              actions_cfg: Dict[str, DiscreteActionsConfig],
              reward_gamma: float = 1.0) -> "RolloutConfig":
        """The trivial geometry: one train policy plays every agent."""
        return RolloutConfig(
            sim_batch_size=num_worlds * agents_per_world,
            num_worlds=num_worlds,
            actions_cfg=actions_cfg,
            reward_gamma=reward_gamma,
        )


@dataclass
class RolloutState:
    """Simulator state, current obs, recurrent state and sampling RNG, in
    sim order. The rollout loop updates it in place."""

    cfg: RolloutConfig
    step_fn: Callable
    sim_state: Any
    cur_obs: Dict[str, torch.Tensor]
    generator: torch.Generator
    rnn_states: Any
    policy_assignments: torch.Tensor
    sim_ctrl: torch.Tensor
    env_returns: torch.Tensor

    @staticmethod
    def create(rollout_cfg: RolloutConfig, sim_fns, generator, rnn_states,
               init_sim_ctrl) -> "RolloutState":
        init_out = sim_fns["init"]()
        device = init_sim_ctrl.device
        B = rollout_cfg.sim_batch_size
        return RolloutState(
            cfg=rollout_cfg,
            step_fn=sim_fns["step"],
            sim_state=init_out["state"],
            cur_obs=init_out["obs"],
            generator=generator,
            rnn_states=rnn_states,
            policy_assignments=torch.zeros((B, 1), dtype=torch.int32,
                                           device=device),
            sim_ctrl=init_sim_ctrl,
            env_returns=torch.zeros((B, 1), dtype=_F32, device=device),
        )


class RolloutData:
    """Training sequences: leaves [P, num_seqs, T/C, ...], except
    ``rnn_start_states`` [P, num_seqs, ...]."""

    def __init__(self, data: Dict[str, Any]):
        self.data = data

    def all(self):
        return self.data

    def policy(self, p: int) -> "RolloutData":
        return RolloutData(tree_map(lambda x: x[p], self.data))

    def minibatch(self, indices):
        """Rows ``indices`` of a per-policy view, time-major ([T/C, mb])
        except the recurrent start states."""
        mb = {k: v for k, v in self.data.items() if k != "rnn_start_states"}
        mb = tree_map(lambda x: x[indices].transpose(0, 1).contiguous(), mb)
        mb["rnn_start_states"] = tree_map(
            lambda x: x[indices], self.data["rnn_start_states"])
        return mb


def rollout_loop(rollout_state: RolloutState, policy_state, num_steps: int,
                 post_inference_cb: Callable, post_step_cb: Callable,
                 cb_state: Any, start_step_idx: int = 0):
    """Run ``num_steps`` sim steps.

    - ``post_inference_cb(step_idx, obs, preprocessed_obs, policy_out,
      cb_state) -> (cb_state, emit)``
    - ``post_step_cb(step_idx, rollout_state, dones, rewards, cb_state)
      -> (rollout_state, cb_state, emit)``

    Returns ``(rollout_state, cb_state, (inference_emits, step_emits))``
    with the emits stacked along a leading time axis.
    """
    cfg = rollout_state.cfg
    actor_critic = policy_state.actor_critic
    inference_emits, step_emits = [], []
    with torch.no_grad():
        for step_idx in range(start_step_idx, start_step_idx + num_steps):
            obs = rollout_state.cur_obs
            preprocessed = policy_state.obs_preprocess.preprocess(
                policy_state.obs_preprocess_state, obs)
            policy_out, rnn_states = actor_critic.rollout(
                rollout_state.generator, rollout_state.rnn_states,
                preprocessed)
            cb_state, emit = post_inference_cb(
                step_idx, obs, preprocessed, policy_out, cb_state)
            inference_emits.append(emit)

            step_output = rollout_state.step_fn({
                "state": rollout_state.sim_state,
                "actions": policy_out["actions"],
                "resets": torch.zeros((cfg.num_worlds, 1), dtype=torch.int32,
                                      device=rollout_state.sim_ctrl.device),
                "sim_ctrl": rollout_state.sim_ctrl,
                "pbt": {"policy_assignments":
                        rollout_state.policy_assignments},
            })
            dones = step_output["dones"].to(torch.bool)
            rewards = step_output["rewards"].to(_F32)
            env_returns = (rewards
                           + cfg.reward_gamma * rollout_state.env_returns)

            rollout_state.rnn_states = actor_critic.clear_recurrent_state(
                rnn_states, dones)
            rollout_state.sim_state = step_output["state"]
            rollout_state.cur_obs = step_output["obs"]
            rollout_state.env_returns = env_returns

            rollout_state, cb_state, emit = post_step_cb(
                step_idx, rollout_state, dones, rewards, cb_state)
            step_emits.append(emit)
            rollout_state.env_returns = torch.where(
                dones, 0, rollout_state.env_returns)

    return rollout_state, cb_state, (tree_stack(inference_emits),
                                     tree_stack(step_emits))


def rollouts_reset(rollout_state: RolloutState, policy_state):
    """Step the sim once with resets raised; clear returns and RNN state."""
    cfg = rollout_state.cfg
    device = rollout_state.sim_ctrl.device
    step_output = rollout_state.step_fn({
        "state": rollout_state.sim_state,
        "actions": {k: torch.zeros(
            (cfg.sim_batch_size, len(v.actions_num_buckets)),
            dtype=torch.int32, device=device)
            for k, v in cfg.actions_cfg.items()},
        "resets": torch.ones((cfg.num_worlds, 1), dtype=torch.int32,
                             device=device),
        "sim_ctrl": rollout_state.sim_ctrl,
        "pbt": {"policy_assignments": torch.zeros(
            (cfg.sim_batch_size, 1), dtype=torch.int32, device=device)},
    })
    dones = step_output["dones"].to(torch.bool)
    rollout_state.rnn_states = \
        policy_state.actor_critic.clear_recurrent_state(
            rollout_state.rnn_states, torch.ones_like(dones))
    rollout_state.sim_state = step_output["state"]
    rollout_state.cur_obs = step_output["obs"]
    rollout_state.env_returns = torch.zeros_like(rollout_state.env_returns)
    return rollout_state


def _with_policy_axis(tree, dim=0):
    return tree_map(lambda x: x.unsqueeze(dim), tree)


class RolloutManager:
    def __init__(self, train_cfg: TrainConfig, rollout_cfg: RolloutConfig):
        self._cfg = rollout_cfg
        self._num_bptt_chunks = train_cfg.num_bptt_chunks
        self._num_bptt_steps = (train_cfg.steps_per_update
                                // train_cfg.num_bptt_chunks)
        self._gamma = train_cfg.gamma
        self._gae_lambda = train_cfg.gae_lambda
        self._use_advantages = train_cfg.compute_advantages
        self._critic_outputs_distribution = (
            train_cfg.dreamer_v3_critic or train_cfg.hlgauss_critic)

    def add_metrics(self, metrics: Dict[str, Metric]):
        names = ["Rewards", "Est Returns", "Env Returns", "Values",
                 "Bootstrap Values"]
        if self._use_advantages:
            names.append("Advantages")
        return dict(metrics, **{name: Metric.init(True) for name in names})

    def _compute_value_estimate(self, critic_out):
        if self._critic_outputs_distribution:
            if isinstance(critic_out, torch.Tensor):
                # .mean() on a plain tensor would silently collapse the
                # batch axis.
                raise TypeError(
                    "TrainConfig.dreamer_v3_critic/hlgauss_critic is "
                    "enabled, but the model's critic returned a plain "
                    "tensor (a scalar critic such as DenseLayerCritic). "
                    "Either set dreamer_v3_critic=False in TrainConfig or "
                    "use a distributional critic (DreamerV3Critic, "
                    "HLGaussCritic).")
            return critic_out.mean()
        return critic_out

    def collect(self, train_state_mgr, rollout_state: RolloutState,
                metrics: TrainingMetrics, user_start_rollouts_hook,
                user_finish_rollouts_hook, user_metrics_hook):
        """One collect phase: (rollout_data, obs_stats). Updates
        ``rollout_state``, ``metrics`` and ``train_state_mgr.user_state``
        in place."""
        rollout_data, obs_stats, user_state = self._collect_impl(
            train_state_mgr.policy_states, train_state_mgr.train_states,
            train_state_mgr.user_state, rollout_state, metrics,
            user_start_rollouts_hook, user_finish_rollouts_hook,
            user_metrics_hook)
        train_state_mgr.user_state = user_state
        return rollout_data, obs_stats

    def _collect_impl(self, policy_state, train_state, user_state,
                      rollout_state, metrics, user_start_rollouts_hook,
                      user_finish_rollouts_hook, user_metrics_hook):
        rollout_state, user_state = user_start_rollouts_hook(
            rollout_state, user_state)
        obs_preprocess = policy_state.obs_preprocess
        obs_state = policy_state.obs_preprocess_state

        def post_inference_cb(step_idx, obs, preprocessed_obs, policy_out,
                              cb_state):
            emit = {
                "obs": preprocessed_obs,
                "actions": policy_out["actions"],
                "log_probs": {k: v.to(_F32)
                              for k, v in policy_out["log_probs"].items()},
                "values": self._compute_value_estimate(
                    policy_out["critic"]),
            }
            cb_state["obs_stats"] = obs_preprocess.update_obs_stats(
                obs_state, cb_state["obs_stats"], step_idx, obs)
            return cb_state, emit

        def post_step_cb(step_idx, rollout_state, dones, rewards, cb_state):
            new_metric = Metric.init_from_data_masked(
                True, rollout_state.env_returns[None], dones[None],
                start_dim=1)
            cb_state["env_returns_metric"] = \
                cb_state["env_returns_metric"].merge(new_metric)
            return rollout_state, cb_state, {"dones": dones,
                                             "rewards": rewards}

        cb_state = {
            "obs_stats": obs_preprocess.init_obs_stats(obs_state),
            "env_returns_metric": Metric.init(
                True, (1,), device=rollout_state.env_returns.device),
        }
        chunks, rnn_start_states = [], []
        for chunk in range(self._num_bptt_chunks):
            rnn_start_states.append(_with_policy_axis(
                rollout_state.rnn_states))
            rollout_state, cb_state, (per_step, step_data) = rollout_loop(
                rollout_state, policy_state, self._num_bptt_steps,
                post_inference_cb, post_step_cb, cb_state,
                start_step_idx=chunk * self._num_bptt_steps)
            chunks.append(_with_policy_axis(dict(per_step, **step_data),
                                            dim=1))
        # store leaves: [C, T/C, P, B, ...]; rnn_start_states: [C, P, B, ...]
        store = tree_stack(chunks)
        rnn_start_states = tree_stack(rnn_start_states)

        metrics.update_metrics({
            "Env Returns": cb_state["env_returns_metric"]})
        bootstrap_values = self._bootstrap_values(policy_state,
                                                  rollout_state)
        rollout_data, user_state = self._finalize_rollouts(
            train_state.value_normalizer, train_state.value_normalizer_state,
            store, rnn_start_states, bootstrap_values, metrics, user_state,
            user_finish_rollouts_hook, user_metrics_hook)
        return rollout_data, cb_state["obs_stats"], user_state

    def _bootstrap_values(self, policy_state, rollout_state):
        """Critic value of the state after the last step: [P, B, 1]."""
        with torch.no_grad():
            preprocessed = policy_state.obs_preprocess.preprocess(
                policy_state.obs_preprocess_state, rollout_state.cur_obs)
            out, _ = policy_state.actor_critic.critic_only(
                rollout_state.rnn_states, preprocessed)
        return self._compute_value_estimate(out["critic"]).unsqueeze(0)

    def _finalize_rollouts(self, value_normalizer, value_normalizer_state,
                           rollouts, rnn_start_states, bootstrap_values,
                           metrics, user_state, user_finish_rollouts_hook,
                           user_metrics_hook):
        # The store keeps the critic's own (normalized) outputs, which the
        # clipped value loss compares against; GAE takes them inverted.
        if value_normalizer is None:
            values = rollouts["values"]
            unnormalized_bootstrap = bootstrap_values
        else:
            values = value_normalizer.invert(value_normalizer_state,
                                             rollouts["values"])
            unnormalized_bootstrap = value_normalizer.invert(
                value_normalizer_state, bootstrap_values)
        rollouts, user_state = user_finish_rollouts_hook(
            rollouts, bootstrap_values, values, unnormalized_bootstrap,
            user_state)

        if self._use_advantages:
            advantages = compute_advantages(
                self._gamma, self._gae_lambda, rollouts["rewards"], values,
                rollouts["dones"], unnormalized_bootstrap)
            rollouts = dict(rollouts,
                            advantages=advantages,
                            returns=advantages + values)
        else:
            rollouts = dict(rollouts, returns=compute_returns(
                self._gamma, rollouts["rewards"], rollouts["dones"],
                unnormalized_bootstrap))

        # [C, T/C, P, B, ...] -> [P, B*C, T/C, ...], rows b-major.
        def reorder_seq_data(x):
            t = x.permute(2, 3, 0, 1, *range(4, x.dim()))
            return t.reshape(t.shape[0], -1, *t.shape[3:])

        # [C, P, B, ...] -> [P, B*C, ...], matching the rows above.
        def reorder_rnn_data(x):
            t = x.permute(1, 2, 0, *range(3, x.dim()))
            return t.reshape(t.shape[0], -1, *t.shape[3:])

        rollouts = tree_map(reorder_seq_data, rollouts)
        rnn_start_states = tree_map(reorder_rnn_data, rnn_start_states)

        metrics.record({
            "Rewards": rollouts["rewards"],
            "Values": reorder_seq_data(values),
            "Est Returns": rollouts["returns"],
            "Bootstrap Values": unnormalized_bootstrap,
        })
        if self._use_advantages:
            metrics.record({"Advantages": rollouts["advantages"]})
        user_metrics_hook(metrics, rollouts, user_state)
        return RolloutData(dict(rollouts,
                                rnn_start_states=rnn_start_states)), \
            user_state
