"""The rollout engine (JAX: madrona_learn_tpu/rollouts.py).

Collection is a Python loop (outer over BPTT chunks, inner over steps) whose
stacked per-step outputs form the trajectory store in the JAX package's
``[C, T/C, P, B, ...]`` layout, with P = 1 kept as an axis. After the
bootstrap value and GAE, the store is reshaped into per-policy training
sequences ``[P, B*C, T/C, ...]`` with b-major rows (row = b*C + c), as the
JAX package does.

With one train policy and no matchmaking (``RolloutConfig.setup``), sim
order, policy order and train order coincide. A PBT population
(``RolloutConfig.setup_population``) plays matchmade matches, by one of two
paths, chosen once by ``chunked_form_missing`` (``init_training``,
``eval_policies``):

- the policy-chunk layout (``chunked_rollout_loop``; JAX's design): when
  every module of the policy has a policy-batched form
  (``models/common.py``), each step gathers the sim rows into ``[B, C]``
  chunks of one policy each (``ops/reorder.py``; C is
  ``RolloutConfig.policy_chunk_size``, JAX's, or
  ``rollout_policy_chunk_size_override``), runs one batched pass of the
  policy over every chunk, chunk b with its policy's weights of the
  population's stacked view (``Population.stacked``, built once per
  collect), and gathers the outputs back to sim order. The layout of the
  next step is computed on the device at the end of each step, after
  matchmaking, and kept in ``RolloutState.reorder_state``: no step copies
  anything to the host. ``chunkwise_rnn`` (``MADRONA_LEARN_TPU_CHUNKWISE_
  RNN=1`` in collect, as in JAX) keeps the recurrent state in chunk order
  across steps: resets go through ``to_policy(dones)`` and the old and new
  layouts are joined by one composed gather (``_chunk_remap``);
- otherwise the per-policy loop (``population_rollout_loop``): each step a
  stable sort of the assignments groups every policy's rows, in sim
  order, and every policy with agents in the step runs its own module once
  over its rows; which policies are present and how many rows each has
  comes to the host as one ``[P]`` copy a step.

Rows of custom policy ids (past the population, played by the simulator)
run no module on either path: their outputs and preprocessed obs are zeros
and their recurrent state is kept. Outputs return to sim order, where the
recurrent state stays; the store keeps the train policies' team-0 agents
in train order ``[P_train, A]``, and the bootstrap value is one batched
``critic_only`` over them on the chunked path (JAX ``vmap``s it).

The loops and the collect phase open the JAX package's named ranges
(``utils/profile.py``), "Gather Chunk Weights" where a stacked view is
indexed by chunk. ``RolloutState.get_current_checkpoints`` /
``load_checkpoints_into_sim`` pass simulator-state snapshots through.
"""

from __future__ import annotations

import dataclasses
import inspect
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from .config import ActionsConfig, DiscreteActionsConfig, TrainConfig
from .ops.gae import compute_advantages, compute_returns
from .ops.metrics import Metric, TrainingMetrics
from .ops.reorder import (PolicyBatchReorderState, compute_reorder_chunks,
                          heuristic_policy_chunk_size)
from .pbt import (PBTMatchmakeConfig, pbt_init_matchmaking,
                  pbt_update_matchmaking)
from .utils import profile, tree_map, tree_stack

# Rewards, returns, log-probs and advantages are stored in float32.
_F32 = torch.float32


@dataclass(frozen=True)
class RolloutConfig:
    sim_batch_size: int
    num_worlds: int
    actions_cfg: Dict[str, ActionsConfig]
    reward_gamma: float
    # The population's geometry (setup_population); None with one policy.
    pbt: Optional[PBTMatchmakeConfig] = None
    reward_dtype: torch.dtype = torch.float32
    # The policy-chunk layout's sizes, as the JAX package derives them
    # (one data shard), and whether the population runs in it
    # (chunked_rollout_loop) or in the per-policy loop.
    policy_chunk_size: int = 0
    num_policy_chunks: int = 0
    total_policy_batch_size: int = 0
    policy_chunked: bool = False

    @staticmethod
    def setup(num_worlds: int, agents_per_world: int,
              actions_cfg: Dict[str, ActionsConfig],
              reward_gamma: float = 1.0) -> "RolloutConfig":
        """The trivial geometry: one train policy plays every agent."""
        return RolloutConfig(
            sim_batch_size=num_worlds * agents_per_world,
            num_worlds=num_worlds,
            actions_cfg=actions_cfg,
            reward_gamma=reward_gamma,
        )

    @staticmethod
    def setup_population(num_current_policies: int, num_past_policies: int,
                         num_teams: int, team_size: int, sim_batch_size: int,
                         actions_cfg: Dict[str, ActionsConfig],
                         self_play_portion: float, cross_play_portion: float,
                         past_play_portion: float,
                         static_play_portion: float,
                         reward_gamma: float = 1.0, custom_policy_ids=(),
                         reward_dtype: torch.dtype = torch.float32,
                         policy_chunk_size_override: int = 0,
                         policy_chunked: bool = False) -> "RolloutConfig":
        """A population's geometry: the matchmaking slices, each giving
        every one of its policies agents, and the policy-chunk layout's
        sizes (JAX: ``RolloutConfig.setup``, one data shard): with
        matchmaking, a power-of-two chunk from the smallest per-policy
        share of any active play slice (``heuristic_policy_chunk_size``)
        and ``ceil(N / C) + P - 1`` chunks, one partial chunk reserved a
        policy; in pure self-play, JAX's reshape to ``[P, N / P]``.
        ``policy_chunk_size_override`` > 0 forces C. ``policy_chunked``:
        the population runs in the layout (``chunked_rollout_loop``)."""
        pbt = PBTMatchmakeConfig.setup(
            num_current_policies, num_past_policies, num_teams, team_size,
            sim_batch_size, self_play_portion, cross_play_portion,
            past_play_portion, static_play_portion, custom_policy_ids)
        if pbt.complex_matchmaking:
            if num_teams < 2 or (num_current_policies < 2
                                 and num_past_policies == 0):
                raise ValueError(
                    "matchmaking needs 2 teams and an opponent: more than "
                    "one train policy or a past policy")
            # The smallest per-policy share of any active play slice.
            min_share = sim_batch_size // pbt.total_num_policies
            for size, policies in (
                    (pbt.self_play_batch_size, num_current_policies),
                    (pbt.cross_play_batch_size, num_current_policies),
                    (pbt.past_play_batch_size, num_past_policies),
                    (pbt.static_play_batch_size, pbt.total_num_policies)):
                if size > 0:
                    min_share = min(min_share, size // policies)
            if min_share <= 0:
                raise ValueError("a play slice gives a policy no agents")
            chunk = heuristic_policy_chunk_size(
                sim_batch_size, pbt.total_num_policies, min_share)
        elif num_past_policies:
            raise ValueError("past policies need cross or past play")
        else:
            chunk = sim_batch_size // num_current_policies
        if policy_chunk_size_override < 0:
            raise ValueError(f"policy_chunk_size_override "
                             f"{policy_chunk_size_override} is negative")
        if policy_chunk_size_override:
            if not pbt.complex_matchmaking and \
                    policy_chunk_size_override != chunk:
                # The layout is the reshape to [P, N / P] (as in JAX,
                # where another size does not reshape).
                raise ValueError(
                    f"rollout_policy_chunk_size_override "
                    f"{policy_chunk_size_override}: pure self-play lays "
                    f"each policy's block out as one chunk of {chunk}")
            chunk = policy_chunk_size_override
        num_chunks = -(-sim_batch_size // chunk)
        if pbt.complex_matchmaking:
            num_chunks += pbt.total_num_policies - 1
        return RolloutConfig(
            sim_batch_size=sim_batch_size,
            num_worlds=sim_batch_size // (num_teams * team_size),
            actions_cfg=actions_cfg,
            reward_gamma=reward_gamma,
            pbt=pbt,
            reward_dtype=reward_dtype,
            policy_chunk_size=chunk,
            num_policy_chunks=num_chunks,
            total_policy_batch_size=num_chunks * chunk,
            policy_chunked=policy_chunked,
        )


def chunked_path_missing(actor_critic, obs_preprocess) -> Optional[str]:
    """The rule for which path a population takes: the policy-chunk layout
    when every module of its actor-critic has a policy-batched form and its
    obs preprocessor a ``preprocess_chunked`` (returns ``None``), else the
    per-policy loop (returns the first module without a form)."""
    from .models.common import chunked_form_missing

    if not hasattr(obs_preprocess, "preprocess_chunked"):
        return type(obs_preprocess).__name__
    return chunked_form_missing(actor_critic)


def batched_learn_missing(cfg: TrainConfig, actor_critic) -> Optional[str]:
    """The rule for which path a population's learn takes: one PPO step a
    minibatch over every train policy (``ppo._ppo_population``) when every
    module of its actor-critic has a policy-batched learn form and no PPO
    option needs each policy on its own (returns ``None``), else the
    per-policy loop (returns what needs it: the option, or the first
    module without a form). Advantage filtering (each policy's own
    minibatch count) and float16 loss scaling (each policy's own scaler
    and finite test) take the loop."""
    from .models.common import batched_form_missing

    if cfg.filter_advantages:
        return "filter_advantages"
    if cfg.compute_dtype == torch.float16:
        return "compute_dtype=float16 (loss scaling)"
    return batched_form_missing(actor_critic)


def compute_policy_chunks(assignments: torch.Tensor,
                          rollout_cfg: RolloutConfig
                          ) -> PolicyBatchReorderState:
    """The policy-chunk layout of ``assignments`` [N] (JAX:
    ``_compute_reorder_state``), on their device, with each chunk's
    policy (JAX's "Gather Chunk Weights" reads it from the chunk's first
    row). With matchmaking, ``compute_reorder_chunks`` over C =
    ``policy_chunk_size``; custom ids (past the population) count as one
    more policy, id P, whose chunks run no policy and whose rows are
    ``custom_rows``. In pure self-play the reshape to ``[P, N / P]``."""
    pbt = rollout_cfg.pbt
    N = assignments.shape[0]
    P = pbt.total_num_policies
    if not pbt.complex_matchmaking:
        chunks = assignments.reshape(pbt.num_current_policies, -1)
        ids = chunks[:, 0].to(torch.int32).contiguous()
        return PolicyBatchReorderState(
            to_policy_idxs=None, to_sim_idxs=None,
            policy_dims=tuple(chunks.shape), sim_dims=(N,),
            chunk_policy=ids, chunk_index=ids.long(),
            assignments=assignments)
    C = rollout_cfg.policy_chunk_size
    custom = bool(pbt.custom_policy_ids)
    ids = assignments.clamp(max=P) if custom else assignments
    buckets = P + custom
    B = -(-N // C) + buckets - 1
    to_policy, to_sim = compute_reorder_chunks(ids, buckets, C, B)
    chunk_policy = ids[to_policy[:, 0].clamp(max=N - 1).long()].to(
        torch.int32)
    return PolicyBatchReorderState(
        to_policy_idxs=to_policy, to_sim_idxs=to_sim, policy_dims=(B, C),
        sim_dims=(N,), chunk_policy=chunk_policy,
        chunk_index=chunk_policy.clamp(max=P - 1).long(),
        custom_rows=(assignments >= P) if custom else None,
        custom_chunks=(chunk_policy >= P) if custom else None,
        assignments=assignments)


class _PolicyRows:
    """The sim rows, in sim order, that each policy present in a step runs
    on, and the way back to sim order.

    Rows assigned an id past the population (``custom_policy_ids``,
    which the simulator plays itself) run no module: ``to_sim`` fills them
    with zeros in every output, or with their rows of ``rest`` where given
    (the recurrent state, which they keep as it was). Their ids sort after
    every policy's, so the population's rows and outputs are those of a
    step without them. A step must hold a row of some policy.
    """

    def __init__(self, rollout_cfg: RolloutConfig,
                 assignments: torch.Tensor):
        pbt = rollout_cfg.pbt
        self.custom = None
        if not pbt.complex_matchmaking:
            n = rollout_cfg.sim_batch_size // pbt.num_current_policies
            self.rows = [(p, slice(p * n, (p + 1) * n))
                         for p in range(pbt.num_current_policies)]
            self.inverse = None
            return
        P = pbt.total_num_policies
        # The step's one device-to-host copy: [P + 1] agent counts, the
        # custom ids counted together in the last.
        counts = torch.bincount(assignments.clamp(max=P).long(),
                                minlength=P + 1).tolist()
        perm = torch.argsort(assignments, stable=True)
        num_rows = sum(counts[:P])
        if not num_rows:
            raise ValueError("every row of the step is a custom policy's")
        self.rows = [(p, rows) for p, rows in
                     enumerate(torch.split(perm[:num_rows], counts[:P]))
                     if counts[p]]
        if num_rows < perm.shape[0]:
            self.custom = perm[num_rows:]
        self.inverse = torch.empty_like(perm)
        self.inverse[perm] = torch.arange(perm.shape[0], device=perm.device)

    def gather(self, tree, rows):
        return tree_map(lambda x: x[rows], tree)

    def to_sim(self, parts, rest=None):
        """Per-policy outputs, in ``rows`` order -> one tree in sim order;
        the custom rows take zeros, or their rows of the sim-order tree
        ``rest``."""
        if self.custom is not None:
            n = self.custom.shape[0]
            parts = [*parts, (
                self.gather(rest, self.custom) if rest is not None else
                tree_map(lambda x: x.new_zeros((n, *x.shape[1:])),
                         parts[0]))]

        def merge(*xs):
            x = torch.cat(xs) if len(xs) > 1 else xs[0]
            return x if self.inverse is None else x[self.inverse]

        return tree_map(merge, *parts)


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
    # The simulator's optional snapshot hooks (envs/sim_interface.py).
    get_ckpts_fn: Optional[Callable] = None
    load_ckpts_fn: Optional[Callable] = None
    # The policy-chunk layout of ``policy_assignments`` (the chunked path),
    # computed at the end of each step; None until a chunked loop runs.
    reorder_state: Optional[PolicyBatchReorderState] = None

    @staticmethod
    def create(rollout_cfg: RolloutConfig, sim_fns, generator, rnn_states,
               init_sim_ctrl,
               static_play_assignments: Optional[torch.Tensor] = None
               ) -> "RolloutState":
        """With a population (``rollout_cfg.pbt``), the first
        matchmaking draws from ``generator`` and the assignments are a
        ``[sim_batch_size]`` vector; otherwise they are zeros
        ``[sim_batch_size, 1]``."""
        device = init_sim_ctrl.device
        B = rollout_cfg.sim_batch_size
        if rollout_cfg.pbt is None:
            assignments = torch.zeros((B, 1), dtype=torch.int32,
                                      device=device)
        else:
            assignments = pbt_init_matchmaking(
                generator, rollout_cfg.pbt, static_play_assignments)
        init_out = sim_fns["init"]()
        return RolloutState(
            cfg=rollout_cfg,
            step_fn=sim_fns["step"],
            sim_state=init_out["state"],
            cur_obs=init_out["obs"],
            generator=generator,
            rnn_states=rnn_states,
            policy_assignments=assignments,
            sim_ctrl=init_sim_ctrl,
            env_returns=torch.zeros((B, 1), dtype=rollout_cfg.reward_dtype,
                                    device=device),
            get_ckpts_fn=sim_fns.get("get_ckpts"),
            load_ckpts_fn=sim_fns.get("load_ckpts"),
        )

    def update_matchmaking(self, self_play_portion: float,
                           cross_play_portion: float,
                           past_play_portion: float,
                           static_play_portion: float,
                           policy_assignments: torch.Tensor):
        """Switch the play portions (training <-> the all-pairs Elo
        tournament) and the assignments, in place."""
        pbt = self.cfg.pbt
        new_pbt = PBTMatchmakeConfig.setup(
            pbt.num_current_policies, pbt.num_past_policies, pbt.num_teams,
            pbt.team_size, self.cfg.sim_batch_size, self_play_portion,
            cross_play_portion, past_play_portion, static_play_portion,
            pbt.custom_policy_ids)
        self.cfg = dataclasses.replace(self.cfg, pbt=new_pbt)
        self.policy_assignments = policy_assignments
        self.reorder_state = None
        return self

    # Simulator-state snapshots. A functional sim's hooks take and return
    # the state; a stateful engine's take none and return only the obs.
    def get_current_checkpoints(self):
        """The simulator's snapshot of its current state."""
        if inspect.signature(self.get_ckpts_fn).parameters:
            return self.get_ckpts_fn(self.sim_state)
        return self.get_ckpts_fn()

    def load_checkpoints_into_sim(self, ckpts):
        """Load the snapshot ``ckpts`` ``[sim_batch, ...]`` into the
        simulator: the sim state (of a functional sim) and the current obs
        are set in place."""
        if ckpts.dim() != 2:
            raise ValueError(f"checkpoints must be [sim_batch, size], not "
                             f"{tuple(ckpts.shape)}")
        trigger = torch.ones((ckpts.shape[0], 1), dtype=torch.int32,
                             device=ckpts.device)
        out = self.load_ckpts_fn(trigger, ckpts)
        if isinstance(out, dict) and "state" in out:
            self.sim_state = out["state"]
            out = out["obs"]
        self.cur_obs = out
        return self


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

    def minibatch_stacked(self, indices):
        """Rows ``indices`` [P, mb] of every policy's sequences in one
        gather: [P, T/C, mb, ...] (each policy's time-major), the recurrent
        start states [P, mb, ...]."""
        policies = torch.arange(indices.shape[0],
                                device=indices.device)[:, None]
        mb = {k: v for k, v in self.data.items() if k != "rnn_start_states"}
        mb = tree_map(lambda x: x[policies, indices].transpose(1, 2)
                      .contiguous(), mb)
        mb["rnn_start_states"] = tree_map(
            lambda x: x[policies, indices], self.data["rnn_start_states"])
        return mb

    def flatten_time(self) -> "RolloutData":
        """Every leaf [num_seqs, T/C, ...] -> [num_seqs * T/C, 1, ...]: one
        step a sequence. A recurrent start state cannot follow, so this
        serves feed-forward towers, whose state is the empty tuple."""
        states = []
        tree_map(states.append, self.data["rnn_start_states"])
        if states:
            raise ValueError(
                "flatten_time (advantage filtering) needs a feed-forward "
                "tower such as BackboneEncoder: recurrent start states "
                "cannot be split into single steps")
        return RolloutData(tree_map(
            lambda x: x.reshape(-1, 1, *x.shape[2:]), self.data))


def rollout_loop(rollout_state: RolloutState, policy_state, num_steps: int,
                 post_inference_cb: Callable, post_step_cb: Callable,
                 cb_state: Any, start_step_idx: int = 0,
                 sample_actions: bool = True):
    """Run ``num_steps`` sim steps, sampling actions (or, with
    ``sample_actions=False``, taking each head's most likely action, with
    no ``log_probs`` in the policy outputs).

    - ``post_inference_cb(step_idx, obs, preprocessed_obs, policy_out,
      cb_state) -> (cb_state, emit)``
    - ``post_step_cb(step_idx, rollout_state, dones, rewards, cb_state)
      -> (rollout_state, cb_state, emit)``

    Returns ``(rollout_state, cb_state, (inference_emits, step_emits))``
    with the emits stacked along a leading time axis.

    With a population (``rollout_state.cfg.pbt``), ``policy_state`` is the
    ``Population`` and the loop is ``chunked_rollout_loop``'s or
    ``population_rollout_loop``'s, as ``cfg.policy_chunked`` says.
    """
    if rollout_state.cfg.pbt is not None:
        loop = (chunked_rollout_loop if rollout_state.cfg.policy_chunked
                else population_rollout_loop)
        return loop(rollout_state, policy_state, num_steps,
                    post_inference_cb, post_step_cb, cb_state,
                    start_step_idx, sample_actions=sample_actions)
    cfg = rollout_state.cfg
    actor_critic = policy_state.actor_critic
    inference_emits, step_emits = [], []
    with torch.no_grad():
        for step_idx in range(start_step_idx, start_step_idx + num_steps):
            obs = rollout_state.cur_obs
            with profile("Policy Inference"):
                with profile("Obs Preprocess"):
                    preprocessed = policy_state.obs_preprocess.preprocess(
                        policy_state.obs_preprocess_state, obs)
                with profile("Policy Apply"):
                    policy_out, rnn_states = actor_critic.rollout(
                        rollout_state.generator, rollout_state.rnn_states,
                        preprocessed, sample_actions=sample_actions)
                cb_state, emit = post_inference_cb(
                    step_idx, obs, preprocessed, policy_out, cb_state)
                inference_emits.append(emit)

            with profile("Rollout Step"):
                with profile("Sim Step"):
                    step_output = rollout_state.step_fn({
                        "state": rollout_state.sim_state,
                        "actions": policy_out["actions"],
                        "resets": torch.zeros(
                            (cfg.num_worlds, 1), dtype=torch.int32,
                            device=rollout_state.sim_ctrl.device),
                        "sim_ctrl": rollout_state.sim_ctrl,
                        "pbt": {"policy_assignments":
                                rollout_state.policy_assignments},
                    })
                dones = step_output["dones"].to(torch.bool)
                rewards = step_output["rewards"].to(_F32)
                env_returns = (rewards
                               + cfg.reward_gamma * rollout_state.env_returns)

                rollout_state.rnn_states = \
                    actor_critic.clear_recurrent_state(rnn_states, dones)
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


def _value_estimate(critic_out):
    """A distributional critic's mean, or the scalar critic's output."""
    return (critic_out if isinstance(critic_out, torch.Tensor)
            else critic_out.mean())


def _pbt_inputs(population, assignments):
    inputs = {"policy_assignments": assignments}
    if population.reward_hyper_params is not None:
        inputs["reward_hyper_params"] = population.reward_hyper_params
    return inputs


def _population_sim_step(rollout_state: RolloutState, population, actions):
    """The sim step of a population's rollout step, under the step's
    assignments: (step output, dones, rewards, env returns, episode
    results)."""
    cfg = rollout_state.cfg
    assignments = rollout_state.policy_assignments
    with profile("Sim Step"):
        step_output = rollout_state.step_fn({
            "state": rollout_state.sim_state,
            "actions": actions,
            "resets": torch.zeros((cfg.num_worlds, 1), dtype=torch.int32,
                                  device=assignments.device),
            "sim_ctrl": rollout_state.sim_ctrl,
            "pbt": _pbt_inputs(population, assignments[:, None]),
        })
    dones = step_output["dones"].to(torch.bool)
    rewards = step_output["rewards"].to(cfg.reward_dtype)
    if cfg.reward_gamma == 1.0:
        # No float promotion: integer rewards stay exact.
        env_returns = rewards + rollout_state.env_returns
    else:
        env_returns = (rewards + cfg.reward_gamma
                       * rollout_state.env_returns).to(cfg.reward_dtype)
    episode_results = step_output.get("pbt", {}).get("episode_results")
    return step_output, dones, rewards, env_returns, episode_results


def population_rollout_loop(rollout_state: RolloutState, population,
                            num_steps: int, post_inference_cb: Callable,
                            post_step_cb: Callable, cb_state: Any,
                            start_step_idx: int = 0,
                            value_fn: Callable = _value_estimate,
                            sample_actions: bool = True):
    """``rollout_loop`` over a population, everything in sim order:

    - ``post_inference_cb(step_idx, obs, preprocessed_obs, policy_out,
      cb_state) -> (cb_state, emit)``, with ``policy_out["critic"]`` the
      values (``value_fn`` of each policy's critic output);
    - ``post_step_cb(step_idx, rollout_state, dones, rewards,
      episode_results, cb_state) -> (rollout_state, cb_state, emit)``,
      after the matchmaking of the next step.

    Actions are sampled from ``rollout_state.generator`` (or, with
    ``sample_actions=False``, each head's most likely) and matchmaking
    draws from it too. Rows of custom policy ids run no module: their
    outputs and preprocessed obs are zeros and their recurrent state is
    kept (``_PolicyRows``).
    """
    cfg = rollout_state.cfg
    clear = population[0].actor_critic.clear_recurrent_state
    inference_emits, step_emits = [], []
    with torch.no_grad():
        for step_idx in range(start_step_idx, start_step_idx + num_steps):
            obs = rollout_state.cur_obs
            # The step's rows of each policy, from the assignments the last
            # step's matchmaking left (JAX computes its reorder state at
            # the end of a step, inside "Rollout Step").
            with profile("Compute Reorder State"):
                batches = _PolicyRows(cfg, rollout_state.policy_assignments)
            with profile("Policy Inference"):
                pre_parts, out_parts, rnn_parts = [], [], []
                for p, rows in batches.rows:
                    policy = population[p]
                    with profile("Reorder To Policy"):
                        policy_obs = batches.gather(obs, rows)
                        policy_rnn = batches.gather(rollout_state.rnn_states,
                                                    rows)
                    with profile("Obs Preprocess"):
                        pre = policy.obs_preprocess.preprocess(
                            policy.obs_preprocess_state, policy_obs)
                    with profile("Policy Apply"):
                        out, rnn = policy.actor_critic.rollout(
                            rollout_state.generator, policy_rnn, pre,
                            sample_actions=sample_actions)
                        out["critic"] = value_fn(out["critic"])
                    pre_parts.append(pre)
                    out_parts.append(out)
                    rnn_parts.append(rnn)
                with profile("Reorder To Sim"):
                    preprocessed = batches.to_sim(pre_parts)
                    policy_out = batches.to_sim(out_parts)
                    rnn_states = batches.to_sim(
                        rnn_parts, rest=rollout_state.rnn_states)
                cb_state, emit = post_inference_cb(
                    step_idx, obs, preprocessed, policy_out, cb_state)
                inference_emits.append(emit)

            with profile("Rollout Step"):
                assignments = rollout_state.policy_assignments
                (step_output, dones, rewards, env_returns,
                 episode_results) = _population_sim_step(
                     rollout_state, population, policy_out["actions"])

                if cfg.pbt.complex_matchmaking:
                    with profile("Matchmaking"):
                        assignments = pbt_update_matchmaking(
                            assignments, dones, rollout_state.generator,
                            cfg.pbt)
                rollout_state.policy_assignments = assignments
                rollout_state.rnn_states = clear(rnn_states, dones)
                rollout_state.sim_state = step_output["state"]
                rollout_state.cur_obs = step_output["obs"]
                rollout_state.env_returns = env_returns

                rollout_state, cb_state, emit = post_step_cb(
                    step_idx, rollout_state, dones, rewards,
                    episode_results, cb_state)
                step_emits.append(emit)
                rollout_state.env_returns = torch.where(
                    dones, 0, rollout_state.env_returns)

    stack = lambda emits: (tree_stack(emits) if emits[0] is not None
                           else None)
    return rollout_state, cb_state, (stack(inference_emits),
                                     stack(step_emits))


def _current_layout(rollout_state: RolloutState) -> PolicyBatchReorderState:
    """The policy-chunk layout of the current assignments: the one the last
    step left, or, where the assignments were set since, a new one."""
    layout = rollout_state.reorder_state
    if (layout is None
            or layout.assignments is not rollout_state.policy_assignments):
        with profile("Compute Reorder State"):
            layout = compute_policy_chunks(rollout_state.policy_assignments,
                                           rollout_state.cfg)
        rollout_state.reorder_state = layout
    return layout


def _chunk_remap(old: PolicyBatchReorderState,
                 new: PolicyBatchReorderState, data):
    """Chunk-order ``data`` of layout ``old`` gathered straight into layout
    ``new`` (JAX: ``chunk_remap``): new slot (b, c) holds sim row
    ``new.to_policy_idxs[b, c]``, which sits at old flat slot
    ``old.to_sim_idxs[row]``; one gather a leaf on the composed indices.
    The sentinel of empty chunks resolves by the clip, as in the two-step
    path."""
    n = old.to_sim_idxs.shape[0]
    idx = old.to_sim_idxs[new.to_policy_idxs.clamp(max=n - 1).long()].long()
    return tree_map(lambda x: x.reshape(-1, *x.shape[2:])[idx], data)


def chunked_rollout_loop(rollout_state: RolloutState, population,
                         num_steps: int, post_inference_cb: Callable,
                         post_step_cb: Callable, cb_state: Any,
                         start_step_idx: int = 0,
                         value_fn: Callable = _value_estimate,
                         sample_actions: bool = True, stack=None,
                         chunkwise_rnn: bool = False):
    """``population_rollout_loop`` in the policy-chunk layout (JAX:
    ``rollout_loop``), with the same callbacks, in sim order. Each step:
    "Reorder To Policy" gathers the obs (and the recurrent state) into the
    step's chunks, "Obs Preprocess" and "Policy Apply" run one batched pass
    of the policy over every chunk (``PopulationStack``; ``stack`` is
    ``population.stacked()``, built here if not given), "Reorder To Sim"
    gathers the outputs back, the custom rows zeroed and their recurrent
    state kept; after the sim step and matchmaking, "Compute Reorder State"
    lays out the next step on the device. Actions are sampled per row from
    ``rollout_state.generator``. With ``chunkwise_rnn`` (matchmaking only)
    the recurrent state stays in chunk order within the loop (in
    ``rollout_state.rnn_states`` too, as in JAX), joined across layouts by
    ``_chunk_remap``; the outputs are bitwise those without it.
    """
    cfg = rollout_state.cfg
    if stack is None:
        stack = population.stacked()
    chunkwise = chunkwise_rnn and cfg.pbt.complex_matchmaking
    clear = stack.actor_critic.clear_recurrent_state
    layout = _current_layout(rollout_state)
    if chunkwise:
        rollout_state.rnn_states = layout.to_policy(rollout_state.rnn_states)
    inference_emits, step_emits = [], []
    with torch.no_grad():
        for step_idx in range(start_step_idx, start_step_idx + num_steps):
            obs = rollout_state.cur_obs
            with profile("Policy Inference"):
                with profile("Reorder To Policy"):
                    policy_obs = layout.to_policy(obs)
                    rnn_in = (rollout_state.rnn_states if chunkwise else
                              layout.to_policy(rollout_state.rnn_states))
                with profile("Obs Preprocess"):
                    pre = stack.preprocess(layout, policy_obs)
                with profile("Policy Apply"):
                    out, rnn = stack.rollout(
                        layout, rollout_state.generator, rnn_in, pre,
                        sample_actions=sample_actions)
                    out["critic"] = value_fn(out["critic"])
                with profile("Reorder To Sim"):
                    preprocessed = layout.drop_custom(layout.to_sim(pre))
                    policy_out = layout.drop_custom(layout.to_sim(out))
                    if chunkwise:
                        rnn = layout.keep_custom_chunks(rnn, rnn_in)
                    else:
                        rnn = layout.drop_custom(layout.to_sim(rnn),
                                                 rest=rollout_state.rnn_states)
                cb_state, emit = post_inference_cb(
                    step_idx, obs, preprocessed, policy_out, cb_state)
                inference_emits.append(emit)

            with profile("Rollout Step"):
                assignments = rollout_state.policy_assignments
                (step_output, dones, rewards, env_returns,
                 episode_results) = _population_sim_step(
                     rollout_state, population, policy_out["actions"])

                rnn = clear(rnn, layout.to_policy(dones) if chunkwise
                            else dones)
                if cfg.pbt.complex_matchmaking:
                    with profile("Matchmaking"):
                        assignments = pbt_update_matchmaking(
                            assignments, dones, rollout_state.generator,
                            cfg.pbt)
                    with profile("Compute Reorder State"):
                        new_layout = compute_policy_chunks(assignments, cfg)
                    if chunkwise:
                        with profile("RNN Chunk Remap"):
                            rnn = _chunk_remap(layout, new_layout, rnn)
                    layout = new_layout
                rollout_state.policy_assignments = assignments
                rollout_state.reorder_state = layout
                rollout_state.rnn_states = rnn
                rollout_state.sim_state = step_output["state"]
                rollout_state.cur_obs = step_output["obs"]
                rollout_state.env_returns = env_returns

                rollout_state, cb_state, emit = post_step_cb(
                    step_idx, rollout_state, dones, rewards,
                    episode_results, cb_state)
                step_emits.append(emit)
                rollout_state.env_returns = torch.where(
                    dones, 0, rollout_state.env_returns)

    if chunkwise:
        rollout_state.rnn_states = layout.to_sim(rollout_state.rnn_states)
    stack_emits = lambda emits: (tree_stack(emits) if emits[0] is not None
                                 else None)
    return rollout_state, cb_state, (stack_emits(inference_emits),
                                     stack_emits(step_emits))


def rollouts_reset(rollout_state: RolloutState, policy_state):
    """Step the sim once with resets raised; clear returns and RNN state.
    ``policy_state`` may be a population."""
    cfg = rollout_state.cfg
    device = rollout_state.sim_ctrl.device
    pbt_inputs = {"policy_assignments": torch.zeros(
        (cfg.sim_batch_size, 1), dtype=torch.int32, device=device)}
    if cfg.pbt is not None:
        pbt_inputs = _pbt_inputs(policy_state,
                                 pbt_inputs["policy_assignments"])
        policy_state = policy_state[0]

    def zero_action(action_cfg):
        if isinstance(action_cfg, DiscreteActionsConfig):
            return torch.zeros(
                (cfg.sim_batch_size, len(action_cfg.actions_num_buckets)),
                dtype=torch.int32, device=device)
        return torch.zeros((cfg.sim_batch_size, 1, action_cfg.num_dims),
                           dtype=_F32, device=device)

    step_output = rollout_state.step_fn({
        "state": rollout_state.sim_state,
        "actions": {k: zero_action(v) for k, v in cfg.actions_cfg.items()},
        "resets": torch.ones((cfg.num_worlds, 1), dtype=torch.int32,
                             device=device),
        "sim_ctrl": rollout_state.sim_ctrl,
        "pbt": pbt_inputs,
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
        if rollout_cfg.pbt is not None:
            self._num_train_policies = rollout_cfg.pbt.num_current_policies
            self._num_train_agents_per_policy = \
                _compute_num_train_agents_per_policy(rollout_cfg)
            self._sim_to_train_idxs = _compute_sim_to_train_indices(
                rollout_cfg)

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
        in place. With a population, ``obs_stats`` is a list, one entry a
        train policy."""
        collect = (self._collect_impl if self._cfg.pbt is None
                   else self._collect_population)
        rollout_data, obs_stats, user_state = collect(
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
            with profile("Pre Step Rollout Store"):
                emit = {
                    "obs": preprocessed_obs,
                    "actions": policy_out["actions"],
                    "log_probs": {k: v.to(_F32) for k, v in
                                  policy_out["log_probs"].items()},
                    "values": self._compute_value_estimate(
                        policy_out["critic"]),
                }
                cb_state["obs_stats"] = obs_preprocess.update_obs_stats(
                    obs_state, cb_state["obs_stats"], step_idx, obs)
                return cb_state, emit

        def post_step_cb(step_idx, rollout_state, dones, rewards, cb_state):
            with profile("Post Step Rollout Store"):
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
            with profile("Cache RNN state"):
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
        with profile("Bootstrap Values"):
            bootstrap_values = self._bootstrap_values(policy_state,
                                                      rollout_state)
        with profile("Finalize Rollouts"):
            rollout_data, user_state = self._finalize_rollouts(
                train_state.value_normalizer,
                train_state.value_normalizer_state, store, rnn_start_states,
                bootstrap_values, metrics, user_state,
                user_finish_rollouts_hook, user_metrics_hook)
        return rollout_data, cb_state["obs_stats"], user_state

    def _collect_population(self, population, train_states, user_state,
                            rollout_state, metrics, user_start_rollouts_hook,
                            user_finish_rollouts_hook, user_metrics_hook):
        rollout_state, user_state = user_start_rollouts_hook(
            rollout_state, user_state)
        P = self._num_train_policies
        train_idxs = self._sim_to_train_idxs.to(
            rollout_state.env_returns.device)

        def to_train(tree):
            """sim order [B, ...] -> train order [P_train, A, ...]."""
            return tree_map(lambda x: x[train_idxs], tree)

        def post_inference_cb(step_idx, obs, preprocessed_obs, policy_out,
                              cb_state):
            with profile("Pre Step Rollout Store"):
                emit = to_train({
                    "obs": preprocessed_obs,
                    "actions": policy_out["actions"],
                    "log_probs": {k: v.to(_F32) for k, v in
                                  policy_out["log_probs"].items()},
                    "values": policy_out["critic"],
                })
                train_obs = to_train(obs)
                cb_state["obs_stats"] = [
                    population[p].obs_preprocess.update_obs_stats(
                        population[p].obs_preprocess_state, stats, step_idx,
                        {k: v[p] for k, v in train_obs.items()})
                    for p, stats in enumerate(cb_state["obs_stats"])]
                return cb_state, emit

        def post_step_cb(step_idx, rollout_state, dones, rewards,
                         episode_results, cb_state):
            with profile("Post Step Rollout Store"):
                train_dones = to_train(dones)
                cb_state["env_returns_metric"] = \
                    cb_state["env_returns_metric"].merge(
                        Metric.init_from_data_masked(
                            True, to_train(rollout_state.env_returns),
                            train_dones, start_dim=1))
                return rollout_state, cb_state, {
                    "dones": train_dones, "rewards": to_train(rewards)}

        cb_state = {
            "obs_stats": [population[p].obs_preprocess.init_obs_stats(
                population[p].obs_preprocess_state) for p in range(P)],
            "env_returns_metric": Metric.init(
                True, (P,), device=rollout_state.env_returns.device),
        }
        # The chunked path reads the population's stacked view, built once
        # a collect; the loops are looked up here, when they run.
        if self._cfg.policy_chunked:
            stack = population.stacked()
            loop = chunked_rollout_loop
            loop_kwargs = dict(stack=stack, chunkwise_rnn=os.environ.get(
                "MADRONA_LEARN_TPU_CHUNKWISE_RNN") == "1")
        else:
            stack, loop, loop_kwargs = None, population_rollout_loop, {}
        chunks, rnn_start_states = [], []
        for chunk in range(self._num_bptt_chunks):
            with profile("Cache RNN state"):
                rnn_start_states.append(to_train(rollout_state.rnn_states))
            rollout_state, cb_state, (per_step, step_data) = loop(
                rollout_state, population, self._num_bptt_steps,
                post_inference_cb, post_step_cb, cb_state,
                start_step_idx=chunk * self._num_bptt_steps,
                value_fn=self._compute_value_estimate, **loop_kwargs)
            chunks.append(dict(per_step, **step_data))
        # store leaves: [C, T/C, P, A, ...]; rnn_start_states: [C, P, A, ...]
        store = tree_stack(chunks)
        rnn_start_states = tree_stack(rnn_start_states)

        metrics.update_metrics({
            "Env Returns": cb_state["env_returns_metric"]})
        with torch.no_grad(), profile("Bootstrap Values"):
            rnn, obs = to_train((rollout_state.rnn_states,
                                 rollout_state.cur_obs))
            if stack is not None:
                # One batched critic_only: the train order's [P, A] rows
                # are P chunks of A rows, chunk p policy p's.
                ids = torch.arange(P, dtype=torch.int32,
                                   device=train_idxs.device)
                layout = PolicyBatchReorderState(
                    to_policy_idxs=None, to_sim_idxs=None,
                    policy_dims=tuple(train_idxs.shape),
                    sim_dims=(train_idxs.numel(),), chunk_policy=ids,
                    chunk_index=ids.long())
                out, _ = stack.critic_only(layout, rnn,
                                           stack.preprocess(layout, obs))
                bootstrap_values = self._compute_value_estimate(
                    out["critic"])
            else:
                bootstrap_values = torch.stack([
                    self._critic_value(population[p],
                                       tree_map(lambda x: x[p], rnn),
                                       {k: v[p] for k, v in obs.items()})
                    for p in range(P)])
        with profile("Finalize Rollouts"):
            rollout_data, user_state = self._finalize_rollouts(
                train_states[0].value_normalizer,
                [ts.value_normalizer_state for ts in train_states],
                store, rnn_start_states, bootstrap_values, metrics,
                user_state, user_finish_rollouts_hook, user_metrics_hook)
        return rollout_data, cb_state["obs_stats"], user_state

    def _critic_value(self, policy_state, rnn_states, obs):
        preprocessed = policy_state.obs_preprocess.preprocess(
            policy_state.obs_preprocess_state, obs)
        out, _ = policy_state.actor_critic.critic_only(rnn_states,
                                                       preprocessed)
        return self._compute_value_estimate(out["critic"])

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
        elif isinstance(value_normalizer_state, list):
            # One normalizer state a train policy (axis 2 of the store).
            values = torch.stack([
                value_normalizer.invert(state, rollouts["values"][:, :, p])
                for p, state in enumerate(value_normalizer_state)], dim=2)
            unnormalized_bootstrap = torch.stack([
                value_normalizer.invert(state, bootstrap_values[p])
                for p, state in enumerate(value_normalizer_state)])
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


# -- Train-order index math -------------------------------------------------

def _compute_num_train_agents_per_policy(rollout_cfg: RolloutConfig) -> int:
    """Only team 0 of cross- and past-play matches trains, which keeps each
    train policy's batch the same size every step."""
    pbt = rollout_cfg.pbt
    total = (pbt.self_play_batch_size
             + pbt.cross_play_batch_size // pbt.num_teams
             + pbt.past_play_batch_size // pbt.num_teams)
    if total % pbt.num_current_policies:
        raise ValueError(f"{total} train agents do not divide among "
                         f"{pbt.num_current_policies} train policies")
    return total // pbt.num_current_policies


def _compute_sim_to_train_indices(rollout_cfg: RolloutConfig):
    """int64 ``[num_train_policies, num_train_agents_per_policy]``: each
    train policy's training agents in sim order (its self-play block, then
    team 0 of its cross- and past-play matches)."""
    pbt = rollout_cfg.pbt
    indices = torch.arange(rollout_cfg.sim_batch_size)
    P = pbt.num_current_policies

    def match_indices(start, stop):
        return indices[start:stop].reshape(P, -1, pbt.num_teams,
                                           pbt.team_size)

    self_end = pbt.self_play_batch_size
    cross_end = self_end + pbt.cross_play_batch_size
    past_end = cross_end + pbt.past_play_batch_size
    return torch.cat([
        match_indices(0, self_end).reshape(P, -1),
        match_indices(self_end, cross_end)[:, :, 0, :].reshape(P, -1),
        match_indices(cross_end, past_end)[:, :, 0, :].reshape(P, -1)],
        dim=1)
