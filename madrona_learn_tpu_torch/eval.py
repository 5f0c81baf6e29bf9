"""Offline evaluation of checkpointed policies (JAX:
madrona_learn_tpu/eval.py).

- ``eval_load_ckpt``: the policies of a checkpoint, on the CPU: one of
  them, the train policies, or the whole population.
- ``eval_policies``: runs them over a simulator for
  ``EvalConfig.num_eval_steps`` steps, through the rollout's policy-chunk
  layout (one batched pass a step over every policy,
  ``rollouts.chunked_rollout_loop``) where the model has policy-batched
  forms, else each policy's module once a step over its rows
  (``rollouts.population_rollout_loop``): the rule of ``init_training``.
  Without ``eval_competitive`` (or with one policy) every policy plays
  itself in its own block of the sim batch; with it, every pairing of the
  policies and the custom policies plays static matches
  (``train._build_all_pairs_assignments``), the custom policies' rows run
  no module. ``step_cb`` sees every step.

The XLA-only parts of the JAX version (checkify, printing the lowered
program, ahead-of-time compilation) have no counterpart here.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from .config import EvalConfig
from .envs.sim_interface import as_sim_fns
from .policy import Policy
from .rollouts import (RolloutConfig, RolloutState, chunked_path_missing,
                       rollout_loop)
from .train import _build_all_pairs_assignments, resolve_device
from .train_state import (MMR, MovingEpisodeScore, PolicyState, Population,
                          TrainStateManager)
from .utils import tree_map


def _select(population: Population, indices) -> Population:
    """The policies ``indices`` of a population, with their rows of its
    ``[P, ...]`` tables."""
    index = torch.tensor(list(indices), dtype=torch.long)
    take = lambda x: None if x is None else x[index.to(x.device)]
    return Population(
        policies=[population.policies[i] for i in index.tolist()],
        reward_hyper_params=take(population.reward_hyper_params),
        get_episode_scores_fn=population.get_episode_scores_fn,
        episode_score=(None if population.episode_score is None else
                       MovingEpisodeScore(**{
                           k: take(v) for k, v in
                           vars(population.episode_score).items()})),
        mmr=(None if population.mmr is None
             else MMR(elo=take(population.mmr.elo))))


def eval_load_ckpt(policy: Policy, ckpt_path: str, train_only: bool = True,
                   single_policy: Optional[int] = None):
    """``(policy_states, num_policies)`` of checkpoint ``ckpt_path``:
    policy ``single_policy`` alone, else the train policies
    (``train_only``), else every policy. A checkpoint without population
    entries (the port's single-policy ones) gives its ``PolicyState``, any
    other a ``Population``."""
    policy_states, num_train, total = TrainStateManager.load_policies(
        policy, ckpt_path)
    if not isinstance(policy_states, Population):
        return policy_states, 1
    if single_policy is not None:
        return _select(policy_states, [single_policy]), 1
    if train_only:
        return _select(policy_states, range(num_train)), num_train
    return policy_states, total


def _on_device(policy: Policy, policy_states, dev) -> Population:
    """``policy_states`` as a population on ``dev`` (its modules moved
    there); one ``PolicyState`` becomes a population of one, with no
    fitness."""
    if isinstance(policy_states, PolicyState):
        policy_states = Population(
            policies=[policy_states], reward_hyper_params=None,
            get_episode_scores_fn=(policy.get_episode_scores
                                   or (lambda er: (0.0, 0.0))),
            episode_score=None, mmr=None)
    to_dev = lambda tree: tree_map(
        lambda x: x.to(dev) if isinstance(x, torch.Tensor) else x, tree)
    pop = policy_states
    return Population(
        policies=[PolicyState(actor_critic=p.actor_critic.to(dev),
                              obs_preprocess=p.obs_preprocess,
                              obs_preprocess_state=to_dev(
                                  p.obs_preprocess_state))
                  for p in pop.policies],
        reward_hyper_params=to_dev(pop.reward_hyper_params),
        get_episode_scores_fn=pop.get_episode_scores_fn,
        episode_score=(None if pop.episode_score is None else
                       MovingEpisodeScore(**to_dev(vars(pop.episode_score)))),
        mmr=None if pop.mmr is None else MMR(elo=pop.mmr.elo.to(dev)))


def eval_policies(dev, eval_cfg: EvalConfig, sim_fns: Dict[str, Callable],
                  policy: Policy, init_sim_ctrl: torch.Tensor, policy_states,
                  step_cb: Callable):
    """Evaluate ``policy_states`` (from ``eval_load_ckpt``) on ``dev``
    (``None`` is the CUDA card) for ``eval_cfg.num_eval_steps`` steps.

    After every step, ``step_cb(step_data)`` gets, in sim order, the
    policy outputs (``actions``; ``log_probs`` when sampling; ``critic``,
    the critic's value estimate; zeros on custom policies' rows), ``obs``,
    ``sim_state``, ``dones``, ``rewards``, ``returns``,
    ``episode_results`` and ``rnn_states``, and returns the sim state to
    go on from. With ``clear_fitness``, the Elo reads 1500 and the episode
    score 0 (on copies). Returns the Elo ``MMR`` of a competitive eval,
    else the ``MovingEpisodeScore``, else ``zeros(1)``.
    """
    dev = resolve_device(dev)
    population = _on_device(policy, policy_states, dev)
    dtypes = {m.dtype for p in population.policies
              for m in p.actor_critic.modules()
              if isinstance(getattr(m, "dtype", None), torch.dtype)}
    if dtypes - {eval_cfg.policy_dtype}:
        raise ValueError(f"EvalConfig.policy_dtype is "
                         f"{eval_cfg.policy_dtype}, the policies' layers "
                         f"compute in {sorted(map(str, dtypes))}")
    num_eval_policies = len(population)
    if eval_cfg.clear_fitness:
        if population.mmr is not None:
            population.mmr = MMR(elo=torch.full_like(population.mmr.elo,
                                                     1500.0))
        if population.episode_score is not None:
            population.episode_score = MovingEpisodeScore(**{
                k: torch.zeros_like(v)
                for k, v in vars(population.episode_score).items()})

    agents_per_world = eval_cfg.team_size * eval_cfg.num_teams
    sim_batch_size = eval_cfg.num_worlds * agents_per_world
    competitive = num_eval_policies > 1 and eval_cfg.eval_competitive
    rollout_cfg = RolloutConfig.setup_population(
        num_current_policies=num_eval_policies, num_past_policies=0,
        num_teams=eval_cfg.num_teams if competitive else 1,
        team_size=eval_cfg.team_size if competitive else agents_per_world,
        sim_batch_size=sim_batch_size, actions_cfg=eval_cfg.actions,
        self_play_portion=0.0 if competitive else 1.0,
        cross_play_portion=0.0, past_play_portion=0.0,
        static_play_portion=1.0 if competitive else 0.0,
        reward_gamma=eval_cfg.reward_gamma,
        custom_policy_ids=eval_cfg.custom_policy_ids,
        policy_chunked=chunked_path_missing(
            population[0].actor_critic,
            population[0].obs_preprocess) is None)
    static_play_assignments = None
    if competitive:
        static_play_assignments = _build_all_pairs_assignments(
            num_eval_policies, eval_cfg.custom_policy_ids, sim_batch_size,
            eval_cfg.num_teams, eval_cfg.team_size, device=dev)
    rollout_state = RolloutState.create(
        rollout_cfg=rollout_cfg, sim_fns=as_sim_fns(sim_fns),
        generator=torch.Generator(device=dev).manual_seed(0),
        rnn_states=population[0].actor_critic.init_recurrent_state(
            sim_batch_size, dev),
        init_sim_ctrl=init_sim_ctrl.to(dev),
        static_play_assignments=static_play_assignments)

    def post_inference_cb(step_idx, obs, preprocessed_obs, policy_out,
                          cb_state):
        return dict(policy_out, obs=obs), None

    def post_step_cb(step_idx, rollout_state, dones, rewards,
                     episode_results, cb_state):
        rollout_state.sim_state = step_cb(dict(
            cb_state, sim_state=rollout_state.sim_state, dones=dones,
            rewards=rewards, returns=rollout_state.env_returns,
            episode_results=episode_results,
            rnn_states=rollout_state.rnn_states))
        return rollout_state, cb_state, None

    rollout_loop(rollout_state, population, eval_cfg.num_eval_steps,
                 post_inference_cb, post_step_cb, {},
                 sample_actions=not eval_cfg.use_deterministic_policy)

    if eval_cfg.eval_competitive and population.mmr is not None:
        return population.mmr
    if population.episode_score is not None:
        return population.episode_score
    return torch.zeros((1,), device=dev)
