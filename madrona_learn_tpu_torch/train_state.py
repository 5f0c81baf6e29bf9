"""Policy and training state (JAX: madrona_learn_tpu/train_state.py).

- ``PolicyState``: the actor-critic module (its parameters) and the
  observation preprocessor with its state.
- ``PolicyTrainState``: hyperparameters, the optimizer and its state, the
  initial L2 norm of every Dense kernel outside the actor and critic heads
  (for the weight-norm projection), the value normalizer and its state
  (``None`` unless ``TrainConfig.normalize_values``), the EMA of the
  largest |advantage| (advantage filtering reads it), the float16 loss
  scaler and its state (``None`` unless ``TrainConfig.compute_dtype`` is
  float16), and the update RNG.
- ``Population`` (PBT): the policy states of the train policies and then
  the past policies, the ``[P, R]`` reward hyperparameters, the
  episode-score function and the fitness, an Elo ``MMR`` (competitive
  populations) or a ``MovingEpisodeScore`` (the others), as ``[P]``
  tensors.
- ``TrainStateManager``: the policy and train state of the one train
  policy, or with ``TrainConfig.pbt`` the ``Population``, one train state a
  train policy and the PBT generator; plus the user's hook state.

The optimizer is learning-rate free and the live ``hyper_params.lr`` scales
each step, as in the JAX package.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from .algo import AlgoBase, HyperParams
from .config import TrainConfig
from .models.actor_critic import ActorCritic
from .observations import ObservationsPreprocess, ObservationsPreprocessNoop
from .ops.dynamic_scale import DynamicScale
from .ops.ema import EMAEstimate, EMANormalizer
from .pbt import _copy_tree
from .policy import Policy


@dataclass
class PolicyState:
    actor_critic: ActorCritic
    obs_preprocess: ObservationsPreprocess
    obs_preprocess_state: Dict[str, Any]


@dataclass
class MovingEpisodeScore:
    mean: torch.Tensor
    var: torch.Tensor
    N: torch.Tensor


@dataclass
class MMR:
    elo: torch.Tensor


@dataclass
class Population:
    """The PBT population: train policies first, then past policies."""

    policies: List[PolicyState]
    reward_hyper_params: Optional[torch.Tensor]
    get_episode_scores_fn: Callable
    episode_score: Optional[MovingEpisodeScore]
    mmr: Optional[MMR]

    def __len__(self):
        return len(self.policies)

    def __getitem__(self, index: int) -> PolicyState:
        return self.policies[index]

    def copy_policy(self, src: int, dst: int):
        """Policy ``src`` into ``dst`` in place: parameters, obs-normalizer
        state, reward hyperparameters and fitness."""
        with torch.no_grad():
            source, dest = self.policies[src], self.policies[dst]
            _copy_tree(source.actor_critic.state_dict(),
                       dest.actor_critic.state_dict())
            _copy_tree(source.obs_preprocess_state,
                       dest.obs_preprocess_state)
            tables = [self.reward_hyper_params]
            if self.mmr is not None:
                tables.append(self.mmr.elo)
            if self.episode_score is not None:
                tables += [self.episode_score.mean, self.episode_score.var,
                           self.episode_score.N]
            for table in tables:
                if table is not None:
                    table[dst] = table[src]


@dataclass
class PolicyTrainState:
    hyper_params: HyperParams
    tx: Any
    opt_state: Any
    initial_weight_norms: Dict[str, torch.Tensor]
    generator: torch.Generator
    max_advantage_est: EMAEstimate
    max_advantage_est_state: Dict[str, torch.Tensor]
    value_normalizer: Optional[EMANormalizer] = None
    value_normalizer_state: Optional[Dict[str, torch.Tensor]] = None
    scaler: Optional[DynamicScale] = None
    scaler_state: Optional[Dict[str, torch.Tensor]] = None


def initial_weight_norms(actor_critic) -> Dict[str, torch.Tensor]:
    """L2 norm of every ``kernel`` parameter outside the actor and critic
    heads (the MLP Dense kernels and the LSTM input projections; the
    ``recurrent_kernel`` is not a ``kernel`` leaf and stays free)."""
    with torch.no_grad():
        return {name: torch.linalg.vector_norm(p).clone()
                for name, p in actor_critic.named_parameters()
                if name.rsplit(".", 1)[-1] == "kernel"
                and name.split(".", 1)[0] not in ("actor", "critic")}


def _setup_value_normalizer(hyper_params: HyperParams, device):
    """The normalizer of a scalar critic's float32 [..., 1] values."""
    normalizer = EMANormalizer(decay=hyper_params.value_normalizer_decay,
                               norm_dtype=torch.float32)
    return normalizer, normalizer.init_estimates(
        torch.zeros((1, 1), dtype=torch.float32, device=device))


def _seed(*key) -> int:
    return int(np.random.SeedSequence(list(key)).generate_state(1)[0])


@dataclass
class TrainStateManager:
    policy_states: Any  # PolicyState, or a Population with PBT
    train_states: Any  # PolicyTrainState, or a list of them with PBT
    user_state: Any
    pbt_generator: Optional[torch.Generator] = None

    @staticmethod
    def create(policy: Policy, cfg: TrainConfig, algo: AlgoBase,
               init_user_state_cb: Callable, example_obs, device,
               generator: torch.Generator) -> "TrainStateManager":
        actor_critic = policy.actor_critic.to(device)
        policy_state = _make_policy_state(policy, actor_critic, example_obs)
        return TrainStateManager(
            policy_states=policy_state,
            train_states=_make_train_state(cfg, algo, actor_critic, device,
                                           generator),
            user_state=init_user_state_cb(),
        )

    @staticmethod
    def create_population(policy: Policy, cfg: TrainConfig, algo: AlgoBase,
                          init_user_state_cb: Callable, example_obs,
                          device, use_competitive_mmr: bool
                          ) -> "TrainStateManager":
        """The PBT population: train policy p is ``policy.actor_critic(p)``
        (each from its own seed); past policy j copies train policy j mod
        ``num_train_policies``. Fitness starts at Elo 1500 or an empty
        episode score; the reward hyperparameters at 0."""
        P, num_past = cfg.pbt.num_train_policies, cfg.pbt.num_past_policies
        if isinstance(policy.actor_critic, torch.nn.Module):
            raise TypeError("a PBT population needs Policy.actor_critic as "
                            "a callable: train policy index -> ActorCritic")
        train_modules = [policy.actor_critic(p).to(device) for p in range(P)]
        modules = train_modules + [copy.deepcopy(train_modules[j % P])
                                   for j in range(num_past)]
        policies = [_make_policy_state(policy, m, example_obs)
                    for m in modules]
        total = P + num_past
        num_reward = len(cfg.pbt.reward_hyper_params_explore)
        if use_competitive_mmr:
            mmr = MMR(elo=torch.full((total,), 1500.0, dtype=torch.float32,
                                     device=device))
            episode_score = None
        else:
            mmr = None
            zeros = lambda dt: torch.zeros((total,), dtype=dt, device=device)
            episode_score = MovingEpisodeScore(
                mean=zeros(torch.float32), var=zeros(torch.float32),
                N=zeros(torch.int32))
        population = Population(
            policies=policies,
            reward_hyper_params=(
                torch.zeros((total, num_reward), dtype=torch.float32,
                            device=device) if num_reward else None),
            get_episode_scores_fn=(policy.get_episode_scores
                                   or (lambda er: (0.0, 0.0))),
            episode_score=episode_score,
            mmr=mmr)
        train_states = [
            _make_train_state(cfg, algo, modules[p], device,
                              torch.Generator(device=device).manual_seed(
                                  _seed(cfg.seed, 1, p)))
            for p in range(P)]
        return TrainStateManager(
            policy_states=population, train_states=train_states,
            user_state=init_user_state_cb(),
            pbt_generator=torch.Generator(device=device).manual_seed(
                _seed(cfg.seed, 2)))


def _make_policy_state(policy: Policy, actor_critic, example_obs):
    obs_preprocess = (policy.obs_preprocess
                      or ObservationsPreprocessNoop.create())
    # Batch-1 example obs: only shapes matter.
    return PolicyState(
        actor_critic=actor_critic,
        obs_preprocess=obs_preprocess,
        obs_preprocess_state=obs_preprocess.init_state(
            {k: v[0:1] for k, v in example_obs.items()}))


def _make_train_state(cfg: TrainConfig, algo: AlgoBase, actor_critic,
                      device, generator) -> PolicyTrainState:
    hyper_params = algo.init_hyperparams(cfg)
    tx = algo.make_optimizer(hyper_params)
    value_norm, value_norm_state = None, None
    if cfg.normalize_values:
        value_norm, value_norm_state = _setup_value_normalizer(
            hyper_params, device)
    scaler, scaler_state = None, None
    if cfg.compute_dtype == torch.float16:
        scaler = DynamicScale()
        scaler_state = scaler.init_state(device)
    max_adv_est = EMAEstimate(decay=hyper_params.max_advantage_est_decay)
    params = {k: p.detach() for k, p in actor_critic.named_parameters()}
    return PolicyTrainState(
        hyper_params=hyper_params,
        tx=tx,
        opt_state=tx.init(params),
        initial_weight_norms=initial_weight_norms(actor_critic),
        generator=generator,
        max_advantage_est=max_adv_est,
        max_advantage_est_state=max_adv_est.init_estimates(
            torch.zeros((1,), dtype=torch.float32, device=device)),
        value_normalizer=value_norm,
        value_normalizer_state=value_norm_state,
        scaler=scaler,
        scaler_state=scaler_state)
