"""Policy and training state (JAX: madrona_learn_tpu/train_state.py).

- ``PolicyState``: the actor-critic module (its parameters) and the
  observation preprocessor with its state.
- ``PolicyTrainState``: hyperparameters, the optimizer and its state, the
  initial L2 norm of every Dense kernel outside the actor and critic heads
  (for the weight-norm projection), the value normalizer and its state
  (``None`` unless ``TrainConfig.normalize_values``), and the update RNG.
- ``TrainStateManager``: the policy and train state of the one train policy,
  plus the user's hook state.

The optimizer is learning-rate free and the live ``hyper_params.lr`` scales
each step, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from .algo import AlgoBase, HyperParams
from .config import TrainConfig
from .models.actor_critic import ActorCritic
from .observations import ObservationsPreprocess, ObservationsPreprocessNoop
from .ops.ema import EMANormalizer
from .policy import Policy


@dataclass
class PolicyState:
    actor_critic: ActorCritic
    obs_preprocess: ObservationsPreprocess
    obs_preprocess_state: Dict[str, Any]


@dataclass
class PolicyTrainState:
    hyper_params: HyperParams
    tx: Any
    opt_state: Any
    initial_weight_norms: Dict[str, torch.Tensor]
    generator: torch.Generator
    value_normalizer: Optional[EMANormalizer] = None
    value_normalizer_state: Optional[Dict[str, torch.Tensor]] = None


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


@dataclass
class TrainStateManager:
    policy_states: PolicyState
    train_states: PolicyTrainState
    user_state: Any

    @staticmethod
    def create(policy: Policy, cfg: TrainConfig, algo: AlgoBase,
               init_user_state_cb: Callable, example_obs, device,
               generator: torch.Generator) -> "TrainStateManager":
        actor_critic = policy.actor_critic.to(device)
        obs_preprocess = (policy.obs_preprocess
                          or ObservationsPreprocessNoop.create())
        # Batch-1 example obs: only shapes matter.
        obs_state = obs_preprocess.init_state(
            {k: v[0:1] for k, v in example_obs.items()})

        hyper_params = algo.init_hyperparams(cfg)
        tx = algo.make_optimizer(hyper_params)
        value_norm, value_norm_state = None, None
        if cfg.normalize_values:
            value_norm, value_norm_state = _setup_value_normalizer(
                hyper_params, device)
        params = {k: p.detach()
                  for k, p in actor_critic.named_parameters()}
        return TrainStateManager(
            policy_states=PolicyState(
                actor_critic=actor_critic,
                obs_preprocess=obs_preprocess,
                obs_preprocess_state=obs_state),
            train_states=PolicyTrainState(
                hyper_params=hyper_params,
                tx=tx,
                opt_state=tx.init(params),
                initial_weight_norms=initial_weight_norms(actor_critic),
                generator=generator,
                value_normalizer=value_norm,
                value_normalizer_state=value_norm_state),
            user_state=init_user_state_cb(),
        )
