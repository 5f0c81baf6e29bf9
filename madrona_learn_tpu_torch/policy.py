"""User-facing policy bundle (JAX: madrona_learn_tpu/policy.py)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Union

from .models.actor_critic import ActorCritic
from .observations import ObservationsPreprocess


@dataclass
class Policy:
    """``actor_critic`` is the module or, for a PBT population
    (``TrainConfig.pbt``), a callable that builds train policy ``index``
    (``index -> ActorCritic``, each from its own seed). ``get_episode_scores`` maps a match's
    ``episode_results`` to the (team 0, team 1) scores, or one team's score
    (PBT fitness)."""

    actor_critic: Union[ActorCritic, Callable[[int], ActorCritic]]
    obs_preprocess: Optional[ObservationsPreprocess] = None
    get_episode_scores: Optional[Callable] = None
