"""User-facing policy bundle (JAX: madrona_learn_tpu/policy.py)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from .models.actor_critic import ActorCritic
from .observations import ObservationsPreprocess


@dataclass
class Policy:
    actor_critic: ActorCritic
    obs_preprocess: Optional[ObservationsPreprocess] = None
