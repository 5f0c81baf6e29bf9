"""Algorithm interface and shared hyperparameters (JAX: algo.py)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from .config import TrainConfig


@dataclass
class HyperParams:
    """Per-policy hyperparameters (PBT mutates them once it is ported)."""

    lr: float
    gamma: float
    gae_lambda: float
    normalize_values: bool
    value_normalizer_decay: float


class AlgoBase:
    def init_hyperparams(self, cfg: TrainConfig) -> HyperParams:
        raise NotImplementedError

    def make_optimizer(self, hyper_params: HyperParams):
        raise NotImplementedError

    def update(self, *args, **kwargs):
        raise NotImplementedError

    def add_metrics(self, cfg: TrainConfig, metrics: Dict):
        raise NotImplementedError
