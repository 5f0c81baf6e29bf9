"""Actor and critic heads (JAX: madrona_learn_tpu/models/critics.py).

The discrete dense actor, the dict actor over named action heads, and the
scalar dense critic. The distributional critics are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn

from ..config import DiscreteActionsConfig
from ..ops.dists import DictActionDistributions, DiscreteActionDistributions
from .common import Dense, orthogonal


class DenseLayerDiscreteActor(nn.Module):
    def __init__(self, cfg: DiscreteActionsConfig, in_features: int, dtype,
                 weight_init: Callable = orthogonal(0.01),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.impl = Dense(in_features, sum(cfg.actions_num_buckets), dtype,
                          use_bias=True, kernel_init=weight_init,
                          generator=generator)

    def forward(self, features):
        return DiscreteActionDistributions(
            self.cfg.actions_num_buckets, self.impl(features))


class DictActor(nn.Module):
    """One head per ``TrainConfig.actions`` key; samples come back as a
    matching ``{name: tensor}`` dict, the layout the sim step consumes."""

    def __init__(self, heads: Dict[str, nn.Module]):
        super().__init__()
        self.heads = nn.ModuleDict(heads)

    def forward(self, features):
        return DictActionDistributions(
            {name: head(features) for name, head in self.heads.items()})


class DenseLayerCritic(nn.Module):
    def __init__(self, in_features: int, dtype,
                 weight_init: Callable = orthogonal(1.0),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.Dense_0 = Dense(in_features, 1, dtype, use_bias=True,
                             kernel_init=weight_init, generator=generator)

    def forward(self, features):
        return self.Dense_0(features).to(torch.float32)
