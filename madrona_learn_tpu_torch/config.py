"""Configuration dataclasses of the port (JAX: madrona_learn_tpu/config.py).

The subset the single-policy PPO path needs: the discrete action space and
``TrainConfig``; mappings are plain dicts. The compute dtype lives on the
model modules. The critic options (``dreamer_v3_critic``, on by default as
in the JAX package, and ``hlgauss_critic``), the advantage / return targets
and their z-scoring, and value normalization are ported with the JAX
package's defaults. The PBT, mesh, advantage-filtering, importance-sampling
and minibatch-mode options of the JAX config are not ported yet, so they
are absent rather than ignored.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List


@dataclass(frozen=True)
class DiscreteActionsConfig:
    """Multi-head categorical action space."""

    actions_num_buckets: List[int]


class AlgoConfig:
    """Base class for algorithm configs."""

    def name(self) -> str:
        raise NotImplementedError

    def setup(self):
        raise NotImplementedError


@dataclass(frozen=True)
class TrainConfig:
    """Top-level training config (single train policy)."""

    num_worlds: int
    num_agents_per_world: int
    actions: Dict[str, DiscreteActionsConfig]
    steps_per_update: int
    lr: float
    algo: AlgoConfig
    num_bptt_chunks: int
    gamma: float
    seed: int
    metrics_buffer_size: int
    gae_lambda: float = 1.0
    # The critic returns a SymExpTwoHotDistribution (DreamerV3Critic):
    # values are its mean and the value loss is its two-hot cross entropy.
    dreamer_v3_critic: bool = True
    # The critic returns an HLGaussDist / HLGaussTwoPartDist (HLGaussCritic,
    # HLGaussTwoPartCritic): values are its mean and the value loss is its
    # cross entropy against Gaussian-smoothed labels.
    hlgauss_critic: bool = False
    # Train on GAE advantages (z-scored per minibatch if
    # normalize_advantages); otherwise on the discounted returns themselves
    # (z-scored if normalize_returns), and the GAE kernel does not run.
    compute_advantages: bool = True
    normalize_advantages: bool = True
    normalize_returns: bool = True
    # A scalar critic predicts returns normalized by an EMA of their mean
    # and variance; the rollout inverts its outputs before GAE.
    normalize_values: bool = False
    value_normalizer_decay: float = 0.99999

    @property
    def sim_batch_size(self) -> int:
        return self.num_worlds * self.num_agents_per_world

    def __post_init__(self):
        if self.steps_per_update % self.num_bptt_chunks:
            raise ValueError(
                f"steps_per_update ({self.steps_per_update}) must be "
                f"divisible by num_bptt_chunks ({self.num_bptt_chunks})")
