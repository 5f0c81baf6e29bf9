"""Configuration dataclasses of the port (JAX: madrona_learn_tpu/config.py).

The subset the single-policy PPO path needs: the discrete and continuous
action spaces and ``TrainConfig``; mappings are plain dicts. The critic
options (``dreamer_v3_critic``, on by default as in the JAX package, and
``hlgauss_critic``), the advantage / return targets and their z-scoring,
value normalization, advantage filtering, trajectory importance sampling,
stratified minibatches and ``compute_dtype`` (float16 turns on dynamic loss
scaling; the model modules carry their own compute dtype) are ported with
the JAX package's defaults. Population-based training is
``TrainConfig.pbt`` (a ``PBTConfig``), with ``ParamExplore`` search spaces
for ``lr`` and PPO's ``entropy_coef``. The mesh options of the JAX config
are not ported, so they are absent rather than ignored; with no mesh,
``minibatch_stratify=None`` means one block. ``EvalConfig`` configures
offline evaluation (``eval.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

import torch


@dataclass(frozen=True)
class DiscreteActionsConfig:
    """Multi-head categorical action space."""

    actions_num_buckets: List[int]


@dataclass(frozen=True)
class ContinuousActionsConfig:
    """Tanh-mean / sigmoid-ranged-std normal action space."""

    stddev_min: float
    stddev_max: float
    num_dims: int


ActionsConfig = Union[DiscreteActionsConfig, ContinuousActionsConfig]


class AlgoConfig:
    """Base class for algorithm configs."""

    def name(self) -> str:
        raise NotImplementedError

    def setup(self):
        raise NotImplementedError


@dataclass(frozen=True)
class ParamExplore:
    """PBT search space of one scalar hyperparameter.

    ``base * [min_scale, max_scale]`` is the resample range, sampled in
    linear, log10 or ln space. Perturbation multiplies by
    U[perturb_rnd_min, perturb_rnd_max], optionally clipped to the range.
    """

    base: float
    min_scale: float
    max_scale: float
    log10_scale: bool = False
    ln_scale: bool = False
    clip_perturb: bool = False
    perturb_rnd_min: float = 0.8
    perturb_rnd_max: float = 1.2


@dataclass(frozen=True)
class PBTConfig:
    """Population-based training: ``num_train_policies`` learning policies
    and ``num_past_policies`` frozen snapshots, matched in self, cross and
    past play (the portions sum to 1)."""

    num_teams: int
    team_size: int
    num_train_policies: int
    num_past_policies: int
    self_play_portion: float
    cross_play_portion: float
    past_play_portion: float
    # A copy (cull or past snapshot) happens only if the source's expected
    # winrate over the destination reaches this threshold.
    policy_overwrite_threshold: float = 0.7
    reward_hyper_params_explore: Dict[str, ParamExplore] = field(
        default_factory=dict)
    # A forced policy-chunk size of the rollout's policy-chunk layout
    # (0: JAX's heuristic, rollouts.RolloutConfig.setup_population). A
    # population whose model has no policy-batched form runs the per-policy
    # loop and refuses any value but 0.
    rollout_policy_chunk_size_override: int = 0


@dataclass(frozen=True)
class TrainConfig:
    """Top-level training config: one train policy, or a PBT population
    with ``pbt``."""

    num_worlds: int
    num_agents_per_world: int
    actions: Dict[str, ActionsConfig]
    steps_per_update: int
    lr: Union[float, ParamExplore]
    algo: AlgoConfig
    num_bptt_chunks: int
    gamma: float
    seed: int
    metrics_buffer_size: int
    gae_lambda: float = 1.0
    pbt: Optional[PBTConfig] = None
    # The policy the Elo tournament pins at 1500, and the ids of policies
    # outside the population that the simulator plays itself.
    baseline_policy_id: int = 0
    custom_policy_ids: List[int] = field(default_factory=list)
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
    # Train only on the rows (time flattened) whose |advantage| is at least
    # 1% of an EMA of the largest |advantage|; the minibatch count follows.
    # The rows have no recurrent state, so this needs a feed-forward tower.
    filter_advantages: bool = False
    max_advantage_est_decay: float = 0.99999
    # Sample importance_sample_num_minibatches minibatches of sequences
    # by softmax(mean |advantage| + mean |value - return|), each weighted
    # by (1 / num_sequences) / its probability.
    importance_sample_trajectories: bool = False
    importance_sample_num_minibatches: int = 0
    # Uniform minibatches from this many equal contiguous blocks of the
    # sequences, each shuffled on its own every epoch; None is one block.
    minibatch_stratify: Optional[int] = None
    # float16 scales the loss dynamically (ops/dynamic_scale.py).
    compute_dtype: torch.dtype = torch.float32

    @property
    def sim_batch_size(self) -> int:
        return self.num_worlds * self.num_agents_per_world

    def __post_init__(self):
        if self.steps_per_update % self.num_bptt_chunks:
            raise ValueError(
                f"steps_per_update ({self.steps_per_update}) must be "
                f"divisible by num_bptt_chunks ({self.num_bptt_chunks})")


@dataclass(frozen=True)
class EvalConfig:
    """Offline evaluation (``eval.eval_policies``): ``num_worlds`` worlds
    of ``num_teams`` teams of ``team_size`` agents for ``num_eval_steps``
    steps; ``eval_competitive`` plays every pairing of the policies (and
    the custom policies, which the simulator plays) in static matches, else
    each policy plays itself. ``policy_dtype`` is the dtype the policies
    compute in: the model layers carry their own, and ``eval_policies``
    refuses a policy with a layer in another."""

    num_worlds: int
    num_teams: int
    team_size: int
    num_eval_steps: int
    actions: Dict[str, ActionsConfig]
    reward_gamma: float
    policy_dtype: torch.dtype
    eval_competitive: bool
    use_deterministic_policy: bool = True
    clear_fitness: bool = True
    custom_policy_ids: List[int] = field(default_factory=list)
