"""madrona_learn_tpu_torch: the PyTorch + CUDA port of madrona_learn_tpu.

The port runs the single-policy PPO path on one NVIDIA GPU: BPTT-chunked
collection from a batched simulator (the toy gridworld), GAE and clipped
PPO, for an MLP + LSTM actor-critic with a scalar critic (the ``bench.py``
headline) or the flagship entity self-attention + LSTM actor-critic with
the DreamerV3 two-hot critic. Its kernels are hand-written
CUDA for Hopper (``csrc/``), each with a plain PyTorch twin that CPU tensors
take. Module names mirror the JAX package's, which stays the reference.
"""

from .config import ContinuousActionsConfig, DiscreteActionsConfig, TrainConfig
from .observations import ObservationsCaster, ObservationsEMANormalizer
from .policy import Policy
from .ppo import PPOConfig
from .train import TrainHooks, TrainingManager, init_training

__all__ = [
    "ContinuousActionsConfig",
    "DiscreteActionsConfig",
    "ObservationsCaster",
    "ObservationsEMANormalizer",
    "PPOConfig",
    "Policy",
    "TrainConfig",
    "TrainHooks",
    "TrainingManager",
    "init_training",
]
