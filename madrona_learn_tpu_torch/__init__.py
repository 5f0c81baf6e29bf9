"""madrona_learn_tpu_torch: the PyTorch + CUDA port of madrona_learn_tpu.

The port runs the single-policy PPO main path on one NVIDIA GPU: the toy
gridworld behind the EMA observation normalizer, an MLP + LSTM actor-critic,
BPTT-chunked collection, GAE and clipped PPO. Its kernels are hand-written
CUDA for Hopper (``csrc/``), each with a plain PyTorch twin that CPU tensors
take. Module names mirror the JAX package's, which stays the reference.
"""

from .config import DiscreteActionsConfig, TrainConfig
from .observations import ObservationsEMANormalizer
from .policy import Policy
from .ppo import PPOConfig
from .train import TrainHooks, TrainingManager, init_training

__all__ = [
    "DiscreteActionsConfig",
    "ObservationsEMANormalizer",
    "PPOConfig",
    "Policy",
    "TrainConfig",
    "TrainHooks",
    "TrainingManager",
    "init_training",
]
