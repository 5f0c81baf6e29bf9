"""madrona_learn_tpu_torch: the PyTorch + CUDA port of madrona_learn_tpu.

The port runs PPO on one NVIDIA GPU: BPTT-chunked collection from a batched
simulator (the toy gridworld, the bidding duel, the native sim), GAE and
clipped PPO, for an MLP + LSTM actor-critic with a scalar critic (the
``bench.py`` headline) or the flagship entity self-attention + LSTM
actor-critic with the DreamerV3 two-hot critic, and the rest of the JAX
package's model zoo (GRU or windowed-attention memory, separate actor and
critic towers, float16 recurrences); for one policy or, with
``TrainConfig.pbt``, a population-based training population of train and
past policies in matchmade self, cross and past play, ranked by Elo or
episode-score fitness, culled and snapshotted; with checkpoints to save,
resume and re-slice a run, and offline evaluation of checkpointed
policies (``eval.py``); with the trainer's tools: named profiling ranges
(``profile``) and a run-long ``torch.profiler`` trace
(``init_training(profile_dir=...)``, ``stop_training``), TensorBoard and
W&B writers, simulator-state snapshots, and the scripts and examples
beside the package. Its kernels are hand-written
CUDA for Hopper (``csrc/``), each with a plain PyTorch twin that CPU tensors
take. Module names mirror the JAX package's, which stays the reference.
"""

from .config import (ContinuousActionsConfig, DiscreteActionsConfig,
                     EvalConfig, ParamExplore, PBTConfig, TrainConfig)
from .eval import eval_load_ckpt, eval_policies
from .models import (ActorCritic, Backbone, BackboneEncoder,
                     BackboneSeparate, BackboneShared,
                     RecurrentBackboneEncoder)
from .observations import (ObservationsCaster, ObservationsEMANormalizer,
                           ObservationsPreprocess,
                           ObservationsPreprocessNoop)
from .pbt import (PBTMatchmakeConfig, pbt_cull_update,
                  pbt_explore_hyperparams, pbt_init_matchmaking,
                  pbt_past_update, pbt_update_elo, pbt_update_fitness,
                  pbt_update_matchmaking)
from .ops.dists import (ContinuousActionDistributions,
                        DiscreteActionDistributions)
from .ops.ema import EMAEstimate, EMANormalizer
from .ops.metrics import Metric, TrainingMetrics
from .policy import Policy
from .ppo import PPOConfig
from .rollouts import (RolloutConfig, RolloutData, RolloutManager,
                       RolloutState, rollout_loop, rollouts_reset)
from .train import (TrainHooks, TrainingManager, eval_elo, init_training,
                    latest_checkpoint, stop_training, update_population)
from .train_state import TrainStateManager, wait_for_checkpoints
from .utils import profile
from .utils.tensorboard import TensorboardWriter
from .utils.wandb import WandbWriter

__all__ = [
    "ActorCritic",
    "Backbone",
    "BackboneEncoder",
    "BackboneSeparate",
    "BackboneShared",
    "ContinuousActionDistributions",
    "ContinuousActionsConfig",
    "DiscreteActionDistributions",
    "DiscreteActionsConfig",
    "EMAEstimate",
    "EMANormalizer",
    "EvalConfig",
    "Metric",
    "ObservationsCaster",
    "ObservationsEMANormalizer",
    "ObservationsPreprocess",
    "ObservationsPreprocessNoop",
    "PBTConfig",
    "PBTMatchmakeConfig",
    "PPOConfig",
    "ParamExplore",
    "Policy",
    "RecurrentBackboneEncoder",
    "RolloutConfig",
    "RolloutData",
    "RolloutManager",
    "RolloutState",
    "TensorboardWriter",
    "TrainConfig",
    "TrainHooks",
    "TrainStateManager",
    "TrainingManager",
    "TrainingMetrics",
    "WandbWriter",
    "eval_elo",
    "eval_load_ckpt",
    "eval_policies",
    "init_training",
    "latest_checkpoint",
    "pbt_cull_update",
    "pbt_explore_hyperparams",
    "pbt_init_matchmaking",
    "pbt_past_update",
    "pbt_update_elo",
    "pbt_update_fitness",
    "pbt_update_matchmaking",
    "profile",
    "rollout_loop",
    "rollouts_reset",
    "stop_training",
    "update_population",
    "wait_for_checkpoints",
]
