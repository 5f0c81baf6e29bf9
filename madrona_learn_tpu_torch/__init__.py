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
policies (``eval.py``). Its kernels are hand-written
CUDA for Hopper (``csrc/``), each with a plain PyTorch twin that CPU tensors
take. Module names mirror the JAX package's, which stays the reference.
"""

from .config import (ContinuousActionsConfig, DiscreteActionsConfig,
                     EvalConfig, ParamExplore, PBTConfig, TrainConfig)
from .eval import eval_load_ckpt, eval_policies
from .models import (ActorCritic, BackboneEncoder, BackboneSeparate,
                     BackboneShared, RecurrentBackboneEncoder)
from .observations import (ObservationsCaster, ObservationsEMANormalizer,
                           ObservationsPreprocess,
                           ObservationsPreprocessNoop)
from .pbt import (PBTMatchmakeConfig, pbt_cull_update,
                  pbt_explore_hyperparams, pbt_init_matchmaking,
                  pbt_past_update, pbt_update_elo, pbt_update_fitness,
                  pbt_update_matchmaking)
from .policy import Policy
from .ppo import PPOConfig
from .rollouts import (RolloutConfig, RolloutData, RolloutManager,
                       RolloutState, rollout_loop, rollouts_reset)
from .train import (TrainHooks, TrainingManager, eval_elo, init_training,
                    latest_checkpoint, update_population)
from .train_state import TrainStateManager, wait_for_checkpoints

__all__ = [
    "ActorCritic",
    "BackboneEncoder",
    "BackboneSeparate",
    "BackboneShared",
    "ContinuousActionsConfig",
    "DiscreteActionsConfig",
    "EvalConfig",
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
    "TrainConfig",
    "TrainHooks",
    "TrainStateManager",
    "TrainingManager",
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
    "rollout_loop",
    "rollouts_reset",
    "update_population",
    "wait_for_checkpoints",
]
