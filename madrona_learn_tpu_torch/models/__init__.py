"""Model building blocks of the port (JAX: madrona_learn_tpu/models)."""

from .actor_critic import ActorCritic, BackboneShared, RecurrentBackboneEncoder
from .common import MLP, Dense, LayerNorm
from .critics import DenseLayerCritic, DenseLayerDiscreteActor, DictActor
from .lstm import LSTM

__all__ = [
    "ActorCritic",
    "BackboneShared",
    "Dense",
    "DenseLayerCritic",
    "DenseLayerDiscreteActor",
    "DictActor",
    "LayerNorm",
    "LSTM",
    "MLP",
    "RecurrentBackboneEncoder",
]
