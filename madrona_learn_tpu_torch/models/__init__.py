"""Model building blocks of the port (JAX: madrona_learn_tpu/models)."""

from .actor_critic import ActorCritic, BackboneShared, RecurrentBackboneEncoder
from .attention import EntitySelfAttentionNet, SelfAttention
from .common import MLP, Dense, LayerNorm
from .critics import (
    DenseLayerCritic,
    DenseLayerDiscreteActor,
    DictActor,
    DreamerV3Critic,
    HLGaussCritic,
    HLGaussTwoPartCritic,
    make_hlgauss_bins,
    make_hlgauss_two_part_bins,
)
from .gru import GRU
from .lstm import LSTM

__all__ = [
    "ActorCritic",
    "BackboneShared",
    "Dense",
    "DenseLayerCritic",
    "DenseLayerDiscreteActor",
    "DictActor",
    "DreamerV3Critic",
    "EntitySelfAttentionNet",
    "GRU",
    "HLGaussCritic",
    "HLGaussTwoPartCritic",
    "LayerNorm",
    "LSTM",
    "MLP",
    "RecurrentBackboneEncoder",
    "SelfAttention",
    "make_hlgauss_bins",
    "make_hlgauss_two_part_bins",
]
