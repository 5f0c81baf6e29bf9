"""Actor and critic heads (JAX: madrona_learn_tpu/models/critics.py).

The discrete dense actor, the dict actor over named action heads, the
scalar dense critic, the DreamerV3 two-hot critic, the HL-Gauss critic
(linear bins) and the two-part HL-Gauss critic (bins spaced like a tiny
float format). Bin tables are built in numpy, bitwise the JAX package's,
and kept on each critic as buffers outside its state dict.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..config import DiscreteActionsConfig
from ..ops.dists import (
    DictActionDistributions,
    DiscreteActionDistributions,
    HLGaussDist,
    HLGaussTwoPartDist,
    SymExpTwoHotDistribution,
)
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

    def chunked(self, params, layout, features):
        return DiscreteActionDistributions(
            self.cfg.actions_num_buckets,
            self.impl.chunked(params.child("impl"), layout, features))

    def batched(self, params, features):
        """The distributions of [P, rows, ...] features, their logits
        flattened to [P * rows, ...]."""
        logits = self.impl.batched(params.child("impl"), features)
        return DiscreteActionDistributions(
            self.cfg.actions_num_buckets,
            logits.reshape(-1, logits.shape[-1]))


class DictActor(nn.Module):
    """One head per ``TrainConfig.actions`` key; samples come back as a
    matching ``{name: tensor}`` dict, the layout the sim step consumes."""

    def __init__(self, heads: Dict[str, nn.Module]):
        super().__init__()
        self.heads = nn.ModuleDict(heads)

    def forward(self, features):
        return DictActionDistributions(
            {name: head(features) for name, head in self.heads.items()})

    def chunked(self, params, layout, features):
        heads = params.child("heads")
        return DictActionDistributions(
            {name: head.chunked(heads.child(name), layout, features)
             for name, head in self.heads.items()})

    def batched(self, params, features):
        heads = params.child("heads")
        return DictActionDistributions(
            {name: head.batched(heads.child(name), features)
             for name, head in self.heads.items()})


class DenseLayerCritic(nn.Module):
    def __init__(self, in_features: int, dtype,
                 weight_init: Callable = orthogonal(1.0),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.Dense_0 = Dense(in_features, 1, dtype, use_bias=True,
                             kernel_init=weight_init, generator=generator)

    def forward(self, features):
        return self.Dense_0(features).to(torch.float32)

    def chunked(self, params, layout, features):
        return self.Dense_0.chunked(params.child("Dense_0"), layout,
                                    features).to(torch.float32)

    def batched(self, params, features):
        return self.Dense_0.batched(params.child("Dense_0"),
                                    features).to(torch.float32)


def _zeros(shape, generator):
    return torch.zeros(shape, dtype=torch.float32)


class DreamerV3Critic(nn.Module):
    """Two-hot symexp critic; the zero-init head makes the mean start at
    exactly 0."""

    def __init__(self, in_features: int, dtype, num_bins: int = 63):
        super().__init__()
        self.Dense_0 = Dense(in_features, num_bins, dtype, use_bias=True,
                             kernel_init=_zeros)

    def forward(self, features):
        return SymExpTwoHotDistribution.create(self.Dense_0(features))


def make_hlgauss_bins(num_bins: int = 127, min_bound: float = -100,
                      max_bound: float = 100):
    """Symmetric linear bins: float32 centers [num_bins] and bounds
    [num_bins + 1]. ``max_bound`` is unused: the bins mirror
    ``min_bound``, as in the JAX package."""
    half = np.linspace(min_bound, 0, num_bins // 2 + 1)
    centers = np.concatenate([half, -half[:-1][::-1]], axis=0)
    width = centers[1] - centers[0]
    bounds = centers - 0.5 * width
    bounds = np.concatenate([bounds, [bounds[-1] + width]], axis=0)
    return (torch.from_numpy(centers.astype(np.float32)),
            torch.from_numpy(bounds.astype(np.float32)))


def _make_float_format_bins(num_mantissa_bits: int, num_exp_bits: int,
                            bias: int, denorm: bool):
    """Bins spaced like a tiny float format: dense near 0, sparse far out."""
    half, widths = [], []
    for exp in range(2 ** num_exp_bits):
        if denorm and exp == 0:
            scale = 2.0 ** (1 - bias)
        else:
            scale = 2.0 ** (exp - bias)
        width = scale / (2 ** num_mantissa_bits)
        for mantissa in range(2 ** num_mantissa_bits):
            frac = mantissa / (2 ** num_mantissa_bits)
            if denorm and exp == 0:
                half.append(frac * scale)
            elif exp == 0 and mantissa == 0:
                half.append(0.0)
            else:
                half.append((1 + frac) * scale)
            widths.append(width)

    half = np.asarray(half, np.float32)
    centers = np.concatenate([-half[:0:-1], half])
    widths = np.asarray(widths, np.float32)
    widths = np.concatenate([widths[:0:-1], widths])
    bounds = centers - 0.5 * widths
    bounds = np.concatenate([bounds, [bounds[-1] + widths[-1]]])
    return (torch.from_numpy(centers.astype(np.float32)),
            torch.from_numpy(bounds.astype(np.float32)))


def make_hlgauss_two_part_bins():
    """(small, large) bin tables of the two-part critic: small covers the
    fractional range with an fp(3, 3) layout biased toward tiny magnitudes,
    large the integer range."""
    small = _make_float_format_bins(3, 3, bias=2 ** 3 - 1, denorm=True)
    large = _make_float_format_bins(3, 3, bias=-3, denorm=True)
    return small, large


class HLGaussCritic(nn.Module):
    """HL-Gauss critic over ``centers`` / ``bounds``; the zero-init head
    starts from the uniform distribution, whose mean is exactly 0."""

    def __init__(self, in_features: int, dtype, centers: torch.Tensor,
                 bounds: torch.Tensor, smoothness: float = 0.75):
        super().__init__()
        self.smoothness = smoothness
        self.register_buffer("centers", centers, persistent=False)
        self.register_buffer("bounds", bounds, persistent=False)
        self.Dense_0 = Dense(in_features, centers.shape[0], dtype,
                             use_bias=True, kernel_init=_zeros)

    @staticmethod
    def create(in_features: int, dtype, num_bins: int = 127,
               min_bound=-100, max_bound=100,
               smoothness: float = 0.75) -> "HLGaussCritic":
        centers, bounds = make_hlgauss_bins(num_bins, min_bound, max_bound)
        return HLGaussCritic(in_features, dtype, centers, bounds, smoothness)

    def forward(self, features):
        return HLGaussDist(self.Dense_0(features).to(torch.float32),
                           self.smoothness, self.centers, self.bounds)


class HLGaussTwoPartCritic(nn.Module):
    """Two zero-init heads, ``small`` and ``large``, over the two-part
    bins; the value is the sum of their means."""

    def __init__(self, in_features: int, dtype, small_centers, small_bounds,
                 large_centers, large_bounds, smoothness: float = 0.75):
        super().__init__()
        self.smoothness = smoothness
        for name, t in (("small_centers", small_centers),
                        ("small_bounds", small_bounds),
                        ("large_centers", large_centers),
                        ("large_bounds", large_bounds)):
            self.register_buffer(name, t, persistent=False)
        self.small = Dense(in_features, small_centers.shape[0], dtype,
                           use_bias=True, kernel_init=_zeros)
        self.large = Dense(in_features, large_centers.shape[0], dtype,
                           use_bias=True, kernel_init=_zeros)

    @staticmethod
    def create(in_features: int, dtype,
               smoothness: float = 0.75) -> "HLGaussTwoPartCritic":
        (sc, sb), (lc, lb) = make_hlgauss_two_part_bins()
        return HLGaussTwoPartCritic(in_features, dtype, sc, sb, lc, lb,
                                    smoothness)

    def forward(self, features):
        return HLGaussTwoPartDist(
            small_dist=HLGaussDist(self.small(features).to(torch.float32),
                                   self.smoothness, self.small_centers,
                                   self.small_bounds),
            large_dist=HLGaussDist(self.large(features).to(torch.float32),
                                   self.smoothness, self.large_centers,
                                   self.large_bounds))
