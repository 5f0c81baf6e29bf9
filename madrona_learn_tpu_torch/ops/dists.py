"""Action and return distributions (JAX: madrona_learn_tpu/ops/dists.py).

``DiscreteActionDistributions`` is a multi-head categorical over one
concatenated logits tensor; ``DictActionDistributions`` maps action names to
such heads, the layout the simulator contract uses.
``SymExpTwoHotDistribution`` is the DreamerV3 critic's two-hot categorical
over symexp-spaced bins; ``HLGaussDist`` is the HL-Gauss critic's
categorical over fixed bins, trained on Gaussian-smoothed labels, and
``HLGaussTwoPartDist`` the sum of a fine and a coarse one. All log-prob
and entropy math runs in float32 whatever the compute dtype: logits are
upcast before the logsumexp, which keeps PPO's ratio stable in bf16.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from ..utils import symexp

_F32 = torch.float32


def categorical(logits, generator: Optional[torch.Generator]):
    """One sample per row of f32 ``logits`` [..., K] by the Gumbel-max
    trick, drawn from ``generator``; returns int64 [..., 1]."""
    u = torch.rand(logits.shape, dtype=_F32, device=logits.device,
                   generator=generator)
    u = u.clamp(min=torch.finfo(_F32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1,
                        keepdim=True)


@dataclass
class DiscreteActionDistributions:
    actions_num_buckets: List[int]
    all_logits: torch.Tensor

    def _head_logits(self):
        offset = 0
        for num_buckets in self.actions_num_buckets:
            yield self.all_logits[..., offset:offset + num_buckets].to(_F32)
            offset += num_buckets

    def sample(self, generator):
        actions, log_probs = [], []
        for logits in self._head_logits():
            action = categorical(logits, generator)
            log_probs.append(
                torch.gather(logits, -1, action)
                - torch.logsumexp(logits, dim=-1, keepdim=True))
            actions.append(action.to(torch.int32))
        return torch.cat(actions, dim=-1), torch.cat(log_probs, dim=-1)

    def best(self):
        return torch.cat([torch.argmax(l, dim=-1, keepdim=True).to(torch.int32)
                          for l in self._head_logits()], dim=-1)

    def action_stats(self, all_actions):
        """Log-probs of stored actions and per-head entropies."""
        log_probs, entropies = [], []
        for i, logits in enumerate(self._head_logits()):
            lp = logits - torch.logsumexp(logits, dim=-1, keepdim=True)
            entropies.append(
                -(torch.softmax(logits, dim=-1) * lp).sum(-1, keepdim=True))
            action = all_actions[..., i:i + 1].to(torch.int64)
            log_probs.append(torch.gather(lp, -1, action))
        return torch.cat(log_probs, dim=-1), torch.cat(entropies, dim=-1)


@dataclass
class DictActionDistributions:
    """Named action distributions: the actor's output."""

    dists: Dict[str, DiscreteActionDistributions]

    def sample(self, generator):
        actions, log_probs = {}, {}
        for name in sorted(self.dists):
            actions[name], log_probs[name] = self.dists[name].sample(
                generator)
        return actions, log_probs

    def best(self):
        return {k: d.best() for k, d in self.dists.items()}

    def action_stats(self, all_actions):
        log_probs, entropies = {}, {}
        for name, dist in self.dists.items():
            log_probs[name], entropies[name] = dist.action_stats(
                all_actions[name])
        return log_probs, entropies


def _log_softmax(logits):
    return logits - torch.logsumexp(logits, dim=-1, keepdim=True)


def _symmetric_weighted_sum(probs, bins):
    """Sum p_i * b_i pairing bins symmetric about the midpoint, so that the
    mean of a uniform distribution over symmetric bins is exactly 0."""
    midpoint = (bins.shape[-1] - 1) // 2
    p_lo, p_mid, p_hi = (probs[..., :midpoint],
                         probs[..., midpoint:midpoint + 1],
                         probs[..., midpoint + 1:])
    b_lo, b_mid, b_hi = (bins[..., :midpoint],
                         bins[..., midpoint:midpoint + 1],
                         bins[..., midpoint + 1:])
    return ((p_mid * b_mid).sum(-1, keepdim=True)
            + ((p_lo * b_lo).flip(-1) + p_hi * b_hi).sum(-1, keepdim=True))


@dataclass
class SymExpTwoHotDistribution:
    """DreamerV3 two-hot categorical over ``symexp(linspace(-14, 0))`` bins,
    mirrored about 0."""

    logits: torch.Tensor

    @staticmethod
    def create(logits):
        return SymExpTwoHotDistribution(logits=logits.to(_F32))

    def _compute_bins(self):
        num_bins = self.logits.shape[-1]
        assert num_bins % 2 == 1 and num_bins > 1
        # jnp.linspace(-14, 0)'s f32 points as XLA computes them, start *
        # (1 - step) with step = i * (1 / div) and the endpoint 0 appended;
        # torch.linspace rounds some points differently.
        div = num_bins // 2
        step = (torch.arange(div, dtype=_F32, device=self.logits.device)
                * (1.0 / div))
        lin = torch.cat([-14.0 * (1 - step),
                         torch.zeros(1, dtype=_F32, device=step.device)])
        half = symexp(lin)
        return torch.cat([half, -half[:-1].flip(0)])

    def mean(self):
        return _symmetric_weighted_sum(torch.softmax(self.logits, dim=-1),
                                       self._compute_bins())

    def two_hot_cross_entropy_loss(self, targets):
        """Cross entropy against the two-hot encoding of f32 ``targets``
        [..., 1]. The closer bin gets the larger weight (the JAX package's
        corrected DreamerV3 weighting), so the encoding's mean is the
        target; targets outside the bins go wholly to the edge bin."""
        assert targets.dtype == _F32
        bins = self._compute_bins()
        num_bins = bins.shape[-1]
        lower_idx = (bins <= targets).sum(-1) - 1
        upper_idx = num_bins - (bins > targets).sum(-1)
        lower_idx = lower_idx.clamp(0, num_bins - 1)
        upper_idx = upper_idx.clamp(0, num_bins - 1)

        same_bin = (lower_idx == upper_idx)[..., None]
        dist_lower = torch.where(same_bin, 1.0,
                                 (bins[lower_idx][..., None] - targets).abs())
        dist_upper = torch.where(same_bin, 1.0,
                                 (bins[upper_idx][..., None] - targets).abs())
        total = dist_lower + dist_upper
        one_hot = torch.nn.functional.one_hot
        target_two_hot = (
            one_hot(lower_idx, num_bins) * (dist_upper / total)
            + one_hot(upper_idx, num_bins) * (dist_lower / total))
        return -(target_two_hot * _log_softmax(self.logits)).sum(
            -1, keepdim=True)

    def merge_time(self, T: int, N: int) -> "SymExpTwoHotDistribution":
        """[T*N, bins] logits -> [T, N, bins]."""
        return SymExpTwoHotDistribution(
            self.logits.reshape(T, N, self.logits.shape[-1]))


@dataclass
class HLGaussDist:
    """Histogram-Gaussian return distribution ("Stop Regressing"): soft
    labels integrate a Gaussian of sigma = smoothness x the target's bin
    width over the bin bounds through erf CDFs. ``centers`` [K] and
    ``bounds`` [K + 1] are float32 and mirrored about 0."""

    logits: torch.Tensor
    smoothness: float
    centers: torch.Tensor
    bounds: torch.Tensor

    def mean(self):
        return _symmetric_weighted_sum(torch.softmax(self.logits, dim=-1),
                                       self.centers)

    def loss(self, targets):
        """Cross entropy against the soft labels of f32 ``targets``
        [..., 1], clipped to the outer centers."""
        centers, bounds = self.centers, self.bounds
        targets = torch.minimum(torch.maximum(targets, centers[0]),
                                centers[-1])
        num_bounds = bounds.shape[-1]
        lower_idx = (bounds <= targets).sum(-1) - 1
        upper_idx = torch.clamp(lower_idx + 1, 1, num_bounds - 1)
        lower_idx = torch.clamp(lower_idx, 0, num_bounds - 2)
        width = bounds[upper_idx] - bounds[lower_idx]
        sigmas = self.smoothness * width[..., None]
        cdfs = torch.erf((bounds - targets) / (math.sqrt(2.0) * sigmas))
        z = cdfs[..., -1:] - cdfs[..., :1]
        soft_labels = (cdfs[..., 1:] - cdfs[..., :-1]) / z
        return -(soft_labels * _log_softmax(self.logits)).sum(
            -1, keepdim=True)

    def merge_time(self, T: int, N: int) -> "HLGaussDist":
        """[T*N, bins] logits -> [T, N, bins]."""
        return HLGaussDist(self.logits.reshape(T, N, self.logits.shape[-1]),
                           self.smoothness, self.centers, self.bounds)


@dataclass
class HLGaussTwoPartDist:
    """A fine small-range and a coarse large-range HL-Gauss distribution,
    summed: the target splits into its remainder in (-2, 2) and the rest."""

    small_dist: HLGaussDist
    large_dist: HLGaussDist

    def mean(self):
        return self.small_dist.mean() + self.large_dist.mean()

    def loss(self, targets):
        # Floored modulo by 2 with the target's sign (JAX's %), not fmod.
        small_tgt = torch.remainder(targets,
                                    torch.where(targets >= 0, 2.0, -2.0))
        large_tgt = targets - small_tgt
        return self.small_dist.loss(small_tgt) + self.large_dist.loss(
            large_tgt)

    def merge_time(self, T: int, N: int) -> "HLGaussTwoPartDist":
        return HLGaussTwoPartDist(self.small_dist.merge_time(T, N),
                                  self.large_dist.merge_time(T, N))
