"""Discrete action distributions (JAX: madrona_learn_tpu/ops/dists.py).

``DiscreteActionDistributions`` is a multi-head categorical over one
concatenated logits tensor; ``DictActionDistributions`` maps action names to
such heads, the layout the simulator contract uses. All log-prob and
entropy math runs in float32 whatever the compute dtype: logits are upcast
before the logsumexp, which keeps PPO's ratio stable in bf16.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

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
