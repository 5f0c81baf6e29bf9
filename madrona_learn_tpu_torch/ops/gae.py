"""Advantages and discounted returns (JAX: madrona_learn_tpu/ops/gae.py).

Inputs arrive in the trajectory-store layout ``[C, T/C, P, B, 1]``; the
recurrence runs over the full ``T = C * T/C`` time axis.

``compute_advantages`` is the one in ``ops/cuda/gae.py``: it takes the plain
version (``gae_reference``) for CPU tensors and launches the GAE kernel for
CUDA tensors.
"""

from __future__ import annotations

import torch

from .cuda.gae import compute_advantages

__all__ = ["compute_advantages", "compute_returns", "zscore_data"]

_F32 = torch.float32


def _as_float(x):
    return x if x.is_floating_point() else x.to(_F32)


def compute_returns(gamma, rewards, dones, bootstrap_values):
    """Discounted returns with done masking, bootstrapped from the final
    value."""
    C, TC, P, B = dones.shape[:4]
    T = C * TC
    seq_dones = dones.reshape(T, -1, 1)
    seq_rewards = _as_float(rewards.reshape(T, -1, 1))
    next_return = _as_float(bootstrap_values.reshape(-1, 1))
    out = []
    for t in range(T - 1, -1, -1):
        next_return = torch.where(seq_dones[t], 0, next_return)
        next_return = seq_rewards[t] + gamma * next_return
        out.append(next_return)
    return torch.stack(out[::-1]).reshape(C, TC, P, B, 1)


def zscore_data(data):
    """Z-score in float32 with the variance floored at 1e-5."""
    mean = data.to(_F32).mean().to(data.dtype)
    var = data.to(_F32).var(unbiased=False).to(data.dtype)
    return (data - mean) * torch.rsqrt(torch.clamp(var, min=1e-5))
