"""Shared building blocks: Dense, LayerNorm and the MLP trunk.

JAX: madrona_learn_tpu/models/common.py. Parameters keep the flax layout
and names so the two packages compare like with like: Dense kernels are
``[in, out]`` and applied as ``x @ kernel``, and LayerNorm owns
``impl.scale`` / ``impl.bias`` (the PPO update renormalizes modules named
``LayerNorm_*`` by that path). Parameters are float32; ``dtype`` is the
compute dtype every layer casts its operands to, as flax's ``dtype=`` does.
Unlike flax, torch modules are shaped eagerly, so each takes its input
width.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn

from ..ops.cuda.layer_norm import layer_norm


def orthogonal(scale: float = 1.0) -> Callable:
    """Orthogonal initializer for an ``[in, out]`` kernel."""

    def init(shape, generator):
        w = torch.empty(shape, dtype=torch.float32)
        nn.init.orthogonal_(w, gain=scale, generator=generator)
        return w

    return init


def orthogonal_gates(num_gates: int, hidden: int) -> Callable:
    """Per-gate orthogonal ``[in, hidden]`` blocks packed along the last
    axis (the recurrent layers' gate-packed kernels)."""

    def init(shape, generator):
        blocks = []
        for _ in range(num_gates):
            w = torch.empty((shape[0], hidden), dtype=torch.float32)
            nn.init.orthogonal_(w, generator=generator)
            blocks.append(w)
        return torch.cat(blocks, dim=-1)

    return init


class Dense(nn.Module):
    """``x @ kernel (+ bias)`` in the compute dtype (flax ``nn.Dense``)."""

    def __init__(self, in_features: int, out_features: int, dtype,
                 use_bias: bool = True, kernel_init: Callable = orthogonal(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(
            kernel_init((in_features, out_features), generator))
        self.bias = (nn.Parameter(torch.zeros(out_features))
                     if use_bias else None)

    def forward(self, x):
        y = x.to(self.dtype) @ self.kernel.to(self.dtype)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class FlaxLayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=...)`` itself, parameters ``scale`` /
    ``bias``: mean and variance in float32 (variance as ``E[x^2] -
    E[x]^2``, clamped at 0), the normalize and affine in float32, and the
    result rounded once to the compute dtype."""

    def __init__(self, dim: int, dtype, eps: float = 1e-6):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        x32 = x.to(torch.float32)
        mean = x32.mean(dim=-1, keepdim=True)
        mean2 = (x32 * x32).mean(dim=-1, keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale
        y = (x32 - mean) * mul + self.bias
        return y.to(self.dtype)


class LayerNorm(nn.Module):
    """Row LayerNorm with flax ``nn.LayerNorm``'s numerics, wrapped as the
    JAX package's ``LayerNorm`` wraps it (its parameters ``impl.scale`` /
    ``impl.bias``).

    ``use_kernel=True`` (JAX: ``use_pallas``) runs the ``layer_norm``
    kernel pair instead, over x reshaped to ``[-1, D]``: a two-pass
    variance, and the result in x's dtype, as JAX's ``_PallasLNImpl``. The
    parameters are the same ``impl.scale`` / ``impl.bias`` either way.
    """

    def __init__(self, dim: int, dtype, eps: float = 1e-6,
                 use_kernel: bool = False):
        super().__init__()
        self.use_kernel = use_kernel
        self.impl = FlaxLayerNorm(dim, dtype, eps)

    def forward(self, x):
        if self.use_kernel:
            out = layer_norm(x.reshape(-1, x.shape[-1]).contiguous(),
                             self.impl.scale, self.impl.bias, self.impl.eps)
            return out.reshape(x.shape)
        return self.impl(x)


class MLP(nn.Module):
    """Dense (no bias) -> LayerNorm -> ReLU stack, orthogonal init."""

    def __init__(self, in_features: int, num_channels: int, num_layers: int,
                 dtype, weight_init: Callable = orthogonal(math.sqrt(2)),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_channels = num_channels
        self.num_layers = num_layers
        self.dtype = dtype
        width = in_features
        for i in range(num_layers):
            self.add_module(f"Dense_{i}", Dense(
                width, num_channels, dtype, use_bias=False,
                kernel_init=weight_init, generator=generator))
            self.add_module(f"LayerNorm_{i}", LayerNorm(num_channels, dtype))
            width = num_channels

    def forward(self, x):
        for i in range(self.num_layers):
            x = getattr(self, f"Dense_{i}")(x)
            x = getattr(self, f"LayerNorm_{i}")(x)
            x = torch.relu(x)
        return x
