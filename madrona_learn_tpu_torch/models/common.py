"""Shared building blocks: Dense, LayerNorm and the MLP trunk.

JAX: madrona_learn_tpu/models/common.py. Parameters keep the flax layout
and names so the two packages compare like with like: Dense kernels are
``[in, out]`` and applied as ``x @ kernel``, and LayerNorm owns
``impl.scale`` / ``impl.bias`` (the PPO update renormalizes modules named
``LayerNorm_*`` by that path). Parameters are float32; ``dtype`` is the
compute dtype every layer casts its operands to, as flax's ``dtype=`` does.
Unlike flax, torch modules are shaped eagerly, so each takes its input
width.

Policy-batched forms (JAX: the ``vmap`` of a policy over its population's
chunks, ``rollouts.py:580-591``): a module's ``chunked(params, layout,
...)`` runs the module over chunk-order inputs ``[B, C, ...]`` (B chunks of
C rows, each of one policy) with the parameters of ``params``, a
``StackedParams`` of the population (this module's own parameters are not
read: it gives the structure only), chunk b with policy
``layout.chunk_policy[b]``'s. Products go through ``grouped_matmul``,
which indexes the weight stacks by chunk; per-policy vectors (biases,
LayerNorm scale and shift) are gathered per chunk and broadcast over its
rows; the arithmetic is the per-policy forward's, op for op.
``chunked_form_missing`` names the first module of a tree without such a
form.

Policy-batched learn forms (JAX: the ``vmap`` of ``algo.update`` over the
train policies, ``train.py:315``): a module's ``batched(params, ...)``
runs the module's update-pass forward over policy-major inputs ``[P, rows,
...]``, policy p's rows with policy p's parameters of ``params``, a
``StackedParams`` of the train policies whose leaves require grad (a
fresh one a minibatch, so that no cast outlives an optimizer step).
Every train policy has the same rows in learn, so products are ``torch.bmm`` over ``[P, rows, in] x [P, in, out]``
(JAX's ``vmap`` of ``Dense`` is a batched ``dot_general``) and per-policy
vectors broadcast over the rows; LayerNorm stays plain PyTorch, as on the
single-policy learn path, but ``LayerNorm(use_kernel=True)``, whose
chunked and batched forms run the ``layer_norm`` kernels' chunk-indexed
instances (JAX ``vmap``s its Pallas LayerNorm). ``batched_form_missing``
names the first module without one.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn

from ..ops.cuda.grouped_matmul import grouped_matmul
from ..ops.cuda.layer_norm import layer_norm, layer_norm_chunked
from ..utils.profile import profile

# The compute dtypes of the policy-batched forms: grouped_matmul's.
CHUNKED_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


class StackedParams:
    """A population's parameters as ``[P, ...]`` stacks, one a parameter
    path of ``named_parameters``, seen from one module (``child``).

    ``stack`` casts a stack to a compute dtype on first use and keeps the
    cast (and a reshaped view of it, where asked), so a stacked view built
    once per collect casts and reshapes each weight once; ``per_chunk``
    gathers each chunk's row of a stack by the layout's ``chunk_index``,
    shaped to broadcast over the chunk's rows.
    """

    def __init__(self, leaves, prefix: str = "", casts=None):
        self.leaves = leaves
        self.prefix = prefix
        self.casts = {} if casts is None else casts

    @staticmethod
    def of(modules) -> "StackedParams":
        """One ``torch.stack`` a parameter over ``modules``, copies."""
        named = [dict(m.named_parameters()) for m in modules]
        with torch.no_grad():
            return StackedParams({name: torch.stack([n[name] for n in named])
                                  for name in named[0]})

    def child(self, name: str) -> "StackedParams":
        return StackedParams(self.leaves, f"{self.prefix}{name}.",
                             self.casts)

    def stack(self, name: str, dtype=None, shape=None) -> torch.Tensor:
        """The ``[P, ...]`` stack of parameter ``name``, in ``dtype``, seen
        as ``[P, *shape]`` where ``shape`` is given."""
        key = (self.prefix + name, dtype, shape)
        x = self.casts.get(key)
        if x is None:
            if shape is None:
                x = self.leaves[self.prefix + name]
                x = (x if dtype is None else x.to(dtype)).contiguous()
            else:
                x = self.stack(name, dtype)
                x = x.reshape(x.shape[0], *shape)
            self.casts[key] = x
        return x

    def per_chunk(self, name: str, dtype, layout, ndim: int,
                  shape=None) -> torch.Tensor:
        """Each chunk's ``name`` (seen as ``shape`` where given), ``[B, 1,
        ..., *shape]`` with ``ndim`` dims in all, to broadcast over a
        ``[B, C, ...]`` tensor."""
        with profile("Gather Chunk Weights"):
            x = self.stack(name, dtype, shape)[layout.chunk_index]
        return x.reshape(x.shape[0], *[1] * (ndim - x.dim()), *x.shape[1:])

    def per_policy(self, name: str, dtype, ndim: int,
                   shape=None) -> torch.Tensor:
        """The ``[P, ...]`` stack of ``name`` (seen as ``shape`` where
        given), ``[P, 1, ..., *shape]`` with ``ndim`` dims in all, to
        broadcast over a ``[P, rows, ...]`` tensor."""
        x = self.stack(name, dtype, shape)
        return x.reshape(x.shape[0], *[1] * (ndim - x.dim()), *x.shape[1:])


def _form_missing(module: nn.Module, forms, supported_attr) -> Optional[str]:
    """The first module of ``module``'s tree (path and class) whose class
    defines none of ``forms``, or whose ``supported_attr()``, where
    defined, is false; ``None`` if there is none."""
    for name, m in module.named_modules():
        if isinstance(m, (nn.ModuleDict, nn.ModuleList)):
            continue
        has_form = any(hasattr(type(m), f) for f in forms)
        supported = getattr(m, supported_attr, lambda: True)
        if not (has_form and supported()):
            return f"{name or 'the actor-critic'} ({type(m).__name__})"
    return None


def chunked_form_missing(module: nn.Module) -> Optional[str]:
    """The first module of ``module``'s tree (path and class) without a
    policy-batched form, or ``None`` if every one has one. A module has one
    when its class defines ``chunked`` (``rollout_chunked`` for the
    actor-critic) and ``chunked_supported()``, where defined, is true."""
    return _form_missing(module, ("chunked", "rollout_chunked"),
                         "chunked_supported")


def batched_form_missing(module: nn.Module) -> Optional[str]:
    """The first module of ``module``'s tree without a policy-batched learn
    form, or ``None``: a module has one when its class defines ``batched``
    (``update_batched`` for the actor-critic) and ``batched_supported()``,
    where defined, is true."""
    return _form_missing(module, ("batched", "update_batched"),
                         "batched_supported")


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

    def chunked_supported(self):
        return self.dtype in CHUNKED_DTYPES

    def chunked(self, params, layout, x):
        """``x`` [B, C, ..., in] -> [B, C, ..., out]: the product through
        ``grouped_matmul``, then the chunk's bias."""
        lead = x.shape[:-1]
        x3 = x.to(self.dtype).reshape(lead[0], -1, x.shape[-1]).contiguous()
        y = grouped_matmul(x3, params.stack("kernel", self.dtype),
                           layout.chunk_policy)
        y = y.reshape(*lead, y.shape[-1])
        if self.bias is not None:
            y = y + params.per_chunk("bias", self.dtype, layout, y.dim())
        return y

    batched_supported = chunked_supported

    def batched(self, params, x):
        """``x`` [P, ..., in] -> [P, ..., out]: ``torch.bmm`` against the
        ``[P, in, out]`` kernel stack, then each policy's bias."""
        lead = x.shape[:-1]
        y = torch.bmm(x.to(self.dtype).reshape(lead[0], -1, x.shape[-1]),
                      params.stack("kernel", self.dtype))
        y = y.reshape(*lead, y.shape[-1])
        if self.bias is not None:
            y = y + params.per_policy("bias", self.dtype, y.dim())
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
        return self._normalize(x, self.scale, self.bias)

    def _normalize(self, x, scale, bias):
        x32 = x.to(torch.float32)
        mean = x32.mean(dim=-1, keepdim=True)
        mean2 = (x32 * x32).mean(dim=-1, keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * scale
        y = (x32 - mean) * mul + bias
        return y.to(self.dtype)

    def chunked(self, params, layout, x):
        """The forward's arithmetic with each chunk's scale and bias."""
        return self._normalize(
            x, params.per_chunk("scale", None, layout, x.dim()),
            params.per_chunk("bias", None, layout, x.dim()))

    def batched(self, params, x):
        """The forward's arithmetic with each policy's scale and bias."""
        return self._normalize(x, params.per_policy("scale", None, x.dim()),
                               params.per_policy("bias", None, x.dim()))


class LayerNorm(nn.Module):
    """Row LayerNorm with flax ``nn.LayerNorm``'s numerics, wrapped as the
    JAX package's ``LayerNorm`` wraps it (its parameters ``impl.scale`` /
    ``impl.bias``).

    ``use_kernel=True`` (JAX: ``use_pallas``) runs the ``layer_norm``
    kernel pair instead, over x reshaped to ``[-1, D]``: a two-pass
    variance, and the result in x's dtype, as JAX's ``_PallasLNImpl``. The
    parameters are the same ``impl.scale`` / ``impl.bias`` either way. Its
    policy-batched forms run the pair's chunk-indexed instances
    (``layer_norm_chunked``): ``chunked`` over the chunks' rows, each with
    its chunk's policy's scale and bias, ``batched`` over the train
    policies' rows as one chunk a policy.
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

    def _kernel_chunks(self, params, x, chunk_policy):
        """``x`` [B, ...] of B chunks through ``layer_norm_chunked``, chunk
        b with policy ``chunk_policy[b]``'s scale and bias."""
        impl = params.child("impl")
        out = layer_norm_chunked(x.reshape(-1, x.shape[-1]).contiguous(),
                                 impl.stack("scale"), impl.stack("bias"),
                                 chunk_policy, self.impl.eps)
        return out.reshape(x.shape)

    def chunked(self, params, layout, x):
        if self.use_kernel:
            return self._kernel_chunks(params, x, layout.chunk_policy)
        return self.impl.chunked(params.child("impl"), layout, x)

    def batched(self, params, x):
        if self.use_kernel:
            return self._kernel_chunks(
                params, x, torch.arange(x.shape[0], dtype=torch.int32,
                                        device=x.device))
        return self.impl.batched(params.child("impl"), x)


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

    def chunked(self, params, layout, x):
        for i in range(self.num_layers):
            for name in (f"Dense_{i}", f"LayerNorm_{i}"):
                x = getattr(self, name).chunked(params.child(name), layout, x)
            x = torch.relu(x)
        return x

    def batched(self, params, x):
        for i in range(self.num_layers):
            for name in (f"Dense_{i}", f"LayerNorm_{i}"):
                x = getattr(self, name).batched(params.child(name), x)
            x = torch.relu(x)
        return x
