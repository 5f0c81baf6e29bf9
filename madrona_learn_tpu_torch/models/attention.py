"""Entity self-attention (JAX: madrona_learn_tpu/models/attention.py).

``SelfAttention`` pads the entity axis to a multiple of 8, runs flax's
``MultiHeadDotProductAttention`` layout (``query`` / ``key`` / ``value``
projections with kernels ``[F, heads, head_dim]`` and biases, an ``out``
projection with kernel ``[heads, head_dim, out]``) around an attention
kernel whose static ``valid_len`` masks the padded keys, and slices the
padded rows off. Leading batch dimensions fold into the kernel's batch.

The kernel is chosen by the padded length, as the JAX package's Pallas
route chooses it: up to 256 the single-pass ``mha`` (its backward
recomputes through the plain version), past 256 ``mha_flash`` (online
softmax over key tiles, with a flash backward of its own). The rollout
step and the update pass see the same length and so take the same kernel
(on the card; its plain version on the CPU), so PPO's importance ratio can
start at 1. The JAX package's other route, flax's ``dot_product_attention``
when ``use_pallas`` is off, is not ported.

``EntitySelfAttentionNet`` is the flagship trunk: per-type bias-free embed
-> LayerNorm -> leaky ReLU, self-attention, a residual (tiled when the
output is wider than the embedding), mean-pool, LayerNorm, a feed-forward
residual and a final LayerNorm. Parameter names follow the flax tree
(``self_embed``, ``<key>_embed``, ``LayerNorm_0..``, ``SelfAttention_0``,
``ff_0``, ``ff_1``), so the weight-norm projection and the LayerNorm renorm
of the PPO update pick the same parameters as in the JAX package. With
``embed_concat_self=True`` (JAX: ``:136``) each entity set's features get
the self features tiled along the entity axis, after them (``[entities,
self]``), so every entity embed reads F_e + F_self features.

Every module here has the policy-batched forms of ``models/common.py``
(JAX ``vmap``s the net over policy chunks and over the train policies):
``chunked`` over ``[B, C, ...]`` leaves and ``batched`` over ``[P, rows,
...]`` leaves run the forward's arithmetic op for op, each child through
its own form. ``DenseGeneral`` sees its ``[P, *in_shape, *out_shape]``
kernel stack as ``[P, prod(in), prod(out)]`` (a view the stacked
parameters keep), so its products are ``grouped_matmul``'s and
``torch.bmm``'s. The attention kernels have no weights: the chunk (or
policy) axes fold into their batch axis, as leading axes do in the
forward, so both forms call the kernel the forward picks by the padded
length, over every chunk's (policy's) items at once.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ..ops.cuda.grouped_matmul import grouped_matmul
from ..ops.cuda.mha import MAX_SEQ, mha
from ..ops.cuda.mha_flash import mha_flash
from .common import CHUNKED_DTYPES, Dense, LayerNorm, orthogonal

__all__ = ["EntitySelfAttentionNet", "SelfAttention"]


def lecun_normal(fan_in: int) -> Callable:
    """flax's default attention kernel init: truncated normal with variance
    1 / fan_in."""

    def init(shape, generator):
        std = math.sqrt(1.0 / fan_in) / .87962566103423978
        w = torch.empty(shape, dtype=torch.float32)
        nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                              generator=generator)
        return w

    return init


def _form(module, params=None, layout=None):
    """``call(name, x, *args)``: ``module``'s child ``name`` over ``x``, by
    its forward where ``params`` is None, else by its ``batched`` form
    (``layout`` None) or its ``chunked`` form, with that child's stacked
    parameters of ``params``."""

    def call(name, x, *args):
        child = getattr(module, name)
        if params is None:
            return child(x, *args)
        if layout is None:
            return child.batched(params.child(name), x, *args)
        return child.chunked(params.child(name), layout, x, *args)

    return call


class DenseGeneral(nn.Module):
    """flax ``DenseGeneral`` over the trailing ``in_shape`` axes:
    ``kernel`` [*in_shape, *out_shape], ``bias`` [*out_shape], computed in
    the compute dtype."""

    def __init__(self, in_shape: Tuple[int, ...], out_shape: Tuple[int, ...],
                 dtype, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.in_shape, self.out_shape = tuple(in_shape), tuple(out_shape)
        fan_in, fan_out = math.prod(in_shape), math.prod(out_shape)
        self.matrix = (fan_in, fan_out)
        self.kernel = nn.Parameter(lecun_normal(fan_in)(
            (fan_in, fan_out), generator).reshape(*in_shape, *out_shape))
        self.bias = nn.Parameter(torch.zeros(out_shape))

    def _lead(self, x):
        return x.shape[:x.dim() - len(self.in_shape)]

    def forward(self, x):
        lead = self._lead(x)
        fan_in = self.matrix[0]
        y = (x.reshape(*lead, fan_in).to(self.dtype)
             @ self.kernel.reshape(fan_in, -1).to(self.dtype)
             + self.bias.reshape(-1).to(self.dtype))
        return y.reshape(*lead, *self.out_shape)

    def chunked_supported(self):
        return self.dtype in CHUNKED_DTYPES

    def chunked(self, params, layout, x):
        """``x`` [B, C, ..., *in_shape] -> [B, C, ..., *out_shape]: the
        product through ``grouped_matmul`` against the ``[P, prod(in),
        prod(out)]`` view of the kernel stack, then each chunk's bias."""
        lead = self._lead(x)
        x3 = x.reshape(lead[0], -1, self.matrix[0]).to(self.dtype)
        y = grouped_matmul(x3.contiguous(),
                           params.stack("kernel", self.dtype, self.matrix),
                           layout.chunk_policy)
        y = y + params.per_chunk("bias", self.dtype, layout, 3,
                                 self.matrix[1:])
        return y.reshape(*lead, *self.out_shape)

    batched_supported = chunked_supported

    def batched(self, params, x):
        """``x`` [P, ..., *in_shape] -> [P, ..., *out_shape]: ``torch.bmm``
        against the ``[P, prod(in), prod(out)]`` view of the kernel stack,
        then each policy's bias."""
        lead = self._lead(x)
        y = torch.bmm(x.reshape(lead[0], -1, self.matrix[0]).to(self.dtype),
                      params.stack("kernel", self.dtype, self.matrix))
        y = y + params.per_policy("bias", self.dtype, 3, self.matrix[1:])
        return y.reshape(*lead, *self.out_shape)


class MultiHeadDotProductAttention(nn.Module):
    def __init__(self, in_features: int, num_heads: int, qkv_features: int,
                 out_features: int, dtype,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        heads = (num_heads, qkv_features // num_heads)
        self.query = DenseGeneral((in_features,), heads, dtype, generator)
        self.key = DenseGeneral((in_features,), heads, dtype, generator)
        self.value = DenseGeneral((in_features,), heads, dtype, generator)
        self.out = DenseGeneral(heads, (out_features,), dtype, generator)

    def _run(self, call, x, valid_len):
        q, k, v = (call(name, x) for name in ("query", "key", "value"))
        lead = q.shape[:-3]

        def fold(t):
            return t.reshape(-1, *t.shape[-3:])

        # madrona_learn_tpu/models/attention.py:76-80
        attend = mha if q.shape[-3] <= MAX_SEQ else mha_flash
        o = attend(fold(q), fold(k), fold(v), valid_len)
        return call("out", o.reshape(*lead, *o.shape[1:]))

    def forward(self, x, valid_len: int):
        """x [..., S, F] -> [..., S, out]; keys past ``valid_len`` masked."""
        return self._run(_form(self), x, valid_len)

    def chunked(self, params, layout, x, valid_len: int):
        """``forward`` over [B, C, S, F] chunks: one kernel call over every
        chunk's items."""
        return self._run(_form(self, params, layout), x, valid_len)

    def batched(self, params, x, valid_len: int):
        """``forward`` over [P, rows, S, F]: one kernel call over every
        policy's items."""
        return self._run(_form(self, params), x, valid_len)


class SelfAttention(nn.Module):
    def __init__(self, in_features: int, num_heads: int, qkv_features: int,
                 out_features: int, dtype,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(
            in_features, num_heads, qkv_features, out_features, dtype,
            generator)

    def _run(self, call, x):
        seq_len = x.shape[-2]
        pad = -(seq_len // -8) * 8 - seq_len
        if pad:
            x = nn.functional.pad(x, (0, 0, 0, pad))
        out = call("MultiHeadDotProductAttention_0", x, seq_len)
        return out[..., :seq_len, :]

    def forward(self, x):
        return self._run(_form(self), x)

    def chunked(self, params, layout, x):
        return self._run(_form(self, params, layout), x)

    def batched(self, params, x):
        return self._run(_form(self, params), x)


def _leaky_relu(x):
    return nn.functional.leaky_relu(x, 0.01)


class EntitySelfAttentionNet(nn.Module):
    """Per-entity-type embed -> self-attention -> mean-pool -> FF residual.

    ``obs_features`` maps each obs key to its feature width: ``self``
    ([..., F_self]) plus any number of entity sets ([..., num_entities,
    F_e]). ``forward`` takes the obs dict and returns [..., out];
    ``chunked`` and ``batched`` take it with [B, C, ...] and [P, rows,
    ...] leaves.
    """

    def __init__(self, obs_features: Dict[str, int], num_embed_channels: int,
                 num_out_channels: int, num_heads: int, dtype,
                 dense_init: Callable = orthogonal(math.sqrt(2)),
                 generator: Optional[torch.Generator] = None,
                 embed_concat_self: bool = False):
        super().__init__()
        self.dtype = dtype
        self.num_embed_channels = num_embed_channels
        self.num_out_channels = num_out_channels
        self.embed_concat_self = embed_concat_self
        # self first, then the entity sets in sorted key order, as flax's
        # tree_flatten_with_path visits them.
        self.entity_keys = sorted(k for k in obs_features if k != "self")
        for idx, name in enumerate(["self"] + self.entity_keys):
            width = obs_features[name]
            if embed_concat_self and name != "self":
                width += obs_features["self"]
            self.add_module(f"{name}_embed", Dense(
                width, num_embed_channels, dtype,
                use_bias=False, kernel_init=dense_init, generator=generator))
            self.add_module(f"LayerNorm_{idx}",
                            LayerNorm(num_embed_channels, dtype))
        self.SelfAttention_0 = SelfAttention(
            num_embed_channels, num_heads, num_embed_channels,
            num_out_channels, dtype, generator)
        n = 1 + len(self.entity_keys)
        self.ff_0 = Dense(num_out_channels, num_out_channels, dtype,
                          use_bias=False, kernel_init=dense_init,
                          generator=generator)
        self.ff_1 = Dense(num_out_channels, num_out_channels, dtype,
                          use_bias=False, kernel_init=dense_init,
                          generator=generator)
        self._pool_norm = f"LayerNorm_{n}"
        self._ff_norm = f"LayerNorm_{n + 1}"
        self._out_norm = f"LayerNorm_{n + 2}"
        for name in (self._pool_norm, self._ff_norm, self._out_norm):
            self.add_module(name, LayerNorm(num_out_channels, dtype))

    def _run(self, call, x_tree):
        def embed(idx, name, x):
            return _leaky_relu(call(f"LayerNorm_{idx}",
                                    call(f"{name}_embed", x)))

        x_self = x_tree["self"][..., None, :]
        embedded = [embed(0, "self", x_self)]
        for idx, name in enumerate(self.entity_keys, start=1):
            x = x_tree[name]
            if self.embed_concat_self:
                x = torch.cat([x, x_self.expand(*x.shape[:-1],
                                                x_self.shape[-1])], dim=-1)
            embedded.append(embed(idx, name, x))
        entities = torch.cat(embedded, dim=-2)

        attended = call("SelfAttention_0", entities)
        reps = self.num_out_channels // self.num_embed_channels
        attended = attended + entities.repeat(
            *([1] * (entities.dim() - 1)), reps)

        # jnp.mean of a bf16 array sums in f32 and rounds once.
        pooled = attended.float().mean(dim=-2).to(self.dtype)
        pooled = call(self._pool_norm, pooled)
        ff = _leaky_relu(call(self._ff_norm, call("ff_0", pooled)))
        ff = _leaky_relu(call("ff_1", ff))
        return call(self._out_norm, pooled + ff)

    def forward(self, x_tree):
        return self._run(_form(self), x_tree)

    def chunked(self, params, layout, x_tree):
        return self._run(_form(self, params, layout), x_tree)

    def batched(self, params, x_tree):
        return self._run(_form(self, params), x_tree)
