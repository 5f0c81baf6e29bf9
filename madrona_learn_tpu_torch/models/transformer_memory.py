"""Windowed-attention memory (JAX: models/transformer_memory.py).

A drop-in for ``LSTM`` in ``RecurrentBackboneEncoder``: the recurrent
state is a K/V ring buffer over the last ``window`` steps, and each step
attends its query over that window. It has the recurrent protocol of the
LSTM (``init_recurrent_state`` / ``clear_recurrent_state`` / ``forward``
/ ``sequence``) with batch-leading state:

- ``k_cache`` / ``v_cache``: [N, window, H] in the compute dtype;
- ``age``: [N, window] int32, 0 for an empty slot, else the steps since
  the slot was written, plus 1;
- ``pos``: [N, 1] int32, the next slot to write (modulo ``window``).

A step projects q, k and v (bias-free Dense ``q`` / ``k`` / ``v``), writes
k and v into slot ``pos % window`` and ages the other filled slots, takes
f32 multi-head scores of q against the window with a -1e9 mask on empty
slots, a softmax and the f32 weighted sum of the values, then the ``out``
projection and a residual flax LayerNorm (``norm``). Clearing empties
``age`` and ``pos`` and leaves the caches, which no empty slot reads.

The JAX package computes this outside any Pallas kernel, so the port runs
it as plain PyTorch ops. Parameter names follow the flax tree
(``step.{q,k,v,out}.kernel``, ``step.norm.{scale,bias}``).

Policy-batched forms (``models/common.py``; JAX ``vmap``s the flax step
over a population's chunks in collect and over its train policies in
learn): ``chunked`` runs a step over ``[B, C, H]`` chunk-order rows with
the state as ``[B, C, window, H]`` / ``[B, C, window]`` / ``[B, C, 1]``,
q / k / v / out through ``Dense.chunked`` (``grouped_matmul``) and ``norm``
through ``FlaxLayerNorm.chunked``; ``batched`` runs ``sequence`` over
policy-major ``[P, T, mb, H]`` minibatches, the products through
``Dense.batched`` (``torch.bmm``). The ring write, ageing, masked f32
softmax and weighted sum are the step's own ops over the rows, whatever
their leading axes.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .common import Dense, FlaxLayerNorm

__all__ = ["WindowAttentionMemory"]


class _AttentionStep(nn.Module):
    """One memory step: project, write the ring slot, attend over the
    window."""

    def __init__(self, hidden: int, heads: int, window: int, dtype,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden, self.heads, self.window = hidden, heads, window
        self.dtype = dtype
        for name in ("q", "k", "v", "out"):
            self.add_module(name, Dense(hidden, hidden, dtype,
                                        use_bias=False, generator=generator))
        self.norm = FlaxLayerNorm(hidden, dtype)

    def _attend(self, carry, q, k, v):
        """Write this step's K/V into the ring, age the rest and attend q
        over the window: (new carry, attended in the compute dtype). The
        rows may carry any leading axes ([N], [B, C], [P, mb]); each row's
        ops are the same."""
        k_cache, v_cache, age, pos = carry
        lead = q.shape[:-1]
        H, W = self.hidden, self.window
        head_dim = H // self.heads

        # Write this step's K/V into the ring slot, age the rest.
        slot = pos[..., 0] % W
        one_hot = (torch.arange(W, dtype=torch.int32, device=q.device)
                   == slot[..., None])
        k_cache = torch.where(one_hot[..., None], k[..., None, :], k_cache)
        v_cache = torch.where(one_hot[..., None], v[..., None, :], v_cache)
        age = torch.where(one_hot, 1, torch.where(age > 0, age + 1, 0))

        # Multi-head attention of q over the masked window, in f32.
        N = q[..., 0].numel()
        qh = q.reshape(N, self.heads, head_dim).float()
        kh = k_cache.reshape(N, W, self.heads, head_dim).float()
        vh = v_cache.reshape(N, W, self.heads, head_dim).float()
        scores = torch.einsum("nhd,nwhd->nhw", qh, kh) / (head_dim ** 0.5)
        scores = torch.where((age.reshape(N, W) > 0)[:, None, :], scores,
                             torch.tensor(-1e9, dtype=torch.float32,
                                          device=q.device))
        weights = torch.softmax(scores, dim=-1)
        attended = torch.einsum("nhw,nwhd->nhd", weights, vh)
        attended = attended.reshape(*lead, H).to(self.dtype)
        return (k_cache, v_cache, age, pos + 1), attended

    def forward(self, carry, x):
        carry, attended = self._attend(carry, self.q(x), self.k(x),
                                       self.v(x))
        # The residual add promotes as numpy does (JAX's "standard" dtype
        # promotion), as torch's does.
        return carry, self.norm(self.out(attended) + x)

    def chunked(self, params, layout, carry, x):
        """``forward`` over [B, C, H] chunks, the state [B, C, ...]."""
        dense = lambda name, t: getattr(self, name).chunked(
            params.child(name), layout, t)
        carry, attended = self._attend(carry, dense("q", x), dense("k", x),
                                       dense("v", x))
        return carry, self.norm.chunked(params.child("norm"), layout,
                                        dense("out", attended) + x)

    def batched(self, params, carry, x):
        """``forward`` over the train policies' [P, mb, H] rows, the state
        [P, mb, ...]."""
        dense = lambda name, t: getattr(self, name).batched(
            params.child(name), t)
        carry, attended = self._attend(carry, dense("q", x), dense("k", x),
                                       dense("v", x))
        return carry, self.norm.batched(params.child("norm"),
                                        dense("out", attended) + x)


class WindowAttentionMemory(nn.Module):
    """Attention over a ring buffer of the last ``window`` steps. The
    residual makes its input as wide as its output, ``num_hidden_channels``
    (as in the JAX package)."""

    def __init__(self, num_hidden_channels: int, window: int,
                 num_heads: int = 4, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_hidden_channels = num_hidden_channels
        self.window = window
        self.num_heads = num_heads
        self.dtype = dtype
        self.step = _AttentionStep(num_hidden_channels, num_heads, window,
                                   dtype, generator)

    def init_recurrent_state(self, N: int, device=None):
        H, W = self.num_hidden_channels, self.window
        return (torch.zeros((N, W, H), dtype=self.dtype, device=device),
                torch.zeros((N, W, H), dtype=self.dtype, device=device),
                torch.zeros((N, W), dtype=torch.int32, device=device),
                torch.zeros((N, 1), dtype=torch.int32, device=device))

    def clear_recurrent_state(self, rnn_states, should_clear):
        """should_clear [N, 1] bool (or [B, C, 1], [P, mb, 1] over
        chunk-order or policy-major state). Emptying ``age`` is enough (a
        stale K/V slot never attends); resetting ``pos`` makes what follows
        independent of the history before the reset."""
        k_cache, v_cache, age, pos = rnn_states
        clear = should_clear[..., :1].to(torch.bool)
        return (k_cache, v_cache, torch.where(clear, 0, age),
                torch.where(clear, 0, pos))

    def forward(self, cur_state, in_features):
        new_state, out = self.step(cur_state, in_features)
        return out, new_state

    def chunked(self, params, layout, cur_state, in_features):
        """``forward`` over [B, C, H] chunks, the state [B, C, ...]."""
        new_state, out = self.step.chunked(params.child("step"), layout,
                                           cur_state, in_features)
        return out, new_state

    def batched(self, params, start_states, seq_ends, seq_x):
        """``sequence`` over the train policies: ``seq_x`` [P, T, mb, H]
        -> [P, T, mb, H], the state [P, mb, ...] and ``seq_ends`` [P, T,
        mb, ...]."""
        P, T, mb = seq_x.shape[:3]
        ends = seq_ends.reshape(P, T, mb, 1)
        state, outs = start_states, []
        for t in range(T):
            state, y = self.step.batched(params.child("step"), state,
                                         seq_x[:, t])
            state = self.clear_recurrent_state(state, ends[:, t])
            outs.append(y)
        return torch.stack(outs, dim=1)

    def sequence(self, start_states, seq_ends, seq_x):
        """[T, N, F] features -> [T, N, H], clearing the state after any
        step whose ``seq_ends`` flag is set."""
        state, outs = start_states, []
        for t in range(seq_x.shape[0]):
            state, y = self.step(state, seq_x[t])
            state = self.clear_recurrent_state(state, seq_ends[t])
            outs.append(y)
        return torch.stack(outs)
