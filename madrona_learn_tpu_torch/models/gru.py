"""Stacked GRU with the LSTM's recurrent protocol (JAX: models/gru.py).

A drop-in for ``LSTM`` in ``RecurrentBackboneEncoder``: the same
``init_recurrent_state`` / ``clear_recurrent_state`` / ``forward`` /
``sequence`` surface, batch-leading state and step-then-reset clearing,
with one ``[N, num_layers, H]`` state tensor instead of a (c, h) pair.
Gates are packed ``[r | z | n]`` along the last axis of the input kernel
``[F, 3H]`` (a Dense with a bias, unlike the LSTM's) and the recurrent
kernel ``[H, 3H]``; ``bias_h`` [H] is the candidate gate's recurrent bias
(flax ``GRUCell``'s linear-before-reset variant):

    r = sigmoid(x_r + h W_hr);  z = sigmoid(x_z + h W_hz)
    n = tanh(x_n + r * (h W_hn + b_hn));  h' = (1 - z) * n + z * h

Gate math is f32 from storage-dtype operands, ``bias_h`` rounded to the
storage dtype first, and the new h rounded at the step boundary. The
rollout step (``forward``) and the update-pass ``sequence`` both go through
``ops/cuda/gru.py`` (``gru_sequence_fwd`` with T = 1 for the step,
``gru_sequence_fwd`` / ``gru_sequence_bwd`` for the sequence), so on the
card the two forwards share rounding points and PPO's ratio can start at 1.
The sequence pass hoists each layer's input projection into one
``[T*N, F] x [F, 3H]`` product. There is no ``use_pallas`` switch and no
``seq_unroll``: the kernel pass is the only route. The compute dtype is
float32, bfloat16 or float16 (the kernels' CUDA-core float16 instances;
JAX sends float16 to its jnp twin, which rounds at the same points).

The policy-batched step (``chunked``, ``models/common.py``) takes the state
as ``[B, C, num_layers, H]`` chunks: each layer's input projection through
``Dense.chunked`` (``grouped_matmul``), its recurrence through
``gru_step_chunked``, the chunk-indexed instance of the forward at T = 1,
whose rows equal ``gru_sequence_fwd``'s. The policy-batched update pass
(``batched``) takes policy-major inputs ``[P, T, mb, ...]`` and every
train policy's minibatch as one chunk of a ``[T, P * mb]`` time-major
batch: each layer's input projection through ``Dense.batched``
(``torch.bmm``), its recurrence through ``gru_sequence_chunked``
(``gru_sequence_fwd_chunked`` and ``gru_sequence_bwd_chunked`` on the
card). Both take float32, bfloat16 and float16 at the hidden sizes the
kernels take (``gru_supported``); another width keeps the per-policy loop.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.cuda.gru import (
    gru_sequence,
    gru_sequence_chunked,
    gru_step,
    gru_step_chunked,
    gru_supported,
)
from .common import CHUNKED_DTYPES, Dense, orthogonal_gates

__all__ = ["GRU"]


class _PackedGRULayer(nn.Module):
    def __init__(self, in_features: int, hidden: int, dtype,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        init = orthogonal_gates(3, hidden)
        self.input_proj = Dense(in_features, 3 * hidden, dtype,
                                use_bias=True, kernel_init=init,
                                generator=generator)
        self.recurrent_kernel = nn.Parameter(
            init((hidden, 3 * hidden), generator))
        self.bias_h = nn.Parameter(torch.zeros(hidden))

    def packed_weights(self):
        return (self.recurrent_kernel.to(self.dtype),
                self.bias_h.to(self.dtype))

    def forward(self, h, x):
        wh, bh = self.packed_weights()
        return gru_step(self.input_proj(x).contiguous(), wh, bh,
                        h.contiguous())

    def _stacks(self, params):
        """The [P, H, 3H] / [P, H] weight stacks in the compute dtype (the
        rounding point of ``packed_weights``)."""
        return (params.stack("recurrent_kernel", self.dtype),
                params.stack("bias_h", self.dtype))

    def chunked(self, params, layout, h, x):
        """``forward`` over [B, C, ...] chunks: the new h [B, C, H]."""
        x_proj = self.input_proj.chunked(params.child("input_proj"), layout,
                                         x)
        B, C = x_proj.shape[:2]
        rows = lambda t: t.reshape(B * C, t.shape[-1]).contiguous()
        new_h = gru_step_chunked(rows(x_proj), *self._stacks(params),
                                 layout.chunk_policy, rows(h))
        return new_h.reshape(B, C, -1)

    def batched(self, params, keep, h0, x):
        """The layer's update pass over the train policies: ``x`` [P, T,
        mb, F] -> ys [P, T, mb, H], policy p's minibatch chunk p of the
        [T, P * mb] sequence (``keep`` [T, P * mb]; ``h0`` [P * mb, H])."""
        P, T, mb = x.shape[:3]
        x_proj = self.input_proj.batched(params.child("input_proj"), x)
        x_proj = x_proj.transpose(0, 1).reshape(T, P * mb, -1).contiguous()
        ys = gru_sequence_chunked(
            x_proj, keep, *self._stacks(params),
            torch.arange(P, dtype=torch.int32, device=x.device), h0)
        return ys.reshape(T, P, mb, -1).transpose(0, 1)


class GRU(nn.Module):
    def __init__(self, in_features: int, num_hidden_channels: int,
                 num_layers: int, dtype,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_hidden_channels = num_hidden_channels
        self.num_layers = num_layers
        self.dtype = dtype
        width = in_features
        for layer in range(num_layers):
            self.add_module(f"layer_{layer}", _PackedGRULayer(
                width, num_hidden_channels, dtype, generator))
            width = num_hidden_channels

    def _cells(self):
        return [getattr(self, f"layer_{l}") for l in range(self.num_layers)]

    def init_recurrent_state(self, N: int, device=None):
        return torch.zeros((N, self.num_layers, self.num_hidden_channels),
                           dtype=self.dtype, device=device)

    def clear_recurrent_state(self, rnn_states, should_clear):
        """should_clear [N, 1] bool; broadcasts over (layer, hidden)."""
        return torch.where(should_clear[..., None],
                           torch.zeros((), dtype=rnn_states.dtype,
                                       device=rnn_states.device), rnn_states)

    def forward(self, cur_hiddens, in_features):
        """One step for every layer: ([N, L*H] outputs, new state)."""
        hs = []
        layer_in = in_features
        for layer, cell in enumerate(self._cells()):
            layer_in = cell(cur_hiddens[:, layer], layer_in)
            hs.append(layer_in)
        return torch.cat(hs, dim=-1), torch.stack(hs, dim=1)

    def chunked_supported(self):
        return (self.dtype in CHUNKED_DTYPES
                and gru_supported(self.num_hidden_channels, self.dtype))

    def chunked(self, params, layout, cur_hiddens, in_features):
        """``forward`` over [B, C, ...] chunks, the state [B, C, L, H]."""
        hs = []
        layer_in = in_features
        for layer, cell in enumerate(self._cells()):
            layer_in = cell.chunked(params.child(f"layer_{layer}"), layout,
                                    cur_hiddens[:, :, layer], layer_in)
            hs.append(layer_in)
        return torch.cat(hs, dim=-1), torch.stack(hs, dim=2)

    batched_supported = chunked_supported

    def batched(self, params, start_hiddens, seq_ends, seq_x):
        """``sequence`` over the train policies: ``seq_x`` [P, T, mb, F]
        -> [P, T, mb, L*H], the state [P, mb, L, H] and ``seq_ends`` [P,
        T, mb, ...]."""
        P, T, mb = seq_x.shape[:3]
        zero = torch.zeros((), dtype=self.dtype, device=seq_x.device)
        keep = torch.where(seq_ends.reshape(P, T, mb).transpose(0, 1),
                           zero, zero + 1).reshape(T, P * mb).contiguous()
        outs = []
        layer_in = seq_x
        for layer, cell in enumerate(self._cells()):
            h0 = start_hiddens[:, :, layer].reshape(P * mb, -1).contiguous()
            layer_in = cell.batched(params.child(f"layer_{layer}"), keep, h0,
                                    layer_in)
            outs.append(layer_in)
        return torch.cat(outs, dim=-1)

    def sequence(self, start_hiddens, seq_ends, seq_x):
        """[T, N, F] features -> [T, N, L*H], clearing the state after any
        step whose ``seq_ends`` flag is set."""
        T, N = seq_x.shape[0], seq_x.shape[1]
        zero = torch.zeros((), dtype=self.dtype, device=seq_x.device)
        keep = torch.where(seq_ends.reshape(T, N), zero, zero + 1).contiguous()
        outs = []
        layer_in = seq_x
        for layer, cell in enumerate(self._cells()):
            wh, bh = cell.packed_weights()
            ys = gru_sequence(cell.input_proj(layer_in).contiguous(), keep,
                              wh, bh, start_hiddens[:, layer].contiguous())
            layer_in = ys
            outs.append(ys)
        return torch.cat(outs, dim=-1)
