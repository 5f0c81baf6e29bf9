"""Stacked LSTM with batch-leading recurrent state (JAX: models/lstm.py).

The (c, h) state is a pair of ``[N, num_layers, H]`` tensors in the compute
dtype. Gates are packed ``(i, f, g, o)`` along the last axis of the input
kernel ``[F, 4H]`` and the recurrent kernel ``[H, 4H]``.

Every step uses the "precise gates" math of the fused kernel: f32 gates
from storage-dtype operands, the carry rounded back at the step boundary.
The rollout step (``forward``) and the update-pass ``sequence`` both go
through ``ops/cuda/lstm.py`` (``lstm_sequence_fwd`` with T = 1 for the
step, ``lstm_sequence_fwd`` / ``lstm_sequence_bwd`` for the
sequence), so on the card the two forwards share rounding points and PPO's
ratio can start at 1. The sequence pass hoists each layer's input
projection into one ``[T*N, F] x [F, 4H]`` product and clears the carry
after any step whose ``seq_ends`` flag is set. With
``fuse_input_proj=True`` (JAX: ``models/lstm.py:134``), a layer whose input
width passes ``lstm_proj_supported`` runs ``lstm_sequence_proj`` instead,
which computes ``round(x . Wi)`` inside the kernel at the same rounding
point, so the [T, N, 4H] projection never goes to device memory. Its f32
sums run in another order than the cuBLAS product of the single step, so
on the card a bf16 projection may differ by one rounding and PPO's ratio
starts near, not exactly at, 1.

The policy-batched step (``chunked``, ``models/common.py``) takes the
state as ``[B, C, num_layers, H]`` chunks: each layer's input projection
through ``grouped_matmul``, its recurrence through
``lstm_step_chunked``, the chunk-indexed instance of the forward at T = 1,
whose rows equal ``lstm_sequence_fwd``'s. With ``fuse_input_proj`` too, as
the single-policy step takes its projection from a product and
``lstm_step``. Float32, bfloat16 and float16 (the kernels' CUDA-core
float16 instances, as for one policy).

The policy-batched update pass (``batched``, ``models/common.py``) takes
policy-major inputs ``[P, T, mb, ...]`` and every train policy's
minibatch as one chunk of a ``[T, P * mb]`` time-major batch: each
layer's input projection through ``torch.bmm``, its recurrence through
``lstm_sequence_chunked`` (``lstm_sequence_fwd_chunked`` and
``lstm_sequence_bwd_chunked`` on the card), the kernel family of the
chunked rollout step, so a row keeps the rollout's rounding points. With
``fuse_input_proj``, a layer that ``sequence`` sends to
``lstm_sequence_proj`` takes ``lstm_sequence_proj_chunked`` (the
projection kernels' chunk-indexed instances) with the ``[P, F, 4H]``
stack of its input kernel.

The compute dtype is float32, bfloat16 or float16. Float16 takes the
kernels' CUDA-core float16 instances (JAX sends a float16 LSTM to its jnp
twin, which has the same rounding points), and never the projection
kernels, which refuse float16 as JAX's do.

Every route is picked from the layer's width and dtype before any launch,
by JAX's gate (``models/lstm.py:240``, ``H % 128 == 0``; float16 as
float32): ``lstm_kernel_route`` sends the step, the sequence and both
policy-batched forms of a multiple of 128 to the kernels, which are built
at H = 128, 256, 384 and 512 (``lstm_supported``) and raise on the card at
a wider one, and any other width (H = 32 in ``examples/train_sharded.py``)
to the kernels' plain twins, on the card as on the CPU, as JAX sends it to
its jnp twin: ``lstm_step_reference``, ``lstm_sequence_reference``,
``lstm_step_chunked_reference`` and ``lstm_sequence_chunked_reference``
(on the card one gathered batched product a step over the chunks). So a
population of any width takes the chunked rollout and the batched learn.
The projection kernels are built at H = 128 and 256
(``lstm_proj_supported``): with ``fuse_input_proj`` a wider layer takes
the unfused sequence kernels.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.cuda.lstm import (
    lstm_kernel_route,
    lstm_proj_supported,
    lstm_sequence,
    lstm_sequence_chunked,
    lstm_sequence_chunked_reference,
    lstm_sequence_proj,
    lstm_sequence_proj_chunked,
    lstm_sequence_reference,
    lstm_step,
    lstm_step_chunked,
    lstm_step_chunked_reference,
    lstm_step_reference,
)
from .common import CHUNKED_DTYPES, Dense, orthogonal_gates

__all__ = ["LSTM"]


class _PackedLSTMLayer(nn.Module):
    def __init__(self, in_features: int, hidden: int, dtype,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        # The route, JAX's: the kernels, or their plain twins (JAX's jnp
        # twin) at a width that is no multiple of 128.
        self.use_kernels = lstm_kernel_route(hidden, dtype)
        init = orthogonal_gates(4, hidden)
        self.input_proj = Dense(in_features, 4 * hidden, dtype,
                                use_bias=False, kernel_init=init,
                                generator=generator)
        self.recurrent_kernel = nn.Parameter(
            init((hidden, 4 * hidden), generator))
        self.bias = nn.Parameter(torch.zeros(4 * hidden))

    def project_input(self, x):
        """[..., F] -> [..., 4H]."""
        return self.input_proj(x)

    def packed_weights(self):
        return (self.recurrent_kernel.to(self.dtype),
                self.bias.to(self.dtype))

    def forward(self, carry, x):
        c, h = carry
        wr, b = self.packed_weights()
        step = lstm_step if self.use_kernels else lstm_step_reference
        new_c, new_h = step(self.project_input(x).contiguous(), wr, b,
                            c.contiguous(), h.contiguous())
        return (new_c, new_h), new_h

    def chunked(self, params, layout, carry, x):
        """``forward`` over [B, C, ...] chunks."""
        c, h = carry
        x_proj = self.input_proj.chunked(params.child("input_proj"), layout,
                                         x)
        B, C = x_proj.shape[:2]
        rows = lambda t: t.reshape(B * C, t.shape[-1]).contiguous()
        step = (lstm_step_chunked if self.use_kernels
                else lstm_step_chunked_reference)
        new_c, new_h = step(
            rows(x_proj), params.stack("recurrent_kernel", self.dtype),
            params.stack("bias", self.dtype), layout.chunk_policy, rows(c),
            rows(h))
        new_c, new_h = new_c.reshape(B, C, -1), new_h.reshape(B, C, -1)
        return (new_c, new_h), new_h

    def batched(self, params, keep, c0, h0, x, fuse_input_proj=False):
        """The layer's update pass over the train policies: ``x`` [P, T,
        mb, F] -> ys [P, T, mb, H], policy p's minibatch chunk p of the
        [T, P * mb] sequence (``keep`` [T, P * mb]; ``c0`` / ``h0`` [P *
        mb, H]); with ``fuse_input_proj``, the projection inside the
        kernels."""
        P, T, mb = x.shape[:3]
        time_major = lambda t: t.transpose(0, 1).reshape(
            T, P * mb, -1).contiguous()
        wr = params.stack("recurrent_kernel", self.dtype)
        b = params.stack("bias", self.dtype)
        chunk_policy = torch.arange(P, dtype=torch.int32, device=x.device)
        if fuse_input_proj:
            ys = lstm_sequence_proj_chunked(
                time_major(x.to(self.dtype)), keep,
                params.child("input_proj").stack("kernel", self.dtype), wr,
                b, chunk_policy, c0, h0)
        else:
            x_proj = self.input_proj.batched(params.child("input_proj"), x)
            sequence = (lstm_sequence_chunked if self.use_kernels
                        else lstm_sequence_chunked_reference)
            ys = sequence(time_major(x_proj), keep, wr, b, chunk_policy, c0,
                          h0)
        return ys.reshape(T, P, mb, -1).transpose(0, 1)


class LSTM(nn.Module):
    def __init__(self, in_features: int, num_hidden_channels: int,
                 num_layers: int, dtype,
                 generator: Optional[torch.Generator] = None,
                 fuse_input_proj: bool = False):
        super().__init__()
        self.num_hidden_channels = num_hidden_channels
        self.num_layers = num_layers
        self.dtype = dtype
        self.fuse_input_proj = fuse_input_proj
        width = in_features
        for layer in range(num_layers):
            self.add_module(f"layer_{layer}", _PackedLSTMLayer(
                width, num_hidden_channels, dtype, generator))
            width = num_hidden_channels

    def _cells(self):
        return [getattr(self, f"layer_{l}") for l in range(self.num_layers)]

    def init_recurrent_state(self, N: int, device=None):
        shape = (N, self.num_layers, self.num_hidden_channels)
        return (torch.zeros(shape, dtype=self.dtype, device=device),
                torch.zeros(shape, dtype=self.dtype, device=device))

    def clear_recurrent_state(self, rnn_states, should_clear):
        """should_clear [N, 1] bool; broadcasts over (layer, hidden)."""
        mask = should_clear[..., None]
        return tuple(torch.where(mask, torch.zeros((), dtype=s.dtype,
                                                   device=s.device), s)
                     for s in rnn_states)

    def forward(self, cur_hiddens, in_features):
        """One step for every layer: ([N, L*H] outputs, new carry)."""
        c_in, h_in = cur_hiddens
        cs, hs, outs = [], [], []
        layer_in = in_features
        for layer, cell in enumerate(self._cells()):
            (c, h), out = cell((c_in[:, layer], h_in[:, layer]), layer_in)
            layer_in = h
            cs.append(c)
            hs.append(h)
            outs.append(out)
        carry = (torch.stack(cs, dim=1), torch.stack(hs, dim=1))
        return torch.cat(outs, dim=-1), carry

    def chunked_supported(self):
        # Every width: one that is no multiple of 128 takes the plain
        # twins, as JAX's jnp twin.
        return self.dtype in CHUNKED_DTYPES

    def _fuses_proj(self, in_features):
        """Whether ``sequence`` runs a layer of this input width through
        the projection kernels (``lstm_proj_supported``: H = 128 or 256,
        float32 or bfloat16)."""
        return self.fuse_input_proj and lstm_proj_supported(
            in_features, self.num_hidden_channels, self.dtype)

    def chunked(self, params, layout, cur_hiddens, in_features):
        """``forward`` over [B, C, ...] chunks, the state [B, C, L, H]."""
        c_in, h_in = cur_hiddens
        cs, hs, outs = [], [], []
        layer_in = in_features
        for layer, cell in enumerate(self._cells()):
            (c, h), out = cell.chunked(
                params.child(f"layer_{layer}"), layout,
                (c_in[:, :, layer], h_in[:, :, layer]), layer_in)
            layer_in = h
            cs.append(c)
            hs.append(h)
            outs.append(out)
        carry = (torch.stack(cs, dim=2), torch.stack(hs, dim=2))
        return torch.cat(outs, dim=-1), carry

    batched_supported = chunked_supported

    def batched(self, params, start_hiddens, seq_ends, seq_x):
        """``sequence`` over the train policies: ``seq_x`` [P, T, mb, F]
        -> [P, T, mb, L*H], the state [P, mb, L, H] and ``seq_ends`` [P,
        T, mb, ...]."""
        c0, h0 = start_hiddens
        P, T, mb = seq_x.shape[:3]
        zero = torch.zeros((), dtype=self.dtype, device=seq_x.device)
        keep = torch.where(seq_ends.reshape(P, T, mb).transpose(0, 1),
                           zero, zero + 1).reshape(T, P * mb).contiguous()
        outs = []
        layer_in = seq_x
        for layer, cell in enumerate(self._cells()):
            rows = lambda s: s[:, :, layer].reshape(P * mb, -1).contiguous()
            layer_in = cell.batched(params.child(f"layer_{layer}"), keep,
                                    rows(c0), rows(h0), layer_in,
                                    self._fuses_proj(layer_in.shape[-1]))
            outs.append(layer_in)
        return torch.cat(outs, dim=-1)

    def sequence(self, start_hiddens, seq_ends, seq_x):
        """[T, N, F] features -> [T, N, L*H], clearing the carry after any
        step whose ``seq_ends`` flag is set."""
        c0, h0 = start_hiddens
        T, N = seq_x.shape[0], seq_x.shape[1]
        zero = torch.zeros((), dtype=self.dtype, device=seq_x.device)
        keep = torch.where(seq_ends.reshape(T, N), zero, zero + 1).contiguous()
        outs = []
        layer_in = seq_x
        for layer, cell in enumerate(self._cells()):
            wr, b = cell.packed_weights()
            c0_l, h0_l = c0[:, layer].contiguous(), h0[:, layer].contiguous()
            if self._fuses_proj(layer_in.shape[-1]):
                # The cast is differentiable, so the gradient reaches the
                # float32 input_proj.kernel.
                wi = cell.input_proj.kernel.to(self.dtype).contiguous()
                ys = lstm_sequence_proj(layer_in.to(self.dtype).contiguous(),
                                        keep, wi, wr, b, c0_l, h0_l)
            else:
                x_proj = cell.project_input(layer_in).contiguous()
                run = (lstm_sequence if cell.use_kernels
                       else lstm_sequence_reference)
                ys = run(x_proj, keep, wr, b, c0_l, h0_l)
            layer_in = ys
            outs.append(ys)
        return torch.cat(outs, dim=-1)
