"""lstm_sequence_fwd / lstm_sequence_bwd: the fused LSTM sequence pass as
CUDA kernels, with plain twins; lstm_sequence_proj_fwd /
lstm_sequence_proj_bwd: the same pass with the input projection inside the
kernel.

Replaces ``madrona_learn_tpu/ops/pallas/lstm.py:lstm_sequence`` (forward
``_fwd_kernel``, backward ``_bwd_kernel`` with its fused dWr/db epilogue)
and ``lstm_sequence_proj`` (``_fwd_proj_kernel``, ``_bwd_proj_kernel`` with
its fused dWi/dWr/db epilogue). ``csrc/lstm.cu`` explains the Hopper
design: a block owns a tile of batch rows and loops over time, Wr (and Wi)
are read from L2 every step (they do not fit in shared memory at H = 256),
and the weight gradients are per-split f32 partials summed in a fixed order
by a second pass instead of one accumulator shared by the whole grid.

The sequence kernels (``lstm_sequence_fwd`` / ``_bwd`` and their
chunk-indexed instances) are built at H = 128, 256, 384 and 512 in
float32, bfloat16 and float16: :func:`lstm_supported` is true exactly
there, which for float32 and bfloat16 is JAX's gate (``H % 128 == 0``,
``ops/pallas/lstm.py:83``) over H from 32 to 512; float16 is the port's
choice (JAX sends it to its jnp twin). The projection kernels are built at
the same four widths in float32 and bfloat16 (:func:`lstm_proj_supported`,
JAX's gate there). The modules route a layer
by JAX's gate (:func:`lstm_kernel_route`): a width that is no multiple of
128 to the plain twins, on the card too, as JAX routes it to its jnp twin;
the wrappers raise on operands no kernel takes (a multiple of 128 past
512 among them).

Two paths for each of the four kernels, picked from the dtype and H alone
by :func:`fwd_uses_tensor_cores` (the sequence forward, its chunk-indexed
instance, and the rollout steps that run them), :func:`bwd_uses_tensor_cores`
(the sequence backward and its chunk-indexed instance) and
:func:`uses_tensor_cores` (the projection kernels); no fallback: the kernel
a call is routed to runs or raises:

- bfloat16 at every width, the projection kernels too, and the float16
  sequence kernels at H = 128 or 256: the recurrence on Hopper's
  warpgroup tensor cores (``wgmma``, bf16 or f16 operands, f32
  accumulators; the weights stream through a TMA ring, read as they stand
  by the forwards and from transposed copies by the backwards; a block owns
  R batch rows, R being :func:`fwd_tc_rows` for the forwards and
  :func:`tc_rows` for the backwards, and at H = 384 and 512 a cluster of
  two blocks splits the units, ``csrc/lstm.cu``, "Wider layers"); the
  backwards then take the weight gradients as a split-K ``wgmma`` product
  over the T * N rows. Bound by streaming the weights from L2. TMA and the
  kernels' 16-byte copies read every operand on a 16-byte boundary: one
  that is not is copied onto one first. The float16 kernels are the port's
  own (JAX sends float16 to its jnp twin): f16 operands, ys, cs, dgates,
  dx_proj, dh0, dc0, dWr and db rounded once to float16, as the CUDA-core
  kernels and the plain twin round them; forward and backward share their
  route, so the backward recomputes the forward's pre-activations bitwise;
- float32, whose products tensor cores would round, and float16 at H = 384
  and 512: the CUDA-core kernels, bound by f32 FMA issue. Float16 is built
  for the two sequence kernels alone: :func:`lstm_proj_supported` refuses
  it, as JAX's does, so a float16 layer takes the unfused kernels.

Contract (all operands in the storage dtype, float32, bfloat16 or float16;
the projection variant float32 or bfloat16):

- ``x_proj`` [T, N, 4H] pre-projected inputs, gates (i, f, g, o); or, for
  the projection variant, ``x`` [T, N, F] and ``wi`` [F, 4H] with
  F % 128 == 0 and F <= 4H, and ``x_proj = round(x . Wi)`` (f32
  accumulation, rounded to the storage dtype, as the hoisted Dense);
- ``keep`` [T, N]: 0 clears the carry after step t;
- ``wr`` [H, 4H], ``bias`` [4H], ``c0``/``h0`` [N, H];
- gate math in f32, ``h . Wr`` accumulated in f32, ``ys``/``cs`` rounded to
  the storage dtype; the backward rounds dgates to the storage dtype.

``lstm_sequence_fwd_chunked`` is the chunk-indexed instance of the
forward (both paths), the policy-batched rollout step of a population
(JAX ``vmap``s the ``pallas_call`` over policy chunks,
``madrona_learn_tpu/rollouts.py:580``): ``x_proj`` holds B chunks of C
rows, ``wr`` / ``bias`` are ``[P, H, 4H]`` / ``[P, 4H]`` stacks, and chunk
b runs with policy ``chunk_policy[b]``'s weights, each row bitwise
``lstm_sequence_fwd``'s with them (a chunk whose policy lies outside
[0, P) is skipped, its rows NaN). Its plain twin runs
``lstm_sequence_reference``'s arithmetic chunk by chunk.
``lstm_sequence_bwd_chunked`` is the chunk-indexed instance of the
backward (both paths), the population's learn step over every train
policy at once (JAX ``vmap``s ``algo.update``, and with it the backward's
``pallas_call``, over policies, ``madrona_learn_tpu/train.py:315``): each
row's dx_proj / dh0 / dc0 bitwise ``lstm_sequence_bwd``'s with its
chunk's policy's weights, and ``dwr[p]`` / ``db[p]`` summed over the rows
of policy p's chunks in f32 and rounded once (zeros for a policy without
a chunk). Its split rule takes only a chunk's own rows and the SM count,
so a policy's weight gradients are the same whether its chunk comes alone
or among others. ``lstm_sequence_chunked`` is the differentiable pair
(``lstm_sequence_chunked_reference`` on the CPU, whose autograd defines
the backward). ``lstm_sequence_proj_fwd_chunked`` /
``lstm_sequence_proj_bwd_chunked`` are the projection kernels' instances
under the same ``vmap`` over the train policies: ``wi`` joins the stacks
as ``[P, F, 4H]``, each row's ys / cs and dx / dh0 / dc0 are bitwise the
single-policy projection kernels' with its chunk's policy's weights, and
``dwi[p]`` / ``dwr[p]`` / ``db[p]`` sum over policy p's chunks, split by
the single-policy rule over each chunk's rows alone;
``lstm_sequence_proj_chunked`` is their differentiable pair, whose plain
twin ``lstm_sequence_proj_chunked_reference`` runs
``lstm_sequence_proj_reference`` chunk by chunk.

CPU tensors take the plain versions; CUDA tensors launch the kernels or
raise.
"""

from __future__ import annotations

import functools

import torch

from .build import Kernel, check, check_operand, library

LSTM_FWD = Kernel(
    name="lstm_sequence_fwd",
    source="madrona_learn_tpu_torch/csrc/lstm.cu",
    replaces="madrona_learn_tpu/ops/pallas/lstm.py:264",
)
LSTM_BWD = Kernel(
    name="lstm_sequence_bwd",
    source="madrona_learn_tpu_torch/csrc/lstm.cu",
    replaces="madrona_learn_tpu/ops/pallas/lstm.py:283",
)
# The chunk-indexed instance of the forward: the policy-batched rollout
# step over a population's chunk layout (rollouts.chunked_rollout_loop).
LSTM_FWD_CHUNKED = Kernel(
    name="lstm_sequence_fwd_chunked",
    source="madrona_learn_tpu_torch/csrc/lstm.cu",
    replaces="madrona_learn_tpu/ops/pallas/lstm.py:264",
)
# The chunk-indexed instance of the backward: the population's learn step
# over every train policy, one chunk a policy (ppo._ppo_population).
LSTM_BWD_CHUNKED = Kernel(
    name="lstm_sequence_bwd_chunked",
    source="madrona_learn_tpu_torch/csrc/lstm.cu",
    replaces="madrona_learn_tpu/ops/pallas/lstm.py:301",
)
LSTM_PROJ_FWD = Kernel(
    name="lstm_sequence_proj_fwd",
    source="madrona_learn_tpu_torch/csrc/lstm.cu",
    replaces="madrona_learn_tpu/ops/pallas/lstm.py:546",
)
LSTM_PROJ_BWD = Kernel(
    name="lstm_sequence_proj_bwd",
    source="madrona_learn_tpu_torch/csrc/lstm.cu",
    replaces="madrona_learn_tpu/ops/pallas/lstm.py:562",
)
# The chunk-indexed instances of the projection kernels: the learn step of
# a fused-trunk population over every train policy (ppo._ppo_population).
LSTM_PROJ_FWD_CHUNKED = Kernel(
    name="lstm_sequence_proj_fwd_chunked",
    source="madrona_learn_tpu_torch/csrc/lstm.cu",
    replaces="madrona_learn_tpu/ops/pallas/lstm.py:516",
)
LSTM_PROJ_BWD_CHUNKED = Kernel(
    name="lstm_sequence_proj_bwd_chunked",
    source="madrona_learn_tpu_torch/csrc/lstm.cu",
    replaces="madrona_learn_tpu/ops/pallas/lstm.py:581",
)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# The widths the kernels are built for (the sequence kernels in every
# dtype, the projection kernels in float32 and bfloat16; the bfloat16 ones
# on tensor cores at all four), and those of the float16 tensor-core
# kernels.
_HIDDEN_SIZES = (128, 256, 384, 512)
_F16_TC_HIDDEN_SIZES = (128, 256)
# Batch rows a row tile of the tensor-core backward owns with the
# projection (kTcRows<true, H> in csrc/lstm.cu): 16 at H = 512, where 32
# leaves no room in shared memory for a ring stage.
_PROJ_TC_ROWS = {128: 32, 256: 32, 384: 32, 512: 16}


def lstm_supported(hidden, dtype):
    """Whether the sequence kernels serve this layer shape: true exactly for
    the (H, dtype) pairs with a kernel instance. In float32 and bfloat16
    that is JAX's gate (``ops/pallas/lstm.py:83``, ``H % 128 == 0``) for
    H up to 512; float16 too, on CUDA cores, where JAX takes its jnp twin
    (as in ``models/lstm.py``)."""
    return hidden in _HIDDEN_SIZES and dtype in _DTYPE_CODES


def lstm_kernel_route(hidden, dtype):
    """The modules' route for a layer of this shape: the sequence kernels
    (True) or their plain twins (False), by JAX's choice between its
    Pallas kernel and its jnp twin (``H % 128 == 0``,
    ``ops/pallas/lstm.py:83``), float16 going to the kernels as float32
    does. True wherever :func:`lstm_supported` is, and also at a multiple
    of 128 past 512, where no instance is built: such a layer raises on
    the card (the wrappers' operand check) instead of leaving the route
    JAX takes."""
    return hidden % 128 == 0 and dtype in _DTYPE_CODES


def _cell(x_proj_t, wr32, b32, c, h):
    """One step of the precise-gates cell: f32 math, storage-dtype carry."""
    f32 = torch.float32
    gates = x_proj_t.to(f32) + h.to(f32) @ wr32 + b32
    gi, gf, gg, go = gates.chunk(4, dim=-1)
    new_c = torch.sigmoid(gf) * c.to(f32) + torch.sigmoid(gi) * torch.tanh(gg)
    new_h = torch.sigmoid(go) * torch.tanh(new_c)
    return new_c.to(x_proj_t.dtype), new_h.to(x_proj_t.dtype)


def _sequence(x_proj, keep, wr, bias, c0, h0):
    """The forward's (ys, cs), each [T, N, H]; or, over chunks (x_proj
    [T, B, C, 4H], keep [T, B, C], wr [B, H, 4H], bias [B, 1, 4H], states
    [B, C, H]), each chunk with its own weights, [T, B, C, H]."""
    wr32, b32 = wr.float(), bias.float()
    c, h = c0, h0
    ys, cs = [], []
    for t in range(x_proj.shape[0]):
        new_c, new_h = _cell(x_proj[t], wr32, b32, c, h)
        mask = keep[t][..., None] > 0.5
        c = torch.where(mask, new_c, torch.zeros((), dtype=new_c.dtype,
                                                 device=new_c.device))
        h = torch.where(mask, new_h, torch.zeros((), dtype=new_h.dtype,
                                                 device=new_h.device))
        ys.append(new_h)
        cs.append(new_c)
    return torch.stack(ys), torch.stack(cs)


def _chunked(fn, x_proj, keep, weights, chunk_policy, states):
    """``fn`` (``_sequence``, or the GRU's sequence as a 1-tuple) over B
    chunks of ``x_proj`` [T, B * C, .], each chunk with its policy's
    ``weights`` (rows of their [P, ...] stacks); a chunk of no policy gets
    NaN rows. Returns fn's outputs as [T, B * C, H]. On the CPU a loop over
    the chunks, each chunk's rows (and their gradients) bitwise ``fn`` on
    them alone; on the card ``_chunk_batch``, with no host sync."""
    if x_proj.device.type != "cpu":
        return _chunk_batch(fn, x_proj, keep, weights, chunk_policy, states)
    B, P = chunk_policy.shape[0], weights[0].shape[0]
    C = x_proj.shape[1] // B
    parts = []
    for b, p in enumerate(chunk_policy.tolist()):
        rows = slice(b * C, (b + 1) * C)
        if 0 <= p < P:
            parts.append(fn(x_proj[:, rows], keep[:, rows],
                            *(w[p] for w in weights),
                            *(s[rows] for s in states)))
        else:
            # One output a carried state: (ys, cs) or (ys,).
            parts.append(tuple(
                torch.full((x_proj.shape[0], C, weights[0].shape[1]),
                           float("nan"), dtype=x_proj.dtype,
                           device=x_proj.device) for _ in states))
    return tuple(torch.cat(outs, dim=1) for outs in zip(*parts))


def _chunk_batch(fn, x_proj, keep, weights, chunk_policy, states):
    """``_chunked`` as one batched product a step over [B, C, .]: each
    chunk's weights gathered by ``chunk_policy`` (biases as [B, 1, .]), a
    chunk of no policy run on zeros with policy 0's weights and its rows
    set to NaN after. The same arithmetic as the loop, the products' sums
    in cuBLAS's order for a batch."""
    B = chunk_policy.shape[0]
    steps, n = x_proj.shape[:2]
    live = (chunk_policy >= 0) & (chunk_policy < weights[0].shape[0])
    idx = torch.where(live, chunk_policy, 0).long()
    w, bias = (t[idx] for t in weights)
    rows = live.repeat_interleave(n // B)[:, None]
    zero = torch.zeros((), dtype=x_proj.dtype, device=x_proj.device)
    split = lambda t: t.reshape(*t.shape[:-2], B, n // B, t.shape[-1])
    outs = fn(split(torch.where(rows, x_proj, zero)),
              keep.reshape(steps, B, n // B), w, bias[:, None],
              *(split(torch.where(rows, s, zero)) for s in states))
    return tuple(torch.where(rows, o.reshape(steps, n, o.shape[-1]),
                             float("nan")) for o in outs)


def lstm_sequence_reference(x_proj, keep, wr, bias, c0, h0):
    """Plain twin of ``lstm_sequence_reference`` (ops/pallas/lstm.py:643).

    Differentiable by autograd; its gradients are the plain version of
    ``lstm_sequence_bwd``.
    """
    return _sequence(x_proj, keep, wr, bias, c0, h0)[0]


def lstm_step_reference(x_proj, wr, bias, c, h):
    """Plain twin of ``lstm_step``: one step of the precise-gates cell,
    (new_c, new_h), differentiable."""
    return _cell(x_proj, wr.float(), bias.float(), c, h)


def lstm_sequence_fwd_chunked_reference(x_proj, keep, wr, bias,
                                        chunk_policy, c0, h0):
    """Plain twin of ``lstm_sequence_fwd_chunked``: each chunk's rows
    through ``lstm_sequence_reference``'s arithmetic with that chunk's
    policy's weights (a loop over the chunks on the CPU, one gathered
    batched product a step on the card: ``_chunked``); (ys, cs). A chunk
    whose policy lies outside [0, P) gets NaN rows."""
    return _chunked(_sequence, x_proj, keep, (wr, bias), chunk_policy,
                    (c0, h0))


def lstm_sequence_chunked_reference(x_proj, keep, wr, bias, chunk_policy,
                                    c0, h0):
    """Plain twin of ``lstm_sequence_chunked``: ys [T, B * C, H], each
    chunk through ``lstm_sequence_reference`` with its policy's weights
    (NaN rows for a chunk of no policy), as ``_chunked`` runs it.
    Differentiable by autograd, whose gradients are the plain version of
    ``lstm_sequence_bwd_chunked``: a policy's ``wr`` / ``bias`` gradients
    sum over its chunks' rows, and a policy without a chunk gets zeros."""
    return _chunked(_sequence, x_proj, keep, (wr, bias), chunk_policy,
                    (c0, h0))[0]


_check = functools.partial(check_operand, "lstm kernel")


def _check_inputs(x_proj, keep, wr, bias, c0, h0):
    if x_proj.dim() != 3 or x_proj.shape[-1] % 4:
        raise ValueError(f"lstm kernel: x_proj must be [T, N, 4H], got "
                         f"{tuple(x_proj.shape)}")
    steps, n, g4 = x_proj.shape
    hidden = g4 // 4
    dtype = x_proj.dtype
    if not lstm_supported(hidden, dtype):
        raise ValueError(
            f"lstm kernel: supports float32/bfloat16/float16 with H in "
            f"{_HIDDEN_SIZES}, got {dtype} H={hidden}")
    if steps == 0 or n == 0:
        raise ValueError(f"lstm kernel: empty input {tuple(x_proj.shape)}")
    _check("x_proj", x_proj, dtype, (steps, n, g4))
    _check("keep", keep, dtype, (steps, n))
    _check("wr", wr, dtype, (hidden, g4))
    _check("bias", bias, dtype, (g4,))
    _check("c0", c0, dtype, (n, hidden))
    _check("h0", h0, dtype, (n, hidden))
    return steps, n, hidden


def _fwd_tc(x, keep, wi, wr, bias, c0, h0, out=None, wit=None):
    """The tensor-core forward of both variants (``wi`` None: x is x_proj;
    bfloat16, or float16 without the projection): (ys, cs), into ``out``
    where given. ``wit`` (f32 [2, T, N, 4H]; the bf16 projection at H =
    384 and 512 alone): each step's round(x . Wi), then round(x . Wi) +
    h . Wr, the products' witness."""
    steps, n = x.shape[:2]
    hidden = wr.shape[0]
    f_in = 0 if wi is None else x.shape[2]
    # x and h0 arrive by 16-byte copies, the weights by TMA.
    x, h0, wr = on_16_bytes(x), on_16_bytes(h0), on_16_bytes(wr)
    wi = wr if wi is None else on_16_bytes(wi)
    if out is None:
        ys = torch.empty((steps, n, hidden), dtype=x.dtype, device=x.device)
        out = ys, torch.empty_like(ys)
    ys, cs = out
    args = (x.data_ptr(), keep.data_ptr(), wi.data_ptr(), wr.data_ptr(),
            bias.data_ptr(), c0.data_ptr(), h0.data_ptr(), ys.data_ptr(),
            cs.data_ptr(), steps, n)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if wit is None:
        err = library().mlt_lstm_fwd_tc(_DTYPE_CODES[x.dtype], hidden, f_in,
                                        *args, stream)
    else:
        err = library().mlt_lstm_proj_fwd_witness(hidden, f_in, *args,
                                                  wit.data_ptr(), stream)
    check(err, "lstm_sequence_proj_fwd" if f_in else "lstm_sequence_fwd")
    return ys, cs


def lstm_sequence_fwd(x_proj, keep, wr, bias, c0, h0):
    """The forward kernel: (ys, cs), each [T, N, H] in the storage dtype."""
    steps, n, hidden = _check_inputs(x_proj, keep, wr, bias, c0, h0)
    if fwd_uses_tensor_cores(x_proj.dtype, hidden):
        ys, cs = _fwd_tc(x_proj, keep, None, wr, bias, c0, h0)
        LSTM_FWD.launches += 1
        LSTM_FWD.tc_launches += 1
        return ys, cs
    ys = torch.empty((steps, n, hidden), dtype=x_proj.dtype,
                     device=x_proj.device)
    cs = torch.empty_like(ys)
    err = library().mlt_lstm_fwd(
        _DTYPE_CODES[x_proj.dtype], hidden, x_proj.data_ptr(),
        keep.data_ptr(), wr.data_ptr(), bias.data_ptr(), c0.data_ptr(),
        h0.data_ptr(), ys.data_ptr(), cs.data_ptr(), steps, n,
        torch.cuda.current_stream(x_proj.device).cuda_stream)
    check(err, "lstm_sequence_fwd")
    LSTM_FWD.launches += 1
    return ys, cs


def lstm_sequence_fwd_chunked(x_proj, keep, wr, bias, chunk_policy, c0,
                              h0):
    """The chunk-indexed forward kernel: ``x_proj`` [T, B * C, 4H] and
    ``keep`` [T, B * C] of B chunks of C rows, ``wr`` [P, H, 4H] and
    ``bias`` [P, 4H] stacks, ``chunk_policy`` [B] int32, ``c0`` / ``h0``
    [B * C, H] -> (ys, cs), each [T, B * C, H]; chunk b runs with policy
    ``chunk_policy[b]``'s weights, and every row equals
    ``lstm_sequence_fwd``'s row with those weights bitwise. A chunk whose
    policy lies outside [0, P) is skipped: its rows are NaN. Same path
    rule as ``lstm_sequence_fwd``; float32, bfloat16 or float16."""
    steps, n, hidden, B, _, P = _check_chunked(
        "lstm_sequence_fwd_chunked", x_proj, keep, wr, bias, chunk_policy,
        c0, h0)
    tensor_core = fwd_uses_tensor_cores(x_proj.dtype, hidden)
    if tensor_core:
        # x_proj and h0 arrive by 16-byte copies, the weights by TMA.
        x_proj, h0, wr = map(on_16_bytes, (x_proj, h0, wr))
    ys = torch.empty((steps, n, hidden), dtype=x_proj.dtype,
                     device=x_proj.device)
    cs = torch.empty_like(ys)
    err = library().mlt_lstm_fwd_chunked(
        int(tensor_core), _DTYPE_CODES[x_proj.dtype], hidden,
        x_proj.data_ptr(), keep.data_ptr(), wr.data_ptr(), bias.data_ptr(),
        chunk_policy.data_ptr(), c0.data_ptr(), h0.data_ptr(),
        ys.data_ptr(), cs.data_ptr(), steps, B, n // B, P,
        torch.cuda.current_stream(x_proj.device).cuda_stream)
    check(err, "lstm_sequence_fwd_chunked")
    LSTM_FWD_CHUNKED.launches += 1
    LSTM_FWD_CHUNKED.tc_launches += int(tensor_core)
    return ys, cs


def lstm_step_chunked(x_proj, wr, bias, chunk_policy, c, h):
    """The policy-batched rollout step, (new_c, new_h) [B * C, H], no
    clearing: ``lstm_step`` for every chunk of B at once, chunk b with
    policy ``chunk_policy[b]``'s weights of the [P, H, 4H] / [P, 4H]
    stacks. On the card, ``lstm_sequence_fwd_chunked`` with T = 1, whose
    rows equal ``lstm_sequence_fwd``'s: the rollout step and the update
    pass share gate math and rounding points, as for one policy."""
    if x_proj.device.type == "cpu":
        return lstm_step_chunked_reference(x_proj, wr, bias, chunk_policy, c,
                                           h)
    keep = torch.ones((1, x_proj.shape[0]), dtype=x_proj.dtype,
                      device=x_proj.device)
    ys, cs = lstm_sequence_fwd_chunked(x_proj.unsqueeze(0), keep, wr, bias,
                                       chunk_policy, c, h)
    return cs[0], ys[0]


def lstm_step_chunked_reference(x_proj, wr, bias, chunk_policy, c, h):
    """Plain twin of ``lstm_step_chunked``: ``lstm_sequence_fwd_chunked``'s
    twin at T = 1, (new_c, new_h)."""
    keep = torch.ones((1, x_proj.shape[0]), dtype=x_proj.dtype,
                      device=x_proj.device)
    ys, cs = lstm_sequence_fwd_chunked_reference(
        x_proj.unsqueeze(0), keep, wr, bias, chunk_policy, c, h)
    return cs[0], ys[0]


def _check_chunked(what, x_proj, keep, wr, bias, chunk_policy, c0, h0):
    """The chunked instances' operand checks: (T, N, H, B, C, P)."""
    if wr.dim() != 3 or chunk_policy.dim() != 1 or x_proj.dim() != 3:
        raise ValueError(
            f"{what}: wr must be [P, H, 4H], chunk_policy [B] and x_proj "
            f"[T, B * C, 4H], got {tuple(wr.shape)}, "
            f"{tuple(chunk_policy.shape)}, {tuple(x_proj.shape)}")
    P, B = wr.shape[0], chunk_policy.shape[0]
    if x_proj.dtype not in _DTYPE_CODES or B == 0 or x_proj.shape[1] % B \
            or P == 0:
        raise ValueError(
            f"{what}: supports float32/bfloat16/float16 over whole chunks, "
            f"got {x_proj.dtype}, {tuple(x_proj.shape)} rows in {B} chunks "
            f"of {P} policies")
    steps, n, hidden = _check_inputs(x_proj, keep, wr[0], bias[0], c0, h0)
    _check("wr", wr, x_proj.dtype, (P, hidden, 4 * hidden))
    _check("bias", bias, x_proj.dtype, (P, 4 * hidden))
    _check("chunk_policy", chunk_policy, torch.int32, (B,))
    return steps, n, hidden, B, n // B, P


def lstm_sequence_bwd_chunked(x_proj, keep, wr, bias, chunk_policy, c0, h0,
                              ys, cs, dys):
    """The chunk-indexed backward kernel, given ``lstm_sequence_fwd_chunked``'s
    ys / cs: (dx_proj [T, B * C, 4H], dwr [P, H, 4H], db [P, 4H], dc0, dh0
    [B * C, H]). Chunk b runs with policy ``chunk_policy[b]``'s weights:
    every row's dx_proj / dh0 / dc0 equal ``lstm_sequence_bwd``'s on that
    chunk's rows bitwise, and ``dwr[p]`` / ``db[p]`` sum over the rows of
    policy p's chunks in f32, rounded once; zeros for a policy without a
    chunk (a chunk whose policy lies outside [0, P) gets NaN rows and adds
    to no policy). The weight gradients split each chunk's rows by the
    single-policy rule applied to the chunk alone. Same path rule as
    ``lstm_sequence_bwd`` (:func:`bwd_uses_tensor_cores`); float32,
    bfloat16 or float16."""
    what = "lstm_sequence_bwd_chunked"
    steps, n, hidden, B, C, P = _check_chunked(what, x_proj, keep, wr, bias,
                                               chunk_policy, c0, h0)
    dtype, device = x_proj.dtype, x_proj.device
    _check("ys", ys, dtype, (steps, n, hidden))
    _check("cs", cs, dtype, (steps, n, hidden))
    _check("dys", dys, dtype, (steps, n, hidden))
    tensor_core = bwd_uses_tensor_cores(dtype, hidden)
    num_sms = torch.cuda.get_device_properties(device).multi_processor_count
    g4 = 4 * hidden

    def empty(*shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device=device)

    # Wr^T of every policy, [P, 4H, H]: one copy a call, on a 16-byte
    # boundary as new storage.
    wr_t = wr.transpose(1, 2).contiguous()
    if tensor_core:
        x_proj, keep, wr, bias, c0, h0, ys, cs, dys = map(
            on_16_bytes, (x_proj, keep, wr, bias, c0, h0, ys, cs, dys))
        splits = _num_splits_tc(steps * C, hidden, hidden, num_sms)
        hin = empty(steps, n, hidden)
        part_b = empty(B * -(-C // tc_rows(False, hidden)), g4,
                       dt=torch.float32)
    else:
        splits = _num_splits(steps, C, hidden, num_sms)
        hin = None
        part_b = empty(B * splits, g4, dt=torch.float32)
    part_w = empty(B * splits, hidden, g4, dt=torch.float32)
    dxp, dh0, dc0 = empty(steps, n, g4), empty(n, hidden), empty(n, hidden)
    dwr, db = empty(P, hidden, g4), empty(P, g4)
    err = library().mlt_lstm_bwd_chunked(
        int(tensor_core), _DTYPE_CODES[dtype], hidden, x_proj.data_ptr(),
        keep.data_ptr(), wr.data_ptr(), wr_t.data_ptr(), bias.data_ptr(),
        chunk_policy.data_ptr(), c0.data_ptr(), h0.data_ptr(), ys.data_ptr(),
        cs.data_ptr(), dys.data_ptr(), dxp.data_ptr(),
        0 if hin is None else hin.data_ptr(), dh0.data_ptr(), dc0.data_ptr(),
        part_w.data_ptr(), part_b.data_ptr(), dwr.data_ptr(), db.data_ptr(),
        steps, B, C, P, splits, torch.cuda.current_stream(device).cuda_stream)
    check(err, what)
    LSTM_BWD_CHUNKED.launches += 1
    LSTM_BWD_CHUNKED.tc_launches += int(tensor_core)
    return dxp, dwr, db, dc0, dh0


class _LSTMSequenceChunked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_proj, keep, wr, bias, chunk_policy, c0, h0):
        ys, cs = lstm_sequence_fwd_chunked(x_proj, keep, wr, bias,
                                           chunk_policy, c0, h0)
        ctx.save_for_backward(x_proj, keep, wr, bias, chunk_policy, c0, h0,
                              ys, cs)
        return ys

    @staticmethod
    def backward(ctx, dys):
        x_proj, keep, wr, bias, chunk_policy, c0, h0, ys, cs = \
            ctx.saved_tensors
        dxp, dwr, db, dc0, dh0 = lstm_sequence_bwd_chunked(
            x_proj, keep, wr, bias, chunk_policy, c0, h0, ys, cs,
            dys.to(x_proj.dtype).contiguous())
        return dxp, None, dwr, db, None, dc0, dh0


def lstm_sequence_chunked(x_proj, keep, wr, bias, chunk_policy, c0, h0):
    """ys [T, B * C, H]: the chunk-indexed sequence pass, differentiable,
    chunk b with policy ``chunk_policy[b]``'s weights of the [P, H, 4H] /
    [P, 4H] stacks (the contract of ``lstm_sequence_fwd_chunked`` and
    ``lstm_sequence_bwd_chunked``). CPU tensors take the plain twin."""
    if x_proj.device.type == "cpu":
        return lstm_sequence_chunked_reference(x_proj, keep, wr, bias,
                                               chunk_policy, c0, h0)
    return _LSTMSequenceChunked.apply(x_proj, keep, wr, bias, chunk_policy,
                                      c0, h0)


def _num_splits(steps, n, hidden, num_sms, gates=4):
    """Row splits for the CUDA-core weight-gradient partials of an
    [H, gates * H] weight: about four blocks per SM, and at least 32 rows
    per split."""
    tiles = (gates * hidden // 64) * (hidden // 64)
    return max(1, min(-(-4 * num_sms // tiles), (steps * n) // 32))


def tc_rows(proj, hidden):
    """Batch rows a row tile of the tensor-core backward owns (kTcRows in
    csrc/lstm.cu): 16, and with the projection 32 (16 at H = 512)."""
    return _PROJ_TC_ROWS[hidden] if proj else 16


def fwd_tc_rows():
    """Batch rows a block of the tensor-core forward owns in both variants
    (kFwdTcRows in csrc/lstm.cu)."""
    return 32


def uses_tensor_cores(dtype, hidden):
    """The path rule of the projection kernels (``lstm_sequence_proj_*``
    and their chunk-indexed instances): bfloat16 at every width they are
    built for takes the tensor-core kernels (``wgmma``; a cluster of two
    blocks at H = 384 and 512); float32, whose products tensor cores would
    round, the CUDA-core ones. (The projection's F rule holds on both
    paths, and :func:`lstm_proj_supported` refuses float16.)"""
    return dtype == torch.bfloat16 and hidden in _HIDDEN_SIZES


def bwd_uses_tensor_cores(dtype, hidden):
    """The path rule of the sequence kernels, one for the backward and the
    forward (``fwd_uses_tensor_cores`` is this function), their
    chunk-indexed instances and so ``lstm_step`` / ``lstm_step_chunked``,
    so that a float16 or bfloat16 backward on tensor cores recomputes the
    pre-activations of the forward that ran, bitwise: bfloat16 at every
    width the kernels are built for takes the tensor-core kernels (split
    over a cluster of two blocks at H = 384 and 512), and so does float16
    at H = 128 and 256 (f16 ``wgmma``); float32, whose products tensor
    cores would round, and float16 at 384 and 512 the CUDA-core ones."""
    return ((dtype == torch.bfloat16 and hidden in _HIDDEN_SIZES)
            or (dtype == torch.float16 and hidden in _F16_TC_HIDDEN_SIZES))


fwd_uses_tensor_cores = bwd_uses_tensor_cores


def on_16_bytes(t):
    """t, or a contiguous copy of it on a 16-byte boundary (TMA and the
    tensor-core kernel's 16-byte copies need one) if t is not on one."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _num_splits_tc(rows, a_width, hidden, num_sms, gates=4):
    """Row splits for the tensor-core weight-gradient partials of an
    [a_width, gates * H] weight: about two blocks of 128 x 128 per SM, and
    at least 256 rows per split."""
    tiles = (a_width // 128) * (gates * hidden // 128)
    return max(1, min(-(-2 * num_sms // tiles), rows // 256))


def _bwd_tc_buffers(x, wi, wr):
    """Outputs and scratch of :func:`_bwd_tc` for these operands."""
    steps, n = x.shape[:2]
    hidden = wr.shape[0]
    f_in = 0 if wi is None else x.shape[2]
    dtype, device = x.dtype, x.device
    splits = _num_splits_tc(
        steps * n, f_in + hidden, hidden,
        torch.cuda.get_device_properties(device).multi_processor_count)

    def empty(*shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device=device)

    dg = empty(steps, n, 4 * hidden)
    return dict(
        splits=splits, dg=dg, dx=dg if wi is None else torch.empty_like(x),
        hin=empty(steps, n, hidden), dh0=empty(n, hidden),
        dc0=empty(n, hidden),
        part_w=empty(splits, f_in + hidden, 4 * hidden, dt=torch.float32),
        part_b=empty(-(-n // tc_rows(wi is not None, hidden)), 4 * hidden,
                     dt=torch.float32),
        dw=empty(f_in + hidden, 4 * hidden), db=empty(4 * hidden))


def _bwd_tc(x, keep, wi, wr, bias, c0, h0, ys, cs, dys, *, phases=3,
            buffers=None, wit=None):
    """The tensor-core backward of both variants (``wi`` None: x is
    x_proj; bfloat16, or float16 without the projection) in its two
    passes, phases bit 0 the recurrence and bit 1 the weight gradients;
    the buffers of :func:`_bwd_tc_buffers`, filled. ``wit`` (f32 [2, T, N,
    4H]; the bf16 projection at H = 384 and 512, the recurrence alone):
    the recomputed products, what :func:`_fwd_tc` writes to its ``wit``
    from the same carry."""
    steps, n = x.shape[:2]
    hidden = wr.shape[0]
    f_in = 0 if wi is None else x.shape[2]
    x, keep, bias, c0, h0, ys, cs, dys = map(
        on_16_bytes, (x, keep, bias, c0, h0, ys, cs, dys))
    if buffers is None:
        buffers = _bwd_tc_buffers(x, wi, wr)
    b = buffers
    # The transposed copies are new storage, on a 16-byte boundary.
    wr_t = wr.t().contiguous()
    wi_t = wr_t if wi is None else wi.t().contiguous()
    wr = on_16_bytes(wr)
    wi = wr if wi is None else on_16_bytes(wi)
    if wit is not None:
        err = library().mlt_lstm_proj_bwd_witness(
            hidden, f_in, x.data_ptr(), keep.data_ptr(), wi.data_ptr(),
            wi_t.data_ptr(), wr.data_ptr(), wr_t.data_ptr(), bias.data_ptr(),
            c0.data_ptr(), h0.data_ptr(), ys.data_ptr(), cs.data_ptr(),
            dys.data_ptr(), b["dx"].data_ptr(), b["dg"].data_ptr(),
            b["hin"].data_ptr(), b["dh0"].data_ptr(), b["dc0"].data_ptr(),
            b["part_b"].data_ptr(), steps, n, wit.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
        check(err, "lstm_sequence_proj_bwd")
        return b
    err = library().mlt_lstm_bwd_tc(
        _DTYPE_CODES[x.dtype], hidden, f_in, phases, x.data_ptr(),
        keep.data_ptr(),
        wi.data_ptr(), wi_t.data_ptr(),
        wr.data_ptr(), wr_t.data_ptr(), bias.data_ptr(), c0.data_ptr(),
        h0.data_ptr(), ys.data_ptr(), cs.data_ptr(), dys.data_ptr(),
        b["dx"].data_ptr(), b["dg"].data_ptr(), b["hin"].data_ptr(),
        b["dh0"].data_ptr(), b["dc0"].data_ptr(), b["part_w"].data_ptr(),
        b["part_b"].data_ptr(), b["dw"].data_ptr(), b["db"].data_ptr(),
        steps, n, b["splits"], torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "lstm_sequence_proj_bwd" if f_in else "lstm_sequence_bwd")
    return b


def lstm_sequence_bwd(x_proj, keep, wr, bias, c0, h0, ys, cs, dys):
    """The backward kernel: (dx_proj, dwr, db, dc0, dh0) given the
    forward's ys / cs, on the route :func:`bwd_uses_tensor_cores` names."""
    steps, n, hidden = _check_inputs(x_proj, keep, wr, bias, c0, h0)
    dtype, device = x_proj.dtype, x_proj.device
    _check("ys", ys, dtype, (steps, n, hidden))
    _check("cs", cs, dtype, (steps, n, hidden))
    _check("dys", dys, dtype, (steps, n, hidden))
    if bwd_uses_tensor_cores(dtype, hidden):
        b = _bwd_tc(x_proj, keep, None, wr, bias, c0, h0, ys, cs, dys)
        LSTM_BWD.launches += 1
        LSTM_BWD.tc_launches += 1
        return b["dg"], b["dw"], b["db"], b["dc0"], b["dh0"]
    wr_t = wr.t().contiguous()
    splits = _num_splits(
        steps, n, hidden,
        torch.cuda.get_device_properties(device).multi_processor_count)
    dxp = torch.empty_like(x_proj)
    dh0 = torch.empty_like(h0)
    dc0 = torch.empty_like(c0)
    part_w = torch.empty((splits, hidden, 4 * hidden), dtype=torch.float32,
                         device=device)
    part_b = torch.empty((splits, 4 * hidden), dtype=torch.float32,
                         device=device)
    dwr = torch.empty_like(wr)
    db = torch.empty_like(bias)
    err = library().mlt_lstm_bwd(
        _DTYPE_CODES[dtype], hidden, x_proj.data_ptr(), keep.data_ptr(),
        wr.data_ptr(), wr_t.data_ptr(), bias.data_ptr(), c0.data_ptr(),
        h0.data_ptr(), ys.data_ptr(), cs.data_ptr(), dys.data_ptr(),
        dxp.data_ptr(), dh0.data_ptr(), dc0.data_ptr(), part_w.data_ptr(),
        part_b.data_ptr(), dwr.data_ptr(), db.data_ptr(), steps, n, splits,
        torch.cuda.current_stream(device).cuda_stream)
    check(err, "lstm_sequence_bwd")
    LSTM_BWD.launches += 1
    return dxp, dwr, db, dc0, dh0


class _LSTMSequence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_proj, keep, wr, bias, c0, h0):
        ys, cs = lstm_sequence_fwd(x_proj, keep, wr, bias, c0, h0)
        ctx.save_for_backward(x_proj, keep, wr, bias, c0, h0, ys, cs)
        return ys

    @staticmethod
    def backward(ctx, dys):
        x_proj, keep, wr, bias, c0, h0, ys, cs = ctx.saved_tensors
        dxp, dwr, db, dc0, dh0 = lstm_sequence_bwd(
            x_proj, keep, wr, bias, c0, h0, ys, cs,
            dys.to(x_proj.dtype).contiguous())
        # keep is a mask: its cotangent is zero, as in the JAX VJP.
        return dxp, None, dwr, db, dc0, dh0


def lstm_sequence(x_proj, keep, wr, bias, c0, h0):
    """ys [T, N, H]: the fused sequence pass, differentiable."""
    if x_proj.device.type == "cpu":
        return lstm_sequence_reference(x_proj, keep, wr, bias, c0, h0)
    return _LSTMSequence.apply(x_proj, keep, wr, bias, c0, h0)


def lstm_step(x_proj, wr, bias, c, h):
    """One rollout step, (new_c, new_h) [N, H], no clearing.

    On the card this is ``lstm_sequence_fwd`` with T = 1, so the rollout
    forward and the update-pass sequence forward share gate math and
    rounding points and PPO's ratio can start at 1.
    """
    if x_proj.device.type == "cpu":
        return lstm_step_reference(x_proj, wr, bias, c, h)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x_proj, wr, bias, c, h)):
        raise RuntimeError("lstm_step has no backward on CUDA; run the "
                           "rollout step under torch.no_grad()")
    keep = torch.ones((1, x_proj.shape[0]), dtype=x_proj.dtype,
                      device=x_proj.device)
    ys, cs = lstm_sequence_fwd(x_proj.unsqueeze(0), keep, wr, bias, c, h)
    return cs[0], ys[0]


def lstm_proj_supported(in_features, hidden, dtype):
    """Whether the projection kernels serve this layer shape: JAX's gate
    (``ops/pallas/lstm.py:369``: float32 or bfloat16, H % 128 == 0,
    F % 128 == 0 and F <= 4H) at the widths they are built for, H = 128,
    256, 384 and 512. Past 512 a ``fuse_input_proj`` layer takes the
    unfused sequence route (which raises on the card there)."""
    return (hidden in _HIDDEN_SIZES
            and dtype in (torch.float32, torch.bfloat16)
            and in_features % 128 == 0 and in_features <= 4 * hidden)


def lstm_sequence_proj_reference(x, keep, wi, wr, bias, c0, h0):
    """Plain twin (JAX: ``ops/pallas/lstm.py:635``): the hoisted
    ``round(x . Wi)`` followed by the sequence twin. Differentiable by
    autograd."""
    x_proj = (x.float() @ wi.float()).to(x.dtype)
    return lstm_sequence_reference(x_proj, keep, wr, bias, c0, h0)


def _check_proj_inputs(x, keep, wi, wr, bias, c0, h0):
    if x.dim() != 3 or wr.dim() != 2:
        raise ValueError(f"lstm_sequence_proj: x must be [T, N, F] and wr "
                         f"[H, 4H], got {tuple(x.shape)}, {tuple(wr.shape)}")
    steps, n, f_in = x.shape
    hidden = wr.shape[0]
    dtype = x.dtype
    if not lstm_proj_supported(f_in, hidden, dtype):
        raise ValueError(
            f"lstm_sequence_proj: supports float32/bfloat16, H in "
            f"{_HIDDEN_SIZES}, F % 128 == 0 and F <= 4H; got {dtype}, "
            f"H={hidden}, F={f_in}")
    if steps == 0 or n == 0:
        raise ValueError(f"lstm_sequence_proj: empty input "
                         f"{tuple(x.shape)}")
    _check("x", x, dtype, (steps, n, f_in))
    _check("keep", keep, dtype, (steps, n))
    _check("wi", wi, dtype, (f_in, 4 * hidden))
    _check("wr", wr, dtype, (hidden, 4 * hidden))
    _check("bias", bias, dtype, (4 * hidden,))
    _check("c0", c0, dtype, (n, hidden))
    _check("h0", h0, dtype, (n, hidden))
    return steps, n, f_in, hidden


def lstm_sequence_proj_fwd(x, keep, wi, wr, bias, c0, h0):
    """The projection forward kernel: (ys, cs), each [T, N, H]."""
    steps, n, f_in, hidden = _check_proj_inputs(x, keep, wi, wr, bias, c0,
                                                h0)
    if uses_tensor_cores(x.dtype, hidden):
        ys, cs = _fwd_tc(x, keep, wi, wr, bias, c0, h0)
        LSTM_PROJ_FWD.launches += 1
        LSTM_PROJ_FWD.tc_launches += 1
        return ys, cs
    ys = torch.empty((steps, n, hidden), dtype=x.dtype, device=x.device)
    cs = torch.empty_like(ys)
    err = library().mlt_lstm_proj_fwd(
        _DTYPE_CODES[x.dtype], hidden, f_in, x.data_ptr(), keep.data_ptr(),
        wi.data_ptr(), wr.data_ptr(), bias.data_ptr(), c0.data_ptr(),
        h0.data_ptr(), ys.data_ptr(), cs.data_ptr(), steps, n,
        torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "lstm_sequence_proj_fwd")
    LSTM_PROJ_FWD.launches += 1
    return ys, cs


def lstm_sequence_proj_bwd(x, keep, wi, wr, bias, c0, h0, ys, cs, dys):
    """The projection backward kernel: (dx, dwi, dwr, db, dc0, dh0) given
    the forward's ys / cs. The rounded dgates go through a [T, N, 4H]
    scratch to the weight-gradient pass."""
    steps, n, f_in, hidden = _check_proj_inputs(x, keep, wi, wr, bias, c0,
                                                h0)
    dtype, device = x.dtype, x.device
    _check("ys", ys, dtype, (steps, n, hidden))
    _check("cs", cs, dtype, (steps, n, hidden))
    _check("dys", dys, dtype, (steps, n, hidden))
    if uses_tensor_cores(dtype, hidden):
        b = _bwd_tc(x, keep, wi, wr, bias, c0, h0, ys, cs, dys)
        LSTM_PROJ_BWD.launches += 1
        LSTM_PROJ_BWD.tc_launches += 1
        dw = b["dw"]
        return b["dx"], dw[:f_in], dw[f_in:], b["db"], b["dc0"], b["dh0"]
    wi_t = wi.t().contiguous()
    wr_t = wr.t().contiguous()
    splits = _num_splits(
        steps, n, hidden,
        torch.cuda.get_device_properties(device).multi_processor_count)
    dx = torch.empty_like(x)
    dg = torch.empty((steps, n, 4 * hidden), dtype=dtype, device=device)
    dh0 = torch.empty_like(h0)
    dc0 = torch.empty_like(c0)
    part_wi = torch.empty((splits, f_in, 4 * hidden), dtype=torch.float32,
                          device=device)
    part_w = torch.empty((splits, hidden, 4 * hidden), dtype=torch.float32,
                         device=device)
    part_b = torch.empty((splits, 4 * hidden), dtype=torch.float32,
                         device=device)
    dwi = torch.empty_like(wi)
    dwr = torch.empty_like(wr)
    db = torch.empty_like(bias)
    err = library().mlt_lstm_proj_bwd(
        _DTYPE_CODES[dtype], hidden, f_in, x.data_ptr(), keep.data_ptr(),
        wi.data_ptr(), wi_t.data_ptr(), wr.data_ptr(), wr_t.data_ptr(),
        bias.data_ptr(), c0.data_ptr(), h0.data_ptr(), ys.data_ptr(),
        cs.data_ptr(), dys.data_ptr(), dx.data_ptr(), dg.data_ptr(),
        dh0.data_ptr(), dc0.data_ptr(), part_wi.data_ptr(),
        part_w.data_ptr(), part_b.data_ptr(), dwi.data_ptr(),
        dwr.data_ptr(), db.data_ptr(), steps, n, splits,
        torch.cuda.current_stream(device).cuda_stream)
    check(err, "lstm_sequence_proj_bwd")
    LSTM_PROJ_BWD.launches += 1
    return dx, dwi, dwr, db, dc0, dh0


class _LSTMSequenceProj(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, keep, wi, wr, bias, c0, h0):
        ys, cs = lstm_sequence_proj_fwd(x, keep, wi, wr, bias, c0, h0)
        ctx.save_for_backward(x, keep, wi, wr, bias, c0, h0, ys, cs)
        return ys

    @staticmethod
    def backward(ctx, dys):
        x, keep, wi, wr, bias, c0, h0, ys, cs = ctx.saved_tensors
        dx, dwi, dwr, db, dc0, dh0 = lstm_sequence_proj_bwd(
            x, keep, wi, wr, bias, c0, h0, ys, cs,
            dys.to(x.dtype).contiguous())
        return dx, None, dwi, dwr, db, dc0, dh0


def lstm_sequence_proj(x, keep, wi, wr, bias, c0, h0):
    """ys [T, N, H]: ``lstm_sequence(round(x . Wi), ...)`` with the
    projection inside the kernel, differentiable."""
    if x.device.type == "cpu":
        return lstm_sequence_proj_reference(x, keep, wi, wr, bias, c0, h0)
    return _LSTMSequenceProj.apply(x, keep, wi, wr, bias, c0, h0)


def _project_chunks(x, wi, chunk_policy):
    """x_proj [T, B * C, 4H]: each chunk's ``round(x . Wi)`` with its
    policy's Wi of the [P, F, 4H] stack (the hoisted Dense's rounding
    point), zeros for a chunk of no policy. Differentiable."""
    B, P = chunk_policy.shape[0], wi.shape[0]
    C = x.shape[1] // B
    parts = []
    for b, p in enumerate(chunk_policy.tolist()):
        xb = x[:, b * C:(b + 1) * C]
        parts.append((xb.float() @ wi[p].float()).to(x.dtype) if 0 <= p < P
                     else xb.new_zeros((*xb.shape[:2], wi.shape[2])))
    return torch.cat(parts, dim=1)


def lstm_sequence_proj_fwd_chunked_reference(x, keep, wi, wr, bias,
                                             chunk_policy, c0, h0):
    """Plain twin of ``lstm_sequence_proj_fwd_chunked``: each chunk's rows
    through ``lstm_sequence_proj_reference``'s arithmetic with that chunk's
    policy's weights, gathered; (ys, cs). A chunk whose policy lies
    outside [0, P) gets NaN rows."""
    return lstm_sequence_fwd_chunked_reference(
        _project_chunks(x, wi, chunk_policy), keep, wr, bias, chunk_policy,
        c0, h0)


def lstm_sequence_proj_chunked_reference(x, keep, wi, wr, bias,
                                         chunk_policy, c0, h0):
    """Plain twin of ``lstm_sequence_proj_chunked``: ys [T, B * C, H], each
    chunk through ``lstm_sequence_proj_reference`` with its policy's
    weights (NaN rows for a chunk of no policy). Differentiable by
    autograd, whose gradients are the plain version of
    ``lstm_sequence_proj_bwd_chunked``: a policy's ``wi`` / ``wr`` /
    ``bias`` gradients sum over its chunks' rows, and a policy without a
    chunk gets zeros."""
    return lstm_sequence_chunked_reference(
        _project_chunks(x, wi, chunk_policy), keep, wr, bias, chunk_policy,
        c0, h0)


def _check_proj_chunked(what, x, keep, wi, wr, bias, chunk_policy, c0, h0):
    """The chunked projection instances' operand checks: (T, N, F, H, B,
    C, P)."""
    if (wi.dim() != 3 or wr.dim() != 3 or chunk_policy.dim() != 1
            or x.dim() != 3):
        raise ValueError(
            f"{what}: wi must be [P, F, 4H], wr [P, H, 4H], chunk_policy "
            f"[B] and x [T, B * C, F], got {tuple(wi.shape)}, "
            f"{tuple(wr.shape)}, {tuple(chunk_policy.shape)}, "
            f"{tuple(x.shape)}")
    P, B = wr.shape[0], chunk_policy.shape[0]
    if B == 0 or P == 0 or x.shape[1] % B:
        raise ValueError(f"{what}: {x.shape[1]} rows are not {B} whole "
                         f"chunks of {P} policies")
    steps, n, f_in, hidden = _check_proj_inputs(x, keep, wi[0], wr[0],
                                                bias[0], c0, h0)
    _check("wi", wi, x.dtype, (P, f_in, 4 * hidden))
    _check("wr", wr, x.dtype, (P, hidden, 4 * hidden))
    _check("bias", bias, x.dtype, (P, 4 * hidden))
    _check("chunk_policy", chunk_policy, torch.int32, (B,))
    return steps, n, f_in, hidden, B, n // B, P


def lstm_sequence_proj_fwd_chunked(x, keep, wi, wr, bias, chunk_policy, c0,
                                   h0):
    """The chunk-indexed projection forward kernel: ``x`` [T, B * C, F]
    and ``keep`` [T, B * C] of B chunks of C rows, ``wi`` [P, F, 4H],
    ``wr`` [P, H, 4H] and ``bias`` [P, 4H] stacks, ``chunk_policy`` [B]
    int32, ``c0`` / ``h0`` [B * C, H] -> (ys, cs), each [T, B * C, H];
    chunk b runs with policy ``chunk_policy[b]``'s weights, and every row
    equals ``lstm_sequence_proj_fwd``'s row with them bitwise. A chunk
    whose policy lies outside [0, P) is skipped: its rows are NaN. Same
    path rule as ``lstm_sequence_proj_fwd``."""
    steps, n, f_in, hidden, B, C, P = _check_proj_chunked(
        "lstm_sequence_proj_fwd_chunked", x, keep, wi, wr, bias,
        chunk_policy, c0, h0)
    tensor_core = uses_tensor_cores(x.dtype, hidden)
    if tensor_core:
        # x and h0 arrive by 16-byte copies, the weights by TMA.
        x, h0, wi, wr = map(on_16_bytes, (x, h0, wi, wr))
    ys = torch.empty((steps, n, hidden), dtype=x.dtype, device=x.device)
    cs = torch.empty_like(ys)
    err = library().mlt_lstm_proj_fwd_chunked(
        int(tensor_core), _DTYPE_CODES[x.dtype], hidden, f_in, x.data_ptr(),
        keep.data_ptr(), wi.data_ptr(), wr.data_ptr(), bias.data_ptr(),
        chunk_policy.data_ptr(), c0.data_ptr(), h0.data_ptr(), ys.data_ptr(),
        cs.data_ptr(), steps, B, C, P,
        torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "lstm_sequence_proj_fwd_chunked")
    LSTM_PROJ_FWD_CHUNKED.launches += 1
    LSTM_PROJ_FWD_CHUNKED.tc_launches += int(tensor_core)
    return ys, cs


def lstm_sequence_proj_bwd_chunked(x, keep, wi, wr, bias, chunk_policy, c0,
                                   h0, ys, cs, dys):
    """The chunk-indexed projection backward kernel, given
    ``lstm_sequence_proj_fwd_chunked``'s ys / cs: (dx [T, B * C, F], dwi
    [P, F, 4H], dwr [P, H, 4H], db [P, 4H], dc0, dh0 [B * C, H]). Chunk b
    runs with policy ``chunk_policy[b]``'s weights: every row's dx / dh0 /
    dc0 equal ``lstm_sequence_proj_bwd``'s on that chunk's rows bitwise,
    and ``dwi[p]`` / ``dwr[p]`` / ``db[p]`` sum over the rows of policy
    p's chunks in f32, rounded once; zeros for a policy without a chunk (a
    chunk whose policy lies outside [0, P) gets NaN rows and adds to no
    policy). The weight gradients split each chunk's rows by the
    single-policy rule applied to the chunk alone. On tensor cores dwi and
    dwr are views of one [P, F + H, 4H] result. Same path rule as
    ``lstm_sequence_proj_bwd``."""
    what = "lstm_sequence_proj_bwd_chunked"
    steps, n, f_in, hidden, B, C, P = _check_proj_chunked(
        what, x, keep, wi, wr, bias, chunk_policy, c0, h0)
    dtype, device = x.dtype, x.device
    _check("ys", ys, dtype, (steps, n, hidden))
    _check("cs", cs, dtype, (steps, n, hidden))
    _check("dys", dys, dtype, (steps, n, hidden))
    tensor_core = uses_tensor_cores(dtype, hidden)
    num_sms = torch.cuda.get_device_properties(device).multi_processor_count
    g4 = 4 * hidden

    def empty(*shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device=device)

    # Wi^T and Wr^T of every policy, [P, 4H, F] / [P, 4H, H]: one copy each
    # a call, on a 16-byte boundary as new storage.
    wi_t = wi.transpose(1, 2).contiguous()
    wr_t = wr.transpose(1, 2).contiguous()
    if tensor_core:
        x, keep, wi, wr, bias, c0, h0, ys, cs, dys = map(
            on_16_bytes, (x, keep, wi, wr, bias, c0, h0, ys, cs, dys))
        splits = _num_splits_tc(steps * C, f_in + hidden, hidden, num_sms)
        hin = empty(steps, n, hidden)
        part_wi = None
        part_w = empty(B * splits, f_in + hidden, g4, dt=torch.float32)
        part_b = empty(B * -(-C // tc_rows(True, hidden)), g4,
                       dt=torch.float32)
        dw = empty(P, f_in + hidden, g4)
        dwi, dwr = dw[:, :f_in], dw[:, f_in:]
    else:
        splits = _num_splits(steps, C, hidden, num_sms)
        hin = None
        part_wi = empty(B * splits, f_in, g4, dt=torch.float32)
        part_w = empty(B * splits, hidden, g4, dt=torch.float32)
        part_b = empty(B * splits, g4, dt=torch.float32)
        dw, dwi, dwr = None, empty(P, f_in, g4), empty(P, hidden, g4)
    dx, dg = empty(steps, n, f_in), empty(steps, n, g4)
    dh0, dc0, db = empty(n, hidden), empty(n, hidden), empty(P, g4)
    ptr = lambda t: 0 if t is None else t.data_ptr()
    err = library().mlt_lstm_proj_bwd_chunked(
        int(tensor_core), _DTYPE_CODES[dtype], hidden, f_in, x.data_ptr(),
        keep.data_ptr(), wi.data_ptr(), wi_t.data_ptr(), wr.data_ptr(),
        wr_t.data_ptr(), bias.data_ptr(), chunk_policy.data_ptr(),
        c0.data_ptr(), h0.data_ptr(), ys.data_ptr(), cs.data_ptr(),
        dys.data_ptr(), dx.data_ptr(), dg.data_ptr(), ptr(hin),
        dh0.data_ptr(), dc0.data_ptr(), ptr(part_wi), part_w.data_ptr(),
        part_b.data_ptr(), 0 if tensor_core else dwi.data_ptr(),
        (dw if tensor_core else dwr).data_ptr(), db.data_ptr(), steps, B, C,
        P, splits, torch.cuda.current_stream(device).cuda_stream)
    check(err, what)
    LSTM_PROJ_BWD_CHUNKED.launches += 1
    LSTM_PROJ_BWD_CHUNKED.tc_launches += int(tensor_core)
    return dx, dwi, dwr, db, dc0, dh0


class _LSTMSequenceProjChunked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, keep, wi, wr, bias, chunk_policy, c0, h0):
        ys, cs = lstm_sequence_proj_fwd_chunked(x, keep, wi, wr, bias,
                                                chunk_policy, c0, h0)
        ctx.save_for_backward(x, keep, wi, wr, bias, chunk_policy, c0, h0,
                              ys, cs)
        return ys

    @staticmethod
    def backward(ctx, dys):
        x, keep, wi, wr, bias, chunk_policy, c0, h0, ys, cs = \
            ctx.saved_tensors
        dx, dwi, dwr, db, dc0, dh0 = lstm_sequence_proj_bwd_chunked(
            x, keep, wi, wr, bias, chunk_policy, c0, h0, ys, cs,
            dys.to(x.dtype).contiguous())
        return dx, None, dwi, dwr, db, None, dc0, dh0


def lstm_sequence_proj_chunked(x, keep, wi, wr, bias, chunk_policy, c0, h0):
    """ys [T, B * C, H]: ``lstm_sequence_chunked(round(x . Wi), ...)`` with
    the projection inside the kernel, differentiable, chunk b with policy
    ``chunk_policy[b]``'s weights of the [P, F, 4H] / [P, H, 4H] / [P, 4H]
    stacks (the contract of ``lstm_sequence_proj_fwd_chunked`` and
    ``lstm_sequence_proj_bwd_chunked``). CPU tensors take the plain
    twin."""
    if x.device.type == "cpu":
        return lstm_sequence_proj_chunked_reference(x, keep, wi, wr, bias,
                                                    chunk_policy, c0, h0)
    return _LSTMSequenceProjChunked.apply(x, keep, wi, wr, bias,
                                          chunk_policy, c0, h0)
