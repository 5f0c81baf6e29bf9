"""gru_sequence_fwd / gru_sequence_bwd: the fused GRU sequence pass as CUDA
kernels, with a plain twin.

Replaces ``madrona_learn_tpu/ops/pallas/gru.py:gru_sequence`` (forward
``_fwd_kernel``, backward ``_bwd_kernel`` with its fused dWh/dbh
epilogue). ``csrc/gru.cu`` explains the Hopper design, which is the LSTM
kernels': a block owns a tile of batch rows and loops over time, Wh is read
from L2 every step (384 KiB in bf16 at H = 256, more than a block's shared
memory), and dWh/dbh are per-split f32 partials summed in a fixed order
instead of one accumulator shared by the whole grid.

The kernels are built at H = 128, 256, 384 and 512 in float32, bfloat16
and float16: :func:`gru_supported` is true exactly there, which for
float32 and bfloat16 is JAX's gate (``H % 128 == 0``,
``ops/pallas/gru.py:47``) over H from 32 to 512; float16 is the port's
choice (JAX sends it to its jnp twin). The modules route a layer by
JAX's gate (:func:`gru_kernel_route`): a width that is no multiple of 128
to the plain twins, on the card too, as JAX routes it to its jnp twin; the
wrappers raise on operands no kernel takes (a multiple of 128 past 512
among them).

Two paths for each kernel, picked from the dtype and H alone by one
rule, :func:`bwd_uses_tensor_cores` (``fwd_uses_tensor_cores`` is the
same function): the forward, the backward, their chunk-indexed instances
and the rollout steps that run them; no fallback: the kernel a call is
routed to runs or raises:

- bfloat16 and float16, at every width: the recurrences on Hopper's
  warpgroup tensor cores (``wgmma``, bf16 or f16 operands, f32
  accumulators). The forward reads Wh as it stands through a TMA ring,
  :data:`FWD_TC_ROWS` batch rows a block; the backward streams Wh^T and
  Wh the same way, :func:`tc_rows` rows a block, then takes dWh as a
  split-K ``wgmma`` product over the T * N rows
  (``csrc/weight_grad_tc.cuh``). At H = 384 and 512 both split the units
  over a cluster of two blocks, as the LSTM's do. Both are bound by
  streaming Wh from L2. An operand off a 16-byte boundary is copied onto
  one first. Float16 is the port's own route (JAX sends it to its jnp
  twin): f16 operands, ys, dxp, dhp, dh0, dWh and dbh rounded once to
  float16, as the CUDA-core kernels and the plain twin round them. The
  forward and the backward's recompute share one product in one slice
  order at every width, so the backward differentiates the forward that
  ran and the rollout step is the update pass's step bitwise;
- float32, whose products tensor cores would round: the CUDA-core kernels
  (the backward with the split-M pass of ``csrc/weight_grad.cuh``), bound
  by f32 FMA issue.

Contract (all operands in the storage dtype, float32, bfloat16 or
float16):

- ``x_proj`` [T, N, 3H] pre-projected inputs including the input bias,
  gates packed ``[r | z | n]``;
- ``keep`` [T, N]: 0 clears the carry after step t (step-then-reset);
- ``wh`` [H, 3H]; ``bias_h`` [H], the candidate gate's recurrent bias,
  already rounded to the storage dtype; ``h0`` [N, H];
- linear-before-reset gate math in f32 (``n = tanh(x_n + r * (h . W_hn +
  b_hn))``), ``h . Wh`` accumulated in f32, ``ys`` rounded to the storage
  dtype; the backward rounds ``dxp`` and ``dhp`` to the storage dtype and
  returns ``dwh`` / ``dbh`` in it.

``gru_sequence_fwd_chunked`` and ``gru_sequence_bwd_chunked`` are the
chunk-indexed instances of the two kernels (both paths), the policy-batched
passes of a population: JAX ``vmap``s a model's apply over policy chunks in
collect (``madrona_learn_tpu/rollouts.py:580``) and ``algo.update`` over
the train policies in learn (``madrona_learn_tpu/train.py:315``), and with
them the ``pallas_call``s. ``x_proj`` holds B chunks of C rows, ``wh`` /
``bias_h`` are ``[P, H, 3H]`` / ``[P, H]`` stacks, and chunk b runs with
policy ``chunk_policy[b]``'s weights, each row bitwise the single-policy
kernel's with them (a chunk whose policy lies outside [0, P) is skipped,
its rows NaN); ``dwh[p]`` / ``dbh[p]`` sum over the rows of policy p's
chunks in f32 and are rounded once (zeros for a policy without a chunk),
split by the single-policy rule over each chunk's rows alone.
``gru_step_chunked`` is the rollout step (the forward at T = 1) and
``gru_sequence_chunked`` the differentiable pair, whose plain twin
``gru_sequence_chunked_reference`` runs ``gru_sequence_reference``'s
arithmetic chunk by chunk (its autograd defines the backward). Float32,
bfloat16 and float16 (on the routes of one policy); the wrappers raise on
a hidden size no kernel takes.

CPU tensors take the plain version; CUDA tensors launch the kernels or
raise.
"""

from __future__ import annotations

import functools

import torch

from .build import Kernel, check, check_operand, library
from .lstm import _chunked, _num_splits, _num_splits_tc, on_16_bytes

GRU_FWD = Kernel(
    name="gru_sequence_fwd",
    source="madrona_learn_tpu_torch/csrc/gru.cu",
    replaces="madrona_learn_tpu/ops/pallas/gru.py:192",
)
GRU_BWD = Kernel(
    name="gru_sequence_bwd",
    source="madrona_learn_tpu_torch/csrc/gru.cu",
    replaces="madrona_learn_tpu/ops/pallas/gru.py:211",
)
# The chunk-indexed instance of the forward: the policy-batched rollout
# step (T = 1) and the batched learn's forward (T = 16) of a GRU population.
GRU_FWD_CHUNKED = Kernel(
    name="gru_sequence_fwd_chunked",
    source="madrona_learn_tpu_torch/csrc/gru.cu",
    replaces="madrona_learn_tpu/ops/pallas/gru.py:192",
)
# The chunk-indexed instance of the backward: the population's learn step
# over every train policy, one chunk a policy (ppo._ppo_population).
GRU_BWD_CHUNKED = Kernel(
    name="gru_sequence_bwd_chunked",
    source="madrona_learn_tpu_torch/csrc/gru.cu",
    replaces="madrona_learn_tpu/ops/pallas/gru.py:211",
)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# The widths the kernels are built for, in every dtype.
_HIDDEN_SIZES = (128, 256, 384, 512)
_check = functools.partial(check_operand, "gru kernel")

# Batch rows a row tile of the tensor-core backward owns at each width
# (kGruTcRows<H> in csrc/gru.cu), which sets the count of its dbh partials.
_TC_ROWS = {128: 32, 256: 32, 384: 32, 512: 16}
# Batch rows a block of the tensor-core forward owns (kGruFwdRows in
# csrc/gru.cu).
FWD_TC_ROWS = 32


def gru_supported(hidden, dtype):
    """Whether the kernels serve this layer shape: true exactly for the
    (H, dtype) pairs with a kernel instance. In float32 and bfloat16 that
    is JAX's gate (``ops/pallas/gru.py:47``, ``H % 128 == 0``) for H up to
    512; float16 too, where JAX takes its jnp twin (on tensor cores at
    every width)."""
    return hidden in _HIDDEN_SIZES and dtype in _DTYPE_CODES


def gru_kernel_route(hidden, dtype):
    """The modules' route for a layer of this shape: the kernels (True) or
    their plain twins (False), by JAX's choice between its Pallas kernel
    and its jnp twin (``H % 128 == 0``, ``ops/pallas/gru.py:47``), float16
    going to the kernels as float32 does. True wherever
    :func:`gru_supported` is, and also at a multiple of 128 past 512,
    where no instance is built: such a layer raises on the card (the
    wrappers' operand check) instead of leaving the route JAX takes."""
    return hidden % 128 == 0 and dtype in _DTYPE_CODES


def tc_rows(hidden):
    """Batch rows a row tile of the tensor-core backward owns at width
    ``hidden`` (a block's, or at H = 384 and 512 a cluster's)."""
    return _TC_ROWS[hidden]


def bwd_uses_tensor_cores(dtype, hidden):
    """The path rule of the GRU kernels, one for the backward and the
    forward (``fwd_uses_tensor_cores`` is this function), their
    chunk-indexed instances and so ``gru_step`` / ``gru_step_chunked``, so
    that the backward recomputes the forward that ran and the rollout step
    is the update pass's step: bfloat16 and float16 at every width the
    kernels take the tensor-core kernels (bf16 or f16 ``wgmma``; a cluster
    of two blocks at H = 384 and 512); float32, whose products tensor
    cores would round, the CUDA-core ones."""
    return (dtype in (torch.bfloat16, torch.float16)
            and hidden in _HIDDEN_SIZES)


fwd_uses_tensor_cores = bwd_uses_tensor_cores


def _cell(x_proj_t, wh32, bh32, h):
    """One step of the GRU cell (``_gates_fp32``): f32 math, storage-dtype
    result."""
    f32 = torch.float32
    H = h.shape[-1]
    h32 = h.to(f32)
    hp = h32 @ wh32
    xp = x_proj_t.to(f32)
    hn_lin = hp[..., 2 * H:] + bh32
    r = torch.sigmoid(xp[..., :H] + hp[..., :H])
    z = torch.sigmoid(xp[..., H:2 * H] + hp[..., H:2 * H])
    n = torch.tanh(xp[..., 2 * H:] + r * hn_lin)
    return ((1.0 - z) * n + z * h32).to(x_proj_t.dtype)


def gru_sequence_reference(x_proj, keep, wh, bias_h, h0):
    """Plain twin of ``gru_sequence_reference`` (ops/pallas/gru.py:272).

    Differentiable by autograd; its gradients are the plain version of
    ``gru_sequence_bwd``. Over chunks (x_proj [T, B, C, 3H], keep
    [T, B, C], wh [B, H, 3H], bias_h [B, 1, H], h0 [B, C, H]) each chunk
    runs with its own weights.
    """
    wh32, bh32 = wh.float(), bias_h.float()
    h = h0
    ys = []
    for t in range(x_proj.shape[0]):
        new_h = _cell(x_proj[t], wh32, bh32, h)
        mask = keep[t][..., None] > 0.5
        h = torch.where(mask, new_h, torch.zeros((), dtype=new_h.dtype,
                                                 device=new_h.device))
        ys.append(new_h)
    return torch.stack(ys)


def _sequence(*args):
    """``gru_sequence_reference`` as a 1-tuple, for ``lstm._chunked``."""
    return (gru_sequence_reference(*args),)


def gru_sequence_chunked_reference(x_proj, keep, wh, bias_h, chunk_policy,
                                   h0):
    """Plain twin of ``gru_sequence_chunked``: ys [T, B * C, H], each chunk
    through ``gru_sequence_reference`` with its policy's weights of the
    [P, H, 3H] / [P, H] stacks (NaN rows for a chunk of no policy): a loop
    over the chunks on the CPU, one gathered batched product a step on the
    card (``lstm._chunked``). Differentiable by autograd, whose gradients
    are the plain version of ``gru_sequence_bwd_chunked``: a policy's
    ``wh`` / ``bias_h`` gradients sum over its chunks' rows, and a policy
    without a chunk gets zeros."""
    return _chunked(_sequence, x_proj, keep, (wh, bias_h), chunk_policy,
                    (h0,))[0]


def gru_step_reference(x_proj, wh, bias_h, h):
    """Plain twin of ``gru_step``: one step of the GRU cell, new h,
    differentiable."""
    return _cell(x_proj, wh.float(), bias_h.float(), h)


def gru_step_chunked_reference(x_proj, wh, bias_h, chunk_policy, h):
    """Plain twin of ``gru_step_chunked``: ``gru_sequence_fwd_chunked``'s
    twin at T = 1, new h [B * C, H]."""
    keep = torch.ones((1, x_proj.shape[0]), dtype=x_proj.dtype,
                      device=x_proj.device)
    return gru_sequence_fwd_chunked_reference(
        x_proj.unsqueeze(0), keep, wh, bias_h, chunk_policy, h)[0]


def gru_sequence_fwd_chunked_reference(x_proj, keep, wh, bias_h,
                                       chunk_policy, h0):
    """Plain twin of ``gru_sequence_fwd_chunked``: the arithmetic of
    ``gru_sequence_chunked_reference``, without autograd; ys [T, B * C,
    H]."""
    with torch.no_grad():
        return gru_sequence_chunked_reference(x_proj, keep, wh, bias_h,
                                              chunk_policy, h0)


def _check_inputs(x_proj, keep, wh, bias_h, h0):
    if x_proj.dim() != 3 or x_proj.shape[-1] % 3:
        raise ValueError(f"gru kernel: x_proj must be [T, N, 3H], got "
                         f"{tuple(x_proj.shape)}")
    steps, n, g3 = x_proj.shape
    hidden = g3 // 3
    dtype = x_proj.dtype
    if not gru_supported(hidden, dtype):
        raise ValueError(
            f"gru kernel: supports float32/bfloat16/float16 with H in "
            f"{_HIDDEN_SIZES}, got {dtype} H={hidden}")
    if steps == 0 or n == 0:
        raise ValueError(f"gru kernel: empty input {tuple(x_proj.shape)}")
    _check("x_proj", x_proj, dtype, (steps, n, g3))
    _check("keep", keep, dtype, (steps, n))
    _check("wh", wh, dtype, (hidden, g3))
    _check("bias_h", bias_h, dtype, (hidden,))
    _check("h0", h0, dtype, (n, hidden))
    return steps, n, hidden


def _fwd_tc(x_proj, keep, wh, bias_h, h0, out=None, hp=None):
    """The tensor-core forward (bfloat16 or float16): ys [T, N, H], into
    ``out`` where given; each step's h . Wh into ``hp`` (f32 [T, N, 3H])
    where given."""
    steps, n, g3 = x_proj.shape
    hidden = g3 // 3
    # x_proj and h0 arrive by 16-byte copies, Wh by TMA.
    x_proj, h0, wh = on_16_bytes(x_proj), on_16_bytes(h0), on_16_bytes(wh)
    ys = out if out is not None else torch.empty(
        (steps, n, hidden), dtype=x_proj.dtype, device=x_proj.device)
    err = library().mlt_gru_fwd_tc(
        _DTYPE_CODES[x_proj.dtype], hidden, x_proj.data_ptr(),
        keep.data_ptr(),
        wh.data_ptr(), bias_h.data_ptr(), h0.data_ptr(), ys.data_ptr(),
        steps, n, None if hp is None else hp.data_ptr(),
        torch.cuda.current_stream(x_proj.device).cuda_stream)
    check(err, "gru_sequence_fwd")
    return ys


def gru_sequence_fwd(x_proj, keep, wh, bias_h, h0):
    """The forward kernel: ys [T, N, H] in the storage dtype."""
    steps, n, hidden = _check_inputs(x_proj, keep, wh, bias_h, h0)
    if fwd_uses_tensor_cores(x_proj.dtype, hidden):
        ys = _fwd_tc(x_proj, keep, wh, bias_h, h0)
        GRU_FWD.launches += 1
        GRU_FWD.tc_launches += 1
        return ys
    ys = torch.empty((steps, n, hidden), dtype=x_proj.dtype,
                     device=x_proj.device)
    err = library().mlt_gru_fwd(
        _DTYPE_CODES[x_proj.dtype], hidden, x_proj.data_ptr(),
        keep.data_ptr(), wh.data_ptr(), bias_h.data_ptr(), h0.data_ptr(),
        ys.data_ptr(), steps, n,
        torch.cuda.current_stream(x_proj.device).cuda_stream)
    check(err, "gru_sequence_fwd")
    GRU_FWD.launches += 1
    return ys


def _bwd_tc_buffers(x_proj):
    """Outputs and scratch of :func:`_bwd_tc` for these operands."""
    steps, n, g3 = x_proj.shape
    hidden = g3 // 3
    dtype, device = x_proj.dtype, x_proj.device
    splits = _num_splits_tc(
        steps * n, hidden, hidden,
        torch.cuda.get_device_properties(device).multi_processor_count,
        gates=3)

    def empty(*shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device=device)

    return dict(
        splits=splits, dxp=empty(steps, n, g3),
        dhp=empty(steps, n, g3), hin=empty(steps, n, hidden),
        dh0=empty(n, hidden),
        part_w=empty(splits, hidden, g3, dt=torch.float32),
        part_b=empty(-(-n // tc_rows(hidden)), hidden, dt=torch.float32),
        dw=empty(hidden, g3), db=empty(hidden))


def _bwd_tc(x_proj, keep, wh, bias_h, h0, ys, dys, *, phases=3,
            buffers=None, hp=None):
    """The tensor-core backward (bfloat16 or float16) in its two passes,
    phases bit 0 the recurrence and bit 1 the weight gradients; the
    buffers of :func:`_bwd_tc_buffers`, filled. ``hp`` (f32 [T, N, 3H]),
    where given, receives the recurrence's recomputed h_in . Wh: bitwise
    what :func:`_fwd_tc` writes to its ``hp`` from the same carry."""
    steps, n, g3 = x_proj.shape
    x_proj, keep, bias_h, h0, ys, dys = map(
        on_16_bytes, (x_proj, keep, bias_h, h0, ys, dys))
    b = _bwd_tc_buffers(x_proj) if buffers is None else buffers
    # The transposed copy is new storage, on a 16-byte boundary.
    wh_t = wh.t().contiguous()
    wh = on_16_bytes(wh)
    err = library().mlt_gru_bwd_tc(
        _DTYPE_CODES[x_proj.dtype], g3 // 3, phases, x_proj.data_ptr(),
        keep.data_ptr(), wh.data_ptr(), wh_t.data_ptr(), bias_h.data_ptr(),
        h0.data_ptr(), ys.data_ptr(), dys.data_ptr(), b["dxp"].data_ptr(),
        b["dhp"].data_ptr(), b["hin"].data_ptr(), b["dh0"].data_ptr(),
        b["part_w"].data_ptr(), b["part_b"].data_ptr(), b["dw"].data_ptr(),
        b["db"].data_ptr(), steps, n, b["splits"],
        None if hp is None else hp.data_ptr(),
        torch.cuda.current_stream(x_proj.device).cuda_stream)
    check(err, "gru_sequence_bwd")
    return b


def gru_sequence_bwd(x_proj, keep, wh, bias_h, h0, ys, dys):
    """The backward kernel: (dxp, dwh, dbh, dh0) given the forward's ys.
    ``dhp`` [T, N, 3H] goes through a scratch to the weight-gradient
    pass."""
    steps, n, hidden = _check_inputs(x_proj, keep, wh, bias_h, h0)
    dtype, device = x_proj.dtype, x_proj.device
    _check("ys", ys, dtype, (steps, n, hidden))
    _check("dys", dys, dtype, (steps, n, hidden))
    if bwd_uses_tensor_cores(dtype, hidden):
        b = _bwd_tc(x_proj, keep, wh, bias_h, h0, ys, dys)
        GRU_BWD.launches += 1
        GRU_BWD.tc_launches += 1
        return b["dxp"], b["dw"], b["db"], b["dh0"]
    wh_t = wh.t().contiguous()
    splits = _num_splits(
        steps, n, hidden,
        torch.cuda.get_device_properties(device).multi_processor_count,
        gates=3)
    dxp = torch.empty_like(x_proj)
    dhp = torch.empty_like(x_proj)
    dh0 = torch.empty_like(h0)
    part_w = torch.empty((splits, hidden, 3 * hidden), dtype=torch.float32,
                         device=device)
    part_b = torch.empty((splits, 3 * hidden), dtype=torch.float32,
                         device=device)
    dwh = torch.empty_like(wh)
    db3 = torch.empty((3 * hidden,), dtype=dtype, device=device)
    err = library().mlt_gru_bwd(
        _DTYPE_CODES[dtype], hidden, x_proj.data_ptr(), keep.data_ptr(),
        wh.data_ptr(), wh_t.data_ptr(), bias_h.data_ptr(), h0.data_ptr(),
        ys.data_ptr(), dys.data_ptr(), dxp.data_ptr(), dhp.data_ptr(),
        dh0.data_ptr(), part_w.data_ptr(), part_b.data_ptr(),
        dwh.data_ptr(), db3.data_ptr(), steps, n, splits,
        torch.cuda.current_stream(device).cuda_stream)
    check(err, "gru_sequence_bwd")
    GRU_BWD.launches += 1
    # bias_h feeds only the candidate gate: its cotangent is dhp's n slice.
    return dxp, dwh, db3[2 * hidden:], dh0


class _GRUSequence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_proj, keep, wh, bias_h, h0):
        ys = gru_sequence_fwd(x_proj, keep, wh, bias_h, h0)
        ctx.save_for_backward(x_proj, keep, wh, bias_h, h0, ys)
        return ys

    @staticmethod
    def backward(ctx, dys):
        x_proj, keep, wh, bias_h, h0, ys = ctx.saved_tensors
        dxp, dwh, dbh, dh0 = gru_sequence_bwd(
            x_proj, keep, wh, bias_h, h0, ys,
            dys.to(x_proj.dtype).contiguous())
        # keep is a mask: its cotangent is zero, as in the JAX VJP.
        return dxp, None, dwh, dbh, dh0


def gru_sequence(x_proj, keep, wh, bias_h, h0):
    """ys [T, N, H]: the fused sequence pass, differentiable."""
    if x_proj.device.type == "cpu":
        return gru_sequence_reference(x_proj, keep, wh, bias_h, h0)
    return _GRUSequence.apply(x_proj, keep, wh, bias_h, h0)


def gru_step(x_proj, wh, bias_h, h):
    """One rollout step, new h [N, H], no clearing.

    On the card this is ``gru_sequence_fwd`` with T = 1, so the rollout
    forward and the update-pass sequence forward share gate math and
    rounding points and PPO's ratio can start at 1.
    """
    if x_proj.device.type == "cpu":
        return gru_step_reference(x_proj, wh, bias_h, h)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x_proj, wh, bias_h, h)):
        raise RuntimeError("gru_step has no backward on CUDA; run the "
                           "rollout step under torch.no_grad()")
    keep = torch.ones((1, x_proj.shape[0]), dtype=x_proj.dtype,
                      device=x_proj.device)
    return gru_sequence_fwd(x_proj.unsqueeze(0), keep, wh, bias_h, h)[0]


def _check_chunked(what, x_proj, keep, wh, bias_h, chunk_policy, h0):
    """The chunked instances' operand checks: (T, N, H, B, C, P)."""
    if wh.dim() != 3 or chunk_policy.dim() != 1 or x_proj.dim() != 3:
        raise ValueError(
            f"{what}: wh must be [P, H, 3H], chunk_policy [B] and x_proj "
            f"[T, B * C, 3H], got {tuple(wh.shape)}, "
            f"{tuple(chunk_policy.shape)}, {tuple(x_proj.shape)}")
    P, B = wh.shape[0], chunk_policy.shape[0]
    if x_proj.dtype not in _DTYPE_CODES or B == 0 or x_proj.shape[1] % B \
            or P == 0:
        raise ValueError(
            f"{what}: supports float32/bfloat16/float16 over whole chunks, "
            f"got {x_proj.dtype}, {tuple(x_proj.shape)} rows in {B} chunks "
            f"of {P} policies")
    steps, n, hidden = _check_inputs(x_proj, keep, wh[0], bias_h[0], h0)
    _check("wh", wh, x_proj.dtype, (P, hidden, 3 * hidden))
    _check("bias_h", bias_h, x_proj.dtype, (P, hidden))
    _check("chunk_policy", chunk_policy, torch.int32, (B,))
    return steps, n, hidden, B, n // B, P


def gru_sequence_fwd_chunked(x_proj, keep, wh, bias_h, chunk_policy, h0):
    """The chunk-indexed forward kernel: ``x_proj`` [T, B * C, 3H] and
    ``keep`` [T, B * C] of B chunks of C rows, ``wh`` [P, H, 3H] and
    ``bias_h`` [P, H] stacks, ``chunk_policy`` [B] int32, ``h0`` [B * C,
    H] -> ys [T, B * C, H]; chunk b runs with policy ``chunk_policy[b]``'s
    weights, and every row equals ``gru_sequence_fwd``'s row with those
    weights bitwise. A chunk whose policy lies outside [0, P) is skipped:
    its rows are NaN. Same path rule as ``gru_sequence_fwd``; float32,
    bfloat16 or float16."""
    steps, n, hidden, B, _, P = _check_chunked(
        "gru_sequence_fwd_chunked", x_proj, keep, wh, bias_h, chunk_policy,
        h0)
    tensor_core = fwd_uses_tensor_cores(x_proj.dtype, hidden)
    if tensor_core:
        # x_proj and h0 arrive by 16-byte copies, the weights by TMA.
        x_proj, h0, wh = map(on_16_bytes, (x_proj, h0, wh))
    ys = torch.empty((steps, n, hidden), dtype=x_proj.dtype,
                     device=x_proj.device)
    err = library().mlt_gru_fwd_chunked(
        int(tensor_core), _DTYPE_CODES[x_proj.dtype], hidden,
        x_proj.data_ptr(), keep.data_ptr(), wh.data_ptr(), bias_h.data_ptr(),
        chunk_policy.data_ptr(), h0.data_ptr(), ys.data_ptr(), steps, B,
        n // B, P, torch.cuda.current_stream(x_proj.device).cuda_stream)
    check(err, "gru_sequence_fwd_chunked")
    GRU_FWD_CHUNKED.launches += 1
    GRU_FWD_CHUNKED.tc_launches += int(tensor_core)
    return ys


def gru_step_chunked(x_proj, wh, bias_h, chunk_policy, h):
    """The policy-batched rollout step, new h [B * C, H], no clearing:
    ``gru_step`` for every chunk of B at once, chunk b with policy
    ``chunk_policy[b]``'s weights of the [P, H, 3H] / [P, H] stacks. On
    the card, ``gru_sequence_fwd_chunked`` with T = 1, whose rows equal
    ``gru_sequence_fwd``'s: the rollout step and the update pass share gate
    math and rounding points, as for one policy."""
    if x_proj.device.type == "cpu":
        return gru_step_chunked_reference(x_proj, wh, bias_h, chunk_policy,
                                          h)
    keep = torch.ones((1, x_proj.shape[0]), dtype=x_proj.dtype,
                      device=x_proj.device)
    return gru_sequence_fwd_chunked(x_proj.unsqueeze(0), keep, wh, bias_h,
                                    chunk_policy, h)[0]


def gru_sequence_bwd_chunked(x_proj, keep, wh, bias_h, chunk_policy, h0,
                             ys, dys):
    """The chunk-indexed backward kernel, given ``gru_sequence_fwd_chunked``'s
    ys: (dx_proj [T, B * C, 3H], dwh [P, H, 3H], dbh [P, H], dh0 [B * C,
    H]). Chunk b runs with policy ``chunk_policy[b]``'s weights: every
    row's dx_proj / dh0 equal ``gru_sequence_bwd``'s on that chunk's rows
    bitwise, and ``dwh[p]`` / ``dbh[p]`` sum over the rows of policy p's
    chunks in f32, rounded once; zeros for a policy without a chunk (a
    chunk whose policy lies outside [0, P) gets NaN rows and adds to no
    policy). The weight gradients split each chunk's rows by the
    single-policy rule applied to the chunk alone. Same path rule as
    ``gru_sequence_bwd``; float32, bfloat16 or float16."""
    what = "gru_sequence_bwd_chunked"
    steps, n, hidden, B, C, P = _check_chunked(what, x_proj, keep, wh,
                                               bias_h, chunk_policy, h0)
    dtype, device = x_proj.dtype, x_proj.device
    _check("ys", ys, dtype, (steps, n, hidden))
    _check("dys", dys, dtype, (steps, n, hidden))
    tensor_core = bwd_uses_tensor_cores(dtype, hidden)
    num_sms = torch.cuda.get_device_properties(device).multi_processor_count
    g3 = 3 * hidden

    def empty(*shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device=device)

    # Wh^T of every policy, [P, 3H, H]: one copy a call, on a 16-byte
    # boundary as new storage.
    wh_t = wh.transpose(1, 2).contiguous()
    if tensor_core:
        x_proj, keep, wh, bias_h, h0, ys, dys = map(
            on_16_bytes, (x_proj, keep, wh, bias_h, h0, ys, dys))
        splits = _num_splits_tc(steps * C, hidden, hidden, num_sms, gates=3)
        hin = empty(steps, n, hidden)
        part_b = empty(B * -(-C // tc_rows(hidden)), hidden,
                       dt=torch.float32)
        db = empty(P, hidden)
    else:
        splits = _num_splits(steps, C, hidden, num_sms, gates=3)
        hin = None
        part_b = empty(B * splits, g3, dt=torch.float32)
        db = empty(P, g3)
    part_w = empty(B * splits, hidden, g3, dt=torch.float32)
    dxp, dhp, dh0 = empty(steps, n, g3), empty(steps, n, g3), empty(n, hidden)
    dwh = empty(P, hidden, g3)
    err = library().mlt_gru_bwd_chunked(
        int(tensor_core), _DTYPE_CODES[dtype], hidden, x_proj.data_ptr(),
        keep.data_ptr(), wh.data_ptr(), wh_t.data_ptr(), bias_h.data_ptr(),
        chunk_policy.data_ptr(), h0.data_ptr(), ys.data_ptr(),
        dys.data_ptr(), dxp.data_ptr(), dhp.data_ptr(),
        0 if hin is None else hin.data_ptr(), dh0.data_ptr(),
        part_w.data_ptr(), part_b.data_ptr(), dwh.data_ptr(), db.data_ptr(),
        steps, B, C, P, splits, torch.cuda.current_stream(device).cuda_stream)
    check(err, what)
    GRU_BWD_CHUNKED.launches += 1
    GRU_BWD_CHUNKED.tc_launches += int(tensor_core)
    # bias_h feeds only the candidate gate: its cotangent is dhp's n slice
    # (the CUDA-core pass sums all 3H columns).
    dbh = db if tensor_core else db[:, 2 * hidden:].contiguous()
    return dxp, dwh, dbh, dh0


class _GRUSequenceChunked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_proj, keep, wh, bias_h, chunk_policy, h0):
        ys = gru_sequence_fwd_chunked(x_proj, keep, wh, bias_h, chunk_policy,
                                      h0)
        ctx.save_for_backward(x_proj, keep, wh, bias_h, chunk_policy, h0, ys)
        return ys

    @staticmethod
    def backward(ctx, dys):
        x_proj, keep, wh, bias_h, chunk_policy, h0, ys = ctx.saved_tensors
        dxp, dwh, dbh, dh0 = gru_sequence_bwd_chunked(
            x_proj, keep, wh, bias_h, chunk_policy, h0, ys,
            dys.to(x_proj.dtype).contiguous())
        return dxp, None, dwh, dbh, None, dh0


def gru_sequence_chunked(x_proj, keep, wh, bias_h, chunk_policy, h0):
    """ys [T, B * C, H]: the chunk-indexed sequence pass, differentiable,
    chunk b with policy ``chunk_policy[b]``'s weights of the [P, H, 3H] /
    [P, H] stacks (the contract of ``gru_sequence_fwd_chunked`` and
    ``gru_sequence_bwd_chunked``). CPU tensors take the plain twin."""
    if x_proj.device.type == "cpu":
        return gru_sequence_chunked_reference(x_proj, keep, wh, bias_h,
                                              chunk_policy, h0)
    return _GRUSequenceChunked.apply(x_proj, keep, wh, bias_h, chunk_policy,
                                     h0)
