"""fused_policy_step: one rollout step of the MLP + LSTM trunk as one CUDA
kernel, with its plain twin.

Replaces ``madrona_learn_tpu/ops/pallas/policy_step.py:fused_policy_step``.
``csrc/policy_step.cu`` explains the Hopper design: a block keeps a tile of
rows' activations in shared memory from the input through every layer to
the LSTM cell, and streams the weights from L2.

Two paths, picked by :func:`uses_tensor_cores` from the dtype, H and F
alone (no fallback: the kernel a call is routed to runs or raises):

- bfloat16 at H = 128, 256, 384 or 512 (F <= 128): every product on
  Hopper's warpgroup tensor cores (``wgmma``, bf16 operands, f32
  accumulators), the weights streaming through a TMA ring, 32 batch rows
  a block (a cluster of two blocks at H = 384 and 512, each with half the
  units). TMA and the kernel's 16-byte copies read every operand but x on
  a 16-byte boundary: one that is not is copied onto one first;
- float32, whose products tensor cores would round: the CUDA-core kernel,
  bound by f32 FMA issue.

Contract (one storage dtype ``dt``, float32 or bfloat16, for every tensor
but the LayerNorm parameters):

- ``x`` [N, F] with F <= 128;
- ``mlp_params``: 1 to 4 layers ``(W [F_in, H], ln_scale [H] f32,
  ln_bias [H] f32)``;
- ``wi`` / ``wr`` [H, 4H] (gates i, f, g, o), ``bias`` [4H], ``c`` / ``h``
  [N, H];
- returns ``(feats, (c', h'))``, each [N, H] in ``dt`` (feats equal h').

The math is the JAX twin's (``fused_policy_step_reference`` there), not the
port's ``LayerNorm`` module: LayerNorm's mean and variance, scale and bias
are rounded to ``dt`` before the f32 normalize, and the input projection is
rounded to ``dt`` before the f32 gate math. The affine multiplies by
``rsqrt(var + eps) * scale`` as flax does, where the JAX twin multiplies
left to right (an f32-rounding difference). Inference only: there is no
backward.

``fused_policy_step_chunked`` is the chunk-indexed instance of the kernel
(both paths), the policy-batched rollout step of a population: JAX
``vmap``s the fused step, and with it its ``pallas_call``, over policy
chunks (``madrona_learn_tpu/rollouts.py:580``). ``x`` holds B chunks of C
rows, every weight is a ``[P, ...]`` stack (the LayerNorm affines f32
``[P, H]``, rounded to ``dt`` in the kernel as for one policy), and chunk
b runs with policy ``chunk_policy[b]``'s weights, each row bitwise
``fused_policy_step``'s with them (a chunk whose policy lies outside
[0, P) is skipped, its rows NaN). Its plain twin
``fused_policy_step_chunked_reference`` runs
``fused_policy_step_reference`` chunk by chunk.

CPU tensors take the plain version; CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import functools

import torch

from .build import Kernel, check, check_operand, library
from .lstm import on_16_bytes

POLICY_STEP = Kernel(
    name="fused_policy_step",
    source="madrona_learn_tpu_torch/csrc/policy_step.cu",
    replaces="madrona_learn_tpu/ops/pallas/policy_step.py:119",
)
# The chunk-indexed instance: the policy-batched rollout step of a
# fused-trunk population (rollouts.chunked_rollout_loop), JAX's vmap of the
# pallas_call over policy chunks.
POLICY_STEP_CHUNKED = Kernel(
    name="fused_policy_step_chunked",
    source="madrona_learn_tpu_torch/csrc/policy_step.cu",
    replaces="madrona_learn_tpu/ops/pallas/policy_step.py:168",
)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HIDDEN_SIZES = (128, 256, 384, 512)
_MAX_LAYERS = 4
_LN_EPS = 1e-6  # flax.linen.LayerNorm's default


def policy_step_supported(hidden, feat_in, dtype):
    """Whether the fused step can serve this tower shape: JAX's gate
    (``ops/pallas/policy_step.py:62``: H % 128 == 0, F <= 128, float32 or
    bfloat16) at the widths the kernel is built for, H = 128, 256, 384 and
    512. Past 512 the port runs the tower unfused."""
    return (hidden in _HIDDEN_SIZES and feat_in <= 128
            and dtype in (torch.float32, torch.bfloat16))


def uses_tensor_cores(dtype, hidden, feat_in):
    """The path rule: bfloat16 with H in (128, 256, 384, 512) and F <= 128
    takes the tensor-core kernel (``wgmma``); float32, whose products
    tensor cores would round, the CUDA-core one."""
    return (dtype == torch.bfloat16 and hidden in _HIDDEN_SIZES
            and 1 <= feat_in <= 128)


def _round(x, dt):
    """x rounded to dt, as float32."""
    return x.to(dt).float()


def fused_policy_step_reference(x, mlp_params, wi, wr, bias, c, h):
    """Plain twin (JAX: ``ops/pallas/policy_step.py:187``): the kernel's
    math and rounding points, unfused."""
    dt = h.dtype
    a = x.to(dt)
    for w, s, lb in mlp_params:
        af = _round(a.float() @ w.to(dt).float(), dt)
        mean = af.mean(dim=-1, keepdim=True)
        var = (af * af).mean(dim=-1, keepdim=True) - mean * mean
        mul = torch.rsqrt(_round(var, dt) + _LN_EPS) * _round(s, dt)
        y = (af - _round(mean, dt)) * mul + _round(lb, dt)
        a = torch.relu(y.to(dt))

    x_proj = _round(a.float() @ wi.to(dt).float(), dt)
    gates = x_proj + h.to(dt).float() @ wr.to(dt).float() + _round(bias, dt)
    gi, gf, gg, go = gates.chunk(4, dim=-1)
    new_c = torch.sigmoid(gf) * c.float() + torch.sigmoid(gi) * torch.tanh(gg)
    new_h = torch.sigmoid(go) * torch.tanh(new_c)
    return new_h.to(dt), (new_c.to(c.dtype), new_h.to(dt))


def fused_policy_step_chunked_reference(x, mlp_stacks, wi, wr, bias,
                                        chunk_policy, c, h):
    """Plain twin of ``fused_policy_step_chunked``: each chunk's rows
    through ``fused_policy_step_reference`` with that chunk's policy's
    weights, gathered; (feats, (c', h')), each [B * C, H]. A chunk whose
    policy lies outside [0, P) gets NaN rows."""
    B, P = chunk_policy.shape[0], wi.shape[0]
    C = x.shape[0] // B
    feats = torch.full(h.shape, float("nan"), dtype=h.dtype, device=h.device)
    c_out = torch.full(c.shape, float("nan"), dtype=c.dtype, device=c.device)
    h_out = feats.clone()
    for b, p in enumerate(chunk_policy.tolist()):
        if 0 <= p < P:
            rows = slice(b * C, (b + 1) * C)
            feats[rows], (c_out[rows], h_out[rows]) = \
                fused_policy_step_reference(
                    x[rows], [tuple(t[p] for t in layer)
                              for layer in mlp_stacks],
                    wi[p], wr[p], bias[p], c[rows], h[rows])
    return feats, (c_out, h_out)


_check = functools.partial(check_operand, "fused_policy_step")


def _no_grad(what, operands):
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        raise RuntimeError(f"{what} has no backward; run the rollout step "
                           f"under torch.no_grad()")


def _check_step(what, x, mlp_params, wi, wr, bias, c, h, stack=()):
    """The step's operand checks, every weight with the leading dims
    ``stack`` (``(P,)`` for the chunk-indexed instance): (N, F, H)."""
    dt = h.dtype
    n, hidden = h.shape
    f_in = x.shape[-1] if x.dim() == 2 else -1
    layers = len(mlp_params)
    if (dt not in _DTYPE_CODES or hidden not in _HIDDEN_SIZES
            or not 1 <= f_in <= 128 or not 1 <= layers <= _MAX_LAYERS):
        raise ValueError(
            f"{what}: supports float32/bfloat16, H in "
            f"{_HIDDEN_SIZES}, x [N, F <= 128] and 1 to {_MAX_LAYERS} MLP "
            f"layers; got {dt}, H={hidden}, x {tuple(x.shape)}, "
            f"{layers} layers")
    if n == 0:
        raise ValueError(f"{what}: empty batch")
    _check("x", x, dt, (n, f_in))
    fin = f_in
    for i, (w, s, lb) in enumerate(mlp_params):
        _check(f"W_{i}", w, dt, (*stack, fin, hidden))
        _check(f"ln_scale_{i}", s, torch.float32, (*stack, hidden))
        _check(f"ln_bias_{i}", lb, torch.float32, (*stack, hidden))
        fin = hidden
    _check("wi", wi, dt, (*stack, hidden, 4 * hidden))
    _check("wr", wr, dt, (*stack, hidden, 4 * hidden))
    _check("bias", bias, dt, (*stack, 4 * hidden))
    _check("c", c, dt, (n, hidden))
    _check("h", h, dt, (n, hidden))
    return n, f_in, hidden


def _aligned(tensor_core, mlp_params, wi, wr, bias, c, h):
    """The operands the kernel reads by TMA or 16-byte copies on a 16-byte
    boundary (the tensor-core route; x is read as it lies)."""
    if tensor_core:
        mlp_params = [tuple(map(on_16_bytes, layer)) for layer in mlp_params]
        wi, wr, bias, c, h = map(on_16_bytes, (wi, wr, bias, c, h))
    return mlp_params, wi, wr, bias, c, h


def fused_policy_step(x, mlp_params, wi, wr, bias, c, h):
    """One trunk step: (feats [N, H], (c' [N, H], h' [N, H]))."""
    if x.device.type == "cpu":
        return fused_policy_step_reference(x, mlp_params, wi, wr, bias, c, h)
    _no_grad("fused_policy_step", [x, wi, wr, bias, c, h] + [
        p for layer in mlp_params for p in layer])
    n, f_in, hidden = _check_step("fused_policy_step", x, mlp_params, wi, wr,
                                  bias, c, h)
    dt = h.dtype
    tensor_core = uses_tensor_cores(dt, hidden, f_in)
    mlp_params, wi, wr, bias, c, h = _aligned(tensor_core, mlp_params, wi,
                                              wr, bias, c, h)
    head = (hidden, len(mlp_params), f_in, n)
    if tensor_core:
        entry = library().mlt_policy_step_tc
    else:
        entry, head = library().mlt_policy_step, (_DTYPE_CODES[dt], *head)
    out = _step(entry, head, "fused_policy_step", x, mlp_params, wi, wr,
                bias, c, h)
    POLICY_STEP.launches += 1
    POLICY_STEP.tc_launches += int(tensor_core)
    return out


def fused_policy_step_chunked(x, mlp_stacks, wi, wr, bias, chunk_policy, c,
                              h):
    """The chunk-indexed step: ``x`` [B * C, F] of B chunks of C rows,
    ``mlp_stacks`` 1 to 4 layers ``(W [P, F_in, H], ln_scale [P, H] f32,
    ln_bias [P, H] f32)``, ``wi`` / ``wr`` [P, H, 4H], ``bias`` [P, 4H],
    ``chunk_policy`` [B] int32, ``c`` / ``h`` [B * C, H] -> (feats, (c',
    h')), each [B * C, H]; chunk b runs with policy ``chunk_policy[b]``'s
    weights, and every row equals ``fused_policy_step``'s row with them
    bitwise. A chunk whose policy lies outside [0, P) is skipped: its rows
    are NaN. Same path rule as ``fused_policy_step``. CPU tensors take the
    plain twin."""
    if x.device.type == "cpu":
        return fused_policy_step_chunked_reference(x, mlp_stacks, wi, wr,
                                                   bias, chunk_policy, c, h)
    return _launch_chunked(x, mlp_stacks, wi, wr, bias, chunk_policy, c, h)


def _launch_chunked(x, mlp_stacks, wi, wr, bias, chunk_policy, c, h):
    """The kernel launch of ``fused_policy_step_chunked``: checks, route,
    launch and counts, whatever device the operands report."""
    what = "fused_policy_step_chunked"
    _no_grad(what, [x, wi, wr, bias, c, h] + [
        p for layer in mlp_stacks for p in layer])
    if wi.dim() != 3 or chunk_policy.dim() != 1:
        raise ValueError(f"{what}: wi must be [P, H, 4H] and chunk_policy "
                         f"[B], got {tuple(wi.shape)}, "
                         f"{tuple(chunk_policy.shape)}")
    P, B = wi.shape[0], chunk_policy.shape[0]
    n, f_in, hidden = _check_step(what, x, mlp_stacks, wi, wr, bias, c, h,
                                  stack=(P,))
    if P == 0 or B == 0 or n % B:
        raise ValueError(f"{what}: {n} rows are not {B} whole chunks of "
                         f"{P} policies")
    _check("chunk_policy", chunk_policy, torch.int32, (B,))
    dt = h.dtype
    tensor_core = uses_tensor_cores(dt, hidden, f_in)
    mlp_stacks, wi, wr, bias, c, h = _aligned(tensor_core, mlp_stacks, wi,
                                              wr, bias, c, h)
    head = (int(tensor_core), _DTYPE_CODES[dt], hidden, len(mlp_stacks),
            f_in, B, n // B, P, chunk_policy.data_ptr())
    out = _step(library().mlt_policy_step_chunked, head, what, x,
                mlp_stacks, wi, wr, bias, c, h)
    POLICY_STEP_CHUNKED.launches += 1
    POLICY_STEP_CHUNKED.tc_launches += int(tensor_core)
    return out


def _step(entry, head, what, x, mlp_params, wi, wr, bias, c, h):
    """One launch of a C entry point on checked operands; ``head`` holds
    its leading arguments, up to x."""
    layer_ptrs = [t.data_ptr() for layer in mlp_params for t in layer]
    layer_ptrs += [None] * (3 * (_MAX_LAYERS - len(mlp_params)))
    feats = torch.empty_like(h)
    c_out = torch.empty_like(c)
    h_out = torch.empty_like(h)
    err = entry(
        *head, x.data_ptr(), *layer_ptrs, wi.data_ptr(), wr.data_ptr(),
        bias.data_ptr(), c.data_ptr(), h.data_ptr(), feats.data_ptr(),
        c_out.data_ptr(), h_out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    check(err, what)
    return feats, (c_out, h_out)
