"""fused_policy_step: one rollout step of the MLP + LSTM trunk as one CUDA
kernel, with its plain twin.

Replaces ``madrona_learn_tpu/ops/pallas/policy_step.py:fused_policy_step``.
``csrc/policy_step.cu`` explains the Hopper design: a block keeps a tile of
rows' activations in shared memory from the input through every layer to
the LSTM cell, and streams the weights from L2.

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

CPU tensors take the plain version; CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import functools

import torch

from .build import Kernel, check, check_operand, library

POLICY_STEP = Kernel(
    name="fused_policy_step",
    source="madrona_learn_tpu_torch/csrc/policy_step.cu",
    replaces="madrona_learn_tpu/ops/pallas/policy_step.py:119",
)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HIDDEN_SIZES = (128, 256)
_MAX_LAYERS = 4
_LN_EPS = 1e-6  # flax.linen.LayerNorm's default


def policy_step_supported(hidden, feat_in, dtype):
    """Whether the fused step can serve this tower shape (JAX:
    ``ops/pallas/policy_step.py:62``). A width that passes and has no
    kernel instantiation raises at launch."""
    return (hidden % 128 == 0 and feat_in <= 128
            and dtype in (torch.float32, torch.bfloat16))


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


_check = functools.partial(check_operand, "fused_policy_step")


def fused_policy_step(x, mlp_params, wi, wr, bias, c, h):
    """One trunk step: (feats [N, H], (c' [N, H], h' [N, H]))."""
    if x.device.type == "cpu":
        return fused_policy_step_reference(x, mlp_params, wi, wr, bias, c, h)
    operands = [x, wi, wr, bias, c, h] + [p for layer in mlp_params
                                          for p in layer]
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        raise RuntimeError("fused_policy_step has no backward; run the "
                           "rollout step under torch.no_grad()")
    dt = h.dtype
    n, hidden = h.shape
    f_in = x.shape[-1] if x.dim() == 2 else -1
    layers = len(mlp_params)
    if (dt not in _DTYPE_CODES or hidden not in _HIDDEN_SIZES
            or not 1 <= f_in <= 128 or not 1 <= layers <= _MAX_LAYERS):
        raise ValueError(
            f"fused_policy_step: supports float32/bfloat16, H in "
            f"{_HIDDEN_SIZES}, x [N, F <= 128] and 1 to {_MAX_LAYERS} MLP "
            f"layers; got {dt}, H={hidden}, x {tuple(x.shape)}, "
            f"{layers} layers")
    if n == 0:
        raise ValueError("fused_policy_step: empty batch")
    _check("x", x, dt, (n, f_in))
    layer_ptrs = []
    fin = f_in
    for i, (w, s, lb) in enumerate(mlp_params):
        _check(f"W_{i}", w, dt, (fin, hidden))
        _check(f"ln_scale_{i}", s, torch.float32, (hidden,))
        _check(f"ln_bias_{i}", lb, torch.float32, (hidden,))
        layer_ptrs += [w.data_ptr(), s.data_ptr(), lb.data_ptr()]
        fin = hidden
    layer_ptrs += [None] * (3 * (_MAX_LAYERS - layers))
    _check("wi", wi, dt, (hidden, 4 * hidden))
    _check("wr", wr, dt, (hidden, 4 * hidden))
    _check("bias", bias, dt, (4 * hidden,))
    _check("c", c, dt, (n, hidden))
    _check("h", h, dt, (n, hidden))
    feats = torch.empty_like(h)
    c_out = torch.empty_like(c)
    h_out = torch.empty_like(h)
    err = library().mlt_policy_step(
        _DTYPE_CODES[dt], hidden, layers, f_in, n, x.data_ptr(), *layer_ptrs,
        wi.data_ptr(), wr.data_ptr(), bias.data_ptr(), c.data_ptr(),
        h.data_ptr(), feats.data_ptr(), c_out.data_ptr(), h_out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "fused_policy_step")
    POLICY_STEP.launches += 1
    return feats, (c_out, h_out)
