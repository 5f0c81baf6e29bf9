"""The arithmetic of the bf16 fused rollout step on tensor cores
(``csrc/policy_step.cu``: policy_step_tc_kernel), held on the CPU to the
contracts that define it, and the rule that routes a call to it.

A plain-torch emulation of the kernel's arithmetic: bf16 operands with f32
products summed 64 deep at a time in the kernel's K order (the ring's
slices; layer 0's K zero-padded to a multiple of 64), each Dense rounded to
bf16; LayerNorm's row sums taken per warp over its 16 units and then over
the warps in order, mean and E[x^2] - mean^2 in f32 and rounded to bf16,
the affine in f32 rounded once, then ReLU; ``xp = round(a . Wi)`` before
``h . Wr`` is added slice by slice into the same sums, then the bias; c'
and h' rounded once. It is held

- against ``fused_policy_step_reference``, the plain twin, under the chip
  check's bf16 rule (chip_smoke.py ``TOL[("step", "bfloat16")]``: max
  |diff| <= 3.2e-2);
- against the JAX package's ``fused_policy_step`` (the Pallas kernel in
  interpret mode) under the same rule.

Inputs come from numpy seeds, at N = 70 (ragged against the kernel's R =
32 rows a block), H = 128 and F = 3, 100 and 128, and at N = 40, H = 384
and 512 (the two-block cluster's instances).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_learn_tpu.ops.pallas.policy_step import (
    fused_policy_step as jax_fused_policy_step,
)
from madrona_learn_tpu_torch.ops.cuda import KERNELS
from madrona_learn_tpu_torch.ops.cuda.policy_step import (
    fused_policy_step,
    fused_policy_step_reference,
    uses_tensor_cores,
)

torch.set_num_threads(1)

BF16 = torch.bfloat16
F32 = torch.float32
K_SLICE = 64          # depth of a weight slice in the kernel's ring
WARP_UNITS = 16       # units of one warp's LayerNorm partial
LN_EPS = 1e-6
# The chip check's step rule in bf16 (chip_smoke.py TOL[("step",
# "bfloat16")]): max |diff| <= 3.2e-2.
STEP_ATOL = 3.2e-2


def _inputs(seed, N, F, H, layers):
    """The operands chip_smoke.py draws (orthogonal-scale weights,
    LayerNorm affines near 1 / 0, a carry of scale 0.5), bf16 but the
    LayerNorm parameters."""
    rng = np.random.default_rng(seed)

    def bf(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(BF16)

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    mlp, fin = [], F
    for _ in range(layers):
        mlp.append((bf(rng.normal(size=(fin, H)) * np.sqrt(2 / fin)),
                    f32(1 + 0.1 * rng.normal(size=H)),
                    f32(0.1 * rng.normal(size=H))))
        fin = H
    return (bf(rng.normal(size=(N, F))), mlp,
            bf(rng.normal(size=(H, 4 * H)) / np.sqrt(H)),
            bf(rng.normal(size=(H, 4 * H)) / np.sqrt(H)),
            bf(0.1 * rng.normal(size=4 * H)),
            bf(0.5 * rng.normal(size=(N, H))),
            bf(0.5 * rng.normal(size=(N, H))))


def _chunked(a, b, acc=None):
    """acc + a [M, K] . b [K, N] of bf16 values in f32, K_SLICE deep at a
    time, the slices added in K order."""
    if acc is None:
        acc = torch.zeros(a.shape[0], b.shape[1], dtype=F32)
    for k0 in range(0, a.shape[1], K_SLICE):
        acc = acc + a[:, k0:k0 + K_SLICE].float() @ b[k0:k0 + K_SLICE].float()
    return acc


def _round(x):
    return x.to(BF16).float()


def emulate_tc_step(x, mlp_params, wi, wr, bias, c, h):
    """The tensor-core step's arithmetic: (feats, (c', h'))."""
    N, F = x.shape
    H = h.shape[-1]
    width = -(-F // K_SLICE) * K_SLICE
    a = torch.zeros(N, width, dtype=BF16)
    a[:, :F] = x
    for w, s, lb in mlp_params:
        w_pad = torch.zeros(a.shape[1], H, dtype=BF16)
        w_pad[:w.shape[0]] = w
        af = _round(_chunked(a, w_pad))
        by_warp = af.reshape(N, H // WARP_UNITS, WARP_UNITS)
        sums = by_warp.sum(-1)
        sqs = (by_warp * by_warp).sum(-1)
        s_all = torch.zeros(N, dtype=F32)
        sq_all = torch.zeros(N, dtype=F32)
        for k in range(H // WARP_UNITS):
            s_all = s_all + sums[:, k]
            sq_all = sq_all + sqs[:, k]
        mean_f = (s_all * (1.0 / H))[:, None]
        msq = (sq_all * (1.0 / H))[:, None]
        inv = torch.rsqrt(_round(msq - mean_f * mean_f) + LN_EPS)
        y = (af - _round(mean_f)) * (inv * _round(s)) + _round(lb)
        a = torch.relu(y.to(BF16))
    gates = _chunked(h, wr, _round(_chunked(a, wi))) + bias.float()
    gi, gf, gg, go = gates.chunk(4, dim=-1)
    new_c = torch.sigmoid(gf) * c.float() + torch.sigmoid(gi) * torch.tanh(gg)
    new_h = torch.sigmoid(go) * torch.tanh(new_c)
    return new_h.to(BF16), (new_c.to(BF16), new_h.to(BF16))


def _jax_step(x, mlp_params, wi, wr, bias, c, h):
    def j(t, dt=jnp.bfloat16):
        return jnp.asarray(t.float().numpy(), dt)

    out, (c_new, h_new) = jax_fused_policy_step(
        j(x), [(j(w), j(s, jnp.float32), j(lb, jnp.float32))
               for w, s, lb in mlp_params],
        j(wi), j(wr), j(bias), j(c), j(h), interpret=True)
    return tuple(torch.from_numpy(np.asarray(t, np.float32))
                 for t in (out, c_new, h_new))


def _check(got, want, what):
    got_f, (got_c, got_h) = got
    for name, g, w in zip(("feats", "c'", "h'"), (got_f, got_c, got_h),
                          want):
        err = (g.float() - w.float()).abs().max().item()
        assert err <= STEP_ATOL, (
            f"{what} {name}: max |diff| {err:.3e} above {STEP_ATOL}")


# (N, F, H, layers): the headline_fused tower's shape at H = 128, F in the
# second 64-column slice, and F = 128 with three layers; at H = 384 and
# 512 the two-block cluster (each block's warps' row sums, the cluster's
# warps in unit order: the emulation's 16-unit warps in order).
CASES = [(70, 3, 128, 2), (70, 100, 128, 1), (70, 128, 128, 3),
         (40, 3, 384, 2), (40, 128, 512, 1)]


@pytest.mark.parametrize("N,F,H,layers", CASES)
def test_tc_step_arithmetic_meets_the_plain_contract(N, F, H, layers):
    args = _inputs(100 + F + layers, N, F, H, layers)
    want_f, (want_c, want_h) = fused_policy_step_reference(*args)
    _check(emulate_tc_step(*args), (want_f, want_c, want_h), "vs plain")


@pytest.mark.parametrize("N,F,H,layers", CASES)
def test_tc_step_arithmetic_matches_the_pallas_step(N, F, H, layers):
    args = _inputs(200 + F + layers, N, F, H, layers)
    _check(emulate_tc_step(*args), _jax_step(*args), "vs Pallas")


def test_tc_step_rows_do_not_depend_on_the_batch():
    """A row's outputs are those of the step over that row's block alone:
    the emulation, as the kernel, mixes no rows (the card checks the kernel
    itself bitwise at N = 16384 against N = 512)."""
    args = _inputs(300, 70, 3, 128, 2)
    x, mlp, wi, wr, bias, c, h = args
    whole = emulate_tc_step(*args)
    part = emulate_tc_step(x[5:37], mlp, wi, wr, bias, c[5:37], h[5:37])
    assert torch.equal(whole[0][5:37], part[0])
    assert torch.equal(whole[1][0][5:37], part[1][0])


@pytest.mark.parametrize("dtype,H,F,tensor_core", [
    (BF16, 256, 3, True),       # the headline_fused rollout step
    (BF16, 128, 3, True),
    (BF16, 256, 128, True),
    (BF16, 256, 129, False),    # no kernel takes F > 128
    (BF16, 192, 3, False),      # no kernel at this width
    (BF16, 384, 3, True),       # the two-block cluster
    (BF16, 512, 128, True),
    (F32, 512, 3, False),
    (F32, 256, 3, False),       # float32 stays on CUDA cores
    (F32, 128, 128, False),
])
def test_step_path_rule(dtype, H, F, tensor_core):
    """The route depends on dtype, H and F alone."""
    assert uses_tensor_cores(dtype, H, F) is tensor_core


def test_step_wrapper_refuses_what_no_kernel_takes():
    """Tensors off the CPU go to the kernel wrapper, which raises on what
    neither kernel takes (meta tensors are never on the card; no kernel at
    H = 192) instead of falling back, and counts no launch."""
    before = {k.name: (k.launches, k.tc_launches) for k in KERNELS}

    def meta(*shape, dtype=BF16):
        return torch.empty(*shape, dtype=dtype, device="meta")

    N, F = 8, 3
    for H, dtype in ((256, BF16), (128, F32), (192, BF16)):
        mlp = [(meta(F, H, dtype=dtype), meta(H, dtype=F32),
                meta(H, dtype=F32))]
        with pytest.raises(ValueError):
            fused_policy_step(meta(N, F, dtype=dtype), mlp,
                              meta(H, 4 * H, dtype=dtype),
                              meta(H, 4 * H, dtype=dtype),
                              meta(4 * H, dtype=dtype),
                              meta(N, H, dtype=dtype),
                              meta(N, H, dtype=dtype))
    assert {k.name: (k.launches, k.tc_launches) for k in KERNELS} == before
