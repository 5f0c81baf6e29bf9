"""The port's grouped_matmul (plain version of the ``grouped_matmul``
kernel) against the JAX package.

The Pallas kernel runs in interpret mode, as tests/test_pallas_kernels.py
runs it, at its two shapes; inputs are made with numpy from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_learn_tpu.ops.pallas.grouped_matmul import (
    grouped_matmul as jax_grouped_matmul,
)
from madrona_learn_tpu.ops.pallas.grouped_matmul import (
    grouped_matmul_reference as jax_grouped_matmul_reference,
)
from madrona_learn_tpu_torch.ops.cuda import KERNELS
from madrona_learn_tpu_torch.ops.cuda.grouped_matmul import (
    grouped_matmul,
    grouped_matmul_reference,
)

torch.set_num_threads(1)

# float32: the same products summed over IN in another order. bfloat16:
# both sides sum the products of the bf16 inputs in f32 and round once, so
# they differ by at most one bf16 ulp (2^-7 relative).
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2 ** -7, atol=1e-6)}


def _launches():
    return {k.name: k.launches for k in KERNELS}


def _inputs(seed, B, C, IN, P, OUT):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, C, IN)).astype(np.float32),
            (rng.normal(size=(P, IN, OUT)) * IN ** -0.5).astype(np.float32),
            rng.integers(0, P, size=(B,)).astype(np.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(8, 64, 32, 4, 128), (5, 128, 64, 3, 96)])
def test_grouped_matmul_plain_matches_pallas(shape, dtype):
    x, w, idx = _inputs(sum(shape), *shape)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    before = _launches()
    got = grouped_matmul(torch.from_numpy(x).to(tdt),
                         torch.from_numpy(w).to(tdt), torch.from_numpy(idx))
    assert _launches() == before  # CPU tensors never launch a kernel
    B, C, _, _, OUT = shape
    assert got.dtype == tdt and got.shape == (B, C, OUT)
    xj, wj, ij = jnp.asarray(x, jdt), jnp.asarray(w, jdt), jnp.asarray(idx)
    for want in (jax_grouped_matmul(xj, wj, ij, True),
                 jax_grouped_matmul_reference(xj, wj, ij)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   **TOL[dtype])


def test_grouped_matmul_uses_each_chunks_policy():
    """Chunk i's rows go through weights[chunk_policy[i]] only: one-hot
    policies make each chunk's output its own weight slice."""
    B, C, IN, P, OUT = 4, 3, 5, 3, 7
    w = torch.arange(P * IN * OUT, dtype=torch.float32).reshape(P, IN, OUT)
    idx = torch.tensor([2, 0, 2, 1], dtype=torch.int32)
    x = torch.zeros(B, C, IN)
    x[:, :, 1] = 1.0
    y = grouped_matmul(x, w, idx)
    for i in range(B):
        torch.testing.assert_close(y[i], w[idx[i], 1].expand(C, OUT))
    torch.testing.assert_close(y, grouped_matmul_reference(x, w, idx))


def test_grouped_matmul_wrapper_refuses_what_the_kernel_cannot_take():
    """Tensors that are not on the CPU go to the kernel path, which raises
    on operands it cannot take instead of taking the plain version."""
    before = _launches()

    def meta(*shape, dtype=torch.float32):
        return torch.empty(*shape, dtype=dtype, device="meta")

    idx = meta(4, dtype=torch.int32)
    for x, w, i in (
            (meta(4, 8, 16), meta(3, 16, 32), idx),       # not on the card
            (meta(4, 8, 16, dtype=torch.float64),
             meta(3, 16, 32, dtype=torch.float64), idx),  # dtype
            (meta(4, 8, 16), meta(3, 16, 32, dtype=torch.bfloat16),
             idx),                                          # mixed dtypes
            (meta(4, 8, 16), meta(3, 12, 32), idx),       # IN differs
            (meta(4, 8, 16), meta(3, 16, 32),
             meta(4, dtype=torch.int64)),                  # index dtype
            (meta(4, 8, 16), meta(3, 16, 32),
             meta(5, dtype=torch.int32)),                  # index length
            (meta(4, 0, 16), meta(3, 16, 32), idx),       # empty chunks
            (meta(4, 8), meta(3, 16, 32), idx)):          # rank
        with pytest.raises(ValueError):
            grouped_matmul(x, w, i)
    assert _launches() == before
