"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU every wrapper takes its kernel's plain PyTorch version, so these
tests hold the plain versions (the functions the CUDA kernels are checked
against on the card by chip_smoke.py) against the Pallas kernels run in
interpret mode, as tests/test_pallas_kernels.py runs them. Inputs come from
a numpy seed and go to both packages.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_learn_tpu.ops.pallas.gae import (
    compute_advantages_pallas,
    gae_pallas,
)
from madrona_learn_tpu.ops.pallas.lstm import lstm_sequence as jax_lstm_seq
from madrona_learn_tpu_torch.ops.cuda import KERNELS, build
from madrona_learn_tpu_torch.ops.cuda.gae import compute_advantages, gae
from madrona_learn_tpu_torch.ops.cuda.lstm import (
    lstm_sequence,
    lstm_sequence_bwd,
    lstm_sequence_fwd,
    lstm_sequence_reference,
    lstm_step,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _launches():
    return {k.name: k.launches for k in KERNELS}


def _gae_inputs(seed, T, N):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(T, N)).astype(np.float32),
            rng.normal(size=(T, N)).astype(np.float32),
            rng.random((T, N)) < 0.1,
            rng.normal(size=(N,)).astype(np.float32))


def test_gae_plain_matches_pallas_across_a_tile_edge():
    # N = 600 crosses the TPU kernel's 512-agent tile.
    r, v, d, b = _gae_inputs(0, 8, 600)
    before = _launches()
    got = gae(0.99, 0.95, *map(torch.from_numpy, (r, v, d, b)))
    want = gae_pallas(0.99, 0.95, *map(jnp.asarray, (r, v, d, b)),
                      interpret=True)
    assert _launches() == before  # CPU tensors never launch a kernel
    # The TPU kernel multiplies by notdones where the plain version
    # selects, and XLA may fuse a*b+c into an FMA: last-bit differences.
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


def test_gae_store_layout_matches_pallas():
    rng = np.random.default_rng(3)
    shape = (2, 8, 1, 96, 1)
    r = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    d = rng.random(shape) < 0.15
    b = rng.normal(size=(1, 96, 1)).astype(np.float32)
    got = compute_advantages(0.99, 0.9, *map(torch.from_numpy, (r, v, d, b)))
    want = compute_advantages_pallas(0.99, 0.9, *map(jnp.asarray,
                                                     (r, v, d, b)),
                                     interpret=True)
    assert got.shape == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


def _lstm_inputs(seed, T, N, H):
    """The distribution tests/test_pallas_kernels.py:_lstm_rand draws."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(T, N, 4 * H)).astype(np.float32),
            (rng.random((T, N)) > 0.2).astype(np.float32),
            (rng.normal(size=(H, 4 * H)) / np.sqrt(H)).astype(np.float32),
            rng.normal(size=(4 * H,)).astype(np.float32),
            rng.normal(size=(N, H)).astype(np.float32),
            rng.normal(size=(N, H)).astype(np.float32))


def test_lstm_plain_forward_matches_pallas():
    args = _lstm_inputs(10, 4, 70, 128)
    got = lstm_sequence(*map(torch.from_numpy, args))
    want = jax_lstm_seq(*map(jnp.asarray, args), True)
    # Same f32 math; the products sum in another order (test_pallas_kernels
    # holds the Pallas kernel to its own twin with the same 1e-5).
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_lstm_plain_gradients_match_pallas():
    T, N, H = 4, 70, 128
    args = _lstm_inputs(11, T, N, H)
    probe = np.random.default_rng(12).normal(size=(T, N, H)).astype(
        np.float32)

    def loss_jax(xp, wr, b, c0, h0):
        ys = jax_lstm_seq(xp, jnp.asarray(args[1]), wr, b, c0, h0, True)
        return jnp.sum(ys * jnp.asarray(probe))

    diff = (args[0],) + args[2:]
    want = jax.grad(loss_jax, argnums=tuple(range(5)))(
        *map(jnp.asarray, diff))

    leaves = [torch.tensor(a, requires_grad=True) for a in diff]
    ys = lstm_sequence(leaves[0], torch.from_numpy(args[1]), *leaves[1:])
    got = torch.autograd.grad((ys * torch.from_numpy(probe)).sum(), leaves)
    # Tolerance of the JAX package's own kernel-vs-twin gradient test.
    for g, w, name in zip(got, want, ("dxp", "dwr", "db", "dc0", "dh0")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_step_is_the_first_sequence_step(dtype):
    """The rollout step and the sequence pass round at the same points, so
    one step equals the first step of a T = 1 sequence bit for bit."""
    args = [torch.from_numpy(a).to(dtype)
            for a in _lstm_inputs(13, 1, 33, 128)]
    xp, keep, wr, b, c0, h0 = args
    new_c, new_h = lstm_step(xp[0], wr, b, c0, h0)
    ys = lstm_sequence_reference(xp, torch.ones_like(keep), wr, b, c0, h0)
    assert new_h.dtype == dtype and new_c.dtype == dtype
    torch.testing.assert_close(new_h, ys[0], rtol=0, atol=0)


def test_kernel_wrappers_never_fall_back():
    """Tensors on a device that is not the CPU go to the kernel path, which
    refuses anything it cannot launch instead of taking the plain
    version."""
    before = _launches()
    meta = lambda *shape, dtype=torch.float32: torch.empty(
        *shape, dtype=dtype, device="meta")
    with pytest.raises(ValueError):
        gae(0.99, 0.95, meta(4, 8), meta(4, 8), meta(4, 8, dtype=torch.bool),
            meta(8))
    T, N, H = 2, 8, 128
    seq = (meta(T, N, 4 * H), meta(T, N), meta(H, 4 * H), meta(4 * H),
           meta(N, H), meta(N, H))
    with pytest.raises(ValueError):
        lstm_sequence(*seq)
    with pytest.raises(ValueError):
        lstm_sequence_fwd(*seq)
    with pytest.raises(ValueError):
        lstm_sequence_bwd(*seq, meta(T, N, H), meta(T, N, H), meta(T, N, H))
    assert _launches() == before


def test_find_nvcc_prefers_cuda_home(tmp_path, monkeypatch):
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text("#!/bin/sh\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    assert build.find_nvcc() == str(nvcc)


def test_find_nvcc_reports_a_missing_toolkit(monkeypatch):
    monkeypatch.setattr(build.os, "access", lambda path, mode: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()


def test_port_imports_without_jax_triton_or_cuda():
    code = (
        "import sys\n"
        "import madrona_learn_tpu_torch as m\n"
        "import madrona_learn_tpu_torch.compat.from_jax\n"
        "import madrona_learn_tpu_torch.envs, madrona_learn_tpu_torch.models\n"
        "from madrona_learn_tpu_torch.ops.cuda import build\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'optax', 'triton')]\n"
        "assert not bad, bad\n"
        "assert build.library.cache_info().currsize == 0\n"
        "print('ok')\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
