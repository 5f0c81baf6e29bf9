"""gae: GAE over the trajectory store, as a CUDA kernel with a plain twin.

Replaces ``madrona_learn_tpu/ops/pallas/gae.py:gae_pallas``. The kernel
(``csrc/gae.cu``) is bound by device-memory bytes (13 per element, a few
flops). A block owns ``COLUMNS`` agent columns, one thread each, and takes
time in chunks of ``CHUNK`` steps from the end, each chunk's tiles staged in
shared memory by ``cp.async`` while the previous chunk's recurrence runs;
the recurrence and its roundings are the plain version's, step for step.

``gae`` takes the plain version for CPU tensors and launches the kernel for
CUDA tensors (``gae_cuda``); it never falls back from one to the other.
"""

from __future__ import annotations

import torch

from .build import Kernel, check, check_operand, library

GAE = Kernel(
    name="gae",
    source="madrona_learn_tpu_torch/csrc/gae.cu",
    replaces="madrona_learn_tpu/ops/pallas/gae.py:50",
)


def gae_reference(gamma, lam, rewards, values, dones, bootstrap):
    """Plain twin: advantages [T, N] from [T, N] inputs and a [N] bootstrap.

    Masks with select, as ``ops/pallas/gae.py:gae_reference`` does, and
    rounds after every multiply and add, as the kernel does.
    """
    rewards = rewards.float()
    values = values.float()
    gamma_lambda = float(gamma * lam)
    next_adv = torch.zeros_like(bootstrap, dtype=torch.float32)
    next_val = bootstrap.float()
    out = torch.empty_like(rewards)
    for t in range(rewards.shape[0] - 1, -1, -1):
        nv = torch.where(dones[t], 0.0, next_val)
        na = torch.where(dones[t], 0.0, next_adv)
        td = rewards[t] + gamma * nv - values[t]
        adv = td + gamma_lambda * na
        out[t] = adv
        next_adv, next_val = adv, values[t]
    return out


# Steps a chunk and agent columns a block: csrc/gae.cu builds every pair of
# CHUNKS x COLUMNS_CHOICES (chip_smoke.py's sweep times them all); the
# wrapper launches the kept pair, the fastest at the trainers' [32, 16384]
# on the H100 (PERF.md, section 6).
CHUNKS = (8, 16, 32)
COLUMNS_CHOICES = (32, 64, 128)
CHUNK, COLUMNS = 16, 64


def gae(gamma, lam, rewards, values, dones, bootstrap):
    """advantages [T, N] f32 from rewards, values [T, N] f32, dones [T, N]
    bool and bootstrap [N] f32."""
    if rewards.device.type == "cpu":
        return gae_reference(gamma, lam, rewards, values, dones, bootstrap)
    return gae_cuda(gamma, lam, rewards, values, dones, bootstrap)


def gae_cuda(gamma, lam, rewards, values, dones, bootstrap, *, chunk=CHUNK,
             columns=COLUMNS):
    """The kernel, with ``chunk`` steps a chunk and ``columns`` agents a
    block (one of the built pairs)."""
    if chunk not in CHUNKS or columns not in COLUMNS_CHOICES:
        raise ValueError(f"gae: no kernel built for {chunk} steps a chunk "
                         f"and {columns} columns a block")
    steps, n = rewards.shape
    for name, x, dtype, shape in (
            ("rewards", rewards, torch.float32, (steps, n)),
            ("values", values, torch.float32, (steps, n)),
            ("dones", dones, torch.bool, (steps, n)),
            ("bootstrap", bootstrap, torch.float32, (n,))):
        check_operand("gae", name, x, dtype, shape)
    if steps == 0 or n == 0:
        raise ValueError(f"gae: empty input {tuple(rewards.shape)}")
    out = torch.empty_like(rewards)
    err = library().mlt_gae(
        rewards.data_ptr(), values.data_ptr(), dones.data_ptr(),
        bootstrap.data_ptr(), out.data_ptr(), steps, n, float(gamma),
        float(gamma * lam), chunk, columns,
        torch.cuda.current_stream(rewards.device).cuda_stream)
    check(err, "gae")
    GAE.launches += 1
    return out


def compute_advantages(gamma, lam, rewards, values, dones, bootstrap_values):
    """GAE in the store layout: [C, T/C, P, B, 1] in, the same shape out."""
    C, TC, P, B = dones.shape[:4]
    T, N = C * TC, P * B
    adv = gae(gamma, lam,
              rewards.reshape(T, N).float().contiguous(),
              values.reshape(T, N).float().contiguous(),
              dones.reshape(T, N).contiguous(),
              bootstrap_values.reshape(N).float().contiguous())
    return adv.reshape(C, TC, P, B, 1)
