"""gae: GAE over the trajectory store, as a CUDA kernel with a plain twin.

Replaces ``madrona_learn_tpu/ops/pallas/gae.py:gae_pallas``. The kernel
(``csrc/gae.cu``) gives one thread to each agent column and runs the reverse
recurrence in registers; it is bound by device-memory bytes (13 per element,
a few flops), and its layout reads and writes each element once, coalesced.

``gae`` takes the plain version for CPU tensors and launches the kernel for
CUDA tensors; it never falls back from one to the other.
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


def gae(gamma, lam, rewards, values, dones, bootstrap):
    """advantages [T, N] f32 from rewards, values [T, N] f32, dones [T, N]
    bool and bootstrap [N] f32."""
    if rewards.device.type == "cpu":
        return gae_reference(gamma, lam, rewards, values, dones, bootstrap)
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
        float(gamma * lam), torch.cuda.current_stream(rewards.device)
        .cuda_stream)
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
