#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's PPO main path once on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: requires CUDA, prints the card's name and power limit;
2. build: compiles ``madrona_learn_tpu_torch/csrc/*.cu`` with nvcc;
3. kernels: each hand-written kernel against its plain PyTorch version at
   the main path's shapes and at a ragged batch, with the stated
   tolerances, and the median time of both;
4. trainer: the ``bench.py`` headline configuration (16384 worlds, 2x256
   MLP, 256-wide LSTM, bf16, T=32 in 2 BPTT chunks, 1 epoch of 4
   minibatches) built in the port, 1 warm-up update and 3 trials of 10
   updates; checks finite losses and metrics, and that every kernel's
   launch count grew by what the configuration implies.

The last line is ``{"ok": true, "device": {...}}``; the line before it lists
every kernel with its launches on the main path, error and times.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

# Tolerances, max |kernel - plain| <= atol + rtol * max |plain|:
# - float32: the kernels and the plain versions do the same f32 math and
#   differ only in the summation order of the products and in expf/tanhf
#   against PyTorch's implementations (a few ulp per step);
# - bfloat16: outputs are rounded to bf16 (8 mantissa bits), so a few-ulp
#   f32 difference can flip a rounding by one bf16 ulp (2^-7 at |x| = 1)
#   and the recurrence carries it on; the plain backward (autograd through
#   the plain forward) also rounds the gate cotangents at other points than
#   the kernel, which rounds them to bf16 as the TPU kernel does.
TOL = {
    "gae": dict(atol=1e-5, rtol=1e-5),
    ("fwd", "float32"): dict(atol=1e-5, rtol=1e-5),
    ("bwd", "float32"): dict(atol=1e-4, rtol=1e-4),
    ("fwd", "bfloat16"): dict(atol=3.2e-2, rtol=0.0),
    ("bwd", "bfloat16"): dict(atol=0.0, rtol=3.2e-2),
}


def log(msg):
    print(msg, flush=True)


def device_phase():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0].strip()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    # Plain float32 products in full f32, as the reference semantics assume.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def build_phase():
    from madrona_learn_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    log(build.build_log())


def time_ms(fn, reps=10, warmup=2):
    """Median wall time of one call on the card, with CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(name, got, want, atol, rtol):
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    ok = math.isfinite(err) and err <= atol + rtol * scale
    log(f"  {name}: max_abs_err {err:.3e} (max |plain| {scale:.3e}, "
        f"tol atol {atol:g} rtol {rtol:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with plain version")
    return err


def check_gae(results):
    import torch
    from madrona_learn_tpu_torch.ops.cuda.gae import gae, gae_reference

    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = 0.0
    for T, N in ((32, 16384), (32, 1000)):
        r = torch.randn(T, N, device="cuda", generator=gen)
        v = torch.randn(T, N, device="cuda", generator=gen)
        d = torch.rand(T, N, device="cuda", generator=gen) < 0.05
        b = torch.randn(N, device="cuda", generator=gen)
        got = gae(0.99, 0.95, r, v, d, b)
        want = gae_reference(0.99, 0.95, r, v, d, b)
        worst = max(worst, compare(f"gae [{T},{N}]", got, want,
                                   **TOL["gae"]))
        if N == 16384:
            ms = time_ms(lambda: gae(0.99, 0.95, r, v, d, b))
            plain_ms = time_ms(
                lambda: gae_reference(0.99, 0.95, r, v, d, b))
            log(f"  gae [{T},{N}] kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            results["gae"] = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms)
    results["gae"]["max_abs_err"] = worst


def _lstm_inputs(gen, T, N, H, dtype):
    import torch

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, device="cuda", generator=gen)
                * scale).to(dtype)

    return (rnd(T, N, 4 * H),
            (torch.rand(T, N, device="cuda", generator=gen) > 0.2).to(dtype),
            rnd(H, 4 * H, scale=H ** -0.5), rnd(4 * H), rnd(N, H), rnd(N, H))


def check_lstm(results):
    import torch
    from madrona_learn_tpu_torch.ops.cuda.lstm import (
        lstm_sequence_bwd, lstm_sequence_fwd, lstm_sequence_reference)

    gen = torch.Generator(device="cuda").manual_seed(2)
    fwd = results["lstm_sequence_fwd"] = {"max_abs_err": 0.0}
    bwd = results["lstm_sequence_bwd"] = {"max_abs_err": 0.0}
    # (T, N, H, dtype, on the main path): the update minibatch, the rollout
    # step, a ragged batch, and float32 at both instantiated widths.
    cases = [
        (16, 8192, 256, torch.bfloat16, True),
        (1, 16384, 256, torch.bfloat16, True),
        (16, 1000, 256, torch.bfloat16, False),
        (5, 1000, 256, torch.float32, False),
        (4, 70, 128, torch.float32, False),
    ]
    for T, N, H, dtype, main_path in cases:
        dname = str(dtype).split(".")[-1]
        tag = f"[{T},{N},{4 * H}] {dname}"
        args = _lstm_inputs(gen, T, N, H, dtype)
        probe = torch.randn(T, N, H, device="cuda", generator=gen).to(dtype)

        ys, cs = lstm_sequence_fwd(*args)
        err = compare(f"lstm fwd {tag}", ys, lstm_sequence_reference(*args),
                      **TOL[("fwd", dname)])
        if main_path:
            fwd["max_abs_err"] = max(fwd["max_abs_err"], err)

        leaves = [a.detach().clone().requires_grad_(i != 1)
                  for i, a in enumerate(args)]
        diff = [leaves[i] for i in (0, 2, 3, 4, 5)]

        def plain_bwd():
            out = lstm_sequence_reference(*leaves)
            return torch.autograd.grad(
                (out.float() * probe.float()).sum(), diff)

        got = lstm_sequence_bwd(*args, ys, cs, probe)
        for name, g, w in zip(("dxp", "dwr", "db", "dc0", "dh0"), got,
                              plain_bwd()):
            err = compare(f"lstm bwd {name} {tag}", g, w,
                          **TOL[("bwd", dname)])
            if main_path and T > 1:
                bwd["max_abs_err"] = max(bwd["max_abs_err"], err)

        if main_path and T > 1:
            fwd["ms"] = time_ms(lambda: lstm_sequence_fwd(*args))
            fwd["plain_ms"] = time_ms(lambda: lstm_sequence_reference(*args))
            bwd["ms"] = time_ms(
                lambda: lstm_sequence_bwd(*args, ys, cs, probe))
            bwd["plain_ms"] = time_ms(plain_bwd)
            log(f"  lstm {tag}: fwd kernel {fwd['ms']:.3f} ms, plain "
                f"{fwd['plain_ms']:.3f} ms; bwd kernel {bwd['ms']:.3f} ms, "
                f"plain {bwd['plain_ms']:.3f} ms")
        elif main_path:
            step_ms = time_ms(lambda: lstm_sequence_fwd(*args))
            step_plain = time_ms(lambda: lstm_sequence_reference(*args))
            log(f"  lstm {tag}: fwd kernel {step_ms:.3f} ms, plain "
                f"{step_plain:.3f} ms")


def kernel_phase():
    results = {}
    log("kernels against their plain versions:")
    check_gae(results)
    check_lstm(results)
    return results


def _small_actor_critic(dtype, hidden, seed):
    import torch
    from madrona_learn_tpu_torch.config import DiscreteActionsConfig
    from madrona_learn_tpu_torch.models import (
        LSTM, MLP, ActorCritic, BackboneShared, DenseLayerCritic,
        DenseLayerDiscreteActor, DictActor, RecurrentBackboneEncoder)

    gen = torch.Generator().manual_seed(seed)
    move = DiscreteActionsConfig(actions_num_buckets=[5])
    return ActorCritic(
        backbone=BackboneShared(
            prefix=lambda obs: torch.cat([obs["delta"], obs["time"]], -1),
            encoder=RecurrentBackboneEncoder(
                net=MLP(3, hidden, 2, dtype, generator=gen),
                rnn=LSTM(hidden, hidden, 1, dtype, generator=gen))),
        actor=DictActor({"move": DenseLayerDiscreteActor(
            move, hidden, dtype, generator=gen)}),
        critic=DenseLayerCritic(hidden, dtype, generator=gen))


def model_phase():
    """The update-pass forward and its gradients through the kernels on
    the card against the same model on the CPU (plain versions), float32,
    small input."""
    import copy

    import torch

    log("model update pass, card (kernels) against CPU (plain), float32:")
    T, N, H = 8, 96, 128
    gen = torch.Generator().manual_seed(3)
    ac_cpu = _small_actor_critic(torch.float32, H, seed=4)
    ac_gpu = copy.deepcopy(ac_cpu).cuda()
    obs = {"delta": torch.randn(T, N, 2, generator=gen),
           "time": torch.rand(T, N, 1, generator=gen)}
    dones = torch.rand(T, N, 1, generator=gen) < 0.2
    actions = {"move": torch.randint(0, 5, (T, N, 1), generator=gen)}
    start = tuple(torch.randn(N, 1, H, generator=gen) for _ in range(2))

    def run(ac, dev):
        out = ac.update(tuple(s.to(dev) for s in start), dones.to(dev),
                        {k: v.to(dev) for k, v in actions.items()},
                        {k: v.to(dev) for k, v in obs.items()})
        loss = (out["log_probs"]["move"].sum() + out["critic"].square().sum()
                + out["entropies"]["move"].sum())
        names, params = zip(*ac.named_parameters())
        grads = torch.autograd.grad(loss, params)
        return out, dict(zip(names, grads))

    out_cpu, g_cpu = run(ac_cpu, "cpu")
    out_gpu, g_gpu = run(ac_gpu, "cuda")
    # Same f32 math; the products sum in another order on the card.
    tol = dict(atol=1e-4, rtol=1e-4)
    compare("log_probs", out_gpu["log_probs"]["move"].cpu(),
            out_cpu["log_probs"]["move"], **tol)
    compare("critic", out_gpu["critic"].cpu(), out_cpu["critic"], **tol)
    for name in g_cpu:
        compare(f"grad {name}", g_gpu[name].cpu(), g_cpu[name], **tol)


NUM_WORLDS = 16384
STEPS_PER_UPDATE = 32
NUM_BPTT_CHUNKS = 2
NUM_MINIBATCHES = 4
CHANNELS = 256
TIMED_UPDATES = 10
TRIALS = 3


def build_trainer(hooks):
    import torch
    import madrona_learn_tpu_torch as mlt
    from madrona_learn_tpu_torch.envs import ToyEnvConfig, make_toy_env

    dtype = torch.bfloat16
    actor_critic = _small_actor_critic(dtype, CHANNELS, seed=0)
    policy = mlt.Policy(
        actor_critic=actor_critic,
        obs_preprocess=mlt.ObservationsEMANormalizer.create(
            decay=0.99999, dtype=dtype))
    cfg = mlt.TrainConfig(
        num_worlds=NUM_WORLDS,
        num_agents_per_world=1,
        actions={"move": mlt.DiscreteActionsConfig(actions_num_buckets=[5])},
        steps_per_update=STEPS_PER_UPDATE,
        num_bptt_chunks=NUM_BPTT_CHUNKS,
        lr=1e-3,
        gamma=0.99,
        gae_lambda=0.95,
        seed=0,
        metrics_buffer_size=1,
        algo=mlt.PPOConfig(
            num_epochs=1,
            minibatch_size=NUM_BPTT_CHUNKS * NUM_WORLDS // NUM_MINIBATCHES,
            clip_coef=0.2,
            value_loss_coef=0.5,
            entropy_coef=0.01,
            max_grad_norm=0.5,
        ),
    )
    sim_fns = make_toy_env(ToyEnvConfig(
        num_worlds=NUM_WORLDS, episode_len=40, grid_size=8, seed=0),
        device="cuda")
    return mlt.init_training(
        "cuda", cfg, sim_fns, policy,
        torch.zeros((1,), dtype=torch.int32, device="cuda"),
        user_hooks=hooks)


def trainer_phase(card):
    import torch
    from madrona_learn_tpu_torch.ops.cuda import KERNELS
    from madrona_learn_tpu_torch.train import TrainHooks

    class PhaseTimer(TrainHooks):
        """Synchronizing timestamps at the collect / learn boundary, only
        while ``active`` (the timed trials run with it off)."""

        def __init__(self):
            self.active = False
            self.marks = []

        def _mark(self, name):
            if self.active:
                torch.cuda.synchronize()
                self.marks.append((name, time.perf_counter()))

        def start_rollouts(self, rollout_state, user_state):
            self._mark("collect")
            return rollout_state, user_state

        def rollout_metrics(self, metrics, rollouts, user_state):
            self._mark("learn")
            return metrics

    timer = PhaseTimer()
    mgr = build_trainer(timer)
    per_update = {
        "gae": 1,
        # one rollout step per collect step, the bootstrap value's critic
        # step, and the sequence forward of every minibatch
        "lstm_sequence_fwd": STEPS_PER_UPDATE + 1 + NUM_MINIBATCHES,
        "lstm_sequence_bwd": NUM_MINIBATCHES,
    }
    num_updates = 1 + TRIALS * TIMED_UPDATES
    log(f"trainer: {NUM_WORLDS} worlds, bf16, MLP 2x{CHANNELS}, LSTM "
        f"{CHANNELS}, T={STEPS_PER_UPDATE} in {NUM_BPTT_CHUNKS} chunks, "
        f"{NUM_MINIBATCHES} minibatches; expected launches per update "
        f"{per_update}")

    for k in KERNELS:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    losses, rewards = [], []

    def one_update():
        mgr.update_iter()
        losses.append(mgr.first_minibatch_stats["loss"])
        rewards.append(mgr.metrics.latest("Rewards").mean[0])

    t0 = time.perf_counter()
    one_update()
    torch.cuda.synchronize()
    log(f"  warm-up update: {time.perf_counter() - t0:.3f} s")
    stats = mgr.first_minibatch_stats
    ratio_dev = stats["max_abs_ratio_dev"].item()
    clip_frac = stats["clip_fraction"].item()
    log(f"  first update, first minibatch: max |ratio - 1| {ratio_dev:.3e}, "
        f"clip fraction {clip_frac:.3e}")

    trial_s = []
    for _ in range(TRIALS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TIMED_UPDATES):
            one_update()
        torch.cuda.synchronize()
        trial_s.append(time.perf_counter() - t0)
        for name, m in mgr.metrics.metrics.items():
            if not bool(torch.isfinite(m.mean).all()):
                raise AssertionError(f"metric {name} is not finite")
    launches = {k.name: k.launches for k in KERNELS}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    loss_hist = torch.stack(losses).float().cpu()
    reward_hist = torch.stack(rewards).float().cpu()
    if not bool(torch.isfinite(loss_hist).all()):
        raise AssertionError(f"non-finite loss: {loss_hist.tolist()}")
    for name, per in per_update.items():
        if launches[name] != per * num_updates:
            raise AssertionError(
                f"{name}: {launches[name]} launches over {num_updates} "
                f"updates, expected {per * num_updates}")
    log(f"  launches over {num_updates} updates: {launches} (expected "
        f"{ {k: v * num_updates for k, v in per_update.items()} })")
    env_steps = TIMED_UPDATES * STEPS_PER_UPDATE * NUM_WORLDS
    sps = [env_steps / s for s in trial_s]
    log(f"  trials: {[f'{s * 1e3 / TIMED_UPDATES:.1f} ms/update' for s in trial_s]}")
    log(f"  env-steps/s (best of {TRIALS}x{TIMED_UPDATES}): {max(sps):.0f} "
        f"on {card}")
    log(f"  peak device memory: {peak_gib:.2f} GiB")
    log(f"  mean reward: update 1 {reward_hist[0]:.4f}, update "
        f"{num_updates} {reward_hist[-1]:.4f}")
    if not reward_hist[-10:].mean() > reward_hist[:3].mean():
        raise AssertionError(
            f"mean reward did not rise: {reward_hist.tolist()}")

    # Collect / learn split over a few synchronized updates.
    timer.active = True
    for _ in range(3):
        one_update()
    timer._mark("end")
    timer.active = False
    spans = {}
    for (name, t), (_, t_next) in zip(timer.marks, timer.marks[1:]):
        spans.setdefault(name, []).append((t_next - t) * 1e3)
    log(f"  phase split (ms, synchronized): "
        f"{ {k: [round(v, 2) for v in vs] for k, vs in spans.items()} }")
    return launches, dict(sps=max(sps), ratio_dev=ratio_dev,
                          clip_frac=clip_frac)


def main():
    card = device_phase()
    build_phase()
    results = kernel_phase()
    model_phase()
    launches, _ = trainer_phase(card)

    import torch
    from madrona_learn_tpu_torch.ops.cuda import KERNELS

    kernels = []
    for k in KERNELS:
        r = results[k.name]
        kernels.append({
            "name": k.name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": launches[k.name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"]})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
