#!/usr/bin/env python3
"""Learning curves of the PyTorch port against the JAX package's record.

Rebuilds configurations of ``scripts/parity_curves.py`` in
``madrona_learn_tpu_torch`` and trains each on the CPU over several seeds:
the toy gridworld at 256 worlds with 40-step episodes, an MLP 2 x 128 +
LSTM 128 actor-critic in float32, T = 40 in 2 BPTT chunks, 2 epochs of 4
minibatches, 150 updates. The configurations:

- ``base``: ``DenseLayerCritic``;
- ``valuenorm``: the same with ``normalize_values=True``;
- ``dreamer``: ``DreamerV3Critic`` (``dreamer_v3_critic=True``);
- ``filter``: ``filter_advantages=True`` over a feed-forward tower
  (``BackboneEncoder`` over the MLP: filtering flattens time, which a
  recurrent state cannot follow, in both packages);
- ``importance``: ``importance_sample_trajectories=True`` with 2
  minibatches drawn of the 4;
- ``hlgauss``: ``HLGaussCritic``;
- ``hlgauss_twopart``: ``HLGaussTwoPartCritic``.

Each run's curve is the mean reward of every update. A configuration's
result is the mean over seeds of the final quartile's mean reward. It is
held against the JAX package's own result in ``PARITY_CURVES.json``
(``ours_final_mean`` / ``ours_final_std``) by that script's rule: the gap
is below 3 x the spread (the larger of the two seed deviations and 1e-3),
and both runs clearly learned (final > 3 x |first update|). The results go
to ``PARITY_CURVES_TORCH.json``; ``PARITY_CURVES.json`` is only read.

    python3 scripts/torch_parity_curves.py            # all seven, ~minutes
    python3 scripts/torch_parity_curves.py --config hlgauss --seeds 1

Exits 0 when every configuration run agrees.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

CONFIGS = ("base", "valuenorm", "dreamer", "filter", "importance",
           "hlgauss", "hlgauss_twopart")
NUM_CHANNELS = 128
EPISODE_LEN = 40
GRID = 8
LR = 1e-3


def run_port(config: str, seed: int, num_updates: int, num_worlds: int):
    """One training run on the CPU: the mean reward of every update."""
    import torch

    import madrona_learn_tpu_torch as mlt
    from madrona_learn_tpu_torch.envs import ToyEnvConfig, make_toy_env
    from madrona_learn_tpu_torch.models import (
        LSTM, MLP, ActorCritic, BackboneEncoder, BackboneShared,
        DenseLayerCritic, DenseLayerDiscreteActor, DictActor,
        DreamerV3Critic, HLGaussCritic, HLGaussTwoPartCritic,
        RecurrentBackboneEncoder)

    torch.set_num_threads(1)
    dtype = torch.float32
    gen = torch.Generator().manual_seed(seed)
    actions = {"move": mlt.DiscreteActionsConfig(actions_num_buckets=[5])}
    critic = {
        "dreamer": lambda: DreamerV3Critic(NUM_CHANNELS, dtype),
        "hlgauss": lambda: HLGaussCritic.create(NUM_CHANNELS, dtype),
        "hlgauss_twopart": lambda: HLGaussTwoPartCritic.create(NUM_CHANNELS,
                                                               dtype),
    }.get(config, lambda: DenseLayerCritic(NUM_CHANNELS, dtype,
                                           generator=gen))
    net = MLP(3, NUM_CHANNELS, 2, dtype, generator=gen)
    if config == "filter":
        encoder = BackboneEncoder(net=net)
    else:
        encoder = RecurrentBackboneEncoder(net=net, rnn=LSTM(
            NUM_CHANNELS, NUM_CHANNELS, 1, dtype, generator=gen))
    actor = DictActor({"move": DenseLayerDiscreteActor(
        actions["move"], NUM_CHANNELS, dtype, generator=gen)})
    ac = ActorCritic(
        backbone=BackboneShared(
            prefix=lambda obs: torch.cat([obs["delta"], obs["time"]], -1),
            encoder=encoder),
        actor=actor, critic=critic())
    policy = mlt.Policy(
        actor_critic=ac,
        obs_preprocess=mlt.ObservationsEMANormalizer.create(
            decay=0.99999, dtype=dtype))
    cfg = mlt.TrainConfig(
        num_worlds=num_worlds, num_agents_per_world=1, actions=actions,
        steps_per_update=EPISODE_LEN, num_bptt_chunks=2, lr=LR,
        gamma=0.99, gae_lambda=0.95, seed=seed, metrics_buffer_size=1,
        algo=mlt.PPOConfig(
            num_epochs=2, minibatch_size=num_worlds // 2, clip_coef=0.2,
            value_loss_coef=0.5, entropy_coef=0.01, max_grad_norm=0.5),
        dreamer_v3_critic=config == "dreamer",
        hlgauss_critic=config.startswith("hlgauss"),
        normalize_values=config == "valuenorm",
        filter_advantages=config == "filter",
        # 2 x minibatch_size sampled sequences of 2 x num_worlds.
        importance_sample_trajectories=config == "importance",
        importance_sample_num_minibatches=2 if config == "importance" else 0)
    sim_fns = make_toy_env(ToyEnvConfig(
        num_worlds=num_worlds, episode_len=EPISODE_LEN, grid_size=GRID,
        seed=seed), device="cpu")
    mgr = mlt.init_training("cpu", cfg, sim_fns, policy,
                            torch.zeros((1,), dtype=torch.int32))
    curve = []
    for _ in range(num_updates):
        mgr.update_iter()
        curve.append(float(np.nanmean(
            mgr.metrics.latest("Rewards").mean.numpy().astype(np.float64))))
    return curve


def compare(config: str, curves, reference) -> dict:
    """The parity rule of scripts/parity_curves.py, the JAX package's
    recorded result in the reference's place."""
    curves = np.asarray(curves)  # [seeds, updates]
    updates = curves.shape[1]
    q = max(1, updates // 4)
    final = curves[:, -q:].mean(axis=1)
    jax_mean = reference["ours_final_mean"]
    jax_std = reference["ours_final_std"]
    jax_first = reference["ours_curve_mean"][0]
    spread = max(jax_std, final.std(), 1e-3)
    gap = abs(jax_mean - final.mean())
    ok = bool(gap < 3 * spread
              and jax_mean > 3 * abs(jax_first)
              and final.mean() > 3 * abs(curves[:, 0].mean()))
    return {
        "config": config,
        "jax_final_mean": jax_mean,
        "jax_final_std": jax_std,
        "torch_final_mean": float(final.mean()),
        "torch_final_std": float(final.std()),
        "torch_final_by_seed": final.tolist(),
        "gap": float(gap),
        "spread": float(spread),
        "within_seed_variance": ok,
        "updates": updates,
        "worlds": reference["worlds"],
        "seeds": int(curves.shape[0]),
        "torch_curve_mean": curves.mean(axis=0).tolist(),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", choices=CONFIGS, action="append",
                        help="configurations to run (default: all)")
    parser.add_argument("--updates", type=int, default=150)
    parser.add_argument("--worlds", type=int, default=256)
    parser.add_argument("--seeds", type=int, default=3)
    parser.add_argument("--workers", type=int, default=4,
                        help="processes running seeds and configurations")
    parser.add_argument("--reference",
                        default=os.path.join(ROOT, "PARITY_CURVES.json"))
    parser.add_argument("--json",
                        default=os.path.join(ROOT, "PARITY_CURVES_TORCH.json"))
    args = parser.parse_args(argv)
    configs = args.config or list(CONFIGS)
    with open(args.reference) as f:
        reference = json.load(f)

    t0 = time.perf_counter()
    jobs = [(c, s) for c in configs for s in range(args.seeds)]
    with ProcessPoolExecutor(
            max_workers=args.workers,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = {job: pool.submit(run_port, *job, args.updates,
                                    args.worlds) for job in jobs}
        curves = {job: f.result() for job, f in futures.items()}

    results = {}
    if os.path.exists(args.json):
        with open(args.json) as f:
            results = json.load(f)
    for config in configs:
        r = compare(config, [curves[(config, s)]
                             for s in range(args.seeds)], reference[config])
        results[config] = r
        print(f"{config}: final-quartile mean reward torch "
              f"{r['torch_final_mean']:.5f} +- {r['torch_final_std']:.5f}, "
              f"JAX {r['jax_final_mean']:.5f} +- {r['jax_final_std']:.5f}, "
              f"gap {r['gap']:.5f} (3 x spread {3 * r['spread']:.5f}): "
              f"{'PARITY OK' if r['within_seed_variance'] else 'PARITY FAIL'}",
              flush=True)
    print(f"{len(jobs)} runs of {args.updates} updates in "
          f"{time.perf_counter() - t0:.0f} s")
    with open(args.json, "w") as f:
        json.dump(results, f, indent=1)
    return 0 if all(results[c]["within_seed_variance"] for c in configs) else 1


if __name__ == "__main__":
    raise SystemExit(main())
