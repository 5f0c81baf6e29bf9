#!/usr/bin/env python3
r"""Population surgery over the PyTorch port's checkpoints.

    python3 scripts/torch_population_surgery.py inspect CKPT
    python3 scripts/torch_population_surgery.py slice SRC DST \
        --train 0,3 --past 1
    python3 scripts/torch_population_surgery.py best SRC DST \
        [--metric elo|score]

The subcommands of ``scripts/population_surgery.py``, over checkpoint
files that ``TrainingManager.save_ckpt`` of ``madrona_learn_tpu_torch``
wrote (or that ``scripts/torch_import_jax_checkpoint.py`` carried over):

- ``inspect``: the population's sizes, its fitness (Elo or episode
  score), the parameters a policy, the next update index and the train
  policies' hyperparameters;
- ``slice``: a new train / past split (``TrainStateManager
  .slice_checkpoint``);
- ``best``: a checkpoint of the fittest train policy alone.

It reads the files on the CPU (``TrainStateManager.restore_host``) and
needs no card.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402


def _load(path):
    from madrona_learn_tpu_torch.train_state import TrainStateManager

    return TrainStateManager.restore_host(path)


def _fitness(ckpt):
    """(Elo [P] or None, episode score (mean [P], N [P]) or None)."""
    population = ckpt["population"] or {}
    mmr, score = population.get("mmr"), population.get("episode_score")
    elo = None if mmr is None else np.asarray(mmr["elo"], np.float64)
    if score is not None:
        score = (np.asarray(score["mean"], np.float64),
                 np.asarray(score["N"]))
    return elo, score


def cmd_inspect(args):
    ckpt = _load(args.ckpt)
    total = len(ckpt["policy_states"])
    num_train = len(ckpt["train_states"])
    tensors = list(ckpt["policy_states"][0]["actor_critic"].values())
    n_params = sum(int(t.numel()) for t in tensors)

    print(f"checkpoint: {args.ckpt}")
    print(f"next_update: {int(ckpt['next_update'])}")
    print(f"policies: {total} total = {num_train} train"
          f" + {total - num_train} past")
    print(f"params/policy: {n_params:,} across {len(tensors)} tensors")

    elo, score = _fitness(ckpt)
    if elo is not None:
        print("elo (desc): " + ", ".join(
            f"p{i}={elo[i]:.1f}" for i in np.argsort(-elo)))
    if score is not None:
        mean, n = score
        print("episode score: " + ", ".join(
            f"p{i}={mean[i]:.3f}(n={int(n[i])})" for i in range(len(mean))))

    for name in ckpt["train_states"][0]["hyper_params"]:
        values = [ts["hyper_params"][name] for ts in ckpt["train_states"]]
        if values[0] is not None:
            print(f"hyperparam {name}: "
                  + ", ".join(f"{float(v):.3e}" for v in values))


def _parse_ids(spec):
    return [int(x) for x in spec.split(",") if x != ""]


def cmd_slice(args):
    from madrona_learn_tpu_torch.train_state import TrainStateManager

    train_sel = _parse_ids(args.train)
    past_sel = _parse_ids(args.past)
    TrainStateManager.slice_checkpoint(args.src, args.dst,
                                       train_select=train_sel,
                                       past_select=past_sel)
    print(f"sliced {args.src} -> {args.dst}: train={train_sel} "
          f"past={past_sel}")


def cmd_best(args):
    from madrona_learn_tpu_torch.train_state import TrainStateManager

    ckpt = _load(args.src)
    num_train = len(ckpt["train_states"])
    elo, score = _fitness(ckpt)
    if args.metric == "elo" and elo is None:
        raise SystemExit("checkpoint has no Elo fitness (--metric elo)")
    if args.metric == "score" and score is None:
        raise SystemExit(
            "checkpoint has no episode-score fitness (--metric score)")
    if args.metric == "elo" or (args.metric == "auto" and elo is not None):
        fitness = elo[:num_train]
    elif score is not None:
        fitness = score[0][:num_train]
    else:
        raise SystemExit("checkpoint has no Elo or episode-score fitness")

    best = int(np.argmax(fitness))
    TrainStateManager.slice_checkpoint(args.src, args.dst,
                                       train_select=[best], past_select=[])
    print(f"best train policy: p{best} (fitness {fitness[best]:.3f}) "
          f"-> {args.dst}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("inspect")
    p.add_argument("ckpt")
    p.set_defaults(fn=cmd_inspect)

    p = sub.add_parser("slice")
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--train", required=True,
                   help="comma-separated train policy ids to keep")
    p.add_argument("--past", default="",
                   help="comma-separated policy ids for the new past set")
    p.set_defaults(fn=cmd_slice)

    p = sub.add_parser("best")
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--metric", choices=["auto", "elo", "score"],
                   default="auto")
    p.set_defaults(fn=cmd_best)

    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
