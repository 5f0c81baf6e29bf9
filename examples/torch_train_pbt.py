"""PBT self-play on the competitive duel with the PyTorch port: a
population of policies with hyperparameter exploration, periodic Elo
tournaments, and cull / past-snapshot population updates.

Run: python examples/torch_train_pbt.py [--num-updates N] [--num-worlds W]
     [--eval-interval K] [--device cuda|cpu]

The port of ``examples/train_pbt.py``. The JAX version warms the
tournament's compile up on a thread (``eval_elo_warmup``); the port has
nothing to compile.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import madrona_learn_tpu_torch as mlt  # noqa: E402
from madrona_learn_tpu_torch.envs import (  # noqa: E402
    ToyEnvConfig, make_duel_env)
from madrona_learn_tpu_torch.models import (  # noqa: E402
    MLP, ActorCritic, BackboneEncoder, BackboneShared, DenseLayerCritic,
    DenseLayerDiscreteActor, DictActor)

ACTIONS = {"move": mlt.DiscreteActionsConfig(actions_num_buckets=[5])}


def get_episode_scores(episode_result):
    winner = episode_result[0]
    a = torch.where(winner == 0, 1.0, torch.where(winner == 1, 0.0, 0.5))
    return a, 1.0 - a


def actor_critic(seed):
    """Train policy ``seed``'s module: an MLP 2 x 64 over the duel's
    time and bid total, float32."""
    dtype = torch.float32
    gen = torch.Generator().manual_seed(seed)
    return ActorCritic(
        backbone=BackboneShared(
            prefix=lambda obs: torch.cat([obs["time"], obs["acc"]], -1),
            encoder=BackboneEncoder(net=MLP(2, 64, 2, dtype, generator=gen))),
        actor=DictActor({"move": DenseLayerDiscreteActor(
            ACTIONS["move"], 64, dtype, generator=gen)}),
        critic=DenseLayerCritic(64, dtype, generator=gen))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--num-updates", type=int, default=40)
    parser.add_argument("--num-worlds", type=int, default=256)
    parser.add_argument("--eval-interval", type=int, default=10)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    num_train, num_past = 4, 2
    episode_len = 16

    sim_fns = make_duel_env(ToyEnvConfig(
        num_worlds=args.num_worlds, episode_len=episode_len,
        num_teams=2, team_size=1), device=args.device)
    policy = mlt.Policy(
        actor_critic=actor_critic,
        obs_preprocess=mlt.ObservationsCaster.create(dtype=torch.float32),
        get_episode_scores=get_episode_scores,
    )

    cfg = mlt.TrainConfig(
        num_worlds=args.num_worlds,
        num_agents_per_world=2,
        actions=ACTIONS,
        steps_per_update=32,
        num_bptt_chunks=2,
        lr=mlt.ParamExplore(base=1e-3, min_scale=0.1, max_scale=10.0,
                            log10_scale=True),
        gamma=0.99,
        gae_lambda=0.95,
        seed=0,
        metrics_buffer_size=10,
        algo=mlt.PPOConfig(
            num_epochs=1,
            # sequences/policy = num_bptt_chunks * train-agents/policy;
            # train agents = self + cross/2 + past/2 of the sim batch.
            minibatch_size=(2 * int(args.num_worlds * 2 * 0.625)
                            // num_train) // 2,
            clip_coef=0.2,
            value_loss_coef=0.5,
            entropy_coef=0.01,
            max_grad_norm=0.5,
        ),
        pbt=mlt.PBTConfig(
            num_teams=2,
            team_size=1,
            num_train_policies=num_train,
            num_past_policies=num_past,
            self_play_portion=0.25,
            cross_play_portion=0.5,
            past_play_portion=0.25,
        ),
        dreamer_v3_critic=False,
        compute_advantages=True,
    )

    zeros = torch.zeros((1,), dtype=torch.int32, device=args.device)
    mgr = mlt.init_training(args.device, cfg, sim_fns, policy,
                            init_sim_ctrl=zeros)

    for i in range(args.num_updates):
        mgr.update_iter()
        if (i + 1) % args.eval_interval == 0:
            # pair_offset sweeps the all-pairs coverage across cycles when
            # the batch underfills the pairing list.
            mgr, _ = mlt.eval_elo(
                mgr, num_eval_steps=4 * episode_len, eval_sim_ctrl=zeros,
                train_sim_ctrl=zeros,
                pair_offset=(i + 1) // args.eval_interval)
            mlt.update_population(mgr)
            elos = mgr.state.policy_states.mmr.elo.tolist()
            lr = float(mgr.state.train_states[0].hyper_params.lr)
            print(f"update {i + 1}: elos={[round(e, 1) for e in elos]} "
                  f"lrs={lr:.2e}...")

    print("done")
    return mgr


if __name__ == "__main__":
    main()
