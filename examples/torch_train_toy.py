"""Single-policy PPO on the toy gridworld with the PyTorch port.

Run: python examples/torch_train_toy.py [--num-updates N] [--native-sim]
     [--ckpt-dir DIR] [--tb-dir DIR] [--device cuda|cpu]

The port of ``examples/train_toy.py``: an MLP 2 x 256 + LSTM 256 actor
with the DreamerV3 two-hot critic, bf16 on the card (its LSTM kernels
there) and float32 on the CPU.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import madrona_learn_tpu_torch as mlt  # noqa: E402
from madrona_learn_tpu_torch.envs import (  # noqa: E402
    ToyEnvConfig, make_toy_env)
from madrona_learn_tpu_torch.models import (  # noqa: E402
    LSTM, MLP, ActorCritic, BackboneShared, DenseLayerDiscreteActor,
    DictActor, DreamerV3Critic, RecurrentBackboneEncoder)


def build_policy(actions, dtype, seed=0):
    """The example's policy: its MLP + LSTM actor-critic and EMA obs
    normalizer."""
    gen = torch.Generator().manual_seed(seed)
    actor_critic = ActorCritic(
        backbone=BackboneShared(
            prefix=lambda obs: torch.cat([obs["delta"], obs["time"]], -1),
            encoder=RecurrentBackboneEncoder(
                net=MLP(3, 256, 2, dtype, generator=gen),
                rnn=LSTM(256, 256, 1, dtype, generator=gen))),
        actor=DictActor({"move": DenseLayerDiscreteActor(
            actions["move"], 256, dtype, generator=gen)}),
        critic=DreamerV3Critic(256, dtype))
    return mlt.Policy(
        actor_critic=actor_critic,
        obs_preprocess=mlt.ObservationsEMANormalizer.create(
            decay=0.99999, dtype=dtype))


def compute_dtype(device):
    return torch.bfloat16 if torch.device(device).type == "cuda" \
        else torch.float32


def make_env(num_worlds, native_sim, device, seed=0):
    if native_sim:
        from madrona_learn_tpu_torch.envs.native_sim import (
            NativeSimConfig, make_native_sim)

        return make_native_sim(NativeSimConfig(
            num_worlds=num_worlds, episode_len=40, grid_size=8, seed=seed),
            device=device)
    return make_toy_env(ToyEnvConfig(
        num_worlds=num_worlds, episode_len=40, grid_size=8, seed=seed),
        device=device)


def train_config(actions, num_worlds, dtype):
    return mlt.TrainConfig(
        num_worlds=num_worlds,
        num_agents_per_world=1,
        actions=actions,
        steps_per_update=40,
        num_bptt_chunks=2,
        lr=1e-3,
        gamma=0.99,
        gae_lambda=0.95,
        seed=0,
        metrics_buffer_size=10,
        algo=mlt.PPOConfig(
            num_epochs=2,
            minibatch_size=(2 * num_worlds) // 2,
            clip_coef=0.2,
            value_loss_coef=0.5,
            entropy_coef=0.01,
            max_grad_norm=0.5,
        ),
        dreamer_v3_critic=True,
        compute_dtype=dtype,
    )


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--num-updates", type=int, default=50)
    parser.add_argument("--num-worlds", type=int, default=1024)
    parser.add_argument("--native-sim", action="store_true")
    parser.add_argument("--ckpt-dir", type=str, default=None)
    parser.add_argument("--tb-dir", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    dtype = compute_dtype(args.device)
    actions = {"move": mlt.DiscreteActionsConfig(actions_num_buckets=[5])}
    sim_fns = make_env(args.num_worlds, args.native_sim, args.device)
    policy = build_policy(actions, dtype)
    cfg = train_config(actions, args.num_worlds, dtype)

    mgr = mlt.init_training(
        args.device, cfg, sim_fns, policy,
        init_sim_ctrl=torch.zeros((1,), dtype=torch.int32))
    tb_writer = mlt.TensorboardWriter(args.tb_dir) if args.tb_dir else None

    start = time.perf_counter()
    for i in range(args.num_updates):
        mgr.update_iter()
        if (i + 1) % 10 == 0 or i + 1 == args.num_updates:
            reward = mgr.metrics.latest("Rewards").mean[0]
            print(f"update {i + 1}: mean reward {float(reward):.3f}")
            if tb_writer is not None:
                mgr.log_metrics_tensorboard(tb_writer)

    if mgr.rollout.sim_ctrl.is_cuda:
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    steps = args.num_worlds * cfg.steps_per_update * args.num_updates
    print(f"{steps / elapsed:,.0f} env-steps/s on {args.device}")

    if args.ckpt_dir:
        mgr.save_ckpt(args.ckpt_dir)
        print(f"saved checkpoint to {args.ckpt_dir}")
    return mgr


if __name__ == "__main__":
    main()
