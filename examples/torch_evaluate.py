"""Offline policy evaluation from a checkpoint of the PyTorch port.

Trains a short toy run if no checkpoint is given, then loads the policies
back with ``eval_load_ckpt`` and rolls them out with ``eval_policies``,
handing every step's data to a host callback that sums episode returns.

Run:
    python examples/torch_evaluate.py [--ckpt ckpts/50] [--num-worlds 256]
        [--eval-steps 200] [--policy N] [--device cuda|cpu]

The port of ``examples/evaluate.py``; the JAX version's ordered
``io_callback`` is a plain host callback here.
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import madrona_learn_tpu_torch as mlt  # noqa: E402
from madrona_learn_tpu_torch.envs import (  # noqa: E402
    ToyEnvConfig, make_toy_env)
from torch_train_toy import (  # noqa: E402
    build_policy, compute_dtype, train_config)


def quick_train(actions, policy, num_worlds, dtype, ckpt_dir, device):
    sim_fns = make_toy_env(ToyEnvConfig(
        num_worlds=num_worlds, episode_len=40, grid_size=8), device=device)
    cfg = train_config(actions, num_worlds, dtype)
    mgr = mlt.init_training(device, cfg, sim_fns, policy,
                            init_sim_ctrl=torch.zeros((1,), dtype=torch.int32))
    for _ in range(30):
        mgr.update_iter()
    mgr.save_ckpt(ckpt_dir)
    return os.path.join(ckpt_dir, str(mgr.update_idx))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--ckpt", type=str, default=None)
    parser.add_argument("--num-worlds", type=int, default=256)
    parser.add_argument("--eval-steps", type=int, default=200)
    parser.add_argument("--policy", type=int, default=None,
                        help="evaluate a single policy index")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    dtype = compute_dtype(args.device)
    actions = {"move": mlt.DiscreteActionsConfig(actions_num_buckets=[5])}
    policy = build_policy(actions, dtype)

    ckpt = args.ckpt
    if ckpt is None:
        ckpt_dir = tempfile.mkdtemp(prefix="eval_example_")
        print(f"no --ckpt given; training 30 quick updates -> {ckpt_dir}")
        ckpt = quick_train(actions, policy, args.num_worlds, dtype, ckpt_dir,
                           args.device)

    policy_states, num_policies = mlt.eval_load_ckpt(
        policy, ckpt, single_policy=args.policy)
    print(f"loaded {num_policies} policies from {ckpt}")

    eval_cfg = mlt.EvalConfig(
        num_worlds=args.num_worlds,
        num_teams=1,
        team_size=1,
        num_eval_steps=args.eval_steps,
        actions=actions,
        reward_gamma=0.99,
        policy_dtype=dtype,
        eval_competitive=False,
        use_deterministic_policy=True,
    )
    sim_fns = make_toy_env(ToyEnvConfig(
        num_worlds=args.num_worlds, episode_len=40, grid_size=8, seed=17),
        device=args.device)

    totals = {"reward_sum": 0.0, "episodes": 0, "return_sum": 0.0}

    def step_cb(step_data):
        # Runs on the host after every step; reading the tensors waits for
        # the step.
        rewards = step_data["rewards"].float()
        dones = step_data["dones"].reshape(-1).bool()
        returns = step_data["returns"].float().reshape(-1)
        totals["reward_sum"] += float(rewards.sum())
        totals["episodes"] += int(dones.sum())
        totals["return_sum"] += float(returns[dones].sum())
        return step_data["sim_state"]

    mlt.eval_policies(
        args.device, eval_cfg, sim_fns, policy,
        torch.zeros((1,), dtype=torch.int32), policy_states, step_cb)

    steps = args.eval_steps * args.num_worlds
    print(f"eval: {steps} agent-steps, "
          f"mean step reward {totals['reward_sum'] / steps:.4f}, "
          f"{totals['episodes']} episodes"
          + (f", mean episode return "
             f"{totals['return_sum'] / totals['episodes']:.3f}"
             if totals["episodes"] else ""))
    return totals


if __name__ == "__main__":
    main()
