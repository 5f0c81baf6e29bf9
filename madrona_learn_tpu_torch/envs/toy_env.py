"""The toy environments (JAX: madrona_learn_tpu/envs/toy_env.py).

``make_toy_env``, the target-chasing gridworld: obs are the egocentric delta to a target and the
episode's time fraction; the 5 discrete actions move the agent; the reward
is the decrease in L1 distance plus 1 for sitting on the target. Finished
agents respawn at positions drawn by a stateless hash of (row id, tick), the
JAX package's uint32 hash evaluated in int64 masked to 32 bits. The start
state is drawn from a ``torch.Generator`` seeded with ``cfg.seed``; it
cannot match ``jax.random``, so parity tests inject the JAX start state.

``make_duel_env``, the two-team bidding duel of the PBT path: every agent
bids its discrete action each step, and at the episode's end the team with
the higher summed bids wins (+1 / -1, 0 for a draw); ``episode_results``
name the winning team of each world (-1 for a draw).

The gridworld has the simulator-state snapshot hooks ``get_ckpts`` /
``load_ckpts`` (``envs/sim_interface.py``); the duel, as in the JAX
package, has none.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

_MASK32 = 0xFFFFFFFF
_MOVES = ((0, 0), (0, 1), (0, -1), (1, 0), (-1, 0))
_SALTS_POS = (0x27D4EB2F, 0x165667B1)
_SALTS_TGT = (0x85EBCA77, 0xC2B2AE3D)


@dataclass(frozen=True)
class ToyEnvConfig:
    num_worlds: int
    episode_len: int = 40
    grid_size: int = 8
    num_teams: int = 1
    team_size: int = 1
    seed: int = 0

    @property
    def agents_per_world(self) -> int:
        return self.num_teams * self.team_size

    @property
    def batch_size(self) -> int:
        return self.num_worlds * self.agents_per_world


def _hash_draw2(base, salts, grid_size):
    """Two per-row ints in [0, grid) from base [B, 1] (uint32 semantics)."""
    h = base ^ salts
    h = h ^ (h >> 15)
    h = (h * 0x2C1B3C6D) & _MASK32
    h = h ^ (h >> 13)
    return (((h >> 16) * grid_size) >> 16).to(torch.int32)


def make_toy_env(cfg: ToyEnvConfig, device="cuda"):
    """``sim_fns`` for the gridworld, with every tensor on ``device`` (the
    CUDA card unless the caller asks for another)."""
    if cfg.agents_per_world != 1:
        raise ValueError("the gridworld has one agent a world")
    B = cfg.batch_size
    moves = torch.tensor(_MOVES, dtype=torch.int32, device=device)
    salts_pos = torch.tensor([_SALTS_POS], dtype=torch.int64, device=device)
    salts_tgt = torch.tensor([_SALTS_TGT], dtype=torch.int64, device=device)

    def _obs(pos, target, t):
        return {
            "delta": (target - pos).to(torch.float32) / cfg.grid_size,
            "time": t.to(torch.float32) / cfg.episode_len,
        }

    def init_fn():
        gen = torch.Generator(device=device).manual_seed(cfg.seed)
        pos = torch.randint(0, cfg.grid_size, (B, 2), generator=gen,
                            dtype=torch.int32, device=device)
        target = torch.randint(0, cfg.grid_size, (B, 2), generator=gen,
                               dtype=torch.int32, device=device)
        t = torch.zeros((B, 1), dtype=torch.int32, device=device)
        rid = torch.arange(B, dtype=torch.int32, device=device)[:, None]
        tick = torch.zeros((B, 1), dtype=torch.int32, device=device)
        state = {"pos": pos, "target": target, "t": t,
                 "rid": rid, "tick": tick}
        return {"state": state, "obs": _obs(pos, target, t)}

    def step_fn(step_input):
        state = step_input["state"]
        action = step_input["actions"]["move"][..., 0].long()  # [B]
        resets = step_input["resets"]  # [num_worlds, 1]
        pos, target, t = state["pos"], state["target"], state["t"]
        rid, tick = state["rid"], state["tick"]

        old_dist = (target - pos).abs().sum(dim=-1, keepdim=True)
        new_pos = torch.clamp(pos + moves[action], 0, cfg.grid_size - 1)
        new_dist = (target - new_pos).abs().sum(dim=-1, keepdim=True)
        on_target = new_dist == 0
        reward = ((old_dist - new_dist).to(torch.float32)
                  + on_target.to(torch.float32))

        t = t + 1
        tick = tick + 1
        dones = (t >= cfg.episode_len) | resets.to(torch.bool)

        base = (cfg.seed
                ^ ((rid.long() * 0x9E3779B1) & _MASK32)
                ^ ((tick.long() * 0x85EBCA77) & _MASK32))
        respawn_pos = _hash_draw2(base, salts_pos, cfg.grid_size)
        respawn_tgt = _hash_draw2(base, salts_tgt, cfg.grid_size)

        pos = torch.where(dones, respawn_pos, new_pos)
        target = torch.where(dones, respawn_tgt, target)
        t = torch.where(dones, 0, t)
        new_state = {"pos": pos, "target": target, "t": t,
                     "rid": rid, "tick": tick}
        return {"state": new_state, "obs": _obs(pos, target, t),
                "rewards": reward, "dones": dones}

    # Snapshots: int32 rows [pos, target, t]. Loading restarts the row ids
    # at arange(n) and the tick at 0 as the JAX package does, so respawns
    # after a restore differ from the uninterrupted run's.
    def get_ckpts_fn(sim_state):
        return torch.cat([sim_state["pos"], sim_state["target"],
                          sim_state["t"]], dim=-1).to(torch.int32)

    def load_ckpts_fn(trigger, ckpts):
        pos, target, t = ckpts[:, 0:2], ckpts[:, 2:4], ckpts[:, 4:5]
        n = ckpts.shape[0]
        state = {"pos": pos, "target": target, "t": t,
                 "rid": torch.arange(n, dtype=torch.int32,
                                     device=ckpts.device)[:, None],
                 "tick": torch.zeros((n, 1), dtype=torch.int32,
                                     device=ckpts.device)}
        return {"state": state, "obs": _obs(pos, target, t)}

    return {"init": init_fn, "step": step_fn, "get_ckpts": get_ckpts_fn,
            "load_ckpts": load_ckpts_fn}


def make_duel_env(cfg: ToyEnvConfig, device="cuda"):
    """``sim_fns`` for the bidding duel, with every tensor on ``device``
    (the CUDA card unless the caller asks for another)."""
    if cfg.num_teams != 2:
        raise ValueError(f"the duel needs 2 teams, not {cfg.num_teams}")
    B, A = cfg.batch_size, cfg.agents_per_world
    win = torch.tensor([[1.0, -1.0]], device=device)

    def _obs(t, acc):
        return {"time": t.to(torch.float32) / cfg.episode_len,
                "acc": acc.to(torch.float32) / (cfg.episode_len * 4)}

    def init_fn():
        t = torch.zeros((B, 1), dtype=torch.int32, device=device)
        acc = torch.zeros((B, 1), dtype=torch.int32, device=device)
        return {"state": {"t": t, "acc": acc}, "obs": _obs(t, acc)}

    def step_fn(step_input):
        state = step_input["state"]
        action = step_input["actions"]["move"][..., 0:1]  # [B, 1], 0..4
        resets = step_input["resets"]  # [num_worlds, 1]

        acc = state["acc"] + action
        t = state["t"] + 1
        episode_over = t >= cfg.episode_len
        dones = episode_over | torch.repeat_interleave(
            resets, A, dim=0).to(torch.bool)

        team_sums = acc.reshape(-1, cfg.num_teams, cfg.team_size).sum(-1)
        team0_wins = team_sums[:, 0] > team_sums[:, 1]
        draw = team_sums[:, 0] == team_sums[:, 1]
        team_reward = torch.where(
            draw[:, None], 0.0, torch.where(team0_wins[:, None], win, -win))
        agent_reward = torch.repeat_interleave(
            team_reward.reshape(-1, 1), cfg.team_size, dim=0)
        reward = torch.where(episode_over, agent_reward, 0.0)
        episode_results = torch.where(
            draw, -1, torch.where(team0_wins, 0, 1)).to(torch.int32)[:, None]

        t = torch.where(dones, 0, t)
        acc = torch.where(dones, 0, acc)
        return {"state": {"t": t, "acc": acc}, "obs": _obs(t, acc),
                "rewards": reward, "dones": dones,
                "pbt": {"episode_results": episode_results}}

    return {"init": init_fn, "step": step_fn}
