"""The target-chasing gridworld (JAX: madrona_learn_tpu/envs/toy_env.py).

Single-team variant: obs are the egocentric delta to a target and the
episode's time fraction; the 5 discrete actions move the agent; the reward
is the decrease in L1 distance plus 1 for sitting on the target. Finished
agents respawn at positions drawn by a stateless hash of (row id, tick), the
JAX package's uint32 hash evaluated in int64 masked to 32 bits. The start
state is drawn from a ``torch.Generator`` seeded with ``cfg.seed``; it
cannot match ``jax.random``, so parity tests inject the JAX start state.
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
    seed: int = 0

    @property
    def batch_size(self) -> int:
        return self.num_worlds


def _hash_draw2(base, salts, grid_size):
    """Two per-row ints in [0, grid) from base [B, 1] (uint32 semantics)."""
    h = base ^ salts
    h = h ^ (h >> 15)
    h = (h * 0x2C1B3C6D) & _MASK32
    h = h ^ (h >> 13)
    return (((h >> 16) * grid_size) >> 16).to(torch.int32)


def make_toy_env(cfg: ToyEnvConfig, device=None):
    """``sim_fns`` for the gridworld, with every tensor on ``device``."""
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

    return {"init": init_fn, "step": step_fn}
