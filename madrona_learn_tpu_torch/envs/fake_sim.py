"""Integer-exact fake simulator and fake policy (JAX:
madrona_learn_tpu/envs/fake_sim.py).

Every quantity is int32 and exactly predictable: the "network" is an
integer recurrence whose one parameter, ``bias``, is set to the policy
index, so collected actions, values, rewards and recurrent states can be
recomputed by a closed-form oracle and checked bit-exactly, including that
policy assignments stay constant within an episode.

Fake dynamics:
- obs ``o``: starts at a random int, becomes ``action0 + 1`` each step.
- obs ``c``: the agent's episode step counter, echoed through the action so
  the sim can advance it.
- reward: ``action0 + 2``.
- done: when the counter wraps at ``episode_len``.

The start obs come from a ``torch.Generator`` seeded with ``obs_seed``;
they cannot match ``jax.random``'s, and the oracle reads them back.

The fake modules have policy-batched forms (``chunked``,
``models/common.py``), so a population of them takes the rollout's
policy-chunk layout: ``FakeNet`` reads each chunk's bias from the stacked
population, the others have no parameters.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

_I32 = torch.int32


@dataclass(frozen=True)
class FakeSimConfig:
    batch_size: int
    episode_len: int
    num_teams: int = 1
    team_size: int = 1
    obs_seed: int = 5

    @property
    def agents_per_world(self) -> int:
        return self.num_teams * self.team_size

    @property
    def num_worlds(self) -> int:
        return self.batch_size // self.agents_per_world


def make_fake_sim(cfg: FakeSimConfig, device="cuda"):
    """``sim_fns`` of the fake dynamics, with every tensor on ``device``
    (the CUDA card unless the caller asks for another)."""

    def init_fn():
        gen = torch.Generator(device=device).manual_seed(cfg.obs_seed)
        obs = {
            "o": torch.randint(0, 10000, (cfg.batch_size, 1), generator=gen,
                               dtype=_I32, device=device),
            "c": torch.zeros((cfg.batch_size, 1), dtype=_I32, device=device),
        }
        return {"state": {}, "obs": obs}

    def step_fn(step_input):
        actions = step_input["actions"]["fake"]
        resets = step_input["resets"]  # [num_worlds, 1]
        agent_resets = torch.repeat_interleave(
            resets, cfg.agents_per_world, dim=0).to(torch.bool)

        counter = actions[..., 2:3] + 1
        dones = counter == cfg.episode_len
        counter = counter % cfg.episode_len
        dones = dones | agent_resets
        counter = torch.where(agent_resets, 0, counter)

        # Team 0 wins every match: enough to drive the results plumbing.
        num_worlds = actions.shape[0] // cfg.agents_per_world
        return {
            "state": {},
            "obs": {"o": actions[..., 0:1] + 1, "c": counter},
            "rewards": actions[..., 0:1] + 2,
            "dones": dones,
            "pbt": {"episode_results": torch.zeros(
                (num_worlds, 1), dtype=_I32, device=actions.device)},
        }

    return {"init": init_fn, "step": step_fn}


class FakeActionDist:
    """Deterministic pass-through distribution of the fake policy."""

    def __init__(self, action):
        self.action = action

    def best(self):
        return self.action

    def sample(self, generator):
        return self.action, self.action

    def action_stats(self, actions):
        zeros = torch.zeros_like(actions)
        return zeros, zeros


class FakeNet(nn.Module):
    """Integer feature net: (o + bias, bias, counter). ``bias`` is the one
    parameter; tests set it to the policy index so actions name the
    policy that produced them."""

    def __init__(self):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros((), dtype=_I32),
                                 requires_grad=False)

    def forward(self, obs):
        return self._features(obs, self.bias)

    def chunked(self, params, layout, obs):
        return self._features(
            obs, params.per_chunk("bias", None, layout, obs["o"].dim()))

    @staticmethod
    def _features(obs, bias):
        inputs = obs["o"]
        return torch.cat([inputs + bias, bias.expand(inputs.shape),
                          obs["c"]], dim=-1)


class FakeRNN(nn.Module):
    """Integer recurrence: y = x0 + h; h' = h + 2 * x0."""

    def init_recurrent_state(self, N, device=None):
        return torch.zeros((N, 1), dtype=_I32, device=device)

    def clear_recurrent_state(self, rnn_states, should_clear):
        return torch.where(should_clear, 0, rnn_states)

    def forward(self, cur_hiddens, in_features):
        x0 = in_features[..., 0:1]
        new_hiddens = cur_hiddens + 2 * x0
        y = torch.cat([x0 + cur_hiddens, in_features[..., 1:3],
                       new_hiddens], dim=-1)
        return y, new_hiddens

    def chunked(self, params, layout, cur_hiddens, in_features):
        return self(cur_hiddens, in_features)

    def sequence(self, start_hiddens, seq_ends, seq_x):
        carry, outs = start_hiddens, []
        for x, end in zip(seq_x, seq_ends):
            y, carry = self(carry, x)
            outs.append(y)
            carry = self.clear_recurrent_state(carry, end)
        return torch.stack(outs)


class FakeActor(nn.Module):
    """Action = (rnn_out0, bias, counter): echoes what the sim needs."""

    def forward(self, features):
        return FakeActionDist(features[..., 0:3])

    def chunked(self, params, layout, features):
        return self(features)


class FakeCritic(nn.Module):
    """Value = the recurrent state (int32, exactly predictable)."""

    def forward(self, features):
        return features[..., 3:4]

    def chunked(self, params, layout, features):
        return self(features)
