"""ActorCritic and its backbone (JAX: models/actor_critic.py).

``ActorCritic`` exposes ``rollout`` (sample or argmax actions plus value),
``critic_only`` and ``update`` (sequence forward that scores stored
actions) over a backbone. The slice ports ``BackboneShared`` (one tower
feeds both heads) with a ``RecurrentBackboneEncoder`` tower (net -> rnn,
with a time-axis ``sequence`` path for BPTT). Recurrent-state init and
clear live on the modules so the rollout engine owns state placement. The
obs dict's leaves may carry entity axes ([N, E, F], [T, N, E, F] in the
update pass); the time axis is always the leading one. The critic returns a
tensor or, for the DreamerV3 critic, a distribution.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch import nn


def _merge_time(tree, T, N):
    """[T*N, ...] -> [T, N, ...] on every tensor of a dict."""
    return {k: v.reshape(T, N, *v.shape[1:]) for k, v in tree.items()}


def _drop_time(tree):
    """[T, N, ...] -> [T*N, ...] on every tensor of a dict."""
    return {k: v.reshape(-1, *v.shape[2:]) for k, v in tree.items()}


def _merge_time_critic(critic_out, T, N):
    """[T*N, ...] -> [T, N, ...] on a critic output: a tensor, or a
    distribution over its logits."""
    if isinstance(critic_out, torch.Tensor):
        return critic_out.reshape(T, N, *critic_out.shape[1:])
    return critic_out.merge_time(T, N)


class RecurrentBackboneEncoder(nn.Module):
    """net -> rnn tower with a sequence path for BPTT."""

    def __init__(self, net: nn.Module, rnn: nn.Module):
        super().__init__()
        self.net = net
        self.rnn = rnn

    def init_recurrent_state(self, N, device=None):
        return self.rnn.init_recurrent_state(N, device)

    def clear_recurrent_state(self, recurrent_states, should_clear):
        return self.rnn.clear_recurrent_state(recurrent_states, should_clear)

    def forward(self, rnn_states_in, inputs):
        return self.rnn(rnn_states_in, self.net(inputs))

    def sequence(self, rnn_start_states, sequence_ends, flattened_inputs):
        # The trunk runs over the flat [T*N] batch (one big product), then
        # reshapes to [T, N] for the recurrent pass.
        T, N = sequence_ends.shape[0:2]
        features = self.net(flattened_inputs)
        rnn_out = self.rnn.sequence(
            rnn_start_states, sequence_ends,
            features.reshape(T, N, *features.shape[1:]))
        return rnn_out.reshape(T * N, *rnn_out.shape[2:])


class BackboneShared(nn.Module):
    """One tower feeds both heads; ``prefix(obs)`` maps the obs dict to the
    tower's input tensor."""

    def __init__(self, prefix: Callable[[Dict[str, torch.Tensor]],
                                        torch.Tensor],
                 encoder: nn.Module):
        super().__init__()
        self.prefix = prefix
        self.encoder = encoder

    def init_recurrent_state(self, N, device=None):
        return self.encoder.init_recurrent_state(N, device)

    def clear_recurrent_state(self, recurrent_states, should_clear):
        return self.encoder.clear_recurrent_state(
            recurrent_states, should_clear)

    def forward(self, rnn_states_in, obs_in):
        feats, rnn_out = self.encoder(rnn_states_in, self.prefix(obs_in))
        return feats, feats, rnn_out

    def critic_only(self, rnn_states_in, obs_in):
        return self.encoder(rnn_states_in, self.prefix(obs_in))

    def sequence(self, rnn_start_states, sequence_ends, obs_in):
        feats = self.encoder.sequence(
            rnn_start_states, sequence_ends, self.prefix(_drop_time(obs_in)))
        return feats, feats


class ActorCritic(nn.Module):
    def __init__(self, backbone: nn.Module, actor: nn.Module,
                 critic: nn.Module):
        super().__init__()
        self.backbone = backbone
        self.actor = actor
        self.critic = critic

    def init_recurrent_state(self, N, device=None):
        return self.backbone.init_recurrent_state(N, device)

    def clear_recurrent_state(self, recurrent_states, should_clear):
        return self.backbone.clear_recurrent_state(
            recurrent_states, should_clear)

    def rollout(self, generator, rnn_states_in, obs_in,
                sample_actions=True):
        """One step: ({actions, log_probs, critic}, new recurrent state)."""
        actor_feats, critic_feats, rnn_out = self.backbone(
            rnn_states_in, obs_in)
        dists = self.actor(actor_feats)
        if sample_actions:
            actions, log_probs = dists.sample(generator)
            results = {"actions": actions, "log_probs": log_probs}
        else:
            results = {"actions": dists.best()}
        results["critic"] = self.critic(critic_feats)
        return results, rnn_out

    def critic_only(self, rnn_states_in, obs_in):
        feats, rnn_out = self.backbone.critic_only(rnn_states_in, obs_in)
        return {"critic": self.critic(feats)}, rnn_out

    def update(self, rnn_states, sequence_breaks, rollout_actions, obs):
        """Score stored [T, N] sequences: time-major log-probs and
        entropies of the taken actions, and fresh critic outputs."""
        T, N = sequence_breaks.shape[0:2]
        actor_feats, critic_feats = self.backbone.sequence(
            rnn_states, sequence_breaks, obs)
        dists = self.actor(actor_feats)
        log_probs, entropies = dists.action_stats(
            _drop_time(rollout_actions))
        return {
            "log_probs": _merge_time(log_probs, T, N),
            "entropies": _merge_time(entropies, T, N),
            "critic": _merge_time_critic(self.critic(critic_feats), T, N),
        }
