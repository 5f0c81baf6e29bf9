"""ActorCritic and its backbones (JAX: models/actor_critic.py).

``ActorCritic`` exposes ``rollout`` (sample or argmax actions plus value),
``actor_only`` (argmax actions), ``critic_only`` and ``update`` (sequence
forward that scores stored actions) over a ``Backbone``: ``BackboneShared``
(one tower feeds both heads) or ``BackboneSeparate`` (an actor tower and a
critic tower over one prefix, recurrent state ``(actor_state,
critic_state)``). A tower is a ``RecurrentBackboneEncoder`` (net -> rnn,
with a time-axis ``sequence`` path for BPTT; the rnn an ``LSTM``, ``GRU``
or ``WindowAttentionMemory``) or a feed-forward ``BackboneEncoder``, whose
recurrent state is the empty tuple. Recurrent-state init and clear live on
the modules so the rollout engine owns state placement; a state is a
tensor or a tuple of them, nested, of any dtype. ``rollout_chunked`` and
``critic_only_chunked`` are the policy-batched forms of ``rollout`` and
``critic_only`` over a population's chunks (``models/common.py``), for
``BackboneShared`` and ``BackboneSeparate`` over ``BackboneEncoder`` or
``RecurrentBackboneEncoder`` towers (the fused step too).
``update_batched`` is the policy-batched form of ``update`` over the train
policies' minibatches (``models/common.py``), for the same backbones,
without trunk rematerialization. A prefix maps the obs dict to a tensor or
to a dict (the entity net's sets), which the towers hand to their net as
it is. The obs dict's leaves may carry entity axes ([N, E, F], [T, N, E,
F] in the update pass); the time axis is always the leading one. The
critic returns a tensor or, for the DreamerV3 critic, a distribution.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.utils.checkpoint
from torch import nn

from ..ops.cuda.policy_step import (fused_policy_step,
                                    fused_policy_step_chunked,
                                    policy_step_supported)
from ..ops.dists import critic_parts
from ..utils import tree_map
from ..utils.profile import profile


def _merge_time(tree, *lead):
    """[T*N, ...] -> [T, N, ...] (or [P*T*N, ...] -> [P, T, N, ...]) on
    every tensor of a dict."""
    return {k: v.reshape(*lead, *v.shape[1:]) for k, v in tree.items()}


def _drop_time(tree):
    """[T, N, ...] -> [T*N, ...] on every tensor of a dict."""
    return {k: v.reshape(-1, *v.shape[2:]) for k, v in tree.items()}


def _prefix_batched(prefix, obs_in, P):
    """``prefix`` over the train policies' [P, T, mb, ...] obs, every row
    at once; each leaf of what it returns (a tensor or a dict) [P, T * mb,
    ...]."""
    x = prefix({k: v.reshape(-1, *v.shape[3:]) for k, v in obs_in.items()})
    return tree_map(lambda t: t.reshape(P, -1, *t.shape[1:]), x)


def _merge_time_critic(critic_out, T, N):
    """[T*N, ...] -> [T, N, ...] on a critic output: a tensor, or a
    distribution over its logits."""
    if isinstance(critic_out, torch.Tensor):
        return critic_out.reshape(T, N, *critic_out.shape[1:])
    return critic_out.merge_time(T, N)


class BackboneEncoder(nn.Module):
    """Feed-forward tower; recurrent state is the empty tuple."""

    def __init__(self, net: nn.Module):
        super().__init__()
        self.net = net

    def init_recurrent_state(self, N, device=None):
        return ()

    def clear_recurrent_state(self, recurrent_states, should_clear):
        return ()

    def forward(self, rnn_states_in, inputs):
        return self.net(inputs), ()

    def chunked(self, params, layout, rnn_states_in, inputs):
        return self.net.chunked(params.child("net"), layout, inputs), ()

    def batched(self, params, rnn_start_states, sequence_ends, inputs):
        return self.net.batched(params.child("net"), inputs)

    def sequence(self, rnn_start_states, sequence_ends, flattened_inputs):
        return self.net(flattened_inputs)


class RecurrentBackboneEncoder(nn.Module):
    """net -> rnn tower with a sequence path for BPTT.

    ``use_fused_step=True`` (JAX: ``models/actor_critic.py:156-257``) runs
    the single-step (rollout) forward as one ``fused_policy_step`` launch
    when the tower matches the kernel: an ``MLP`` net feeding a one-layer
    ``LSTM`` of the same width and dtype, and one rank-2 input the kernel
    takes. Other towers take the unfused modules. The fused path only
    reads the module parameters, so the parameter tree (and checkpoints,
    and ``compat/from_jax.py``) is the same either way. The update pass is
    unchanged; its LayerNorm rounds its statistics once where the fused
    step rounds mean and variance to the storage dtype, so in bf16 the two
    forwards differ by about a bf16 ulp and PPO's ratio starts near, not
    at, 1 (the JAX package has the same divergence). In a population's
    policy-chunk layout (``chunked``) the fused step is one
    ``fused_policy_step_chunked`` launch over every chunk, each with its
    policy's stacked trunk and cell weights, as JAX ``vmap``s the fused
    step over policy chunks.

    ``remat_trunk_sequence=True`` (JAX: ``:186``) rematerializes the trunk
    in the update pass: ``sequence`` runs ``net`` under
    ``torch.utils.checkpoint``, which keeps none of its activations and
    runs its forward again in the backward. The rollout step is unchanged,
    and so are the numbers: the recomputed forward is the first one.
    """

    def __init__(self, net: nn.Module, rnn: nn.Module,
                 use_fused_step: bool = False,
                 remat_trunk_sequence: bool = False):
        super().__init__()
        self.net = net
        self.rnn = rnn
        self.use_fused_step = use_fused_step
        self.remat_trunk_sequence = remat_trunk_sequence

    def init_recurrent_state(self, N, device=None):
        return self.rnn.init_recurrent_state(N, device)

    def clear_recurrent_state(self, recurrent_states, should_clear):
        return self.rnn.clear_recurrent_state(recurrent_states, should_clear)

    def _fused_step_applicable(self, inputs):
        """JAX's gate: an MLP net, a one-layer LSTM, one rank-2 input, net
        width == LSTM width, one dtype, and ``policy_step_supported`` (JAX's
        own, at H = 128, 256, 384 and 512 where the kernel is built). The
        port's LSTM always runs precise gates, so JAX's ``use_pallas or
        float32`` clause always holds."""
        from .common import MLP
        from .lstm import LSTM

        net, rnn = self.net, self.rnn
        if not (isinstance(net, MLP) and isinstance(rnn, LSTM)
                and rnn.num_layers == 1 and net.num_layers >= 1
                and isinstance(inputs, torch.Tensor) and inputs.dim() == 2):
            return False
        return (net.num_channels == rnn.num_hidden_channels
                and net.dtype == rnn.dtype
                and policy_step_supported(rnn.num_hidden_channels,
                                          inputs.shape[-1], rnn.dtype))

    def _fused_step(self, rnn_states_in, x):
        dt = self.rnn.dtype
        mlp = [(getattr(self.net, f"Dense_{i}").kernel.to(dt),
                getattr(self.net, f"LayerNorm_{i}").impl.scale,
                getattr(self.net, f"LayerNorm_{i}").impl.bias)
               for i in range(self.net.num_layers)]
        cell = self.rnn.layer_0
        wr, b = cell.packed_weights()
        c_in, h_in = rnn_states_in  # [N, 1, H]
        out, (c, h) = fused_policy_step(
            x.to(dt).contiguous(), mlp, cell.input_proj.kernel.to(dt), wr, b,
            c_in[:, 0].contiguous(), h_in[:, 0].contiguous())
        return out, (c[:, None], h[:, None])

    def forward(self, rnn_states_in, inputs):
        if self.use_fused_step and self._fused_step_applicable(inputs):
            return self._fused_step(rnn_states_in, inputs)
        return self.rnn(rnn_states_in, self.net(inputs))

    def _fused_step_chunked(self, params, layout, rnn_states_in, x):
        """``_fused_step`` over [B, C, ...] chunks: the trunk's Dense and
        LayerNorm stacks (the affines in float32, rounded in the kernel as
        for one policy) and the cell's Wi / Wr / b stacks of ``params``."""
        dt = self.rnn.dtype
        net, cell = params.child("net"), params.child("rnn").child("layer_0")
        mlp = [(net.child(f"Dense_{i}").stack("kernel", dt),
                net.child(f"LayerNorm_{i}").child("impl").stack("scale"),
                net.child(f"LayerNorm_{i}").child("impl").stack("bias"))
               for i in range(self.net.num_layers)]
        B, C = x.shape[:2]
        rows = lambda t: t.reshape(B * C, t.shape[-1]).contiguous()
        c_in, h_in = rnn_states_in  # [B, C, 1, H]
        out, (c, h) = fused_policy_step_chunked(
            rows(x.to(dt)), mlp, cell.child("input_proj").stack("kernel", dt),
            cell.stack("recurrent_kernel", dt), cell.stack("bias", dt),
            layout.chunk_policy, rows(c_in), rows(h_in))
        chunks = lambda t: t.reshape(B, C, *t.shape[1:])
        return chunks(out), (chunks(c)[:, :, None], chunks(h)[:, :, None])

    def chunked(self, params, layout, rnn_states_in, inputs):
        if self.use_fused_step and isinstance(inputs, torch.Tensor) and \
                self._fused_step_applicable(inputs.flatten(0, 1)):
            return self._fused_step_chunked(params, layout, rnn_states_in,
                                            inputs)
        features = self.net.chunked(params.child("net"), layout, inputs)
        return self.rnn.chunked(params.child("rnn"), layout, rnn_states_in,
                                features)

    def batched_supported(self):
        return not self.remat_trunk_sequence

    def batched(self, params, rnn_start_states, sequence_ends, inputs):
        """``sequence`` over the train policies: ``inputs`` [P, T * mb,
        ...] -> [P, T * mb, ...], ``sequence_ends`` [P, T, mb, ...]."""
        P, T, mb = sequence_ends.shape[0:3]
        features = self.net.batched(params.child("net"), inputs)
        with profile("rnn.fwd_sequence"):
            rnn_out = self.rnn.batched(
                params.child("rnn"), rnn_start_states, sequence_ends,
                features.reshape(P, T, mb, *features.shape[2:]))
        return rnn_out.reshape(P, T * mb, *rnn_out.shape[3:])

    def sequence(self, rnn_start_states, sequence_ends, flattened_inputs):
        # The trunk runs over the flat [T*N] batch (one big product), then
        # reshapes to [T, N] for the recurrent pass.
        T, N = sequence_ends.shape[0:2]
        if self.remat_trunk_sequence and torch.is_grad_enabled():
            features = torch.utils.checkpoint.checkpoint(
                self.net, flattened_inputs, use_reentrant=False)
        else:
            features = self.net(flattened_inputs)
        with profile("rnn.fwd_sequence"):
            rnn_out = self.rnn.sequence(
                rnn_start_states, sequence_ends,
                features.reshape(T, N, *features.shape[1:]))
        return rnn_out.reshape(T * N, *rnn_out.shape[2:])


class Backbone(nn.Module):
    """Interface of a backbone: ``forward -> (actor_feats, critic_feats,
    rnn_out)``; ``actor_only`` / ``critic_only -> (feats, rnn_out)``;
    ``sequence -> (actor_feats, critic_feats)`` per timestep of stored
    [T, N] batches; and the recurrent state's init and clear."""

    def init_recurrent_state(self, N, device=None):
        raise NotImplementedError

    def clear_recurrent_state(self, recurrent_states, should_clear):
        raise NotImplementedError


class BackboneShared(Backbone):
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

    def actor_only(self, rnn_states_in, obs_in):
        return self.encoder(rnn_states_in, self.prefix(obs_in))

    critic_only = actor_only

    def critic_only_chunked(self, params, layout, rnn_states_in, obs_in):
        return self.encoder.chunked(params.child("encoder"), layout,
                                    rnn_states_in, self.prefix(obs_in))

    def chunked(self, params, layout, rnn_states_in, obs_in):
        feats, rnn_out = self.critic_only_chunked(params, layout,
                                                  rnn_states_in, obs_in)
        return feats, feats, rnn_out

    def sequence(self, rnn_start_states, sequence_ends, obs_in):
        feats = self.encoder.sequence(
            rnn_start_states, sequence_ends, self.prefix(_drop_time(obs_in)))
        return feats, feats

    def batched(self, params, rnn_start_states, sequence_ends, obs_in):
        """``sequence`` over the train policies' [P, T, mb, ...] obs: the
        prefix over every row at once, the tower's ``batched``;
        [P, T * mb, ...] features."""
        feats = self.encoder.batched(
            params.child("encoder"), rnn_start_states, sequence_ends,
            _prefix_batched(self.prefix, obs_in, sequence_ends.shape[0]))
        return feats, feats


class BackboneSeparate(Backbone):
    """Independent actor and critic towers over a shared prefix.

    The recurrent state is the pair ``(actor_state, critic_state)``;
    ``actor_only`` / ``critic_only`` run and advance only their tower's
    slot and pass the other through. ``chunked`` and ``batched`` run each
    tower's form over the one prefix; ``critic_only_chunked`` the critic's
    alone, the actor's slot passed through.
    """

    TOWERS = ("actor_encoder", "critic_encoder")

    def __init__(self, prefix: Callable[[Dict[str, torch.Tensor]],
                                        torch.Tensor],
                 actor_encoder: nn.Module, critic_encoder: nn.Module):
        super().__init__()
        self.prefix = prefix
        self.actor_encoder = actor_encoder
        self.critic_encoder = critic_encoder

    def _towers(self):
        return tuple(getattr(self, name) for name in self.TOWERS)

    def init_recurrent_state(self, N, device=None):
        return tuple(t.init_recurrent_state(N, device)
                     for t in self._towers())

    def clear_recurrent_state(self, recurrent_states, should_clear):
        return tuple(t.clear_recurrent_state(s, should_clear)
                     for t, s in zip(self._towers(), recurrent_states))

    def forward(self, rnn_states_in, obs_in):
        processed = self.prefix(obs_in)
        actor_feats, actor_rnn = self.actor_encoder(rnn_states_in[0],
                                                    processed)
        critic_feats, critic_rnn = self.critic_encoder(rnn_states_in[1],
                                                       processed)
        return actor_feats, critic_feats, (actor_rnn, critic_rnn)

    def _one_tower(self, slot, rnn_states_in, obs_in):
        feats, rnn_out = self._towers()[slot](rnn_states_in[slot],
                                              self.prefix(obs_in))
        new_states = list(rnn_states_in)
        new_states[slot] = rnn_out
        return feats, tuple(new_states)

    def actor_only(self, rnn_states_in, obs_in):
        return self._one_tower(0, rnn_states_in, obs_in)

    def critic_only(self, rnn_states_in, obs_in):
        return self._one_tower(1, rnn_states_in, obs_in)

    def sequence(self, rnn_start_states, sequence_ends, obs_in):
        processed = self.prefix(_drop_time(obs_in))
        return tuple(t.sequence(s, sequence_ends, processed)
                     for t, s in zip(self._towers(), rnn_start_states))

    def chunked(self, params, layout, rnn_states_in, obs_in):
        processed = self.prefix(obs_in)
        (actor_feats, actor_rnn), (critic_feats, critic_rnn) = (
            t.chunked(params.child(name), layout, s, processed)
            for name, t, s in zip(self.TOWERS, self._towers(),
                                  rnn_states_in))
        return actor_feats, critic_feats, (actor_rnn, critic_rnn)

    def critic_only_chunked(self, params, layout, rnn_states_in, obs_in):
        feats, rnn_out = self.critic_encoder.chunked(
            params.child("critic_encoder"), layout, rnn_states_in[1],
            self.prefix(obs_in))
        return feats, (rnn_states_in[0], rnn_out)

    def batched(self, params, rnn_start_states, sequence_ends, obs_in):
        """``sequence`` over the train policies' [P, T, mb, ...] obs: the
        prefix over every row at once, each tower's ``batched``."""
        processed = _prefix_batched(self.prefix, obs_in,
                                    sequence_ends.shape[0])
        return tuple(t.batched(params.child(name), s, sequence_ends,
                               processed)
                     for name, t, s in zip(self.TOWERS, self._towers(),
                                           rnn_start_states))


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

    def rollout_chunked(self, params, layout, generator, rnn_states_in,
                        obs_in, sample_actions=True):
        """``rollout`` over a population's chunks ([B, C, ...]), with the
        ``StackedParams`` ``params``; actions are sampled per row from
        ``generator``."""
        actor_feats, critic_feats, rnn_out = self.backbone.chunked(
            params.child("backbone"), layout, rnn_states_in, obs_in)
        dists = self.actor.chunked(params.child("actor"), layout,
                                   actor_feats)
        if sample_actions:
            actions, log_probs = dists.sample(generator)
            results = {"actions": actions, "log_probs": log_probs}
        else:
            results = {"actions": dists.best()}
        results["critic"] = self.critic.chunked(params.child("critic"),
                                                layout, critic_feats)
        return results, rnn_out

    def critic_only_chunked(self, params, layout, rnn_states_in, obs_in):
        """``critic_only`` over a population's chunks."""
        feats, rnn_out = self.backbone.critic_only_chunked(
            params.child("backbone"), layout, rnn_states_in, obs_in)
        return {"critic": self.critic.chunked(params.child("critic"), layout,
                                              feats)}, rnn_out

    def actor_only(self, rnn_states_in, obs_in):
        """One step of the actor alone: ({actions: each head's most likely
        action}, new recurrent state)."""
        feats, rnn_out = self.backbone.actor_only(rnn_states_in, obs_in)
        return {"actions": self.actor(feats).best()}, rnn_out

    def critic_only(self, rnn_states_in, obs_in):
        feats, rnn_out = self.backbone.critic_only(rnn_states_in, obs_in)
        return {"critic": self.critic(feats)}, rnn_out

    def update_batched(self, params, rnn_states, sequence_breaks,
                       rollout_actions, obs):
        """``update`` over the train policies at once: every input with a
        leading policy axis ([P, T, mb, ...]; the recurrent state [P, mb,
        ...]), policy p's rows with its parameters of the ``StackedParams``
        ``params``; log-probs, entropies and critic outputs [P, T, mb,
        ...]."""
        P, T, mb = sequence_breaks.shape[0:3]
        actor_feats, critic_feats = self.backbone.batched(
            params.child("backbone"), rnn_states, sequence_breaks, obs)
        dists = self.actor.batched(params.child("actor"), actor_feats)
        log_probs, entropies = dists.action_stats(
            {k: v.reshape(-1, *v.shape[3:])
             for k, v in rollout_actions.items()})
        # A tensor, or a distribution whose logits are reshaped.
        critic, rebuild = critic_parts(
            self.critic.batched(params.child("critic"), critic_feats))
        return {
            "log_probs": _merge_time(log_probs, P, T, mb),
            "entropies": _merge_time(entropies, P, T, mb),
            "critic": rebuild(tree_map(
                lambda x: x.reshape(P, T, mb, *x.shape[2:]), critic)),
        }

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
