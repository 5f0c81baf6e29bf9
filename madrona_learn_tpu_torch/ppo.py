"""PPO: clipped surrogate over collected rollouts (JAX: ppo.py).

The port has uniform shuffled minibatches and the clipped surrogate per
action head. The surrogate scores GAE advantages or, with
``compute_advantages=False``, the returns, each z-scored per minibatch
unless its flag is off. The critic loss is one of:
- the two-hot cross entropy of ``dreamer_v3_critic``'s distribution;
- the HL-Gauss cross entropy of ``hlgauss_critic``'s distribution;
- for a scalar critic, the L2 loss (``optax.l2_loss``) or, with
  ``huber_value_loss``, the Huber loss (``optax.huber_loss``, delta 1).
  With ``normalize_values`` the critic predicts returns normalized by the
  train state's EMA normalizer, which each minibatch updates. With
  ``clip_value_loss`` the prediction is clipped to ``clip_coef`` around the
  rollout's, in normalized space.
The distributional critics refuse clipping, the Huber loss and value
normalization, as the JAX package does. The entropy bonus weighs each
action key by ``entropy_key_weights`` (default 1). After each step come the
weight-norm projection and the LayerNorm renormalization.

The optimizer is the JAX package's learning-rate-free chain,
``optax.clip_by_global_norm`` then ``optax.scale_by_adam``, written out in
optax's exact form (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the
norm, which optax does not); the step is then scaled by the live
``-hyper_params.lr``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from .algo import AlgoBase, HyperParams
from .config import AlgoConfig, TrainConfig
from .ops.gae import zscore_data
from .ops.metrics import Metric, TrainingMetrics

__all__ = ["PPOConfig", "PPO"]

_F32 = torch.float32


@dataclass(frozen=True)
class PPOConfig(AlgoConfig):
    num_epochs: int
    minibatch_size: int
    clip_coef: float
    value_loss_coef: float
    entropy_coef: float
    max_grad_norm: float
    clip_value_loss: bool = False
    huber_value_loss: bool = False
    # Static per-action-key weights on the entropy bonus (missing keys
    # weigh 1).
    entropy_key_weights: Optional[Dict[str, float]] = None

    def name(self):
        return "ppo"

    def setup(self):
        return PPO()


@dataclass
class PPOHyperParams(HyperParams):
    clip_coef: float
    value_loss_coef: float
    entropy_coef: float
    max_grad_norm: float


@dataclass
class AdamState:
    count: torch.Tensor
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


@dataclass(frozen=True)
class ClipAdam:
    """``optax.chain(clip_by_global_norm(max_norm), scale_by_adam())``."""

    max_norm: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: Dict[str, torch.Tensor]) -> AdamState:
        device = next(iter(params.values())).device
        return AdamState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            mu={k: torch.zeros_like(p) for k, p in params.items()},
            nu={k: torch.zeros_like(p) for k, p in params.items()})

    def update(self, grads: Dict[str, torch.Tensor], state: AdamState):
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        trigger = g_norm < self.max_norm
        grads = {k: torch.where(trigger, g, (g / g_norm) * self.max_norm)
                 for k, g in grads.items()}

        mu = {k: (1 - self.b1) * g + self.b1 * state.mu[k]
              for k, g in grads.items()}
        nu = {k: (1 - self.b2) * (g * g) + self.b2 * state.nu[k]
              for k, g in grads.items()}
        count = state.count + 1
        count_f = count.to(_F32)
        bc1 = 1 - torch.pow(torch.tensor(self.b1, dtype=_F32,
                                         device=count.device), count_f)
        bc2 = 1 - torch.pow(torch.tensor(self.b2, dtype=_F32,
                                         device=count.device), count_f)
        updates = {k: (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + self.eps)
                   for k in grads}
        return updates, AdamState(count=count, mu=mu, nu=nu)


class PPO(AlgoBase):
    def init_hyperparams(self, cfg: TrainConfig) -> PPOHyperParams:
        if cfg.dreamer_v3_critic or cfg.hlgauss_critic:
            for option in ("clip_value_loss", "huber_value_loss"):
                if getattr(cfg.algo, option):
                    raise ValueError(f"{option} needs a scalar critic; "
                                     "the distributional critics refuse it")
            if cfg.normalize_values:
                raise ValueError("normalize_values needs a scalar critic; "
                                 "the distributional critics refuse it")
        return PPOHyperParams(
            lr=cfg.lr, gamma=cfg.gamma, gae_lambda=cfg.gae_lambda,
            normalize_values=cfg.normalize_values,
            value_normalizer_decay=cfg.value_normalizer_decay,
            clip_coef=cfg.algo.clip_coef,
            value_loss_coef=cfg.algo.value_loss_coef,
            entropy_coef=cfg.algo.entropy_coef,
            max_grad_norm=cfg.algo.max_grad_norm)

    def make_optimizer(self, hyper_params: PPOHyperParams) -> ClipAdam:
        return ClipAdam(max_norm=hyper_params.max_grad_norm)

    def update(self, *args, **kwargs):
        return _ppo(*args, **kwargs)

    def add_metrics(self, cfg: TrainConfig, metrics: Dict[str, Metric]):
        return dict(metrics, **{
            name: Metric.init(True)
            for name in ("Loss", "Action Obj", "Value Loss", "Value Errors",
                         "Entropy")})


def _flat_concat(tree):
    return torch.cat([x.reshape(-1, x.shape[-1]) for x in tree.values()],
                     dim=-1)


def _ppo_update(cfg: TrainConfig, mb, policy_state, train_state,
                metrics: TrainingMetrics):
    """One minibatch step; returns ratio diagnostics of the minibatch."""
    hp = train_state.hyper_params
    actor_critic = policy_state.actor_critic
    params = dict(actor_critic.named_parameters())

    fwd = actor_critic.update(mb["rnn_start_states"], mb["dones"],
                              mb["actions"], mb["obs"])
    if cfg.compute_advantages:
        advantages = mb["advantages"].to(_F32)
        if cfg.normalize_advantages:
            advantages = zscore_data(advantages)
    else:
        advantages = mb["returns"].to(_F32)
        if cfg.normalize_returns:
            advantages = zscore_data(advantages)

    ratios, action_objs = {}, {}
    for k, new_lp in fwd["log_probs"].items():
        ratio = torch.exp(new_lp - mb["log_probs"][k].to(_F32))
        clipped = torch.clamp(ratio, 1.0 - hp.clip_coef, 1.0 + hp.clip_coef)
        ratios[k] = ratio
        action_objs[k] = torch.minimum(advantages * ratio,
                                       advantages * clipped)

    value_losses, value_errs, new_value_norm_state = _value_loss(
        cfg, mb, fwd["critic"], train_state)

    key_weights = cfg.algo.entropy_key_weights or {}
    action_obj_avg = sum(o.to(_F32).mean() for o in action_objs.values())
    value_loss = value_losses.to(_F32).mean()
    entropy_avg = hp.entropy_coef * sum(
        key_weights.get(k, 1.0) * e.to(_F32).mean()
        for k, e in fwd["entropies"].items())
    loss = -action_obj_avg + hp.value_loss_coef * value_loss - entropy_avg

    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    grads = {k: (g if g is not None else torch.zeros_like(params[k]))
             for k, g in zip(params, grads)}

    with torch.no_grad():
        updates, train_state.opt_state = train_state.tx.update(
            grads, train_state.opt_state)
        for k, p in params.items():
            new = p + (-hp.lr) * updates[k]
            init_norm = train_state.initial_weight_norms.get(k)
            if init_norm is not None:
                # Project tracked kernels back to their initial L2 norm.
                new = init_norm * new / torch.linalg.vector_norm(new)
            p.copy_(new)
        _renorm_layernorms(actor_critic)
        train_state.value_normalizer_state = new_value_norm_state

        metrics.record({
            "Loss": loss.detach().reshape(1),
            "Action Obj": _flat_concat(action_objs)[None],
            "Value Loss": value_losses[None],
            "Value Errors": value_errs.abs()[None],
            "Entropy": _flat_concat(fwd["entropies"])[None],
        })
        dev = torch.stack([(r - 1).abs().max() for r in ratios.values()])
        clip_frac = torch.stack([((r - 1).abs() > hp.clip_coef).to(_F32)
                                 .mean() for r in ratios.values()])
    return {"max_abs_ratio_dev": dev.max(), "clip_fraction": clip_frac.mean(),
            "loss": loss.detach()}


def _value_loss(cfg: TrainConfig, mb, critic_out, train_state):
    """(per-element value losses, value errors in return units, the value
    normalizer's new state or None)."""
    if cfg.dreamer_v3_critic or cfg.hlgauss_critic:
        value_losses = (critic_out.two_hot_cross_entropy_loss(mb["returns"])
                        if cfg.dreamer_v3_critic
                        else critic_out.loss(mb["returns"]))
        return value_losses, critic_out.mean() - mb["returns"], None

    value_norm = train_state.value_normalizer
    norm_state = train_state.value_normalizer_state
    hp = train_state.hyper_params
    new_values_norm = critic_out
    if value_norm is None:
        value_errs = new_values_norm - mb["returns"]
    else:
        value_errs = (value_norm.invert(norm_state, new_values_norm)
                      - mb["returns"])

    if cfg.algo.clip_value_loss:
        old_values_norm = mb["values"]
        new_values_norm = torch.minimum(
            torch.maximum(new_values_norm, old_values_norm - hp.clip_coef),
            old_values_norm + hp.clip_coef)

    if value_norm is None:
        normalized_returns, new_norm_state = mb["returns"], None
    else:
        with torch.no_grad():
            new_norm_state, normalized_returns = \
                value_norm.normalize_and_update_estimates(norm_state,
                                                          mb["returns"])

    errors = new_values_norm - normalized_returns
    if cfg.algo.huber_value_loss:
        # optax.huber_loss with delta = 1.
        abs_errors = errors.abs()
        quadratic = torch.minimum(abs_errors, torch.ones_like(abs_errors))
        value_losses = 0.5 * quadratic ** 2 + (abs_errors - quadratic)
    else:
        value_losses = 0.5 * errors ** 2  # optax.l2_loss
    return value_losses, value_errs, new_norm_state


def _renorm_layernorms(module):
    """Scale each LayerNorm's (scale, bias) to a joint norm of sqrt(dim)."""
    for name, child in module.named_modules():
        if name.rsplit(".", 1)[-1].startswith("LayerNorm"):
            scale, bias = child.impl.scale, child.impl.bias
            factor = torch.sqrt(scale.shape[-1] / (
                torch.dot(bias, bias) + torch.dot(scale, scale)))
            bias.mul_(factor)
            scale.mul_(factor)


def _ppo(cfg: TrainConfig, policy_state, train_state, rollout_data,
         user_metrics_cb: Callable, metrics: TrainingMetrics):
    """Epochs of shuffled whole-sequence minibatches for one policy.

    Returns the ratio diagnostics of the first minibatch of the first
    epoch, where the weights still equal the rollout's.
    """
    num_trajectories = rollout_data.all()["dones"].shape[0]
    mb_size = cfg.algo.minibatch_size
    if num_trajectories % mb_size:
        raise ValueError(
            f"minibatch_size ({mb_size}) must evenly divide the "
            f"{num_trajectories} training sequences per policy "
            f"(= num_bptt_chunks * train agents per policy)")
    gen = train_state.generator
    first = None
    for epoch in range(cfg.algo.num_epochs):
        perm = torch.randperm(num_trajectories, generator=gen,
                              device=gen.device)
        for i in range(num_trajectories // mb_size):
            mb = rollout_data.minibatch(perm[i * mb_size:(i + 1) * mb_size])
            stats = _ppo_update(cfg, mb, policy_state, train_state, metrics)
            if first is None:
                first = stats
            user_metrics_cb(metrics, epoch, mb, policy_state, train_state)
    return first
