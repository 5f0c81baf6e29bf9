"""PPO: clipped surrogate over collected rollouts (JAX: ppo.py).

Minibatches are chosen one of three ways each update:
- uniform: every training sequence once an epoch, shuffled as one block or,
  with ``minibatch_stratify``, as that many equal contiguous blocks each
  shuffled on its own, every minibatch taking an equal share of each block;
- advantage filtering (``filter_advantages``): time is flattened into rows,
  an EMA of the largest |advantage| sets a threshold of 1% of it, and the
  epoch shuffles the rows with the largest |advantage|, enough whole
  minibatches to hold every row above the threshold;
- trajectory importance sampling (``importance_sample_trajectories``):
  ``importance_sample_num_minibatches`` minibatches of distinct sequences
  drawn by softmax(mean |advantage| + mean |value - return|).
Every loss term is a per-trajectory weighted mean, mean(w * x) with one
weight a sequence: ``(1 / num_sequences) / p`` under importance sampling,
which keeps the estimate unbiased, and 1 otherwise (``1.0 * x`` is ``x``
bitwise, so the uniform update is unchanged by the weighting).

The surrogate scores GAE advantages or, with ``compute_advantages=False``,
the returns, each z-scored per minibatch (unweighted) unless its flag is
off. The critic loss is one of:
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
weight-norm projection and the LayerNorm renormalization. The update opens
the JAX package's named ranges (``utils/profile.py``).

The optimizer is the JAX package's learning-rate-free chain,
``optax.clip_by_global_norm`` then ``optax.scale_by_adam``, written out in
optax's exact form (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the
norm, which optax does not); the step is then scaled by the live
``-hyper_params.lr``. With a float16 ``compute_dtype`` the train state's
``DynamicScale`` scales the loss, and a step whose gradients are not finite
keeps the parameters and the optimizer state as they were
(``torch.where``, no host synchronization).

A population whose model has policy-batched learn forms
(``rollouts.batched_learn_missing``) learns all its train policies at once,
as JAX ``vmap``s ``algo.update`` over them (``train.py:315``):
``_ppo_population`` takes one PPO step a minibatch over every train
policy, on the ``[P, ...]`` stacks of ``train_state.StackedTrainState``.
Each policy draws its minibatches from its own generator, in the order the
per-policy loop draws them; one gather takes every policy's minibatch; one
batched forward and backward (``ActorCritic.update_batched``) feed each
policy's loss, mapped over the policies by ``torch.func.vmap`` from the
per-policy code (``_loss_terms``) and summed for one ``autograd.grad``, so
each policy's gradient is its own; the Adam step clips each policy's
gradients by its own global norm, and the weight-norm projection and the
LayerNorm renormalization run per policy. Under float16 loss scaling each
train policy keeps its own scaler (``DynamicScale.unscale_stacked``): its
loss is scaled by its own scale before the one ``autograd.grad``, its
gradient rows unscaled by it, and a policy whose step was not finite keeps
its parameters and Adam state (``torch.where`` per policy) while the
others step.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Callable, Dict, Optional, Union

import torch

from .algo import AlgoBase, HyperParams
from .config import AlgoConfig, ParamExplore, TrainConfig
from .ops.gae import zscore_data
from .models.common import StackedParams
from .ops.dists import critic_parts
from .ops.metrics import Metric, TrainingMetrics
from .utils import profile, tree_map

__all__ = ["PPOConfig", "PPO"]

_F32 = torch.float32


@dataclass(frozen=True)
class PPOConfig(AlgoConfig):
    num_epochs: int
    minibatch_size: int
    clip_coef: float
    value_loss_coef: float
    entropy_coef: Union[float, ParamExplore]
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

    def explore_hyperparams(self, generator, hyper_params,
                            resample_chance):
        """PBT's mutation of PPO's own hyperparameters."""
        if isinstance(self.entropy_coef, ParamExplore):
            from .pbt import explore_param
            hyper_params.entropy_coef = explore_param(
                generator, hyper_params.entropy_coef, self.entropy_coef,
                resample_chance)
        return hyper_params


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
        """(updates, new state). With a ``[P]`` count the gradients and the
        state are a population's ``[P, ...]`` stacks, and each policy's
        gradients are clipped by their own global norm."""
        stacked = state.count.dim() == 1
        if stacked:
            g_norm = torch.sqrt(sum((g * g).reshape(g.shape[0], -1).sum(1)
                                    for g in grads.values()))
        else:
            g_norm = torch.sqrt(sum(torch.sum(g * g)
                                    for g in grads.values()))

        def per(x, like):
            """A per-policy ``x`` [P] shaped to broadcast over ``like``."""
            return x.reshape(-1, *[1] * (like.dim() - 1)) if stacked else x

        trigger = g_norm < self.max_norm
        grads = {k: torch.where(per(trigger, g), g,
                                (g / per(g_norm, g)) * self.max_norm)
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
        updates = {k: (mu[k] / per(bc1, mu[k]))
                   / (torch.sqrt(nu[k] / per(bc2, nu[k])) + self.eps)
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
        # A searched hyperparameter starts at its base; PBT then draws it.
        lr = cfg.lr.base if isinstance(cfg.lr, ParamExplore) else cfg.lr
        entropy = cfg.algo.entropy_coef
        if isinstance(entropy, ParamExplore):
            entropy = entropy.base
        return PPOHyperParams(
            lr=lr, gamma=cfg.gamma, gae_lambda=cfg.gae_lambda,
            normalize_values=cfg.normalize_values,
            value_normalizer_decay=cfg.value_normalizer_decay,
            max_advantage_est_decay=cfg.max_advantage_est_decay,
            clip_coef=cfg.algo.clip_coef,
            value_loss_coef=cfg.algo.value_loss_coef,
            entropy_coef=entropy,
            max_grad_norm=cfg.algo.max_grad_norm)

    def make_optimizer(self, hyper_params: PPOHyperParams) -> ClipAdam:
        return ClipAdam(max_norm=hyper_params.max_grad_norm)

    def update(self, *args, **kwargs):
        return _ppo(*args, **kwargs)

    def update_population(self, *args, **kwargs):
        return _ppo_population(*args, **kwargs)

    def add_metrics(self, cfg: TrainConfig, metrics: Dict[str, Metric]):
        return dict(metrics, **{
            name: Metric.init(True)
            for name in ("Loss", "Action Obj", "Value Loss", "Value Errors",
                         "Entropy")})


def _flat_concat(tree):
    return torch.cat([x.reshape(-1, x.shape[-1]) for x in tree.values()],
                     dim=-1)


def _weighted_mean(weights, x):
    """mean(w * x) over time-major ``x`` [T, mb, ...] with one weight a
    trajectory, ``weights`` [mb, 1]. (JAX multiplies by the [mb, 1] weights
    as they stand, which for the [T, mb, 1, dims] terms of continuous
    actions broadcasts to [T, mb, mb, dims]; the two agree under uniform
    weights.)"""
    w = weights.reshape(weights.shape[0], *(1,) * (x.dim() - 2))
    return (w * x.to(_F32)).mean()


def _loss_terms(cfg: TrainConfig, mb, mb_weights, fwd, train_state,
                entropy_coef):
    """One policy's loss from its update pass ``fwd`` over the minibatch
    ``mb``: (loss, ratios, action objectives, value losses, value errors,
    the value normalizer's new state or None). Reads ``train_state``'s
    hyperparameters and value normalizer and changes nothing, so
    ``_ppo_population`` maps it over the train policies with
    ``torch.func.vmap``."""
    hp = train_state.hyper_params
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
        # Continuous heads' log-probs are [T, mb, heads, dims].
        scores = (advantages[..., None] if ratio.dim() - 2 > 1
                  else advantages)
        ratios[k] = ratio
        action_objs[k] = torch.minimum(scores * ratio, scores * clipped)

    value_losses, value_errs, new_value_norm_state = _value_loss(
        cfg, mb, fwd["critic"], train_state)

    key_weights = cfg.algo.entropy_key_weights or {}
    action_obj_avg = sum(_weighted_mean(mb_weights, o)
                         for o in action_objs.values())
    value_loss = _weighted_mean(mb_weights, value_losses)
    entropy_avg = entropy_coef * sum(
        key_weights.get(k, 1.0) * _weighted_mean(mb_weights, e)
        for k, e in fwd["entropies"].items())
    loss = -action_obj_avg + hp.value_loss_coef * value_loss - entropy_avg
    return (loss, ratios, action_objs, value_losses, value_errs,
            new_value_norm_state)


def _ratio_stats(ratios, clip_coef, dims):
    """max |ratio - 1| and the clipped fraction over ``dims`` of every
    action key's ratios, the fraction averaged over the keys."""
    dev = torch.stack([(r - 1).abs().amax(dim=dims) for r in ratios.values()])
    clip_frac = torch.stack([((r - 1).abs() > clip_coef).to(_F32)
                             .mean(dim=dims) for r in ratios.values()])
    return dev.amax(0), clip_frac.mean(0)


def _ppo_update(cfg: TrainConfig, mb, mb_weights, policy_state, train_state,
                metrics: TrainingMetrics):
    """One minibatch step; returns ratio diagnostics of the minibatch and,
    with a loss scaler, whether the step was finite."""
    # A 1-D [mb] weight would broadcast against [T, mb, 1] to [T, mb, mb].
    assert mb_weights.dim() == 2 and mb_weights.shape[-1] == 1, (
        f"mb_weights must be [minibatch, 1], got {tuple(mb_weights.shape)}")
    with profile("Optimize"):
        hp = train_state.hyper_params
        actor_critic = policy_state.actor_critic
        params = dict(actor_critic.named_parameters())

        with profile("AC Forward"):
            fwd = actor_critic.update(mb["rnn_start_states"], mb["dones"],
                                      mb["actions"], mb["obs"])
        (loss, ratios, action_objs, value_losses, value_errs,
         new_value_norm_state) = _loss_terms(cfg, mb, mb_weights, fwd,
                                             train_state, hp.entropy_coef)

        scaler = train_state.scaler
        grads = torch.autograd.grad(
            loss if scaler is None
            else scaler.scale_loss(train_state.scaler_state, loss),
            list(params.values()), allow_unused=True)
        grads = [g if g is not None else torch.zeros_like(p)
                 for g, p in zip(grads, params.values())]
        finite = None
        if scaler is not None:
            train_state.scaler_state, finite, grads = scaler.unscale(
                train_state.scaler_state, grads)
        grads = dict(zip(params, grads))

        with torch.no_grad():
            old_opt_state = train_state.opt_state
            updates, new_opt_state = train_state.tx.update(grads,
                                                           old_opt_state)
            if finite is not None:
                new_opt_state = AdamState(**tree_map(
                    lambda new, old: torch.where(finite, new, old),
                    vars(new_opt_state), vars(old_opt_state)))
            train_state.opt_state = new_opt_state
            for k, p in params.items():
                new = p + (-hp.lr) * updates[k]
                if finite is not None:
                    new = torch.where(finite, new, p)
                init_norm = train_state.initial_weight_norms.get(k)
                if init_norm is not None:
                    # Project tracked kernels back to their initial L2 norm.
                    new = init_norm * new / torch.linalg.vector_norm(new)
                p.copy_(new)
            _renorm_layernorms(actor_critic)
            train_state.value_normalizer_state = new_value_norm_state

    with profile("Record Metrics"), torch.no_grad():
        metrics.record({
            "Loss": loss.detach().reshape(1),
            "Action Obj": _flat_concat(action_objs)[None],
            "Value Loss": value_losses[None],
            "Value Errors": value_errs.abs()[None],
            "Entropy": _flat_concat(fwd["entropies"])[None],
        })
        dev, clip_frac = _ratio_stats(ratios, hp.clip_coef, None)
    stats = {"max_abs_ratio_dev": dev, "clip_fraction": clip_frac,
             "loss": loss.detach()}
    if finite is not None:
        stats["finite"] = finite
    return stats


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


def _renorm_layernorms_stacked(module, leaves):
    """``_renorm_layernorms`` of every policy of the ``[P, dim]`` stacks
    ``leaves``, each policy's to its own joint norm."""
    for name, _ in module.named_modules():
        if name.rsplit(".", 1)[-1].startswith("LayerNorm"):
            scale = leaves[f"{name}.impl.scale"]
            bias = leaves[f"{name}.impl.bias"]
            factor = torch.sqrt(scale.shape[-1] / (
                (bias * bias).sum(-1) + (scale * scale).sum(-1)))[:, None]
            bias.mul_(factor)
            scale.mul_(factor)


def permutation(generator: torch.Generator, x: torch.Tensor):
    """The rows of ``x`` in an order drawn from ``generator``."""
    return x[torch.randperm(x.shape[0], generator=generator,
                            device=x.device)]


def choice(generator: torch.Generator, probs: torch.Tensor, k: int):
    """``k`` distinct indices drawn with probabilities ``probs``. Without
    replacement ``torch.multinomial`` takes the k largest p / Exp(1), the
    Gumbel-top-k rule of ``jax.random.choice(..., replace=False, p=)``."""
    return torch.multinomial(probs, k, replacement=False,
                             generator=generator)


def resolve_stratify(cfg: TrainConfig, num_train_seqs_per_policy: int) -> int:
    """The number of blocks uniform minibatches are stratified over: 1
    under advantage filtering or importance sampling (their selections are
    global), ``minibatch_stratify`` (None is 1: the port has no mesh), and
    1 with a warning when the blocks would not divide the sequences and
    the minibatch evenly."""
    if cfg.filter_advantages or cfg.importance_sample_trajectories:
        return 1
    stratify = max(int(cfg.minibatch_stratify or 1), 1)
    if stratify == 1:
        return 1
    if (num_train_seqs_per_policy % stratify != 0
            or cfg.algo.minibatch_size % stratify != 0):
        warnings.warn(
            f"minibatch stratification disabled: stratify={stratify} must "
            f"divide both the per-policy training sequences "
            f"({num_train_seqs_per_policy}) and minibatch_size "
            f"({cfg.algo.minibatch_size}); falling back to the single "
            f"global shuffle.")
        return 1
    return stratify


def filter_selection(cfg: TrainConfig, train_state, advantages):
    """Advantage filtering over time-flattened ``advantages`` [rows, 1, 1]:
    (the rows by descending |advantage|, the first ``num_minibatches *
    minibatch_size`` kept and the rest -1, num_minibatches, the EMA of the
    largest |advantage| updated)."""
    mb_size = cfg.algo.minibatch_size
    adv_abs = advantages.abs()
    est_state = train_state.max_advantage_est.update_estimates(
        train_state.max_advantage_est_state, adv_abs.max())
    adv_flat = adv_abs.reshape(-1)
    sorted_idxs = torch.argsort(adv_flat, descending=True, stable=True)
    num_above = (adv_flat >= 0.01 * est_state["mu"]).sum()
    # A host synchronization, once an update: the minibatch loop is Python.
    num_minibatches = min(int(num_above + mb_size - 1) // mb_size,
                          adv_flat.shape[0] // mb_size)
    rows = torch.arange(adv_flat.shape[0], device=adv_flat.device)
    valid_inds = torch.where(rows < num_minibatches * mb_size, sorted_idxs,
                             -1)
    return valid_inds, num_minibatches, est_state


def importance_weights(data):
    """Trajectory importance sampling over sequences [num, T/C, ...]: (the
    sampling probabilities [num], the unbiasing weights [num, 1])."""
    advantages = data["advantages"].to(_F32)
    num_total = advantages.shape[0]

    def per_seq_mean(x):
        return x.reshape(num_total, -1).mean(dim=1)

    traj_scores = (per_seq_mean(advantages.abs())
                   + per_seq_mean((data["values"].to(_F32)
                                   - data["returns"].to(_F32)).abs()))
    traj_probs = torch.softmax(traj_scores, dim=0)
    # E_sample[w_i * loss_i] = mean_i loss_i.
    return traj_probs, ((1.0 / num_total) / traj_probs)[:, None]


def epoch_indices(cfg: TrainConfig, generator, valid_inds, stratify: int,
                  num_minibatches: int):
    """One epoch's minibatch index stream: minibatch i is the slice
    [i * minibatch_size, (i + 1) * minibatch_size). Stratified, each of the
    ``stratify`` contiguous blocks of ``valid_inds`` (then ``arange``) is
    shuffled on its own and each minibatch takes ``minibatch_size /
    stratify`` rows from every block, block-major; otherwise
    ``valid_inds`` is shuffled as one, with filtering's -1 entries moved
    to the back in their shuffled order."""
    device = valid_inds.device
    if stratify > 1:
        block = valid_inds.shape[0] // stratify
        per_mb = cfg.algo.minibatch_size // stratify
        perms = torch.stack([
            permutation(generator, torch.arange(block, device=device))
            for _ in range(stratify)])
        ids = torch.arange(stratify, device=device)[:, None] * block + perms
        return ids.reshape(stratify, num_minibatches, per_mb).transpose(
            0, 1).reshape(-1)
    inds = permutation(generator, valid_inds)
    if cfg.filter_advantages:
        inds = inds[torch.argsort((inds == -1).to(torch.int32), stable=True)]
    return inds


def _ppo(cfg: TrainConfig, policy_state, train_state, rollout_data,
         user_metrics_cb: Callable, metrics: TrainingMetrics):
    """Epochs of minibatches for one policy.

    Returns the ratio diagnostics of the first minibatch of the first
    epoch, where the weights still equal the rollout's, with the update's
    ``num_minibatches`` an epoch, the first epoch's index stream
    (``epoch_inds``) and the per-trajectory weights (``traj_weights``)
    it was drawn with, and, with a loss scaler, the count of its
    non-finite steps (``nonfinite_steps``, on the device).
    """
    rollout_data, valid_inds, num_minibatches, traj_weights, stratify = \
        _selection(cfg, train_state, rollout_data)
    mb_size = cfg.algo.minibatch_size
    gen = train_state.generator
    first, first_inds, nonfinite = None, None, None
    for epoch in range(cfg.algo.num_epochs):
        with profile("Compute Minibatch Indices"):
            inds = epoch_indices(cfg, gen, valid_inds, stratify,
                                 num_minibatches)
        if first_inds is None:
            first_inds = inds
        for i in range(num_minibatches):
            with profile("Gather Minibatch"):
                mb_inds = inds[i * mb_size:(i + 1) * mb_size]
                mb = rollout_data.minibatch(mb_inds)
                mb_weights = traj_weights[mb_inds]
            stats = _ppo_update(cfg, mb, mb_weights, policy_state,
                                train_state, metrics)
            if first is None:
                first = stats
            if "finite" in stats:
                step = (~stats["finite"]).to(torch.int32)
                nonfinite = step if nonfinite is None else nonfinite + step
            with profile("Metrics Callback"):
                user_metrics_cb(metrics, epoch, mb, policy_state,
                                train_state)
    out = dict(first or {}, num_minibatches=num_minibatches,
               epoch_inds=first_inds, traj_weights=traj_weights)
    if nonfinite is not None:
        out["nonfinite_steps"] = nonfinite
    return out


def _selection(cfg: TrainConfig, train_state, rollout_data):
    """What one policy's epochs choose from: (the rollout data, flattened
    to single steps under advantage filtering; the valid sequence indices;
    the minibatches an epoch; the per-trajectory weights [num, 1]; the
    stratification's blocks). Importance sampling draws its sequences from
    the policy's generator, and filtering updates its advantage EMA."""
    mb_size = cfg.algo.minibatch_size
    gen = train_state.generator
    if cfg.filter_advantages:
        rollout_data = rollout_data.flatten_time()
        advantages = rollout_data.all()["advantages"]
        valid_inds, num_minibatches, \
            train_state.max_advantage_est_state = filter_selection(
                cfg, train_state, advantages)
        traj_weights = torch.ones((advantages.shape[0], 1), dtype=_F32,
                                  device=advantages.device)
    elif cfg.importance_sample_trajectories:
        traj_probs, traj_weights = importance_weights(rollout_data.all())
        num_total = traj_probs.shape[0]
        num_minibatches = cfg.importance_sample_num_minibatches
        num_sampled = num_minibatches * mb_size
        if not (num_sampled < num_total and num_minibatches > 0):
            raise ValueError(
                f"importance sampling draws importance_sample_num_minibatches"
                f" ({num_minibatches}) x minibatch_size ({mb_size}) = "
                f"{num_sampled} sequences, which must be more than 0 and "
                f"fewer than the {num_total} training sequences")
        valid_inds = choice(gen, traj_probs, num_sampled)
    else:
        num_trajectories = rollout_data.all()["dones"].shape[0]
        if num_trajectories % mb_size:
            raise ValueError(
                f"minibatch_size ({mb_size}) must evenly divide the "
                f"{num_trajectories} training sequences per policy "
                f"(= num_bptt_chunks * train agents per policy)")
        num_minibatches = num_trajectories // mb_size
        device = rollout_data.all()["dones"].device
        valid_inds = torch.arange(num_trajectories, device=device)
        traj_weights = torch.ones((num_trajectories, 1), dtype=_F32,
                                  device=device)
    return (rollout_data, valid_inds, num_minibatches, traj_weights,
            resolve_stratify(cfg, valid_inds.shape[0]))


def _ppo_population(cfg: TrainConfig, stacked, rollout_data,
                    user_metrics_cb: Callable, metrics: TrainingMetrics):
    """Epochs of minibatches for every train policy at once, on the
    ``[P, ...]`` stacks of ``stacked`` (``train_state.StackedTrainState``);
    ``rollout_data`` holds the P policies' sequences. Uniform, stratified
    and importance-sampled minibatches (the same count for every policy),
    and float16 loss scaling with one scaler a policy; advantage filtering
    takes the per-policy loop (``rollouts.batched_learn_missing``).

    Returns one dict a train policy, as ``_ppo`` does for one: its first
    minibatch's ratio diagnostics, ``num_minibatches``, its first epoch's
    index stream, its per-trajectory weights and, with a loss scaler, the
    count of its non-finite steps (``nonfinite_steps``)."""
    P = len(stacked.train_states)
    mb_size = cfg.algo.minibatch_size
    selections, streams = [], []
    with profile("Compute Minibatch Indices"):
        # Each policy's draws from its own generator, in the per-policy
        # loop's order: its selection, then its epochs'.
        for p, ts in enumerate(stacked.train_states):
            _, valid_inds, num_minibatches, traj_weights, stratify = \
                _selection(cfg, ts, rollout_data.policy(p))
            selections.append((num_minibatches, traj_weights))
            streams.append([epoch_indices(cfg, ts.generator, valid_inds,
                                          stratify, num_minibatches)
                            for _ in range(cfg.algo.num_epochs)])
    num_minibatches = selections[0][0]
    traj_weights = torch.stack([w for _, w in selections])
    policies = torch.arange(P, device=traj_weights.device)[:, None]

    first, nonfinite = None, None
    for epoch in range(cfg.algo.num_epochs):
        for i in range(num_minibatches):
            with profile("Gather Minibatch"):
                mb_inds = torch.stack([s[epoch][i * mb_size:(i + 1) * mb_size]
                                       for s in streams])
                mb = rollout_data.minibatch_stacked(mb_inds)
                mb_weights = traj_weights[policies, mb_inds]
            stats = _ppo_update_population(cfg, mb, mb_weights, stacked,
                                           metrics)
            if first is None:
                first = stats
            if "finite" in stats:
                step = (~stats["finite"]).to(torch.int32)
                nonfinite = step if nonfinite is None else nonfinite + step
            with profile("Metrics Callback"):
                # Each policy's state after this minibatch's step, as JAX
                # and the per-policy loop hand it over: views of its rows
                # of the stacks.
                for p in range(P):
                    user_metrics_cb(metrics.for_policy(p), epoch,
                                    tree_map(lambda x, p=p: x[p], mb),
                                    *stacked.policy_views(p))
    out = [dict({k: v[p] for k, v in first.items()},
                num_minibatches=num_minibatches,
                epoch_inds=streams[p][0], traj_weights=traj_weights[p])
           for p in range(P)]
    if nonfinite is not None:
        for p, o in enumerate(out):
            o["nonfinite_steps"] = nonfinite[p]
    return out


def _ppo_update_population(cfg: TrainConfig, mb, mb_weights, stacked,
                           metrics: TrainingMetrics):
    """One minibatch step of every train policy (``mb`` [P, T, mb, ...],
    ``mb_weights`` [P, mb, 1]): the batched forward and backward, each
    policy's loss and gradient, the stacked Adam step, the per-policy
    projections; [P] ratio diagnostics of the minibatch."""
    with profile("Optimize"):
        leaves = stacked.leaves
        actor_critic = stacked.actor_critic
        with profile("AC Forward"):
            fwd = actor_critic.update_batched(
                StackedParams(leaves), mb["rnn_start_states"], mb["dones"],
                mb["actions"], mb["obs"])

        # vmap maps tensors only: a distributional critic's output goes
        # through as its logits and is rebuilt inside.
        critic, rebuild_critic = critic_parts(fwd["critic"])
        actor_fwd = {k: v for k, v in fwd.items() if k != "critic"}

        def policy_terms(mb_p, weights_p, actor_fwd_p, critic_p, norm_state_p,
                         entropy_p):
            train_state = SimpleNamespace(
                hyper_params=stacked.hyper_params,
                value_normalizer=stacked.value_normalizer,
                value_normalizer_state=norm_state_p or None)
            fwd_p = dict(actor_fwd_p, critic=rebuild_critic(critic_p))
            out = _loss_terms(cfg, mb_p, weights_p, fwd_p, train_state,
                              entropy_p)
            return out[:-1] + (out[-1] or {},)

        (loss, ratios, action_objs, value_losses, value_errs,
         new_value_norm_state) = torch.func.vmap(policy_terms)(
            mb, mb_weights, actor_fwd, critic,
            stacked.value_normalizer_state or {}, stacked.entropy_coef)
        scaler = stacked.scaler
        # Each policy's loss scaled by its own scale: a policy's rows of
        # the leaves reach its loss alone, so they get its scale alone.
        grads = torch.autograd.grad(
            (loss if scaler is None
             else scaler.scale_loss(stacked.scaler_state, loss)).sum(),
            list(leaves.values()), allow_unused=True)
        grads = [g if g is not None else torch.zeros_like(p)
                 for g, p in zip(grads, leaves.values())]
        finite = None
        if scaler is not None:
            stacked.scaler_state, finite, grads = scaler.unscale_stacked(
                stacked.scaler_state, grads)
        grads = dict(zip(leaves, grads))

        with torch.no_grad():
            old_opt_state = stacked.opt_state
            updates, new_opt_state = stacked.tx.update(grads, old_opt_state)
            if finite is not None:
                # A policy whose step was not finite keeps its Adam state
                # and its parameters (before the projections below, as on
                # the per-policy loop and in JAX); its value normalizer
                # advances, as there.
                new_opt_state = AdamState(**tree_map(
                    lambda new, old: torch.where(
                        finite.reshape(-1, *[1] * (new.dim() - 1)), new,
                        old),
                    vars(new_opt_state), vars(old_opt_state)))
            stacked.opt_state = new_opt_state
            lr = stacked.lr
            for k, p in leaves.items():
                per = lambda x, p=p: x.reshape(-1, *[1] * (p.dim() - 1))
                new = p + per(-lr) * updates[k]
                if finite is not None:
                    new = torch.where(per(finite), new, p)
                init_norm = stacked.initial_weight_norms.get(k)
                if init_norm is not None:
                    # Project tracked kernels back to their initial L2 norm,
                    # policy by policy.
                    norm = torch.linalg.vector_norm(
                        new.reshape(new.shape[0], -1), dim=1)
                    new = per(init_norm) * new / per(norm)
                p.copy_(new)
            _renorm_layernorms_stacked(actor_critic, leaves)
            if stacked.value_normalizer is not None:
                stacked.value_normalizer_state = new_value_norm_state

    hp = stacked.hyper_params
    P = loss.shape[0]
    with profile("Record Metrics"), torch.no_grad():
        metrics.record({
            "Loss": loss.detach().reshape(P, 1),
            "Action Obj": torch.cat(
                [x.reshape(P, -1, x.shape[-1]) for x in action_objs.values()],
                dim=-1),
            "Value Loss": value_losses,
            "Value Errors": value_errs.abs(),
            "Entropy": torch.cat(
                [x.reshape(P, -1, x.shape[-1])
                 for x in fwd["entropies"].values()], dim=-1),
        })
        dev, clip_frac = _ratio_stats(
            ratios, hp.clip_coef,
            tuple(range(1, next(iter(ratios.values())).dim())))
    stats = {"max_abs_ratio_dev": dev, "clip_fraction": clip_frac,
             "loss": loss.detach()}
    if finite is not None:
        stats["finite"] = finite
    return stats
