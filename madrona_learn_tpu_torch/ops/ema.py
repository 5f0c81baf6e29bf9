"""Bias-corrected EMA statistics (JAX: madrona_learn_tpu/ops/ema.py).

- ``EMAEstimate``: EMA of a mean with the ``-1/expm1(N log d)`` bias
  correction (equal to dividing by ``1 - d^N``).
- ``EMANormalizer``: EMA of per-feature mean and variance. Batches reduce to
  a (mean, var) pair with Chan's weighted merge, then fold into the EMA.
  Estimates are float32 whatever the data dtype; ``normalize`` casts to the
  compute dtype and ``invert`` returns float32 (the values that enter
  GAE). ``normalize_and_update_estimates`` is the value normalizer's step:
  fold one batch in, then normalize it with the new estimates.

Estimates are plain dicts of tensors; every function returns new tensors.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

_F32 = torch.float32


def _as_float(x):
    return x if x.is_floating_point() else x.to(_F32)


def _bias_correction(n, decay):
    """1 / (1 - decay^n), in log space and float32."""
    log_decay = torch.log(torch.tensor(decay, dtype=_F32, device=n.device))
    return -1.0 / torch.expm1(n.to(_F32) * log_decay)


@dataclass(frozen=True)
class EMAEstimate:
    """Bias-corrected EMA of a (vector of) scalar mean(s)."""

    decay: float

    def init_estimates(self, x):
        dim = x.shape[-1]
        return dict(
            mu=torch.zeros(dim, dtype=_F32, device=x.device),
            mu_biased=torch.zeros(dim, dtype=_F32, device=x.device),
            N=torch.zeros((), dtype=torch.int32, device=x.device),
        )

    def update_estimates(self, est, x):
        x_mean = x.to(_F32).mean()
        decay = torch.tensor(self.decay, dtype=_F32, device=x.device)
        new_n = est["N"] + 1
        new_mu_biased = decay * est["mu_biased"] + (1 - decay) * x_mean
        new_mu = new_mu_biased * _bias_correction(new_n, self.decay)
        return dict(mu=new_mu, mu_biased=new_mu_biased, N=new_n)


@dataclass(frozen=True)
class EMANormalizer:
    """EMA mean/sigma normalizer for observations and values."""

    decay: float
    norm_dtype: torch.dtype
    eps: float = 1e-5

    def init_estimates(self, x):
        dim, dev = x.shape[-1], x.device
        # mu = 0 and sigma = 1 are a no-op until the first update.
        return dict(
            mu=torch.zeros(dim, dtype=_F32, device=dev),
            inv_sigma=torch.ones(dim, dtype=_F32, device=dev),
            sigma=torch.ones(dim, dtype=_F32, device=dev),
            mu_biased=torch.zeros(dim, dtype=_F32, device=dev),
            sigma_sq_biased=torch.zeros(dim, dtype=_F32, device=dev),
            N=torch.zeros((), dtype=torch.int32, device=dev),
        )

    def normalize(self, est, x):
        x = _as_float(x)
        out = (x - est["mu"].to(x.dtype)) * est["inv_sigma"].to(x.dtype)
        return out.to(self.norm_dtype)

    def invert(self, est, x):
        return x.to(_F32) * est["sigma"] + est["mu"]

    def init_input_stats(self, est):
        return torch.zeros_like(est["mu"]), torch.zeros_like(est["mu"])

    def update_input_stats(self, cur_stats, num_prev_updates, x):
        """Merge one batch into running (mean, var) accumulators.

        Each prior update and the new batch weigh the same, so after k
        calls the accumulators hold the moments of the union of the k
        (equal-sized) batches.
        """
        a_mean, a_var = cur_stats
        x = _as_float(x).to(_F32)
        axes = tuple(range(x.dim() - 1))
        b_mean = x.mean(dim=axes)
        b_var = torch.square(x - b_mean).mean(dim=axes)

        delta = b_mean - a_mean
        b_weight = torch.reciprocal(torch.tensor(
            float(num_prev_updates + 1), dtype=_F32, device=x.device))
        a_weight = 1 - b_weight
        ab_mean = a_mean + delta * b_weight
        ab_var = (a_weight * a_var + b_weight * b_var
                  + torch.square(delta) * a_weight * b_weight)
        return ab_mean, ab_var

    def update_estimates(self, est, input_stats):
        """Fold one (mean, var) summary into the EMA estimates (Chan's
        merge with arbitrary weights, Schubert & Gertz 2018)."""
        x_mean, x_var = input_stats
        one_minus_alpha = torch.tensor(self.decay, dtype=_F32,
                                       device=x_mean.device)
        alpha = 1 - one_minus_alpha

        mean_delta = x_mean - est["mu"]
        new_n = est["N"] + 1
        new_mu_biased = one_minus_alpha * est["mu_biased"] + alpha * x_mean
        new_sigma_sq_biased = (
            one_minus_alpha * est["sigma_sq_biased"]
            + alpha * x_var
            + (est["N"].to(_F32) / new_n.to(_F32))
            * (one_minus_alpha * alpha)
            * torch.square(mean_delta)
        )
        correction = _bias_correction(new_n, self.decay)
        new_mu = new_mu_biased * correction
        new_sigma_sq = new_sigma_sq_biased * correction
        new_inv_sigma = torch.rsqrt(torch.clamp(new_sigma_sq, min=self.eps))
        return dict(
            mu=new_mu,
            inv_sigma=new_inv_sigma,
            sigma=torch.reciprocal(new_inv_sigma),
            mu_biased=new_mu_biased,
            sigma_sq_biased=new_sigma_sq_biased,
            N=new_n,
        )

    def normalize_and_update_estimates(self, est, inputs):
        """(new estimates, ``inputs`` normalized by them)."""
        stats = self.update_input_stats(self.init_input_stats(est), 0,
                                        inputs)
        est = self.update_estimates(est, stats)
        return est, self.normalize(est, inputs)
