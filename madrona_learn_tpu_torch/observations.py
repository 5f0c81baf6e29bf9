"""Observation preprocessing keyed on obs-dict entries (JAX:
madrona_learn_tpu/observations.py).

A preprocessor is a bundle of five per-key operations mapped over the obs
dict:

    preprocess(state, ob)                 -> network-ready ob
    init_state(ob)                        -> persistent normalizer state
    update_state(state, stats)            -> fold streamed stats into state
    init_obs_stats(state)                 -> fresh streaming accumulator
    update_obs_stats(state, stats, n, ob) -> accumulate one batch

Per-step calls only accumulate batch statistics; the EMA fold runs once per
update, so normalization stays frozen within a collect phase.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from .ops.ema import EMANormalizer

_NOOP = lambda *args: None


@dataclass(frozen=True)
class KeyOps:
    """The five per-key operations. Defaults are stateless no-ops."""

    preprocess: Callable = lambda state, ob: ob
    init_state: Callable = lambda ob: None
    update_state: Callable = _NOOP
    init_obs_stats: Callable = _NOOP
    update_obs_stats: Callable = lambda state, stats, n, ob: None


class ObservationsPreprocess:
    """Maps per-key ops over obs dicts; subclasses implement ``_ops``."""

    def _ops(self, ob_name: str) -> KeyOps:
        return KeyOps()

    def _apply(self, op_name, *trees):
        return {name: getattr(self._ops(name), op_name)(
                    *(t[name] for t in trees))
                for name in trees[0]}

    def preprocess(self, states, obs):
        return self._apply("preprocess", states, obs)

    def init_state(self, obs):
        return self._apply("init_state", obs)

    def update_state(self, states, obs_stats):
        return self._apply("update_state", states, obs_stats)

    def init_obs_stats(self, states):
        return self._apply("init_obs_stats", states)

    def update_obs_stats(self, states, cur_obs_stats, num_prev_updates, obs):
        return {name: self._ops(name).update_obs_stats(
                    states[name], cur_obs_stats[name], num_prev_updates,
                    obs[name])
                for name in states}


@dataclass(frozen=True)
class ObservationsEMANormalizer(ObservationsPreprocess):
    """Per-key EMA mean/sigma normalization."""

    normalizer: EMANormalizer

    @staticmethod
    def create(decay: float, dtype: torch.dtype, eps: float = 1e-5):
        return ObservationsEMANormalizer(
            normalizer=EMANormalizer(decay=decay, norm_dtype=dtype, eps=eps))

    def _ops(self, ob_name):
        norm = self.normalizer
        return KeyOps(
            preprocess=norm.normalize,
            init_state=norm.init_estimates,
            update_state=norm.update_estimates,
            init_obs_stats=norm.init_input_stats,
            update_obs_stats=lambda est, stats, n, ob: (
                norm.update_input_stats(stats, n, ob)),
        )


@dataclass(frozen=True)
class ObservationsPreprocessNoop(ObservationsPreprocess):
    @staticmethod
    def create():
        return ObservationsPreprocessNoop()
