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

``preprocess_chunked`` is the policy-batched ``preprocess`` of a
population's chunks: each chunk's state is gathered by its policy from the
``[P, ...]`` stacks of ``stack_states`` and broadcast over its rows.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from .ops.ema import EMANormalizer
from .utils import profile, tree_map

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

    @staticmethod
    def stack_states(states):
        """A population's states (a list, one a policy) as ``[P, ...]``
        stacks, leaf by leaf; stateless keys stay ``None``."""
        return tree_map(lambda *xs: None if xs[0] is None
                        else torch.stack(xs), *states)

    def preprocess_chunked(self, stacked_states, obs, layout):
        """``preprocess`` over chunk-order ``obs`` [B, C, ...], chunk b
        with policy ``layout.chunk_policy[b]``'s state."""
        def per_chunk(state, ob):
            def gather(x):
                if x is None:
                    return None
                with profile("Gather Chunk Weights"):
                    x = x[layout.chunk_index]
                return x.reshape(x.shape[0], *[1] * (ob.dim() - x.dim()),
                                 *x.shape[1:])

            return tree_map(gather, state)

        return {name: self._ops(name).preprocess(
                    per_chunk(state, obs[name]), obs[name])
                for name, state in stacked_states.items()}

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
class ObservationsCaster(ObservationsPreprocess):
    """Cast every obs entry to one dtype (e.g. float32 obs -> float16)."""

    dtype: torch.dtype

    @staticmethod
    def create(dtype: torch.dtype):
        return ObservationsCaster(dtype=dtype)

    def _ops(self, ob_name):
        return KeyOps(preprocess=lambda state, ob: ob.to(self.dtype))


@dataclass(frozen=True)
class ObservationsPreprocessNoop(ObservationsPreprocess):
    @staticmethod
    def create():
        return ObservationsPreprocessNoop()
