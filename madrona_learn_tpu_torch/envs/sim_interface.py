"""The simulator boundary contract (JAX: envs/sim_interface.py).

The trainer consumes a dict of callables (``sim_fns``) over tensors on the
training device:

- ``init() -> {'state': dict, 'obs': {name: [sim_batch, ...]}}``
- ``step({'state', 'actions': {name: [sim_batch, ...]},
          'resets': [num_worlds, 1] int32, 'sim_ctrl',
          'pbt': {'policy_assignments': [sim_batch, 1] int32,
                  optional 'reward_hyper_params': [num_policies, H]}})
     -> {'state', 'obs', 'rewards': [sim_batch, 1],
         'dones': [sim_batch, 1], optional 'pbt': {'episode_results'}}``
  (a population passes its ``reward_hyper_params`` when it has them; the
  PBT path reads ``episode_results``, one row a world, for Elo and
  episode-score fitness);
- optional ``get_ckpts`` / ``load_ckpts`` for simulator-state snapshots
  (``RolloutState.get_current_checkpoints`` /
  ``load_checkpoints_into_sim``). A functional sim takes the state,
  ``get_ckpts(state) -> ckpts``, and returns both from
  ``load_ckpts(trigger, ckpts) -> {'state', 'obs'}``; a stateful engine
  takes no state, ``get_ckpts() -> ckpts``, and returns the obs alone from
  ``load_ckpts(trigger, ckpts)``. ``ckpts`` is ``[sim_batch, ...]``,
  ``trigger`` ``[sim_batch, 1]`` int32 ones.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional


@dataclass(frozen=True)
class SimInterface:
    """Typed wrapper over the ``sim_fns`` dict (both forms are accepted)."""

    init: Callable[[], Dict[str, Any]]
    step: Callable[[Dict[str, Any]], Dict[str, Any]]
    get_ckpts: Optional[Callable] = None
    load_ckpts: Optional[Callable] = None

    def as_dict(self) -> Dict[str, Callable]:
        fns = {"init": self.init, "step": self.step}
        if self.get_ckpts is not None:
            fns["get_ckpts"] = self.get_ckpts
        if self.load_ckpts is not None:
            fns["load_ckpts"] = self.load_ckpts
        return fns


def as_sim_fns(sim) -> Dict[str, Callable]:
    if isinstance(sim, SimInterface):
        return sim.as_dict()
    return sim
