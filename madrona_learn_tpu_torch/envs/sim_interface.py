"""The simulator boundary contract (JAX: envs/sim_interface.py).

The trainer consumes a dict of callables (``sim_fns``) over tensors on the
training device:

- ``init() -> {'state': dict, 'obs': {name: [sim_batch, ...]}}``
- ``step({'state', 'actions': {name: [sim_batch, ...]},
          'resets': [num_worlds, 1] int32, 'sim_ctrl',
          'pbt': {'policy_assignments': [sim_batch, 1] int32}})
     -> {'state', 'obs', 'rewards': [sim_batch, 1],
         'dones': [sim_batch, 1]}``
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict


@dataclass(frozen=True)
class SimInterface:
    """Typed wrapper over the ``sim_fns`` dict (both forms are accepted)."""

    init: Callable[[], Dict[str, Any]]
    step: Callable[[Dict[str, Any]], Dict[str, Any]]

    def as_dict(self) -> Dict[str, Callable]:
        return {"init": self.init, "step": self.step}


def as_sim_fns(sim) -> Dict[str, Callable]:
    if isinstance(sim, SimInterface):
        return sim.as_dict()
    return sim
