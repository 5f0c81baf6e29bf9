"""Dynamic loss scaling for float16 training (JAX: flax's
``flax.training.dynamic_scale.DynamicScale``, which the JAX package's
train state holds when ``compute_dtype`` is float16).

flax's rules, written out exactly (``torch.amp.GradScaler`` grows, backs off
and counts by other rules):

- the scale starts at 2^16;
- the loss is multiplied by ``scale`` before autograd; the gradients are
  cast to float32 and divided by ``scale``;
- a step is finite when every gradient element is;
- ``grow`` is ``fin_steps == growth_interval``; a finite step with ``grow``
  doubles the scale (capped at float32's largest value); a non-finite step
  halves it (floored at float32's smallest normal value);
- ``fin_steps`` goes back to 0 after ``grow`` or a non-finite step and
  counts up otherwise.

The state is a dict of two device tensors, ``scale`` (float32) and
``fin_steps`` (int32), so a step needs no host synchronization; the caller
keeps or reverts its parameter update with ``torch.where`` on the
returned ``finite``.

A population's batched learn keeps one scaler a train policy (JAX
``vmap``s the scaled update over the policies): ``scale`` and
``fin_steps`` stacked as ``[P]``, and ``unscale_stacked`` takes the
``[P, ...]`` gradients of the sum of each policy's scaled loss, each row
divided by its own scale, a ``[P]`` finite test and each row's state
stepped by the same rule; every row is bitwise what ``unscale`` gives
that policy alone.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

_F32 = torch.float32

# flax's defaults, which the JAX package's train state keeps.
_GROWTH_FACTOR = 2.0
_BACKOFF_FACTOR = 0.5
_INIT_SCALE = 65536.0
_MINIMUM_SCALE = torch.finfo(_F32).tiny


@dataclass(frozen=True)
class DynamicScale:
    growth_interval: int = 2000

    def init_state(self, device) -> Dict[str, torch.Tensor]:
        return dict(
            scale=torch.tensor(_INIT_SCALE, dtype=_F32, device=device),
            fin_steps=torch.zeros((), dtype=torch.int32, device=device))

    def scale_loss(self, state, loss):
        """The loss to differentiate."""
        return state["scale"] * loss

    def unscale(self, state, grads: List[torch.Tensor]
                ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor,
                           List[torch.Tensor]]:
        """(new state, finite, float32 gradients of the unscaled loss) from
        the gradients of ``scale_loss``."""
        scale = state["scale"]
        grads = [g.to(_F32) / scale for g in grads]
        finite = torch.ones((), dtype=torch.bool, device=scale.device)
        for g in grads:
            finite = finite & torch.isfinite(g).all()
        return self._step(state, finite), finite, grads

    def unscale_stacked(self, state, grads: List[torch.Tensor]
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor,
                                   List[torch.Tensor]]:
        """``unscale`` for P policies at once: ``state`` of ``[P]``
        stacks, ``grads`` ``[P, ...]`` whose row p is the gradient of
        policy p's scaled loss; (new state, finite [P], float32 gradients
        of the unscaled losses), row p bitwise ``unscale``'s for policy
        p."""
        scale = state["scale"]
        grads = [g.to(_F32) / scale.reshape(-1, *[1] * (g.dim() - 1))
                 for g in grads]
        finite = torch.ones_like(scale, dtype=torch.bool)
        for g in grads:
            finite = finite & torch.isfinite(g).reshape(
                g.shape[0], -1).all(dim=1)
        return self._step(state, finite), finite, grads

    def _step(self, state, finite):
        """flax's rule: the next state after a step that was ``finite``
        (elementwise over stacked states)."""
        scale = state["scale"]
        grow = state["fin_steps"] == self.growth_interval
        fin_scale = torch.where(
            grow & finite,
            torch.clamp(scale * _GROWTH_FACTOR, max=torch.finfo(_F32).max),
            scale)
        inf_scale = torch.clamp(scale * _BACKOFF_FACTOR, min=_MINIMUM_SCALE)
        new_state = dict(
            scale=torch.where(finite, fin_scale, inf_scale),
            fin_steps=torch.where(grow | ~finite,
                                  torch.zeros_like(state["fin_steps"]),
                                  state["fin_steps"] + 1))
        return new_state
