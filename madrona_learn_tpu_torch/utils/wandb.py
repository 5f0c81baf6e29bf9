"""Weights & Biases mirror of the TensorBoard writer (JAX:
madrona_learn_tpu/utils/wandb.py). Requires the optional ``wandb``
package, imported when a writer is made."""

from __future__ import annotations

from .tensorboard import TensorboardWriter


class WandbWriter(TensorboardWriter):
    def __init__(self, logdir: str, config=None, **wandb_kwargs):
        import wandb

        wandb.init(sync_tensorboard=True, config=config, **wandb_kwargs)
        super().__init__(logdir)
        self._wandb = wandb

    def scalar(self, tag: str, value, step: int):
        super().scalar(tag, value, step)
        self._wandb.log({tag: float(value)}, step=int(step))
