#!/usr/bin/env python3
"""Carry a checkpoint of the JAX package over to the PyTorch port.

    python3 scripts/torch_import_jax_checkpoint.py SRC DST

SRC is a checkpoint directory that the JAX package's
``TrainingManager.save_ckpt`` wrote (``<ckpt_dir>/<update_idx>``, an orbax
PyTree checkpoint). It is read with ``orbax.checkpoint`` as host numpy
arrays, converted by ``madrona_learn_tpu_torch.compat.from_jax
.checkpoint_tree`` and written to DST as the port's checkpoint file, which
``init_training(..., restore_ckpt=DST)``, ``TrainingManager.load_ckpt`` and
``eval_load_ckpt`` read. Name DST ``<dir>/<update_idx>`` for
``latest_checkpoint`` to find it.

The parameters, Adam moments, normalizer and loss-scaler states,
hyperparameters, fitness and user state carry over exactly; each JAX PRNG
key seeds the matching torch generator, so the draws after a resume differ
from the JAX run's. The script does not import the JAX package.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402


def read_jax_checkpoint(path: str):
    """The orbax checkpoint ``path`` as a tree of host numpy arrays."""
    import jax
    import orbax.checkpoint as ocp

    path = os.path.abspath(path)
    checkpointer = ocp.PyTreeCheckpointer()
    meta = checkpointer.metadata(path).item_metadata
    restore_args = jax.tree.map(
        lambda _: ocp.RestoreArgs(restore_type=np.ndarray), meta.tree)
    return checkpointer.restore(path, restore_args=restore_args)


def to_torch(tree):
    """numpy arrays -> tensors; dicts, lists and other leaves kept."""
    import torch

    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree.copy())
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v) for v in tree)
    return tree


def convert(src: str, dst: str):
    """Write the port's checkpoint ``dst`` from the JAX checkpoint
    ``src``; returns the converted tree."""
    from madrona_learn_tpu_torch.compat.from_jax import checkpoint_tree
    from madrona_learn_tpu_torch.train_state import _write

    tree = to_torch(checkpoint_tree(read_jax_checkpoint(src)))
    _write(tree, dst)
    return tree


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("src", help="the JAX checkpoint directory")
    parser.add_argument("dst", help="the port's checkpoint file to write")
    args = parser.parse_args(argv)
    tree = convert(args.src, args.dst)
    print(f"{args.dst}: update {tree['next_update']}, "
          f"{len(tree['policy_states'])} policies, "
          f"{len(tree['train_states'])} train states")


if __name__ == "__main__":
    main()
