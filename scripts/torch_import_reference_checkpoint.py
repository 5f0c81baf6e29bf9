#!/usr/bin/env python3
"""Carry a checkpoint of upstream madrona-learn over to the PyTorch port.

    python3 scripts/torch_import_reference_checkpoint.py SRC DST [--policy P]

SRC is an orbax checkpoint directory of upstream madrona-learn: a flax
variables tree (``{'params': ...}``), a bare params tree, or a whole
training checkpoint whose ``policy_states`` hold the stacked ``params``
(and ``obs_preprocess_state``) of a population, of which policy P
(default 0) is taken. It is read with ``orbax.checkpoint`` as host numpy
arrays; ``madrona_learn_tpu_torch.compat.reference_import
.convert_reference_params`` repacks the per-gate LSTM denses into the
packed ``(i, f, g, o)`` layer, and ``compat/from_jax.py`` renames the
parameters into the port's. DST is a ``torch.save`` file of one policy,
``{"actor_critic": state dict, "obs_preprocess_state": ... or None}``,
the form of an entry of the port's checkpoint ``policy_states``:
``actor_critic.load_state_dict(torch.load(DST)["actor_critic"])`` loads
it into the matching port model.

It runs where ``orbax`` is installed, not on the card, and imports
neither the JAX package nor upstream.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))


def convert_tree(tree, policy: int = 0):
    """An upstream tree (host numpy) -> the port's policy entry, as numpy
    arrays."""
    from madrona_learn_tpu_torch.compat import from_jax
    from madrona_learn_tpu_torch.compat.reference_import import (
        convert_reference_params)

    # One policy's tree first: the converter packs the gate biases along
    # axis 0, which in a stacked tree is the policy axis.
    obs_state = None
    if "policy_states" in tree:
        policies = tree["policy_states"]
        params = from_jax.policy_slice(policies["params"], policy)
        if policies.get("obs_preprocess_state") is not None:
            obs_state = from_jax.obs_preprocess_state(from_jax.policy_slice(
                policies["obs_preprocess_state"], policy))
    else:
        params = tree
    return {"actor_critic": from_jax.actor_critic_state_dict(
                convert_reference_params(params)),
            "obs_preprocess_state": obs_state}


def convert(src: str, dst: str, policy: int = 0):
    """Write the port's policy file ``dst`` from the upstream checkpoint
    ``src``; returns the converted entry."""
    from madrona_learn_tpu_torch.train_state import _write
    from torch_import_jax_checkpoint import read_jax_checkpoint, to_torch

    entry = to_torch(convert_tree(read_jax_checkpoint(src), policy))
    _write(entry, dst)
    return entry


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("src", help="the upstream orbax checkpoint")
    parser.add_argument("dst", help="the port's policy file to write")
    parser.add_argument("--policy", type=int, default=0,
                        help="the policy of a stacked population to take")
    args = parser.parse_args(argv)
    entry = convert(args.src, args.dst, args.policy)
    print(f"converted {len(entry['actor_critic'])} parameter tensors: "
          f"{args.src} -> {args.dst}")


if __name__ == "__main__":
    main()
