"""``scripts/torch_population_surgery.py`` against the JAX package's
``scripts/population_surgery.py``.

The JAX population of ``tests/test_pbt_e2e.py`` (4 train and 2 past
policies) is saved with distinct Elo ratings, the best of them a past
policy's, and carried over to the port's checkpoint by
``scripts/torch_import_jax_checkpoint.py``. ``inspect`` must print the
same lines over both (the sizes, the parameter count, the Elo ranking and
the hyperparameters; every number is copied, so the text is equal) and
``best`` must pick the same train policy. ``slice`` and ``best`` must
write the port checkpoints they name, and ``inspect`` must read a
population checkpoint the port wrote itself.
"""

import argparse
import contextlib
import importlib.util
import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_learn_tpu_torch.train_state import TrainStateManager
from test_pbt_e2e import NUM_PAST, NUM_TRAIN, build_training_mgr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ELO = [1500.0, 1612.5, 1433.25, 1587.0, 1700.0, 1399.5]


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jax_surgery = _script("population_surgery")
port_surgery = _script("torch_population_surgery")
importer = _script("torch_import_jax_checkpoint")


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """(the JAX checkpoint, the port's carried-over copy)."""
    mgr = build_training_mgr(seed=41)
    ps = mgr.state.policy_states
    ps = ps.replace(mmr=ps.mmr.replace(elo=jnp.asarray(ELO, jnp.float32)))
    mgr = mgr.replace(state=mgr.state.replace(policy_states=ps))
    root = tmp_path_factory.mktemp("surgery")
    mgr.save_ckpt(str(root / "jax"))
    jax_ckpt = str(root / "jax" / "0")
    port_ckpt = str(root / "port" / "0")
    importer.convert(jax_ckpt, port_ckpt)
    return jax_ckpt, port_ckpt


def _printed(fn, *args, **kwargs):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args, **kwargs)
    return out.getvalue().splitlines()


def test_inspect_matches_jax(checkpoints):
    jax_ckpt, port_ckpt = checkpoints
    want = _printed(jax_surgery.cmd_inspect,
                    argparse.Namespace(ckpt=jax_ckpt))
    got = _printed(port_surgery.main, ["inspect", port_ckpt])
    assert got[0] == f"checkpoint: {port_ckpt}"
    # The hyperparameters come in each package's key order.
    assert got[1:4] == want[1:4]
    assert sorted(got[4:]) == sorted(want[4:])
    assert got[2] == (f"policies: {NUM_TRAIN + NUM_PAST} total = "
                      f"{NUM_TRAIN} train + {NUM_PAST} past")
    assert ("elo (desc): p4=1700.0, p1=1612.5, p3=1587.0, p0=1500.0, "
            "p2=1433.2, p5=1399.5") in got
    assert any(line.startswith("hyperparam lr: ") for line in got)


def test_best_and_slice_match_jax(checkpoints, tmp_path):
    jax_ckpt, port_ckpt = checkpoints
    want = _printed(jax_surgery.cmd_best, argparse.Namespace(
        src=jax_ckpt, dst=str(tmp_path / "jax_best"), metric="auto"))
    dst = str(tmp_path / "best")
    got = _printed(port_surgery.main, ["best", port_ckpt, dst])
    assert [line.split(" -> ")[0] for line in got] == \
        [line.split(" -> ")[0] for line in want] == \
        ["best train policy: p1 (fitness 1612.500)"]
    best = TrainStateManager.restore_host(dst)
    source = TrainStateManager.restore_host(port_ckpt)
    assert len(best["policy_states"]) == len(best["train_states"]) == 1
    assert best["population"]["mmr"]["elo"].tolist() == [ELO[1]]
    for name, tensor in best["policy_states"][0]["actor_critic"].items():
        assert torch.equal(
            tensor, source["policy_states"][1]["actor_critic"][name]), name

    sliced = str(tmp_path / "sliced")
    port_surgery.main(["slice", port_ckpt, sliced, "--train", "0,2",
                       "--past", "4"])
    out = TrainStateManager.restore_host(sliced)
    assert (len(out["policy_states"]), len(out["train_states"])) == (3, 2)
    assert out["population"]["mmr"]["elo"].tolist() == \
        [ELO[0], ELO[2], ELO[4]]

    with pytest.raises(SystemExit, match="episode-score"):
        port_surgery.main(["best", port_ckpt, dst, "--metric", "score"])


def test_inspect_reads_a_port_population(tmp_path):
    """A population checkpoint the port wrote: its own sizes, Elo and
    learning rates."""
    from test_torch_checkpoint import NUM_PAST as PAST, NUM_TRAIN as TRAIN
    from test_torch_checkpoint import pbt_trainer

    mgr = pbt_trainer()
    mgr.save_ckpt(str(tmp_path))
    lines = _printed(port_surgery.main, ["inspect", str(tmp_path / "0")])
    assert lines[2] == (f"policies: {TRAIN + PAST} total = {TRAIN} train "
                        f"+ {PAST} past")
    params = sum(p.numel() for p in
                 mgr.state.policy_states[0].actor_critic.state_dict()
                 .values())
    assert lines[3].startswith(f"params/policy: {params:,} across ")
    assert lines[4] == "elo (desc): " + ", ".join(
        f"p{i}=1500.0" for i in range(TRAIN + PAST))
    lrs = [float(ts.hyper_params.lr) for ts in mgr.state.train_states]
    assert f"hyperparam lr: {', '.join(f'{x:.3e}' for x in lrs)}" in lines
    assert np.unique(lrs).size == TRAIN
