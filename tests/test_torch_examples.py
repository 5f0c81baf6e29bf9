"""The port's example entry points and its public names.

Each example's ``main()`` runs a couple of updates on ``--device cpu`` at
a tiny size: ``torch_train_toy.py`` writes TensorBoard events (read back
by the port's reader, every CRC checked) and a checkpoint,
``torch_evaluate.py`` evaluates that checkpoint, and ``torch_train_pbt.py``
runs a tournament and a population update. The port's ``__all__`` must
cover the JAX package's, apart from the names documented as not ported.
"""

import importlib.util
import os
import sys

import torch

import madrona_learn_tpu
import madrona_learn_tpu_torch
from madrona_learn_tpu_torch.utils.tensorboard import read_events

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
# XLA's ahead-of-time compile and memory settings, the mesh (the
# multi-device slice) and the tournament's compile warm-up: ROADMAP lists
# why each is not ported.
NOT_PORTED = {"aot_compile", "cfg_jax_mem", "MeshConfig",
              "eval_elo_warmup", "join_warmup_threads"}


def _example(name):
    sys.path.insert(0, EXAMPLES)
    try:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(EXAMPLES, f"{name}.py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.path.remove(EXAMPLES)
    return module


def test_train_toy_then_evaluate(tmp_path, capsys):
    mgr = _example("torch_train_toy").main([
        "--num-updates", "2", "--num-worlds", "16", "--device", "cpu",
        "--tb-dir", str(tmp_path / "tb"), "--ckpt-dir",
        str(tmp_path / "ckpt")])
    assert mgr.update_idx == 2
    out = capsys.readouterr().out
    assert "update 2: mean reward" in out and "env-steps/s on cpu" in out

    (name,) = os.listdir(tmp_path / "tb")
    events = read_events(str(tmp_path / "tb" / name))
    tags = {v["tag"] for e in events[1:] for v in e["values"]}
    assert {"p0/Rewards Mean", "p0/Env Returns sigma",
            "p0/Loss Max"} <= tags
    assert {e["step"] for e in events[1:]} == set(range(1, 11))
    assert os.path.isfile(tmp_path / "ckpt" / "2")

    totals = _example("torch_evaluate").main([
        "--ckpt", str(tmp_path / "ckpt" / "2"), "--num-worlds", "8",
        "--eval-steps", "45", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "loaded 1 policies" in out and "eval: 360 agent-steps" in out
    # Every world's 40-step episode ends once in 45 steps.
    assert totals["episodes"] == 8


def test_train_pbt(capsys):
    mgr = _example("torch_train_pbt").main([
        "--num-updates", "2", "--num-worlds", "64", "--eval-interval", "2",
        "--device", "cpu"])
    out = capsys.readouterr().out
    assert "update 2: elos=" in out and out.rstrip().endswith("done")
    elo = mgr.state.policy_states.mmr.elo
    assert elo.shape == (6,) and float(elo[0]) == 1500.0
    assert bool(torch.isfinite(elo).all())


def test_exports_cover_jax():
    port, jax_names = (set(madrona_learn_tpu_torch.__all__),
                       set(madrona_learn_tpu.__all__))
    assert jax_names - port == NOT_PORTED
    for name in port:
        assert getattr(madrona_learn_tpu_torch, name) is not None, name
