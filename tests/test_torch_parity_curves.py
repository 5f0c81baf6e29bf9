"""The port's learning curves against the JAX package's recorded ones.

``scripts/torch_parity_curves.py`` trains the ``base``, ``valuenorm``,
``dreamer``, ``filter``, ``importance``, ``hlgauss`` and
``hlgauss_twopart`` configurations of ``scripts/parity_curves.py`` in the
port on the CPU (256 worlds, 150 updates, 3 seeds) and holds each final-quartile mean reward within
3 x the seed spread of ``PARITY_CURVES.json``'s. Tens of minutes of CPU
time, so it is marked slow.
"""

import importlib.util
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def _script():
    spec = importlib.util.spec_from_file_location(
        "torch_parity_curves",
        os.path.join(ROOT, "scripts", "torch_parity_curves.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.slow
def test_port_learning_curves_match_jax(tmp_path):
    out = tmp_path / "curves.json"
    run = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts",
                                      "torch_parity_curves.py"),
         "--json", str(out)], capture_output=True, text=True, timeout=3600)
    results = json.loads(out.read_text())
    assert sorted(results) == sorted(_script().CONFIGS)
    for config, r in results.items():
        assert r["within_seed_variance"], (config, r["gap"], r["spread"])
    assert run.returncode == 0, run.stdout + run.stderr


def test_compare_applies_the_parity_rule():
    """gap < 3 x max(spreads, 1e-3), and both sides learned."""
    compare = _script().compare
    ref = {"ours_final_mean": 1.0, "ours_final_std": 0.0,
           "ours_curve_mean": [0.02, 0.5], "worlds": 256}
    rising = [[0.02, 0.5, 1.0, 1.001], [0.02, 0.5, 1.0, 1.001]]
    r = compare("base", rising, ref)
    assert r["within_seed_variance"] and r["spread"] == 1e-3
    assert r["torch_final_mean"] == pytest.approx(1.001)
    assert r["gap"] == pytest.approx(0.001)
    # Off by more than 3 x the spread.
    assert not compare("base", [[0.02, 0.5, 1.0, 1.01]] * 2,
                       ref)["within_seed_variance"]
    # Level with the record but never learned from its first update.
    flat = [[0.9, 0.9, 1.0, 1.0]] * 2
    assert not compare("base", flat, ref)["within_seed_variance"]
