"""The port's named profiling ranges and its run-long profiler.

One tiny update of a single-policy trainer and one of a population run
under a CPU ``torch.profiler``: every range of the JAX package's update
(``train.py``, ``rollouts.py``, ``ppo.py``, ``models/actor_critic.py``)
that the port has a counterpart of must appear, under JAX's name and with
the nesting JAX gives it; ``profile.disable()`` must remove them all; no
NVTX call may be made on the CPU; and ``init_training(profile_dir=...)``
must write a trace holding the ranges when ``stop_training`` is called.
"""

import json

import pytest
import torch

import madrona_learn_tpu_torch as mlt
from madrona_learn_tpu_torch.utils.profile import Profiler, profile
from test_torch_checkpoint import pbt_trainer, single_trainer

# The JAX package's scope names with a counterpart in the port.
UPDATE_RANGES = {
    "Update Iter", "Collect Rollouts", "Update Observations Stats",
    "Learn", "Policy Inference", "Obs Preprocess", "Policy Apply",
    "Rollout Step", "Sim Step", "Pre Step Rollout Store",
    "Post Step Rollout Store", "Cache RNN state", "Bootstrap Values",
    "Finalize Rollouts", "AC Forward", "Optimize", "Record Metrics",
    "Compute Minibatch Indices", "Gather Minibatch", "Metrics Callback",
    "rnn.fwd_sequence"}
# Only the matchmade (population) rollout reorders rows.
POPULATION_RANGES = {"Reorder To Policy", "Reorder To Sim",
                     "Compute Reorder State", "Matchmaking"}
# (range, the range JAX nests it in)
NESTING = [("Collect Rollouts", "Update Iter"), ("Learn", "Update Iter"),
           ("Policy Apply", "Policy Inference"),
           ("Sim Step", "Rollout Step"),
           ("Post Step Rollout Store", "Rollout Step"),
           ("Finalize Rollouts", "Collect Rollouts"),
           ("AC Forward", "Optimize"), ("Optimize", "Learn"),
           ("rnn.fwd_sequence", "AC Forward")]


def _traced(mgr):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        mgr.update_iter()
    return prof.events()


def _names(events):
    return {e.name for e in events}


def _parents(event):
    while event.cpu_parent is not None:
        event = event.cpu_parent
        yield event.name


@pytest.fixture(autouse=True)
def enabled_ranges():
    profile.enable()
    yield
    profile.enable()


@pytest.mark.parametrize("trainer", ["single", "pbt"])
def test_ranges_appear_under_jax_names(trainer, monkeypatch):
    def no_nvtx(*args):
        raise AssertionError("an NVTX call on the CPU")

    monkeypatch.setattr(torch.cuda.nvtx, "range_push", no_nvtx)
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", no_nvtx)
    mgr = (single_trainer if trainer == "single" else pbt_trainer)()
    mgr.update_iter()
    events = _traced(mgr)
    expected = UPDATE_RANGES | (POPULATION_RANGES if trainer == "pbt"
                                else set())
    assert expected <= _names(events)
    if trainer == "single":
        assert not POPULATION_RANGES & _names(events)
    for child, parent in NESTING:
        for e in events:
            if e.name == child:
                assert parent in set(_parents(e)), (child, parent)


def test_disable_removes_the_ranges():
    mgr = single_trainer()
    mgr.update_iter()
    profile.disable()
    names = _names(_traced(mgr))
    assert not (UPDATE_RANGES | POPULATION_RANGES) & names
    profile.enable()
    assert UPDATE_RANGES <= _names(_traced(mgr))


def test_ranges_record_only_under_a_profiler(monkeypatch):
    """With no profiler active a range enters no ``record_function``."""
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name))
    with Profiler()("Learn"):
        pass
    assert entered == []


def test_profile_dir_writes_a_trace_at_stop(tmp_path):
    from test_torch_checkpoint import W
    from madrona_learn_tpu_torch.envs import ToyEnvConfig, make_toy_env

    base = single_trainer()
    policy = mlt.Policy(base.state.policy_states.actor_critic,
                        mlt.ObservationsEMANormalizer.create(
                            decay=0.99999, dtype=torch.float32))
    env = make_toy_env(ToyEnvConfig(num_worlds=W, episode_len=5,
                                    grid_size=5), device="cpu")
    mgr = mlt.init_training("cpu", base.cfg, env, policy,
                            torch.zeros((1,), dtype=torch.int32),
                            profile_dir=str(tmp_path / "prof"))
    mgr.update_iter()
    path = mlt.stop_training(mgr)
    assert path == str(tmp_path / "prof" / "trace.json")
    with open(path) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert UPDATE_RANGES <= names
    assert mlt.stop_training(mgr) is None
    assert not torch.autograd._profiler_enabled()
