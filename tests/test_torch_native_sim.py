"""The port's native-simulator entry point against the JAX package's.

Both packages drive the same C++ library (``native/batch_sim.cpp``): the
JAX package through ``jax.pure_callback``, the port by calling it directly.
Fed the same numpy-seeded actions and resets, they must agree bitwise. A
short CPU training run checks that the trainer runs on it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import madrona_learn_tpu.envs.native_sim as jax_native_sim
import madrona_learn_tpu_torch as tlt
from madrona_learn_tpu_torch.envs import NativeSimConfig, make_native_sim
from madrona_learn_tpu_torch.envs import native_sim as port_native_sim
from test_torch_fused_trunk import _torch_fused_actor_critic

torch.set_num_threads(1)

CFG = dict(num_worlds=96, episode_len=7, grid_size=6, seed=4)


def _assert_tree_equal(got, want, path=""):
    if hasattr(want, "items"):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}/{k}")
        return
    g = got.numpy()
    w = np.asarray(want)
    assert g.dtype == w.dtype and g.shape == w.shape, (path, g.dtype, w.dtype)
    np.testing.assert_array_equal(g, w, err_msg=path)


@pytest.fixture
def jax_make(monkeypatch):
    """The JAX package's make_native_sim. It loads native/libbatch_sim.so
    and runs make where that is missing; it gets the port's build of the
    same source with the Makefile's flags instead, so that no two test
    processes run make at once."""
    monkeypatch.setattr(jax_native_sim, "_LIB_PATH",
                        str(port_native_sim.build()))
    monkeypatch.setattr(jax_native_sim, "_lib", None)
    return jax_native_sim.make_native_sim


def test_native_sim_matches_jax_bitwise(jax_make):
    n, steps, reset_step = CFG["num_worlds"], 20, 9
    jax_sim = jax_make(jax_native_sim.NativeSimConfig(**CFG))
    sim = make_native_sim(NativeSimConfig(**CFG), device="cpu")
    jax_out = jax_sim["init"]()
    out = sim["init"]()
    _assert_tree_equal(out, jax_out)

    jax_step = jax.jit(jax_sim["step"])
    rng = np.random.default_rng(0)
    saw_done = False
    for step in range(steps):
        actions = rng.integers(0, 5, size=(n, 1)).astype(np.int32)
        resets = np.full((n, 1), int(step == reset_step), np.int32)
        jax_out = jax_step({
            "state": jax_out["state"],
            "actions": {"move": jnp.asarray(actions)},
            "resets": jnp.asarray(resets),
            "sim_ctrl": jnp.zeros((1,), jnp.int32), "pbt": {}})
        out = sim["step"]({
            "state": out["state"],
            "actions": {"move": torch.from_numpy(actions)},
            "resets": torch.from_numpy(resets),
            "sim_ctrl": torch.zeros((1,), dtype=torch.int32), "pbt": {}})
        _assert_tree_equal(out, jax_out)
        if step == reset_step:
            assert bool(out["dones"].all())
        saw_done |= bool(out["dones"].any())
    assert saw_done


def test_trains_on_native_sim():
    """Two updates of the fused-trunk model over the native sim on the CPU:
    finite losses and metrics."""
    W = 32
    cfg = tlt.TrainConfig(
        num_worlds=W, num_agents_per_world=1,
        actions={"move": tlt.DiscreteActionsConfig(actions_num_buckets=[5])},
        steps_per_update=8, num_bptt_chunks=2, lr=1e-3, gamma=0.95,
        gae_lambda=0.95, seed=5, metrics_buffer_size=1,
        algo=tlt.PPOConfig(num_epochs=1, minibatch_size=2 * W,
                           clip_coef=0.2, value_loss_coef=0.5,
                           entropy_coef=0.01, max_grad_norm=0.5),
        dreamer_v3_critic=False)
    policy = tlt.Policy(_torch_fused_actor_critic(),
                        tlt.ObservationsEMANormalizer.create(
                            decay=0.99999, dtype=torch.float32))
    sim = make_native_sim(NativeSimConfig(num_worlds=W, episode_len=10,
                                          grid_size=5, seed=5), device="cpu")
    mgr = tlt.init_training("cpu", cfg, sim, policy,
                            torch.zeros((1,), dtype=torch.int32))
    for _ in range(2):
        mgr.update_iter()
        assert torch.isfinite(mgr.first_minibatch_stats["loss"]).all()
        for name, metric in mgr.metrics.metrics.items():
            assert torch.isfinite(metric.mean).all(), name
