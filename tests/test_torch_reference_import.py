"""Upstream madrona-learn checkpoints into the port, against the JAX
package's import.

A synthetic upstream-layout tree (the JAX package's MLP + LSTM
actor-critic, 2 LSTM layers for the conversion and 1 for scoring, with
the LSTM as upstream's ``cell/OptimizedLSTMCell_<i>``: per-gate denses,
biases on the h side, every leaf random) goes through
the JAX package's ``convert_reference_params`` and the port's copy: the
results must be equal, leaf for leaf and bitwise (the conversion only
moves numbers). Loaded into the JAX model and, through
``compat/from_jax.py``, into the port's, they must score a sequence with
log-probs, entropies and values within 1e-5 (float32, summed in other
orders). ``scripts/torch_import_reference_checkpoint.py`` must read an
orbax checkpoint of the tree, bare or as a stacked population with its
observation normalizer, into the same state dict. (The script slices the
policy out before converting: both packages' converters concatenate the
gate biases along axis 0, the policy axis of a stacked tree.)
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from madrona_learn_tpu.compat.reference_import import (
    convert_reference_params as jax_convert)
from madrona_learn_tpu_torch.compat import from_jax
from madrona_learn_tpu_torch.compat.reference_import import (
    convert_reference_params)
from test_torch_models import (_jax_actor_critic, _np, _obs,
                               _torch_actor_critic)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "torch_import_reference_checkpoint",
    os.path.join(ROOT, "scripts", "torch_import_reference_checkpoint.py"))
script = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(script)

H, LAYERS, T, N = 16, 2, 6, 8
GATES = "ifgo"


def _upstream_tree(seed=0, layers=LAYERS):
    """``{'params': ...}`` in upstream's layout, every leaf random."""
    ac = _jax_actor_critic(jnp.float32, H, lstm_layers=layers)
    obs = {k: jnp.asarray(v) for k, v in
           _obs(np.random.default_rng(seed), N).items()}
    params = ac.init(random.PRNGKey(seed), random.PRNGKey(1),
                     ac.init_recurrent_state(N), obs,
                     method="rollout")["params"]
    rng = np.random.default_rng(seed + 2)
    params = jax.tree.map(lambda x: rng.normal(
        scale=0.3, size=x.shape).astype(np.float32), params)
    rnn = params["backbone"]["encoder"]["rnn"]
    cells = {}
    for i in range(layers):
        in_features = rnn[f"layer_{i}"]["input_proj"]["kernel"].shape[0]
        cell = {}
        for g in GATES:
            cell[f"i{g}"] = {"kernel": rng.normal(
                scale=0.3, size=(in_features, H)).astype(np.float32)}
            cell[f"h{g}"] = {
                "kernel": rng.normal(scale=0.3, size=(H, H)).astype(
                    np.float32),
                "bias": rng.normal(scale=0.3, size=(H,)).astype(np.float32)}
        cells[f"OptimizedLSTMCell_{i}"] = cell
    params["backbone"]["encoder"]["rnn"] = {"cell": cells}
    return {"params": params}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def _assert_trees_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert got[path].dtype == w.dtype, path
        np.testing.assert_array_equal(got[path], w, err_msg=path)


def test_conversion_equals_jax_bitwise():
    tree = _upstream_tree()
    got = convert_reference_params(tree)
    _assert_trees_equal(got, jax_convert(tree))
    layer = got["params"]["backbone"]["encoder"]["rnn"]["layer_1"]
    cell = tree["params"]["backbone"]["encoder"]["rnn"]["cell"][
        "OptimizedLSTMCell_1"]
    assert layer["input_proj"]["kernel"].shape == (H, 4 * H)
    np.testing.assert_array_equal(layer["bias"][2 * H:3 * H],
                                  cell["hg"]["bias"])


def test_pre_restructure_layout_and_input_bias():
    """The JAX package's own pre-restructure ``cell/layer_<i>`` converts
    the same way; an input-side bias is refused by both."""
    tree = _upstream_tree(seed=4)
    rnn = tree["params"]["backbone"]["encoder"]["rnn"]
    rnn["cell"] = {k.replace("OptimizedLSTMCell_", "layer_"): v
                   for k, v in rnn["cell"].items()}
    _assert_trees_equal(convert_reference_params(tree), jax_convert(tree))

    rnn["cell"]["layer_0"]["if"]["bias"] = np.zeros(H, np.float32)
    with pytest.raises(ValueError, match="input-dense bias"):
        convert_reference_params(tree)
    with pytest.raises(ValueError, match="input-dense bias"):
        jax_convert(tree)


def test_scored_sequence_matches_jax():
    tree = _upstream_tree(seed=1, layers=1)
    ac_j = _jax_actor_critic(jnp.float32, H)
    ac_t = _torch_actor_critic(torch.float32, H)
    ac_t.load_state_dict({
        k: torch.from_numpy(v) for k, v in from_jax.actor_critic_state_dict(
            convert_reference_params(tree)).items()})

    rng = np.random.default_rng(5)
    obs = _obs(rng, T, N)
    breaks = rng.random((T, N, 1)) < 0.2
    actions = rng.integers(0, 5, size=(T, N, 1)).astype(np.int32)
    c0 = rng.normal(size=(N, 1, H)).astype(np.float32)
    h0 = rng.normal(size=(N, 1, H)).astype(np.float32)

    out_j = ac_j.apply(jax_convert(tree),
                       (jnp.asarray(c0), jnp.asarray(h0)),
                       jnp.asarray(breaks), {"move": jnp.asarray(actions)},
                       {k: jnp.asarray(v) for k, v in obs.items()},
                       method="update")
    with torch.no_grad():
        out_t = ac_t.update((torch.from_numpy(c0), torch.from_numpy(h0)),
                            torch.from_numpy(breaks),
                            {"move": torch.from_numpy(actions)},
                            {k: torch.from_numpy(v) for k, v in obs.items()})
    for key in ("log_probs", "entropies"):
        np.testing.assert_allclose(_np(out_t[key]["move"]),
                                   np.asarray(out_j[key]["move"]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    np.testing.assert_allclose(_np(out_t["critic"]),
                               np.asarray(out_j["critic"]),
                               rtol=1e-5, atol=1e-5)


def _state_dict_equal(got, want):
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        np.testing.assert_array_equal(got[name].numpy(), w, err_msg=name)


def test_import_script_reads_orbax_checkpoints(tmp_path):
    import orbax.checkpoint as ocp

    tree = _upstream_tree(seed=2)
    want = from_jax.actor_critic_state_dict(jax_convert(tree))

    src = str(tmp_path / "variables")
    ocp.PyTreeCheckpointer().save(src, tree)
    dst = str(tmp_path / "policy.pt")
    script.main([src, dst])
    entry = torch.load(dst, weights_only=True)
    _state_dict_equal(entry["actor_critic"], want)
    assert entry["obs_preprocess_state"] is None

    # A stacked population with its EMA normalizer state: policy 1.
    other = _upstream_tree(seed=3)
    stacked = jax.tree.map(lambda a, b: np.stack([a, b]), tree["params"],
                           other["params"])
    rng = np.random.default_rng(9)
    ema = {"delta": {name: rng.normal(size=(2, 2)).astype(np.float32)
                     for name in ("mu", "inv_sigma", "sigma", "mu_biased",
                                  "sigma_sq_biased")}}
    ema["delta"]["N"] = np.array([3, 4], np.int32)
    pop = {"policy_states": {"params": stacked,
                             "obs_preprocess_state": ema}}
    src = str(tmp_path / "population")
    ocp.PyTreeCheckpointer().save(src, pop)
    script.main([src, dst, "--policy", "1"])
    entry = torch.load(dst, weights_only=True)
    _state_dict_equal(entry["actor_critic"],
                      from_jax.actor_critic_state_dict(jax_convert(other)))
    for name, values in ema["delta"].items():
        np.testing.assert_array_equal(
            entry["obs_preprocess_state"]["delta"][name].numpy(), values[1],
            err_msg=name)
