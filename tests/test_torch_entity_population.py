"""Policy-batched forms of the entity-attention trunk and of separate
towers: their populations collect in the policy-chunk layout and learn one
PPO step a minibatch over every train policy, as JAX ``vmap``s them.

- ``DenseGeneral`` (an input and an output projection),
  ``MultiHeadDotProductAttention``, ``SelfAttention`` and
  ``EntitySelfAttentionNet`` (with and without ``embed_concat_self``):
  ``chunked`` over shuffled chunks of 3 policies (one with two chunks, one
  with none), one chunk of index P (no policy: NaN rows, never another
  policy's numbers), and ``batched`` over
  the 3 policies, against JAX's ``jax.vmap`` of the flax module over the
  policy stack (the Pallas ``mha`` / ``mha_flash`` in interpret mode, the
  way ``tests/test_sharding.py`` routes them, in this module only) within
  1e-5, and against each policy's own port forward within 1e-6; at sets
  that pad to 16 (``mha``) and past 256 (``mha_flash``). Parameters come
  across through ``compat/from_jax.py``; LayerNorm affines and attention
  biases are moved off their init.
- A population of the entity net (embed 16, out 32, 2 heads, under an LSTM
  32 tower, with self-concatenated embeds, and feed-forward under
  ``BackboneEncoder``) and one of separate MLP 32 + LSTM 32 towers, over
  the duel's obs (the entity sets made from [time, acc] by fixed
  elementwise maps): the chunked rollout equals the per-policy loop
  (``test_torch_chunk_layout``'s check, matchmade and with custom rows),
  the batched learn equals the per-policy loop
  (``test_torch_batched_learn``'s check and tolerances), and the separate
  towers' state pair kept in chunk order (``chunkwise_rnn``) is bitwise the
  sim-order carry.
"""

import functools
import types
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from flax.core import FrozenDict
from jax import random

import madrona_learn_tpu.models as jm
import madrona_learn_tpu.models.attention as mattn
import madrona_learn_tpu.ops.pallas.attention as pattn
import madrona_learn_tpu_torch as tlt
import madrona_learn_tpu_torch.models as tm
import test_torch_batched_learn as batched_learn
import test_torch_chunk_layout as chunk_layout
from madrona_learn_tpu_torch.models.attention import (
    DenseGeneral, MultiHeadDotProductAttention)
from madrona_learn_tpu_torch.models.common import StackedParams
from test_torch_attention import _load, _perturb

torch.set_num_threads(1)

F32 = torch.float32
P = 3
# Chunk b's policy: policy 2 owns two chunks, policy 1 none, and index P
# is a chunk of no policy (a custom id's). As many valid chunks as
# policies, of as many rows as each policy has in ``batched``, so that
# JAX compiles one vmap a case.
ORDER = [2, 0, P, 2]
ROWS = 4
EMBED, OUT, HEADS, HIDDEN = 16, 32, 2, 32
# An entity net's self features and entity sets (a set's width, and its
# entity count at the two sets: 12 entities pad to 16, 262 past 256).
FEATURES = {"self": 16, "allies": 12, "enemies": 12}
SETS = {"small": dict(allies=5, enemies=6),
        "large": dict(allies=255, enemies=6)}


@pytest.fixture(scope="module")
def jax_run():
    """JAX's runs of this module, each once: ``run(case)`` memoized, with
    ``SelfAttention``'s Pallas route open and ``mha`` / ``mha_flash`` in
    interpret mode while they run (as ``tests/test_sharding.py`` routes
    them)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(mattn, "_pallas_backend_ok", lambda: True)
    for name in ("mha", "mha_flash"):
        mp.setattr(pattn, name, functools.partial(getattr(pattn, name),
                                                  interpret=True))
    yield functools.lru_cache(maxsize=None)(_jax_case)
    mp.undo()


def _pallas_attention(valid_len):
    """flax's ``attention_fn`` as JAX's ``SelfAttention`` builds it: the
    Pallas kernel by padded length, keys past ``valid_len`` masked."""
    def attention_fn(q, k, v, bias=None, mask=None, **kwargs):
        kernel = pattn.mha if q.shape[-3] <= 256 else pattn.mha_flash
        return kernel(q, k, v, valid_len=valid_len)
    return attention_fn


def _case(name):
    """(flax module, port module factory, input maker, extra args, the
    case's numpy generator); the input maker takes the leading shape."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    normal = lambda *shape: rng.normal(size=shape).astype(np.float32)
    kind, _, variant = name.partition("-")
    if kind == "dense_in":
        return (fnn.DenseGeneral((HEADS, EMBED // HEADS), dtype=jnp.float32),
                lambda: DenseGeneral(
                    (EMBED,), (HEADS, EMBED // HEADS), F32),
                lambda *lead: normal(*lead, 7, EMBED), (), rng)
    if kind == "dense_out":
        return (fnn.DenseGeneral(OUT, axis=(-2, -1), dtype=jnp.float32),
                lambda: DenseGeneral(
                    (HEADS, EMBED // HEADS), (OUT,), F32),
                lambda *lead: normal(*lead, 7, HEADS, EMBED // HEADS), (),
                rng)
    seq, valid = {"small": (16, 13), "large": (264, 258)}[variant]
    if kind == "mha":
        return (fnn.MultiHeadDotProductAttention(
                    num_heads=HEADS, qkv_features=EMBED, out_features=OUT,
                    dtype=jnp.float32,
                    attention_fn=_pallas_attention(valid)),
                lambda: MultiHeadDotProductAttention(
                    EMBED, HEADS, EMBED, OUT, F32),
                lambda *lead: normal(*lead, seq, EMBED), (valid,), rng)
    if kind == "self_attention":
        return (mattn.SelfAttention(num_heads=HEADS, qkv_features=EMBED,
                                    out_features=OUT, dtype=jnp.float32,
                                    use_pallas=True),
                lambda: tm.SelfAttention(EMBED, HEADS, EMBED, OUT, F32),
                lambda *lead: normal(*lead, valid, EMBED), (), rng)
    concat = kind == "entity_concat_self"
    sets = SETS[variant]
    return (jm.EntitySelfAttentionNet(
                num_embed_channels=EMBED, num_out_channels=OUT,
                num_heads=HEADS, dtype=jnp.float32, embed_concat_self=concat),
            lambda: tm.EntitySelfAttentionNet(FEATURES, EMBED, OUT, HEADS,
                                              F32, embed_concat_self=concat),
            lambda *lead: {"self": normal(*lead, FEATURES["self"]),
                           **{k: normal(*lead, n, FEATURES[k])
                              for k, n in sets.items()}},
            (), rng)


def _tree(fn, x):
    return {k: fn(v) for k, v in x.items()} if isinstance(x, dict) else fn(x)


def _jax_case(name):
    """A case's inputs, its P policies' flax parameters (drawn, then
    perturbed) and JAX's ``vmap`` of the module over the policy stack:
    over the chunks of a policy, each with its policy's parameters, and
    over the policies."""
    module, _, inputs, args, rng = _case(name)
    chunk_x = inputs(len(ORDER), ROWS)
    policy_x = inputs(P, ROWS)
    wrap = lambda x: (FrozenDict(_tree(jnp.asarray, x))
                      if isinstance(x, dict) else jnp.asarray(x))
    one = _tree(lambda a: a[0], chunk_x)
    train = (False,) if name.startswith("entity") else ()
    init = jax.jit(lambda key: module.init(key, wrap(one), *train))
    params = [_perturb(init(random.PRNGKey(p))["params"], rng)
              for p in range(P)]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *params)

    def apply(p, x):
        return module.apply({"params": p}, x, *train)

    valid = [b for b, p in enumerate(ORDER) if p < P]
    idx = jnp.asarray([ORDER[b] for b in valid])
    vmapped = jax.jit(jax.vmap(apply))
    chunks = vmapped(jax.tree.map(lambda a: a[idx], stacked),
                     wrap(_tree(lambda a: a[valid], chunk_x)))
    policies = vmapped(stacked, wrap(policy_x))
    return chunk_x, policy_x, params, np.asarray(chunks), \
        np.asarray(policies)


def _torch(x):
    return _tree(torch.from_numpy, x)


CASES = ["dense_in", "dense_out", "mha-small", "mha-large",
         "self_attention-small", "self_attention-large", "entity-small",
         "entity-large", "entity_concat_self-small",
         "entity_concat_self-large"]


@pytest.mark.parametrize("name", CASES)
def test_batched_forms_equal_jax_vmap_and_each_policys_forward(jax_run,
                                                               name):
    chunk_x, policy_x, params, want_chunks, want_policies = jax_run(name)
    _, make, _, args, _ = _case(name)
    modules = [_load(make(), p) for p in params]
    stacked = StackedParams.of(modules)
    idx = torch.tensor(ORDER, dtype=torch.int32)
    layout = types.SimpleNamespace(chunk_policy=idx,
                                   chunk_index=idx.clamp(max=P - 1).long())
    with torch.no_grad():
        got = modules[0].chunked(stacked, layout, _torch(chunk_x), *args)
        valid = [b for b, p in enumerate(ORDER) if p < P]
        np.testing.assert_allclose(got[valid].numpy(), want_chunks,
                                   rtol=1e-5, atol=1e-5)
        for b, p in enumerate(ORDER):
            if p == P:
                assert torch.isnan(got[b]).all(), b
                continue
            want = modules[p](_torch(_tree(lambda a: a[b], chunk_x)), *args)
            torch.testing.assert_close(got[b], want, rtol=1e-6, atol=1e-6)
        got = modules[0].batched(stacked, _torch(policy_x), *args)
        np.testing.assert_allclose(got.numpy(), want_policies, rtol=1e-5,
                                   atol=1e-5)
        for p in range(P):
            want = modules[p](_torch(_tree(lambda a: a[p], policy_x)), *args)
            torch.testing.assert_close(got[p], want, rtol=1e-6, atol=1e-6)
    # The kernel stack's [P, prod(in), prod(out)] view is kept with the
    # casts, a view of the cast stack: later calls reshape nothing.
    if name.startswith("dense"):
        matrix = modules[0].matrix
        view = stacked.casts[("kernel", F32, matrix)]
        assert view.shape == (P, *matrix)
        assert stacked.stack("kernel", F32, matrix) is view
        assert view.data_ptr() == stacked.stack("kernel", F32).data_ptr()


# -- Populations ---------------------------------------------------------------

def _entity_prefix():
    """The duel's obs f = [time, acc] as the entity sets, each leaf f_0 A_0
    + f_1 A_1 with fixed matrices from numpy's default_rng(0): self [16],
    allies [5, 12], enemies [6, 12]. Elementwise, so a row's sets do not
    depend on the rows it is batched with."""
    rng = np.random.default_rng(0)
    mats = {k: torch.from_numpy(rng.normal(size=(2, *shape))
                                .astype(np.float32))
            for k, shape in (("self", (16,)), ("allies", (5, 12)),
                             ("enemies", (6, 12)))}

    def prefix(obs):
        f = torch.cat([obs["time"], obs["acc"]], -1)
        out = {}
        for k, a in mats.items():
            fi = [f[..., i].reshape(*f.shape[:-1], *[1] * (a.dim() - 1))
                  for i in range(2)]
            out[k] = fi[0] * a[0] + fi[1] * a[1]
        return out

    return prefix


def _population_model(kind, generator=None):
    """An entity-net actor-critic ("entity": under an LSTM 32 tower;
    "entity_concat_self": with self-concatenated embeds; "entity_ff":
    feed-forward under ``BackboneEncoder``) or separate MLP 32 + LSTM 32
    towers ("separate"), over the duel's obs."""
    if kind == "separate":
        def tower():
            return tm.RecurrentBackboneEncoder(
                net=tm.MLP(2, HIDDEN, 1, F32, generator=generator),
                rnn=tm.LSTM(HIDDEN, HIDDEN, 1, F32, generator=generator))

        backbone = tm.BackboneSeparate(
            lambda obs: torch.cat([obs["time"], obs["acc"]], -1), tower(),
            tower())
    else:
        net = tm.EntitySelfAttentionNet(
            FEATURES, EMBED, OUT, HEADS, F32, generator=generator,
            embed_concat_self=kind == "entity_concat_self")
        backbone = tm.BackboneShared(
            prefix=_entity_prefix(),
            encoder=(tm.BackboneEncoder(net=net) if kind == "entity_ff" else
                     tm.RecurrentBackboneEncoder(
                         net=net, rnn=tm.LSTM(OUT, HIDDEN, 1, F32,
                                              generator=generator))))
    width = OUT if kind == "entity_ff" else HIDDEN
    return tm.ActorCritic(
        backbone=backbone,
        actor=tm.DictActor({"move": tm.DenseLayerDiscreteActor(
            tlt.DiscreteActionsConfig(actions_num_buckets=[5]), width, F32,
            weight_init=tm.common.orthogonal(1.0), generator=generator)}),
        critic=tm.DenseLayerCritic(width, F32, generator=generator))


KINDS = ("entity", "entity_concat_self", "entity_ff", "separate")


@pytest.mark.parametrize("static", [False, True], ids=["matchmade",
                                                       "custom"])
@pytest.mark.parametrize("kind", KINDS)
def test_chunked_rollout_equals_the_per_policy_loop(monkeypatch, kind,
                                                    static):
    """``test_torch_chunk_layout``'s population (policies of distinct
    weights, LayerNorm affines and obs normalizers, 7 steps of the duel)
    with each model: the chunked rollout takes the layout and equals the
    per-policy loop step by step (actions, preprocessed obs and custom rows
    bitwise, values, log-probs and every recurrent state within 1e-6)."""
    monkeypatch.setattr(chunk_layout, "_model", lambda lstm, seed:
                        _population_model(
                            kind, torch.Generator().manual_seed(seed)))
    chunk_layout.test_chunked_rollout_equals_the_per_policy_loop(True,
                                                                 static)


@pytest.mark.parametrize("kind", ("entity", "separate"))
def test_batched_learn_equals_the_per_policy_loop(monkeypatch, kind):
    """``test_torch_batched_learn``'s population (4 train and 2 past
    policies, two epochs of two minibatches) with each model: the batched
    learn is taken and equals the per-policy loop (parameters, Adam state,
    first-minibatch stats and metrics, that test's tolerances)."""
    monkeypatch.setattr(batched_learn, "_actor_critic",
                        lambda p, tower="lstm", dtype=F32:
                        _population_model(kind))
    batched_learn.test_batched_learn_equals_the_per_policy_loop("uniform")


@pytest.mark.parametrize("static", [False, True], ids=["matchmade",
                                                       "custom"])
def test_separate_chunkwise_rnn_is_bitwise_the_sim_order_carry(monkeypatch,
                                                               static):
    """The separate towers' ``(actor_state, critic_state)`` pair kept in
    chunk order across steps (``chunkwise_rnn``, joined across layouts by
    ``_chunk_remap``) gives bitwise the outputs and states of the sim-order
    carry (``test_torch_chunk_layout``'s check)."""
    monkeypatch.setattr(chunk_layout, "_model", lambda lstm, seed:
                        _population_model(
                            "separate", torch.Generator().manual_seed(seed)))
    chunk_layout.test_chunkwise_rnn_is_bitwise_the_sim_order_carry(static)
