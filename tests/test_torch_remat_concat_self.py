"""Trunk rematerialization and self-concatenated entity embeddings, on the
CPU.

- ``RecurrentBackboneEncoder(remat_trunk_sequence=True)``: the update
  pass's loss and every parameter gradient bitwise equal to the plain
  pass's, for an entity-attention trunk with ``embed_concat_self`` (the
  recomputed forward is the first one), and the rollout step untouched.
- Two ``update_iter``s of the slice's MLP + LSTM trainer with the trunk
  rematerialized in both packages (JAX: ``nn.remat``), with the slice
  test's checks and tolerances.
- ``EntitySelfAttentionNet(embed_concat_self=True)`` against flax at
  float32 (1e-5, ``test_torch_attention.py``'s), on both JAX attention
  routes (the Pallas kernel in interpret mode, and the CPU route): each
  entity set's embed reads its features followed by the self features.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import FrozenDict
from jax import random

import madrona_learn_tpu as mlt
import madrona_learn_tpu.models as jm
import madrona_learn_tpu_torch.models as tm
import test_torch_slice as slice_test
from madrona_learn_tpu_torch.compat.from_jax import actor_critic_state_dict
from madrona_learn_tpu_torch.config import DiscreteActionsConfig
from test_torch_attention import (OBS_FEATURES, _entity_obs, _perturb,
                                  jax_route)  # noqa: F401
from test_torch_models import F32, _load, _np

# Two update_iters of the rematerialized trainer, with the slice test's
# checks run against this module's fixtures.
from test_torch_slice import (  # noqa: F401
    test_gradients_and_optimizer_state_match_jax,
    test_obs_normalizer_and_metrics_match_jax,
    test_parameters_match_jax,
    test_rollout_data_matches_jax,
)

torch.set_num_threads(1)

H = slice_test.H


@pytest.mark.parametrize("embed,out", [(16, 32), (16, 16)])
def test_concat_self_entity_net_matches_flax(jax_route, embed, out):
    rng = np.random.default_rng(20 + out)
    obs = _entity_obs(rng, 10)
    net_j = jm.EntitySelfAttentionNet(num_embed_channels=embed,
                                      num_out_channels=out, num_heads=2,
                                      dtype=jnp.float32,
                                      embed_concat_self=True)
    j_obs = FrozenDict({k: jnp.asarray(v) for k, v in obs.items()})
    params = _perturb(net_j.init(random.PRNGKey(4), j_obs, False)["params"],
                      rng)
    net_t = tm.EntitySelfAttentionNet(OBS_FEATURES, embed, out, 2,
                                      torch.float32, embed_concat_self=True)
    want_shapes = {k: v.shape for k, v in
                   actor_critic_state_dict(params).items()}
    assert {k: tuple(p.shape) for k, p in net_t.named_parameters()} == \
        want_shapes
    # The entity embeds read F_e + F_self features, the self embed F_self.
    assert want_shapes["allies_embed.kernel"] == (12 + 16, embed)
    assert want_shapes["self_embed.kernel"] == (16, embed)
    _load(net_t, params)
    got = net_t({k: torch.from_numpy(v) for k, v in obs.items()})
    want = net_j.apply({"params": params}, j_obs, False)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def _flagship_tower(remat):
    return tm.ActorCritic(
        backbone=tm.BackboneShared(
            prefix=lambda obs: obs,
            encoder=tm.RecurrentBackboneEncoder(
                net=tm.EntitySelfAttentionNet(OBS_FEATURES, 16, 32, 2,
                                              torch.float32,
                                              embed_concat_self=True),
                rnn=tm.LSTM(32, H, 1, torch.float32),
                remat_trunk_sequence=remat)),
        actor=tm.DictActor({"move": tm.DenseLayerDiscreteActor(
            DiscreteActionsConfig(actions_num_buckets=[5, 3]), H,
            torch.float32)}),
        critic=tm.DenseLayerCritic(H, torch.float32))


def test_remat_gradients_are_bitwise_the_plain_ones(monkeypatch):
    torch.manual_seed(0)
    model = _flagship_tower(remat=True)
    encoder = model.backbone.encoder
    rng = np.random.default_rng(5)
    T, N = 4, 6
    obs = {k: torch.from_numpy(v) for k, v in _entity_obs(rng, T, N).items()}
    dones = torch.from_numpy(rng.random((T, N, 1)) < 0.3)
    actions = {"move": torch.from_numpy(
        rng.integers(0, 3, (T, N, 2)).astype(np.int32))}
    start = tuple(torch.from_numpy(rng.normal(size=(N, 1, H)).astype(
        np.float32)) for _ in range(2))

    import madrona_learn_tpu_torch.models.actor_critic as ac_mod

    checkpoints = []
    orig = ac_mod.torch.utils.checkpoint.checkpoint
    monkeypatch.setattr(ac_mod.torch.utils.checkpoint, "checkpoint",
                        lambda *a, **k: checkpoints.append(k)
                        or orig(*a, **k))

    def grads(remat):
        encoder.remat_trunk_sequence = remat
        out = model.update(start, dones, actions, obs)
        loss = (out["log_probs"]["move"].sum()
                + out["entropies"]["move"].sum() + out["critic"].sum())
        names, params = zip(*model.named_parameters())
        return loss, dict(zip(names, torch.autograd.grad(loss, params)))

    loss_r, g_r = grads(True)
    assert checkpoints == [{"use_reentrant": False}]
    loss_p, g_p = grads(False)
    assert len(checkpoints) == 1
    assert torch.equal(loss_r, loss_p)
    for name, g in g_p.items():
        assert torch.equal(g_r[name], g), name
    # The rollout step takes no checkpoint.
    encoder.remat_trunk_sequence = True
    with torch.no_grad():
        model.rollout(torch.Generator().manual_seed(0),
                      model.init_recurrent_state(N),
                      {k: v[0] for k, v in obs.items()})
    model.update(start, dones, actions, obs)  # under autograd: one more
    assert len(checkpoints) == 2


def _jax_remat_actor_critic():
    actions = mlt.DiscreteActionsConfig(actions_num_buckets=[5])
    return jm.ActorCritic(
        backbone=jm.BackboneShared(
            prefix=lambda obs, train: jnp.concatenate(
                [obs["delta"], obs["time"]], axis=-1),
            encoder=jm.RecurrentBackboneEncoder(
                net=jm.MLP(num_channels=H, num_layers=2, dtype=jnp.float32),
                rnn=jm.LSTM(num_hidden_channels=H, num_layers=1,
                            dtype=jnp.float32, use_pallas=True),
                remat_trunk_sequence=True)),
        actor=jm.DictActor(heads={"move": jm.DenseLayerDiscreteActor(
            cfg=actions, dtype=jnp.float32)}),
        critic=jm.DenseLayerCritic(dtype=jnp.float32))


def _torch_remat_actor_critic():
    return tm.ActorCritic(
        backbone=tm.BackboneShared(
            prefix=lambda obs: torch.cat([obs["delta"], obs["time"]], -1),
            encoder=tm.RecurrentBackboneEncoder(
                net=tm.MLP(3, H, 2, torch.float32),
                rnn=tm.LSTM(H, H, 1, torch.float32),
                remat_trunk_sequence=True)),
        actor=tm.DictActor({"move": tm.DenseLayerDiscreteActor(
            DiscreteActionsConfig(actions_num_buckets=[5]), H,
            torch.float32)}),
        critic=tm.DenseLayerCritic(H, torch.float32))


@pytest.fixture(scope="module")
def jax_run():
    return slice_test.run_jax(_jax_remat_actor_critic())


@pytest.fixture(scope="module")
def torch_run(jax_run):
    return slice_test.run_torch(jax_run, _torch_remat_actor_critic())
