"""Policy-batched forms of the GRU and of the distributional critics: their
populations collect in the policy-chunk layout and learn one PPO step a
minibatch over every train policy, as JAX ``vmap``s them.

- The distributional critics (``DreamerV3Critic``, ``HLGaussCritic``,
  ``HLGaussTwoPartCritic``): ``chunked`` over shuffled chunks and
  ``batched`` over policies equal each policy's own forward (logits and
  mean within 1e-6: ``grouped_matmul``'s and ``torch.bmm``'s f32 sums run
  in another order than the single product's), over the shared bins.
- A population of each model (MLP 32 -> GRU 128; MLP 32 -> LSTM 32 with
  each distributional critic) collects through the chunked path as
  through the per-policy loop (``test_torch_chunk_layout``'s check, under
  matchmaking and a static tournament with custom rows) and learns on the
  batched path as on the loop (``test_torch_batched_learn``'s check);
  the GRU's one-tensor state also in chunk order across steps
  (``chunkwise_rnn``), bitwise the sim-order carry.
  The GRU is 128 wide, a width the chunk-indexed GRU kernels take
  (``gru_supported``); a GRU of another width takes their plain twins
  (``test_torch_widths.py``).
"""

import dataclasses
import types

import pytest
import torch

import madrona_learn_tpu_torch as tlt
import madrona_learn_tpu_torch.models as tm
import test_torch_batched_learn as batched_learn
import test_torch_chunk_layout as chunk_layout
from madrona_learn_tpu_torch.models.common import StackedParams
from madrona_learn_tpu_torch.ops.dists import critic_parts

torch.set_num_threads(1)

F32 = torch.float32
H, GRU_H = 32, 128
CRITICS = {
    "dreamer": lambda width: tm.DreamerV3Critic(width, F32),
    "hlgauss": lambda width: tm.HLGaussCritic.create(width, F32),
    "hlgauss_two_part": lambda width: tm.HLGaussTwoPartCritic.create(
        width, F32),
}
KINDS = ("gru", *CRITICS)


def _critic(kind, width, generator=None):
    """A distributional critic whose zero-init heads are drawn at scale 0.1
    (from ``generator``, or torch's global generator), so that its values
    differ between rows and policies. The two-hot head's bins reach 1.2e6:
    its bias falls off as -|i - 31| from the middle bin (as
    ``test_torch_flagship`` sets it), which keeps its values near the
    returns."""
    critic = CRITICS[kind](width)
    with torch.no_grad():
        for p in critic.parameters():
            p.copy_(0.1 * torch.randn(p.shape, generator=generator))
        if kind == "dreamer":
            bins = critic.Dense_0.bias.shape[0]
            critic.Dense_0.bias.sub_(
                (torch.arange(bins) - bins // 2).abs().float())
    return critic


def _zoo_model(kind, generator=None):
    """MLP 32 -> GRU 128 with the dense critic, or MLP 32 -> LSTM 32 with
    the distributional critic ``kind``."""
    net = tm.MLP(2, H, 1, F32, generator=generator)
    width = GRU_H if kind == "gru" else H
    rnn = (tm.GRU(H, GRU_H, 1, F32, generator=generator) if kind == "gru"
           else tm.LSTM(H, H, 1, F32, generator=generator))
    return tm.ActorCritic(
        backbone=tm.BackboneShared(
            prefix=lambda obs: torch.cat([obs["time"], obs["acc"]], -1),
            encoder=tm.RecurrentBackboneEncoder(net=net, rnn=rnn)),
        actor=tm.DictActor({"move": tm.DenseLayerDiscreteActor(
            tlt.DiscreteActionsConfig(actions_num_buckets=[5]), width, F32,
            weight_init=tm.common.orthogonal(1.0), generator=generator)}),
        critic=(tm.DenseLayerCritic(width, F32, generator=generator)
                if kind == "gru" else _critic(kind, width, generator)))


def _logits(dist):
    """A critic output's logits, the two-part critic's concatenated."""
    tensors, _ = critic_parts(dist)
    return torch.cat(tensors, -1) if isinstance(tensors, tuple) else tensors


@pytest.mark.parametrize("kind", sorted(CRITICS))
def test_critic_batched_forms_equal_each_policys_forward(kind):
    """``chunked`` over 5 chunks of 7 rows in a shuffled order (a policy
    with two chunks) and ``batched`` over 3 policies' rows: each chunk's /
    policy's logits and mean those of its policy's own critic, within
    1e-6; the bins are the critic's own, not stacked."""
    P, B, C = 3, 5, 7
    gen = torch.Generator().manual_seed(8)
    critics = [_critic(kind, H, gen) for _ in range(P)]
    params = StackedParams.of(critics)
    assert not any("centers" in k or "bounds" in k for k in params.leaves)
    order = [2, 0, 1, 2, 0]
    idx = torch.tensor(order, dtype=torch.int32)
    layout = types.SimpleNamespace(chunk_policy=idx, chunk_index=idx.long())
    feats = torch.randn(B, C, H, generator=gen)
    got = critics[0].chunked(params, layout, feats)
    for b, p in enumerate(order):
        want = critics[p](feats[b])
        torch.testing.assert_close(_logits(got)[b], _logits(want),
                                   rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(got.mean()[b], want.mean(), rtol=1e-6,
                                   atol=1e-6)
    feats = torch.randn(P, 11, H, generator=gen)
    got = critics[0].batched(params, feats)
    for p in range(P):
        want = critics[p](feats[p])
        torch.testing.assert_close(_logits(got)[p], _logits(want),
                                   rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(got.mean()[p], want.mean(), rtol=1e-6,
                                   atol=1e-6)
    # critic_parts rebuilds the output from its tensors, bins included.
    tensors, rebuild = critic_parts(got)
    again = rebuild(tensors)
    assert type(again) is type(got) and torch.equal(again.mean(), got.mean())


@pytest.mark.parametrize("static", [False, True], ids=["matchmade",
                                                       "custom"])
@pytest.mark.parametrize("kind", KINDS)
def test_chunked_rollout_equals_the_per_policy_loop(monkeypatch, kind,
                                                    static):
    """``test_torch_chunk_layout``'s population (policies of distinct
    weights and obs normalizers, 7 steps of the duel) with each model: the
    chunked rollout takes the layout and equals the per-policy loop step
    by step (actions, preprocessed obs and custom rows bitwise, values,
    log-probs and the recurrent state within 1e-6)."""
    monkeypatch.setattr(chunk_layout, "_model", lambda lstm, seed: _zoo_model(
        kind, torch.Generator().manual_seed(seed)))
    chunk_layout.test_chunked_rollout_equals_the_per_policy_loop(True,
                                                                 static)


@pytest.mark.parametrize("kind", KINDS)
def test_batched_learn_equals_the_per_policy_loop(monkeypatch, kind):
    """``test_torch_batched_learn``'s population (4 train and 2 past
    policies, two epochs of two minibatches) with each model, the
    distributional critics under their TrainConfig flags: the batched learn
    is taken and equals the per-policy loop (parameters, Adam state,
    first-minibatch stats and metrics, that test's tolerances)."""
    make_cfg = batched_learn._cfg
    monkeypatch.setattr(batched_learn, "_actor_critic",
                        lambda p, tower="lstm", dtype=F32: _zoo_model(kind))
    monkeypatch.setattr(batched_learn, "_cfg", lambda variant, tower="lstm":
                        dataclasses.replace(
                            make_cfg(variant, tower),
                            dreamer_v3_critic=kind == "dreamer",
                            hlgauss_critic=kind.startswith("hlgauss")))
    batched_learn.test_batched_learn_equals_the_per_policy_loop("uniform")


@pytest.mark.parametrize("static", [False, True], ids=["matchmade",
                                                       "custom"])
def test_gru_chunkwise_rnn_is_bitwise_the_sim_order_carry(monkeypatch,
                                                          static):
    """The GRU's one-tensor state kept in chunk order across steps
    (``chunkwise_rnn``, joined across layouts by ``_chunk_remap``) gives
    bitwise the outputs of the sim-order carry
    (``test_torch_chunk_layout``'s check)."""
    monkeypatch.setattr(chunk_layout, "_model", lambda lstm, seed: _zoo_model(
        "gru", torch.Generator().manual_seed(seed)))
    chunk_layout.test_chunkwise_rnn_is_bitwise_the_sim_order_carry(static)
