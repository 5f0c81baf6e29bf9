"""The port's sim <-> policy-chunk reorder against the JAX package's.

``compute_reorder_chunks`` must give the JAX package's indices bitwise, on
the counting-sort branch (P <= 64) and the argsort branch (P > 64), for the
cases of ``tests/test_reorder.py`` and a hypothesis fuzz;
``PolicyBatchReorderState``'s ``to_policy`` then ``to_sim`` must give back
the assignments and any payload, with every chunk policy-pure. The
rollout's per-policy rows (``rollouts._PolicyRows``, a stable sort) must be
each policy's full chunks joined to its partial chunk, and map back to sim
order.
"""

from types import SimpleNamespace


import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from madrona_learn_tpu.ops.reorder import (
    compute_reorder_chunks as jax_compute_reorder_chunks)
from madrona_learn_tpu_torch.ops.reorder import (
    PolicyBatchReorderState,
    compute_reorder_chunks,
)
from madrona_learn_tpu_torch.rollouts import _PolicyRows


def _num_chunks(N, P, C):
    return -(N // -C) + P - 1


def check(assignments, P, C, payload=None):
    """Bitwise equal to JAX, a round trip and policy-pure chunks."""
    assignments = np.asarray(assignments, np.int32)
    N = assignments.shape[0]
    B = _num_chunks(N, P, C)
    want = jax_compute_reorder_chunks(jnp.asarray(assignments), P, C, B)
    t_assign = torch.from_numpy(assignments)
    got = compute_reorder_chunks(t_assign, P, C, B)
    for name, g, w in zip(("to_policy_idxs", "to_sim_idxs"), got, want):
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    state = PolicyBatchReorderState(to_policy_idxs=got[0],
                                    to_sim_idxs=got[1], policy_dims=(P, C),
                                    sim_dims=(N,))
    chunked = state.to_policy(t_assign)
    np.testing.assert_array_equal(state.to_sim(chunked).numpy(),
                                  assignments)
    for row, vals in zip(got[0].numpy(), chunked.numpy()):
        if (row < N).any():
            assert len(np.unique(vals)) == 1, "a chunk mixes policies"
    if payload is not None:
        payload = torch.from_numpy(payload)
        np.testing.assert_array_equal(
            state.to_sim(state.to_policy(payload)).numpy(), payload.numpy())


CASES = {
    "even": (np.repeat(np.arange(4), 4), 4, 4),
    "uneven_with_empty_policy": (
        np.array([0, 0, 0, 0, 0, 2, 2, 3, 3, 3, 3, 3, 3, 3, 2, 0]), 4, 4),
    "all_one_policy": (np.full(20, 3), 5, 4),
    "single_agent_per_policy": (np.arange(8), 8, 4),
    # The argsort branch: more than 64 policies.
    "argsort_branch": (np.random.default_rng(3).integers(0, 70, 300), 70,
                       8),
    "argsort_branch_empty": (np.repeat([0, 5, 99], [17, 1, 40]), 100, 16),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reorder_matches_jax(case):
    assignments, P, C = CASES[case]
    check(assignments, P, C)


@pytest.mark.parametrize("P", [7, 65])
def test_permuted_assignments_and_payload(P):
    rng = np.random.default_rng(5)
    for _ in range(5):
        assignments = rng.integers(0, P, size=64)
        check(assignments, P, 8,
              payload=rng.normal(size=(64, 5)).astype(np.float32))


def test_simple_path_reshapes():
    """With trivial matchmaking both directions are reshapes."""
    x = torch.arange(16, dtype=torch.float32)[:, None]
    state = PolicyBatchReorderState(to_policy_idxs=None, to_sim_idxs=None,
                                    policy_dims=(2, 8), sim_dims=(16,))
    chunked = state.to_policy(x)
    assert chunked.shape == (2, 8, 1)
    np.testing.assert_array_equal(state.to_sim(chunked).numpy(), x.numpy())


@settings(max_examples=40, deadline=None)
@given(data=st.data(), P=st.sampled_from([1, 2, 5, 12, 64, 65, 90]),
       C=st.sampled_from([2, 4, 8, 16]))
def test_reorder_fuzz_matches_jax(data, P, C):
    N = data.draw(st.integers(min_value=1, max_value=96))
    assignments = data.draw(st.lists(st.integers(min_value=0,
                                                 max_value=P - 1),
                                     min_size=N, max_size=N))
    check(assignments, P, C)


def _joined_chunks(assignments, P, C):
    """Each present policy's rows of the chunk layout: its full chunks,
    then the valid rows of its reserved partial chunk."""
    to_policy, _ = compute_reorder_chunks(assignments, P, C,
                                          _num_chunks(len(assignments), P, C))
    flat = to_policy.reshape(-1).long()
    counts = torch.bincount(assignments.long(), minlength=P).tolist()
    num_full = [c // C for c in counts]
    partial_base, start, rows = sum(num_full), 0, []
    for p, count in enumerate(counts):
        if count:
            partial = (partial_base + p) * C
            rows.append((p, torch.cat([
                flat[start * C:(start + num_full[p]) * C],
                flat[partial:partial + count - num_full[p] * C]])))
        start += num_full[p]
    return rows


@pytest.mark.parametrize("case", sorted(CASES))
def test_policy_rows_join_the_chunk_layout(case):
    assignments, P, C = CASES[case]
    t_assign = torch.from_numpy(np.asarray(assignments, np.int32))
    rollout_cfg = SimpleNamespace(pbt=SimpleNamespace(
        complex_matchmaking=True, total_num_policies=P))
    batches = _PolicyRows(rollout_cfg, t_assign)
    want = _joined_chunks(t_assign, P, C)
    assert [p for p, _ in batches.rows] == [p for p, _ in want]
    for (p, got), (_, rows) in zip(batches.rows, want):
        np.testing.assert_array_equal(got.numpy(), rows.numpy(),
                                      err_msg=f"policy {p}")
    # Per-policy outputs (each row's own id) come back in sim order.
    back = batches.to_sim([batches.gather(t_assign, rows)
                           for _, rows in batches.rows])
    np.testing.assert_array_equal(back.numpy(), t_assign.numpy())
