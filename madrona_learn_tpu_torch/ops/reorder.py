"""Sim order <-> policy-chunk order (JAX: madrona_learn_tpu/ops/reorder.py).

During PBT rollouts every sim agent slot carries a policy assignment that
can change each step (matchmaking). ``compute_reorder_chunks`` builds the
gather indices between:

- **sim order**: the flat ``[sim_batch_size]`` layout the simulator sees;
- **policy order**: ``[num_chunks, chunk_size]``, each chunk holding agents
  of one policy only (padded; a policy may own several chunks).

Each policy first fills ``floor(count / C)`` full chunks, packed from the
front of the chunk array; then it owns one reserved partial chunk at slot
``num_full_chunks_total + policy``. So ``B = ceil(N / C) + P - 1`` chunks
hold any assignment. The indices equal the JAX package's bitwise, from the
counting sort for P <= 64 and from a stable argsort above that. The
data-sharded variant (``compute_reorder_chunks_sharded``) is not ported.

A population whose model has a policy-batched form runs in this layout
(``rollouts.chunked_rollout_loop``): each step, after matchmaking, the
rollout computes the next step's ``PolicyBatchReorderState`` on the device
(with each chunk's policy, ``chunk_policy``), gathers the obs and the
recurrent state into chunks, runs one batched pass of the policy whose
kernels (``grouped_matmul``, ``lstm_sequence_fwd_chunked``) read each
chunk's weights by its index, and gathers the outputs back to sim order.
Rows of custom policy ids (past the population) fill chunks of their own,
whose index lies outside [0, P): no weights are read for them. Other
models keep the per-policy loop (``rollouts._PolicyRows``): a policy's full
chunks joined to its partial chunk are its rows in sim order, which a
stable sort of the assignments gives directly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ..utils import tree_map

_I32 = torch.int32


def heuristic_policy_chunk_size(sim_batch_size: int,
                                total_num_policies: int,
                                min_chunk: int) -> int:
    """A power-of-two chunk size from the smallest per-policy share, in
    [64, 512], capped so the reserved partial chunks' padding stays within
    half the batch."""
    c = 1 << ((min_chunk - 1).bit_length())
    c = min(c, 512)
    c = max(c, min(64, sim_batch_size))
    pad_budget = sim_batch_size // (2 * max(total_num_policies - 1, 1))
    if pad_budget >= 1:
        c = min(c, max(64, 1 << (pad_budget.bit_length() - 1)))
    return c


def compute_reorder_chunks(assignments: torch.Tensor, P: int, C: int,
                           B: int):
    """``(to_policy_idxs [B, C], to_sim_idxs [N])``, int32, from the
    ``[N]`` policy ids in ``[0, P)``.

    ``to_policy_idxs`` gathers sim-order data into the chunk layout; empty
    slots point at the chunk's first element and fully empty chunks hold
    the sentinel ``N`` (resolved by a clipped gather). ``to_sim_idxs``
    gathers the flattened ``[B * C]`` chunk layout back to sim order.
    """
    if assignments.dim() != 1:
        raise ValueError(f"assignments must be 1-D, got "
                         f"{tuple(assignments.shape)}")
    N = assignments.shape[0]
    device = assignments.device
    policies = torch.arange(P, dtype=_I32, device=device)
    if P <= 64:
        # Counting sort: a one-hot cumsum gives each agent's rank within
        # its policy. It is laid out [P, N] so the scan runs along the
        # inner axis (the scan along the outer axis of [N, P] took 5.5 ms
        # at N = 32768, P = 12 on the H100).
        one_hot = policies[:, None] == assignments[None, :].to(_I32)
        counts = one_hot.sum(dim=1, dtype=_I32)
        ranks_all = torch.cumsum(one_hot.to(_I32), dim=1, dtype=_I32) - 1
        offsets = torch.where(one_hot, ranks_all, 0).sum(dim=0, dtype=_I32)
        owner = assignments.long()
        src_idxs = None
    else:
        src_idxs = torch.argsort(assignments, stable=True)
        owner = assignments[src_idxs].long()
        counts = torch.bincount(assignments.long(), minlength=P).to(_I32)
        starts = torch.cumsum(counts, 0, dtype=_I32) - counts
        offsets = torch.arange(N, dtype=_I32, device=device) - starts[owner]

    full_counts = (counts // C) * C
    full_cumsum = torch.cumsum(full_counts, 0, dtype=_I32)
    full_starts = full_cumsum - full_counts
    # One reserved partial chunk per policy, after all full chunks.
    partial_starts = full_cumsum[-1] + policies * C - full_counts

    in_full = offsets < full_counts[owner]
    dest = torch.where(in_full, full_starts[owner] + offsets,
                       partial_starts[owner] + offsets).long()

    if src_idxs is None:
        sources = torch.arange(N, dtype=_I32, device=device)
        to_sim_idxs = dest.to(_I32)
    else:
        sources = src_idxs.to(_I32)
        to_sim_idxs = torch.empty((N,), dtype=_I32, device=device)
        to_sim_idxs[src_idxs] = dest.to(_I32)

    to_policy_idxs = torch.full((B * C,), N, dtype=_I32, device=device)
    to_policy_idxs[dest] = sources
    to_policy_idxs = to_policy_idxs.reshape(B, C)
    # Padding slots point at the chunk's first (valid) element.
    to_policy_idxs = torch.where(to_policy_idxs != N, to_policy_idxs,
                                 to_policy_idxs[:, 0:1])
    return to_policy_idxs, to_sim_idxs


@dataclass
class PolicyBatchReorderState:
    """Gathers between sim order and policy-chunk order. With trivial
    matchmaking (pure self-play, block-constant assignments) both index
    sets are ``None`` and the transforms are reshapes. ``policy_counts``
    holds each policy's agent count ([P] int32) where the indices exist.

    The rollout's layout (``rollouts.compute_policy_chunks``) also holds
    each chunk's policy, ``chunk_policy`` [B] int32 for the kernels (a
    chunk of custom ids has the index P, outside the population) and
    ``chunk_index`` [B] int64 clamped into [0, P) for gathers of per-policy
    tensors; ``custom_rows`` [N] and ``custom_chunks`` [B] bool, the sim
    rows and the chunks of custom ids (None without them), and the
    ``assignments`` it was computed from."""

    to_policy_idxs: Optional[torch.Tensor]
    to_sim_idxs: Optional[torch.Tensor]
    policy_dims: Tuple[int, ...]
    sim_dims: Tuple[int, ...]
    policy_counts: Optional[torch.Tensor] = None
    chunk_policy: Optional[torch.Tensor] = None
    chunk_index: Optional[torch.Tensor] = None
    custom_rows: Optional[torch.Tensor] = None
    custom_chunks: Optional[torch.Tensor] = None
    assignments: Optional[torch.Tensor] = None

    def __post_init__(self):
        # The gathers' int64 indices, made once; the clip resolves the
        # sentinel of empty chunks.
        self._to_policy = self._to_sim = None
        if self.to_policy_idxs is not None:
            n = self.to_sim_idxs.shape[0]
            self._to_policy = self.to_policy_idxs.clamp(max=n - 1).long()
            self._to_sim = self.to_sim_idxs.long()

    def to_policy(self, data):
        def txfm(x):
            if self._to_policy is None:
                return x.reshape(*self.policy_dims, *x.shape[1:])
            return x[self._to_policy]

        return tree_map(txfm, data)

    def to_sim(self, data):
        def txfm(x):
            if self._to_sim is None:
                return x.reshape(*self.sim_dims, *x.shape[2:])
            return x.reshape(-1, *x.shape[2:])[self._to_sim]

        return tree_map(txfm, data)

    def drop_custom(self, data, rest=None):
        """Sim-order ``data`` with the custom rows set to zeros, or to their
        rows of the sim-order tree ``rest`` where given."""
        if self.custom_rows is None:
            return data

        def txfm(x, *r):
            mask = self.custom_rows.reshape(-1, *[1] * (x.dim() - 1))
            return torch.where(mask, r[0] if r else torch.zeros(
                (), dtype=x.dtype, device=x.device), x)

        return (tree_map(txfm, data) if rest is None
                else tree_map(txfm, data, rest))

    def keep_custom_chunks(self, new, old):
        """Chunk-order ``new`` with the rows of the custom chunks taken from
        ``old``."""
        if self.custom_chunks is None:
            return new

        def txfm(x, y):
            mask = self.custom_chunks.reshape(-1, *[1] * (x.dim() - 1))
            return torch.where(mask, y, x)

        return tree_map(txfm, new, old)
