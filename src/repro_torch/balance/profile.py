"""The paper-family "analysis job": profile the sort-key distribution
(port of ``repro.balance.profile``).

Kolb, Thor & Rahm (arXiv:1108.1631) precede BlockSplit/PairRange with a
lightweight MapReduce analysis job that counts entities per blocking key;
here that job is a single device pass over the sort keys — sort + marginal
comparison counts + cumulative sums (the O(n log n) work) run on the host
in numpy, and only the O(K) unique-key block structure is kept.

The resulting ``KeyProfile`` is everything a partition planner needs:

  * per-block (unique-key) entity counts and cumulative entity counts —
    candidate shard boundaries can only fall at block edges (key-bounds
    plans) or at explicit ranks inside a block (split plans);
  * window-induced comparison counts per block and cumulatively — the cost
    model (``window.rank_prefix_comparisons``) assigns the comparison for
    pair (i-d, i) to the later rank i, so contiguous rank ranges have exact
    closed-form costs;
  * the replication/halo cost of placing a boundary after each block: the
    min(rank, w-1) predecessor entities RepSN would replicate across it.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core import window as W


@dataclass(frozen=True)
class KeyProfile:
    """Key-distribution profile of one entity set under window ``window``.

    All arrays are host numpy, indexed by sorted unique key ("block"):

      uniq               (K,) int64  sorted unique sort keys
      counts             (K,) int64  entities per key
      cum_entities       (K,) int64  inclusive cumulative entity counts
      block_comparisons  (K,) int64  window comparisons owned by the block
      cum_comparisons    (K,) int64  inclusive cumulative comparisons

    ``halo_cost`` (a property, derived from cum_entities) is the
    replication cost of each candidate boundary: the min(rank, w-1)
    predecessor entities RepSN would copy across a boundary placed after
    that block (``planners._plan_stats`` applies the same formula at rank
    granularity for split boundaries).
    """
    n: int
    window: int
    uniq: np.ndarray
    counts: np.ndarray
    cum_entities: np.ndarray
    block_comparisons: np.ndarray
    cum_comparisons: np.ndarray

    @property
    def halo_cost(self) -> np.ndarray:
        """(K,) replication cost of a boundary placed after each block: the
        min(rank, w−1) predecessors RepSN would copy across it."""
        return np.minimum(self.cum_entities, self.window - 1)

    @property
    def n_blocks(self) -> int:
        """Number of unique-key blocks (K)."""
        return int(self.uniq.shape[0])

    @property
    def total_comparisons(self) -> int:
        """Total SN window comparisons over the whole profiled key set."""
        return int(self.cum_comparisons[-1]) if self.n_blocks else 0

    def comparisons_in_rank_range(self, lo, hi) -> np.ndarray:
        """Exact window comparisons owned by sorted ranks in [lo, hi)."""
        return (W.rank_prefix_comparisons(hi, self.window)
                - W.rank_prefix_comparisons(lo, self.window))

    def rank_after_key(self, key_bounds: np.ndarray) -> np.ndarray:
        """For each inclusive key upper bound, the number of entities with
        key <= bound — the rank-space boundary a key-bounds plan induces."""
        idx = np.searchsorted(self.uniq, np.asarray(key_bounds, np.int64),
                              side="right")
        cum = np.concatenate([[0], self.cum_entities])
        return cum[idx]

    def key_at_rank(self, rank) -> np.ndarray:
        """Sort key of the entity at 0-based sorted rank (clipped)."""
        r = np.clip(np.asarray(rank, np.int64), 0, max(self.n - 1, 0))
        idx = np.searchsorted(self.cum_entities, r, side="right")
        return self.uniq[np.minimum(idx, self.n_blocks - 1)]

    def merge(self, other: "KeyProfile", *,
              remove: bool = False) -> "KeyProfile":
        """Combine two profiles into the profile of the CONCATENATED key
        sets — the incremental accumulator of the streaming analysis job
        (``repro.stream`` profiles each ingested chunk on device and folds
        the results, so planning sees the full corpus without ever holding
        it).

        Exact, not approximate: per-key counts are additive, and every
        derived column (cum_entities, comparison counts) is a closed-form
        function of the merged counts via ``window.rank_prefix_comparisons``
        — ``a.merge(b)`` equals ``profile_keys(concat(a_keys, b_keys))``
        bit-for-bit.  Windows must match; merging with an empty profile is
        the identity.

        ``remove=True`` is the delete path of the serving layer
        (``repro.serve``): ``other``'s counts are subtracted exactly —
        ``a.merge(b).merge(b, remove=True)`` equals ``a`` bit-for-bit, so
        planner cost models stay truthful under deletes.  Removing keys the
        profile does not hold (or more copies than it holds) raises."""
        if self.window != other.window:
            raise ValueError(
                f"cannot merge profiles with different windows "
                f"({self.window} vs {other.window})")
        if other.n == 0:
            return self
        if not remove and self.n == 0:
            return other
        sign = -1 if remove else 1
        allk = np.concatenate([self.uniq, other.uniq])
        allc = np.concatenate([self.counts, sign * other.counts])
        uniq, inv = np.unique(allk, return_inverse=True)
        counts = np.zeros(uniq.shape[0], np.int64)
        np.add.at(counts, inv, allc)
        if remove:
            if counts.min(initial=0) < 0:
                bad = uniq[counts < 0][:8]
                raise ValueError(
                    f"cannot remove keys the profile does not hold "
                    f"(over-removed keys, first few: {bad.tolist()})")
            keep = counts > 0                  # reclaim emptied key blocks
            uniq, counts = uniq[keep], counts[keep]
        cum_entities = np.cumsum(counts)
        cum_comparisons = np.asarray(
            W.rank_prefix_comparisons(cum_entities, self.window), np.int64)
        block_comparisons = np.diff(np.concatenate([[0], cum_comparisons]))
        return KeyProfile(n=self.n + sign * other.n, window=self.window,
                          uniq=uniq, counts=counts,
                          cum_entities=cum_entities,
                          block_comparisons=block_comparisons,
                          cum_comparisons=cum_comparisons)

    @classmethod
    def empty(cls, window: int) -> "KeyProfile":
        """The merge identity: a profile of zero keys under ``window``."""
        z = np.zeros((0,), np.int64)
        return cls(n=0, window=window, uniq=z, counts=z, cum_entities=z,
                   block_comparisons=z, cum_comparisons=z)


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)


def profile_keys(keys, *, window: int, valid=None) -> KeyProfile:
    """Run the analysis job over ``keys`` (valid entries only).

    Keys may be numpy arrays or tensors (moved to the host).
    """
    keys = _host(keys)
    if valid is not None:
        keys = keys[_host(valid)]
    n = int(keys.shape[0])
    empty = np.zeros((0,), np.int64)
    if n == 0:
        return KeyProfile(n=0, window=window, uniq=empty, counts=empty,
                          cum_entities=empty, block_comparisons=empty,
                          cum_comparisons=empty)
    # keys are int32 by schema (entities.py: packed, < 2^30)
    sk = np.sort(keys.astype(np.int32)).astype(np.int64)
    # block (unique-key) end positions in the sorted order
    is_end = np.concatenate([sk[1:] != sk[:-1], [True]])
    end = np.flatnonzero(is_end)                         # (K,) last rank/block
    cum_entities = end + 1
    counts = np.diff(np.concatenate([[0], cum_entities]))
    cum_comparisons = np.asarray(
        W.rank_prefix_comparisons(cum_entities, window), np.int64)
    block_comparisons = np.diff(np.concatenate([[0], cum_comparisons]))
    return KeyProfile(n=n, window=window, uniq=sk[end].copy(), counts=counts,
                      cum_entities=cum_entities,
                      block_comparisons=block_comparisons,
                      cum_comparisons=cum_comparisons)
