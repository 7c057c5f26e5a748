"""Partition planners: key profile -> ShardPlan (port of
``repro.balance.planners``; host numpy, as in the reference).

A planner decides where the shard boundaries fall, whether an oversized
key block is split across shards at rank granularity, and how large the
padded per-shard shuffle capacity (``cap_link``) must be so nothing
overflows.  Planners registered here (``ERConfig.partitioner``):

  uniform     even KEY-SPACE split over the observed key extent
  blocksplit  greedy walk over key blocks balancing COMPARISON counts;
              boundaries snap to block edges, and only a block larger
              than a shard's fair share is split mid-block
  pairrange   exact equal division of the global SN pair space: boundary
              ranks at comparison-count quantiles (the inverse cost model)

Legacy names (balanced | range | sample) keep their exact historical
boundaries and capacity semantics (cap from ``cfg.cap_factor``).

Rank-granular plans carry a per-entity ``dest`` that overrides the
key->shard partition function inside ``srp.srp_shard`` (monotone in
sorted rank, so halo exchange and boundary windows hold unchanged), and
``cap_link`` feeds the variants' padded capacities.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple, Type

import numpy as np

from repro_torch.balance.profile import KeyProfile, profile_keys
from repro_torch.core import partition as P
from repro_torch.core import window as W

LEGACY_PARTITIONERS = ("balanced", "range", "sample")


@dataclass(frozen=True)
class ShardPlan:
    """A planned partitioning of one entity set into ``num_shards`` shards.

    bounds        (r-1,) int32  inclusive key upper bounds
    rank_bounds   (r-1,) int64  boundary ranks in the global (key, eid) sort
                  (None for explicit-bounds plans without a profile)
    dest          (N,) int32    per-entity shard, ORIGINAL entity order
                  (None: route by key via ``bounds``)
    planned_load / planned_comparisons / halo   (r,) int64 per-shard entity
                  counts, window comparisons and halo entities received
                  (None without a profile)
    cap_link      planned per-(mapper, destination) shuffle capacity; None
                  derives it from cfg.cap_factor
    rank_granular True when some boundary falls INSIDE a key block
    """
    partitioner: str
    num_shards: int
    bounds: np.ndarray
    rank_bounds: Optional[np.ndarray] = None
    dest: Optional[np.ndarray] = None
    planned_load: Optional[np.ndarray] = None
    planned_comparisons: Optional[np.ndarray] = None
    halo: Optional[np.ndarray] = None
    cap_link: Optional[int] = None
    rank_granular: bool = False

    @property
    def imbalance(self) -> float:
        """max/mean of planned per-shard comparison counts."""
        if self.planned_comparisons is None:
            return float("nan")
        return imbalance_ratio(self.planned_comparisons)

    @property
    def straggler(self) -> int:
        """Shard id with the largest planned comparison count."""
        if self.planned_comparisons is None:
            return 0
        return int(np.argmax(self.planned_comparisons))

    def assignment(self, keys: np.ndarray,
                   valid: Optional[np.ndarray] = None) -> np.ndarray:
        """Per-entity shard ids in the ORIGINAL entity order (valid-filtered
        when ``valid`` is given)."""
        if self.dest is not None:
            d = np.asarray(self.dest)
            return d[np.asarray(valid)] if valid is not None else d
        if self.rank_granular:
            raise ValueError(
                "rank-granular plan carries no per-entity dest: assignment "
                "must be derived from sorted ranks against rank_bounds")
        keys = np.asarray(keys)
        if valid is not None:
            keys = keys[np.asarray(valid)]
        return np.searchsorted(np.asarray(self.bounds), keys,
                               side="left").astype(np.int32)


def imbalance_ratio(comparisons) -> float:
    """max/mean of per-shard comparison counts (1.0 = perfectly level)."""
    c = np.asarray(comparisons, np.float64)
    mean = c.mean() if c.size else 0.0
    return float(c.max() / mean) if mean > 0 else 1.0


def realized_comparisons(load, window: int) -> np.ndarray:
    """Per-shard window comparison counts induced by realized per-shard
    valid counts (shards own contiguous sorted rank ranges)."""
    offs = np.concatenate([[0], np.cumsum(np.asarray(load, np.int64))])
    return np.asarray(W.rank_prefix_comparisons(offs[1:], window)
                      - W.rank_prefix_comparisons(offs[:-1], window),
                      np.int64)


def as_plan(bounds_or_plan) -> ShardPlan:
    """Pass ShardPlans through; wrap raw boundary arrays (numpy or tensor)
    in a stats-free explicit plan."""
    if isinstance(bounds_or_plan, ShardPlan):
        return bounds_or_plan
    b = bounds_or_plan
    b = b.cpu().numpy() if hasattr(b, "cpu") else np.asarray(b)
    b = b.astype(np.int32).reshape(-1)
    return ShardPlan(partitioner="explicit",
                     num_shards=int(b.shape[0]) + 1, bounds=b)


# -- planner registry ---------------------------------------------------------------

_PLANNERS: Dict[str, Type["Partitioner"]] = {}


def register_partitioner(name: str):
    """Class decorator: ``@register_partitioner("blocksplit")``."""
    def deco(cls):
        cls.name = name
        _PLANNERS[name] = cls
        return cls
    return deco


def get_partitioner(name: str) -> "Partitioner":
    """Instantiate the registered partition planner named ``name`` (raises
    ``ValueError`` listing registry + legacy names when unknown)."""
    try:
        return _PLANNERS[name]()
    except KeyError:
        raise ValueError(
            f"unknown partition planner {name!r}; registered: "
            f"{available_partitioners()} (legacy: {LEGACY_PARTITIONERS})"
        ) from None


def available_partitioners() -> Tuple[str, ...]:
    """Sorted names of every registered partition planner (the legacy
    names live outside the registry)."""
    return tuple(sorted(_PLANNERS))


class Partitioner:
    """One boundary-selection strategy.  ``boundary_ranks(profile, r)``
    returns (rank_bounds (r-1,) int64, key_bounds (r-1,) int64 | None):
    nondecreasing boundary ranks in the global sorted order, plus — when
    every boundary sits on a key-block edge — the equivalent inclusive key
    upper bounds.  ``key_bounds=None`` marks a rank-granular plan."""

    name = "?"

    def boundary_ranks(self, profile: KeyProfile,
                       r: int) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Choose the r−1 shard boundaries for ``profile``."""
        raise NotImplementedError


@register_partitioner("uniform")
class UniformPartitioner(Partitioner):
    """Even key-space ranges over the observed key extent (paper Even8/10):
    the baseline skew is measured against."""

    def boundary_ranks(self, profile, r):
        lo, hi = int(profile.uniq[0]), int(profile.uniq[-1])
        span = hi - lo + 1
        key_bounds = lo + (np.arange(1, r, dtype=np.int64) * span) // r
        return profile.rank_after_key(key_bounds), key_bounds


@register_partitioner("blocksplit")
class BlockSplitPartitioner(Partitioner):
    """Greedy block walk balancing comparison counts (Kolb's BlockSplit,
    SN-adapted).  For each boundary the remaining comparison mass is divided
    by the remaining shards; the boundary snaps to the nearer edge of the
    block that straddles the goal — unless that block alone exceeds the
    fair share, in which case it is split mid-block at the exact rank."""

    def boundary_ranks(self, profile, r):
        n, w = profile.n, profile.window
        cum_n = profile.cum_entities
        cum_c = profile.cum_comparisons
        total = profile.total_comparisons
        edges = []
        any_split = False
        rank0 = 0
        for made in range(r - 1):
            done = int(W.rank_prefix_comparisons(rank0, w))
            target = (total - done) / (r - made)
            goal = done + target
            j = int(np.searchsorted(cum_c, goal, side="left"))
            if j >= profile.n_blocks or rank0 >= n - 1:
                edges.append(n)                   # mass exhausted: empty tail
                continue
            start_rank = int(cum_n[j - 1]) if j > 0 else 0
            end_rank = int(cum_n[j])
            block_c = int(cum_c[j]) - (int(cum_c[j - 1]) if j > 0 else 0)
            if block_c > target:
                # oversized block: split it at the exact pair-space rank
                e = W.rank_for_prefix_comparisons(goal, w)
                e = int(np.clip(e, rank0 + 1, n))
                if start_rank < e < end_rank:
                    any_split = True
            else:
                # snap to the nearer block edge (never re-emit a past edge)
                lo_c = int(W.rank_prefix_comparisons(start_rank, w))
                hi_c = int(cum_c[j])
                if start_rank > rank0 and goal - lo_c <= hi_c - goal:
                    e = start_rank
                else:
                    e = end_rank
            edges.append(min(e, n))
            rank0 = edges[-1]
        edges = np.asarray(edges, np.int64)
        if any_split:
            return edges, None
        # every boundary on a block edge: the key of rank e-1 closes shard s
        return edges, np.asarray(
            profile.key_at_rank(np.maximum(edges - 1, 0)), np.int64)


@register_partitioner("pairrange")
class PairRangePartitioner(Partitioner):
    """Equal contiguous ranges of the global SN pair space (Kolb's
    PairRange, SN-adapted): boundary ranks at exact comparison-count
    quantiles; always rank-granular."""

    def boundary_ranks(self, profile, r):
        n, w = profile.n, profile.window
        total = profile.total_comparisons
        edges = [W.rank_for_prefix_comparisons(total * (s + 1) / r, w)
                 for s in range(r - 1)]
        edges = np.minimum(np.maximum.accumulate(np.asarray(edges, np.int64)),
                           n)
        return edges, None


# -- plan construction --------------------------------------------------------------

def _legacy_bounds(keys: np.ndarray, partitioner: str, r: int) -> np.ndarray:
    """Exact historical boundary behavior of the legacy partitioners."""
    if partitioner == "balanced":
        return np.asarray(P.balanced_partition(keys, r))
    if partitioner == "range":
        return np.asarray(P.range_partition(int(keys.max()) + 1, r))
    if partitioner == "sample":
        import torch
        return np.asarray(P.sample_partition(
            torch.as_tensor(np.sort(keys)), r))
    raise ValueError(f"unknown partitioner {partitioner!r}")


def _plan_stats(profile: KeyProfile, rank_bounds: np.ndarray):
    edges = np.concatenate([[0], np.asarray(rank_bounds, np.int64),
                            [profile.n]])
    load = np.diff(edges)
    comp = np.asarray(profile.comparisons_in_rank_range(edges[:-1], edges[1:]),
                      np.int64)
    halo = np.minimum(edges[:-1], profile.window - 1)
    halo[0] = 0
    return load, comp, halo


def _planned_cap_link(assign_valid: np.ndarray, valid_pos: np.ndarray,
                      n_slots: int, r: int, window: int) -> int:
    """Exact per-(mapper, destination) shuffle capacity for
    ``runners.shard_input``'s contiguous mapper chunks, floored so the halo
    slice stays legal (r*cap_link >= w-1) and >= 1."""
    cap0 = int(np.ceil(n_slots / r))
    mapper = valid_pos // cap0
    counts = np.zeros((r, r), np.int64)
    np.add.at(counts, (mapper, assign_valid), 1)
    need = int(counts.max())
    halo_floor = int(np.ceil((window - 1) / r))
    return max(need, halo_floor, 1)


def validate_plan(plan: ShardPlan, cfg, n_valid: int) -> None:
    """Reject plan/config combinations that would SILENTLY truncate a
    shard's halo: RepSN hops too low for the planned loads, or JobSN
    interior shards holding fewer than w-1 entities."""
    from repro_torch.api.variants import get_variant   # lazy: import cycle
    variant = get_variant(cfg.variant)
    if not variant.halo_slices or plan.planned_load is None:
        return
    w, r = cfg.window, plan.num_shards
    loads = np.asarray(plan.planned_load, np.int64)
    edges = np.concatenate([[0], np.asarray(plan.rank_bounds, np.int64)])
    if variant.name == "repsn":
        need_hops = 1
        for s in range(1, r):
            # an empty shard emits nothing, so it needs no halo at all
            need = min(int(edges[s]), w - 1) if loads[s] > 0 else 0
            acc, h = 0, 0
            for q in range(s - 1, -1, -1):
                if acc >= need:
                    break
                acc += int(loads[q])
                h += 1
            need_hops = max(need_hops, h)
        if cfg.hops < need_hops:
            raise ValueError(
                f"partitioner {plan.partitioner!r} gives some shard fewer "
                f"than window-1={w - 1} predecessors within hops="
                f"{cfg.hops}: its halo would be silently truncated and "
                f"boundary pairs lost.  Set hops>={need_hops} (hops="
                f"{r - 1} is always complete), lower window, or use fewer "
                f"shards")
    elif variant.name == "jobsn" and n_valid > w - 1:
        nonempty = np.flatnonzero(loads)
        first = int(nonempty[0]) if nonempty.size else 0
        last = int(nonempty[-1]) if nonempty.size else 0
        small = [s for s in range(first + 1, last) if loads[s] < w - 1]
        if small:
            raise ValueError(
                f"partitioner {plan.partitioner!r} plans interior shard(s) "
                f"{small} with fewer than window-1={w - 1} entities; "
                f"JobSN's single boundary pass cannot reach across them "
                f"and would silently drop pairs.  Use variant='repsn' with "
                f"hops={r - 1}, lower num_shards, or lower window")


def plan_from_profile(profile: KeyProfile, partitioner: str,
                      r: int) -> ShardPlan:
    """Plan shard boundaries from a ``KeyProfile`` alone, for the planner
    registry and the legacy names (their boundaries rebuilt from the
    profile's sorted key multiset — exact, since the legacy derivations
    only read sorted keys).  The plan carries boundaries, planned stats and
    ``rank_granular``, but neither ``dest`` nor ``cap_link`` (those need
    the entity layout; ``plan_shards`` attaches them)."""
    if profile.n == 0:
        bounds = np.asarray(P.manual_partition(range(1, r)) if r > 1
                            else P.manual_partition([]))
        return ShardPlan(partitioner=partitioner, num_shards=r,
                         bounds=bounds.astype(np.int32))
    if partitioner in LEGACY_PARTITIONERS:
        sorted_keys = np.repeat(profile.uniq, profile.counts)
        bounds = _legacy_bounds(sorted_keys, partitioner, r) \
            .astype(np.int32)
        rank_bounds = profile.rank_after_key(bounds)
        load, comp, halo = _plan_stats(profile, rank_bounds)
        return ShardPlan(partitioner=partitioner, num_shards=r,
                         bounds=bounds, rank_bounds=rank_bounds,
                         planned_load=load, planned_comparisons=comp,
                         halo=halo)
    planner = get_partitioner(partitioner)
    rank_bounds, key_bounds = planner.boundary_ranks(profile, r)
    rank_bounds = np.asarray(rank_bounds, np.int64)
    load, comp, halo = _plan_stats(profile, rank_bounds)
    if key_bounds is None:
        # key-view bounds are telemetry only: the key of the last entity of
        # each shard (routing happens by rank)
        bounds = np.asarray(profile.key_at_rank(
            np.maximum(rank_bounds - 1, 0)), np.int64).astype(np.int32)
    else:
        bounds = np.asarray(key_bounds, np.int64).astype(np.int32)
    return ShardPlan(partitioner=partitioner, num_shards=r, bounds=bounds,
                     rank_bounds=rank_bounds, planned_load=load,
                     planned_comparisons=comp, halo=halo,
                     rank_granular=key_bounds is None)


def plan_shards(ents: dict, cfg, r: int) -> ShardPlan:
    """Profile ``ents`` (a port entity dict on any device) and build the
    ShardPlan for ``cfg.partitioner``.  Legacy partitioners keep their
    historical boundaries and capacity semantics; the registry planners
    also emit exact planned capacities and, where a boundary falls inside
    a key block, per-entity routing (``dest``)."""
    valid = ents["valid"].cpu().numpy()
    keys_all = ents["key"].cpu().numpy()
    keys = keys_all[valid]
    if keys.size == 0:
        return plan_from_profile(KeyProfile.empty(cfg.window),
                                 cfg.partitioner, r)
    profile = profile_keys(keys, window=cfg.window)
    plan = plan_from_profile(profile, cfg.partitioner, r)

    if cfg.partitioner in LEGACY_PARTITIONERS:
        validate_plan(plan, cfg, int(keys.shape[0]))
        return plan

    dest = None
    if plan.rank_granular:
        # route by explicit per-entity destination: sorted (key, eid) rank
        # against the plan's boundary ranks
        eids = ents["eid"].cpu().numpy()[valid]
        order = np.lexsort((eids, keys))
        ranks = np.empty(keys.shape[0], np.int64)
        ranks[order] = np.arange(keys.shape[0])
        assign_valid = np.searchsorted(plan.rank_bounds, ranks,
                                       side="right").astype(np.int32)
        dest = np.zeros(keys_all.shape[0], np.int32)
        dest[np.flatnonzero(valid)] = assign_valid
    else:
        assign_valid = np.searchsorted(plan.bounds, keys,
                                       side="left").astype(np.int32)

    cap_link = _planned_cap_link(assign_valid, np.flatnonzero(valid),
                                 keys_all.shape[0], r, cfg.window)
    plan = replace(plan, dest=dest, cap_link=cap_link)
    validate_plan(plan, cfg, int(keys.shape[0]))
    return plan
