"""Partition planning: key profile -> ShardPlan (port of the legacy path of
``repro.balance.planners``).

The legacy boundary derivations (``balanced`` | ``range`` | ``sample``)
keep their exact historical boundaries and capacity semantics (the
shuffle capacity comes from ``cfg.cap_factor``; a legacy plan carries no
``cap_link``), and gain planned-load telemetry from the key profile.

The profile-backed planners of the reference (``uniform``, ``blocksplit``,
``pairrange``) are not ported yet: naming one raises NotImplementedError
(ROADMAP M6).  ``ShardPlan`` keeps every field, so rank-granular plans
built elsewhere still route through ``dest``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.balance.profile import KeyProfile, profile_keys
from repro_torch.core import partition as P
from repro_torch.core import window as W

LEGACY_PARTITIONERS = ("balanced", "range", "sample")
# the reference's planner registry names, not ported yet (ROADMAP M6)
PROFILE_PLANNERS = ("uniform", "blocksplit", "pairrange")


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


def _unported(partitioner: str):
    return NotImplementedError(
        f"partitioner {partitioner!r} is not ported to repro_torch yet "
        f"(ROADMAP M6: planning); use one of {LEGACY_PARTITIONERS}")


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
    if partitioner in PROFILE_PLANNERS:
        raise _unported(partitioner)
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
    """Plan shard boundaries from a ``KeyProfile`` alone (legacy names: the
    boundaries are rebuilt from the profile's sorted key multiset — exact,
    since the legacy derivations only read sorted keys)."""
    if profile.n == 0:
        bounds = np.asarray(P.manual_partition(range(1, r)) if r > 1
                            else P.manual_partition([]))
        return ShardPlan(partitioner=partitioner, num_shards=r,
                         bounds=bounds.astype(np.int32))
    if partitioner not in LEGACY_PARTITIONERS:
        if partitioner in PROFILE_PLANNERS:
            raise _unported(partitioner)
        raise ValueError(f"unknown partitioner {partitioner!r}")
    sorted_keys = np.repeat(profile.uniq, profile.counts)
    bounds = _legacy_bounds(sorted_keys, partitioner, r).astype(np.int32)
    rank_bounds = profile.rank_after_key(bounds)
    load, comp, halo = _plan_stats(profile, rank_bounds)
    return ShardPlan(partitioner=partitioner, num_shards=r, bounds=bounds,
                     rank_bounds=rank_bounds, planned_load=load,
                     planned_comparisons=comp, halo=halo)


def plan_shards(ents: dict, cfg, r: int) -> ShardPlan:
    """Profile ``ents`` and build the ShardPlan for ``cfg.partitioner``
    (legacy names only; the profile-backed planners raise, ROADMAP M6)."""
    if cfg.partitioner in PROFILE_PLANNERS:
        raise _unported(cfg.partitioner)
    valid = ents["valid"].cpu().numpy()
    keys = ents["key"].cpu().numpy()[valid]
    if keys.size == 0:
        return plan_from_profile(KeyProfile.empty(cfg.window),
                                 cfg.partitioner, r)
    profile = profile_keys(keys, window=cfg.window)
    plan = plan_from_profile(profile, cfg.partitioner, r)
    validate_plan(plan, cfg, int(keys.shape[0]))
    return plan
