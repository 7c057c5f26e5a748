"""Neighborhood-delta matching: turn one micro-batch into exact pair edits
(port of ``repro.serve.delta``).

The serving layer maintains the CURRENT pair sets of the corpus, so every
mutation must produce both sides of the edit: inserts create pairs around
the new entities but also retire old×old pairs pushed apart beyond w−1
ranks, and deletes retire pairs but also create old×old pairs pulled
together.  The delta matcher computes those edits without touching the
rest of the corpus, from one locality fact about sorted neighborhood:

  **Every pair whose status changes lies wholly inside one merged expanded
  interval around a mutated rank.**  Take the per-mutation intervals
  [k−w+1, k+w) around each inserted/deleted rank ``k`` and merge overlaps.
  If pair (a, b) changes status, some mutation sits between (or at) the
  endpoints' ranks at distance ≤ w−1 from each — otherwise both the pair's
  rank distance and its SN membership are untouched — so ``a`` and ``b``
  fall inside that mutation's interval; and when several mutations sit
  between them, consecutive ones are ≤ w−1 ranks apart (the pair spans
  ≤ w−1 old entities total), so their intervals chain into ONE merged
  interval containing both endpoints.

That reduces the edit to per-interval set algebra:

  after_i    the complete SN pairs of interval i in the POST-mutation
             order — ONE shard-program call per group of intervals (each
             interval routed to its own shard via a rank-granular
             ``ShardPlan``, exactly the stream's chunk plans), on bucketed
             shapes;
  before_i   the restriction of the maintained sets to pairs with BOTH
             endpoints in interval i — pure host array work, one slice
             of the sorted set per region row;
  updated    (maintained \\ ∪before_i) ∪ ∪after_i — ∪before_i dropped by
             position and ∪after_i inserted at its sorted positions.

The device call runs the SRP variant with ``emit="pairs"`` — intervals are
mutually independent (each is a complete window over a contiguous rank
range), so per-partition SN with no boundary completion is exactly right —
and matcher decisions are per-pair deterministic, so the edited sets stay
bit-identical to a from-scratch resolve over the live corpus.

Every shard program runs on the matcher's ``device`` (the CUDA card by
default), and so K1 runs on every device call.  The set algebra runs on
the host over sorted distinct packed arrays, as ``searchsorted`` lookups
(``api.results``' sorted set operations) — numpy's hashing
``setdiff1d``/``union1d``/``intersect1d``/``isin`` give the same values in
the same dtype.  It costs the batch's regions plus two copies of each
maintained set: no lookup or sort runs over every maintained pair.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from repro_torch import balance as B
from repro_torch import obs as OBS
from repro_torch.api import results as RES
from repro_torch.api.runners import VmapRunner
from repro_torch.core import entities as E
from repro_torch.device import resolve_device

_EMPTY = np.empty((0,), RES.PACKED_DTYPE)
_LOW32 = RES.PACKED_DTYPE(0xFFFFFFFF)


class DeltaStats(NamedTuple):
    """Telemetry of one applied mutation.

    ``added_*``/``removed_*`` are the packed pair edits (the serving
    result's payload); ``regions``/``region_rows`` size the touched
    neighborhoods; ``shapes`` lists the (num_shards, shard_cap) buckets of
    the device calls — a steady workload cycles through few of them.
    ``degraded`` marks a mutation applied through the brownout path (see
    ``insert``/``delete``); ``comp_ranges`` are the inclusive composite
    ranges (c_lo, c_hi) of the touched regions — composites are immutable
    per entity, so these ranges stay valid anchors for a later ``refresh``
    no matter how the corpus mutates in between."""
    batch: int
    regions: int
    region_rows: int
    device_calls: int
    shapes: Tuple[Tuple[int, int], ...]
    added_blocked: np.ndarray
    removed_blocked: np.ndarray
    added_matched: np.ndarray
    removed_matched: np.ndarray
    degraded: bool = False
    comp_ranges: Tuple[Tuple[int, int], ...] = ()


def merge_intervals(ranks: np.ndarray, window: int, n: int
                    ) -> List[Tuple[int, int]]:
    """Expanded intervals [k−w+1, k+w) around each mutated rank, clipped to
    [0, n) and merged (``ranks`` must be sorted).  Touching intervals merge
    too — over-merging is always safe, it only widens a region."""
    out: List[List[int]] = []
    w = window
    for k in np.asarray(ranks, np.int64).tolist():
        lo, hi = max(0, k - (w - 1)), min(n, k + w)
        if hi <= lo:
            continue
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(a, b) for a, b in out]


def _region_pairs(packed: np.ndarray, eid_sorted: np.ndarray,
                  iv_of: np.ndarray) -> Tuple[np.ndarray, int]:
    """Positions in ``packed`` of the maintained pairs with BOTH endpoints
    inside the SAME interval (``eid_sorted``: sorted distinct region eids;
    ``iv_of``: their interval ids), and the count of pairs looked at.
    Same-interval matters: a pair spanning two different merged intervals
    is unchanged by construction and must stay untouched.

    Packed pairs sort by their lower eid first, so the pairs whose lower
    eid is ``e`` are one slice of ``packed``, from ``e << 32`` to
    ``(e << 32) | 0xFFFFFFFF`` (``(e + 1) << 32`` would wrap at eid
    2^32 - 1): the lookups cost the region's rows, not the set's size."""
    if packed.shape[0] == 0 or eid_sorted.shape[0] == 0:
        return np.empty((0,), np.int64), 0
    e = eid_sorted.astype(RES.PACKED_DTYPE) << RES.PACKED_DTYPE(32)
    starts = np.searchsorted(packed, e, side="left")
    lens = np.searchsorted(packed, e | _LOW32, side="right") - starts
    total = int(lens.sum())
    pos = np.repeat(starts - (np.cumsum(lens) - lens), lens) \
        + np.arange(total)
    hi = (packed[pos] & _LOW32).astype(np.int64)
    ih = np.minimum(np.searchsorted(eid_sorted, hi), eid_sorted.shape[0] - 1)
    keep = (eid_sorted[ih] == hi) & (iv_of[ih] == np.repeat(iv_of, lens))
    return pos[keep], total


def _splice(packed: np.ndarray, drop: np.ndarray,
            add: np.ndarray) -> np.ndarray:
    """``packed`` without the values at positions ``drop``, with the sorted
    distinct values of ``add`` inserted in order: two copies of the set,
    whatever its size.  A value of ``add`` still in the set after the drop
    is not inserted twice."""
    kept = np.delete(packed, drop)
    at = np.searchsorted(kept, add)
    if kept.shape[0] and add.shape[0]:
        new = kept[np.minimum(at, kept.shape[0] - 1)] != add
        add, at = add[new], at[new]
    return np.insert(kept, at, add)


def _diff(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return RES.setdiff_sorted(a, b) if a.shape[0] else _EMPTY


class DeltaMatcher:
    """Stateless-per-call delta engine bound to one (cfg, index) pair.

    ``insert``/``delete`` take the maintained packed COMPLETE pair sets
    and return the updated sets plus a ``DeltaStats``; the index mutation
    is applied as the final step (a raised error leaves both the index and
    the maintained sets untouched).

    ``shard_buckets``/``cap_floor`` define the shape-bucket grid: a
    mutation with R merged regions of max length L runs as one call per
    ⌈R / max_bucket⌉ group, each padded to (next bucket ≥ group size) ×
    (cap_floor · 2^k ≥ L) — so a steady workload cycles through few
    shapes.  ``device``: where every delta call runs (None = the CUDA card,
    raising without one).

    Traced, ``insert``/``delete`` open an ``index`` span over the regions'
    gather (``rows``: the regions' rows), then ``delta_pairs`` and
    ``set_algebra`` (``touched``: the maintained pairs its lookups read),
    then a second ``index`` span over the index's own mutation (``rows``:
    the rows inserted or deleted)."""

    def __init__(self, cfg, index, *,
                 shard_buckets: Sequence[int] = (2, 4, 8),
                 cap_floor: int = 64, device=None):
        if cfg.passes:
            raise ValueError("the serving layer resolves under ONE sort key;"
                             " multi-pass configs are batch-only")
        if cfg.linkage:
            raise ValueError("linkage mode is batch-only; serve single-"
                             "source configs")
        if cfg.return_scores:
            raise ValueError("return_scores is unsupported when serving "
                             "(delta calls emit packed pairs)")
        self.cfg = cfg
        self.index = index
        self.shard_buckets = tuple(sorted(shard_buckets))
        self.cap_floor = int(cap_floor)
        self.device = resolve_device(device)
        self._runners: Dict[int, VmapRunner] = {}
        self._cfgs: Dict[Tuple[int, int], object] = {}

    # -- shape-bucketed device call -----------------------------------------

    def _delta_cfg(self, r_b: int, cap_b: int):
        key = (r_b, cap_b)
        cfg_d = self._cfgs.get(key)
        if cfg_d is None:
            # capacities sized from the bucket cap itself: a shard holds at
            # most one region of <= cap_b rows, so the suggestion's band
            # bound can never overflow (guarded below anyway)
            caps = B.suggest_caps(self.index.profile, self.cfg, r_b,
                                  max_load=cap_b)
            cfg_d = self.cfg.with_(
                variant="srp", runner="vmap", num_shards=r_b, emit="pairs",
                cand_cap=caps.cand_cap, pair_cap=caps.pair_cap,
                cap_factor=0.0, compute_metrics=False, passes=(),
                linkage=False)
            self._cfgs[key] = cfg_d
        return cfg_d

    def _runner(self, r_b: int) -> VmapRunner:
        runner = self._runners.get(r_b)
        if runner is None:
            runner = VmapRunner(r_b, device=self.device)
            self._runners[r_b] = runner
        return runner

    def _device_pairs(self, regions: List[dict]
                      ) -> Tuple[np.ndarray, np.ndarray, int,
                                 Tuple[Tuple[int, int], ...]]:
        """Complete SN pairs of each region under the POST-mutation order:
        regions ride as SRP shards of bucketed shard programs (dest = the
        region id), so cross-region pairs are structurally impossible."""
        if not regions:
            return _EMPTY, _EMPTY, 0, ()
        bparts: List[np.ndarray] = []
        mparts: List[np.ndarray] = []
        shapes: List[Tuple[int, int]] = []
        max_r = self.shard_buckets[-1]
        for g0 in range(0, len(regions), max_r):
            group = regions[g0:g0 + max_r]
            r_b = next(b for b in self.shard_buckets if b >= len(group))
            need = max(int(reg["key"].shape[0]) for reg in group)
            cap_b = self.cap_floor
            while cap_b < need:
                cap_b *= 2
            padded = E.host_pad(E.host_concat(group), r_b * cap_b)
            dest = np.zeros(r_b * cap_b, np.int32)
            dest[:sum(int(reg["key"].shape[0]) for reg in group)] = \
                np.concatenate([np.full(int(reg["key"].shape[0]), i,
                                        np.int32)
                                for i, reg in enumerate(group)])
            dev = E.from_numpy(padded, self.device)
            plan = B.ShardPlan(partitioner="serve-delta", num_shards=r_b,
                               bounds=np.zeros(max(r_b - 1, 0), np.int32),
                               dest=dest, cap_link=None, rank_granular=True)
            po = self._runner(r_b).resolve_packed(
                dev, plan, self._delta_cfg(r_b, cap_b))
            if po.overflow or po.cand_overflow or po.pair_overflow:
                raise RuntimeError(
                    f"serve delta call overflowed (link={po.overflow}, "
                    f"cand={po.cand_overflow}, pair={po.pair_overflow}) — "
                    f"capacity sizing bug, shape=({r_b}, {cap_b})")
            bparts.append(po.blocked)
            mparts.append(po.matched)
            shapes.append((r_b, cap_b))
        blocked = RES.unique_packed(np.concatenate(bparts)) \
            if len(bparts) > 1 else bparts[0]
        matched = RES.unique_packed(np.concatenate(mparts)) \
            if len(mparts) > 1 else mparts[0]
        return blocked, matched, len(shapes), tuple(shapes)

    # -- degraded (brownout) path -------------------------------------------

    def _host_pairs(self, regions: List[dict]) -> np.ndarray:
        """Complete SN blocked pairs of each region, computed EXACTLY on
        host: a region is a contiguous rank range in composite order, so
        its blocked set is every pair at sorted distance 1..w-1 — pure
        index arithmetic, no matcher, no device dispatch.  Bit-identical
        to the blocked half of ``_device_pairs`` by construction, which is
        why brownout never degrades the BLOCKED set (DESIGN.md §13)."""
        w = self.cfg.window
        parts: List[np.ndarray] = []
        for reg in regions:
            eids = np.asarray(reg["eid"], np.int64)
            for d in range(1, min(w, int(eids.shape[0]))):
                parts.append(RES.pack_pairs(eids[:-d], eids[d:]))
        if not parts:
            return _EMPTY
        return RES.unique_packed(np.concatenate(parts))

    # -- mutations -----------------------------------------------------------

    def _apply(self, blocked, matched, regions, region_eids, region_ivs,
               batch_n, *, degraded: bool = False, comp_ranges=()):
        """The regions' pairs (a ``delta_pairs`` span), then the edit of
        the maintained sets (a ``set_algebra`` span)."""
        with OBS.span("delta_pairs", degraded=degraded):
            if degraded:
                # brownout: blocked stays exact (host SN arithmetic);
                # matched is the conservative carry-forward gate — a pair
                # stays matched while it stays blocked (matcher decisions
                # are per-pair deterministic over immutable payloads, so
                # every carried match is one an exact re-resolve would
                # confirm); NEW matches are deferred to ``refresh`` over
                # comp_ranges
                after_b = self._host_pairs(regions)
                after_m, calls, shapes = None, 0, ()
            else:
                after_b, after_m, calls, shapes = self._device_pairs(regions)
        with OBS.span("set_algebra") as sp:
            if region_eids:
                eids = np.concatenate(region_eids)
                ivs = np.concatenate(region_ivs)
                order = np.argsort(eids, kind="stable")
                eid_sorted, iv_of = eids[order], ivs[order]
            else:
                eid_sorted = np.empty((0,), np.int64)
                iv_of = np.empty((0,), np.int64)
            at_b, seen_b = _region_pairs(blocked, eid_sorted, iv_of)
            at_m, seen_m = _region_pairs(matched, eid_sorted, iv_of)
            before_b, before_m = blocked[at_b], matched[at_m]
            if degraded:
                after_m = RES.intersect_sorted(before_m, after_b)
            new_blocked = _splice(blocked, at_b, after_b)
            new_matched = _splice(matched, at_m, after_m)
            if sp.enabled:
                sp.set(touched=seen_b + seen_m)
            stats = DeltaStats(
                batch=batch_n, regions=len(region_eids),
                region_rows=int(eid_sorted.shape[0]),
                device_calls=calls, shapes=shapes,
                added_blocked=_diff(after_b, before_b),
                removed_blocked=_diff(before_b, after_b),
                added_matched=_diff(after_m, before_m),
                removed_matched=_diff(before_m, after_m),
                degraded=degraded, comp_ranges=tuple(comp_ranges))
        return new_blocked, new_matched, stats

    def insert(self, batch, blocked: np.ndarray, matched: np.ndarray,
               *, degraded: bool = False
               ) -> Tuple[np.ndarray, np.ndarray, DeltaStats]:
        """Fold one batch of NEW entities (device entity dict) into the
        maintained sets.  Returns (blocked', matched', stats); the sorted
        batch is appended to the index as a run.

        ``degraded=True`` is the brownout path: zero device calls — the
        blocked edit is computed exactly on host, the matched edit is the
        conservative carry-forward gate (previously confirmed matches that
        stay blocked stay matched; new matches are DEFERRED).  The caller
        must record ``stats.comp_ranges`` and later ``refresh`` them to
        restore matched exactness."""
        with OBS.span("index") as sp:
            srun = E.sort_chunk(batch)
            q = E.composite_order_key(srun)
            if q.shape[0] == 0:
                return blocked, matched, DeltaStats(0, 0, 0, 0, (), _EMPTY,
                                                    _EMPTY, _EMPTY, _EMPTY)
            self.index.assert_new_eids(srun["eid"])
            old_all = self.index.live_comps
            pos = np.searchsorted(old_all, q)
            new_ranks = pos + np.arange(q.shape[0], dtype=np.int64)
            n_new = old_all.shape[0] + q.shape[0]
            new_all = np.insert(old_all, pos, q)
            regions: List[dict] = []
            region_eids: List[np.ndarray] = []
            region_ivs: List[np.ndarray] = []
            comp_ranges: List[Tuple[int, int]] = []
            w = self.cfg.window
            for iv, (lo, hi) in enumerate(
                    merge_intervals(new_ranks, w, n_new)):
                c_lo, c_hi = int(new_all[lo]), int(new_all[hi - 1])
                comp_ranges.append((c_lo, c_hi))
                old_part = self.index.take_comp_range(c_lo, c_hi)
                blo = int(np.searchsorted(q, c_lo, side="left"))
                bhi = int(np.searchsorted(q, c_hi, side="right"))
                new_part = E.host_take(srun, np.arange(blo, bhi))
                if old_part is None:
                    region = new_part
                else:
                    both = E.host_concat([old_part, new_part])
                    region = E.host_take(
                        both, np.argsort(E.composite_order_key(both),
                                         kind="stable"))
                regions.append(region)
                region_eids.append(np.asarray(region["eid"], np.int64))
                region_ivs.append(np.full(int(region["eid"].shape[0]), iv,
                                          np.int64))
            if sp.enabled:
                sp.set(regions=len(regions),
                       rows=sum(int(e.shape[0]) for e in region_eids))
        out = self._apply(blocked, matched, regions, region_eids,
                          region_ivs, int(q.shape[0]), degraded=degraded,
                          comp_ranges=comp_ranges)
        with OBS.span("index", regions=len(regions), rows=int(q.shape[0])):
            self.index.insert(srun)
        return out

    def delete(self, eids, blocked: np.ndarray, matched: np.ndarray,
               *, degraded: bool = False
               ) -> Tuple[np.ndarray, np.ndarray, DeltaStats]:
        """Remove live entities by eid from the maintained sets.  Returns
        (blocked', matched', stats); the index rows are tombstoned.
        ``degraded`` works exactly as in ``insert``."""
        eids = RES.sort_unique(np.asarray(eids, np.int64))
        if eids.shape[0] == 0:
            return blocked, matched, DeltaStats(0, 0, 0, 0, (), _EMPTY,
                                                _EMPTY, _EMPTY, _EMPTY)
        with OBS.span("index") as sp:
            comps = np.sort(self.index.comps_of(eids))
            all_ = self.index.live_comps
            ranks = np.searchsorted(all_, comps)
            regions: List[dict] = []
            region_eids: List[np.ndarray] = []
            region_ivs: List[np.ndarray] = []
            comp_ranges: List[Tuple[int, int]] = []
            w = self.cfg.window
            for iv, (lo, hi) in enumerate(
                    merge_intervals(ranks, w, int(all_.shape[0]))):
                # the region is taken in the PRE-delete order (deleted
                # rows included — they anchor the before-restriction); the
                # device call sees only the survivors, i.e. the
                # post-delete order
                c_lo, c_hi = int(all_[lo]), int(all_[hi - 1])
                comp_ranges.append((c_lo, c_hi))
                region = self.index.take_comp_range(c_lo, c_hi)
                r_eids = np.asarray(region["eid"], np.int64)
                region_eids.append(r_eids)
                region_ivs.append(np.full(r_eids.shape[0], iv, np.int64))
                keep = np.flatnonzero(~RES.isin_sorted(r_eids, eids))
                if keep.shape[0]:
                    regions.append(E.host_take(region, keep))
            if sp.enabled:
                sp.set(regions=len(region_eids),
                       rows=sum(int(e.shape[0]) for e in region_eids))
        out = self._apply(blocked, matched, regions, region_eids,
                          region_ivs, int(eids.shape[0]), degraded=degraded,
                          comp_ranges=comp_ranges)
        with OBS.span("index", regions=len(region_eids),
                      rows=int(eids.shape[0])):
            self.index.delete(eids)
        return out

    def refresh(self, comp_ranges: Sequence[Tuple[int, int]],
                blocked: np.ndarray, matched: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray, DeltaStats]:
        """The repair pass: re-resolve the given inclusive composite
        ranges EXACTLY (full device path, real matcher) against the
        CURRENT live corpus and fold the results into the maintained
        sets.  No index mutation.

        Correctness (DESIGN.md §13): a degraded mutation's matched errors
        are confined to pairs with both endpoints inside one recorded
        comp_range at the time — composites never change, later exact
        mutations self-heal any overlap they touch, and a contiguous
        composite range is a contiguous rank range, so the exact
        maintained set restricted to in-range pairs equals the range's
        complete SN pairs.  Re-deriving that restriction from a device
        call therefore erases every residual error; over-coverage (ranges
        grown by merging, or entities inserted into a dirty range after
        it was recorded) is idempotent."""
        regions: List[dict] = []
        region_eids: List[np.ndarray] = []
        region_ivs: List[np.ndarray] = []
        for c_lo, c_hi in comp_ranges:
            region = self.index.take_comp_range(int(c_lo), int(c_hi))
            if region is None:
                continue
            iv = len(regions)
            r_eids = np.asarray(region["eid"], np.int64)
            regions.append(region)
            region_eids.append(r_eids)
            region_ivs.append(np.full(r_eids.shape[0], iv, np.int64))
        return self._apply(blocked, matched, regions, region_eids,
                           region_ivs, 0, comp_ranges=tuple(
                               (int(a), int(b)) for a, b in comp_ranges))


def srp_straddle_packed(index, cfg) -> np.ndarray:
    """The SRP-variant serving correction: packed pairs of the COMPLETE set
    that cross a partition boundary of the plan
    ``plan_from_profile(index.profile, cfg.partitioner, cfg.num_shards)``
    — exactly the plan a from-scratch SRP resolve of the live corpus would
    run (the profile is merged incrementally but exactly).  SRP's served
    set is complete \\ straddle; boundary-complete variants need none.

    O(r · w²) host work against the flat rank index per call.
    """
    n = index.n_live
    r = cfg.num_shards
    w = cfg.window
    if n == 0 or r <= 1:
        return _EMPTY
    plan = B.plan_from_profile(index.profile, cfg.partitioner, r)
    lo_l, hi_l = [], []
    for b in RES.sort_unique(plan.rank_bounds).tolist():
        if b <= 0 or b >= n:
            continue
        lo, hi = max(0, b - (w - 1)), min(n, b + (w - 1))
        eids = index.eids_at_ranks(lo, hi)
        for jr in range(b, hi):
            for ir in range(max(lo, jr - (w - 1)), b):
                lo_l.append(int(eids[ir - lo]))
                hi_l.append(int(eids[jr - lo]))
    if not lo_l:
        return _EMPTY
    return RES.unique_packed(RES.pack_pairs(np.asarray(lo_l, np.int64),
                                            np.asarray(hi_l, np.int64)))
