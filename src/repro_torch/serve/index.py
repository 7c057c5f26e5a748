"""Persistent sorted index — the long-lived corpus behind the serving layer
(port of ``repro.serve.index``; host numpy, the reference's segment and
spool files, so a snapshot either package wrote restores in the other).

An LSM-flavored adaptation of the streaming sort phase
(``repro_torch.stream``): the corpus lives as SORTED RUNS in a
``stream.store.ChunkStore`` (payload on spool, exactly like the external
merge), while a small resident rank index —
the per-run int64 composite keys ``(key << 32) | eid`` plus one flat sorted
array of all LIVE composites — answers the only questions the delta matcher
asks in O(log n): where does an entity land in the global (key, eid) sort
order, and which entities occupy a contiguous rank range.

  * ``insert(run)``   appends one device-sorted run (``entities.sort_chunk``
                      output) and folds its key distribution into the
                      incrementally-merged ``balance.KeyProfile`` — planning
                      state stays exact under writes.
  * ``delete(eids)``  tombstones rows in place (per-run live masks; the
                      profile is decremented exactly via
                      ``KeyProfile.merge(..., remove=True)``).  Deleted rows
                      stay on spool until compaction.
  * ``take_comp_range``  materializes the live entities of one composite-key
                      range — the w-neighborhood gather of the delta matcher.
  * ``compact()``     rewrites every run into fresh generation runs through
                      the external-sort machinery (``merged_blocks`` k-way
                      gallop over a tombstone-masked view + ``rechunk``),
                      reclaiming tombstoned rows and spool bytes;
                      ``maybe_compact`` triggers it when the run count or
                      tombstone fraction crosses a threshold.

The flat live-composite array costs 8 bytes/entity resident (the payload
never is) and is maintained incrementally — one ``np.insert``/``np.delete``
per micro-batch, not a re-sort.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch import balance as B
from repro_torch import obs as OBS
from repro_torch.api.results import sort_unique
from repro_torch.core import entities as E
from repro_torch.stream.external_sort import merged_blocks, rechunk
from repro_torch.stream.store import ChunkStore, atomic_write_json

_INDEX_MANIFEST = "INDEX.json"

_EID_MASK = np.int64(0xFFFFFFFF)


class _MaskedRuns:
    """Duck-typed ChunkStore view that hides tombstoned rows: masking a
    sorted run keeps it sorted, so ``external_sort.merged_blocks`` consumes
    the view unchanged — the compaction merge IS the streaming merge."""

    def __init__(self, runs: ChunkStore, masks: List[np.ndarray]):
        self._runs = runs
        self._masks = masks

    def __len__(self) -> int:
        return len(self._runs)

    def load_index(self, i: int) -> Dict[str, np.ndarray]:
        idx = self._runs.load_index(i)
        m = self._masks[i]
        return {"key": idx["key"][m], "eid": idx["eid"][m]}

    def load(self, i: int) -> dict:
        return E.host_take(self._runs.load(i), self._masks[i])


class SortedIndex:
    """Persistent sorted index over one entity corpus (see module doc).

    ``spool_dir=None`` keeps runs in memory; ``segment_rows`` is the run
    width compaction rewrites to; ``max_runs``/``max_tombstone_frac`` are
    the ``maybe_compact`` thresholds."""

    def __init__(self, window: int, *, spool_dir: Optional[str] = None,
                 segment_rows: int = 4096, max_runs: int = 12,
                 max_tombstone_frac: float = 0.25, merge_block: int = 4096):
        self.window = window
        self.spool_dir = spool_dir
        self.segment_rows = segment_rows
        self.max_runs = max_runs
        self.max_tombstone_frac = max_tombstone_frac
        self.merge_block = merge_block
        self._gen = 0
        self._runs = ChunkStore(spool_dir, prefix="g000-")
        self._comps: List[np.ndarray] = []      # per-run sorted composites
        self._live: List[np.ndarray] = []       # per-run bool masks
        self._loc: Dict[int, Tuple[int, int]] = {}   # live eid -> (run, row)
        self._all = np.empty((0,), np.int64)    # sorted LIVE composites
        self.profile = B.KeyProfile.empty(window)
        self.tombstones = 0
        self.compactions = 0

    # -- introspection -------------------------------------------------------

    @property
    def n_live(self) -> int:
        """Live (non-tombstoned) entity count."""
        return int(self._all.shape[0])

    @property
    def n_rows(self) -> int:
        """Stored rows including tombstones (reclaimed by compaction)."""
        return sum(int(c.shape[0]) for c in self._comps)

    @property
    def n_runs(self) -> int:
        """Current sorted-run count (compaction folds them back down)."""
        return len(self._comps)

    @property
    def live_comps(self) -> np.ndarray:
        """The flat sorted array of live composites (read-only view): rank
        r holds the composite of the entity at global sorted rank r."""
        return self._all

    def eids_at_ranks(self, lo: int, hi: int) -> np.ndarray:
        """Eids of the live entities at global sorted ranks [lo, hi)."""
        return (self._all[lo:hi] & _EID_MASK).astype(np.int64)

    def comps_of(self, eids: np.ndarray) -> np.ndarray:
        """Composite keys of live entities by eid (aligned with ``eids``);
        raises on an eid that is unknown or already deleted."""
        out = np.empty(len(eids), np.int64)
        for i, e in enumerate(np.asarray(eids, np.int64).tolist()):
            loc = self._loc.get(int(e))
            if loc is None:
                raise ValueError(f"eid {e} is not live in the index")
            out[i] = self._comps[loc[0]][loc[1]]
        return out

    def assert_new_eids(self, eids: np.ndarray) -> None:
        """Reject eids that are already live (re-inserting a DELETED eid is
        fine — its tombstoned row is invisible and reclaimed on compaction)."""
        arr = np.asarray(eids, np.int64)
        uniq = sort_unique(arr)
        if uniq.shape[0] != arr.shape[0]:
            raise ValueError("insert batch contains duplicate eids")
        clash = [int(e) for e in uniq.tolist() if int(e) in self._loc]
        if clash:
            raise ValueError(f"eids already live in the index: {clash[:8]}")

    # -- mutation ------------------------------------------------------------

    def insert(self, run: dict) -> np.ndarray:
        """Append one sorted run (host dict from ``entities.sort_chunk``:
        (key, eid)-sorted, invalid rows dropped) and fold its keys into the
        merged profile.  Returns the run's composite keys."""
        comps = E.composite_order_key(run)
        if comps.shape[0] == 0:
            return comps
        if np.any(np.diff(comps) < 0):
            raise ValueError("insert expects a (key, eid)-sorted run "
                             "(entities.sort_chunk output)")
        eids = np.asarray(run["eid"], np.int64)
        self.assert_new_eids(eids)
        run_id = len(self._comps)
        self._runs.append(run)
        self._comps.append(comps)
        self._live.append(np.ones(comps.shape[0], bool))
        for row, e in enumerate(eids.tolist()):
            self._loc[int(e)] = (run_id, row)
        pos = np.searchsorted(self._all, comps)
        self._all = np.insert(self._all, pos, comps)
        self.profile = self.profile.merge(
            B.profile_keys(np.asarray(run["key"]), window=self.window))
        return comps

    def delete(self, eids: np.ndarray) -> np.ndarray:
        """Tombstone live entities by eid (profile decremented exactly).
        Returns their composite keys, sorted."""
        comps = np.sort(self.comps_of(eids))
        keys = (comps >> np.int64(32)).astype(np.int32)
        for e in np.asarray(eids, np.int64).tolist():
            run, row = self._loc.pop(int(e))
            self._live[run][row] = False
        ranks = np.searchsorted(self._all, comps)
        self._all = np.delete(self._all, ranks)
        self.profile = self.profile.merge(
            B.profile_keys(keys, window=self.window), remove=True)
        self.tombstones += int(comps.shape[0])
        return comps

    # -- reads ---------------------------------------------------------------

    def take_comp_range(self, c_lo: int, c_hi: int) -> Optional[dict]:
        """Materialize the LIVE entities with composite key in the inclusive
        range [c_lo, c_hi] as one (key, eid)-sorted host dict (payload
        gathered from the spooled runs); None when the range is empty."""
        comp_parts: List[np.ndarray] = []
        row_parts: List[dict] = []
        for i, comps in enumerate(self._comps):
            lo = int(np.searchsorted(comps, c_lo, side="left"))
            hi = int(np.searchsorted(comps, c_hi, side="right"))
            if lo == hi:
                continue
            rows = lo + np.flatnonzero(self._live[i][lo:hi])
            if rows.shape[0] == 0:
                continue
            comp_parts.append(comps[rows])
            row_parts.append(E.host_take(self._runs.load(i), rows))
        if not row_parts:
            return None
        order = np.argsort(np.concatenate(comp_parts), kind="stable")
        return E.host_take(E.host_concat(row_parts), order)

    def scan_live(self, block: int = 4096) -> Iterator[dict]:
        """The galloping merge view: yield every live entity in global
        (key, eid) order as host blocks (``external_sort.merged_blocks``
        over the tombstone-masked runs)."""
        return merged_blocks(_MaskedRuns(self._runs, self._live), block)

    # -- durability ----------------------------------------------------------

    def snapshot(self, snapshot_dir: str) -> dict:
        """Persist the LIVE corpus to ``snapshot_dir``: the tombstone-masked
        galloping merge (the compaction view) re-blocked into sorted
        ``seg%06d.npz`` segments plus an ``INDEX.json`` manifest, every file
        written atomically with the manifest LAST — a crash mid-snapshot
        leaves the previous snapshot (or no manifest), never a torn one.
        Tombstoned rows are not persisted; a restored index starts
        compacted.  Returns the manifest dict."""
        os.makedirs(snapshot_dir, exist_ok=True)
        store = ChunkStore(snapshot_dir, prefix="seg")
        for chunk in rechunk(self.scan_live(self.merge_block),
                             self.segment_rows):
            store.append(chunk)
        manifest = {"version": 1, "window": self.window,
                    "segment_rows": self.segment_rows,
                    "segments": len(store), "n_live": self.n_live}
        atomic_write_json(os.path.join(snapshot_dir, _INDEX_MANIFEST),
                          manifest)
        return manifest

    @classmethod
    def restore(cls, snapshot_dir: str, *, spool_dir: Optional[str] = None,
                **kwargs) -> "SortedIndex":
        """Rebuild an index from a ``snapshot`` directory.  Segments replay
        through the ordinary ``insert`` path, and ``KeyProfile.merge`` is
        exact, so the restored profile — and therefore every plan and
        served pair set derived from it — is identical to the live index's
        at snapshot time.  ``spool_dir``/remaining kwargs configure the NEW
        index (the snapshot dir itself is never written to)."""
        mpath = os.path.join(snapshot_dir, _INDEX_MANIFEST)
        if not os.path.exists(mpath):
            raise FileNotFoundError(
                f"no index snapshot manifest at {mpath!r}")
        with open(mpath) as f:
            manifest = json.load(f)
        if manifest.get("version") != 1:
            raise ValueError(f"unsupported index snapshot version "
                             f"{manifest.get('version')!r}")
        store = ChunkStore.attach(snapshot_dir, "seg",
                                  count=manifest["segments"])
        idx = cls(manifest["window"], spool_dir=spool_dir,
                  segment_rows=manifest["segment_rows"], **kwargs)
        for chunk in store:
            idx.insert(chunk)
        return idx

    # -- compaction ----------------------------------------------------------

    def maybe_compact(self) -> bool:
        """Compact when the run count exceeds ``max_runs`` or tombstones
        exceed ``max_tombstone_frac`` of stored rows; returns True when a
        compaction ran."""
        rows = self.n_rows
        if self.n_runs > self.max_runs or (
                rows > 0 and self.tombstones > self.max_tombstone_frac * rows):
            self.compact()
            return True
        return False

    def compact(self) -> None:
        """Rewrite all runs into a fresh generation (k-way galloping merge
        of the live rows, re-blocked to ``segment_rows``), dropping
        tombstoned rows and their spool bytes.  The live entity set, the
        flat rank index, and the merged profile are all unchanged —
        compaction is invisible to readers.  Traced, a ``compact`` span
        (``rows``: the live rows rewritten; ``runs``: the runs after)."""
        with OBS.span("compact", rows=self.n_live) as sp:
            self._gen += 1
            fresh = ChunkStore(self.spool_dir, prefix=f"g{self._gen:03d}-")
            for chunk in rechunk(self.scan_live(self.merge_block),
                                 self.segment_rows):
                fresh.append(chunk)
            old = self._runs
            self._runs = fresh
            self._comps = [E.composite_order_key(fresh.load_index(i))
                           for i in range(len(fresh))]
            self._live = [np.ones(c.shape[0], bool) for c in self._comps]
            self._loc = {}
            for run_id in range(len(fresh)):
                for row, e in enumerate(
                        np.asarray(fresh.load_index(run_id)["eid"],
                                   np.int64).tolist()):
                    self._loc[int(e)] = (run_id, row)
            old.dispose()
            self.tombstones = 0
            self.compactions += 1
            sp.set(runs=len(fresh))
