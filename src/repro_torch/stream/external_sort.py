"""External merge sort over entity chunks (the streaming sort phase; port
of ``repro.stream.external_sort``, host numpy).

The paper's MapReduce shuffle sorts the corpus globally by blocking key; on
one accelerator the same global order is produced out-of-core in two steps:

  1. **Per-chunk device sort** (``entities.sort_chunk``): each ingested
     chunk is sorted by (key, eid) on the device — the O(n log n) work — and
     lands back on host as a *sorted run* (spooled via ``ChunkStore``).
  2. **K-way galloping merge** (``merged_blocks``): runs are merged on the
     single int64 composite key ``(key << 32) | eid``
     (``entities.composite_order_key``).  Each step takes the longest
     prefix of the smallest-headed run that stays below every other run's
     head (one ``searchsorted`` — a gallop, not an element-wise heap), so
     the merge is O(total + k·log) with only run INDICES (key/eid) resident
     plus the runs currently contributing rows; payload arrays are loaded
     per run on first contribution and released when the run is exhausted.

The merged stream is yielded as host blocks of at most ``block`` rows — the
consumer (``resolver``) never sees, and the process never materializes, the
full sorted corpus in one array.  Under an active tracer each yielded block
adds one to the ``merge_blocks`` counter: the merge's work grows with the
(key, run) pairs of the corpus, one block per run that holds a key.
"""
from __future__ import annotations

from typing import Iterator, List

import numpy as np

from repro_torch import obs as OBS
from repro_torch.core import entities as E
from repro_torch.stream.store import ChunkStore


def _composites(runs: ChunkStore) -> List[np.ndarray]:
    """Per-run int64 merge keys, loaded from the index columns only."""
    return [E.composite_order_key(runs.load_index(i))
            for i in range(len(runs))]


def merged_blocks(runs: ChunkStore, block: int) -> Iterator[dict]:
    """Yield the globally (key, eid)-sorted stream of all ``runs`` as host
    entity blocks of at most ``block`` rows (see module doc).

    Runs must each already be sorted by (key, eid) — ``entities.sort_chunk``
    output.  Equal composite keys across runs (duplicate (key, eid) pairs)
    are emitted in run order, one row at a time, so the merge always makes
    progress and stays deterministic."""
    if block < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    tracer = OBS.current_tracer()
    blocks = None if tracer is None else tracer.metrics.counter(
        "merge_blocks")
    comps = _composites(runs)
    cursors = [0] * len(runs)
    active = [i for i in range(len(runs)) if comps[i].shape[0] > 0]
    open_runs: dict = {}
    while active:
        i = min(active, key=lambda j: comps[j][cursors[j]])
        others = [comps[j][cursors[j]] for j in active if j != i]
        ci = comps[i]
        if others:
            end = int(np.searchsorted(ci, min(others), side="left"))
            if end <= cursors[i]:           # tie on the composite key:
                end = cursors[i] + 1        # emit one row, stay stable
        else:
            end = ci.shape[0]
        end = min(end, cursors[i] + block)
        if i not in open_runs:              # payload loads lazily, once
            open_runs[i] = runs.load(i)
        if blocks is not None:
            blocks.inc()
        yield E.host_take(open_runs[i], slice(cursors[i], end))
        cursors[i] = end
        if end == ci.shape[0]:
            active.remove(i)
            open_runs.pop(i, None)          # release the exhausted run


def rechunk(blocks: Iterator[dict], size: int) -> Iterator[dict]:
    """Re-block a stream of host entity dicts into chunks of EXACTLY
    ``size`` rows (the final chunk may be shorter) — the fixed native chunk
    width that keeps every streamed shard program the same shape."""
    if size < 1:
        raise ValueError(f"size must be >= 1, got {size}")
    buf: List[dict] = []
    total = 0
    for b in blocks:
        buf.append(b)
        total += int(b["key"].shape[0])
        while total >= size:
            big = E.host_concat(buf)
            yield E.host_take(big, slice(0, size))
            rest = E.host_take(big, slice(size, None))
            total = int(rest["key"].shape[0])
            buf = [rest] if total else []
    if total:
        yield E.host_concat(buf)
