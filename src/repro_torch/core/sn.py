"""Sequential Sorted Neighborhood — the paper's baseline (§4, Figure 4).

The oracle for all parallel variants: sort by (key, eid), slide a window of
size w, emit all pairs within distance < w.  Pure numpy on the host — the
port's own copy of ``repro.core.sn`` (the port imports nothing of
``repro``).
"""
from __future__ import annotations

from typing import Callable, Set, Tuple

import numpy as np


def sequential_sn_pairs(keys: np.ndarray, eids: np.ndarray,
                        w: int) -> Set[Tuple[int, int]]:
    """All SN pairs as a set of (eid_lo, eid_hi) with the paper's window
    semantics: entities at sorted distance 1..w-1 are compared."""
    order = np.lexsort((eids, keys))
    se = eids[order]
    n = len(se)
    pairs = set()
    for i in range(n):
        for j in range(i + 1, min(i + w, n)):
            a, b = int(se[i]), int(se[j])
            pairs.add((min(a, b), max(a, b)))
    return pairs


def adaptive_sn_pairs(keys: np.ndarray, eids: np.ndarray,
                      weff: np.ndarray) -> Set[Tuple[int, int]]:
    """Adaptive-window SN oracle: each entity carries its OWN effective
    window, and the pair (i-d, i) exists iff d < weff[i] — the LATER sorted
    element owns the comparison (the same ownership rule the band mask and
    the profile cost model use).  ``weff`` is per-entity, aligned with
    ``keys``/``eids`` BEFORE sorting; constant weff == w reduces exactly to
    ``sequential_sn_pairs``."""
    order = np.lexsort((eids, keys))
    se = eids[order]
    sw = np.asarray(weff)[order]
    n = len(se)
    pairs = set()
    for j in range(n):
        for d in range(1, int(sw[j])):
            i = j - d
            if i < 0:
                break
            a, b = int(se[i]), int(se[j])
            pairs.add((min(a, b), max(a, b)))
    return pairs


def expected_pair_count(n: int, w: int) -> int:
    """Exact count of sliding-window pairs for n >= w (the paper states
    (n - w/2)(w-1); exactly: (n-w+1)(w-1) full windows + (w-1)w/2 tail... the
    closed form below is the true count of pairs with distance in [1, w-1]."""
    if n <= 1 or w <= 1:
        return 0
    we = min(w - 1, n - 1)
    # sum_{d=1..we} (n - d)
    return we * n - we * (we + 1) // 2


def srp_missed_boundary_pairs(r: int, w: int) -> int:
    """Paper §4.1: SRP alone misses (r-1) * w * (w-1) / 2 pairs (when every
    partition holds at least w-1 entities).  NOTE the paper's formula counts
    w(w-1)/2 per boundary = the number of cross-boundary pairs at distance
    < w."""
    return (r - 1) * w * (w - 1) // 2


def sequential_sn_matches(keys, eids, w: int,
                          sim_fn: Callable[[int, int], float],
                          threshold: float) -> Set[Tuple[int, int]]:
    """Sequential blocking + matching (the full ER workflow, Figure 2)."""
    order = np.lexsort((eids, keys))
    n = len(order)
    out = set()
    for oi in range(n):
        for oj in range(oi + 1, min(oi + w, n)):
            i, j = int(order[oi]), int(order[oj])
            if sim_fn(i, j) >= threshold:
                a, b = int(eids[i]), int(eids[j])
                out.add((min(a, b), max(a, b)))
    return out
