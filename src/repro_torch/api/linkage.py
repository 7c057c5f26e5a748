"""Dual-source (R x S) record linkage (port of ``repro.api.linkage``; the
multi-source direction of Kirsten et al., "Data Partitioning for Parallel
Entity Matching").

Entities are tagged with an int32 ``src`` payload (0 = left source R,
1 = right source S).  The tag rides the SRP shuffle / halo exchange like any
other payload field, and the band masks are restricted to pairs whose
endpoints carry DIFFERENT tags — blocking and matching then only ever emit
cross-source correspondences, while the sort/window structure (and all three
variants' boundary handling) is unchanged.
"""
from __future__ import annotations

from typing import Set, Tuple

import numpy as np
import torch

from repro_torch.core import entities as E
from repro_torch.core import sn

Pair = Tuple[int, int]


def cross_source_band(src: torch.Tensor, w: int) -> torch.Tensor:
    """(w-1, M) mask: row d-1 true where src[i] != src[i+d] (same band layout
    as window.band_scores).  Delegates to ``window.cross_source_rows`` — the
    single implementation both band engines use."""
    from repro_torch.core.window import cross_source_rows
    return cross_source_rows(src, w)


def tag_sources(lhs: dict, rhs: dict) -> Tuple[dict, int]:
    """Concat two entity sets with source tags and disjoint eids.

    Returns (combined_entities, offset): rhs eids are shifted by ``offset``
    so the merged id space is unique; ``untag_pairs`` maps pairs back to
    (lhs_eid, rhs_eid).  Both inputs must share the same payload schema."""
    lhs_eid = lhs["eid"]
    offset = int(lhs_eid.max()) + 1 if lhs_eid.numel() else 0

    def with_src(ents, tag, shift):
        n = ents["key"].shape[0]
        dev = ents["key"].device
        payload = dict(ents["payload"])
        payload["src"] = torch.full((n,), tag, dtype=torch.int32, device=dev)
        return E.make_entities(ents["key"], ents["eid"] + shift,
                               payload=payload, valid=ents["valid"])

    combined = E.concat(with_src(lhs, 0, 0), with_src(rhs, 1, offset))
    return combined, offset


def untag_pairs(pairs, offset: int) -> Set[Pair]:
    """Map cross-source pairs from the merged eid space back to
    (lhs_eid, rhs_eid) tuples."""
    out: Set[Pair] = set()
    for a, b in pairs:
        if a >= offset:
            a, b = b, a
        out.add((a, b - offset))
    return out


def filter_cross_source(pairs, eids: np.ndarray, src: np.ndarray):
    """Keep only pairs whose endpoints carry different source tags."""
    by_eid = dict(zip(eids.tolist(), src.tolist()))
    return {(a, b) for a, b in pairs if by_eid[a] != by_eid[b]}


def filter_cross_source_packed(packed: np.ndarray, eids: np.ndarray,
                               src: np.ndarray) -> np.ndarray:
    """Vectorized ``filter_cross_source`` over a packed uint64 pair array
    (eid -> src lookup via searchsorted; no Python dict / tuple objects)."""
    from repro_torch.api import results as RES
    if packed.size == 0:
        return packed
    order = np.argsort(eids)
    sorted_eids, sorted_src = eids[order], src[order]
    lo, hi = RES.unpack_pairs(packed)
    s_lo = sorted_src[np.searchsorted(sorted_eids, lo)]
    s_hi = sorted_src[np.searchsorted(sorted_eids, hi)]
    return packed[s_lo != s_hi]


def sequential_link_pairs(keys: np.ndarray, eids: np.ndarray,
                          src: np.ndarray, w: int) -> Set[Pair]:
    """Host oracle: sequential SN window pairs restricted to cross-source
    endpoints (merged eid space)."""
    return filter_cross_source(sn.sequential_sn_pairs(keys, eids, w),
                               eids, src)
