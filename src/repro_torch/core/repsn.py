"""RepSN — Sorted Neighborhood with entity replication (paper §4.3).

The paper replicates the w-1 highest-keyed entities of each partition to
its successor reducer.  With the shard dim explicit this is a halo
exchange over the local sorted shards (L, M, ...): each shard's last w-1
valid entities move one hop forward — the reference's ring ``ppermute``,
supplied by the axis object (``core/collectives.py``) — with shard 0's
received halo invalidated (it has no predecessor).

``hops > 1`` iterates the halo so windows spanning more than one partition
boundary (partitions holding fewer than w-1 entities) are complete too;
``hops = r-1`` is always sufficient.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import entities as E


def tail_window(ents: dict, w: int, *, presorted: bool = False) -> dict:
    """Each shard's last w-1 valid entities (in key order), rolled so
    padding sits FIRST — prepending this to a sorted shard keeps valid
    slots contiguous.  ``presorted=True`` skips the (key, eid) sort."""
    s = ents if presorted else E.sort_entities(ents)
    nv = E.n_valid(s)
    start = torch.clamp(nv - (w - 1), 0, s["key"].shape[-1])
    tail = E.slice_entities(s, start, w - 1)
    # if nv < w-1 the slice has trailing invalid slots: rotate them first
    shift = torch.clamp_min((w - 1) - nv, 0)
    return E.roll(tail, shift)


def _ring_fwd(ents: dict, axis) -> dict:
    """One forward halo hop: shard s receives shard s-1's entities; the
    wrapped edge (shard r-1 -> shard 0) is invalidated."""
    out = E.map_fields(ents, axis.ppermute_fwd)
    first = (axis.axis_index(out["valid"].device) == 0).unsqueeze(-1)
    out["valid"] = out["valid"] & ~first
    out["key"] = torch.where(out["valid"], out["key"],
                             torch.full_like(out["key"], E.INVALID_KEY))
    return out


def halo_exchange(sorted_ents: dict, w: int, axis, hops: int = 1) -> dict:
    """The (w-1)-slot halo per shard: the last w-1 global predecessors of
    its key range (valid contiguous at the halo's tail)."""
    halo = _ring_fwd(tail_window(sorted_ents, w, presorted=True), axis)
    for _ in range(hops - 1):
        # [halo | native] interleaves the halo's leading padding with
        # native keys, so the multi-hop concat needs the sort
        halo = _ring_fwd(tail_window(E.concat(halo, sorted_ents), w), axis)
    return halo


def repsn_combine(sorted_ents: dict, w: int, axis,
                  hops: int = 1) -> Tuple[dict, int]:
    """Prepend the halo; returns (combined (L, w-1+M, ...), halo_len).

    The window over the combined slots with mode="native" emits exactly
    the SRP pairs plus each shard's boundary pairs — together, the
    complete sequential-SN pair set."""
    halo = halo_exchange(sorted_ents, w, axis, hops=hops)
    return E.concat(halo, sorted_ents), w - 1
