"""JobSN — Sorted Neighborhood with an additional phase (paper §4.2).

Phase 1 = SRP + the window within each partition.  Phase 2 windows each
boundary group (last w-1 of shard i ++ first w-1 of shard i+1) and keeps
only pairs that span the boundary (mode="cross").  The successor's head
reaches shard i by the reference's backward ``ppermute``, supplied by the
axis object (``core/collectives.py``); shard r-1 has no successor, so its
received head is invalidated.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import entities as E
from repro_torch.core.repsn import tail_window


def head_window(ents: dict, w: int, *, presorted: bool = False) -> dict:
    """Each shard's first w-1 slots (sorted shards keep valid first, so
    this is a static slice; trailing slots may be invalid)."""
    s = ents if presorted else E.sort_entities(ents)
    return E.slice_entities(s, 0, w - 1)


def boundary_group(sorted_ents: dict, w: int, axis) -> Tuple[dict, int]:
    """Phase 2 input per shard: [my_tail (w-1) | successor_head (w-1)],
    with halo_len = w-1 marking the boundary for mode="cross"."""
    head = head_window(sorted_ents, w, presorted=True)
    recv = E.map_fields(head, axis.ppermute_back)
    last = (axis.axis_index(recv["valid"].device)
            == axis.size - 1).unsqueeze(-1)
    recv["valid"] = recv["valid"] & ~last
    recv["key"] = torch.where(recv["valid"], recv["key"],
                              torch.full_like(recv["key"], E.INVALID_KEY))
    tail = tail_window(sorted_ents, w, presorted=True)
    return E.concat(tail, recv), w - 1
