"""SRP — Sorted Reduce Partitions (paper §4.1), with the shard dim explicit.

The MapReduce shuffle with composite key ``p(k).k`` becomes, over stacked
mapper shards (r, cap0, ...):

  1. map side: dest = p(key) per entity (partition.shard_of)
  2. bucketize into a fixed-capacity (r, r*cap_link) buffer, ranked within
     each destination by a stable sort (capacity + overflow accounting, as
     in the reference)
  3. the exchange: the reference's ``all_to_all`` over the shard axis,
     supplied by the axis object (``core/collectives.py``): a transpose
     of the (r_src, r_dst, cap_link, ...) buffer when all shards are
     local, ``torch.distributed`` when each rank holds one
  4. reduce-side sort by (key, eid) -> globally range-sorted shards

The reference's ``psum``/``all_gather`` of the overflow and load come from
the same axis object; every shard keeps its copy, so outputs have the
reference's per-shard shapes.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import entities as E
from repro_torch.core import partition as P
from repro_torch.core.collectives import LocalAxis


def bucketize(ents: dict, dest: torch.Tensor, r: int,
              cap_link: int) -> Tuple[dict, torch.Tensor]:
    """Scatter each mapper shard's entities into r*cap_link slots grouped by
    destination.  Returns (bucketed (r, r*cap_link, ...), overflow (r,)
    int32 per mapper); entities beyond a bucket's capacity are dropped and
    counted."""
    n = dest.shape[-1]
    dev = dest.device
    lead = tuple(dest.shape[:-1])
    d = torch.where(ents["valid"], dest, r)               # invalid -> dump
    order = torch.sort(d, dim=-1, stable=True).indices
    sd = d.gather(-1, order).to(torch.int64)
    counts = torch.zeros(lead + (r + 1,), dtype=torch.int64, device=dev) \
        .scatter_add_(-1, sd, torch.ones_like(sd))
    offs = torch.cumsum(counts, dim=-1) - counts          # exclusive
    pos = torch.arange(n, device=dev) - offs.gather(-1, sd)
    keep = (pos < cap_link) & (sd < r)
    n_slots = r * cap_link
    slot = torch.where(keep, sd * cap_link + pos, n_slots)

    src = E.permute(ents, order)
    out = E.empty_like(ents, n_slots + 1)
    rd = dest.dim() - 1
    # slot n_slots is the dump for dropped entities, sliced off here
    scat = lambda buf, val: \
        E.put_rows(buf, slot, val, rd).narrow(rd, 0, n_slots)
    bucketed = {
        "key": scat(out["key"], torch.where(
            keep, src["key"], torch.full_like(src["key"], E.INVALID_KEY))),
        "eid": scat(out["eid"], src["eid"]),
        "valid": scat(out["valid"], src["valid"] & keep),
        "payload": {k: scat(out["payload"][k], v)
                    for k, v in src["payload"].items()},
    }
    overflow = ((~keep) & (sd < r)).sum(dim=-1, dtype=torch.int32)
    return bucketed, overflow


def exchange(bucketed: dict, axis) -> dict:
    """The shuffle: shard t receives block t of every mapper s (one
    ``all_to_all`` per field over ``axis``)."""
    return E.map_fields(bucketed, axis.all_to_all)


def srp_shard(ents: dict, bounds, r: int, cap_link: int,
              axis=None) -> Tuple[dict, torch.Tensor]:
    """Full SRP over the local mapper shards (L, cap0, ...) of an ``r``-
    shard axis (None: all r local): returns (sorted reduce partitions
    (L, r*cap_link, ...), overflow (L,) — the global count in every
    shard's slot, the reference's psum).

    A ``_dest`` payload field (rank-granular ShardPlan routing) overrides
    the key->shard function; it is consumed map-side and stripped before
    the shuffle."""
    dest = ents["payload"].get("_dest")
    if dest is None:
        dest = P.shard_of(bounds, ents["key"])
    else:
        ents = dict(ents)
        ents["payload"] = {k: v for k, v in ents["payload"].items()
                           if k != "_dest"}
    axis = LocalAxis(r) if axis is None else axis
    buf, overflow = bucketize(ents, dest, r, cap_link)
    recv = exchange(buf, axis)
    sorted_ents = E.sort_entities(recv)
    return sorted_ents, axis.psum(overflow)


def local_load(ents: dict, axis) -> torch.Tensor:
    """Per-shard valid counts, gathered to every shard: (L, r) (skew
    telemetry, paper §5.3)."""
    return axis.all_gather(E.n_valid(ents))
