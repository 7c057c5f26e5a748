"""Capacity auto-sizing: KeyProfile -> band/pair buffer capacities (port of
``repro.balance.capacity``).

  cand_cap   per-shard survivor buffer of the pallas cascade compaction
             (overflow loses MATCHES, never blocked pairs)
  pair_cap   per-shard emitted-index buffer under ``emit="pairs"``
             (overflow loses BLOCKED pairs — must be a hard bound)

A shard holding L entities (plus its w-1 halo) owns at most (w-1)*(L+w-1)
band slots, so capacities sized from the planned maximum load never
overflow; ``observed_cand`` optionally tightens ``cand_cap`` to ~1.25x the
busiest shard's measured gate survivors.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np

from repro_torch.balance.planners import plan_from_profile
from repro_torch.balance.profile import KeyProfile

# deterministic headroom on top of the exact bounds
_SLACK = 16


class CapSuggestion(NamedTuple):
    """Derived capacities; ``max_load`` is the planned busiest-shard entity
    count INCLUDING the w-1 halo."""
    cand_cap: int
    pair_cap: int
    max_load: int


def suggest_caps(profile: Optional[KeyProfile], cfg, r: Optional[int] = None,
                 *, max_load: Optional[int] = None,
                 observed_cand: Optional[Sequence[int]] = None
                 ) -> CapSuggestion:
    """Derive ``cand_cap``/``pair_cap`` from a ``KeyProfile`` (or from an
    explicit ``max_load``, which skips planning)."""
    w = cfg.window
    if r is None:
        r = cfg.num_shards
    if max_load is None:
        if profile is None or profile.n == 0:
            raise ValueError("cannot size capacities from an empty profile; "
                             "pass max_load explicitly")
        plan = plan_from_profile(profile, cfg.partitioner, r)
        max_load = int(np.max(plan.planned_load)) + (w - 1)
    band_bound = (w - 1) * int(max_load) + _SLACK
    if observed_cand is not None and len(observed_cand) > 0:
        cand_cap = min(int(max(observed_cand) * 1.25) + _SLACK, band_bound)
    else:
        cand_cap = band_bound
    return CapSuggestion(cand_cap=cand_cap, pair_cap=band_bound,
                         max_load=int(max_load))
