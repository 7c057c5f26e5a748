"""DEPRECATED shim over ``repro_torch.api`` — the old free-function
pipeline, port of ``repro.core.pipeline``.

The canonical entry point is the typed facade:

    from repro_torch import api
    res = api.resolve(ents, api.ERConfig(variant="repsn", runner="vmap",
                                         num_shards=r, window=w))

This module keeps the original surface (``SNConfig``, ``sn_shard``,
``shard_input``, ``run_vmap``, ``run_shard_map``, ``extract_pairs``,
``result_pairs``, ``blocked_pairs``) working: every function forwards to
the variant registry / runners / result helpers in ``repro_torch.api``
and — for the run/collect entry points — emits a DeprecationWarning
naming its replacement.  ``SNConfig`` has no ``band_engine``, so the
shims run the ``scan`` engine, and no static fingerprint, so the runners
run them eagerly (past the executable cache), as the reference's do.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Set, Tuple

from repro_torch.core.match import CascadeMatcher, default_matcher


def _deprecated(old: str, new: str) -> None:
    warnings.warn(f"repro_torch.core.pipeline.{old} is deprecated; use "
                  f"{new}", DeprecationWarning, stacklevel=3)


@dataclass(frozen=True)
class SNConfig:
    """Old blocking config — superseded by ``repro_torch.api.ERConfig``
    (which also carries runner/partitioner/linkage choices)."""
    window: int = 10
    variant: str = "repsn"            # any registered variant name
    hops: int = 1                      # halo hops (repsn; 1 = paper)
    cap_factor: float = 0.0           # link capacity = cap0*cap_factor/r;
                                       # 0 -> cap0 (never overflows)
    matcher: CascadeMatcher = field(default_factory=default_matcher)
    return_scores: bool = False        # band scores (B) vs match mask (M)


def sn_shard(ents: dict, bounds, r: int, axis, cfg: SNConfig) -> dict:
    """Per-shard SN program, dispatched through the variant registry
    (``repro_torch.api.variants``).  ``axis``: the port's shard axis
    (``core.collectives.LocalAxis`` / ``GroupAxis``); a name (the
    reference's vmap axis, e.g. "sn") means the r local shards of a
    leading dim."""
    from repro_torch.api.variants import get_variant
    variant = get_variant(cfg.variant)
    return variant.shard_program(ents, bounds, r, cfg, axis=None if
                                 isinstance(axis, str) else axis)


def shard_input(ents: dict, r: int) -> dict:
    from repro_torch.api.runners import shard_input as _shard_input
    return _shard_input(ents, r)


def run_vmap(ents: dict, r: int, bounds, cfg: SNConfig, *,
             device=None) -> dict:
    """``device``: where the r shards run (None: the CUDA card)."""
    _deprecated("run_vmap",
                "repro_torch.api.resolve(..., ERConfig(runner='vmap')) or "
                "repro_torch.api.VmapRunner(r).run_raw")
    from repro_torch.api.runners import VmapRunner
    return VmapRunner(num_shards=r, device=device).run_raw(ents, bounds,
                                                           cfg)


def run_shard_map(ents: dict, mesh, axis: str, bounds, cfg: SNConfig, *,
                  device=None) -> dict:
    """``mesh``: a ``repro_torch.launch.Mesh``; ``device``: where this
    rank's shard runs (None: the CUDA card)."""
    _deprecated("run_shard_map",
                "repro_torch.api.resolve(..., ERConfig(runner='shard_map')) "
                "or repro_torch.api.ShardMapRunner(mesh, axis).run_raw")
    from repro_torch.api.runners import ShardMapRunner
    return ShardMapRunner(mesh=mesh, axis=axis, device=device).run_raw(
        ents, bounds, cfg)


# -- host-side pair extraction ----------------------------------------------------

def extract_pairs(part: dict) -> Set[Tuple[int, int]]:
    """Matched pairs of one stacked band part (vectorized in
    ``repro_torch.api.results.pairs_from_band``)."""
    from repro_torch.api.results import pairs_from_band
    return pairs_from_band(part, "match")


def result_pairs(out: dict) -> Set[Tuple[int, int]]:
    _deprecated("result_pairs", "repro_torch.api.resolve(...).matches")
    from repro_torch.api.results import pairs_from_band
    pairs = pairs_from_band(out["main"], "match")
    if "boundary" in out:
        pairs |= pairs_from_band(out["boundary"], "match")
    return pairs


def blocked_pairs(out: dict) -> Set[Tuple[int, int]]:
    """Pairs generated by BLOCKING (the band mask, pre-matching) — the
    paper reports B, the blocking correspondences (§4.1)."""
    _deprecated("blocked_pairs",
                "repro_torch.api.resolve(...).blocking.pairs")
    from repro_torch.api.results import pairs_from_band
    pairs = pairs_from_band(out["main"], "mask")
    if "boundary" in out:
        pairs |= pairs_from_band(out["boundary"], "mask")
    return pairs
