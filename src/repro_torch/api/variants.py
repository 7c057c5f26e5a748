"""Variant registry — the SN strategies behind ``api.resolve`` (port of
``repro.api.variants``).

Each variant owns three hooks:

  * ``shard_program(ents, bounds, r, cfg, cap_link=None, axis=None)``
    the shard program over the local mapper shards (L, cap0, ...) of an
    r-shard axis — the shard dim is explicit where the reference maps a
    named axis, and ``axis`` (``core/collectives.py``) supplies its
    collectives: None (``LocalAxis``) holds all r shards (L = r, the
    vmap runner), a ``GroupAxis`` one shard per rank (L = 1, the
    shard_map runner); returns per-shard outputs with leading dim L:
    ``overflow``, ``load`` and one or more band parts (``main``,
    optionally ``boundary``)
  * ``collect(out)``  host pair sets (blocked + matched) from the runner
    output, deduplicated across parts; ``collect_device(out)`` makes the
    same sets on the output's device and copies only them to the host
  * ``sequential_pairs(keys, eids, bounds, w, part=None)``  the HOST oracle
    with this variant's semantics (SRP: per-partition windows; RepSN/JobSN:
    the complete sequential SN pair set)

New variants register with ``@register_variant("name")``.
"""
from __future__ import annotations

from typing import Dict, Set, Tuple, Type

import numpy as np
import torch

from repro_torch.api import results as RES
from repro_torch.core import jobsn as J
from repro_torch.core import repsn as R
from repro_torch.core import sn
from repro_torch.core import srp as S
from repro_torch.core import window as W
from repro_torch.core.collectives import LocalAxis

_REGISTRY: Dict[str, Type["VariantBase"]] = {}


def register_variant(name: str):
    """Class decorator: ``@register_variant("repsn")``."""
    def deco(cls):
        cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def get_variant(name: str) -> "VariantBase":
    """Instantiate the registered variant named ``name``."""
    try:
        return _REGISTRY[name]()
    except KeyError:
        raise ValueError(f"unknown SN variant {name!r}; registered: "
                         f"{available_variants()}") from None


def available_variants() -> Tuple[str, ...]:
    """Sorted names of every registered SN variant."""
    return tuple(sorted(_REGISTRY))


class VariantBase:
    """Shared SRP front end + band evaluation; subclasses add the variant's
    boundary-handling step."""

    name = "?"
    parts: Tuple[str, ...] = ("main",)
    halo_slices = False        # True: slices w-1 boundary slots per shard
    boundary_complete = True   # sequential_pairs == full SN oracle

    # -- device side ---------------------------------------------------------

    def shard_program(self, ents: dict, bounds, r: int, cfg,
                      cap_link: int = None, axis=None) -> dict:
        """SRP shuffle + this variant's ``_windows`` step over the local
        mapper shards of ``axis`` (None: all r of them).  ``cap_link`` is
        the planner-provided shuffle capacity; None derives it from
        ``cfg.cap_factor``."""
        axis = LocalAxis(r) if axis is None else axis
        cap0 = ents["key"].shape[-1]
        if cap_link is None:
            cap_link = cap0 if cfg.cap_factor <= 0 else \
                max(1, int(np.ceil(cap0 * cfg.cap_factor / r)))
        if self.halo_slices and cfg.window - 1 > r * cap_link:
            raise ValueError(
                f"variant {self.name!r} slices w-1 boundary slots per "
                f"shard, but window={cfg.window} exceeds the per-shard "
                f"buffer of {r * cap_link} slots; reduce window or "
                f"num_shards, raise cap_factor, or use runner='sequential'")
        sorted_ents, overflow = S.srp_shard(ents, bounds, r, cap_link, axis)
        out = {"overflow": overflow,
               "load": S.local_load(sorted_ents, axis)}
        out.update(self._windows(sorted_ents, axis, cfg))
        return out

    def _windows(self, sorted_ents: dict, axis, cfg) -> dict:
        raise NotImplementedError

    def _band(self, e: dict, halo_len: int, mode: str, cfg) -> dict:
        """Evaluate this part's window bands with the configured BandEngine.
        Under ``cfg.emit == "pairs"`` each band is compacted on the device
        into a flat-index buffer (capacity ``cfg.pair_cap``, overflow
        counted) and the part carries those buffers plus the (r, M) eids
        instead of the bands and payload."""
        engine = W.get_band_engine(getattr(cfg, "band_engine", "scan"))
        out = engine.band(e, cfg, halo_len=halo_len, mode=mode)
        if getattr(cfg, "emit", "band") == "pairs":
            m = e["valid"].shape[-1]
            full = (cfg.window - 1) * m
            pair_cap = cfg.pair_cap or 0   # None (unresolved auto) -> full
            cap = min(pair_cap, full) if pair_cap > 0 else full
            bound = engine.match_bound(e, cfg)
            caps = {"mask": cap,
                    "match": cap if bound is None else min(cap, bound)}
            for field in ("mask", "match"):
                emitted = W.emit_band_indices(out.pop(field), caps[field])
                out.update({f"{field}_idx": emitted["idx"],
                            f"{field}_n": emitted["n"],
                            f"{field}_overflow": emitted["overflow"]})
            out["eid"] = e["eid"]
        else:
            out["ents"] = e
        out["halo_len"] = halo_len
        return out

    # -- host side -----------------------------------------------------------

    def collect(self, out: dict) -> RES.CollectedPairs:
        """Host runner output (numpy) -> deduplicated PACKED pair arrays;
        parts are unioned, so a pair emitted twice counts once."""
        blocked = [RES.packed_pairs_from_part(out[p], "mask")
                   for p in self.parts if p in out]
        matched = [RES.packed_pairs_from_part(out[p], "match")
                   for p in self.parts if p in out]
        dedup = lambda parts: RES.unique_packed(np.concatenate(parts)) \
            if parts else np.empty((0,), RES.PACKED_DTYPE)
        return RES.CollectedPairs(blocked=dedup(blocked),
                                  matched=dedup(matched))

    @torch.inference_mode()
    def collect_device(self, out: dict) -> RES.CollectedPairs:
        """``collect`` of the runner output (tensors) on its own device:
        the parts' pairs are packed, unioned, sorted and deduplicated
        there, and only the two finished sets are copied to the host —
        bit-identical to ``collect(runners._to_host(out))``."""
        sets = []
        for field in ("mask", "match"):
            parts = [RES.packed_pairs_device(out[p], field)
                     for p in self.parts if p in out]
            sets.append(RES.unique_packed_device(torch.cat(parts))
                        if parts else np.empty((0,), RES.PACKED_DTYPE))
        return RES.CollectedPairs(blocked=sets[0], matched=sets[1])

    def sequential_pairs(self, keys: np.ndarray, eids: np.ndarray,
                         bounds: np.ndarray, w: int,
                         part: np.ndarray = None,
                         weff: np.ndarray = None) -> Set[Tuple[int, int]]:
        """Host oracle with this variant's semantics (boundary-complete
        variants return the full sequential SN pair set)."""
        if weff is not None:
            return sn.adaptive_sn_pairs(keys, eids, weff)
        return sn.sequential_sn_pairs(keys, eids, w)


@register_variant("srp")
class SrpVariant(VariantBase):
    """Plain Sorted Reduce Partitions (paper §4.1): window within each
    partition only; misses (r-1)*w*(w-1)/2 boundary pairs by design."""

    boundary_complete = False

    def _windows(self, sorted_ents, axis, cfg):
        return {"main": self._band(sorted_ents, 0, "all", cfg)}

    def sequential_pairs(self, keys, eids, bounds, w, part=None, weff=None):
        """SN pairs WITHIN each partition only (``part`` per-entity ids win
        over the ``bounds`` key map)."""
        if part is None:
            part = np.searchsorted(np.asarray(bounds), keys, side="left")
        pairs: Set[Tuple[int, int]] = set()
        for p in np.unique(part):
            sel = part == p
            if weff is not None:
                pairs |= sn.adaptive_sn_pairs(keys[sel], eids[sel],
                                              np.asarray(weff)[sel])
            else:
                pairs |= sn.sequential_sn_pairs(keys[sel], eids[sel], w)
        return pairs


@register_variant("repsn")
class RepSNVariant(VariantBase):
    """SN with replication (paper §4.3): halo-prepend the predecessor's last
    w-1 entities, then window with mode="native"."""

    halo_slices = True

    def _windows(self, sorted_ents, axis, cfg):
        combined, hl = R.repsn_combine(sorted_ents, cfg.window, axis,
                                       hops=cfg.hops)
        return {"main": self._band(combined, hl, "native", cfg)}


@register_variant("jobsn")
class JobSNVariant(VariantBase):
    """SN with an additional phase (paper §4.2): plain SRP window plus a
    boundary-group pass restricted to cross-boundary pairs."""

    parts = ("main", "boundary")
    halo_slices = True

    def _windows(self, sorted_ents, axis, cfg):
        group, hl = J.boundary_group(sorted_ents, cfg.window, axis)
        return {"main": self._band(sorted_ents, 0, "all", cfg),
                "boundary": self._band(group, hl, "cross", cfg)}
