"""Sliding-window matching over sorted shards (port of ``repro.core.window``).

The window is evaluated as a BAND: for sorted slots i of a shard,
``band[..., d-1, i] = score(E[i], E[i+d])`` for distance d in 1..w-1.  With
the shard dim explicit every band here is (r, w-1, M) — one (w-1, M) band
per shard — and every op works along the last (slot) dim.

Band evaluation is a pluggable **BandEngine** (``ERConfig.band_engine``):

  * ``scan``    w-1 shifted full-payload passes through
                ``CascadeMatcher.combined`` — the reference oracle
  * ``pallas``  the paper's §5.1 cascade: the fused cheap-band kernel
                (``kernels.ops.fused_cheap_band``: CUDA on the card, its
                plain version on the CPU), cumsum compaction of the gate
                survivors into ``cand_cap``, and the exact matcher on the
                survivors only.  Decisions equal the scan engine's: the gate
                is widened by GATE_EPS and survivors are rescored exactly.

Both return the same part dict, so variants and runners never branch on
the engine.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Type

import numpy as np
import torch

from repro_torch.core import entities as E
from repro_torch.core.match import CascadeMatcher, cosine_sim, jaccard_sig

# epsilon guard on the cascade gate: the fused kernel's cheap scores can
# differ from the plain ones by reduction-order ulps; widening the gate by
# GATE_EPS (in normalized-score units) keeps every pair the scan engine
# could accept, and extra survivors are exactly rescored anyway.
GATE_EPS = 1e-5


def _pair_mask(valid: torch.Tensor, d: int, *, halo_len: int, mode: str,
               weff: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mask for pairs (i, i+d) of combined [halo | native] slots (..., M).

    mode "all": every valid pair; "native": the LATER element is native
    (RepSN: halo-halo pairs belong to the predecessor shard); "cross":
    earlier element in the first half, later in the second (JobSN's
    boundary job).  ``weff`` (per-slot effective windows) additionally
    requires d < weff[i+d] — the later element owns the comparison."""
    m = valid.shape[-1]
    i = torch.arange(m, device=valid.device)
    j = i + d
    ok = (j < m) & valid & torch.roll(valid, -d, dims=-1)
    if weff is not None:
        ok = ok & (d < torch.roll(weff, -d, dims=-1))
    if mode == "native":
        ok = ok & (j >= halo_len)
    elif mode == "cross":
        ok = ok & (i < halo_len) & (j >= halo_len)
    return ok


def cross_source_rows(src: torch.Tensor, w: int) -> torch.Tensor:
    """(..., w-1, M) linkage mask: row d-1 true where src[i] != src[i+d]."""
    return torch.stack([src != torch.roll(src, -d, dims=-1)
                        for d in range(1, w)], dim=-2)


def band_mask(valid: torch.Tensor, w: int, *, halo_len: int = 0,
              mode: str = "all", src: Optional[torch.Tensor] = None,
              weff: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(..., w-1, M) validity band: row d-1 masks distance-d pairs; ``src``
    restricts to cross-source pairs, ``weff`` to each pair's later
    element's effective window."""
    rows = torch.stack([_pair_mask(valid, d, halo_len=halo_len, mode=mode,
                                   weff=weff) for d in range(1, w)], dim=-2)
    if src is not None:
        rows = rows & cross_source_rows(src, w)
    return rows


def _roll_rows(payload: dict, d: int, row_dim: int) -> dict:
    return {k: torch.roll(v, -d, dims=row_dim) for k, v in payload.items()}


def band_scores(ents: dict, w: int, matcher: CascadeMatcher, *,
                halo_len: int = 0, mode: str = "all",
                skip: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (scores, mask), each (..., w-1, M): row d-1 holds distance-d
    pairs.  One rolled payload view per distance — O(M * F) extra memory
    at a time, whatever w."""
    payload = ents["payload"]
    valid = ents["valid"]
    rd = valid.dim() - 1
    weff = payload.get("_weff")
    scores, masks = [], []
    for d in range(1, w):
        score, _ = matcher.combined(payload, _roll_rows(payload, d, rd),
                                    skip=skip)
        ok = _pair_mask(valid, d, halo_len=halo_len, mode=mode, weff=weff)
        scores.append(torch.where(ok, score, 0.0))
        masks.append(ok)
    return torch.stack(scores, dim=-2), torch.stack(masks, dim=-2)


def band_matches(ents: dict, w: int, matcher: CascadeMatcher, *,
                 halo_len: int = 0, mode: str = "all") -> torch.Tensor:
    """(..., w-1, M) bool: the band's pairs whose full cascade score
    reaches the matcher's threshold."""
    scores, mask = band_scores(ents, w, matcher, halo_len=halo_len, mode=mode)
    return (scores >= matcher.threshold) & mask


def compact_flat(band: torch.Tensor, cap: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pack the True positions of boolean bands (..., w-1, M) into
    fixed-capacity buffers of FLAT indices ``(d-1)*M + i``, in band order.

    Cumsum-based: each survivor's slot is its exclusive prefix count, and
    one scatter writes it (survivors past ``cap`` all land in a dump slot
    ``cap`` that is sliced off — its duplicate writes are harmless).

    Returns (flat_idx (..., cap) int32, n_true (...,) int32, overflow
    (...,) int32); positions past ``cap`` are dropped but counted in
    ``overflow``.  Slots beyond ``min(n_true, cap)`` are zero."""
    lead = band.shape[:-2]
    flat = band.reshape(lead + (-1,))
    n = flat.shape[-1]
    if n >= 2**31:
        raise ValueError(f"band of {n} slots overflows int32 flat indices")
    rank = torch.cumsum(flat, dim=-1, dtype=torch.int32) - 1
    n_true = flat.sum(dim=-1, dtype=torch.int32)
    target = torch.where(flat & (rank < cap), rank, cap).to(torch.int64)
    src = torch.arange(n, dtype=torch.int32, device=band.device) \
        .expand(lead + (n,))
    buf = torch.zeros(lead + (cap + 1,), dtype=torch.int32,
                      device=band.device).scatter_(-1, target, src)
    overflow = torch.clamp_min(n_true - cap, 0)
    return buf[..., :cap], n_true, overflow


def compact_candidates(gate: torch.Tensor, cap: int):
    """Stage 2 of the cascade: the True (d, i) positions of ``gate``
    (..., w-1, M) as a fixed-capacity candidate list, in band order.

    Returns (cand_i, cand_d, cand_valid, n_cand, overflow); candidates past
    ``cap`` are dropped but counted in ``overflow``."""
    m = gate.shape[-1]
    cand_flat, n_cand, overflow = compact_flat(gate, cap)
    kept = torch.clamp_max(n_cand, cap)
    cand_valid = torch.arange(cap, device=gate.device) < kept.unsqueeze(-1)
    cand_d = cand_flat // m + 1
    cand_i = cand_flat % m
    return cand_i, cand_d, cand_valid, n_cand, overflow


def emit_band_indices(band: torch.Tensor, cap: int) -> dict:
    """Device-side pair emission: compact boolean bands (..., w-1, M) into
    packed flat-index buffers so the host transfers ``cap`` int32 slots and
    a count instead of the whole band.  Drops are counted, never silent."""
    idx, n_true, overflow = compact_flat(band, cap)
    return {"idx": idx, "n": torch.clamp_max(n_true, cap),
            "overflow": overflow}


def cheap_band(payload: dict, split: "CascadeSplit", w: int) -> torch.Tensor:
    """Band-shaped plain evaluation of the cascade's cheap prefix:
    (..., w-1, M) unnormalized partial scores ``w_cos*cosine +
    w_jac*jaccard`` (the reference's ``cheap_band_jnp``).  Row dims of the
    payload are second to last (``feat`` (..., M, F), ``sig`` (..., M, W));
    like the reference, a row pairs past the end wrap around — callers mask
    those slots."""
    feat = payload.get(split.feat_field) if split.feat_field else None
    sig = payload.get(split.sig_field) if split.sig_field else None
    rows = []
    for d in range(1, w):
        part = 0.0
        if feat is not None:
            part = part + split.w_cos * cosine_sim(
                feat, torch.roll(feat, -d, dims=-2))
        if sig is not None:
            part = part + split.w_jac * jaccard_sig(
                sig, torch.roll(sig, -d, dims=-2))
        rows.append(part)
    return torch.stack(rows, dim=-2)


def score_candidates(ents: dict, cand_i, cand_d, cand_valid,
                     matcher: CascadeMatcher) -> torch.Tensor:
    """Run the full (expensive) matcher on compacted candidate pairs only —
    the real-FLOP realization of the paper's skip optimization."""
    m = ents["valid"].shape[-1]
    rd = ents["valid"].dim() - 1
    i = cand_i.to(torch.int64)
    j = torch.clamp_max(i + cand_d, m - 1)
    pa = {k: E.take_rows(v, i, rd) for k, v in ents["payload"].items()}
    pb = {k: E.take_rows(v, j, rd) for k, v in ents["payload"].items()}
    score, _ = matcher.combined(pa, pb, skip=False)
    return torch.where(cand_valid, score, 0.0)


def band_pair_count(mask: torch.Tensor) -> torch.Tensor:
    """True slots per boolean band (..., w-1, M) -> (...,) int32."""
    return mask.sum(dim=(-2, -1), dtype=torch.int32)


def prune_low_evidence(payload: dict, matcher: CascadeMatcher, w: int,
                       mask: torch.Tensor, threshold: float):
    """Meta-blocking comparison pruning: shrink the blocked band to pairs
    whose CHEAP cascade evidence clears ``threshold`` (a fraction of the
    cheap prefix's weight), before the expensive matcher.  The evidence is
    always the plain ``cheap_band`` — the same math for both engines and
    the sequential runner — and GATE_EPS keeps a pair exactly at the bar.

    Returns (kept_mask, pruned (...,) int32).  Raises when the matcher has
    no kernel-supported cheap prefix."""
    split = split_cascade(matcher, payload)
    if split is None:
        raise ValueError(
            "prune_policy='evidence' needs a matcher whose cascade starts "
            "with a kernel-supported cheap stage (cosine/jaccard on a "
            "present payload field); split_cascade found none")
    cheap = cheap_band(payload, split, w)
    bar = threshold * (split.w_cos + split.w_jac) - GATE_EPS
    kept = mask & (cheap >= bar)
    return kept, band_pair_count(mask) - band_pair_count(kept)


# -- window comparison cost model (host-side; the balance planners' oracle) ---------
#
# Every SN pair (i-d, i) is OWNED by its later element i, so the entity at
# global sorted rank i contributes exactly min(i, w-1) comparisons.

def rank_prefix_comparisons(rank, w: int) -> np.ndarray:
    """Total SN pairs among the first ``rank`` sorted entities (vectorized;
    equals ``sn.expected_pair_count(rank, w)``)."""
    r = np.asarray(rank, np.int64)
    ramp = np.minimum(r, w - 1)
    return ramp * (ramp - 1) // 2 + np.maximum(r - (w - 1), 0) * (w - 1)


def rank_for_prefix_comparisons(target: float, w: int) -> int:
    """Inverse of ``rank_prefix_comparisons``: the smallest rank whose
    prefix comparison count reaches ``target``."""
    wm1 = w - 1
    if target <= 0:
        return 0
    tri = wm1 * (wm1 - 1) // 2
    if target <= tri:
        e = int(np.ceil((1.0 + np.sqrt(1.0 + 8.0 * float(target))) / 2.0))
        while e * (e - 1) // 2 < target:
            e += 1
        while e > 0 and (e - 1) * (e - 2) // 2 >= target:
            e -= 1
        return e
    return wm1 + int(np.ceil((float(target) - tri) / wm1))


# -- band engines -------------------------------------------------------------------

_BAND_ENGINES: Dict[str, Type["BandEngine"]] = {}


def register_band_engine(name: str):
    """Class decorator: ``@register_band_engine("pallas")``."""
    def deco(cls):
        cls.name = name
        _BAND_ENGINES[name] = cls
        return cls
    return deco


def get_band_engine(name: str) -> "BandEngine":
    try:
        return _BAND_ENGINES[name]()
    except KeyError:
        raise ValueError(
            f"unknown band engine {name!r}; registered: "
            f"{available_band_engines()}") from None


def available_band_engines() -> Tuple[str, ...]:
    return tuple(sorted(_BAND_ENGINES))


def _per_shard(value: int, lead, device) -> torch.Tensor:
    return torch.full(tuple(lead), value, dtype=torch.int32, device=device)


class BandEngine:
    """One way to evaluate the sliding-window bands of sorted shards.

    ``band(ents, cfg, halo_len=..., mode=...)`` takes entities (r, M, ...)
    and returns per-shard outputs:

      mask           (r, w-1, M) bool   blocked (candidate) pairs
      match          (r, w-1, M) bool   matcher-accepted pairs
      matcher_evals  (r,) int32  full-cascade evaluations actually run
      cand_count     (r,) int32  cascade-gate survivors kept (0 for scan)
      cand_overflow  (r,) int32  gate survivors dropped by cand_cap
      pruned         (r,) int32  band slots dropped by evidence pruning
      scores         (r, w-1, M) f32, only when cfg.return_scores
    """

    name = "?"

    def band(self, ents: dict, cfg, *, halo_len: int, mode: str) -> dict:
        raise NotImplementedError

    def match_bound(self, ents: dict, cfg) -> Optional[int]:
        """Upper bound on True entries of one shard's MATCH band, or None
        (shrinks the emitted match index buffer)."""
        return None

    @staticmethod
    def _src(ents: dict, cfg) -> Optional[torch.Tensor]:
        if getattr(cfg, "linkage", False) and "src" in ents["payload"]:
            return ents["payload"]["src"]
        return None


@register_band_engine("scan")
class ScanBandEngine(BandEngine):
    """Reference oracle: w-1 shifted full-payload passes.  The cascade skip
    is a ``torch.where`` — both branches are computed, so every band slot
    costs one full matcher evaluation."""

    def band(self, ents: dict, cfg, *, halo_len: int, mode: str) -> dict:
        scores, mask = band_scores(ents, cfg.window, cfg.matcher,
                                   halo_len=halo_len, mode=mode)
        src = self._src(ents, cfg)
        if src is not None:
            mask = mask & cross_source_rows(src, cfg.window)
        lead, dev = ents["valid"].shape[:-1], ents["valid"].device
        pruned = _per_shard(0, lead, dev)
        if getattr(cfg, "prune_policy", "off") == "evidence":
            mask, pruned = prune_low_evidence(
                ents["payload"], cfg.matcher, cfg.window, mask,
                cfg.prune_threshold)
        match = (scores >= cfg.matcher.threshold) & mask
        m = ents["valid"].shape[-1]
        out = {"mask": mask, "match": match,
               "matcher_evals": _per_shard((cfg.window - 1) * m, lead, dev),
               "cand_count": _per_shard(0, lead, dev),
               "cand_overflow": _per_shard(0, lead, dev),
               "pruned": pruned}
        if cfg.return_scores:
            out["scores"] = scores
        return out


@dataclass(frozen=True)
class CascadeSplit:
    """How the matcher cascade maps onto the fused kernel: the cheap prefix
    (cosine and/or jaccard) and the gate threshold for the UNNORMALIZED
    partial score the kernel emits."""
    feat_field: Optional[str]
    sig_field: Optional[str]
    w_cos: float
    w_jac: float
    tau_partial: float       # gate: cheap_partial >= tau_partial


def split_cascade(matcher: CascadeMatcher,
                  payload: dict) -> Optional[CascadeSplit]:
    """Split the cost-ordered cascade into a kernel-supported cheap prefix
    (one cosine field + one jaccard field, in cost order) and the rest.
    None when the FIRST matcher is unsupported (the pallas engine then
    runs the scan oracle)."""
    w_cos = w_jac = 0.0
    feat_field = sig_field = None
    prefix_w = 0.0
    for m in matcher.ordered():
        if m.kind == "cosine" and feat_field is None and m.field in payload:
            feat_field, w_cos = m.field, m.weight
        elif m.kind == "jaccard" and sig_field is None and m.field in payload:
            sig_field, w_jac = m.field, m.weight
        else:
            break
        prefix_w += m.weight
    if feat_field is None and sig_field is None:
        return None
    wsum = sum(m.weight for m in matcher.matchers)
    remaining = wsum - prefix_w
    # gate passes iff (cheap + remaining)/wsum >= threshold - GATE_EPS
    tau = (matcher.threshold - GATE_EPS) * wsum - remaining
    return CascadeSplit(feat_field=feat_field, sig_field=sig_field,
                        w_cos=w_cos, w_jac=w_jac, tau_partial=tau)


@register_band_engine("pallas")
class PallasBandEngine(BandEngine):
    """The §5.1 cascade end to end on the device: fused cheap-band kernel
    -> cumsum compaction -> exact matcher on survivors only.  (The name is
    the reference's config string; here the cheap band is the CUDA kernel
    ``kernels/csrc/fused_band.cu`` on the card.)

    cand_cap (cfg.cand_cap; 0 = the full band, never overflows) bounds each
    shard's survivor buffer like SRP's cap_link bounds the shuffle:
    candidates past the cap are dropped and counted in ``cand_overflow``,
    and can only LOSE matches (blocked pairs come from the mask).  The
    expensive stage scores the whole buffer, so cand_cap is both the FLOP
    and the memory lever."""

    def match_bound(self, ents: dict, cfg) -> Optional[int]:
        cand_cap = cfg.cand_cap or 0
        if cand_cap > 0 and \
                split_cascade(cfg.matcher, ents["payload"]) is not None:
            return cand_cap
        return None

    def band(self, ents: dict, cfg, *, halo_len: int, mode: str) -> dict:
        from repro_torch.kernels import ops

        split = split_cascade(cfg.matcher, ents["payload"])
        if split is None:     # no kernel-supported cheap stage
            return ScanBandEngine().band(ents, cfg, halo_len=halo_len,
                                         mode=mode)
        w = cfg.window
        valid = ents["valid"]
        lead, dev = valid.shape[:-1], valid.device
        m = valid.shape[-1]
        payload = ents["payload"]
        mask = band_mask(valid, w, halo_len=halo_len, mode=mode,
                         src=self._src(ents, cfg),
                         weff=payload.get("_weff"))
        pruned = _per_shard(0, lead, dev)
        if getattr(cfg, "prune_policy", "off") == "evidence":
            mask, pruned = prune_low_evidence(payload, cfg.matcher, w, mask,
                                              cfg.prune_threshold)

        feat = payload[split.feat_field].contiguous() if split.feat_field \
            else torch.zeros(lead + (m, 1), dtype=torch.float32, device=dev)
        sig = payload[split.sig_field].contiguous() if split.sig_field \
            else torch.zeros(lead + (m, 1), dtype=torch.int32, device=dev)
        cheap = ops.fused_cheap_band(feat, sig, window=w - 1,
                                     w_cos=split.w_cos, w_jac=split.w_jac,
                                     block_i=cfg.band_block)
        gate = (cheap.transpose(-1, -2) >= split.tau_partial) & mask
        del cheap

        cand_cap = cfg.cand_cap or 0   # None (unresolved auto) acts like 0
        cap = cand_cap if cand_cap > 0 else (w - 1) * m
        cand_i, cand_d, cand_valid, n_cand, overflow = \
            compact_candidates(gate, cap)
        del gate
        score = score_candidates(ents, cand_i, cand_d, cand_valid,
                                 cfg.matcher)
        accept = cand_valid & (score >= cfg.matcher.threshold)

        full = (w - 1) * m
        flat_idx = (cand_d - 1) * m + cand_i
        safe = torch.where(cand_valid, flat_idx, full).to(torch.int64)
        match = torch.zeros(lead + (full + 1,), dtype=torch.bool,
                            device=dev).scatter_(-1, safe, accept)
        match = match[..., :full].reshape(lead + (w - 1, m))
        out = {"mask": mask, "match": match,
               # the expensive stage scores the whole cand_cap buffer
               # (invalid slots included): report THAT
               "matcher_evals": _per_shard(cap, lead, dev),
               "cand_count": torch.clamp_max(n_cand, cap),
               "cand_overflow": overflow,
               "pruned": pruned}
        if cfg.return_scores:
            out["scores"] = torch.zeros(
                lead + (full + 1,), dtype=torch.float32, device=dev
            ).scatter_(-1, safe, torch.where(cand_valid, score, 0.0))[
                ..., :full].reshape(lead + (w - 1, m))
        return out
