"""Match strategies (paper §3, §5.1) — port of ``repro.core.match``.

The paper's matcher: edit distance on title + TriGram similarity on
abstract, weighted average, threshold 0.75, SKIPPING the later matcher when
the earlier ones can no longer reach the threshold.  Entities carry

  * "feat": unit-norm embeddings   -> cosine similarity  (cheap)
  * "sig":  bit-packed trigram sets -> Jaccard via popcount (int32 views)
  * "text": padded byte strings    -> exact edit distance (expensive)

Every function is elementwise over leading dims, so the same code scores
one shard or the stacked (r, ...) shards.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch


# -- primitive similarities ---------------------------------------------------------

def cosine_sim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: (..., F) unit-ish vectors -> (...,) in [0, 1]."""
    s = (a.float() * b.float()).sum(dim=-1)
    return torch.clamp(0.5 * (s + 1.0), 0.0, 1.0)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word of an int32 bit view, as int64.

    SWAR popcount on the word widened to int64 and masked to its low 32
    bits: torch's ``>>`` on a negative int32 is ARITHMETIC, so working on
    the raw int32 would smear the sign bit into the counts."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def jaccard_sig(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: (..., W) int32 bit-packed sets -> Jaccard |a&b|/|a|b|;
    empty vs empty is 1.0."""
    inter = popcount32(a & b).sum(dim=-1).float()
    union = popcount32(a | b).sum(dim=-1).float()
    return torch.where(union > 0, inter / torch.clamp_min(union, 1.0),
                       torch.ones_like(union))


def _edit_distance_scan(a32, b32, L: int, la, lb):
    """Levenshtein distance of the padded strings ``a32``/``b32`` (..., L)
    with true lengths ``la``/``lb``: the reference's anti-diagonal DP, one
    batched step per diagonal d = 2..2L (a Python loop of tensor ops; the
    reference's ``lax.scan``).  ``prev2``/``prev`` hold diagonals d-2 and
    d-1 indexed by row i; cell (i, d-i) is read off diagonal la+lb at row
    la."""
    big = 2 * L + 7
    dev = a32.device
    shape = a32.shape[:-1] + (L + 1,)
    rows = torch.arange(L + 1, device=dev)
    prev2 = torch.where(rows == 0, 0, big).to(torch.int32).expand(shape)
    prev = torch.where(rows <= 1, 1, big).to(torch.int32).expand(shape)
    target_d = la + lb
    ans = torch.where(target_d == 0, 0,
                      torch.where(target_d == 1, 1, big)).to(torch.int32)
    if L == 0:
        return ans
    pad = torch.full(shape[:-1] + (1,), big, dtype=torch.int32, device=dev)
    # the row's character is the same on every diagonal: gather it once
    ca = a32[..., (rows - 1).clamp(0, L - 1)]
    la_idx = la.to(torch.int64).unsqueeze(-1)
    for d in range(2, 2 * L + 1):
        j = d - rows
        up = torch.cat([pad, prev[..., :-1]], dim=-1)
        diag = torch.cat([pad, prev2[..., :-1]], dim=-1)
        cb = b32[..., (j - 1).clamp(0, L - 1)]
        sub = diag + (ca != cb).to(torch.int32)
        cur = torch.minimum(torch.minimum(up + 1, prev + 1), sub)
        cur[..., 0] = min(d, big)                 # i == 0
        if d <= L:
            cur[..., d] = d                       # j == 0
        lo = max(d - L, 0)                        # j <= L  <=>  i >= d - L
        cur[..., :lo] = big
        cur[..., d + 1:] = big                    # j >= 0  <=>  i <= d
        hit = cur.gather(-1, la_idx).squeeze(-1)
        ans = torch.where(target_d == d, hit, ans)
        prev2, prev = prev, cur
    return ans


def _lengths(a32):
    return (a32 > 0).sum(dim=-1, dtype=torch.int32)


def edit_distance_impl(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Edit distance of padded byte strings (..., L) -> (...,) int32."""
    a32, b32 = a.to(torch.int32), b.to(torch.int32)
    return _edit_distance_scan(a32, b32, a.shape[-1], _lengths(a32),
                               _lengths(b32))


def edit_sim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """1 - dist / max(len) in [0, 1]."""
    a32, b32 = a.to(torch.int32), b.to(torch.int32)
    la, lb = _lengths(a32), _lengths(b32)
    d = _edit_distance_scan(a32, b32, a.shape[-1], la, lb)
    mx = torch.clamp_min(torch.maximum(la, lb), 1)
    return torch.clamp(1.0 - d.float() / mx.float(), 0.0, 1.0)


def edit_distance_ref(a: np.ndarray, b: np.ndarray) -> int:
    """Host oracle for tests."""
    sa = bytes(a[a > 0].tolist())
    sb = bytes(b[b > 0].tolist())
    m, n = len(sa), len(sb)
    dp = list(range(n + 1))
    for i in range(1, m + 1):
        prev = dp[0]
        dp[0] = i
        for j in range(1, n + 1):
            cur = dp[j]
            dp[j] = min(dp[j] + 1, dp[j - 1] + 1,
                        prev + (sa[i - 1] != sb[j - 1]))
            prev = cur
    return dp[n]


# -- matcher strategy objects -----------------------------------------------------

@dataclass(frozen=True)
class Matcher:
    """One similarity over a payload field."""
    field: str
    kind: str            # "cosine" | "jaccard" | "edit"
    weight: float = 1.0
    cost: float = 1.0    # relative cost (cascade ordering)

    def __call__(self, pa: Dict[str, torch.Tensor],
                 pb: Dict[str, torch.Tensor]) -> torch.Tensor:
        a, b = pa[self.field], pb[self.field]
        if self.kind == "cosine":
            return cosine_sim(a, b)
        if self.kind == "jaccard":
            return jaccard_sig(a, b)
        if self.kind == "edit":
            return edit_sim(a, b)
        raise ValueError(self.kind)


@dataclass(frozen=True)
class CascadeMatcher:
    """Weighted-average match strategy with the paper's skip optimization:
    matchers run cheap-to-expensive; once the best still-achievable combined
    score drops below the threshold, later matchers are skipped.

    ``combined(pa, pb)`` returns (score, evaluated) over any leading shape."""
    matchers: Tuple[Matcher, ...]
    threshold: float = 0.75

    def ordered(self):
        return tuple(sorted(self.matchers, key=lambda m: m.cost))

    def combined(self, pa, pb, *, skip: bool = True):
        ms = self.ordered()
        wsum = sum(m.weight for m in ms)
        acc = None
        remaining = wsum
        evaluated = 0.0
        alive = None
        for m in ms:
            if acc is None:
                s = m(pa, pb)
                acc = m.weight * s
                alive = torch.ones_like(s, dtype=torch.bool)
            else:
                if skip:
                    # max achievable if every remaining matcher scored 1.0
                    best = (acc + remaining) / wsum
                    alive = alive & (best >= self.threshold)
                s = torch.where(alive, m(pa, pb), 0.0)
                acc = acc + m.weight * s
            evaluated = evaluated + alive.float()
            remaining -= m.weight
        return acc / wsum, evaluated

    def matches(self, pa, pb, *, skip: bool = True):
        score, _ = self.combined(pa, pb, skip=skip)
        return score >= self.threshold


def as_matcher(m) -> CascadeMatcher:
    """Any cascade-shaped object (``.matchers`` of objects with field, kind,
    weight, cost, plus ``.threshold`` — e.g. the reference's) as this
    package's ``CascadeMatcher``, so one kwargs dict configures both
    packages."""
    if isinstance(m, CascadeMatcher):
        return m
    return CascadeMatcher(
        matchers=tuple(Matcher(field=x.field, kind=x.kind,
                               weight=float(x.weight), cost=float(x.cost))
                       for x in m.matchers),
        threshold=float(m.threshold))


def default_matcher() -> CascadeMatcher:
    """The paper's strategy: cheap trigram-style similarity gates the rest;
    weighted average, threshold 0.75 (§5.1)."""
    return CascadeMatcher(
        matchers=(
            Matcher(field="feat", kind="cosine", weight=0.5, cost=1.0),
            Matcher(field="sig", kind="jaccard", weight=0.5, cost=2.0),
        ),
        threshold=0.75)


def paper_cascade() -> CascadeMatcher:
    """The §5.1 cascade with a real cost gap: cosine 0.25 + Jaccard 0.25
    gating edit distance 0.5 on ``text``, threshold 0.75 (the reference
    benchmark's ``bench_sn.paper_cascade``)."""
    return CascadeMatcher(matchers=(
        Matcher(field="feat", kind="cosine", weight=0.25, cost=1.0),
        Matcher(field="sig", kind="jaccard", weight=0.25, cost=2.0),
        Matcher(field="text", kind="edit", weight=0.5, cost=10.0),
    ), threshold=0.75)
