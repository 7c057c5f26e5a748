"""Overflow recovery — the ``ERConfig.on_overflow`` escalation ladder (port
of ``repro.resilience.retry``).

The capacity knobs (``cand_cap``/``pair_cap``/``cap_factor``) buy static
shapes at the price of truncation: an overflowed buffer historically just
COUNTED its drops (``overflow``/``cand_overflow``/``pair_overflow``).  The
ladder turns that into MapReduce-style task re-execution: the affected
resolve (or the one overflowing stream chunk) reruns with every overflowed
finite cap doubled, up to ``cfg.retry_limit`` rounds.

Doubling is deliberate: caps stay on the power-of-two ladder above the base
cap, so retried executions collapse onto a handful of
``static_fingerprint`` values.  A ladder that still overflows after ``retry_limit``
rounds raises ``CapacityOverflowError`` — under ``on_overflow="retry"`` a
result NEVER silently drops pairs.

``autosize_caps`` closes the loop on sizing: unset (None) caps are derived
from ``balance.suggest_caps`` on the key profile — the band bound that
provably cannot overflow under the planned loads — so the ladder is a
safety net for profile drift, not the primary sizing mechanism.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np

from repro_torch import balance as B
from repro_torch import obs as OBS


class CapacityOverflowError(RuntimeError):
    """A finite capacity truncated the result and the policy forbids
    keeping it (``on_overflow="raise"``, or ``"retry"`` after the ladder
    was exhausted).  Carries the offending counters for diagnostics."""

    def __init__(self, msg: str, *, overflow: int = 0, cand_overflow: int = 0,
                 pair_overflow: int = 0, retries: int = 0):
        super().__init__(msg)
        self.overflow = overflow
        self.cand_overflow = cand_overflow
        self.pair_overflow = pair_overflow
        self.retries = retries


class ResilienceStats(NamedTuple):
    """Overflow-recovery telemetry of one resolve / streaming pass.

    retries       device re-executions the ladder performed
    escalations   individual cap doublings applied (>= retries: one retry
                  may double several overflowed caps at once)
    cand_cap /    the caps the FINAL (kept) execution ran under, post
    pair_cap      auto-sizing and escalation (0 = unbounded)
    auto_caps     True when unset caps were derived from the key profile
                  (``balance.suggest_caps``) rather than given explicitly
    """
    policy: str
    retries: int
    escalations: int
    cand_cap: int
    pair_cap: int
    auto_caps: bool


def union_stats(stats) -> Optional[ResilienceStats]:
    """The ``ResilienceStats`` of a multi-pass run from its passes'
    (``None`` entries skipped; ``None`` when no pass has any): retries and
    escalations add up, the caps are the largest any pass kept."""
    rz = [s for s in stats if s is not None]
    return None if not rz else ResilienceStats(
        policy=rz[0].policy,
        retries=sum(x.retries for x in rz),
        escalations=sum(x.escalations for x in rz),
        cand_cap=max(x.cand_cap for x in rz),
        pair_cap=max(x.pair_cap for x in rz),
        auto_caps=any(x.auto_caps for x in rz))


def _overflowed(out) -> bool:
    """Did any finite capacity truncate this outcome?"""
    return (int(out.overflow) > 0 or int(out.cand_overflow) > 0
            or int(out.pair_overflow) > 0)


def _escalated(cfg, out) -> Tuple[object, int]:
    """One ladder rung: double every finite cap whose buffer overflowed.
    Returns (new cfg, doublings applied).  Link-capacity overflow with
    ``cap_factor == 0`` counts as one escalation with no cfg change — the
    caller's ``call(cfg, attempt)`` closure lifts the plan's exact
    ``cap_link`` on retries (attempt > 0), which is the actual recovery."""
    kw = {}
    doublings = 0
    if int(out.cand_overflow) > 0 and (cfg.cand_cap or 0) > 0:
        kw["cand_cap"] = 2 * cfg.cand_cap
        doublings += 1
    if int(out.pair_overflow) > 0 and (cfg.pair_cap or 0) > 0:
        kw["pair_cap"] = 2 * cfg.pair_cap
        doublings += 1
    if int(out.overflow) > 0:
        if cfg.cap_factor > 0:
            kw["cap_factor"] = 2.0 * cfg.cap_factor
        doublings += 1
    return (cfg.with_(**kw) if kw else cfg), doublings


def run_with_recovery(call: Callable, cfg):
    """Execute ``call(cfg, attempt)`` under the ``cfg.on_overflow`` policy.

    ``call`` runs the resolve and returns any outcome carrying the three
    overflow counters (``RunnerOutcome``/``PackedOutcome``); ``attempt`` is
    0 for the first execution and increments per retry (callers use it to
    lift plan-exact ``cap_link`` capacities the cfg cannot express).

    Returns ``(outcome, cfg_used, retries, escalations)`` where ``cfg_used``
    is the (possibly escalated) config of the kept execution.  Raises
    ``CapacityOverflowError`` under policy "raise" (immediately) or "retry"
    (after ``cfg.retry_limit`` fruitless rounds).

    Under an active tracer every ladder rung runs inside an ``attempt``
    child span (attempt index, the caps it ran under, whether it
    overflowed), and retries/overflow events land on the tracer's
    counters — the DESIGN.md §12 view of the recovery ladder."""

    def _call(c, attempt: int):
        sp = OBS.span("attempt", attempt=attempt,
                      cand_cap=getattr(c, "cand_cap", 0) or 0,
                      pair_cap=getattr(c, "pair_cap", 0) or 0)
        with sp:
            o = call(c, attempt)
            if sp.enabled:
                over = _overflowed(o)
                sp.set(overflowed=over)
                m = OBS.current_tracer().metrics
                if over:
                    m.counter("overflow_events").inc()
                if attempt > 0:
                    m.counter("retries").inc()
        return o

    out = _call(cfg, 0)
    if cfg.on_overflow == "count" or not _overflowed(out):
        return out, cfg, 0, 0
    if cfg.on_overflow == "raise":
        raise CapacityOverflowError(
            f"capacity overflow under on_overflow='raise': "
            f"overflow={int(out.overflow)} "
            f"cand_overflow={int(out.cand_overflow)} "
            f"pair_overflow={int(out.pair_overflow)}; raise the caps or "
            f"use on_overflow='retry'",
            overflow=int(out.overflow), cand_overflow=int(out.cand_overflow),
            pair_overflow=int(out.pair_overflow))
    retries = escalations = 0
    while _overflowed(out) and retries < cfg.retry_limit:
        nxt, doublings = _escalated(cfg, out)
        if doublings == 0:
            break          # nothing left to escalate: fail loudly below
        cfg = nxt
        retries += 1
        escalations += doublings
        out = _call(cfg, retries)
    if _overflowed(out):
        raise CapacityOverflowError(
            f"capacity overflow survived {retries} retry escalation(s) "
            f"(retry_limit={cfg.retry_limit}): "
            f"overflow={int(out.overflow)} "
            f"cand_overflow={int(out.cand_overflow)} "
            f"pair_overflow={int(out.pair_overflow)}; raise retry_limit or "
            f"the base caps",
            overflow=int(out.overflow), cand_overflow=int(out.cand_overflow),
            pair_overflow=int(out.pair_overflow), retries=retries)
    return out, cfg, retries, escalations


def autosize_caps(cfg, *, plan=None, profile: Optional[B.KeyProfile] = None,
                  r: Optional[int] = None, floor_load: int = 0):
    """Resolve unset (None) caps to concrete ints before any runner call.

    When a profile-backed plan (``planned_load``) or a merged ``KeyProfile``
    is available, unset caps become ``balance.suggest_caps``'s band bound —
    the (w-1)*max_load + slack capacity that cannot overflow under the
    planned loads.  Without one (legacy partitioners, raw bounds), unset
    caps fall back to 0 = the legacy unbounded/full-band semantics, so
    nothing changes for runs that never had a profile.  Only caps the
    config actually consumes are sized (``cand_cap`` on the pallas engine,
    ``pair_cap`` under emit="pairs") — everything else resolves to 0 and
    keeps its pre-auto executable-cache fingerprint.

    ``floor_load`` raises the sizing load to at least that many rows — the
    stream passes its combined [halo | chunk] width, because a degenerate
    (collapsed) chunk lands whole on a single shard regardless of the
    planned per-shard loads.

    Returns ``(cfg with int caps, auto: bool)``."""
    need_cand = cfg.cand_cap is None and cfg.band_engine == "pallas"
    need_pair = cfg.pair_cap is None and cfg.emit == "pairs"
    fill = {}
    auto = False
    if need_cand or need_pair:
        max_load = None
        if plan is not None and getattr(plan, "planned_load", None) \
                is not None:
            max_load = int(np.max(np.asarray(plan.planned_load))) \
                + cfg.window - 1
        elif profile is not None and profile.n > 0:
            max_load = B.suggest_caps(profile, cfg, r).max_load
        if max_load is not None:
            caps = B.suggest_caps(profile, cfg, r,
                                  max_load=max(max_load, floor_load))
            auto = True
            if need_cand:
                fill["cand_cap"] = caps.cand_cap
            if need_pair:
                fill["pair_cap"] = caps.pair_cap
    if cfg.cand_cap is None and "cand_cap" not in fill:
        fill["cand_cap"] = 0
    if cfg.pair_cap is None and "pair_cap" not in fill:
        fill["pair_cap"] = 0
    return (cfg.with_(**fill) if fill else cfg), auto
