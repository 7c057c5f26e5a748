"""``resolve`` / ``link`` — the facade tying config, variants, runners and
results together (port of ``repro.api.facade``).

    res = api.resolve(ents, api.ERConfig(variant="jobsn"))            # card
    res = api.resolve(ents, api.ERConfig(), device="cpu")             # CPU
    linked = api.link(ents_r, ents_s, api.ERConfig(window=6))

Shard boundaries come from ``cfg.partitioner`` (profile -> plan ->
execute); explicit ``bounds`` (a raw array or a ShardPlan) always win.
``device=None`` runs on the CUDA card and raises without one.
"""
from __future__ import annotations

from dataclasses import replace as _replace

import numpy as np

from repro_torch import balance as B
from repro_torch import obs as OBS
from repro_torch.api import linkage as LK
from repro_torch.api.config import ERConfig
from repro_torch.api.results import (BalanceMetrics, BlockingResult,
                                     ERResult, PerfStats, compute_metrics)
from repro_torch.api.runners import Runner, SequentialRunner, VmapRunner
from repro_torch.core import entities as E
from repro_torch.core import sn
from repro_torch.device import resolve_device
from repro_torch.resilience import retry as RZ


def _refuse_unported(cfg: ERConfig) -> None:
    """Features of the reference that the port does not have yet raise,
    naming their ROADMAP item — never silently something else."""
    unported = [
        (bool(cfg.passes), "multi-pass blocking (passes)", "M7"),
        (cfg.window_policy == "adaptive", "window_policy='adaptive'", "M7"),
        (cfg.trace, "trace=True", "M10"),
        (cfg.runner == "shard_map", "runner='shard_map'", "M11"),
        (cfg.partitioner in B.planners.PROFILE_PLANNERS,
         f"partitioner={cfg.partitioner!r}", "M6"),
    ]
    for hit, what, item in unported:
        if hit:
            raise NotImplementedError(
                f"{what} is not ported to repro_torch yet (ROADMAP {item})")


def make_runner(cfg: ERConfig, *, device=None) -> Runner:
    """Instantiate the runner named by ``cfg.runner``."""
    if cfg.runner == "sequential":
        return SequentialRunner(num_shards=cfg.num_shards)
    if cfg.runner == "vmap":
        return VmapRunner(num_shards=cfg.num_shards, device=device)
    _refuse_unported(cfg)
    raise ValueError(f"unknown runner {cfg.runner!r}")


def default_bounds(ents: dict, cfg: ERConfig, r: int):
    """Partition boundaries per ``cfg.partitioner`` (the key-bounds view of
    ``balance.plan_shards``)."""
    return B.plan_shards(ents, cfg, r).bounds


def _total_comparisons(ents: dict, cfg: ERConfig) -> int:
    """Comparison-space size for the reduction ratio: all valid pairs, or
    R x S cross-source pairs in linkage mode."""
    valid = ents["valid"].cpu().numpy()
    if cfg.linkage and "src" in ents["payload"]:
        src = ents["payload"]["src"].cpu().numpy()[valid]
        n_r = int((src == 0).sum())
        return n_r * (len(src) - n_r)
    n = int(valid.sum())
    return n * (n - 1) // 2


def _host_oracle(ents: dict, cfg: ERConfig):
    """Sequential-SN oracle pair set (cross-source-filtered in linkage
    mode)."""
    host = E.to_host(ents)
    valid = host["valid"]
    keys = host["key"][valid]
    eids = host["eid"][valid]
    if cfg.linkage and "src" in host["payload"]:
        src = host["payload"]["src"][valid]
        return LK.sequential_link_pairs(keys, eids, src, cfg.window)
    if "_weff" in host["payload"]:
        return sn.adaptive_sn_pairs(keys, eids, host["payload"]["_weff"][valid])
    return sn.sequential_sn_pairs(keys, eids, cfg.window)


def _balance_metrics(plan: B.ShardPlan, out, window: int):
    """Planned vs realized shard load (both through the one cost model)."""
    if plan.planned_comparisons is None:
        return None
    realized_comp = B.realized_comparisons(out.load, window)
    return BalanceMetrics(
        partitioner=plan.partitioner,
        planned_load=tuple(int(x) for x in plan.planned_load),
        realized_load=tuple(int(x) for x in out.load),
        planned_comparisons=tuple(int(x) for x in plan.planned_comparisons),
        realized_comparisons=tuple(int(x) for x in realized_comp),
        imbalance_planned=plan.imbalance,
        imbalance_realized=B.imbalance_ratio(realized_comp),
        straggler_shard=int(np.argmax(realized_comp)),
        halo_entities=int(np.asarray(plan.halo).sum()),
        cap_link=plan.cap_link)


def resolve(ents: dict, cfg: ERConfig, *, bounds=None,
            device=None) -> ERResult:
    """Run the configured ER pipeline over one entity set (a port entity
    dict, on any device; it is moved to ``device``).

    ``bounds``: explicit partition boundaries ((r-1,) int32) or a
    ``ShardPlan``; planned from ``cfg.partitioner`` when omitted.
    ``device``: None = the CUDA card (raises without one); pass "cpu" to
    run on the CPU.  The sequential runner always runs on the host."""
    device = resolve_device(device)
    _refuse_unported(cfg)
    ents = E.to_device(ents, device)
    runner = make_runner(cfg, device=device)
    n_valid = int(ents["valid"].sum())
    with OBS.span("plan", partitioner=cfg.partitioner, n=n_valid):
        if bounds is None:
            if 0 < n_valid < runner.shards:
                raise ValueError(
                    f"num_shards={runner.shards} exceeds the entity count "
                    f"({n_valid} valid entities); lower num_shards so every "
                    f"shard can hold at least one entity")
            plan = B.plan_shards(ents, cfg, runner.shards)
        else:
            plan = B.as_plan(bounds)
            if cfg.runner != "sequential" \
                    and plan.num_shards != runner.shards:
                raise ValueError(
                    f"bounds define {plan.num_shards} partitions but the "
                    f"{runner.name} runner has {runner.shards} shards")
            if 0 < n_valid < plan.num_shards:
                raise ValueError(
                    f"bounds define {plan.num_shards} partitions but only "
                    f"{n_valid} valid entities exist; use fewer partitions")
        cfg, auto_caps = RZ.autosize_caps(cfg, plan=plan)

    def _attempt(c: ERConfig, attempt: int):
        # retries lift the plan's exact cap_link (the overflow disproved
        # it); cfg.cap_factor, doubled by the ladder, takes over
        p = plan if attempt == 0 or plan.cap_link is None \
            else _replace(plan, cap_link=None)
        return runner.resolve(ents, p, c)

    with OBS.span("execute", runner=runner.name, shards=runner.shards):
        out, run_cfg, retries, escalations = \
            RZ.run_with_recovery(_attempt, cfg)
    resilience = RZ.ResilienceStats(
        policy=cfg.on_overflow, retries=retries, escalations=escalations,
        cand_cap=run_cfg.cand_cap or 0, pair_cap=run_cfg.pair_cap or 0,
        auto_caps=auto_caps)

    blocking = BlockingResult(pairs=out.blocked, load=out.load,
                              overflow=out.overflow, variant=cfg.variant,
                              runner=runner.name, window=cfg.window,
                              num_shards=out.num_shards,
                              cand_count=out.cand_count,
                              cand_overflow=out.cand_overflow,
                              matcher_evals=out.matcher_evals,
                              pair_overflow=out.pair_overflow,
                              pruned=out.pruned)
    balance = _balance_metrics(plan, out, cfg.window)
    metrics = None
    if cfg.compute_metrics:
        from repro_torch.api.variants import get_variant
        with OBS.span("metrics"):
            # only the unpruned sequential boundary-complete result doubles
            # as its own oracle
            if cfg.runner == "sequential" and \
                    cfg.prune_policy == "off" and \
                    get_variant(cfg.variant).boundary_complete:
                oracle = set(out.blocked)
            else:
                oracle = _host_oracle(ents, cfg)
            metrics = _replace(
                compute_metrics(out.blocked, oracle,
                                _total_comparisons(ents, cfg)),
                balance=balance, resilience=resilience)
    return ERResult(blocking=blocking, matches=out.matched, metrics=metrics,
                    balance=balance,
                    perf=PerfStats(cache_hits=0, cache_misses=0, traces=0,
                                   cache_entries=0),
                    resilience=resilience)


def _untag_blocking(b: BlockingResult, offset: int) -> BlockingResult:
    """A BlockingResult's pairs mapped from the merged linkage eid space
    back to (lhs_eid, rhs_eid); every other field carried through."""
    return _replace(b, pairs=frozenset(LK.untag_pairs(b.pairs, offset)))


def link(lhs: dict, rhs: dict, cfg: ERConfig, *, bounds=None,
         device=None) -> ERResult:
    """Dual-source linkage R x S: blocked/matched pairs are CROSS-SOURCE
    only, returned as (lhs_eid, rhs_eid) in each source's own id space.
    Both sources must share one payload schema.  ``device`` as in
    ``resolve``."""
    device = resolve_device(device)
    cfg = cfg.with_(linkage=True)
    ents, offset = LK.tag_sources(E.to_device(lhs, device),
                                  E.to_device(rhs, device))
    res = resolve(ents, cfg, bounds=bounds, device=device)
    return _replace(res, blocking=_untag_blocking(res.blocking, offset),
                    matches=frozenset(LK.untag_pairs(res.matches, offset)))
