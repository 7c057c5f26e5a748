"""``resolve`` / ``link`` — the facade tying config, variants, runners and
results together (port of ``repro.api.facade``).

    res = api.resolve(ents, api.ERConfig(variant="jobsn"))            # card
    res = api.resolve(ents, api.ERConfig(), device="cpu")             # CPU
    linked = api.link(ents_r, ents_s, api.ERConfig(window=6))

Shard boundaries come from ``cfg.partitioner`` (profile -> plan ->
execute): a legacy boundary derivation (balanced | range | sample) or a
profile-backed planner (uniform | blocksplit | pairrange); explicit
``bounds`` (a raw array or a ShardPlan) always win.  ``cfg.passes`` runs
multi-pass blocking (a ``MultiPassResult``), ``window_policy="adaptive"``
per-entity windows.  ``resume`` continues a checkpointed stream
(``repro_torch.stream``); ``serve`` starts an online incremental service
(``repro_torch.serve``).  ``cfg.trace`` attaches a ``TraceReport``.
``device=None`` runs on the CUDA card and raises without one.
``runner="shard_map"`` runs one shard per rank of ``mesh`` (a
``launch.Mesh``; None: the default process group, started at world size
1 if there is none).  ``ERResult.perf`` is the executable cache's delta
over the call.
"""
from __future__ import annotations

from dataclasses import replace as _replace

import numpy as np

from repro_torch import balance as B
from repro_torch import obs as OBS
from repro_torch.api import linkage as LK
from repro_torch.api.config import ERConfig
from repro_torch.api.results import (BalanceMetrics, BlockingResult,
                                     ERResult, MultiPassResult, PairSet,
                                     PerfStats, compute_metrics)
from repro_torch.api.runners import (Runner, SequentialRunner,
                                     ShardMapRunner, VmapRunner)
from repro_torch.core import entities as E
from repro_torch.core import keys as K
from repro_torch.core import sn
from repro_torch.device import resolve_device
from repro_torch.perf import cache as PC
from repro_torch.resilience import retry as RZ


def make_runner(cfg: ERConfig, *, mesh=None, axis: str = "data",
                device=None) -> Runner:
    """Instantiate the runner named by ``cfg.runner`` (``mesh``/``axis``
    only matter for the shard_map runner)."""
    if cfg.runner == "sequential":
        return SequentialRunner(num_shards=cfg.num_shards)
    if cfg.runner == "vmap":
        return VmapRunner(num_shards=cfg.num_shards, device=device)
    if cfg.runner == "shard_map":
        return ShardMapRunner(mesh=mesh, axis=axis, device=device)
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
    mode).  Adaptive-window runs get the adaptive oracle: the attached
    ``_weff`` when the entity set carries one, else weff recomputed from
    the key profile (the same function the device path uses)."""
    host = E.to_host(ents)
    valid = host["valid"]
    keys = host["key"][valid]
    eids = host["eid"][valid]
    if cfg.linkage and "src" in host["payload"]:
        src = host["payload"]["src"][valid]
        return LK.sequential_link_pairs(keys, eids, src, cfg.window)
    weff = None
    if "_weff" in host["payload"]:
        weff = host["payload"]["_weff"][valid]
    elif cfg.window_policy == "adaptive":
        from repro_torch import quality as Q
        profile = B.profile_keys(keys, window=cfg.window)
        weff = Q.weff_for_keys(keys, profile, cfg.window, cfg.window_max)
    if weff is not None:
        return sn.adaptive_sn_pairs(keys, eids, weff)
    return sn.sequential_sn_pairs(keys, eids, cfg.window)


def _adaptive_rewrite(ents: dict, cfg: ERConfig):
    """Realize ``window_policy="adaptive"``: attach the per-entity
    effective windows as an int32 ``_weff`` payload tensor on the
    entities' device (a pure function of the global key profile, so it
    rides every shuffle and halo) and rewrite ``window`` to ``window_max``
    — the one width the band runs at.  ``window_policy``/``window_max``
    stay set, so downstream code still sees the run is adaptive."""
    import torch

    from repro_torch import quality as Q
    keys = ents["key"].cpu().numpy()
    profile = B.profile_keys(keys, window=cfg.window,
                             valid=ents["valid"].cpu().numpy())
    weff = Q.weff_for_keys(keys, profile, cfg.window, cfg.window_max)
    ents = dict(ents, payload=dict(ents["payload"], _weff=torch.as_tensor(
        weff, dtype=torch.int32, device=ents["key"].device)))
    return ents, cfg.with_(window=cfg.window_max)


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


def attach_trace(res, tracer):
    """Capture ``tracer`` as a ``TraceReport`` and attach it to ``res``
    (ERResult / MultiPassResult / StreamResult — whichever of the stats
    fields the result carries ride into the unified schema).  Pair/match
    gauges are stamped here so every report answers pairs-per-second
    without consulting the result object."""
    m = tracer.metrics
    m.gauge("pairs").set(len(res.blocking.pairs))
    m.gauge("matches").set(len(res.matches))
    stats = [getattr(res, f, None)
             for f in ("balance", "perf", "stream", "resilience")]
    return _replace(res, trace=OBS.TraceReport.from_tracer(tracer, stats))


def owned_trace(cfg: ERConfig, root: str, attrs: dict, fn):
    """Return ``fn()`` — under ``cfg.trace`` with no tracer active on this
    thread, run inside a fresh tracer's ``root`` span (``attrs`` its
    attributes) and with the report attached (``attach_trace``).  With a
    tracer already active, ``fn``'s spans join that outer trace."""
    if not cfg.trace or OBS.current_tracer() is not None:
        return fn()
    tracer = OBS.Tracer()
    with OBS.activate(tracer), OBS.span(root, **attrs):
        res = fn()
    return attach_trace(res, tracer)


def resolve(ents: dict, cfg: ERConfig, *, bounds=None, mesh=None,
            axis: str = "data", device=None):
    """Run the configured ER pipeline over one entity set (a port entity
    dict, on any device; it is moved to ``device``).

    ``bounds``: explicit partition boundaries ((r-1,) int32) or a
    ``ShardPlan``; planned from ``cfg.partitioner`` when omitted.
    ``mesh``/``axis`` only matter for the shard_map runner (default: the
    default process group on a 1-D mesh).  ``device``: None = the CUDA
    card (raises without one); pass "cpu" to run on the CPU.  The
    sequential runner always runs on the host.

    Returns an ``ERResult`` — or, when ``cfg.passes`` selects multi-pass
    blocking, a ``MultiPassResult`` holding the per-pass ERResults plus
    the union pair sets.  Under ``cfg.trace`` the result also carries a
    ``repro_torch.obs.TraceReport`` (``result.trace``) — unless a tracer
    is already active on this thread, in which case the call adds its
    spans to that outer trace instead (multi-pass passes, stream
    chunks)."""
    device = resolve_device(device)
    return owned_trace(
        cfg, "resolve", dict(variant=cfg.variant, runner=cfg.runner,
                             window=cfg.window),
        lambda: _resolve(ents, cfg, bounds=bounds, mesh=mesh, axis=axis,
                         device=device))


def _resolve(ents: dict, cfg: ERConfig, *, bounds, mesh, axis: str,
             device):
    """``resolve`` minus trace ownership (the body every caller shares)."""
    ents = E.to_device(ents, device)
    if cfg.passes:
        return _resolve_multipass(ents, cfg, bounds=bounds, mesh=mesh,
                                  axis=axis, device=device)
    if cfg.window_policy == "adaptive":
        ents, cfg = _adaptive_rewrite(ents, cfg)
    runner = make_runner(cfg, mesh=mesh, axis=axis, device=device)
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
    cache = PC.executable_cache()
    before = cache.stats.snapshot()

    def _attempt(c: ERConfig, attempt: int):
        # retries lift the plan's exact cap_link (the overflow disproved
        # it); cfg.cap_factor, doubled by the ladder, takes over
        p = plan if attempt == 0 or plan.cap_link is None \
            else _replace(plan, cap_link=None)
        return runner.resolve(ents, p, c)

    with OBS.span("execute", runner=runner.name, shards=runner.shards):
        out, run_cfg, retries, escalations = \
            RZ.run_with_recovery(_attempt, cfg)
    dh, dm, dt = cache.stats.delta(before)
    perf = PerfStats(cache_hits=dh, cache_misses=dm, traces=dt,
                     cache_entries=len(cache))
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
                oracle = out.blocked
            else:
                oracle = _host_oracle(ents, cfg)
            metrics = _replace(
                compute_metrics(out.blocked, oracle,
                                _total_comparisons(ents, cfg)),
                balance=balance, resilience=resilience)
    return ERResult(blocking=blocking, matches=out.matched, metrics=metrics,
                    balance=balance, perf=perf, resilience=resilience)


def _rekeyed(ents: dict, spec) -> dict:
    """Entity set with its sort key replaced by ``spec``'s derivation (the
    per-pass view multi-pass blocking resolves; payload/eid/valid shared)."""
    return {"key": K.derive_sort_key(ents, spec), "eid": ents["eid"],
            "valid": ents["valid"], "payload": ents["payload"]}


def union_passes(results, cfg):
    """The union of a multi-pass run's pass results (any sequence of
    objects carrying ``.blocking``, ``.matches`` and ``.resilience``):
    ``(blocking, matches, resilience)``, the pairs unioned and the
    accounting added up (``load`` stays empty — per-pass shard loads live
    on the pass results)."""
    b0 = results[0].blocking
    total = lambda f: sum(getattr(r.blocking, f) for r in results)
    blocking = BlockingResult(
        pairs=PairSet().union(*(r.blocking.pairs for r in results)),
        load=(), overflow=total("overflow"), variant=cfg.variant,
        runner=b0.runner, window=cfg.window, num_shards=b0.num_shards,
        cand_overflow=total("cand_overflow"),
        matcher_evals=total("matcher_evals"),
        pair_overflow=total("pair_overflow"), pruned=total("pruned"))
    return (blocking, PairSet().union(*(r.matches for r in results)),
            RZ.union_stats(r.resilience for r in results))


def _resolve_multipass(ents: dict, cfg: ERConfig, *, bounds, mesh,
                       axis: str, device) -> MultiPassResult:
    """One full single-pass resolve per SortKeySpec + the pair-set union.

    Explicit ``bounds`` are rejected: each pass sorts by a different
    derived key, so per-pass boundaries are planned from
    ``cfg.partitioner``.  With metrics, each pass's sequential host oracle
    is computed once here (per-pass resolves run metric-less) and serves
    both the pass's own metrics and the union metrics."""
    if bounds is not None:
        raise ValueError(
            "explicit bounds cannot be shared across multi-pass sort keys "
            "(each pass sorts by a different derived key); drop bounds and "
            "let cfg.partitioner plan each pass, or run passes manually")
    sub = cfg.with_(passes=(), compute_metrics=False)
    results = []
    union_oracle: set = set()
    for spec in cfg.passes:
        with OBS.span("pass", name=spec.name, kind=spec.kind):
            pents = _rekeyed(ents, spec)
            res = resolve(pents, sub, mesh=mesh, axis=axis, device=device)
            if cfg.compute_metrics:
                with OBS.span("metrics"):
                    oracle = _host_oracle(pents, sub)
                    union_oracle |= oracle
                    res = _replace(res, metrics=_replace(
                        compute_metrics(res.blocking.pairs, oracle,
                                        _total_comparisons(ents, cfg)),
                        balance=res.balance))
        results.append(res)
    results = tuple(results)
    blocking, matches, resilience = union_passes(results, cfg)
    metrics = None
    if cfg.compute_metrics:
        metrics = compute_metrics(blocking.pairs, union_oracle,
                                  _total_comparisons(ents, cfg))
    return MultiPassResult(passes=results,
                           pass_names=tuple(p.name for p in cfg.passes),
                           blocking=blocking, matches=matches,
                           metrics=metrics, resilience=resilience)


def untag(res, offset: int):
    """An ERResult, MultiPassResult or StreamResult with its blocked and
    matched pairs, and its passes', mapped from the merged linkage eid
    space back to (lhs_eid, rhs_eid); every other field carried through."""
    back = lambda pairs: frozenset(LK.untag_pairs(pairs, offset))
    res = _replace(res, blocking=_replace(res.blocking,
                                          pairs=back(res.blocking.pairs)),
                   matches=back(res.matches))
    if getattr(res, "passes", ()):
        res = _replace(res, passes=tuple(untag(p, offset)
                                         for p in res.passes))
    return res


def link(lhs: dict, rhs: dict, cfg: ERConfig, *, bounds=None, mesh=None,
         axis: str = "data", device=None):
    """Dual-source linkage R x S: blocked/matched pairs are CROSS-SOURCE
    only, returned as (lhs_eid, rhs_eid) in each source's own id space.
    Both sources must share one payload schema.  ``mesh``, ``axis`` and
    ``device`` as in ``resolve``.  Returns an ``ERResult`` (or ``MultiPassResult`` under
    ``cfg.passes``, with union and per-pass pairs all mapped back)."""
    device = resolve_device(device)
    cfg = cfg.with_(linkage=True)
    ents, offset = LK.tag_sources(E.to_device(lhs, device),
                                  E.to_device(rhs, device))
    return untag(resolve(ents, cfg, bounds=bounds, mesh=mesh, axis=axis,
                         device=device), offset)


def serve(cfg: ERConfig, *, initial=None, device=None, **kwargs):
    """Start an online incremental ``repro_torch.serve.ResolutionService``
    under ``cfg`` (single-pass, non-linkage configs only): inserts and
    deletes arrive as micro-batches, and the served pair sets stay
    bit-identical to a from-scratch ``resolve`` over the live corpus at
    every point.  ``initial`` seeds the corpus through the same insert
    path; ``device`` is where every delta call runs (None = the CUDA card,
    raising without one; "cpu" runs on the CPU); remaining kwargs
    (``max_batch``, ``max_wait_ms``, ``spool_dir``, ``admission``,
    ``chaos``, ...) go to the service constructor.

    Under brownout (``admission=AdmissionConfig(...)``) the bit-parity
    invariant relaxes to eventually-exact: blocked pairs stay exact, new
    matches may be deferred, and ``repair()`` restores full parity
    (DESIGN.md §13)."""
    if cfg.window_policy == "adaptive":
        # the incremental profile changes with every insert/delete, so weff
        # would vary over time and served pair sets could never stay
        # bit-identical to a from-scratch resolve
        raise ValueError(
            "window_policy='adaptive' is not servable: per-entity windows "
            "derive from the full-corpus key profile, which is incremental "
            "(time-varying) in the serve path; use a fixed window")
    from repro_torch.serve import ResolutionService
    return ResolutionService(cfg, initial=initial, device=device, **kwargs)


def resume(checkpoint_dir: str, *, chunks=None, cfg: ERConfig = None,
           mesh=None, axis: str = "data", device=None):
    """Resume a checkpointed ``stream.resolve_stream(checkpoint_dir=...)``
    run killed mid-flight (DESIGN.md §11): continues at the last committed
    chunk and returns the same ``StreamResult`` — bit-identical pair union
    — an uninterrupted run would have produced.  Checkpoints the
    reference package wrote resume here too.

    The config is rebuilt from the checkpoint manifest; pass ``cfg`` only
    when the original run used a non-default matcher (it is validated
    against the stored fingerprint).  ``chunks`` re-supplies the original
    deterministic chunk iterator and is required only when the run died
    during ingest.  ``mesh``, ``axis`` and ``device`` as in
    ``resolve``."""
    from repro_torch.resilience.checkpoint import resume_stream
    return resume_stream(checkpoint_dir, chunks=chunks, cfg=cfg, mesh=mesh,
                         axis=axis, device=device)
