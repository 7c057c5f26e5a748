"""Out-of-core streaming resolution: ``resolve_stream`` / ``link_stream``
(port of ``repro.stream.resolver``).

Every other path materializes the full sorted corpus on the device inside
one ``resolve()`` — capping n at device memory, the opposite of the paper's
premise that MapReduce SN exists for datasets no single node holds.
``resolve_stream`` lifts that cap: it consumes an ITERATOR of entity
chunks, globally sort-partitions them out-of-core (per-chunk device sorts +
a k-way host merge — ``external_sort``), and drives the variant × runner ×
engine machinery chunk-by-chunk.  Peak device residency is one
``[seam halo | chunk]`` window, so n is bounded by host disk (the
``spool_dir`` option), not device memory.

**Seam halo.**  The merged stream is cut into fixed-width native chunks;
each chunk is resolved together with the w−1 immediately preceding GLOBAL
entities (the carry).  Any SN pair whose later element is native to chunk k
reaches back at most w−1 ranks — i.e. into chunk k or its carry — so the
union of per-chunk pair sets is bit-identical to a monolithic ``resolve``:

  * **RepSN / JobSN** (boundary-complete): each chunk is a contiguous slice
    of the global (key, eid) order, so its SN pairs are a subset of the
    global set, and the carry closes every seam.  Chunks are re-planned
    individually (``balance.plan_shards``); chunks too small to plan
    legally (n < r·w) collapse to one shard, counted in
    ``degenerate_chunks``.
  * **SRP** (pair set DEPENDS on the partitioning): the monolithic plan is
    reproduced exactly from the incrementally merged ``KeyProfile``
    (``balance.plan_from_profile``), and every chunk routes by GLOBAL
    sorted rank against that plan's ``rank_bounds``.

**Device.**  ``device`` (None = the CUDA card) is where every raw chunk is
sorted and every chunk's shard program runs; only the merge, the carry and
the pair union live on the host.

**Steady state.**  Chunks share one shape (natives padded to ``chunk_size``
+ a w−1 halo prefix) and one normalized plan form, as in the reference.
After the first chunk every chunk hits the ``repro_torch.perf`` executable
cache (``steady_chunks``; on the card its shard program is a CUDA graph
replay), each chunk metered as in the reference.

**Multi-pass.**  With ``cfg.passes`` the whole pipeline (sort → merge →
chunked resolve) reruns per derived sort key over the SAME ingested chunk
store, and the union rides on ``StreamResult.passes``.
"""
from __future__ import annotations

import time
from collections.abc import Set as AbstractSet
from dataclasses import dataclass, replace
from typing import Iterable, Optional, Set, Tuple

import numpy as np

from repro_torch import balance as B
from repro_torch import obs as OBS
from repro_torch.api import facade as F
from repro_torch.api import linkage as LK
from repro_torch.api import results as RES
from repro_torch.api.config import ERConfig
from repro_torch.api.results import BlockingResult, ERMetrics, \
    compute_metrics
from repro_torch.api.variants import get_variant
from repro_torch.core import entities as E
from repro_torch.core import sn
from repro_torch.device import resolve_device
from repro_torch.perf import cache as PC
from repro_torch.quality import adaptive as QA
# the leaf retry module only (never the package __init__): the resilience
# package imports checkpoint -> stream.store -> this module, so importing
# the package here would re-enter its half-executed __init__
from repro_torch.resilience import retry as RZ
from repro_torch.stream.external_sort import merged_blocks, rechunk
from repro_torch.stream.store import ChunkStore

Pair = Tuple[int, int]


@dataclass(frozen=True)
class StreamStats:
    """Telemetry of one streaming pass (or the ingest-wide aggregate).

    chunks             native chunks resolved (ceil(n / chunk_size))
    chunk_size         native rows per chunk (the device-residency knob)
    entities           total valid entities ingested
    runs               sorted runs merged (== ingested chunks)
    carry_entities     total seam-halo rows re-resolved across chunk seams
                       (≈ (chunks−1)·(w−1): the streaming overhead)
    degenerate_chunks  chunks too small to plan r shards legally (n < r·w),
                       collapsed to one shard — correctness kept, balance
                       lost; a healthy stream has 0 (raise chunk_size)
    steady_chunks      chunks served entirely from the executable cache
                       (hits > 0, zero builds/traces); after the first
                       chunk every chunk should be steady
    cache_hits/cache_misses/traces   executable-cache deltas over the pass
    spooled_bytes      bytes written to the disk spool (0 in-memory); the
                       top-level result counts raw chunks + sorted runs,
                       per-pass results only their own runs
    chunk_device_bytes max host->device bytes staged per chunk resolve —
                       the PEAK device-input residency of the stream
    corpus_bytes       total entity bytes of the whole corpus (what one
                       monolithic resolve would stage instead)
    """
    chunks: int
    chunk_size: int
    entities: int
    runs: int
    carry_entities: int
    degenerate_chunks: int
    steady_chunks: int
    cache_hits: int
    cache_misses: int
    traces: int
    spooled_bytes: int
    chunk_device_bytes: int
    corpus_bytes: int


@dataclass(frozen=True)
class StreamResult:
    """Outcome of a streaming resolution (mirrors ``ERResult``; multi-pass
    runs additionally mirror ``MultiPassResult`` via ``passes``).

    ``blocking.load`` / ``blocking.cand_count`` report the elementwise MAX
    over chunks, while the overflow counters aggregate additively.
    ``stream`` carries the streaming telemetry; per-pass results keep
    their own.  ``trace`` is the ``repro_torch.obs.TraceReport`` of a run
    under ``ERConfig.trace=True``; per-pass results share the owner's
    tracer and carry none of their own."""
    blocking: BlockingResult
    matches: AbstractSet[Pair]
    stream: StreamStats
    metrics: Optional[ERMetrics] = None
    passes: Tuple["StreamResult", ...] = ()
    pass_names: Tuple[str, ...] = ()
    resilience: Optional[RZ.ResilienceStats] = None
    trace: Optional[object] = None

    @property
    def pairs(self) -> AbstractSet[Pair]:
        """The blocked (candidate) pair set — sugar for blocking.pairs."""
        return self.blocking.pairs


def _valid_host(ents) -> dict:
    """One input chunk as a host dict with its invalid slots stripped."""
    h = E.to_host(ents)
    valid = np.asarray(h["valid"], bool)
    if not valid.all():        # all-valid chunks skip the mask copy
        h = E.host_take(h, valid)
    return h


def _ingest(chunks: Iterable[dict], spool_dir: Optional[str], *,
            store: Optional[ChunkStore] = None, transform=None):
    """Consume the chunk iterator once: strip invalid slots, move to host,
    apply the optional per-chunk ``transform`` (``link_stream``'s source
    tagging), spool.  Returns (store, max_chunk_rows, total_rows,
    corpus_bytes); pass ``store`` to keep appending to an existing spool
    (counters restart — callers accumulate)."""
    store = store if store is not None else ChunkStore(spool_dir,
                                                       prefix="raw")
    max_len = total = nbytes = 0
    for ents in chunks:
        h = _valid_host(ents)
        if int(h["key"].shape[0]) == 0:
            continue
        if transform is not None:
            h = transform(h)
        max_len = max(max_len, int(h["key"].shape[0]))
        total += int(h["key"].shape[0])
        nbytes += _entity_bytes(h)
        store.append(h)
    return store, max_len, total, nbytes


def _entity_bytes(h: dict) -> int:
    """Total bytes of one host entity dict (key/eid/valid + payload)."""
    return (h["key"].nbytes + h["eid"].nbytes + h["valid"].nbytes
            + sum(v.nbytes for v in h["payload"].values()))


def _host_pad(ents: dict, cap: int) -> dict:
    """Pad a host entity dict to exactly ``cap`` rows with invalid slots
    (keys pushed past every real key) — the fixed combined-chunk shape of
    every streamed shard program."""
    n = int(ents["key"].shape[0])
    if n == cap:
        return ents
    pad = cap - n
    z = lambda a: np.zeros((pad,) + a.shape[1:], a.dtype)
    tail = {
        "key": np.full((pad,), int(E.INVALID_KEY), np.int32),
        "eid": z(ents["eid"]),
        "valid": np.zeros((pad,), bool),
        "payload": {k: z(v) for k, v in ents["payload"].items()},
    }
    return E.host_concat([ents, tail])


def _device_entities(h: dict, device) -> dict:
    """A host entity dict as port tensors on ``device``."""
    return E.make_entities(h["key"], h["eid"], payload=h["payload"],
                           valid=h["valid"], device=device)


def _sorted_runs(raw: ChunkStore, spec, window: int,
                 spool_dir: Optional[str], label: str, device, *,
                 runs: Optional[ChunkStore] = None):
    """Phase 1 of a pass: sort every raw chunk on ``device`` by the pass's
    derived key and fold each chunk's key distribution into ONE merged
    profile (``KeyProfile.merge``) — planning sees the whole corpus without
    ever holding it.  Returns (runs store, merged profile); ``runs`` lets
    the checkpoint path supply its own (durable, pre-swept) store."""
    from repro_torch.core import keys as K
    if runs is None:
        runs = ChunkStore(spool_dir and f"{spool_dir}/runs-{label}",
                          prefix="run")
    profile = B.KeyProfile.empty(window)
    for h in raw:
        dev = _device_entities(h, device)
        key = None if spec is None else K.derive_sort_key(dev, spec)
        run = E.sort_chunk(dev, key=key)
        profile = profile.merge(B.profile_keys(run["key"], window=window))
        runs.append(run)
    return runs, profile


def _chunk_plan(cfg: ERConfig, variant, gplan: B.ShardPlan, dev: dict,
                padded: dict, ranks: np.ndarray, r: int):
    """The per-chunk ShardPlan (see module doc): global-rank routing for
    partition-dependent variants (SRP), per-chunk re-planning for boundary-
    complete ones.  Every plan is normalized to dest-based routing with
    ``cap_link=None`` so all chunks share one program shape.
    Returns (plan, degenerate: bool)."""
    cap = int(padded["key"].shape[0])
    n_comb = int(ranks.shape[0])
    if not variant.boundary_complete:
        dest = np.zeros(cap, np.int32)
        dest[:n_comb] = np.searchsorted(
            gplan.rank_bounds, ranks, side="right").astype(np.int32)
        return replace(gplan, num_shards=r, dest=dest, cap_link=None,
                       rank_granular=True), False
    if n_comb >= r * cfg.window:
        try:
            plan = B.plan_shards(dev, cfg, r)
            dest = plan.dest if plan.dest is not None else \
                plan.assignment(padded["key"])
            return replace(plan, dest=np.asarray(dest, np.int32),
                           cap_link=None), False
        except ValueError:
            # the GLOBAL plan already validated this cfg (config-static
            # errors raised before any chunk ran), so a failure here is
            # chunk-local data shape (this chunk's key distribution plans
            # an illegal halo): collapse below, counted as degenerate
            pass
    # too small (or unplannable) for r shards: one shard holds the chunk —
    # correct for boundary-complete variants, counted as degenerate
    return B.ShardPlan(partitioner="stream-collapse", num_shards=r,
                       bounds=np.zeros(max(r - 1, 0), np.int32),
                       dest=np.zeros(cap, np.int32)), True


def _stream_pass(raw: ChunkStore, cfg: ERConfig, spec, chunk_size: int,
                 runner, spool_dir: Optional[str], label: str,
                 total_comparisons: int, device, *, ckpt=None, fault=None):
    """Run ONE full streaming pass (sort → merge → chunked resolve) and
    return (StreamResult, oracle_pair_set | None) — the oracle set is kept
    so multi-pass callers can union per-pass oracles for union metrics.

    With ``ckpt`` (a ``resilience.StreamCheckpoint``) the pass is durable:
    sorted runs + profile commit once, then every resolved chunk commits
    its pair spool, seam halo, and accumulators — and a pass whose
    manifest already records progress FAST-FORWARDS: committed chunks are
    skipped in the (deterministic) merged stream, their pairs reloaded
    from the spool, the carry/rank/counters restored.  ``fault`` is the
    test-only ``FaultPlan`` crash injector."""
    with OBS.span("pass", name=label, variant=cfg.variant):
        return _stream_pass_body(raw, cfg, spec, chunk_size, runner,
                                 spool_dir, label, total_comparisons,
                                 device, ckpt=ckpt, fault=fault)


def _stream_pass_body(raw: ChunkStore, cfg: ERConfig, spec,
                      chunk_size: int, runner, spool_dir: Optional[str],
                      label: str, total_comparisons: int, device, *,
                      ckpt=None, fault=None):
    """``_stream_pass`` proper (the wrapper above only opens the pass's
    span so every phase below nests under it)."""
    w_base = cfg.window
    if cfg.window_policy == "adaptive":
        # the facade's adaptive rewrite: the band (and every derived width
        # — seam carry, combined_cap, halo validation) runs at window_max;
        # per-chunk weff comes from the MERGED profile, whose per-key
        # counts are exactly the monolithic corpus's
        cfg = cfg.with_(window=cfg.window_max)
    w, r = cfg.window, runner.shards
    variant = get_variant(cfg.variant)
    with OBS.span("sort_runs"):
        if ckpt is not None:
            runs, sorted_done = ckpt.runs_store(label)
            if sorted_done:
                profile = ckpt.load_profile(label)
            else:
                runs, profile = _sorted_runs(raw, spec, w, None, label,
                                             device, runs=runs)
                ckpt.commit_sorted(label, runs, profile)
        else:
            runs, profile = _sorted_runs(raw, spec, w, spool_dir, label,
                                         device)
    with OBS.span("plan", partitioner=cfg.partitioner, n=profile.n):
        gplan = B.plan_from_profile(profile, cfg.partitioner, r)
        # config-level feasibility is judged ONCE, against the global
        # plan — exactly what the monolithic facade would reject
        B.validate_plan(gplan, cfg, profile.n)

        combined_cap = (w - 1) + chunk_size
        # unset (None) caps resolve from the merged profile's planned
        # loads — floored at the combined chunk width, since a degenerate
        # (collapsed) chunk puts the whole [halo | chunk] window on one
        # shard
        cfg, auto_caps = RZ.autosize_caps(cfg, plan=gplan, profile=profile,
                                          r=r, floor_load=combined_cap)
    cache = PC.executable_cache()
    blocked_parts, matched_parts = [], []
    load_max = np.zeros(r, np.int64)
    cand_max = np.zeros(r, np.int64)
    overflow = cand_overflow = matcher_evals = pair_overflow = 0
    pruned = 0
    chunks = steady = degenerate = carry_total = 0
    hits = misses = traces = 0
    retries = escalations = 0
    device_bytes = 0
    oracle: Optional[Set[Pair]] = set() if cfg.compute_metrics else None

    carry: Optional[dict] = None
    rank_offset = 0
    completed = 0
    state = ckpt.pass_state(label) if ckpt is not None else None
    if state is not None and state["completed_chunks"] > 0:
        completed = state["completed_chunks"]
        for i in range(completed):
            bl, ma = ckpt.load_pairs(label, i)
            blocked_parts.append(bl)
            matched_parts.append(ma)
        carry = ckpt.load_carry(label)
        rank_offset = state["rank_offset"]
        chunks, carry_total = state["chunks"], state["carry_total"]
        degenerate, steady = state["degenerate"], state["steady"]
        hits, misses = state["hits"], state["misses"]
        traces = state["traces"]
        overflow = state["overflow"]
        cand_overflow = state["cand_overflow"]
        matcher_evals = state["matcher_evals"]
        pair_overflow = state["pair_overflow"]
        pruned = state.get("pruned", 0)
        retries, escalations = state["retries"], state["escalations"]
        device_bytes = state["device_bytes"]
        if state["load_max"]:
            load_max = np.asarray(state["load_max"], np.int64)
        if state["cand_max"]:
            cand_max = np.asarray(state["cand_max"], np.int64)

    # the ladder's escalated caps are STICKY across chunks: once one chunk
    # forced a doubling, later chunks start at the doubled shape instead
    # of re-climbing the ladder per chunk
    run_cfg = cfg
    ci = -1
    # the merge is pulled through ``next`` by hand (rather than a plain
    # ``for``) so the k-way merge's own time lands in ``merge`` spans,
    # separate from the ``chunk`` resolve spans it feeds
    merged = iter(rechunk(merged_blocks(runs, chunk_size), chunk_size))
    while True:
        with OBS.span("merge"):
            native = next(merged, None)
        if native is None:
            break
        ci += 1
        if ci < completed:
            continue   # fast-forward: committed by a previous (killed) run
        csp = OBS.span("chunk", index=ci)
        with csp:
            n_nat = int(native["key"].shape[0])
            combined = native if carry is None else \
                E.host_concat([carry, native])
            n_comb = int(combined["key"].shape[0])
            n_carry = n_comb - n_nat
            padded = _host_pad(combined, combined_cap)
            if cfg.window_policy == "adaptive":
                # weff rides only the per-chunk PADDED COPY — the carry
                # (and its checkpointed form) keeps the raw payload
                # schema, so host_concat sees matching fields every chunk
                padded = dict(padded, payload=dict(
                    padded["payload"],
                    _weff=QA.weff_for_keys(np.asarray(padded["key"]),
                                           profile, w_base, w)))
            dev = _device_entities(padded, device)
            ranks = np.arange(rank_offset - n_carry, rank_offset + n_nat,
                              dtype=np.int64)
            plan, degen = _chunk_plan(cfg, variant, gplan, dev, padded,
                                      ranks, r)
            if csp.enabled:
                csp.set(natives=n_nat, carry=n_carry,
                        degenerate=bool(degen))
                OBS.current_tracer().metrics.counter(
                    "carry_entities").inc(n_carry)

            before = cache.stats.snapshot()
            po, run_cfg, rt, esc = RZ.run_with_recovery(
                lambda c, attempt: runner.resolve_packed(dev, plan, c),
                run_cfg)
            retries, escalations = retries + rt, escalations + esc
            dh, dm, dt = cache.stats.delta(before)
            hits, misses, traces = hits + dh, misses + dm, traces + dt
            steady += int(dh > 0 and dm == 0 and dt == 0)
            degenerate += int(degen)

            blocked_parts.append(po.blocked)
            matched_parts.append(po.matched)
            load_max = np.maximum(load_max, np.asarray(po.load, np.int64))
            if po.cand_count:
                cand_max = np.maximum(cand_max,
                                      np.asarray(po.cand_count, np.int64))
            overflow += po.overflow
            cand_overflow += po.cand_overflow
            matcher_evals += po.matcher_evals
            pair_overflow += po.pair_overflow
            pruned += po.pruned
            device_bytes = max(device_bytes,
                               _entity_bytes(padded) + 4 * combined_cap)

            if oracle is not None:
                # the FULL sequential-SN oracle, accumulated chunk-wise
                # (each combined slice is contiguous in the global order,
                # so chunk oracles union to the global one) — deliberately
                # NOT the variant-faithful set: the metric must EXPOSE
                # SRP's missed boundary pairs, not absolve them
                if cfg.window_policy == "adaptive":
                    cw = QA.weff_for_keys(np.asarray(combined["key"]),
                                          profile, w_base, w)
                    pairs = sn.adaptive_sn_pairs(combined["key"],
                                                 combined["eid"], cw)
                else:
                    pairs = sn.sequential_sn_pairs(combined["key"],
                                                   combined["eid"], w)
                if cfg.linkage and "src" in combined["payload"]:
                    pairs = LK.filter_cross_source(
                        pairs, combined["eid"], combined["payload"]["src"])
                oracle |= pairs

            chunks += 1
            carry_total += n_carry
            keep = min(w - 1, n_comb)
            carry = E.host_take(combined, slice(n_comb - keep, n_comb))
            rank_offset += n_nat

            if ckpt is not None:
                # commit protocol (checkpoint module doc): pair spool,
                # then seam halo + manifest — the manifest write is the
                # commit point
                t0 = time.perf_counter()
                sp = OBS.span("checkpoint_commit", chunk=ci)
                with sp:
                    ckpt.spool_chunk(label, ci, po.blocked, po.matched)
                    if fault is not None:
                        fault.before_commit(label, ci)
                    ckpt.commit_chunk(
                        label, carry, rank_offset=rank_offset,
                        chunks=chunks, carry_total=carry_total,
                        degenerate=degenerate, steady=steady, hits=hits,
                        misses=misses, traces=traces,
                        overflow=int(overflow),
                        cand_overflow=int(cand_overflow),
                        matcher_evals=int(matcher_evals),
                        pair_overflow=int(pair_overflow),
                        pruned=int(pruned),
                        retries=retries, escalations=escalations,
                        device_bytes=int(device_bytes),
                        load_max=[int(x) for x in load_max],
                        cand_max=[int(x) for x in cand_max])
                if sp.enabled:
                    OBS.current_tracer().metrics.histogram(
                        "checkpoint_commit_ms").observe(
                            1e3 * (time.perf_counter() - t0))
                if fault is not None:
                    fault.after_commit(label, ci)

    # one sort-dedup (``unique_packed``), not ``np.unique``: newer numpy
    # hashes there, 15-22 s on 12.6M pairs (PERF.md)
    dedup = lambda parts: RES.unique_packed(np.concatenate(parts)) \
        if parts else np.empty((0,), RES.PACKED_DTYPE)
    with OBS.span("union", chunks=len(blocked_parts)):
        blocked = dedup(blocked_parts)
        matched = dedup(matched_parts)
    blocking = BlockingResult(
        pairs=RES.packed_to_frozenset(blocked),
        load=tuple(int(x) for x in load_max), overflow=overflow,
        variant=cfg.variant, runner=runner.name, window=w, num_shards=r,
        cand_count=tuple(int(x) for x in cand_max),
        cand_overflow=cand_overflow, matcher_evals=matcher_evals,
        pair_overflow=pair_overflow, pruned=pruned)
    metrics = None
    if oracle is not None:
        metrics = compute_metrics(blocking.pairs, oracle, total_comparisons)
    stats = StreamStats(
        chunks=chunks, chunk_size=chunk_size, entities=rank_offset,
        runs=len(runs), carry_entities=carry_total,
        degenerate_chunks=degenerate, steady_chunks=steady,
        cache_hits=hits, cache_misses=misses, traces=traces,
        # this pass's own spool only (its sorted runs); the shared raw
        # store is stamped ONCE at the top level — summing per-pass stats
        # must not multiply it by the pass count
        spooled_bytes=runs.spooled_bytes,
        chunk_device_bytes=device_bytes, corpus_bytes=0)
    resilience = RZ.ResilienceStats(
        policy=cfg.on_overflow, retries=retries, escalations=escalations,
        cand_cap=run_cfg.cand_cap or 0, pair_cap=run_cfg.pair_cap or 0,
        auto_caps=auto_caps)
    if ckpt is not None:
        ckpt.mark_pass_done(label)
    return StreamResult(
        blocking=blocking, matches=RES.packed_to_frozenset(matched),
        stream=stats, metrics=metrics, resilience=resilience), oracle


def _union_stream(results: Tuple[StreamResult, ...], cfg: ERConfig,
                  names: Tuple[str, ...], oracle: Optional[Set[Pair]],
                  total_comparisons: int) -> StreamResult:
    """Union per-pass StreamResults: pair/accounting union through the ONE
    shared implementation (``facade.union_blocking``) + additive streaming
    telemetry."""
    blocking = F.union_blocking(results, cfg, results[0].blocking.runner)
    s0 = results[0].stream
    total = lambda f: sum(getattr(r.stream, f) for r in results)
    stats = StreamStats(
        chunks=total("chunks"), chunk_size=s0.chunk_size,
        entities=s0.entities, runs=total("runs"),
        carry_entities=total("carry_entities"),
        degenerate_chunks=total("degenerate_chunks"),
        steady_chunks=total("steady_chunks"),
        cache_hits=total("cache_hits"), cache_misses=total("cache_misses"),
        traces=total("traces"), spooled_bytes=total("spooled_bytes"),
        chunk_device_bytes=max(r.stream.chunk_device_bytes
                               for r in results),
        corpus_bytes=s0.corpus_bytes)
    metrics = None
    if oracle is not None:
        metrics = compute_metrics(blocking.pairs, oracle,
                                  total_comparisons)
    rz = [r.resilience for r in results if r.resilience is not None]
    resilience = None if not rz else RZ.ResilienceStats(
        policy=rz[0].policy,
        retries=sum(x.retries for x in rz),
        escalations=sum(x.escalations for x in rz),
        cand_cap=max(x.cand_cap for x in rz),
        pair_cap=max(x.pair_cap for x in rz),
        auto_caps=any(x.auto_caps for x in rz))
    return StreamResult(
        blocking=blocking,
        matches=RES.PairSet().union(*(r.matches for r in results)),
        stream=stats, metrics=metrics, passes=results, pass_names=names,
        resilience=resilience)


def _finalize(res: StreamResult, nbytes: int,
              raw_spool: int) -> StreamResult:
    """Stamp the ingest-wide totals onto a result's stats: the corpus byte
    count and the shared raw store's spool bytes (added exactly once —
    per-pass stats only count their own sorted-run spool)."""
    return replace(res, stream=replace(
        res.stream, corpus_bytes=nbytes,
        spooled_bytes=res.stream.spooled_bytes + raw_spool))


def resolve_stream(chunks: Iterable[dict], cfg: ERConfig, *,
                   chunk_size: Optional[int] = None, mesh=None,
                   axis: str = "data", spool_dir: Optional[str] = None,
                   checkpoint_dir: Optional[str] = None,
                   fault_plan=None, device=None) -> StreamResult:
    """Resolve an out-of-core entity stream (see module doc).

    ``chunks``: an iterable of entity dicts (port tensors on any device,
    or host numpy in either package's dtypes; any sizes, consumed ONCE);
    keys may arrive in any order — the external merge establishes the
    global sort.  ``chunk_size``: native rows resolved per device call
    (defaults to the largest ingested chunk); peak device residency is one
    (w−1 + chunk_size)-row window.  ``spool_dir``: directory for the host
    spool (None keeps chunks in memory).  ``mesh``/``axis`` select the
    process group of the shard_map runner.  ``device``: where chunks are
    sorted and resolved (None = the CUDA card, raising without one; "cpu"
    runs on the CPU).

    ``checkpoint_dir`` makes the run DURABLE: progress commits
    crash-atomically after every ingested chunk and every resolved chunk,
    and re-running the same call — or ``api.resume(checkpoint_dir)`` —
    continues at the last committed chunk with a bit-identical result.
    The directory doubles as the spool (``spool_dir`` is ignored);
    ``compute_metrics`` is not supported on checkpointed runs.
    ``fault_plan`` (a ``resilience.FaultPlan``) injects deterministic
    crashes at the commit seams — the kill/resume test harness.

    The union of per-chunk pair sets is bit-identical to a monolithic
    ``resolve(all_chunks, cfg)`` — provided capacities don't truncate.
    Returns a ``StreamResult``; with ``cfg.passes`` the top level holds the
    multi-pass union and ``result.passes`` the per-pass results.  Under
    ``cfg.trace`` the result also carries a ``repro_torch.obs``
    ``TraceReport`` (root ``stream`` span over ingest / per-pass sort,
    merge, chunk and checkpoint-commit child spans — DESIGN.md §12)."""
    device = resolve_device(device)
    return F.owned_trace(
        cfg, "stream", dict(variant=cfg.variant, runner=cfg.runner,
                            window=cfg.window),
        lambda: _resolve_stream(chunks, cfg, chunk_size=chunk_size,
                                spool_dir=spool_dir,
                                checkpoint_dir=checkpoint_dir,
                                fault_plan=fault_plan, mesh=mesh, axis=axis,
                                device=device))


def _resolve_stream(chunks: Iterable[dict], cfg: ERConfig, *,
                    chunk_size: Optional[int], spool_dir: Optional[str],
                    checkpoint_dir: Optional[str], fault_plan, mesh,
                    axis: str, device) -> StreamResult:
    """``resolve_stream`` minus the owner-tracer wrapper (the body runs
    inside the ambient ``stream`` span when tracing is on)."""
    if checkpoint_dir is not None:
        from repro_torch.resilience.checkpoint import StreamCheckpoint
        ckpt = StreamCheckpoint.open(checkpoint_dir, cfg, chunk_size)
        return _resolve_checkpointed(chunks, cfg, ckpt, mesh=mesh,
                                     axis=axis, device=device,
                                     fault=fault_plan)
    if fault_plan is not None:
        raise ValueError("fault_plan injects crashes at checkpoint commit "
                         "seams and requires checkpoint_dir")
    with OBS.span("ingest"):
        raw, max_len, total, nbytes = _ingest(chunks, spool_dir)
    return _resolve_ingested(raw, max_len, total, nbytes, cfg,
                             chunk_size=chunk_size, mesh=mesh, axis=axis,
                             device=device, spool_dir=spool_dir)


def _ingest_checkpointed(chunks: Iterable[dict], store: ChunkStore,
                         ckpt) -> None:
    """The durable twin of ``_ingest``: append each (valid-stripped) chunk
    to the checkpoint's raw store and commit the running ingest totals
    after every append.  A resumed run re-supplies the SAME deterministic
    iterator; the first ``ingest.chunks`` non-empty chunks are skipped —
    they are already durable."""
    skip = ckpt.ingest["chunks"]
    max_len = ckpt.ingest["max_len"]
    total, nbytes = ckpt.ingest["total"], ckpt.ingest["nbytes"]
    seen = 0
    for ents in chunks:
        h = _valid_host(ents)
        if int(h["key"].shape[0]) == 0:
            continue
        seen += 1
        if seen <= skip:
            continue         # durably committed by the previous run
        max_len = max(max_len, int(h["key"].shape[0]))
        total += int(h["key"].shape[0])
        nbytes += _entity_bytes(h)
        store.append(h)
        ckpt.commit_raw(max_len, total, nbytes)


def _resolve_checkpointed(chunks: Optional[Iterable[dict]], cfg: ERConfig,
                          ckpt, *, mesh, axis: str, device,
                          fault) -> StreamResult:
    """Drive one checkpointed run (fresh or resumed) to completion: finish
    ingest if the manifest says it never completed, then resolve with
    every pass fast-forwarding over its committed chunks."""
    if cfg.compute_metrics:
        raise ValueError(
            "compute_metrics is not supported with checkpoint_dir: the "
            "host oracle accumulates over the whole run and is not "
            "persisted; compute metrics on a separate un-checkpointed run")
    raw = ckpt.raw_store()
    if ckpt.phase == "ingest":
        if chunks is None:
            raise ValueError(
                f"checkpoint {ckpt.path!r} stopped during ingest "
                f"({ckpt.ingest['chunks']} chunks committed); resuming "
                f"needs the original chunk iterator re-supplied via "
                f"chunks=...")
        with OBS.span("ingest"):
            _ingest_checkpointed(chunks, raw, ckpt)
        ckpt.ingest_done()
    ing = ckpt.ingest
    res = _resolve_ingested(raw, ing["max_len"], ing["total"],
                            ing["nbytes"], cfg,
                            chunk_size=ckpt.manifest["chunk_size"],
                            mesh=mesh, axis=axis, device=device,
                            spool_dir=None, ckpt=ckpt, fault=fault)
    ckpt.mark_done()
    return res


def _total_stream_comparisons(raw: ChunkStore, total: int, cfg: ERConfig,
                              n_r: Optional[int]) -> int:
    """Comparison-space size for the streaming reduction ratio: all pairs,
    or R × S cross-source pairs in linkage mode.  ``link_stream`` passes
    the left-source count it already tallied at ingest; only a direct
    ``resolve_stream`` over PRE-tagged chunks falls back to re-reading src
    columns from the store (metrics path only)."""
    if not cfg.linkage:
        return total * (total - 1) // 2
    if n_r is None:
        n_r = 0
        if "src" in raw.payload_fields():
            n_r = sum(int((raw.load_field(i, "src") == 0).sum())
                      for i in range(len(raw)))
    return n_r * (total - n_r)


def _resolve_ingested(raw: ChunkStore, max_len: int, total: int,
                      nbytes: int, cfg: ERConfig, *, chunk_size, mesh,
                      axis: str, device, spool_dir,
                      n_lhs: Optional[int] = None, ckpt=None,
                      fault=None) -> StreamResult:
    """The post-ingest half of ``resolve_stream`` (shared with
    ``link_stream``, which builds its own tagged store and passes its
    left-source entity count as ``n_lhs``; the checkpoint path passes
    ``ckpt``/``fault`` through to every pass)."""
    runner = F.make_runner(cfg, mesh=mesh, axis=axis, device=device)
    size = chunk_size if chunk_size is not None else max(max_len, 1)
    if size < 1:
        raise ValueError(f"chunk_size must be >= 1, got {size}")
    total_cmp = _total_stream_comparisons(raw, total, cfg, n_lhs) \
        if cfg.compute_metrics else 0
    if not cfg.passes:
        res, _ = _stream_pass(raw, cfg, None, size, runner, spool_dir,
                              "key", total_cmp, device, ckpt=ckpt,
                              fault=fault)
        return _finalize(res, nbytes, raw.spooled_bytes)
    sub = cfg.with_(passes=())
    results, oracle = [], (set() if cfg.compute_metrics else None)
    for spec in cfg.passes:
        res, orc = _stream_pass(raw, sub, spec, size, runner, spool_dir,
                                spec.name, total_cmp, device, ckpt=ckpt,
                                fault=fault)
        results.append(res)
        if oracle is not None:
            oracle |= orc
    return _finalize(
        _union_stream(tuple(results), cfg,
                      tuple(p.name for p in cfg.passes), oracle, total_cmp),
        nbytes, raw.spooled_bytes)


def _untag_stream(res: StreamResult, offset: int) -> StreamResult:
    """Map a StreamResult (and its passes) from the merged linkage eid
    space back to (lhs_eid, rhs_eid) tuples."""
    blocking = replace(
        res.blocking,
        pairs=frozenset(LK.untag_pairs(res.blocking.pairs, offset)))
    return replace(
        res, blocking=blocking,
        matches=frozenset(LK.untag_pairs(res.matches, offset)),
        passes=tuple(_untag_stream(p, offset) for p in res.passes))


def link_stream(lhs_chunks: Iterable[dict], rhs_chunks: Iterable[dict],
                cfg: ERConfig, *, chunk_size: Optional[int] = None,
                mesh=None, axis: str = "data",
                spool_dir: Optional[str] = None,
                device=None) -> StreamResult:
    """Dual-source (R × S) record linkage over out-of-core streams.

    Both iterables are ingested once, straight into the (spoolable) chunk
    store — lhs first, because its maximum eid fixes the id-space offset
    rhs entities are shifted by, exactly like ``linkage.tag_sources``.
    Pairs come back untagged as (lhs_eid, rhs_eid) in each source's
    original id space.  Everything else matches ``resolve_stream``,
    including the ``cfg.trace`` TraceReport."""
    cfg = cfg.with_(linkage=True)
    device = resolve_device(device)
    return F.owned_trace(
        cfg, "stream", dict(variant=cfg.variant, runner=cfg.runner,
                            linkage=True),
        lambda: _link_stream(lhs_chunks, rhs_chunks, cfg,
                             chunk_size=chunk_size, spool_dir=spool_dir,
                             mesh=mesh, axis=axis, device=device))


def _link_stream(lhs_chunks: Iterable[dict], rhs_chunks: Iterable[dict],
                 cfg: ERConfig, *, chunk_size: Optional[int],
                 spool_dir: Optional[str], mesh, axis: str,
                 device) -> StreamResult:
    """``link_stream`` minus the owner-tracer wrapper (``cfg`` arrives with
    ``linkage`` already set)."""
    store = ChunkStore(spool_dir, prefix="raw")
    max_eid = -1

    def tagger(tag: int, shift: int):
        def transform(h: dict) -> dict:
            nonlocal max_eid
            n = int(h["key"].shape[0])
            shifted = h["eid"].astype(np.int64) + shift
            if int(shifted.max()) >= 2 ** 31:
                # a wrapped int32 eid would sign-extend into the composite
                # merge key's high bits and silently corrupt the global
                # sort order (and untag_pairs' >= offset test)
                raise ValueError(
                    f"rhs eid {int(shifted.max()) - shift} + id-space "
                    f"offset {shift} overflows the int32 eid schema; "
                    f"renumber source eids below 2^31 - offset")
            h = {"key": h["key"], "eid": shifted.astype(np.int32),
                 "valid": h["valid"],
                 "payload": dict(h["payload"],
                                 src=np.full((n,), tag, np.int32))}
            max_eid = max(max_eid, int(h["eid"].max()))
            return h
        return transform

    with OBS.span("ingest"):
        _, len_l, total_l, bytes_l = _ingest(lhs_chunks, spool_dir,
                                             store=store,
                                             transform=tagger(0, 0))
        offset = max_eid + 1
        _, len_r, total_r, bytes_r = _ingest(rhs_chunks, spool_dir,
                                             store=store,
                                             transform=tagger(1, offset))
    res = _resolve_ingested(store, max(len_l, len_r), total_l + total_r,
                            bytes_l + bytes_r, cfg, chunk_size=chunk_size,
                            mesh=mesh, axis=axis, device=device,
                            spool_dir=spool_dir, n_lhs=total_l)
    return _untag_stream(res, offset)
