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

import itertools
import time
from collections.abc import Set as AbstractSet
from dataclasses import dataclass, fields, replace
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


@dataclass
class _PassTally:
    """The accumulators of one streamed pass under the names of its
    checkpoint manifest: the global rank the next chunk starts at, the
    chunk and cache counts, the runner's counters and the ladder's.
    Every resolved chunk folds in through ``add``; ``state()`` is what a
    chunk commits, ``from_state`` what a resumed pass restarts from, and
    the pass's result records are read off it."""
    load_max: np.ndarray      # per shard: the max over chunks
    cand_max: np.ndarray
    rank_offset: int = 0
    chunks: int = 0
    carry_total: int = 0
    degenerate: int = 0
    steady: int = 0
    hits: int = 0
    misses: int = 0
    traces: int = 0
    overflow: int = 0
    cand_overflow: int = 0
    matcher_evals: int = 0
    pair_overflow: int = 0
    pruned: int = 0
    retries: int = 0
    escalations: int = 0
    device_bytes: int = 0     # the max over chunks

    MAXIMA = ("load_max", "cand_max")
    # the runner's counters, added up chunk by chunk
    OUTCOME = ("overflow", "cand_overflow", "matcher_evals",
               "pair_overflow", "pruned")

    @classmethod
    def from_state(cls, state: Optional[dict], r: int) -> "_PassTally":
        """The tally a pass manifest's ``state`` committed, or a fresh one
        for ``r`` shards when nothing was (``state`` None).  Manifests
        written before evidence pruning carry no ``pruned``."""
        t = cls(np.zeros(r, np.int64), np.zeros(r, np.int64))
        if state is None:
            return t
        for f in fields(cls):
            v = state.get(f.name, 0) if f.name == "pruned" \
                else state[f.name]
            if f.name not in cls.MAXIMA:
                setattr(t, f.name, v)
            elif v:        # empty until the first chunk commits
                setattr(t, f.name, np.asarray(v, np.int64))
        return t

    def state(self) -> dict:
        """The checkpoint form: every counter a Python int, each per-shard
        maximum a list of ints."""
        return {f.name: [int(x) for x in getattr(self, f.name)]
                if f.name in self.MAXIMA else int(getattr(self, f.name))
                for f in fields(self)}

    def add(self, po, cache_delta, *, degen: bool, n_nat: int,
            n_carry: int, retries: int, escalations: int,
            nbytes: int) -> None:
        """Fold one resolved chunk: its ``PackedOutcome``, the executable
        cache's (hits, misses, traces) over it, whether its plan
        collapsed, its native and carried rows, the ladder's retries and
        escalations, and the bytes it staged on the device."""
        dh, dm, dt = cache_delta
        self.rank_offset += n_nat
        self.chunks += 1
        self.carry_total += n_carry
        self.degenerate += int(degen)
        self.steady += int(dh > 0 and dm == 0 and dt == 0)
        self.hits += dh
        self.misses += dm
        self.traces += dt
        for f in self.OUTCOME:
            setattr(self, f, getattr(self, f) + getattr(po, f))
        self.retries += retries
        self.escalations += escalations
        self.device_bytes = max(self.device_bytes, nbytes)
        self.load_max = np.maximum(self.load_max,
                                   np.asarray(po.load, np.int64))
        if po.cand_count:
            self.cand_max = np.maximum(self.cand_max,
                                       np.asarray(po.cand_count, np.int64))

    def blocking(self, pairs, cfg: ERConfig, runner) -> BlockingResult:
        return BlockingResult(
            pairs=pairs, load=tuple(int(x) for x in self.load_max),
            variant=cfg.variant, runner=runner.name, window=cfg.window,
            num_shards=runner.shards,
            cand_count=tuple(int(x) for x in self.cand_max),
            **{f: getattr(self, f) for f in self.OUTCOME})

    def stream_stats(self, chunk_size: int, runs: ChunkStore) -> StreamStats:
        # this pass's own spool only (its sorted runs); the shared raw
        # store is stamped ONCE at the top level — summing per-pass stats
        # must not multiply it by the pass count
        return StreamStats(
            chunks=self.chunks, chunk_size=chunk_size,
            entities=self.rank_offset, runs=len(runs),
            carry_entities=self.carry_total,
            degenerate_chunks=self.degenerate, steady_chunks=self.steady,
            cache_hits=self.hits, cache_misses=self.misses,
            traces=self.traces, spooled_bytes=runs.spooled_bytes,
            chunk_device_bytes=self.device_bytes, corpus_bytes=0)

    def resilience(self, run_cfg: ERConfig,
                   auto_caps: bool) -> RZ.ResilienceStats:
        """``run_cfg``: the config of the last chunk's kept execution
        (the ladder's escalated caps are sticky across chunks)."""
        return RZ.ResilienceStats(
            policy=run_cfg.on_overflow, retries=self.retries,
            escalations=self.escalations, cand_cap=run_cfg.cand_cap or 0,
            pair_cap=run_cfg.pair_cap or 0, auto_caps=auto_caps)


def _ingest(chunks: Iterable[dict], store: ChunkStore, *, transform=None,
            ckpt=None) -> Tuple[int, int, int]:
    """Consume the chunk iterator once: strip invalid slots, move to host,
    apply the optional per-chunk ``transform`` (``link_stream``'s source
    tagging) and append each non-empty chunk to ``store``.  Returns
    (max_chunk_rows, total_rows, corpus_bytes).

    With ``ckpt`` the totals start at the checkpoint's committed ones and
    are committed after every append; a resumed run re-supplies the SAME
    deterministic iterator, whose first ``ingest.chunks`` non-empty chunks
    are skipped — they are already durable."""
    skip = max_len = total = nbytes = 0
    if ckpt is not None:
        ing = ckpt.ingest
        skip, max_len = ing["chunks"], ing["max_len"]
        total, nbytes = ing["total"], ing["nbytes"]
    seen = 0
    for ents in chunks:
        h = E.to_host(ents)
        valid = np.asarray(h["valid"], bool)
        if not valid.all():        # all-valid chunks skip the mask copy
            h = E.host_take(h, valid)
        if int(h["key"].shape[0]) == 0:
            continue
        seen += 1
        if seen <= skip:
            continue         # durably committed by the previous run
        if transform is not None:
            h = transform(h)
        max_len = max(max_len, int(h["key"].shape[0]))
        total += int(h["key"].shape[0])
        nbytes += _entity_bytes(h)
        store.append(h)
        if ckpt is not None:
            ckpt.commit_raw(max_len, total, nbytes)
    return max_len, total, nbytes


def _entity_bytes(h: dict) -> int:
    """Total bytes of one host entity dict (key/eid/valid + payload)."""
    return (h["key"].nbytes + h["eid"].nbytes + h["valid"].nbytes
            + sum(v.nbytes for v in h["payload"].values()))


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
        dev = E.from_numpy(h, device)
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
    its pair spool, seam halo, and tally — and a pass whose manifest
    already records progress FAST-FORWARDS: committed chunks are skipped
    in the (deterministic) merged stream, their pairs reloaded from the
    spool, the carry and tally restored.  ``fault`` is the test-only
    ``FaultPlan`` crash injector."""
    with OBS.span("pass", name=label, variant=cfg.variant):
        w_base = cfg.window
        if cfg.window_policy == "adaptive":
            # the facade's adaptive rewrite: the band (and every derived
            # width — seam carry, combined_cap, halo validation) runs at
            # window_max; per-chunk weff comes from the MERGED profile,
            # whose per-key counts are exactly the monolithic corpus's
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
                runs, profile = _sorted_runs(raw, spec, w, spool_dir,
                                             label, device)
        with OBS.span("plan", partitioner=cfg.partitioner, n=profile.n):
            gplan = B.plan_from_profile(profile, cfg.partitioner, r)
            # config-level feasibility is judged ONCE, against the global
            # plan — exactly what the monolithic facade would reject
            B.validate_plan(gplan, cfg, profile.n)

            combined_cap = (w - 1) + chunk_size
            # unset (None) caps resolve from the merged profile's planned
            # loads — floored at the combined chunk width, since a
            # degenerate (collapsed) chunk puts the whole [halo | chunk]
            # window on one shard
            cfg, auto_caps = RZ.autosize_caps(
                cfg, plan=gplan, profile=profile, r=r,
                floor_load=combined_cap)
        cache = PC.executable_cache()
        oracle: Optional[Set[Pair]] = set() if cfg.compute_metrics \
            else None
        state = ckpt.pass_state(label) if ckpt is not None else None
        completed = state["completed_chunks"] if state is not None else 0
        tally = _PassTally.from_state(state if completed else None, r)
        parts = [ckpt.load_pairs(label, i) for i in range(completed)]
        carry: Optional[dict] = ckpt.load_carry(label) if completed \
            else None

        # the ladder's escalated caps are STICKY across chunks: once one
        # chunk forced a doubling, later chunks start at the doubled shape
        # instead of re-climbing the ladder per chunk
        run_cfg = cfg
        # the merge is pulled through ``next`` by hand (rather than a
        # plain ``for``) so the k-way merge's own time lands in ``merge``
        # spans, separate from the ``chunk`` resolve spans it feeds
        merged = iter(rechunk(merged_blocks(runs, chunk_size), chunk_size))
        for ci in itertools.count():
            with OBS.span("merge"):
                native = next(merged, None)
            if native is None:
                break
            if ci < completed:
                continue   # fast-forward: committed by a previous run
            csp = OBS.span("chunk", index=ci)
            with csp:
                n_nat = int(native["key"].shape[0])
                combined = native if carry is None else \
                    E.host_concat([carry, native])
                n_comb = int(combined["key"].shape[0])
                n_carry = n_comb - n_nat
                padded = E.host_pad(combined, combined_cap)
                if cfg.window_policy == "adaptive":
                    # weff rides only the per-chunk PADDED COPY — the
                    # carry (and its checkpointed form) keeps the raw
                    # payload schema, so host_concat sees matching fields
                    # every chunk
                    padded = dict(padded, payload=dict(
                        padded["payload"],
                        _weff=QA.weff_for_keys(np.asarray(padded["key"]),
                                               profile, w_base, w)))
                dev = E.from_numpy(padded, device)
                ranks = np.arange(tally.rank_offset - n_carry,
                                  tally.rank_offset + n_nat, dtype=np.int64)
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
                tally.add(po, cache.stats.delta(before), degen=degen,
                          n_nat=n_nat, n_carry=n_carry, retries=rt,
                          escalations=esc,
                          nbytes=_entity_bytes(padded) + 4 * combined_cap)
                parts.append((po.blocked, po.matched))
                if oracle is not None:
                    oracle |= _chunk_oracle(combined, cfg, profile, w_base)
                keep = min(w - 1, n_comb)
                carry = E.host_take(combined, slice(n_comb - keep, n_comb))
                if ckpt is not None:
                    _commit_chunk(ckpt, fault, label, ci, po, carry, tally)

        # one sort-dedup (``unique_packed``), not ``np.unique``: newer
        # numpy hashes there, 15-22 s on 12.6M pairs (PERF.md)
        dedup = lambda arrs: RES.unique_packed(np.concatenate(arrs)) \
            if arrs else np.empty((0,), RES.PACKED_DTYPE)
        with OBS.span("union", chunks=len(parts)):
            blocked = dedup([b for b, _ in parts])
            matched = dedup([m for _, m in parts])
        blocking = tally.blocking(RES.packed_to_frozenset(blocked), cfg,
                                  runner)
        metrics = None if oracle is None else \
            compute_metrics(blocking.pairs, oracle, total_comparisons)
        if ckpt is not None:
            ckpt.mark_pass_done(label)
        return StreamResult(
            blocking=blocking, matches=RES.packed_to_frozenset(matched),
            stream=tally.stream_stats(chunk_size, runs), metrics=metrics,
            resilience=tally.resilience(run_cfg, auto_caps)), oracle


def _chunk_oracle(combined: dict, cfg: ERConfig, profile,
                  w_base: int) -> Set[Pair]:
    """The FULL sequential-SN oracle of one combined [carry | chunk] slice.
    Each slice is contiguous in the global order, so chunk oracles union
    to the global one — deliberately NOT the variant-faithful set: the
    metric must EXPOSE SRP's missed boundary pairs, not absolve them."""
    if cfg.window_policy == "adaptive":
        cw = QA.weff_for_keys(np.asarray(combined["key"]), profile, w_base,
                              cfg.window)
        pairs = sn.adaptive_sn_pairs(combined["key"], combined["eid"], cw)
    else:
        pairs = sn.sequential_sn_pairs(combined["key"], combined["eid"],
                                       cfg.window)
    if cfg.linkage and "src" in combined["payload"]:
        pairs = LK.filter_cross_source(pairs, combined["eid"],
                                       combined["payload"]["src"])
    return pairs


def _commit_chunk(ckpt, fault, label: str, ci: int, po, carry: dict,
                  tally: _PassTally) -> None:
    """Commit resolved chunk ``ci`` (checkpoint module doc): its pair
    spool, then the seam halo and the tally in the manifest — the
    manifest write is the commit point."""
    t0 = time.perf_counter()
    sp = OBS.span("checkpoint_commit", chunk=ci)
    with sp:
        ckpt.spool_chunk(label, ci, po.blocked, po.matched)
        if fault is not None:
            fault.before_commit(label, ci)
        ckpt.commit_chunk(label, carry, **tally.state())
    if sp.enabled:
        OBS.current_tracer().metrics.histogram(
            "checkpoint_commit_ms").observe(
                1e3 * (time.perf_counter() - t0))
    if fault is not None:
        fault.after_commit(label, ci)


def _union_stream(results: Tuple[StreamResult, ...], cfg: ERConfig,
                  names: Tuple[str, ...], oracle: Optional[Set[Pair]],
                  total_comparisons: int) -> StreamResult:
    """Union per-pass StreamResults: pairs, accounting and resilience
    through the facade's multi-pass union (``facade.union_passes``) +
    additive streaming telemetry."""
    blocking, matches, resilience = F.union_passes(results, cfg)
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
    return StreamResult(
        blocking=blocking, matches=matches, stream=stats, metrics=metrics,
        passes=results, pass_names=names, resilience=resilience)


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
    raw = ChunkStore(spool_dir, prefix="raw")
    with OBS.span("ingest"):
        max_len, total, nbytes = _ingest(chunks, raw)
    return _resolve_ingested(raw, max_len, total, nbytes, cfg,
                             chunk_size=chunk_size, mesh=mesh, axis=axis,
                             device=device, spool_dir=spool_dir)


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
            _ingest(chunks, raw, ckpt=ckpt)
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
        len_l, total_l, bytes_l = _ingest(lhs_chunks, store,
                                          transform=tagger(0, 0))
        offset = max_eid + 1
        len_r, total_r, bytes_r = _ingest(rhs_chunks, store,
                                          transform=tagger(1, offset))
    res = _resolve_ingested(store, max(len_l, len_r), total_l + total_r,
                            bytes_l + bytes_r, cfg, chunk_size=chunk_size,
                            mesh=mesh, axis=axis, device=device,
                            spool_dir=spool_dir, n_lhs=total_l)
    return F.untag(res, offset)
