"""Micro-batched serving layer: ``ResolutionService`` (port of
``repro.serve.service``).

The front end of the online subsystem: callers submit entity inserts and
deletes; a worker thread coalesces adjacent same-kind requests into
micro-batches (up to ``max_batch`` entities or ``max_wait_ms``), drives the
``DeltaMatcher`` once per batch, and resolves every request's future with
the batch's ``IncrementalResult``.  Delta calls ride a shape-bucket grid
and run on the service's ``device`` (the CUDA card unless ``"cpu"`` is
passed), from the worker thread (or the watchdog's batch thread); each
thread that runs a batch activates the service's tracer.  Because every
delta call rides the shape-bucket grid, a steady request stream hits the
``repro_torch.perf`` executable cache (on the card, CUDA graph replays):
``ServeStats.steady_batches`` counts those batches, the analogue of the
stream's ``steady_chunks``.

The service maintains the CURRENT pair sets (not a monotone union): the
**served** sets are exactly what a from-scratch ``api.resolve`` of the
live corpus under the same config would produce — for boundary-complete
variants (repsn, jobsn) the maintained complete sets themselves; for SRP,
complete minus the pairs straddling the profile-planned partition bounds
(``delta.srp_straddle_packed``).  That equality holds after ANY
interleaving of inserts and deletes.

Ordering semantics: requests apply in submission order; only ADJACENT
same-kind requests coalesce, so a delete never leapfrogs the insert before
it.  All requests in one micro-batch share the batch's result (``batched``
reports the coalescing width).  Pair ids are stable for the service's
lifetime: a pair that is retired and later re-created keeps its id.

Under load the service absorbs pressure instead of collapsing (DESIGN.md
§13): an ``AdmissionConfig`` picks the queue policy (block / reject /
shed_oldest) and per-request deadlines, a watermark controller browns the
delta path out to the degraded (zero-device-call) matcher when the queue
or p95 latency crosses its high watermark, and the dirty composite ranges
the brownout touched are re-resolved exactly by the ``repair`` pass once
pressure drops — eventually-exact (invariant 13).  A ``ChaosPlan`` from
``repro_torch.resilience`` injects latency/stall/error disturbances at
exact batch indices for the overload property tests.
"""
from __future__ import annotations

import contextlib
import json
import os
import queue
import threading
import time
from collections.abc import Set as AbstractSet
from concurrent.futures import Future, InvalidStateError
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from repro_torch import obs as OBS
from repro_torch.api import results as RES
from repro_torch.api.variants import get_variant
from repro_torch.core import entities as E
from repro_torch.device import resolve_device
from repro_torch.perf import cache as PC
from repro_torch.resilience.faults import InjectedFault
from repro_torch.serve import admission as ADM
from repro_torch.serve.delta import DeltaMatcher, srp_straddle_packed
from repro_torch.serve.index import SortedIndex
from repro_torch.stream.store import atomic_savez, atomic_write_json, \
    host_column

_SERVICE_MANIFEST = "SERVICE.json"

Pair = Tuple[int, int]
_EMPTY = np.empty((0,), RES.PACKED_DTYPE)
_STOP = object()


class ServeStats(NamedTuple):
    """Service telemetry snapshot (rides on every ``IncrementalResult``).

    ``steady_batches`` counts micro-batches served ENTIRELY from the
    executable cache (hits, zero builds/traces); it and the three cache
    counters come from the ``repro_torch.perf`` executable cache.
    ``shapes`` lists the distinct (num_shards, shard_cap) delta-call
    buckets seen.  ``batch_fill`` is the mean coalesced batch size
    over ``max_batch``; ``p50_ms``/``p95_ms`` are submit-to-result
    latencies over a sliding window.  ``failure`` is None while the
    service is healthy; after an unexpected worker error it carries that
    error's repr (the service refuses further submissions — DESIGN.md
    §11).

    The overload block (DESIGN.md §13): ``shed``/``rejected``/``expired``
    count futures failed by admission policy (shed_oldest eviction,
    reject-at-submit, deadline expiry at batch formation);
    ``degraded_batches`` counts batches applied through the brownout
    path, ``repairs`` the repair passes that re-resolved them exactly,
    ``dirty_ranges`` the composite ranges still awaiting repair
    (``repair()`` drives this to 0); ``brownout`` is the watermark
    controller's current state and ``health`` the derived
    ``ok | degraded | overloaded | failed`` summary."""
    requests: int
    batches: int
    steady_batches: int
    queue_depth: int
    batch_fill: float
    cache_hits: int
    cache_misses: int
    traces: int
    device_calls: int
    p50_ms: float
    p95_ms: float
    live_entities: int
    index_runs: int
    index_rows: int
    tombstones: int
    compactions: int
    pairs: int
    matches: int
    shapes: Tuple[Tuple[int, int], ...]
    failure: Optional[str] = None
    shed: int = 0
    rejected: int = 0
    expired: int = 0
    degraded_batches: int = 0
    repairs: int = 0
    dirty_ranges: int = 0
    brownout: bool = False
    health: str = "ok"


class IncrementalResult(NamedTuple):
    """Outcome of one request (shared by its whole micro-batch).

    ``new_pairs``/``retired_pairs`` are the SERVED blocked-set edits this
    batch caused (both directions are real: an insert can retire old
    pairs, a delete can create them); ``*_matches`` the matched-set edits.
    ``pair_ids`` maps each NEW pair to its stable service-wide id.
    ``degraded=True`` marks a batch applied through the brownout path:
    its blocked edits are exact, but new matches are deferred until the
    ``repair`` pass re-resolves the touched ranges (DESIGN.md §13)."""
    new_pairs: AbstractSet[Pair]
    retired_pairs: AbstractSet[Pair]
    new_matches: AbstractSet[Pair]
    retired_matches: AbstractSet[Pair]
    pair_ids: Dict[Pair, int]
    batched: int
    stats: ServeStats
    degraded: bool = False


def _host_request(ents) -> dict:
    """An insert's entities as a host dict in the port's dtypes: tensors
    copied to the host, the reference's uint32 signature words viewed as
    int32 (so requests of either form coalesce into one batch)."""
    h = ents if isinstance(ents.get("key"), np.ndarray) else E.to_host(ents)
    return dict(h, payload={k: host_column(k, np.asarray(v))
                            for k, v in h["payload"].items()})


class _Request:
    __slots__ = ("kind", "data", "n", "future", "t0", "deadline")

    def __init__(self, kind: str, data, n: int,
                 deadline_ms: Optional[float] = None):
        self.kind = kind
        self.data = data
        self.n = n
        self.future: "Future[IncrementalResult]" = Future()
        self.t0 = time.perf_counter()
        # absolute monotonic expiry; None = wait forever (legacy)
        self.deadline = None if deadline_ms is None \
            else time.monotonic() + deadline_ms * 1e-3


class ResolutionService:
    """Online incremental entity resolution over one persistent corpus.

        svc = ResolutionService(cfg, initial=base_corpus)
        res = svc.resolve_incremental(new_ents)   # sync insert
        res.new_pairs, res.retired_pairs
        svc.delete([17, 42])                      # sync delete by eid
        svc.pairs                                 # currently served set

    ``submit_insert``/``submit_delete`` are the async forms (futures);
    the sync forms go through the same queue, so concurrent callers
    coalesce.  ``start=False`` skips the worker thread and processes
    every request inline (single-caller tests/benchmarks).

    ``admission`` (an ``AdmissionConfig``) sets the overload policy:
    queue policy, default deadline, brownout watermarks, stuck-batch
    watchdog — all service-level, none change what a correct resolve
    produces (invariant 13).  ``chaos`` (a ``resilience.ChaosPlan``)
    injects deterministic latency/stall/error disturbances at exact
    batch indices — the overload test harness, never set in production.

    The config must be single-pass, non-linkage, without
    ``return_scores``; the service always executes delta calls on the
    vmap runner, and SRP straddle correction uses ``cfg.num_shards`` —
    served sets match a from-scratch vmap ``resolve`` under ``cfg``.
    ``device``: where the delta calls run (None = the CUDA card, raising
    without one; "cpu" runs on the CPU).
    """

    def __init__(self, cfg, *, initial=None, max_batch: int = 512,
                 max_wait_ms: float = 2.0, queue_cap: int = 1024,
                 spool_dir: Optional[str] = None, start: bool = True,
                 segment_rows: int = 4096, max_runs: int = 12,
                 max_tombstone_frac: float = 0.25,
                 shard_buckets=(2, 4, 8), cap_floor: int = 64,
                 admission: Optional[ADM.AdmissionConfig] = None,
                 chaos=None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._boundary_complete = get_variant(cfg.variant).boundary_complete
        self._shard_buckets = shard_buckets     # kept for restore()
        self._cap_floor = cap_floor
        self.index = SortedIndex(cfg.window, spool_dir=spool_dir,
                                 segment_rows=segment_rows,
                                 max_runs=max_runs,
                                 max_tombstone_frac=max_tombstone_frac)
        self._delta = DeltaMatcher(cfg, self.index,
                                   shard_buckets=shard_buckets,
                                   cap_floor=cap_floor, device=self.device)
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)
        self._blocked = _EMPTY      # maintained COMPLETE sets
        self._matched = _EMPTY
        self._served_b = _EMPTY     # derived SERVED sets (post-straddle)
        self._served_m = _EMPTY
        self._pair_ids: Dict[int, int] = {}     # packed pair -> stable id
        self._lock = threading.Lock()
        # submit-to-result latencies (seconds) over a bounded sliding
        # window — the obs ring buffer keeps the historical deque's
        # percentile semantics bit-for-bit (DESIGN.md §12)
        self._latency = OBS.Histogram("latency_s", 2048)
        # per-batch spans accumulate here when the config asks for
        # tracing; the service owns its tracer for its whole lifetime
        # (batches arrive forever — there is no single "run" to scope it)
        self._tracer = OBS.Tracer() if getattr(cfg, "trace", False) \
            else None
        if self._tracer is not None:
            # batches whose publish diffed the whole served sets (srp
            # only); registered up front so that boundary-complete
            # variants read 0
            self._tracer.metrics.counter("publish_full_diffs")
        self._requests = 0
        self._batches = 0
        self._dispatched = 0
        self._steady = 0
        self._fill = 0.0
        self._hits = self._misses = self._traces = 0
        self._device_calls = 0
        self._shapes: set = set()
        self._adm = admission if admission is not None \
            else ADM.AdmissionConfig()
        self._chaos = chaos
        self._watermark = ADM.WatermarkController(self._adm, queue_cap)
        self._brownout = False
        self._dirty: List[Tuple[int, int]] = []   # merged (c_lo, c_hi)
        self._shed = self._rejected = self._expired = 0
        self._degraded_batches = self._repairs = 0
        self._q: "queue.Queue" = queue.Queue(maxsize=queue_cap)
        self._worker: Optional[threading.Thread] = None
        self._closed = False
        self._failure: Optional[BaseException] = None
        if start:
            self._worker = threading.Thread(target=self._run,
                                            name="resolution-serve",
                                            daemon=True)
            self._worker.start()
        if initial is not None:
            self.resolve_incremental(initial)

    # -- submission ----------------------------------------------------------

    def submit_insert(self, ents, *, deadline_ms: Optional[float] = None
                      ) -> "Future[IncrementalResult]":
        """Enqueue an insert of NEW entities (device or host entity dict;
        invalid rows are dropped, live-eid collisions raise).  Under the
        default ``queue_policy="block"`` a full queue blocks for
        backpressure (failing fast if the worker dies meanwhile); see
        ``AdmissionConfig`` for the reject/shed policies.  ``deadline_ms``
        bounds this request's QUEUE WAIT (falls back to the admission
        config's ``default_deadline_ms``): an expired request fails with
        ``DeadlineExceededError`` at batch-formation time."""
        h = _host_request(ents)
        return self._submit(_Request("insert", h, int(h["key"].shape[0]),
                                     self._deadline(deadline_ms)))

    def submit_delete(self, eids, *, deadline_ms: Optional[float] = None
                      ) -> "Future[IncrementalResult]":
        """Enqueue a delete of live entities by eid (unknown or already-
        deleted eids fail the whole request).  ``deadline_ms`` as in
        ``submit_insert``."""
        arr = np.asarray(eids, np.int64).reshape(-1)
        return self._submit(_Request("delete", arr, int(arr.shape[0]),
                                     self._deadline(deadline_ms)))

    def resolve_incremental(self, ents) -> IncrementalResult:
        """Synchronous insert: submit and wait for the batch result."""
        return self.submit_insert(ents).result()

    def delete(self, eids) -> IncrementalResult:
        """Synchronous delete: submit and wait for the batch result."""
        return self.submit_delete(eids).result()

    def _deadline(self, deadline_ms: Optional[float]) -> Optional[float]:
        return self._adm.default_deadline_ms if deadline_ms is None \
            else deadline_ms

    def _check_open(self) -> None:
        if self._failure is not None:
            raise RuntimeError(
                "service failed and no longer accepts requests"
            ) from self._failure
        if self._closed:
            raise RuntimeError("service is closed")

    def _submit(self, req: _Request) -> "Future[IncrementalResult]":
        self._check_open()
        if self._worker is None:
            self._dispatch(self._drop_expired([req]))
            return req.future
        policy = self._adm.queue_policy
        if policy == "reject":
            try:
                self._q.put_nowait(req)
            except queue.Full:
                self._rejected += 1
                if self._tracer is not None:
                    self._tracer.metrics.counter("rejected").inc()
                raise ADM.OverloadError(
                    f"queue full ({self._q.maxsize} deep) under "
                    f"queue_policy='reject'") from None
        elif policy == "shed_oldest":
            while True:
                try:
                    self._q.put_nowait(req)
                    break
                except queue.Full:
                    pass
                self._check_open()
                try:
                    old = self._q.get_nowait()
                except queue.Empty:
                    continue
                if old is _STOP:
                    # the service is closing under us: put the sentinel
                    # back and refuse the new request
                    try:
                        self._q.put_nowait(old)
                    except queue.Full:
                        pass
                    raise RuntimeError("service is closed")
                self._shed += 1
                if self._tracer is not None:
                    self._tracer.metrics.counter("shed").inc()
                self._settle(old.future, exc=ADM.OverloadError(
                    "shed: evicted by a newer request under "
                    "queue_policy='shed_oldest'"))
        else:   # "block" — legacy backpressure, but never block into a
            # dead service: re-check failed/closed between bounded put
            # attempts so a worker failure releases every waiting
            # submitter with the ORIGINAL error
            while True:
                try:
                    self._q.put(req, timeout=0.05)
                    break
                except queue.Full:
                    self._check_open()
        if self._failure is not None:
            # the worker died while we waited (its queue drain is what
            # freed our slot) — nothing will ever consume this request,
            # so fail it here rather than let the future dangle
            try:
                self._check_open()
            except RuntimeError as exc:
                self._settle(req.future, exc=exc)
                raise
        return req.future

    # -- worker --------------------------------------------------------------

    def _run(self) -> None:
        pending: Optional[_Request] = None
        running = True
        while running:
            req = pending if pending is not None else self._next_request()
            pending = None
            if req is _STOP:
                break
            group = [req]
            n = req.n
            deadline = time.monotonic() + self.max_wait_ms * 1e-3
            while n < self.max_batch:
                wait = deadline - time.monotonic()
                if wait <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=wait)
                except queue.Empty:
                    break
                if nxt is _STOP:
                    running = False
                    break
                if nxt.kind != req.kind:
                    # a kind change closes the batch: submission order is
                    # preserved exactly
                    pending = nxt
                    break
                group.append(nxt)
                n += nxt.n
            self._dispatch(self._drop_expired(group))
            if self._failure is not None:
                running = False        # dead worker: stop consuming
        if pending is not None and pending is not _STOP:
            if self._failure is not None:
                self._settle(pending.future, exc=self._failure)
            else:
                self._dispatch(self._drop_expired([pending]))
        # anything still queued raced the shutdown (enqueued after the
        # stop sentinel or after a failure drain): fail it on the way out
        # so no future can dangle behind the worker's exit
        self._fail_queued(self._failure if self._failure is not None
                          else RuntimeError("service is closed"))

    def _next_request(self):
        """Blocking queue get, interleaving the background repair pass:
        when the queue drains while repair debt is outstanding, pressure
        is gone by definition — release the brownout through the
        watermark (depth 0; latency is NOT consulted, its sliding window
        decays too slowly to gate recovery) and re-resolve the dirty
        ranges exactly before going back to sleep."""
        while True:
            try:
                if not self._dirty:
                    return self._q.get()
                return self._q.get(timeout=0.02)
            except queue.Empty:
                self._brownout = self._watermark.update(0, 0.0)
                if not self._brownout:
                    self.repair()

    def _drop_expired(self, group) -> list:
        """Batch-formation deadline check: fail every expired request
        with ``DeadlineExceededError`` BEFORE any work is spent on it and
        return the survivors.  A request that makes it into the returned
        group runs to completion — deadlines bound queue wait, not
        compute."""
        now = time.monotonic()
        alive = []
        for r in group:
            if r.deadline is not None and now > r.deadline:
                self._expired += 1
                if self._tracer is not None:
                    self._tracer.metrics.counter("expired").inc()
                self._settle(r.future, exc=ADM.DeadlineExceededError(
                    f"deadline passed after "
                    f"{1e3 * (time.perf_counter() - r.t0):.1f}ms in the "
                    f"queue, before the request entered a batch"))
            else:
                alive.append(r)
        return alive

    def _dispatch(self, group) -> None:
        """Run one batch, under the stuck-batch watchdog when
        ``batch_timeout_s`` is set (the zero-overhead inline path is kept
        when it is not).  On expiry the batch fails with
        ``BatchTimeoutError`` instead of hanging the worker — and the
        service fails with it: the abandoned batch thread may still
        mutate state, so the parity invariant can no longer be
        guaranteed (DESIGN.md §13)."""
        if not group:
            return
        timeout = self._adm.batch_timeout_s
        if timeout is None:
            self._process(group)
            return
        done = threading.Event()

        def run() -> None:
            try:
                self._process(group)
            finally:
                done.set()

        t = threading.Thread(target=run, name="resolution-batch",
                             daemon=True)
        t.start()
        if not done.wait(timeout):
            self._fail(ADM.BatchTimeoutError(
                f"batch of {len(group)} request(s) exceeded "
                f"batch_timeout_s={timeout}"), group)

    @staticmethod
    def _settle(fut: "Future", exc: Optional[BaseException] = None,
                result=None) -> None:
        """Resolve a future exactly once: a watchdog-failed batch and its
        zombie thread may both reach the same future — whoever is second
        must be a no-op, not an InvalidStateError."""
        try:
            if exc is not None:
                fut.set_exception(exc)
            else:
                fut.set_result(result)
        except InvalidStateError:
            pass

    def _process(self, group) -> None:
        try:
            result = self._apply_batch(group)
        except (ValueError, InjectedFault) as exc:
            # request-level rejection: bad input (eid collisions, unknown
            # deletes, ...) or a chaos-injected matcher error — both are
            # raised BEFORE any state mutation, so the batch's callers
            # get the error and the service keeps serving
            for r in group:
                self._settle(r.future, exc=exc)
        except BaseException as exc:  # noqa: BLE001 — service-level failure
            # anything else means the worker can no longer guarantee its
            # parity invariant: mark the service failed (never die
            # silently), fail this batch AND everything still queued with
            # the ORIGINAL error, and refuse new submissions
            self._fail(exc, group)
        else:
            for r in group:
                self._settle(r.future, result=result)

    def _fail(self, exc: BaseException, group) -> None:
        self._failure = exc
        self._closed = True
        for r in group:
            self._settle(r.future, exc=exc)
        self._fail_queued(exc)   # queued requests must not hang forever

    def _fail_queued(self, exc: BaseException) -> None:
        """Empty the queue, failing every waiting request's future with
        ``exc`` (a stop sentinel in it is dropped)."""
        while True:
            try:
                nxt = self._q.get_nowait()
            except queue.Empty:
                return
            if nxt is not _STOP:
                self._settle(nxt.future, exc=exc)

    def _apply_batch(self, group) -> IncrementalResult:
        if self._tracer is None:
            return self._apply_batch_inner(group)
        t0 = time.perf_counter()
        for r in group:
            self._tracer.metrics.histogram("admission_ms").observe(
                1e3 * (t0 - r.t0))      # queue wait per admitted request
        with OBS.activate(self._tracer), OBS.span(
                "batch", kind=group[0].kind, requests=len(group),
                entities=sum(r.n for r in group)):
            result = self._apply_batch_inner(group)
        self._tracer.metrics.histogram("batch_ms").observe(
            1e3 * (time.perf_counter() - t0))
        return result

    def _apply_batch_inner(self, group) -> IncrementalResult:
        kind = group[0].kind
        # chaos + brownout decisions happen OUTSIDE the lock: an injected
        # stall must not hold stats() hostage, and an injected error must
        # fire before any state mutation (request-level by construction)
        # chaos indexes DISPATCHED batches, not completed ones: an
        # injected error must consume its slot, or it would re-fire on
        # every retry forever (``_batches`` only counts completions)
        idx = self._dispatched
        self._dispatched += 1
        if self._chaos is not None:
            self._chaos.on_batch(idx)
        p95 = 0.0 if self._adm.brownout_p95_ms is None \
            else 1e3 * self._latency.percentile(0.95)
        self._brownout = self._watermark.update(self._q.qsize(), p95)
        degraded = self._brownout
        if self._tracer is not None:
            self._tracer.metrics.gauge("brownout").set(
                1.0 if degraded else 0.0)
        # ``publish``: the served sets, the pair ids and the public sets,
        # from inside the lock to the result built outside it
        with contextlib.ExitStack() as publish:
            with self._lock:
                cache = PC.executable_cache()
                before = cache.stats.snapshot()
                if kind == "insert":
                    h = group[0].data if len(group) == 1 else \
                        E.host_concat([r.data for r in group])
                    dev = E.from_numpy(h, self.device)
                    nb, nm, dstats = self._delta.insert(dev, self._blocked,
                                                        self._matched,
                                                        degraded=degraded)
                else:
                    eids = np.concatenate([r.data for r in group])
                    nb, nm, dstats = self._delta.delete(eids, self._blocked,
                                                        self._matched,
                                                        degraded=degraded)
                self._blocked, self._matched = nb, nm
                if dstats.degraded:
                    self._degraded_batches += 1
                    self._record_dirty(dstats.comp_ranges)
                    if self._tracer is not None:
                        self._tracer.metrics.counter("degraded_batches").inc()
                dh, dm, dt = cache.stats.delta(before)
                self._hits += dh
                self._misses += dm
                self._traces += dt
                self._steady += int(dstats.device_calls > 0
                                    and dh > 0 and dm == 0 and dt == 0)
                self._batches += 1
                self._requests += len(group)
                self._fill += min(1.0, sum(r.n for r in group)
                                  / max(self.max_batch, 1))
                self._device_calls += dstats.device_calls
                self._shapes.update(dstats.shapes)
                self.index.maybe_compact()

                publish.enter_context(OBS.span(
                    "publish", full_diff=not self._boundary_complete))
                old_sb, old_sm = self._served_b, self._served_m
                self._served_b, self._served_m = self._served_sets(nb, nm)
                if self._boundary_complete:
                    # served = maintained before and after the batch, so
                    # the batch's edit is the served edit: what it removed
                    # left the set, and what it added joined it unless
                    # it was there already
                    new_p = RES.setdiff_sorted(dstats.added_blocked, old_sb)
                    gone_p = dstats.removed_blocked
                    new_m = RES.setdiff_sorted(dstats.added_matched, old_sm)
                    gone_m = dstats.removed_matched
                else:
                    # the straddle filter moves pairs the batch never
                    # touched: diff the whole served sets
                    new_p = RES.setdiff_sorted(self._served_b, old_sb)
                    gone_p = RES.setdiff_sorted(old_sb, self._served_b)
                    new_m = RES.setdiff_sorted(self._served_m, old_sm)
                    gone_m = RES.setdiff_sorted(old_sm, self._served_m)
                    if self._tracer is not None:
                        self._tracer.metrics.counter(
                            "publish_full_diffs").inc()
                ids = {}
                for packed in new_p.tolist():
                    pid = self._pair_ids.get(packed)
                    if pid is None:
                        pid = len(self._pair_ids)
                        self._pair_ids[packed] = pid
                    ids[(packed >> 32, packed & 0xFFFFFFFF)] = pid
                now = time.perf_counter()
                for r in group:
                    self._latency.observe(now - r.t0)
                stats = self._stats_locked()
            return IncrementalResult(
                new_pairs=RES.packed_to_frozenset(new_p),
                retired_pairs=RES.packed_to_frozenset(gone_p),
                new_matches=RES.packed_to_frozenset(new_m),
                retired_matches=RES.packed_to_frozenset(gone_m),
                pair_ids=ids, batched=len(group), stats=stats,
                degraded=dstats.degraded)

    def _served_sets(self, nb: np.ndarray, nm: np.ndarray):
        """The served (blocked, matched) sets derived from maintained
        complete sets ``nb``/``nm`` under the current index: the maintained
        sets themselves for boundary-complete variants, and for SRP the
        complete sets minus the pairs that straddle a partition."""
        if self._boundary_complete:
            return nb, nm
        straddle = srp_straddle_packed(self.index, self.cfg)
        return (RES.setdiff_sorted(nb, straddle),
                RES.setdiff_sorted(nm, straddle))

    # -- brownout repair -----------------------------------------------------

    def _record_dirty(self, ranges) -> None:
        """Fold the composite ranges a degraded batch touched into the
        merged dirty list (sorted, overlaps coalesced).  Composites are
        immutable per entity, so the ranges stay valid repair anchors no
        matter what mutates in between (DESIGN.md §13)."""
        merged = sorted(self._dirty
                        + [(int(a), int(b)) for a, b in ranges])
        out: List[Tuple[int, int]] = []
        for lo, hi in merged:
            if out and lo <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], hi))
            else:
                out.append((lo, hi))
        self._dirty = out

    def repair(self) -> int:
        """Re-resolve every dirty composite range EXACTLY (full device
        path, real matcher) and fold the results into the maintained and
        served sets — after this returns, the served sets are
        bit-identical to a from-scratch ``resolve`` of the live corpus
        (invariant 13, the eventually-exact half).  Returns the number of
        ranges repaired (0 = nothing was dirty).

        The worker runs this automatically whenever the queue drains
        while repair debt is outstanding; ``start=False`` services (and
        tests that want deterministic timing) call it directly."""
        with self._lock:
            return self._repair_locked()

    def _repair_locked(self) -> int:
        if not self._dirty:
            return 0
        ranges, self._dirty = self._dirty, []
        cache = PC.executable_cache()
        before = cache.stats.snapshot()
        nb, nm, dstats = self._delta.refresh(ranges, self._blocked,
                                             self._matched)
        self._blocked, self._matched = nb, nm
        dh, dm, dt = cache.stats.delta(before)
        self._hits += dh
        self._misses += dm
        self._traces += dt
        self._device_calls += dstats.device_calls
        self._shapes.update(dstats.shapes)
        self._repairs += 1
        if self._tracer is not None:
            self._tracer.metrics.counter("repairs").inc()
        self._served_b, self._served_m = self._served_sets(nb, nm)
        # the blocked set never degrades, so repair cannot mint pairs the
        # id table has not seen — guard anyway so ids stay total
        for packed in dstats.added_blocked.tolist():
            self._pair_ids.setdefault(packed, len(self._pair_ids))
        return len(ranges)

    # -- state ---------------------------------------------------------------

    @property
    def packed_pairs(self) -> np.ndarray:
        """Currently served blocked set, packed (sorted unique uint64)."""
        with self._lock:
            return self._served_b

    @property
    def packed_matches(self) -> np.ndarray:
        """Currently served matched set, packed."""
        with self._lock:
            return self._served_m

    @property
    def pairs(self) -> AbstractSet[Pair]:
        """Currently served blocked set as (lo, hi) eid tuples (over a copy
        of ``packed_pairs``, which its callers may write)."""
        return RES.packed_to_frozenset(self.packed_pairs.copy())

    @property
    def matches(self) -> AbstractSet[Pair]:
        """Currently served matched set as (lo, hi) eid tuples (over a copy
        of ``packed_matches``)."""
        return RES.packed_to_frozenset(self.packed_matches.copy())

    def pair_id(self, pair: Pair) -> int:
        """Stable id of a pair the service has served at any point."""
        return self._pair_ids[(int(pair[0]) << 32) | int(pair[1])]

    def _stats_locked(self) -> ServeStats:
        pct = lambda p: 1e3 * self._latency.percentile(p)
        depth = self._q.qsize()
        cap = self._q.maxsize
        return ServeStats(
            requests=self._requests, batches=self._batches,
            steady_batches=self._steady,
            queue_depth=depth,
            batch_fill=self._fill / max(self._batches, 1),
            cache_hits=self._hits, cache_misses=self._misses,
            traces=self._traces, device_calls=self._device_calls,
            p50_ms=pct(0.50), p95_ms=pct(0.95),
            live_entities=self.index.n_live,
            index_runs=self.index.n_runs, index_rows=self.index.n_rows,
            tombstones=self.index.tombstones,
            compactions=self.index.compactions,
            pairs=int(self._served_b.shape[0]),
            matches=int(self._served_m.shape[0]),
            shapes=tuple(sorted(self._shapes)),
            failure=None if self._failure is None else repr(self._failure),
            shed=self._shed, rejected=self._rejected,
            expired=self._expired,
            degraded_batches=self._degraded_batches,
            repairs=self._repairs, dirty_ranges=len(self._dirty),
            brownout=self._brownout,
            health=ADM.derive_health(
                failure=self._failure is not None,
                brownout=self._brownout,
                dirty_ranges=len(self._dirty),
                depth_frac=depth / cap if cap > 0 else 0.0,
                high=self._adm.brownout_high))

    def stats(self) -> ServeStats:
        """Current telemetry snapshot."""
        with self._lock:
            return self._stats_locked()

    def trace_report(self) -> Optional["OBS.TraceReport"]:
        """A ``repro_torch.obs.TraceReport`` over every micro-batch served
        so far (one ``batch`` span per batch, the bounded ``batch_ms``
        latency histogram, and the current ``ServeStats`` behind the
        unified schema).  Requires the service config to carry
        ``trace=True``; returns None otherwise.  Can be called repeatedly
        — each call snapshots the tracer's current state."""
        if self._tracer is None:
            return None
        with self._lock:
            return OBS.TraceReport.from_tracer(self._tracer,
                                               (self._stats_locked(),))

    # -- durability ----------------------------------------------------------

    def snapshot(self, snapshot_dir: str) -> None:
        """Persist the full serving state to ``snapshot_dir`` (DESIGN.md
        §11): the live index segments (``SortedIndex.snapshot``), the
        maintained + served packed pair sets, the stable pair-id table,
        and a manifest carrying the config fingerprint.  All writes are
        atomic with the manifest last; a restored service serves the
        IDENTICAL pair set and continues under the same ids.  Outstanding
        brownout repair debt is drained FIRST — a snapshot is always
        exact, so restore never needs to know about dirty ranges."""
        with self._lock:
            self._repair_locked()
            self.index.snapshot(snapshot_dir)
            packed = np.fromiter(self._pair_ids.keys(), np.uint64,
                                 len(self._pair_ids))
            ids = np.fromiter(self._pair_ids.values(), np.int64,
                              len(self._pair_ids))
            atomic_savez(os.path.join(snapshot_dir, "pairs.npz"),
                         blocked=self._blocked, matched=self._matched,
                         served_b=self._served_b, served_m=self._served_m,
                         pair_packed=packed, pair_id=ids)
            atomic_write_json(
                os.path.join(snapshot_dir, _SERVICE_MANIFEST),
                {"version": 1,
                 "fingerprint": repr(self.cfg.static_fingerprint()),
                 "num_shards": self.cfg.num_shards})

    @classmethod
    def restore(cls, snapshot_dir: str, cfg,
                **kwargs) -> "ResolutionService":
        """Rebuild a service from a ``snapshot`` directory.  ``cfg`` must
        be the original config (validated against the stored fingerprint —
        the served set depends on it); remaining kwargs configure the new
        service exactly like the constructor.  The restored service serves
        the same pairs/matches under the same stable pair ids, and further
        mutations stay in parity with an uninterrupted service."""
        mpath = os.path.join(snapshot_dir, _SERVICE_MANIFEST)
        if not os.path.exists(mpath):
            raise FileNotFoundError(
                f"no service snapshot manifest at {mpath!r}")
        with open(mpath) as f:
            manifest = json.load(f)
        fp = repr(cfg.static_fingerprint())
        if fp != manifest["fingerprint"] \
                or cfg.num_shards != manifest["num_shards"]:
            raise ValueError(
                f"config does not match the snapshot at {snapshot_dir!r} "
                f"(the served pair set depends on it); restore with the "
                f"original configuration")
        svc = cls(cfg, **kwargs)
        with svc._lock:
            old = svc.index
            svc.index = SortedIndex.restore(
                snapshot_dir, spool_dir=old.spool_dir,
                max_runs=old.max_runs,
                max_tombstone_frac=old.max_tombstone_frac,
                merge_block=old.merge_block)
            svc._delta = DeltaMatcher(cfg, svc.index,
                                      shard_buckets=svc._shard_buckets,
                                      cap_floor=svc._cap_floor,
                                      device=svc.device)
            with np.load(os.path.join(snapshot_dir, "pairs.npz"),
                         allow_pickle=False) as z:
                svc._blocked, svc._matched = z["blocked"], z["matched"]
                svc._served_b, svc._served_m = z["served_b"], z["served_m"]
                svc._pair_ids = dict(zip(z["pair_packed"].tolist(),
                                         z["pair_id"].tolist()))
        return svc

    # -- lifecycle -----------------------------------------------------------

    def close(self, drain: bool = True,
              timeout: Optional[float] = None) -> None:
        """Stop the worker and refuse new submissions.  ``drain=True``
        (default) processes everything already queued first — every
        previously returned future completes normally; ``drain=False``
        fails queued requests immediately with a RuntimeError instead.

        ``timeout`` (seconds) bounds the shutdown so it cannot hang
        behind a stuck batch: if the worker has not finished draining
        when it expires, every still-queued future fails with
        ``BatchTimeoutError``, the service marks itself failed, and the
        abandoned worker (a daemon thread) is left to die with the
        process.  ``timeout=None`` keeps the legacy unbounded drain."""
        if self._closed:
            return
        self._closed = True
        if self._worker is not None:
            if not drain:
                self._fail_queued(RuntimeError(
                    "service closed with drain=False before this request "
                    "was processed"))
            try:
                self._q.put_nowait(_STOP)
            except queue.Full:
                # a full queue behind a stuck worker: only block for the
                # sentinel when the caller asked for an unbounded drain
                if timeout is None:
                    self._q.put(_STOP)
            self._worker.join(timeout)
            if self._worker.is_alive():
                exc = ADM.BatchTimeoutError(
                    f"close(timeout={timeout}) expired with the worker "
                    f"still busy; queued requests were abandoned")
                if self._failure is None:
                    self._failure = exc
                self._fail_queued(exc)
                try:        # the drained queue has room for the sentinel
                    self._q.put_nowait(_STOP)   # now: a later-recovering
                except queue.Full:              # worker still stops
                    pass
            self._worker = None

    def __enter__(self) -> "ResolutionService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
