"""Parity of the port's tracing and metrics (``repro_torch.obs``) with the
reference's ``repro.obs`` on the CPU (invariant 12: tracing changes no
pair set).

  * the unit semantics of both packages side by side: span nesting, the
    no-op singleton, ``activate`` restoring, thread safety, histogram
    percentiles on one seeded sequence, the registry
  * ``pack_stats`` of the port's five stats types equals the reference's
    dict for the same runs (the executable-cache fields too: both caches
    start empty) and round-trips through JSON
  * a traced resolve, multi-pass resolve, stream, and a stream killed and
    resumed: the untraced sets, the reference's multiset of (span name,
    parent span name) pairs and its metric names
  * a traced run after an untraced one hits its executables (zero
    retraces)
  * the port's Chrome export read by the reference's ``tools/
    trace_report.py``
  * the port's own spans and metrics (``PORT_ONLY_SPANS``,
    ``PORT_ONLY_METRICS``, dropped from every parity check and held
    disjoint from the reference's): the public pair sets, the serve
    batch's steps, a stream's spool and union, the merge's blocks, the
    tuples the public sets box (``pairs_boxed``), the collections made
    on the device (``device_collections``) and the collector's passes,
    whose ``gc.callbacks`` hook is installed only while a tracer is
    active and cannot deadlock the tracer
"""
import collections
import gc
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as RA  # noqa: E402
from repro import obs as RO  # noqa: E402
from repro import stream as RS  # noqa: E402
from repro.core import entities as RE  # noqa: E402
from repro_torch import api as TA  # noqa: E402
from repro_torch import obs as TO  # noqa: E402
from repro_torch import stream as TS  # noqa: E402

from _torch_parity import clear_caches, port_ents  # noqa: E402

N, R, W = 600, 4, 6
PACKAGES = [RO, TO]


def _kw(**kw):
    kw.setdefault("window", W)
    kw.setdefault("num_shards", R)
    kw.setdefault("variant", "repsn")
    kw.setdefault("hops", R - 1)
    kw.setdefault("runner", "vmap")
    return kw


@pytest.fixture(scope="module")
def ents():
    return RE.synth_entities(np.random.default_rng(8), N, n_keys=90,
                             dup_frac=0.25, text_len=8)


def _chunks(ents, sz=150):
    h = RE.to_host(ents)
    n = int(h["key"].shape[0])
    return [RE.host_take(h, slice(s, min(s + sz, n)))
            for s in range(0, n, sz)]


# spans only the port opens: its host work (the public frozensets, the
# serve batch's steps, a stream's disk spool and its union of the chunk
# outcomes) and CPython's collector passes; a parity check drops them,
# re-parenting their children to the nearest kept ancestor
PORT_ONLY_SPANS = frozenset({"frozensets", "gc", "index", "delta_pairs",
                             "set_algebra", "compact", "publish", "spool",
                             "union"})
# metrics only the port records (the k-way merge's yielded blocks, the
# tuples its public pair sets yield when iterated, its collections made on
# the device)
PORT_ONLY_METRICS = frozenset({"merge_blocks", "pairs_boxed",
                               "device_collections"})


def _edges(spans):
    """Multiset of (span name, parent span name) — the shape of a trace —
    without ``PORT_ONLY_SPANS``."""
    by_index = {s.index: s for s in spans}

    def kept_parent(s):
        p = s.parent
        while p >= 0 and by_index[p].name in PORT_ONLY_SPANS:
            p = by_index[p].parent
        return by_index[p].name if p >= 0 else None

    return collections.Counter((s.name, kept_parent(s)) for s in spans
                               if s.name not in PORT_ONLY_SPANS)


def _metric_names(registry):
    """The names of a registry's metrics without ``PORT_ONLY_METRICS``."""
    return set(registry) - PORT_ONLY_METRICS


def _same_trace(ref, port):
    assert _edges(port.spans) == _edges(ref.spans)
    assert _metric_names(port.registry) == _metric_names(ref.registry)


# -- unit semantics, both packages -------------------------------------------

@pytest.mark.parametrize("pkg", PACKAGES, ids=["ref", "port"])
def test_span_nesting_and_attrs(pkg):
    t = pkg.Tracer()
    with pkg.activate(t):
        with pkg.span("root", a=1):
            with pkg.span("child") as c:
                c.set(b=2)
            with pkg.span("child"):
                pass
    # a collector pass under the tracer is a ``gc`` span of the port's
    root, c1, c2 = [s for s in t.spans() if s.name != "gc"]
    assert [s.name for s in (root, c1, c2)] == ["root", "child", "child"]
    assert (root.parent, root.depth) == (-1, 0)
    assert (c1.parent, c1.depth, c2.parent) == (root.index, 1, root.index)
    assert root.attrs == {"a": 1} and c1.attrs == {"b": 2}
    assert c1.t0 >= root.t0 and c1.t0 + c1.dur <= root.t0 + root.dur + 1e-6


@pytest.mark.parametrize("pkg", PACKAGES, ids=["ref", "port"])
def test_noop_singleton_and_activate_restores(pkg):
    assert pkg.current_tracer() is None
    sp = pkg.span("anything", big=list(range(10)))
    assert sp is pkg.NOOP_SPAN and not sp.enabled
    with sp:
        sp.set(ignored=True)
    t1, t2 = pkg.Tracer(), pkg.Tracer()
    with pkg.activate(t1):
        with pkg.activate(t2):
            assert pkg.current_tracer() is t2
        assert pkg.current_tracer() is t1
    assert pkg.current_tracer() is None


@pytest.mark.parametrize("pkg", PACKAGES, ids=["ref", "port"])
def test_spans_are_thread_safe(pkg):
    t = pkg.Tracer()

    def work(i):
        with pkg.activate(t):
            with pkg.span("outer", i=i):
                with pkg.span("inner", i=i):
                    pass

    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(30)
        assert not th.is_alive()
    spans = [s for s in t.spans() if s.name != "gc"]
    by_index = {s.index: s for s in spans}
    assert len(spans) == 16
    for s in spans:
        if s.name == "inner":
            parent = by_index[s.parent]
            assert parent.name == "outer" and parent.tid == s.tid
            assert parent.attrs["i"] == s.attrs["i"]


def test_histogram_and_registry_match_reference():
    values = np.random.default_rng(0).normal(size=500)
    hr, ht = RO.Histogram("lat", capacity=64), TO.Histogram("lat", 64)
    for v in values:
        hr.observe(float(v))
        ht.observe(float(v))
        for p in (0.0, 0.5, 0.95, 1.0):
            assert ht.percentile(p) == hr.percentile(p)
    assert (len(ht), ht.count) == (len(hr), hr.count) == (64, 500)
    assert ht.to_dict() == hr.to_dict()
    assert TO.Histogram("e").to_dict() == RO.Histogram("e").to_dict()
    regs = []
    for pkg in PACKAGES:
        m = pkg.MetricsRegistry()
        m.counter("x").inc(3)
        m.gauge("g").set(1.5)
        m.histogram("h", 8).observe(2.0)
        with pytest.raises(TypeError):
            m.gauge("x")
        regs.append(m.to_dict())
    assert regs[0] == regs[1]
    assert TO.SCHEMA_VERSION == RO.SCHEMA_VERSION
    assert TO.STATS_KINDS == RO.STATS_KINDS


# -- the unified stats schema -------------------------------------------------

def _packed_equal(ref_obj, port_obj, skip=()):
    """The port's packed stats against the reference's: equal but for
    ``skip``; both survive a JSON round trip to an equal typed object."""
    a, b = RO.pack_stats(ref_obj), TO.pack_stats(port_obj)
    assert set(a) == set(b)
    for k in a:
        if k not in skip:
            assert a[k] == b[k], (k, a[k], b[k])
    back = TO.unpack_stats(json.loads(json.dumps(b)))
    assert back == port_obj and type(back) is type(port_obj)


def test_pack_stats_of_the_same_run_matches_reference(ents):
    kw = _kw(partitioner="pairrange", trace=True)
    clear_caches()
    ref = RA.resolve(ents, RA.ERConfig(**kw))
    port = TA.resolve(port_ents(ents), TA.ERConfig(**kw), device="cpu")
    for f in ("balance", "perf", "resilience"):
        _packed_equal(getattr(ref, f), getattr(port, f))
    for kind in ("BalanceMetrics", "PerfStats", "ResilienceStats"):
        assert port.trace.stat(kind) == getattr(
            port, {"BalanceMetrics": "balance", "PerfStats": "perf",
                   "ResilienceStats": "resilience"}[kind])
    ref_s = RS.resolve_stream(iter(_chunks(ents)), RA.ERConfig(**kw),
                              chunk_size=150)
    port_s = TS.resolve_stream(iter(_chunks(ents)), TA.ERConfig(**kw),
                               chunk_size=150, device="cpu")
    _packed_equal(ref_s.stream, port_s.stream)
    assert port_s.trace.stat("StreamStats") == port_s.stream
    h = RE.to_host(ents)
    svcs = [pkg.serve(pkg.ERConfig(**_kw(trace=True)), start=False,
                      **extra)
            for pkg, extra in ((RA, {}), (TA, {"device": "cpu"}))]
    for svc in svcs:
        svc.resolve_incremental(RE.host_take(h, slice(0, 400)))
        svc.delete(h["eid"][10:20])
    _packed_equal(svcs[0].stats(), svcs[1].stats(),
                  skip=("p50_ms", "p95_ms"))
    assert svcs[1].trace_report().stat("ServeStats") == svcs[1].stats()


# -- invariant 12 end to end: same sets, same trace shape ---------------------

def test_traced_run_adds_zero_retraces(ents):
    """A traced resolve after an untraced one hits the executables the
    untraced one built (``trace`` is not in the static fingerprint)."""
    from repro_torch.perf import executable_cache
    cache = executable_cache()
    cfg = TA.ERConfig(**_kw())
    TA.resolve(port_ents(ents), cfg, device="cpu")     # warm untraced
    before = cache.stats.snapshot()
    res = TA.resolve(port_ents(ents), cfg.with_(trace=True), device="cpu")
    hits, misses, traces = cache.stats.delta(before)
    assert traces == 0 and misses == 0 and hits > 0
    assert res.perf.steady_state and res.trace is not None


def test_traced_resolve_matches_reference(ents):
    kw = _kw()
    plain = TA.resolve(port_ents(ents), TA.ERConfig(**kw), device="cpu")
    port = TA.resolve(port_ents(ents), TA.ERConfig(**kw, trace=True),
                      device="cpu")
    ref = RA.resolve(ents, RA.ERConfig(**kw, trace=True))
    assert plain.trace is None
    assert port.pairs == plain.pairs == ref.pairs
    assert port.matches == plain.matches == ref.matches
    _same_trace(ref.trace, port.trace)
    m = port.trace.metrics()
    assert m["schema_version"] == TO.SCHEMA_VERSION
    assert m["metrics"]["pairs"]["value"] == len(port.pairs)
    assert m["metrics"]["transfer_bytes"]["value"] > 0
    assert dict(port.trace.self_times())["shard_program"] > 0
    assert 0.0 < port.trace.coverage() <= 1.0
    assert TA.ERConfig(**kw).static_fingerprint() == \
        TA.ERConfig(**kw, trace=True).static_fingerprint()


def test_traced_multipass_and_link_match_reference(ents):
    passes = lambda pkg: (pkg.SortKeySpec(name="key"),
                          pkg.SortKeySpec(name="text1", source="text",
                                          kind="prefix", offset=1, width=2))
    kw = _kw(trace=True)
    ref = RA.resolve(ents, RA.ERConfig(**kw, passes=passes(RA)))
    port = TA.resolve(port_ents(ents), TA.ERConfig(**kw, passes=passes(TA)),
                      device="cpu")
    plain = TA.resolve(port_ents(ents),
                       TA.ERConfig(**_kw(passes=passes(TA))), device="cpu")
    assert port.pairs == plain.pairs == ref.pairs
    assert port.matches == plain.matches == ref.matches
    assert all(p.trace is None for p in port.passes)
    _same_trace(ref.trace, port.trace)
    h = RE.to_host(ents)
    lhs, rhs = RE.host_take(h, slice(0, 300)), RE.host_take(h, slice(300, N))
    mk = lambda x: RE.make_entities(x["key"], x["eid"],
                                    payload=x["payload"], valid=x["valid"])
    ref_l = RA.link(mk(lhs), mk(rhs), RA.ERConfig(**kw))
    port_l = TA.link(port_ents(mk(lhs)), port_ents(mk(rhs)),
                     TA.ERConfig(**kw), device="cpu")
    assert port_l.pairs == ref_l.pairs and port_l.matches == ref_l.matches
    _same_trace(ref_l.trace, port_l.trace)


def test_traced_stream_matches_reference(ents):
    kw = _kw(trace=True)
    ref = RS.resolve_stream(iter(_chunks(ents)), RA.ERConfig(**kw),
                            chunk_size=150)
    port = TS.resolve_stream(iter(_chunks(ents)), TA.ERConfig(**kw),
                             chunk_size=150, device="cpu")
    plain = TS.resolve_stream(iter(_chunks(ents)), TA.ERConfig(**_kw()),
                              chunk_size=150, device="cpu")
    assert port.pairs == plain.pairs == ref.pairs
    assert port.matches == plain.matches == ref.matches
    _same_trace(ref.trace, port.trace)
    chunk_spans = [s for s in port.trace.spans if s.name == "chunk"]
    assert [s.attrs["index"] for s in chunk_spans] == \
        list(range(port.stream.chunks))
    assert sum(s.attrs["carry"] for s in chunk_spans) == \
        port.stream.carry_entities == \
        port.trace.registry["carry_entities"]["value"]
    assert all(p.trace is None for p in port.passes)
    h = RE.to_host(ents)
    halves = [RE.host_take(h, slice(0, 300)), RE.host_take(h, slice(300, N))]
    ref_l = RS.link_stream(iter(halves[:1]), iter(halves[1:]),
                           RA.ERConfig(**kw), chunk_size=150)
    port_l = TS.link_stream(iter(halves[:1]), iter(halves[1:]),
                            TA.ERConfig(**kw), chunk_size=150, device="cpu")
    assert port_l.pairs == ref_l.pairs and port_l.matches == ref_l.matches
    _same_trace(ref_l.trace, port_l.trace)


def _under_tracer(obs, fn, raises=None):
    """(spans, registry, result) of ``fn`` run under an outer tracer with a
    root span of its own — how a call that raises (and so returns no
    report) is traced; ``raises``: the exception ``fn`` must raise."""
    t = obs.Tracer()
    with obs.activate(t), obs.span("root"):
        if raises is None:
            out = fn()
        else:
            with pytest.raises(raises):
                fn()
            out = None
    return t.spans(), t.metrics.to_dict(), out


def test_traced_kill_and_resume_match_reference(ents, tmp_path):
    """A stream killed after chunk 1's commit and resumed, in both
    packages: the killed run's and the resume's span trees and metric
    names are the reference's, and the traced resume (``resolve_stream``
    re-run and ``api.resume`` under a tracer) gives the untraced sets."""
    kw = _kw(trace=True)
    plain = TS.resolve_stream(iter(_chunks(ents)), TA.ERConfig(**_kw()),
                              chunk_size=150, device="cpu")
    runs = {}
    for name, pkg, spkg, obs, extra in (
            ("ref", RA, RS, RO, {}), ("port", TA, TS, TO, {"device": "cpu"})):
        ck = str(tmp_path / name)
        killed = _under_tracer(obs, lambda: spkg.resolve_stream(
            iter(_chunks(ents)), pkg.ERConfig(**kw), chunk_size=150,
            checkpoint_dir=ck, fault_plan=pkg.FaultPlan(crash_after_chunk=1),
            **extra), raises=pkg.InjectedFault)
        resumed = spkg.resolve_stream(iter(_chunks(ents)), pkg.ERConfig(**kw),
                                      chunk_size=150, checkpoint_dir=ck,
                                      **extra)
        runs[name] = (killed, resumed)
    (rk, rres), (pk, pres) = runs["ref"], runs["port"]
    assert _edges(pk[0]) == _edges(rk[0]) and \
        _metric_names(pk[1]) == _metric_names(rk[1])
    _same_trace(rres.trace, pres.trace)
    assert pres.pairs == plain.pairs == rres.pairs
    assert pres.matches == plain.matches == rres.matches
    assert [s.attrs["index"] for s in pres.trace.spans
            if s.name == "chunk"] == list(range(2, pres.stream.chunks))
    assert pres.trace.registry["checkpoint_commit_ms"]["count"] == \
        pres.stream.chunks - 2
    # api.resume under a tracer: a torn kill at chunk 2, then the resume
    ck = str(tmp_path / "torn")
    cfg = TA.ERConfig(**kw)
    with pytest.raises(TA.InjectedFault):
        TS.resolve_stream(iter(_chunks(ents)), cfg, chunk_size=150,
                          checkpoint_dir=ck, device="cpu",
                          fault_plan=TA.FaultPlan(crash_before_commit=2))
    spans, _, back = _under_tracer(
        TO, lambda: TA.resume(ck, cfg=cfg, device="cpu"))
    assert back.pairs == plain.pairs and back.matches == plain.matches
    assert [s.attrs["index"] for s in spans if s.name == "chunk"] == \
        list(range(2, back.stream.chunks))


# -- exports -----------------------------------------------------------------

def test_chrome_export_is_read_by_the_reference_tool(ents, tmp_path):
    from tools.trace_report import digest, load_trace
    res = TA.resolve(port_ents(ents), TA.ERConfig(**_kw(trace=True)),
                     device="cpu")
    path = str(tmp_path / "trace.json")
    res.trace.export_chrome(path)
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    assert len(events) == len(res.trace.spans)
    for ev in events:
        assert ev["ph"] == "X" and ev["dur"] >= 0 and ev["ts"] >= 0
        assert "index" in ev["args"] and "parent" in ev["args"]
    assert doc["repro"]["schema_version"] == RO.SCHEMA_VERSION
    d = digest(load_trace(path), top=5)
    assert d["spans"] == len(events)
    assert d["top_self_time"] and d["pairs"] == len(res.pairs)
    t = TO.Tracer()
    with TO.activate(t), TO.span("x", n=np.int64(3), shape=(2, 3)):
        pass
    t.export_chrome(str(tmp_path / "t.json"), extra={"note": 1})
    d = digest(load_trace(str(tmp_path / "t.json")), top=1)
    assert d["spans"] == len(t.spans()) >= 1


# -- the port's own spans ------------------------------------------------------

def _below(spans, ancestor):
    """The spans under ``ancestor`` (a SpanRecord), at any depth."""
    by_index = {s.index: s for s in spans}

    def under(s):
        p = s.parent
        while p >= 0:
            if p == ancestor.index:
                return True
            p = by_index[p].parent
        return False

    return [s for s in spans if under(s)]


def _obs_callbacks():
    return [cb for cb in gc.callbacks
            if getattr(cb, "__module__", "").startswith("repro_torch.obs")]


def test_port_only_spans_are_not_reference_spans(ents):
    """No reference span carries a name the parity checks drop, and the
    port's traces of the same runs do carry ``frozensets`` spans."""
    passes = lambda pkg: (pkg.SortKeySpec(name="key"),
                          pkg.SortKeySpec(name="text1", source="text",
                                          kind="prefix", offset=1, width=2))
    h = RE.to_host(ents)
    mk = lambda x: RE.make_entities(x["key"], x["eid"],
                                    payload=x["payload"], valid=x["valid"])
    lhs, rhs = mk(RE.host_take(h, slice(0, 300))), \
        mk(RE.host_take(h, slice(300, N)))
    kw = _kw(trace=True)
    ref = [RA.resolve(ents, RA.ERConfig(**kw)),
           RA.resolve(ents, RA.ERConfig(**kw, passes=passes(RA))),
           RA.link(lhs, rhs, RA.ERConfig(**kw)),
           RS.resolve_stream(iter(_chunks(ents)), RA.ERConfig(**kw),
                             chunk_size=150)]
    port = [TA.resolve(port_ents(ents), TA.ERConfig(**kw), device="cpu"),
            TA.resolve(port_ents(ents), TA.ERConfig(**kw, passes=passes(TA)),
                       device="cpu"),
            TA.link(port_ents(lhs), port_ents(rhs), TA.ERConfig(**kw),
                    device="cpu"),
            TS.resolve_stream(iter(_chunks(ents)), TA.ERConfig(**kw),
                              chunk_size=150, device="cpu")]
    ref_names = {s.name for r in ref for s in r.trace.spans}
    assert {"resolve", "attempt", "chunk"} <= ref_names
    assert not PORT_ONLY_SPANS & ref_names
    assert not PORT_ONLY_METRICS & {m for r in ref for m in r.trace.registry}
    for r in port:
        assert "frozensets" in {s.name for s in r.trace.spans}


def test_traced_resolve_spans_its_frozensets_under_attempt(ents):
    res = TA.resolve(port_ents(ents), TA.ERConfig(**_kw(trace=True)),
                     device="cpu")
    spans = res.trace.spans
    attempt, = [s for s in spans if s.name == "attempt"]
    sets = [s for s in spans if s.name == "frozensets"]
    assert sets and all(s in _below(spans, attempt) for s in sets)
    assert sorted(s.attrs["pairs"] for s in sets) == \
        sorted((len(res.pairs), len(res.matches)))


def test_traced_service_spans_each_batch(ents):
    """An insert that compacts and a delete that compacts, after the
    bootstrap: each batch holds the index, delta, set-algebra, compaction
    and publish steps, and the result's frozensets under ``publish``."""
    h = RE.to_host(ents)
    svc = TA.serve(TA.ERConfig(**_kw(variant="srp", trace=True)),
                   initial=RE.host_take(h, slice(0, 400)), start=False,
                   device="cpu", max_runs=1, max_tombstone_frac=0.0)
    svc.resolve_incremental(RE.host_take(h, slice(400, N)))
    svc.delete(h["eid"][10:20])
    assert svc.stats().compactions == 2
    spans = svc.trace_report().spans
    batches = [s for s in spans if s.name == "batch"]
    assert len(batches) == 3
    steps = {"index", "delta_pairs", "set_algebra", "compact", "publish"}
    for k, b in enumerate(batches):
        below = _below(spans, b)
        names = collections.Counter(s.name for s in below)
        assert set(names) >= steps - ({"compact"} if k == 0 else set())
        assert names["index"] == 2 and names["compact"] == (k > 0)
        publish, = [s for s in below if s.name == "publish"]
        assert len([s for s in _below(spans, publish)
                    if s.name == "frozensets"]) == 4
        assert publish.attrs["full_diff"] is True
        algebra, = [s for s in below if s.name == "set_algebra"]
        assert (algebra.attrs["touched"] > 0) == (k > 0)
        assert all(s.dur is not None for s in below)
    compact = [s for s in spans if s.name == "compact"]
    assert [s.attrs["runs"] for s in compact] == [1, 1]
    assert [s.attrs["rows"] for s in compact] == [N, N - 10]
    assert svc.trace_report().registry["publish_full_diffs"]["value"] == 3
    svc.close()


def test_traced_boundary_complete_service_publishes_the_edit(ents):
    """Under repsn each batch's ``publish`` takes the batch's edit (no
    whole-set diff: ``full_diff`` false, ``publish_full_diffs`` 0), still
    builds the result's frozensets under it, and ``set_algebra`` counts
    the maintained pairs its lookups read: none at the bootstrap, more
    than the batch's edit after it."""
    h = RE.to_host(ents)
    svc = TA.serve(TA.ERConfig(**_kw(trace=True)),
                   initial=RE.host_take(h, slice(0, 400)), start=False,
                   device="cpu")
    results = [svc.resolve_incremental(RE.host_take(h, slice(400, N))),
               svc.delete(h["eid"][10:20])]
    spans = svc.trace_report().spans
    batches = [s for s in spans if s.name == "batch"]
    assert len(batches) == 3
    for k, b in enumerate(batches):
        below = _below(spans, b)
        publish, = [s for s in below if s.name == "publish"]
        assert publish.attrs["full_diff"] is False
        assert len([s for s in _below(spans, publish)
                    if s.name == "frozensets"]) == 4
        algebra, = [s for s in below if s.name == "set_algebra"]
        touched = algebra.attrs["touched"]
        assert isinstance(touched, int)
        if k == 0:
            assert touched == 0
        else:
            res = results[k - 1]
            assert touched >= len(res.retired_pairs) + \
                len(res.retired_matches) > 0
    assert svc.trace_report().registry["publish_full_diffs"]["value"] == 0
    svc.close()


def test_collector_passes_are_spans_under_the_open_span():
    t = TO.Tracer()
    was = gc.isenabled()
    gc.disable()            # only the passes asked for below
    try:
        with TO.activate(t), TO.span("open"):
            for generation in (0, 1, 2):
                gc.collect(generation)
    finally:
        if was:
            gc.enable()
    root, *passes = t.spans()
    assert root.name == "open"
    assert [s.name for s in passes] == ["gc"] * 3
    assert [s.attrs["generation"] for s in passes] == [0, 1, 2]
    for s in passes:
        assert s.parent == root.index and s.depth == 1 and s.dur >= 0
        assert set(s.attrs) == {"generation", "collected", "uncollectable"}
        assert root.t0 <= s.t0 and s.t0 + s.dur <= root.t0 + root.dur
    assert not t.metrics.to_dict()          # spans only, no metric


def test_no_gc_callback_without_an_active_tracer(ents):
    assert not _obs_callbacks()
    with TO.activate(TO.Tracer()):
        assert len(_obs_callbacks()) == 1
        with TO.activate(TO.Tracer()):
            assert len(_obs_callbacks()) == 1
        seen = []
        th = threading.Thread(target=lambda: seen.append(
            len(_obs_callbacks())))
        th.start()
        th.join(30)
        assert seen == [1]
    assert not _obs_callbacks()
    res = TA.resolve(port_ents(ents), TA.ERConfig(**_kw(trace=True)),
                     device="cpu")
    assert res.trace is not None and not _obs_callbacks()
    svc = TA.serve(TA.ERConfig(**_kw(trace=True)),
                   initial=RE.to_host(ents), device="cpu")
    svc.delete(RE.to_host(ents)["eid"][:5])
    svc.close()
    assert svc.trace_report().spans and not _obs_callbacks()
    TA.resolve(port_ents(ents), TA.ERConfig(**_kw()), device="cpu")
    assert not _obs_callbacks()


def test_collector_cannot_deadlock_the_tracer(ents, tmp_path):
    """A collection after every allocation lands inside the tracer's own
    locked sections too; a traced resolve and the export still finish."""
    done = []

    def work():
        res = TA.resolve(port_ents(ents), TA.ERConfig(**_kw(trace=True)),
                         device="cpu")
        res.trace.export_chrome(str(tmp_path / "resolve.json"))
        t = TO.Tracer()
        with TO.activate(t), TO.span("x"):
            for _ in range(1000):
                t.spans()
                with TO.span("y"):
                    pass
            t.export_chrome(str(tmp_path / "t.json"))
        done.append(len(res.trace.spans) > 0 and len(t.spans()) > 0)

    old = gc.get_threshold()
    gc.set_threshold(1)
    try:
        th = threading.Thread(target=work, daemon=True)
        th.start()
        th.join(120)
        alive = th.is_alive()
    finally:
        gc.set_threshold(*old)
    assert not alive and done == [True]
