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
"""
import collections
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


def _edges(spans):
    """Multiset of (span name, parent span name) — the shape of a trace."""
    by_index = {s.index: s for s in spans}
    return collections.Counter(
        (s.name, by_index[s.parent].name if s.parent >= 0 else None)
        for s in spans)


def _same_trace(ref, port):
    assert _edges(port.spans) == _edges(ref.spans)
    assert set(port.registry) == set(ref.registry)


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
    root, c1, c2 = t.spans()
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
    spans = t.spans()
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
    assert _edges(pk[0]) == _edges(rk[0]) and set(pk[1]) == set(rk[1])
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
    assert d["spans"] == 1


def test_torch_profiler_brackets_device_spans(ents):
    from torch.profiler import ProfilerActivity, profile
    t = TO.Tracer(torch_profiler=True)
    cfg = TA.ERConfig(**_kw())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with TO.activate(t):
            TA.resolve(port_ents(ents), cfg, device="cpu")
    assert "shard_program" in {e.key for e in prof.key_averages()}
    assert "shard_program" in {s.name for s in t.spans()}
