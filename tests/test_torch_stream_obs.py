"""The port's out-of-core tracing: the disk spool's ``spool`` spans, the
``union`` of a pass's chunk outcomes and the k-way merge's
``merge_blocks`` counter (``repro_torch.stream``), on the CPU.

  * a traced spooled stream opens ``spool`` spans (writes at ingest and
    for each sorted run, reads under ``sort_runs`` and ``merge``) and one
    ``union`` span a pass; an in-memory stream opens no ``spool`` span
  * ``merge_blocks`` equals the blocks ``merged_blocks`` yields, for a
    stream and for the merge alone
  * an in-memory ``ChunkStore``, as the serve index keeps, opens no
    ``spool`` span, also through a service's compactions
  * tracing changes no pair set (invariant 12)
"""
import collections
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import api as TA  # noqa: E402
from repro_torch import obs as TO  # noqa: E402
from repro_torch import stream as TS  # noqa: E402
from repro_torch.core import entities as TE  # noqa: E402

N, R, W, CHUNK = 640, 4, 6, 160


def _kw(**kw):
    return dict(dict(window=W, num_shards=R, variant="repsn", hops=R - 1,
                     runner="vmap"), **kw)


@pytest.fixture(scope="module")
def host():
    ents = TE.synth_entities(np.random.default_rng(28), N, n_keys=70,
                             dup_frac=0.25, text_len=8)
    return TE.to_host(ents)


def _chunks(host):
    return [TE.host_take(host, slice(s, s + CHUNK))
            for s in range(0, N, CHUNK)]


def _stream(host, spool_dir=None, **kw):
    return TS.resolve_stream(iter(_chunks(host)), TA.ERConfig(**_kw(**kw)),
                             chunk_size=CHUNK, spool_dir=spool_dir,
                             device="cpu")


def _parents(spans):
    by_index = {s.index: s for s in spans}
    return collections.Counter(
        (s.name, by_index[s.parent].name if s.parent >= 0 else None)
        for s in spans)


def _sorted_runs(host, spool_dir=None):
    """The stream's sorted runs of ``_chunks``, as its first phase makes
    them (each chunk sorted by (key, eid))."""
    runs = TS.ChunkStore(spool_dir, prefix="run")
    for h in _chunks(host):
        runs.append(TE.sort_chunk(TE.make_entities(
            h["key"], h["eid"], payload=h["payload"], valid=h["valid"])))
    return runs


def test_traced_spooled_stream_opens_spool_and_union_spans(host, tmp_path):
    res = _stream(host, str(tmp_path / "spool"), trace=True)
    spans = res.trace.spans
    edges = _parents(spans)
    chunks = len(_chunks(host))
    # one write per raw chunk under ingest and per sorted run under
    # sort_runs, one read per raw chunk there
    assert edges[("spool", "ingest")] == chunks
    assert edges[("spool", "sort_runs")] == 2 * chunks
    # the merge reads each run's index and then its rows
    assert edges[("spool", "merge")] == 2 * chunks
    assert edges[("union", "pass")] == 1
    union, = [s for s in spans if s.name == "union"]
    assert union.attrs["chunks"] == res.stream.chunks
    assert {s.attrs["op"] for s in spans if s.name == "spool"} == \
        {"write", "read", "index"}
    assert all(s.dur is not None for s in spans)


def test_in_memory_stream_opens_no_spool_span(host):
    res = _stream(host, trace=True)
    names = collections.Counter(s.name for s in res.trace.spans)
    assert names["spool"] == 0 and names["union"] == 1


@pytest.mark.parametrize("spooled", [False, True], ids=["memory", "disk"])
def test_merge_blocks_counts_the_blocks_merged(host, tmp_path, spooled):
    spool = str(tmp_path / "spool") if spooled else None
    res = _stream(host, spool, trace=True)
    want = len(list(TS.merged_blocks(_sorted_runs(host), CHUNK)))
    assert want > res.stream.runs
    assert res.trace.registry["merge_blocks"] == {"type": "counter",
                                                  "value": want}


@pytest.mark.parametrize("block", [1, 7, CHUNK, N])
def test_merge_blocks_counter_of_the_merge_alone(host, block):
    runs = _sorted_runs(host)
    tracer = TO.Tracer()
    with TO.activate(tracer):
        got = list(TS.merged_blocks(runs, block))
    assert tracer.metrics.counter("merge_blocks").value == len(got)
    # untraced, the merge yields the same blocks and counts nothing
    plain = list(TS.merged_blocks(runs, block))
    assert [b["eid"].tolist() for b in plain] == \
        [b["eid"].tolist() for b in got]
    assert len(tracer.metrics) == 1


def test_in_memory_chunk_store_opens_no_spool_span(host, tmp_path):
    h = _chunks(host)[0]
    tracer = TO.Tracer()
    with TO.activate(tracer):
        for store in (TS.ChunkStore(), TS.ChunkStore(str(tmp_path))):
            store.append(h)
            store.load(0)
            store.load_index(0)
            store.load_field(0, "feat")
    ops = [s.attrs["op"] for s in tracer.spans() if s.name == "spool"]
    # the spooled store's four operations only
    assert ops == ["write", "read", "index", "field"]


def test_serve_index_in_memory_opens_no_spool_span(host):
    svc = TA.serve(TA.ERConfig(**_kw(trace=True)),
                   initial=TE.host_take(host, slice(0, 400)), start=False,
                   device="cpu", max_runs=1, max_tombstone_frac=0.0)
    svc.resolve_incremental(TE.host_take(host, slice(400, N)))
    svc.delete(host["eid"][10:20])
    assert svc.stats().compactions == 2
    report = svc.trace_report()
    names = {s.name for s in report.spans}
    assert "compact" in names and "spool" not in names
    # the compactions merge the index's runs
    assert report.registry["merge_blocks"]["value"] > 0


@pytest.mark.parametrize("spooled", [False, True], ids=["memory", "disk"])
def test_tracing_changes_no_pair_set(host, tmp_path, spooled):
    spool = (lambda name: str(tmp_path / name)) if spooled else \
        (lambda name: None)
    plain = _stream(host, spool("plain"))
    traced = _stream(host, spool("traced"), trace=True)
    assert plain.trace is None and traced.trace is not None
    assert traced.pairs == plain.pairs and traced.matches == plain.matches
    # the executable cache's counters depend on what ran before
    cold = lambda s: replace(s, cache_hits=0, cache_misses=0, traces=0,
                             steady_chunks=0)
    assert cold(traced.stream) == cold(plain.stream)
    assert len(plain.pairs) > 0 and len(plain.matches) > 0
