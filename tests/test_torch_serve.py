"""Parity of the port's online serving (``repro_torch.serve``,
``repro_torch.api.serve``) with the reference's ``repro.serve`` on the CPU.

The same numpy corpus and the same insert/delete sequence go through both
packages' services (the port with ``device="cpu"``, the reference with
JAX on the CPU, its pallas engine in interpret mode as its own tests run
it):

  * every variant x band engine under interleaved inserts and deletes:
    the served sets, every ``IncrementalResult`` (edits, stable pair ids,
    batch width) and every ``ServeStats`` field but the latencies (the
    executable-cache counters included: both caches start empty) equal
    the reference service's, and the served sets equal a from-scratch
    port resolve
  * steady micro-batches are pure executable-cache hits (zero retraces)
  * maintained-set semantics, stable pair ids, compaction, delete-all,
    the micro-batcher on the worker thread, the guardrails
  * a snapshot written by either package restores in the other
  * the ``SortedIndex`` units against the reference's index, and the
    sorted set operations against numpy's
"""
import glob

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import (assert_same_serve, clear_caches,  # noqa: E402
                           port_ents)
from repro import api as RA  # noqa: E402
from repro.core import entities as RE  # noqa: E402
from repro.serve import ResolutionService as RefService  # noqa: E402
from repro.serve import SortedIndex as RefIndex  # noqa: E402
from repro_torch import api as TA  # noqa: E402
from repro_torch.api import results as TR  # noqa: E402
from repro_torch.core import entities as TE  # noqa: E402
from repro_torch.serve import ResolutionService, SortedIndex  # noqa: E402

N, R, W = 520, 4, 6
VARIANTS = ["srp", "repsn", "jobsn"]
ENGINES = ["scan", "pallas"]


def _kw(**kw):
    kw.setdefault("window", W)
    kw.setdefault("num_shards", R)
    kw.setdefault("variant", "repsn")
    kw.setdefault("hops", R - 1)
    kw.setdefault("runner", "vmap")
    if kw.get("band_engine") == "pallas":
        kw.setdefault("band_interpret", True)
        kw.setdefault("band_block", 64)
    return kw


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(11)
    return RE.to_host(RE.synth_entities(rng, N, n_keys=70, dup_frac=0.25))


def _take(h, sel):
    return RE.host_take(h, sel)


def _services(kw, initial, **svc_kw):
    """(reference, port) services under one kwargs dict, both inline and
    both from an empty executable cache."""
    clear_caches()
    ref = RA.serve(RA.ERConfig(**kw), initial=initial, start=False,
                   **svc_kw)
    port = TA.serve(TA.ERConfig(**kw), initial=initial, start=False,
                    device="cpu", **svc_kw)
    return ref, port


def _resolve_live(h_live, kw):
    return TA.resolve(port_ents(RE.make_entities(
        h_live["key"], h_live["eid"], payload=h_live["payload"],
        valid=h_live["valid"])), TA.ERConfig(**kw), device="cpu")


def _assert_fresh(svc, corpus, live, kw):
    """The served sets equal a from-scratch port resolve of the live
    entities."""
    ref = _resolve_live(_take(corpus, np.flatnonzero(live)), kw)
    assert svc.pairs == ref.blocking.pairs
    assert svc.matches == ref.matches


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_interleaved_parity(corpus, variant, engine):
    """The tentpole contract, against both oracles: batches far below the
    window, deletes inside the initial corpus and inside earlier delta
    regions."""
    kw = _kw(variant=variant, band_engine=engine)
    ref, port = _services(kw, _take(corpus, slice(0, 300)))
    live = np.zeros(N, bool)
    live[:300] = True
    assert_same_serve(ref, port)
    _assert_fresh(port, corpus, live, kw)
    eid = corpus["eid"]
    prev = port.pairs
    for kind, arg in [("insert", slice(300, 303)),
                      ("delete", eid[150:154]),
                      ("insert", slice(303, 380)),
                      ("delete", np.concatenate([eid[301:302],
                                                 eid[320:350]])),
                      ("insert", slice(380, 420))]:
        if kind == "insert":
            a = ref.resolve_incremental(_take(corpus, arg))
            b = port.resolve_incremental(_take(corpus, arg))
            live[arg] = True
        else:
            a, b = ref.delete(arg), port.delete(arg)
            live[np.isin(eid, arg)] = False
        assert_same_serve(ref, port, a, b)
        assert (prev - b.retired_pairs) | b.new_pairs == port.pairs
        assert b.new_pairs.isdisjoint(prev) and b.retired_pairs <= prev
        prev = port.pairs
    _assert_fresh(port, corpus, live, kw)


def test_delete_creates_insert_retires_and_ids_stay(corpus):
    """Maintained-set semantics (a delete can create pairs, an insert
    retire them) and stable pair ids across retire / re-create, in step
    with the reference."""
    ref, port = _services(_kw(), _take(corpus, slice(0, 300)))
    mid = port.index.eids_at_ranks(140, 160)
    assert np.array_equal(mid, ref.index.eids_at_ranks(140, 160))
    rows = np.flatnonzero(np.isin(corpus["eid"][:300], mid))
    results = []
    for op in ("delete", "insert", "delete"):
        pair = [svc.delete(mid) if op == "delete"
                else svc.resolve_incremental(_take(corpus, rows))
                for svc in (ref, port)]
        assert_same_serve(ref, port, *pair)
        results.append(pair[1])
    created = next(iter(results[0].new_pairs))
    assert results[0].new_pairs and \
        results[1].retired_pairs >= results[0].new_pairs
    assert results[2].pair_ids[created] == results[0].pair_ids[created] \
        == port.pair_id(created) == ref.pair_id(created)


def test_compaction_reclaims_and_preserves(corpus, tmp_path):
    kw = _kw(num_shards=2, hops=1)
    spools = [str(tmp_path / "ref"), str(tmp_path / "port")]
    clear_caches()
    ref = RA.serve(RA.ERConfig(**kw), initial=_take(corpus, slice(0, 200)),
                   start=False, spool_dir=spools[0], segment_rows=64,
                   max_runs=3, max_tombstone_frac=0.1)
    port = TA.serve(TA.ERConfig(**kw), initial=_take(corpus, slice(0, 200)),
                    start=False, spool_dir=spools[1], segment_rows=64,
                    max_runs=3, max_tombstone_frac=0.1, device="cpu")
    live = np.zeros(N, bool)
    live[:200] = True
    for i in range(5):
        for svc in (ref, port):
            svc.resolve_incremental(_take(corpus, slice(200 + 20 * i,
                                                        220 + 20 * i)))
    live[200:300] = True
    for svc in (ref, port):
        svc.delete(corpus["eid"][10:40])
    live[10:40] = False
    st = port.stats()
    assert st.compactions >= 1
    assert st.tombstones == 0 and st.index_rows == st.live_entities
    assert all("g000" not in p for p in glob.glob(spools[1] + "/*.npz"))
    assert sorted(p.split("/")[-1] for p in glob.glob(spools[1] + "/*")) \
        == sorted(p.split("/")[-1] for p in glob.glob(spools[0] + "/*"))
    assert_same_serve(ref, port)
    _assert_fresh(port, corpus, live, kw)
    for svc in (ref, port):       # deleted eids re-insert after compaction
        svc.resolve_incremental(_take(corpus, slice(10, 25)))
    live[10:25] = True
    assert_same_serve(ref, port)
    _assert_fresh(port, corpus, live, kw)


def test_delete_all_then_rebuild(corpus):
    kw = _kw(num_shards=2, hops=1)
    ref, port = _services(kw, _take(corpus, slice(0, 60)))
    for svc in (ref, port):
        svc.delete(corpus["eid"][:60])
    assert port.pairs == frozenset() and port.stats().live_entities == 0
    for svc in (ref, port):
        svc.resolve_incremental(_take(corpus, slice(30, 90)))
    assert_same_serve(ref, port)
    live = np.zeros(N, bool)
    live[30:90] = True
    _assert_fresh(port, corpus, live, kw)


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_snapshot_crosses_packages(corpus, tmp_path, writer):
    """A snapshot either package wrote restores in the other: the same
    served sets under the same pair ids, and the next mutations stay in
    step with the writer's own service."""
    kw = _kw(variant="srp")
    ref, port = _services(kw, _take(corpus, slice(0, 300)))
    for svc in (ref, port):
        svc.delete(corpus["eid"][100:110])
        svc.resolve_incremental(_take(corpus, slice(300, 340)))
    src = ref if writer == "ref" else port
    src.snapshot(str(tmp_path))
    back = ResolutionService.restore(str(tmp_path), TA.ERConfig(**kw),
                                     start=False, device="cpu") \
        if writer == "ref" else \
        RefService.restore(str(tmp_path), RA.ERConfig(**kw), start=False)
    def same_state():         # a restored service starts its counters anew
        for f in ("packed_pairs", "packed_matches"):
            a, b = getattr(src, f), getattr(back, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        assert dict(back._pair_ids) == dict(src._pair_ids)
        assert np.array_equal(back.index.live_comps, src.index.live_comps)

    same_state()
    for svc in (src, back):
        svc.resolve_incremental(_take(corpus, slice(340, 380)))
        svc.delete(corpus["eid"][5:9])
    same_state()
    with pytest.raises(ValueError, match="does not match"):
        ResolutionService.restore(str(tmp_path),
                                  TA.ERConfig(**_kw(window=W + 1)),
                                  start=False, device="cpu")


def _microbatch(pkg, corpus, kw, **svc_kw):
    """Bootstrap 200 entities, then six inserts submitted together (one
    coalesced batch), then an insert and a delete: (service, the six
    results, the stats after them)."""
    svc = pkg.serve(pkg.ERConfig(**kw), initial=_take(corpus, slice(0, 200)),
                    max_batch=400, max_wait_ms=250.0, **svc_kw)
    futs = [svc.submit_insert(_take(corpus, slice(200 + 5 * i, 205 + 5 * i)))
            for i in range(6)]
    res = [f.result(timeout=60) for f in futs]
    fi = svc.submit_insert(_take(corpus, slice(230, 240)))
    fd = svc.submit_delete(corpus["eid"][232:234])
    fi.result(timeout=60), fd.result(timeout=60)
    return svc, res, svc.stats()


def test_microbatcher_coalesces_and_preserves_order(corpus):
    kw = _kw()
    clear_caches()
    ref, _, ref_st = _microbatch(RA, corpus, kw)
    ref.close()
    svc, res, st = _microbatch(TA, corpus, kw, device="cpu")
    try:
        assert all(r.batched == 6 for r in res)
        assert res[0] is res[5]
        live = np.zeros(N, bool)
        live[:240] = True
        live[232:234] = False
        _assert_fresh(svc, corpus, live, kw)
        assert st.requests == 9 and st.batches <= 4
        assert st.p95_ms >= st.p50_ms > 0.0
        # the same batches meter the reference's executable-cache counters
        assert (st.batches, st.steady_batches, st.cache_hits,
                st.cache_misses, st.traces) == \
            (ref_st.batches, ref_st.steady_batches, ref_st.cache_hits,
             ref_st.cache_misses, ref_st.traces)
        assert st.device_calls > 0 and st.shapes
        # a port-tensor insert and a host insert in the reference's dtypes
        # (uint32 signatures) coalesce into one batch
        ft = svc.submit_insert(TE.make_entities(
            corpus["key"][240:250], corpus["eid"][240:250],
            payload={k: v[240:250] for k, v in corpus["payload"].items()}))
        fh = svc.submit_insert(_take(corpus, slice(250, 260)))
        assert ft.result(timeout=60) is fh.result(timeout=60)
        live[240:260] = True
        _assert_fresh(svc, corpus, live, kw)
    finally:
        svc.close(timeout=60)


@pytest.mark.parametrize("engine", ENGINES)
def test_steady_state_is_zero_retrace(corpus, engine):
    """Shape bucketing: after warm-up, identically-sized micro-batches are
    pure executable-cache hits — traces do not grow with requests, in
    either package, and the counters agree."""
    kw = _kw(band_engine=engine)
    ref, port = _services(kw, _take(corpus, slice(0, 300)))
    for i in range(3):                                   # warm the buckets
        for svc in (ref, port):
            svc.resolve_incremental(_take(corpus, slice(300 + 10 * i,
                                                        310 + 10 * i)))
    warm = port.stats()
    for i in range(3, 8):
        pair = [svc.resolve_incremental(
            _take(corpus, slice(300 + 10 * i, 310 + 10 * i)))
            for svc in (ref, port)]
    st = pair[1].stats
    assert st.traces == warm.traces
    assert st.cache_misses == warm.cache_misses
    assert st.cache_hits > warm.cache_hits
    assert st.steady_batches - warm.steady_batches == 5
    assert len(st.shapes) == len(warm.shapes)
    assert_same_serve(ref, port, *pair)


def test_service_guardrails(corpus):
    for bad in (dict(passes=(TA.SortKeySpec(name="key"),)),
                dict(linkage=True), dict(return_scores=True),
                dict(window_policy="adaptive", window_max=W + 2)):
        with pytest.raises(ValueError):
            TA.serve(TA.ERConfig(**_kw(**bad)), start=False, device="cpu")
    svc = TA.serve(TA.ERConfig(**_kw()), initial=_take(corpus, slice(0, 100)),
                   start=False, device="cpu")
    with pytest.raises(ValueError):            # live-eid collision
        svc.resolve_incremental(_take(corpus, slice(50, 60)))
    with pytest.raises(ValueError):            # unknown delete
        svc.delete(np.asarray([999999], np.int64))
    before = svc.pairs
    empty = _take(corpus, np.zeros((0,), np.int64))
    assert svc.resolve_incremental(empty).new_pairs == frozenset()
    assert svc.pairs == before
    _assert_fresh(svc, corpus, np.arange(N) < 100, _kw())


def test_service_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TA.serve(TA.ERConfig(**_kw()), start=False)


def test_sorted_index_units_match_reference(tmp_path):
    rng = np.random.default_rng(3)
    h = RE.to_host(RE.synth_entities(rng, 100, n_keys=20))
    t_idx = SortedIndex(W, spool_dir=str(tmp_path / "port"))
    r_idx = RefIndex(W, spool_dir=str(tmp_path / "ref"))
    t_run = TE.sort_chunk(port_ents(RE.make_entities(
        h["key"], h["eid"], payload=h["payload"], valid=h["valid"])))
    r_run = RE.sort_chunk(RE.make_entities(h["key"], h["eid"],
                                           payload=h["payload"],
                                           valid=h["valid"]))
    t_idx.insert(t_run)
    r_idx.insert(r_run)
    assert np.array_equal(t_idx.live_comps, r_idx.live_comps)
    assert np.array_equal(t_idx.live_comps, np.sort(t_idx.live_comps))
    comps = t_idx.comps_of(h["eid"][:5])
    ranks = np.searchsorted(t_idx.live_comps, comps)
    assert np.array_equal(t_idx.eids_at_ranks(int(ranks[0]),
                                              int(ranks[0]) + 1),
                          np.asarray(h["eid"][:1], np.int64))
    region = t_idx.take_comp_range(int(t_idx.live_comps[10]),
                                   int(t_idx.live_comps[19]))
    assert np.array_equal(np.asarray(region["eid"], np.int64),
                          t_idx.eids_at_ranks(10, 20))
    assert region["payload"]["sig"].dtype == np.int32
    with pytest.raises(ValueError):
        t_idx.insert(t_run)                        # duplicate eids
    t_idx.delete(h["eid"][:10])
    r_idx.delete(h["eid"][:10])
    with pytest.raises(ValueError):
        t_idx.comps_of(h["eid"][:1])               # tombstoned
    assert (t_idx.n_live, t_idx.tombstones) == (90, 10)
    assert np.array_equal(t_idx.live_comps, r_idx.live_comps)
    for f in ("uniq", "counts"):
        assert np.array_equal(getattr(t_idx.profile, f),
                              getattr(r_idx.profile, f))
    t_idx.compact()
    r_idx.compact()
    assert t_idx.tombstones == 0 and t_idx.n_rows == t_idx.n_live == 90
    assert t_idx.n_runs == r_idx.n_runs
    scan = [b["eid"] for b in t_idx.scan_live(16)]
    assert np.array_equal(np.concatenate(scan),
                          np.concatenate([b["eid"]
                                          for b in r_idx.scan_live(16)]))
    # an index snapshot crosses packages too
    t_idx.snapshot(str(tmp_path / "snap"))
    back = RefIndex.restore(str(tmp_path / "snap"))
    assert np.array_equal(back.live_comps, t_idx.live_comps)


def test_sorted_set_ops_equal_numpy():
    """The port's sorted set operations give numpy's values in numpy's
    dtype on sorted distinct packed arrays (empty ones included)."""
    rng = np.random.default_rng(0)
    ops = [(TR.setdiff_sorted, np.setdiff1d), (TR.union_sorted, np.union1d),
           (TR.intersect_sorted, np.intersect1d), (TR.isin_sorted, np.isin)]
    for _ in range(300):
        a, b = (np.unique(rng.integers(0, 64, rng.integers(0, 48))
                          .astype(np.uint64)) for _ in range(2))
        for mine, theirs in ops:
            got, want = mine(a, b), theirs(a, b)
            assert got.dtype == want.dtype and np.array_equal(got, want)
        c = rng.integers(-20, 20, rng.integers(0, 40))
        assert np.array_equal(TR.sort_unique(c), np.unique(c))
        assert TR.sort_unique(c).dtype == np.unique(c).dtype
    a = np.array([3, 1, 7, 3], np.int64)
    assert np.array_equal(TR.isin_sorted(a, np.array([3, 7], np.int64)),
                          np.isin(a, [3, 7]))


# -- the maintained-set edit of one batch -------------------------------------

def _restrict_reference(packed, eid_sorted, iv_of):
    """The edit's former restriction: every maintained pair unpacked and
    both endpoints looked up among the region eids (same interval)."""
    if packed.shape[0] == 0 or eid_sorted.shape[0] == 0:
        return packed[:0]
    lo, hi = TR.unpack_pairs(packed)
    il, ih = np.searchsorted(eid_sorted, lo), np.searchsorted(eid_sorted, hi)
    last = eid_sorted.shape[0] - 1
    ilc, ihc = np.minimum(il, last), np.minimum(ih, last)
    return packed[(il <= last) & (eid_sorted[ilc] == lo) & (ih <= last)
                  & (eid_sorted[ihc] == hi) & (iv_of[ilc] == iv_of[ihc])]


def _edit_reference(blocked, matched, after_b, after_m, region_eids,
                    region_ivs, degraded):
    """The edit's former formula, whole-set diffs and unions: (blocked',
    matched', added_b, removed_b, added_m, removed_m)."""
    if region_eids:
        eids, ivs = np.concatenate(region_eids), np.concatenate(region_ivs)
        order = np.argsort(eids, kind="stable")
        eid_sorted, iv_of = eids[order], ivs[order]
    else:
        eid_sorted = iv_of = np.empty((0,), np.int64)
    diff = lambda a, b: TR.setdiff_sorted(a, b) if a.shape[0] else a[:0]
    before_b = _restrict_reference(blocked, eid_sorted, iv_of)
    before_m = _restrict_reference(matched, eid_sorted, iv_of)
    if degraded:
        after_m = TR.intersect_sorted(before_m, after_b)
    return (TR.union_sorted(diff(blocked, before_b), after_b),
            TR.union_sorted(diff(matched, before_m), after_m),
            diff(after_b, before_b), diff(before_b, after_b),
            diff(after_m, before_m), diff(before_m, after_m))


def _sn_pairs(order, w):
    """Packed SN pairs of eids in ``order`` (ranks < w apart)."""
    order = np.asarray(order, np.int64)
    parts = [TR.pack_pairs(order[:-d], order[d:])
             for d in range(1, min(w, order.shape[0]))]
    return TR.unique_packed(np.concatenate(parts)) if parts \
        else np.empty((0,), TR.PACKED_DTYPE)


def _matched_of(blocked):
    """A per-pair deterministic matcher stand-in."""
    return blocked[(blocked * np.uint64(0x9E3779B97F4A7C15))
                   >> np.uint64(61) == 0]


def _random_edit(rng, kind, n=9000, w=6, muts=120):
    """A maintained SN set of ~50k pairs over ``n`` eids in random order,
    and the regions and after-pairs of ``muts`` random inserts or
    deletes, as ``DeltaMatcher.insert``/``delete`` build them."""
    from repro_torch.serve.delta import merge_intervals
    order = rng.permutation(n).astype(np.int64) * 3 + 7
    blocked = _sn_pairs(order, w)
    if kind == "delete":
        ranks = np.sort(rng.choice(n, muts, replace=False))
        gone = order[ranks]
        full, post = order, order[~np.isin(order, gone)]
    else:
        ranks = np.sort(rng.choice(n + muts, muts, replace=False))
        full = np.empty(n + muts, np.int64)
        new = np.zeros(n + muts, bool)
        new[ranks] = True
        full[new] = np.arange(muts) * 3 + 3 * n + 8
        full[~new] = order
        gone, post = np.empty(0, np.int64), full
    region_eids, region_ivs, parts = [], [], []
    for iv, (lo, hi) in enumerate(merge_intervals(ranks, w, full.shape[0])):
        reg = full[lo:hi]
        region_eids.append(reg)
        region_ivs.append(np.full(reg.shape[0], iv, np.int64))
        parts.append(_sn_pairs(reg[~np.isin(reg, gone)], w))
    after_b = TR.unique_packed(np.concatenate(parts))
    want = _sn_pairs(post, w)
    return (blocked, _matched_of(blocked), after_b, _matched_of(after_b),
            region_eids, region_ivs, want)


def _edit_case(case):
    """(blocked, matched, after_b, after_m, region_eids, region_ivs,
    degraded, the blocked set the edit must leave or None)."""
    rng = np.random.default_rng(sum(map(ord, case)))
    if case in ("inserts", "deletes", "degraded"):
        b, m, ab, am, reg, ivs, want = _random_edit(
            rng, "delete" if case == "deletes" else "insert")
        return b, m, ab, am, reg, ivs, case == "degraded", want
    if case == "no_regions":
        b, m, _, _, _, _, _ = _random_edit(rng, "insert")
        empty = b[:0]
        return b, m, empty, empty, [], [], False, b
    pk = lambda *ps: TR.unique_packed(TR.pack_pairs(
        np.array([p[0] for p in ps], np.int64),
        np.array([p[1] for p in ps], np.int64)))
    if case == "two_intervals":
        # (3, 4) spans intervals 0 and 1: it must stay, though both its
        # endpoints are region eids
        reg = [np.array([1, 2, 3]), np.array([4, 5, 6])]
        b = pk((0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 6), (6, 9))
        ab = pk((1, 3), (2, 3), (4, 6))
        return b, pk((3, 4), (5, 6)), ab, pk((4, 6)), reg, \
            [np.zeros(3, np.int64), np.ones(3, np.int64)], False, \
            pk((0, 1), (1, 3), (2, 3), (3, 4), (4, 6), (6, 9))
    top = 2 ** 32 - 1
    if case == "top_eid":
        reg = [np.array([5, top - 1, top])]
        b = pk((0, top), (5, top - 1), (5, top), (top - 1, top), (1, 2))
        ab = pk((5, top), (top - 1, top))
        return b, b, ab, pk((top - 1, top)), reg, [np.zeros(3, np.int64)], \
            False, pk((0, top), (1, 2), (5, top), (top - 1, top))
    assert case == "after_present"
    # (2, 9) and (5, 9) are maintained and lie outside the region, yet
    # the after-pairs carry them
    reg = [np.array([2, 5])]
    b = pk((2, 5), (2, 9), (5, 9), (9, 11))
    ab = pk((2, 5), (2, 9), (5, 9))
    return b, pk((2, 9)), ab, pk((2, 9), (5, 9)), reg, \
        [np.zeros(2, np.int64)], False, b


EDIT_CASES = ["inserts", "deletes", "degraded", "no_regions",
              "two_intervals", "top_eid", "after_present"]


@pytest.mark.parametrize("case", EDIT_CASES)
def test_edit_equals_the_whole_set_formula(case):
    """``DeltaMatcher._apply``'s edit (lookups by each region eid's slice
    of the sorted sets, then one splice) leaves the sets and the
    ``DeltaStats`` the whole-set diffs and unions leave, bit for bit."""
    from repro_torch.serve.delta import DeltaMatcher
    b, m, ab, am, reg, ivs, degraded, want = _edit_case(case)
    dm = DeltaMatcher(TA.ERConfig(**_kw()), SortedIndex(W), device="cpu")
    dm._device_pairs = lambda regions: (ab, am, len(regions), ((2, 64),))
    dm._host_pairs = lambda regions: ab
    nb, nm, st = dm._apply(b, m, reg, reg, ivs, 7, degraded=degraded,
                           comp_ranges=((1, 2),))
    ref = _edit_reference(b, m, ab, am, reg, ivs, degraded)
    got = (nb, nm, st.added_blocked, st.removed_blocked, st.added_matched,
           st.removed_matched)
    for name, g, r in zip(("blocked", "matched", "added_blocked",
                           "removed_blocked", "added_matched",
                           "removed_matched"), got, ref):
        assert g.dtype == r.dtype == TR.PACKED_DTYPE and \
            np.array_equal(g, r), name
    assert np.array_equal(nb, want)
    assert nb.size == np.unique(nb).size and nm.size == np.unique(nm).size
    calls = 0 if degraded else len(reg)
    assert st == st._replace(
        batch=7, regions=len(reg), region_rows=sum(r.size for r in reg),
        device_calls=calls, shapes=() if degraded else ((2, 64),),
        degraded=degraded, comp_ranges=((1, 2),))
    if case in ("inserts", "deletes"):
        assert st.added_blocked.size and st.removed_blocked.size


@pytest.mark.parametrize("variant", ["repsn", "srp"])
def test_published_edit_is_the_served_sets_diff(corpus, variant):
    """Each ``IncrementalResult``'s four sets equal the diff of the served
    sets snapshotted before and after its batch, over mixed inserts and
    deletes; a boundary-complete variant publishes the batch's edit (no
    whole-set diff), SRP diffs once a batch."""
    svc = TA.serve(TA.ERConfig(**_kw(variant=variant, trace=True)),
                   initial=_take(corpus, slice(0, 260)), start=False,
                   device="cpu")
    eid = corpus["eid"]
    for kind, arg in [("insert", slice(260, 300)), ("delete", eid[40:44]),
                      ("insert", slice(300, 302)), ("delete", eid[[0, 7]]),
                      ("delete", eid[100:160]), ("insert", slice(302, 390)),
                      ("insert", slice(100, 130))]:
        b0, m0 = svc.packed_pairs, svc.packed_matches
        res = svc.resolve_incremental(_take(corpus, arg)) \
            if kind == "insert" else svc.delete(arg)
        b1, m1 = svc.packed_pairs, svc.packed_matches
        for got, (a, b) in [(res.new_pairs, (b1, b0)),
                            (res.retired_pairs, (b0, b1)),
                            (res.new_matches, (m1, m0)),
                            (res.retired_matches, (m0, m1))]:
            assert got == TR.packed_to_frozenset(np.setdiff1d(a, b))
        assert set(res.pair_ids) == res.new_pairs
    st = svc.stats()
    fulls = svc.trace_report().registry["publish_full_diffs"]["value"]
    assert fulls == (st.batches if variant == "srp" else 0)
    assert st.batches == 8
    svc.close()
