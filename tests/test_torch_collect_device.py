"""Collection on the device (``VariantBase.collect_device`` and
``runners._device_outcome_packed``) against the host twin it replaced.

The emitted pairs of a runner output are packed, unioned over the
variant's parts, sorted and deduplicated where the output lives, and only
the two sets and one vector of counters are copied to the host.  Held
here, bit for bit, to ``variant.collect(_to_host(out))`` and to the host
accounting of every ``PackedOutcome`` field: each variant under both
emit modes, JobSN's two parts emitting the same pair, an empty output, a
prefix cut that differs by shard, and on the card (``gpu``).  Then the
counters: ``transfer_bytes`` counts the bytes copied, and
``device_collections`` one per collection.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import cuda  # noqa: E402,F401
from repro_torch import api as TA  # noqa: E402
from repro_torch import obs as OBS  # noqa: E402
from repro_torch.api import results as RES  # noqa: E402
from repro_torch.api import runners as RN  # noqa: E402
from repro_torch.core import entities as E  # noqa: E402
from repro_torch.core import partition as P  # noqa: E402

N, R, WIN, NK = 240, 4, 6, 64
VARIANTS = ["srp", "repsn", "jobsn"]


@pytest.fixture(scope="module")
def host():
    return E.synth_arrays(np.random.default_rng(11), N, n_keys=NK,
                          dup_frac=0.25, text_len=12)


@pytest.fixture(scope="module")
def bounds(host):
    return np.asarray(P.balanced_partition(host["key"], R), np.int32)


def _cfg(variant, **kw):
    kw.setdefault("emit", "pairs")
    return TA.ERConfig(window=WIN, num_shards=R, hops=R - 1,
                       variant=variant, band_engine="pallas", cand_cap=256,
                       **kw)


def _host_outcome(out: dict, cfg, r: int) -> RN.PackedOutcome:
    """The host collection the device one replaced: every tensor copied,
    then ``collect`` and the counters summed in numpy."""
    variant = TA.get_variant(cfg.variant)
    out = RN._to_host(out)
    col = variant.collect(out)
    cand_count = np.zeros(r, np.int64)
    cand_overflow = matcher_evals = pair_overflow = pruned = 0
    for p in variant.parts:
        if p in out:
            q = out[p]
            cand_count += np.asarray(q["cand_count"], np.int64)
            cand_overflow += int(q["cand_overflow"].sum())
            matcher_evals += int(np.asarray(q["matcher_evals"],
                                            np.int64).sum())
            if "pruned" in q:
                pruned += int(q["pruned"].sum())
            if "mask_overflow" in q:
                pair_overflow += int(q["mask_overflow"].sum()) + \
                    int(q["match_overflow"].sum())
    return RN.PackedOutcome(
        blocked=col.blocked, matched=col.matched,
        load=tuple(int(x) for x in out["load"][0]),
        overflow=int(out["overflow"][0]), num_shards=r,
        cand_count=tuple(int(c) for c in cand_count),
        cand_overflow=cand_overflow, matcher_evals=matcher_evals,
        pair_overflow=pair_overflow, pruned=pruned)


def _assert_same_outcome(want: RN.PackedOutcome, got: RN.PackedOutcome):
    for name in RN.PackedOutcome._fields:
        a, b = getattr(want, name), getattr(got, name)
        if name in ("blocked", "matched"):
            assert b.dtype == RES.PACKED_DTYPE and b.ndim == 1, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b and type(a) is type(b), f"{name}: {a} vs {b}"


@pytest.mark.parametrize("emit", ["pairs", "band"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_device_collection_equals_host(host, bounds, variant, emit):
    cfg = _cfg(variant, emit=emit)
    out = TA.VmapRunner(R, device="cpu").run_raw(E.from_numpy(host, "cpu"),
                                                 bounds, cfg)
    want = _host_outcome(out, cfg, R)
    col = TA.get_variant(variant).collect_device(out)
    np.testing.assert_array_equal(col.blocked, want.blocked)
    np.testing.assert_array_equal(col.matched, want.matched)
    _assert_same_outcome(want, RN._device_outcome_packed(out, cfg, R))
    assert want.blocked.size > 0 and want.matched.size > 0


def test_pair_overflow_counted_alike(host, bounds):
    """A pair cap below the band's pairs: the dropped slots are counted
    the same, and the kept pairs are the same."""
    cfg = _cfg("jobsn", pair_cap=24)
    out = TA.VmapRunner(R, device="cpu").run_raw(E.from_numpy(host, "cpu"),
                                                 bounds, cfg)
    want = _host_outcome(out, cfg, R)
    assert want.pair_overflow > 0
    _assert_same_outcome(want, RN._device_outcome_packed(out, cfg, R))


# -- hand-made outputs: repeats across parts, empty, uneven prefixes ---------

def _part(eid, pairs, cap, junk=()):
    """One part of an emit="pairs" output: ``pairs[s]`` lists shard s's
    (i, d) slots, emitted in that order as flat index (d-1)*M+i; ``junk``
    fills the slots past each shard's count with indices that would pair
    real eids, so a collection that reads past ``_n`` shows it."""
    r, m = eid.shape
    idx = np.zeros((r, cap), np.int32)
    n = np.zeros(r, np.int32)
    for s, slots in enumerate(pairs):
        flat = [(d - 1) * m + i for i, d in slots]
        idx[s, :len(flat)] = flat
        fill = [(d - 1) * m + i for i, d in junk][:cap - len(flat)]
        idx[s, len(flat):len(flat) + len(fill)] = fill
        n[s] = len(flat)
    zero = np.zeros(r, np.int32)
    t = torch.from_numpy
    return {"eid": t(eid), "mask_idx": t(idx), "mask_n": t(n),
            "mask_overflow": t(zero), "match_idx": t(idx.copy()),
            "match_n": t(np.minimum(n, 1)), "match_overflow": t(zero),
            "cand_count": t(n.copy()), "cand_overflow": t(zero),
            "matcher_evals": t(n.copy()), "halo_len": 0}


def _output(parts: dict, r: int) -> dict:
    load = np.full((r, r), 5, np.int32)
    load[0] = np.arange(r) + 3
    return {"overflow": torch.zeros(r, dtype=torch.int32),
            "load": torch.from_numpy(load), **parts}


def test_jobsn_parts_emitting_one_pair_count_it_once():
    """The boundary part emits pairs the main part emitted too (and one
    twice itself): each pair is in the sets once, as in ``collect``."""
    eid = np.array([[7, 3, 9, 1, 12, 4], [20, 2, 18, 30, 11, 5]], np.int32)
    main = _part(eid, [[(0, 1), (1, 1), (2, 2)], [(0, 1), (3, 2)]], 8)
    # shard 0: (0, 1) again (3-7) twice, then (1, 2): 3-1; shard 1: (3, 2)
    # again (5-30), then (1, 4): 2-5
    boundary = _part(eid, [[(0, 1), (1, 2), (0, 1)], [(3, 2), (1, 4)]], 8)
    out = _output({"main": main, "boundary": boundary}, 2)
    cfg = _cfg("jobsn")
    got = TA.get_variant("jobsn").collect_device(out)
    want = _host_outcome(out, cfg, 2)
    np.testing.assert_array_equal(got.blocked, want.blocked)
    np.testing.assert_array_equal(got.matched, want.matched)
    assert RES.unpack_pairs(got.blocked)[0].tolist() == [1, 2, 2, 3, 3, 5, 9]
    assert got.blocked.size == 7 < 10          # 10 slots emitted in all
    _assert_same_outcome(want, RN._device_outcome_packed(out, cfg, 2))


def test_empty_output_gives_empty_sets():
    eid = np.arange(12, dtype=np.int32).reshape(2, 6)
    out = _output({"main": _part(eid, [[], []], 4, junk=[(0, 1)])}, 2)
    cfg = _cfg("repsn")
    po = RN._device_outcome_packed(out, cfg, 2)
    for s in (po.blocked, po.matched):
        assert s.shape == (0,) and s.dtype == RES.PACKED_DTYPE
    _assert_same_outcome(_host_outcome(out, cfg, 2), po)


def test_prefix_cut_differs_by_shard():
    """Shards emit 3, 1 and 0 pairs under one capacity of 6; the slots
    past each count hold junk indices that must not be read."""
    eid = np.array([[4, 8, 15, 16, 23, 42], [1, 2, 3, 5, 7, 11],
                    [50, 51, 52, 53, 54, 55]], np.int32)
    junk = [(2, 3), (4, 1), (0, 5)]
    out = _output({"main": _part(eid, [[(0, 1), (1, 2), (3, 1)], [(2, 3)],
                                       []], 6, junk=junk)}, 3)
    assert out["main"]["mask_n"].tolist() == [3, 1, 0]
    cfg = _cfg("srp")
    po = RN._device_outcome_packed(out, cfg, 3)
    _assert_same_outcome(_host_outcome(out, cfg, 3), po)
    pairs = lambda a: [tuple(p) for p in
                       np.stack(RES.unpack_pairs(a), 1).tolist()]
    assert pairs(po.blocked) == [(3, 11), (4, 8), (8, 16), (16, 23)]
    assert pairs(po.matched) == [(3, 11), (4, 8)]


@pytest.mark.gpu
@pytest.mark.parametrize("variant", VARIANTS)
def test_device_collection_on_the_card(host, bounds, cuda, variant):
    cfg = _cfg(variant)
    out = TA.VmapRunner(R, device=cuda).run_raw(E.from_numpy(host, cuda),
                                                bounds, cfg)
    _assert_same_outcome(_host_outcome(out, cfg, R),
                         RN._device_outcome_packed(out, cfg, R))


# -- the counters --------------------------------------------------------------

@pytest.mark.parametrize("variant", VARIANTS)
def test_transfer_bytes_count_the_copies(host, bounds, variant):
    cfg = _cfg(variant)
    runner = TA.VmapRunner(R, device="cpu")
    ents = E.from_numpy(host, "cpu")
    vec, layout = RN._counters(runner.run_raw(ents, bounds, cfg),
                               TA.get_variant(variant))
    tracer = OBS.Tracer()
    with OBS.activate(tracer):
        po = runner.resolve_packed(ents, bounds, cfg)
    want = po.blocked.nbytes + po.matched.nbytes + vec.nbytes
    reg = tracer.metrics.to_dict()
    assert reg["transfer_bytes"]["value"] == want
    (span,) = [s for s in tracer.spans() if s.name == "collect"]
    assert span.attrs["transfer_bytes"] == want
    assert span.attrs["load"] == po.load
    # load (R), overflow (1), then every part's R-shard counters
    parts = 2 if variant == "jobsn" else 1
    assert layout == [("load", R), ("overflow", 1)] + \
        [(k, R) for k in RN._PART_COUNTERS] * parts
    assert vec.numel() == R + 1 + 6 * R * parts
    assert reg["device_collections"]["value"] == 1


def test_device_collections_one_per_resolve(host, bounds):
    runner = TA.VmapRunner(R, device="cpu")
    ents = E.from_numpy(host, "cpu")
    tracer = OBS.Tracer()
    with OBS.activate(tracer):
        for k in range(1, 4):
            runner.resolve_packed(ents, bounds, _cfg("repsn"))
            assert tracer.metrics.to_dict()["device_collections"] == \
                {"type": "counter", "value": k}
    res = TA.resolve(ents, _cfg("jobsn", trace=True), device="cpu")
    assert res.trace.registry["device_collections"]["value"] == 1
    seq = TA.resolve(ents, _cfg("repsn", trace=True, runner="sequential"),
                     device="cpu")
    assert "device_collections" not in seq.trace.registry
