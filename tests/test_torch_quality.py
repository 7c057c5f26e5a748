"""Multi-pass blocking, adaptive windows and the quality harness: the port
against the reference, mirroring ``tests/test_quality.py``.

  * ``labeled_corpus`` and ``zipf_entities`` are bit-identical by seed;
  * ``derive_sort_key`` (identity, prefix, word) and the key helpers agree,
    and so do their errors;
  * ``weff_for_keys``, ``evaluate`` and ``attach`` agree;
  * ``MultiPassResult`` is equal per pass and in the union, metrics
    included, for ``resolve`` and ``link``;
  * adaptive runs, with and without evidence pruning, are equal, metrics
    included, across 3 variants x {scan, pallas}, and sequential."""
import dataclasses

import jax  # noqa: F401  (the reference; JAX_PLATFORMS=cpu)
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as RA  # noqa: E402
from repro import balance as RB  # noqa: E402
from repro import quality as RQ  # noqa: E402
from repro.core import entities as RE  # noqa: E402
from repro.core import keys as RK  # noqa: E402
from repro.data.corpus import zipf_entities as ref_zipf  # noqa: E402
from repro.data.truth import labeled_corpus as ref_labeled  # noqa: E402
from repro_torch import api as TA  # noqa: E402
from repro_torch import balance as TB  # noqa: E402
from repro_torch import quality as TQ  # noqa: E402
from repro_torch.core import entities as TE  # noqa: E402
from repro_torch.core import keys as TK  # noqa: E402
from repro_torch.data import labeled_corpus, zipf_entities  # noqa: E402

from _torch_parity import assert_same_result, port_ents  # noqa: E402

R = 4
WBASE, WMID, WMAX = 4, 8, 12
THR = 0.55
PASSES = (dict(name="key"), dict(name="alt", source="alt"))


def _kw(**kw):
    kw.setdefault("window", WBASE)
    kw.setdefault("num_shards", R)
    kw.setdefault("variant", "repsn")
    kw.setdefault("hops", R - 1)
    return kw


def _adaptive(**kw):
    kw.setdefault("window_policy", "adaptive")
    kw.setdefault("window_max", WMAX)
    return _kw(**kw)


@pytest.fixture(scope="module")
def dirty():
    return (ref_labeled(1, 600, max_cluster=WMAX, typo_rate=0.12),
            labeled_corpus(1, 600, max_cluster=WMAX, typo_rate=0.12))


def assert_same_ents(ref_ents, port_ents_) -> None:
    """Every array of a port entity dict equals the reference's, dtype
    included (signatures compared as the reference's uint32)."""
    host = TE.to_numpy(port_ents_)
    for k in ("key", "eid", "valid"):
        a = np.asarray(ref_ents[k])
        assert a.dtype == host[k].dtype, k
        np.testing.assert_array_equal(a, host[k], err_msg=k)
    assert set(ref_ents["payload"]) == set(host["payload"])
    for k, v in ref_ents["payload"].items():
        a = np.asarray(v)
        assert a.dtype == host["payload"][k].dtype, k
        np.testing.assert_array_equal(a, host["payload"][k], err_msg=k)


def assert_same_metrics(ref, port) -> None:
    if ref is None:
        assert port is None
        return
    for f in ("reduction_ratio", "pairs_completeness", "oracle_pairs",
              "total_comparisons"):
        assert getattr(port, f) == getattr(ref, f), f
    for f in ("balance", "quality"):
        a, b = getattr(ref, f), getattr(port, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert dataclasses.astuple(a) == dataclasses.astuple(b), f


# -- generators ---------------------------------------------------------------

LABELED = [(3, 500, dict(max_cluster=10, typo_rate=0.2)),
           (0, 600, dict(max_cluster=12)),
           (5, 257, dict(max_cluster=6, size_skew=0.5, cluster_rate=0.6,
                         typo_rate=0.3, feat_dim=8, sig_words=3)),
           (2, 7, dict(max_cluster=12))]      # room < max_cluster


@pytest.mark.parametrize("seed,n,kw", LABELED,
                         ids=[f"s{s}n{n}" for s, n, _ in LABELED])
def test_labeled_corpus_bit_identical(seed, n, kw):
    ref = ref_labeled(seed, n, **kw)
    port = labeled_corpus(seed, n, **kw)
    assert_same_ents(ref.ents, port.ents)
    assert port.gold == ref.gold
    assert port.gold_packed.dtype == ref.gold_packed.dtype
    np.testing.assert_array_equal(port.gold_packed, ref.gold_packed)
    for f in ("n", "n_units", "max_cluster", "max_block", "n_typos"):
        assert getattr(port, f) == getattr(ref, f), f
    assert port.ents["key"].device.type == "cpu"


def test_labeled_corpus_validation_matches_reference():
    for kw in (dict(max_cluster=1), dict(typo_rate=1.0)):
        with pytest.raises(ValueError) as ref_err:
            ref_labeled(0, 100, **kw)
        with pytest.raises(ValueError) as port_err:
            labeled_corpus(0, 100, **kw)
        assert str(port_err.value) == str(ref_err.value)


ZIPF = [(7, 1400, dict(n_clusters=64, exponent=1.1, dup_frac=0.25)),
        (3, 900, dict(n_clusters=40, exponent=2.2, dup_frac=0.0)),
        (1, 500, dict(n_clusters=16, exponent=0.0, cluster_width=3,
                      shuffle_clusters=True, feat_dim=4, sig_words=2))]


@pytest.mark.parametrize("seed,n,kw", ZIPF,
                         ids=[f"s{s}n{n}" for s, n, _ in ZIPF])
def test_zipf_entities_bit_identical(seed, n, kw):
    assert_same_ents(ref_zipf(seed, n, **kw), zipf_entities(seed, n, **kw))


# -- sort keys ----------------------------------------------------------------

@pytest.fixture(scope="module")
def keyed():
    """A corpus with every field kind a sort key can read: the int32 key,
    an int32 ``alt``, padded ``text`` bytes with upper case and digits,
    and uint32 signatures (high bits set)."""
    rng = np.random.default_rng(9)
    ents = RE.synth_entities(rng, 300, n_keys=50, text_len=6)
    chars = np.frombuffer(b"abcXYZ019 -_", np.uint8)
    payload = {k: np.asarray(v) for k, v in ents["payload"].items()}
    payload["text"] = chars[rng.integers(0, chars.size, size=(300, 6))]
    payload["alt"] = rng.integers(0, 2**31 - 1, size=300).astype(np.int32)
    return RE.make_entities(np.asarray(ents["key"]), np.asarray(ents["eid"]),
                            payload={k: jnp.asarray(v)
                                     for k, v in payload.items()})


SPECS = [dict(name="key"), dict(name="alt", source="alt"),
         dict(name="p0", source="text", kind="prefix", width=2),
         dict(name="p3", source="text", kind="prefix", offset=1, width=5),
         dict(name="w0", source="sig", kind="word", index=0),
         dict(name="w7", source="sig", kind="word", index=7)]


@pytest.mark.parametrize("spec", SPECS, ids=[s["name"] for s in SPECS])
def test_derive_sort_key_equals_reference(keyed, spec):
    ref = np.asarray(RK.derive_sort_key(keyed, RA.SortKeySpec(**spec)))
    port = TK.derive_sort_key(port_ents(keyed), TA.SortKeySpec(**spec))
    assert port.dtype == torch.int32
    np.testing.assert_array_equal(port.numpy(), ref)
    assert (ref >= 0).all() and (ref <= TK.KEY_MASK).all()


BAD_SPECS = [dict(name="x", source="sig"),
             dict(name="x", source="text", kind="prefix", offset=3, width=4),
             dict(name="x", source="feat", kind="word", index=32),
             dict(name="x", source="alt", kind="word"),
             dict(name="x", source="nope", kind="prefix")]


@pytest.mark.parametrize("spec", BAD_SPECS,
                         ids=["identity_2d", "prefix_short", "word_index",
                              "word_1d", "missing_field"])
def test_derive_sort_key_errors_equal_reference(keyed, spec):
    with pytest.raises((ValueError, KeyError)) as ref_err:
        RK.derive_sort_key(keyed, RA.SortKeySpec(**spec))
    with pytest.raises((ValueError, KeyError)) as port_err:
        TK.derive_sort_key(port_ents(keyed), TA.SortKeySpec(**spec))
    assert type(port_err.value) is type(ref_err.value)
    assert str(port_err.value) == str(ref_err.value)


def test_key_helpers_equal_reference(keyed):
    text = np.array(keyed["payload"]["text"])          # a writable copy
    all_bytes = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(
        TK.char_code(torch.from_numpy(all_bytes)).numpy(),
        np.asarray(RK.char_code(jnp.asarray(all_bytes))))
    for k in range(1, 6):
        np.testing.assert_array_equal(
            TK.prefix_key(torch.from_numpy(text), k).numpy(),
            np.asarray(RK.prefix_key(jnp.asarray(text), k)))
        assert TK.key_range(k) == RK.key_range(k)
    for got, want in zip(TK.multipass_keys(torch.from_numpy(text), 3, 2),
                         RK.multipass_keys(jnp.asarray(text), 3, 2)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert TK.KEY_MASK == RK.KEY_MASK
    with pytest.raises(ValueError, match="overflows int32"):
        TK.prefix_key(torch.from_numpy(text), 6)


# -- quality helpers ----------------------------------------------------------

def test_weff_for_keys_equals_reference(dirty):
    ref_tc, _ = dirty
    keys = np.asarray(ref_tc.ents["key"])
    probe = np.concatenate([keys, [0, 1, 2**30 - 1]])    # absent keys too
    for window, wmax in ((4, 12), (2, 3), (8, 8)):
        want = RQ.weff_for_keys(probe, RB.profile_keys(keys, window=window),
                                window, wmax)
        got = TQ.weff_for_keys(probe, TB.profile_keys(keys, window=window),
                               window, wmax)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert (TQ.weff_for_keys(probe, TB.KeyProfile.empty(4), 4, 12) == 4).all()


def test_evaluate_and_attach_equal_reference(dirty):
    ref_tc, port_tc = dirty
    gold = [(0, 1), (0, 2), (1, 2), (3, 4), (3, 5), (4, 5)]
    blocked = [(0, 1), (0, 2), (1, 2), (3, 4), (6, 7), (6, 8), (7, 8),
               (0, 9), (1, 9), (2, 9)]
    packed = np.asarray([(a << 32) | b for a, b in blocked], np.uint64)
    for b_arg, g_arg, total in ((packed, set(gold), 45),
                                (set(blocked), frozenset(gold), 45),
                                (packed[::-1].copy(), set(gold), 0)):
        want = RQ.evaluate(b_arg, g_arg, total)
        got = TQ.evaluate(b_arg, g_arg, total)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
    with pytest.raises(ValueError, match="total_comparisons"):
        TQ.evaluate(packed, set(gold))
    kw = _kw(window=WMID, band_engine="pallas")
    ref = RA.resolve(ref_tc.ents, RA.ERConfig(**kw))
    port = TA.resolve(port_tc.ents, TA.ERConfig(**kw), device="cpu")
    assert_same_result(ref, port)
    for with_metrics in (False, True):
        if with_metrics:
            ref = RA.resolve(ref_tc.ents, RA.ERConfig(**kw,
                                                      compute_metrics=True))
            port = TA.resolve(port_tc.ents, TA.ERConfig(
                **kw, compute_metrics=True), device="cpu")
        a, b = RQ.attach(ref, ref_tc), TQ.attach(port, port_tc)
        assert_same_metrics(a.metrics, b.metrics)
        assert b.metrics.quality.gold_pairs == len(port_tc.gold)


# -- multi-pass ---------------------------------------------------------------

def _passes(pkg):
    return tuple(pkg.SortKeySpec(**p) for p in PASSES)


def assert_same_multipass(ref, port) -> None:
    assert isinstance(port, TA.MultiPassResult)
    assert port.pass_names == ref.pass_names
    for a, b in zip(ref.passes, port.passes):
        assert_same_result(a, b)
        assert_same_metrics(a.metrics, b.metrics)
        assert b.resilience == a.resilience
        if a.balance is not None:
            assert dataclasses.astuple(b.balance) == \
                dataclasses.astuple(a.balance)
    assert port.blocking.pairs == ref.blocking.pairs
    assert port.matches == ref.matches
    for f in ("overflow", "cand_overflow", "pair_overflow", "matcher_evals",
              "pruned", "load", "num_shards", "runner", "window"):
        assert getattr(port.blocking, f) == getattr(ref.blocking, f), f
    assert_same_metrics(ref.metrics, port.metrics)
    assert port.resilience == ref.resilience


MP_GRID = [(v, e) for v in ("srp", "repsn", "jobsn")
           for e in ("scan", "pallas")]


@pytest.mark.parametrize("variant,engine", MP_GRID,
                         ids=["-".join(g) for g in MP_GRID])
def test_multipass_resolve_equal_reference(dirty, variant, engine):
    ref_tc, port_tc = dirty
    kw = _kw(window=WMAX, variant=variant, band_engine=engine,
             compute_metrics=True, emit="pairs")
    ref = RA.resolve(ref_tc.ents, RA.ERConfig(**kw, passes=_passes(RA)))
    port = TA.resolve(port_tc.ents, TA.ERConfig(**kw, passes=_passes(TA)),
                      device="cpu")
    assert_same_multipass(ref, port)
    alt = port.pass_result("alt").blocking.pairs
    assert port.blocking.pairs == port.pass_result("key").blocking.pairs | alt
    # the alt pass wins back typo-split cluster pairs
    assert TQ.evaluate(port, port_tc).pairs_completeness > \
        TQ.evaluate(port.pass_result("key"), port_tc).pairs_completeness
    with pytest.raises(KeyError, match="no pass named"):
        port.pass_result("nope")


def test_multipass_adaptive_sequential_equal_reference(dirty):
    ref_tc, port_tc = dirty
    kw = _adaptive(runner="sequential", compute_metrics=True)
    ref = RA.resolve(ref_tc.ents, RA.ERConfig(**kw, passes=_passes(RA)))
    port = TA.resolve(port_tc.ents, TA.ERConfig(**kw, passes=_passes(TA)),
                      device="cpu")
    assert_same_multipass(ref, port)


def test_multipass_rejects_explicit_bounds(dirty):
    _, port_tc = dirty
    with pytest.raises(ValueError, match="explicit bounds"):
        TA.resolve(port_tc.ents, TA.ERConfig(**_kw(passes=_passes(TA))),
                   bounds=np.asarray([1, 2, 3], np.int32), device="cpu")


@pytest.mark.parametrize("variant", ["srp", "repsn", "jobsn"])
def test_multipass_link_equal_reference(variant):
    rng = np.random.default_rng(5)
    lhs = RE.synth_entities(rng, 120, n_keys=30, dup_frac=0.0, text_len=8)
    take = rng.permutation(120)[:50]
    rhs = RE.make_entities(
        np.asarray(lhs["key"])[take], np.arange(50, dtype=np.int32),
        payload={k: np.asarray(v)[take] for k, v in lhs["payload"].items()})
    passes = (dict(name="key"),
              dict(name="t1", source="text", kind="prefix", offset=1))
    kw = _kw(window=4, variant=variant, band_engine="pallas", emit="pairs",
             compute_metrics=True)
    ref = RA.link(lhs, rhs, RA.ERConfig(**kw, passes=tuple(
        RA.SortKeySpec(**p) for p in passes)))
    port = TA.link(port_ents(lhs), port_ents(rhs), TA.ERConfig(
        **kw, passes=tuple(TA.SortKeySpec(**p) for p in passes)),
        device="cpu")
    assert_same_multipass(ref, port)
    assert port.matches


# -- adaptive windows ---------------------------------------------------------

AD_GRID = [(v, e, p) for v in ("srp", "repsn", "jobsn")
           for e in ("scan", "pallas") for p in ("off", "evidence")]


@pytest.mark.parametrize("variant,engine,prune", AD_GRID,
                         ids=["-".join(g) for g in AD_GRID])
def test_adaptive_resolve_equal_reference(dirty, variant, engine, prune):
    ref_tc, port_tc = dirty
    kw = _adaptive(variant=variant, band_engine=engine, emit="pairs",
                   compute_metrics=True)
    if prune == "evidence":
        kw.update(prune_policy="evidence", prune_threshold=THR)
    ref = RA.resolve(ref_tc.ents, RA.ERConfig(**kw))
    port = TA.resolve(port_tc.ents, TA.ERConfig(**kw), device="cpu")
    assert_same_result(ref, port)
    assert_same_metrics(ref.metrics, port.metrics)
    assert port.blocking.window == WMAX
    if prune == "evidence":
        assert port.blocking.pruned > 0
    a, b = RQ.attach(ref, ref_tc), TQ.attach(port, port_tc)
    assert_same_metrics(a.metrics, b.metrics)


@pytest.mark.parametrize("prune", ["off", "evidence"])
def test_adaptive_sequential_equal_reference_and_device(dirty, prune):
    ref_tc, port_tc = dirty
    kw = _adaptive(compute_metrics=True)
    if prune == "evidence":
        kw.update(prune_policy="evidence", prune_threshold=THR)
    ref = RA.resolve(ref_tc.ents, RA.ERConfig(**kw, runner="sequential"))
    seq = TA.resolve(port_tc.ents, TA.ERConfig(**kw, runner="sequential"),
                     device="cpu")
    dev = TA.resolve(port_tc.ents, TA.ERConfig(**kw), device="cpu")
    assert_same_result(ref, seq)
    assert_same_metrics(ref.metrics, seq.metrics)
    assert dev.blocking.pairs == seq.blocking.pairs
    assert dev.matches == seq.matches
    assert dev.blocking.pruned == seq.blocking.pruned


def test_adaptive_pc_geq_fixed_at_better_rr(dirty):
    """README's frontier on the port: adaptive (4 grown to block density,
    cap 12) reaches PC >= fixed w=8 with RR >= fixed w=8."""
    _, port_tc = dirty
    clean = labeled_corpus(0, 600, max_cluster=WMAX)
    fixed = TQ.evaluate(TA.resolve(clean.ents, TA.ERConfig(**_kw(
        window=WMID, band_engine="pallas")), device="cpu"), clean)
    adapt = TQ.evaluate(TA.resolve(clean.ents, TA.ERConfig(**_adaptive(
        band_engine="pallas")), device="cpu"), clean)
    assert adapt.reduction_ratio >= fixed.reduction_ratio
    assert adapt.pairs_completeness == 1.0 > fixed.pairs_completeness


def test_adaptive_weff_rides_the_payload_as_int32(dirty):
    """The rewrite attaches ``_weff`` as an int32 tensor on the entities'
    device and compiles the band at window_max."""
    from repro_torch.api.facade import _adaptive_rewrite
    _, port_tc = dirty
    cfg = TA.ERConfig(**_adaptive())
    ents, run_cfg = _adaptive_rewrite(port_tc.ents, cfg)
    weff = ents["payload"]["_weff"]
    assert weff.dtype == torch.int32
    assert weff.device == port_tc.ents["key"].device
    assert run_cfg.window == WMAX and run_cfg.window_policy == "adaptive"
    assert int(weff.min()) >= WBASE and int(weff.max()) == WMAX
    assert "_weff" not in port_tc.ents["payload"]          # not mutated


def test_pairs_from_band_equals_reference():
    from repro.api.results import pairs_from_band as ref_pairs
    rng = np.random.default_rng(3)
    eid = np.stack([rng.permutation(40) + 40 * s for s in range(3)])
    band = rng.random((3, 5, 40)) < 0.3
    band &= (np.arange(40)[None, None, :] + np.arange(1, 6)[None, :, None]
             < 40)
    part = {"ents": {"eid": eid.astype(np.int32)}, "match": band}
    got = TA.pairs_from_band(part)
    assert got == ref_pairs(part) and len(got) == int(band.sum())
    assert TA.pairs_from_band(dict(part, match=np.zeros_like(band))) == set()
