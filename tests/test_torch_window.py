"""Port parity for the window band (``repro_torch.core.window``): the band
engines' per-part outputs and the cumsum compaction primitives, against
the JAX reference on the CPU.  The port works on stacked shards (leading
dim r); the reference is applied shard by shard."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as RA  # noqa: E402
from repro.core import entities as RE  # noqa: E402
from repro.core import window as RW  # noqa: E402
from repro_torch import api as TA  # noqa: E402
from repro_torch.core import entities as TE  # noqa: E402
from repro_torch.core import window as TW  # noqa: E402

from _torch_parity import paper_cascades, to_np  # noqa: E402

PART_FIELDS = ("mask", "match", "matcher_evals", "cand_count",
               "cand_overflow", "pruned")


def _sorted_shards(seed, r, m, n_keys, *, text_len=8, invalid=0.2):
    """r sorted shards of m slots (some invalid), as reference per-shard
    dicts and one stacked port dict."""
    rng = np.random.default_rng(seed)
    ref_shards = []
    for s in range(r):
        e = RE.synth_entities(rng, m, n_keys=n_keys, dup_frac=0.4,
                              text_len=text_len)
        valid = rng.random(m) >= invalid
        e = RE.make_entities(e["key"], e["eid"] + s * m,
                             payload=e["payload"], valid=valid)
        ref_shards.append(RE.sort_entities(e))
    stacked = [TE.from_numpy(e, "cpu") for e in ref_shards]
    port = {f: torch.stack([e[f] for e in stacked])
            for f in ("key", "eid", "valid")}
    port["payload"] = {k: torch.stack([e["payload"][k] for e in stacked])
                       for k in stacked[0]["payload"]}
    return ref_shards, port


CASES = [
    # id, engine, halo_len, mode, cfg kwargs
    ("scan-all", "scan", 0, "all", {}),
    ("scan-native", "scan", 4, "native", {}),
    ("pallas-native", "pallas", 4, "native", {}),
    ("pallas-cross", "pallas", 4, "cross", {}),
    ("pallas-capped", "pallas", 0, "all", {"cand_cap": 6}),
    ("pallas-prune", "pallas", 0, "all",
     {"prune_policy": "evidence", "prune_threshold": 0.6}),
    ("scan-prune", "scan", 0, "all",
     {"prune_policy": "evidence", "prune_threshold": 0.6}),
    ("pallas-scores", "pallas", 0, "all", {"return_scores": True}),
]


@pytest.mark.parametrize("engine,halo_len,mode,kw",
                         [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_engine_parts_equal_reference(engine, halo_len, mode, kw):
    ref_m, port_m = paper_cascades()
    base = dict(window=5, band_engine=engine, **kw)
    ref_cfg = RA.ERConfig(matcher=ref_m, **base)
    port_cfg = TA.ERConfig(matcher=port_m, **base)
    ref_shards, port = _sorted_shards(4, 3, 40, 12)
    got = TW.get_band_engine(engine).band(port, port_cfg, halo_len=halo_len,
                                          mode=mode)
    for s, e in enumerate(ref_shards):
        want = RW.get_band_engine(engine).band(e, ref_cfg, halo_len=halo_len,
                                               mode=mode)
        fields = PART_FIELDS + (("scores",) if "return_scores" in kw else ())
        for f in fields:
            np.testing.assert_allclose(
                to_np(got[f][s]), np.asarray(want[f]), rtol=1e-6, atol=1e-7,
                err_msg=f"shard {s} field {f}")
    if engine == "pallas":
        assert int(got["cand_count"].sum()) > 0


@pytest.mark.parametrize("halo_len,mode", [(0, "all"), (4, "native")])
def test_band_matches_equal_reference(halo_len, mode):
    """``band_matches``: the scored band thresholded, on a seeded band of
    3 shards, against the reference shard by shard."""
    ref_m, port_m = paper_cascades()
    ref_shards, port = _sorted_shards(11, 3, 40, 10)
    got = TW.band_matches(port, 6, port_m, halo_len=halo_len, mode=mode)
    n = 0
    for s, e in enumerate(ref_shards):
        want = np.asarray(RW.band_matches(e, 6, ref_m, halo_len=halo_len,
                                          mode=mode))
        np.testing.assert_array_equal(to_np(got[s]), want)
        n += int(want.sum())
    assert n > 0


def test_linkage_band_mask_equals_reference():
    ref_m, port_m = paper_cascades()
    ref_shards, port = _sorted_shards(8, 2, 30, 6)
    src = np.random.default_rng(0).integers(0, 2, size=(2, 30)) \
        .astype(np.int32)
    port["payload"]["src"] = torch.from_numpy(src)
    ref_cfg = RA.ERConfig(window=4, matcher=ref_m, linkage=True,
                          band_engine="pallas")
    port_cfg = TA.ERConfig(window=4, matcher=port_m, linkage=True,
                           band_engine="pallas")
    got = TW.get_band_engine("pallas").band(port, port_cfg, halo_len=0,
                                            mode="all")
    for s, e in enumerate(ref_shards):
        e = dict(e, payload=dict(e["payload"], src=jnp.asarray(src[s])))
        want = RW.get_band_engine("pallas").band(e, ref_cfg, halo_len=0,
                                                 mode="all")
        np.testing.assert_array_equal(to_np(got["mask"][s]),
                                      np.asarray(want["mask"]))
        np.testing.assert_array_equal(to_np(got["match"][s]),
                                      np.asarray(want["match"]))


@pytest.mark.parametrize("cap_kind", ["tight", "exact", "roomy"])
def test_compaction_primitives_equal_reference(cap_kind):
    rng = np.random.default_rng(0)
    gate = rng.random((3, 5, 37)) < 0.2                 # 3 shards
    n_max = int(gate.reshape(3, -1).sum(-1).max())
    cap = {"tight": 3, "exact": n_max, "roomy": 4 * n_max + 1}[cap_kind]
    tg = torch.from_numpy(gate)
    ci, cd, cv, n_cand, ovf = TW.compact_candidates(tg, cap)
    flat, n_true, ovf2 = TW.compact_flat(tg, cap)
    em = TW.emit_band_indices(tg, cap)
    for s in range(3):
        want = RW.compact_candidates(jnp.asarray(gate[s]), cap)
        for g, w in zip((ci, cd, cv, n_cand, ovf), want):
            np.testing.assert_array_equal(to_np(g[s]), np.asarray(w))
        wf = RW.compact_flat(jnp.asarray(gate[s]), cap)
        for g, w in zip((flat, n_true, ovf2), wf):
            np.testing.assert_array_equal(to_np(g[s]), np.asarray(w))
        we = RW.emit_band_indices(jnp.asarray(gate[s]), cap)
        for k in ("idx", "n", "overflow"):
            np.testing.assert_array_equal(to_np(em[k][s]),
                                          np.asarray(we[k]))
    if cap_kind == "tight":
        assert int(ovf.sum()) > 0


def test_cheap_band_and_split_equal_reference():
    ref_m, port_m = paper_cascades()
    ref_shards, port = _sorted_shards(2, 1, 64, 8)
    e = ref_shards[0]
    rsplit = RW.split_cascade(ref_m, e["payload"])
    tsplit = TW.split_cascade(port_m, port["payload"])
    assert (rsplit.feat_field, rsplit.sig_field, rsplit.w_cos, rsplit.w_jac,
            rsplit.tau_partial) == \
        (tsplit.feat_field, tsplit.sig_field, tsplit.w_cos, tsplit.w_jac,
         tsplit.tau_partial)
    want = np.asarray(RW.cheap_band_jnp(e["payload"], rsplit, 6))
    got = to_np(TW.cheap_band(port["payload"], tsplit, 6))[0]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_cost_model_equals_reference():
    ranks = np.arange(0, 200, 7)
    for w in (2, 5, 10):
        np.testing.assert_array_equal(
            TW.rank_prefix_comparisons(ranks, w),
            RW.rank_prefix_comparisons(ranks, w))
        for t in (0, 1, 5.5, 44, 1000):
            assert TW.rank_for_prefix_comparisons(t, w) == \
                RW.rank_for_prefix_comparisons(t, w)


def test_engine_registry():
    assert TW.available_band_engines() == RW.available_band_engines()
    with pytest.raises(ValueError, match="unknown band engine"):
        TW.get_band_engine("nope")
