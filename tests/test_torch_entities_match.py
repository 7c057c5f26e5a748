"""Port parity: entity schema + matchers (``repro_torch.core.entities`` and
``core.match``) against the JAX reference on the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import entities as RE  # noqa: E402
from repro.core import match as RM  # noqa: E402
from repro_torch.core import entities as TE  # noqa: E402
from repro_torch.core import match as TM  # noqa: E402

from _torch_parity import to_np  # noqa: E402


@pytest.mark.parametrize("kw", [
    dict(n=300, n_keys=40),
    dict(n=257, n_keys=8, skew=0.6, text_len=12, dup_frac=0.3),
    dict(n=64, n_keys=1000, sig_words=4, feat_dim=7, dup_frac=0.0),
], ids=["plain", "skew-text", "narrow-nodup"])
def test_synth_entities_bit_identical(kw):
    kw = dict(kw)
    n = kw.pop("n")
    ref = RE.synth_entities(np.random.default_rng(5), n, **kw)
    port = TE.to_numpy(TE.synth_entities(np.random.default_rng(5), n, **kw))
    for f in ("key", "eid", "valid"):
        np.testing.assert_array_equal(port[f], np.asarray(ref[f]))
    assert set(port["payload"]) == set(ref["payload"])
    for k, v in ref["payload"].items():
        v = np.asarray(v)
        assert port["payload"][k].dtype == v.dtype, k
        np.testing.assert_array_equal(port["payload"][k], v)


@pytest.mark.parametrize("seed,n_keys,invalid", [
    (0, 5, 0.0), (1, 50, 0.3), (2, 3, 0.8)],
    ids=["dense-dups", "some-invalid", "mostly-invalid"])
def test_sort_order_equals_reference(seed, n_keys, invalid):
    rng = np.random.default_rng(seed)
    n = 200
    ref = RE.synth_entities(rng, n, n_keys=n_keys)
    valid = rng.random(n) >= invalid
    eid = rng.permutation(n).astype(np.int32)       # ties broken by eid
    ref = RE.make_entities(ref["key"], eid, payload=ref["payload"],
                           valid=valid)
    want = RE.to_host(RE.sort_entities(ref))
    got = TE.to_numpy(TE.sort_entities(TE.from_numpy(ref, "cpu")))
    for f in ("key", "eid", "valid"):
        np.testing.assert_array_equal(got[f], want[f])
    np.testing.assert_array_equal(got["payload"]["sig"],
                                  np.asarray(want["payload"]["sig"]))


def test_host_pad_appends_invalid_rows_past_every_key():
    """``host_pad``: the padding rows are invalid with keys past every real
    key, the payload keeps its fields and dtypes, the rows equal the
    reference stream's padding, and ``cap == n`` returns the input."""
    from repro.stream.resolver import _host_pad as ref_pad
    h = TE.to_host(TE.synth_entities(np.random.default_rng(4), 37,
                                     n_keys=9, text_len=6))
    got = TE.host_pad(h, 50)
    assert got["key"].shape == (50,)
    assert not got["valid"][37:].any() and got["valid"][:37].all()
    assert int(got["key"][37:].min()) > int(h["key"].max())
    assert got["key"][37:].dtype == np.int32
    assert set(got["payload"]) == set(h["payload"])
    for k, v in h["payload"].items():
        assert got["payload"][k].dtype == v.dtype, k
        assert got["payload"][k].shape == (50,) + v.shape[1:], k
    want = ref_pad(h, 50)
    for f in ("key", "eid", "valid"):
        np.testing.assert_array_equal(got[f], want[f])
        assert got[f].dtype == want[f].dtype
    for k in h["payload"]:
        np.testing.assert_array_equal(got["payload"][k], want["payload"][k])
    assert TE.host_pad(h, 37) is h


def test_batched_slice_roll_match_dynamic_slice_clamping():
    """Per-shard starts/shifts on a stacked (r, M) entity dict equal the
    reference's dynamic_slice / roll applied shard by shard — including
    starts clamped to M - size."""
    rng = np.random.default_rng(3)
    r, m, size = 4, 12, 5
    ents = RE.synth_entities(rng, r * m, n_keys=30)
    host = {k: np.asarray(v) for k, v in ents.items() if k != "payload"}
    stacked = TE.from_numpy(ents, "cpu")
    stacked = TE.map_fields(stacked, lambda a: a.reshape((r, m) + a.shape[1:]))
    starts = np.array([0, 3, 9, 40])                # 9 and 40 are clamped
    shifts = np.array([0, 1, 3, 4])
    got_s = TE.slice_entities(stacked, torch.as_tensor(starts), size)
    got_r = TE.roll(stacked, torch.as_tensor(shifts))
    for s in range(r):
        one = RE.make_entities(host["key"][s * m:(s + 1) * m],
                               host["eid"][s * m:(s + 1) * m])
        ws = RE.slice_entities(one, int(starts[s]), size)
        wr = RE.roll(one, int(shifts[s]))
        np.testing.assert_array_equal(to_np(got_s["eid"][s]),
                                      np.asarray(ws["eid"]))
        np.testing.assert_array_equal(to_np(got_r["eid"][s]),
                                      np.asarray(wr["eid"]))


@pytest.fixture(scope="module")
def pair_payloads():
    ents = RE.synth_entities(np.random.default_rng(9), 400, n_keys=10,
                             dup_frac=0.5, text_len=10)
    p = {k: np.array(v) for k, v in ents["payload"].items()}
    # empty texts and empty signatures exercise the edge conventions
    p["text"][:20, 3:] = 0
    p["text"][20:25] = 0
    p["sig"][:10] = 0
    order = np.random.default_rng(1).permutation(400)
    return p, order


def test_cosine_and_jaccard_equal_reference(pair_payloads):
    p, order = pair_payloads
    tp = {k: torch.from_numpy(v.view(np.int32) if v.dtype == np.uint32
                              else v) for k, v in p.items()}
    got_c = TM.cosine_sim(tp["feat"], tp["feat"][order])
    want_c = RM.cosine_sim(jnp.asarray(p["feat"]),
                           jnp.asarray(p["feat"][order]))
    np.testing.assert_allclose(to_np(got_c), np.asarray(want_c),
                               rtol=1e-6, atol=1e-7)
    got_j = TM.jaccard_sig(tp["sig"], tp["sig"][order])
    want_j = RM.jaccard_sig(jnp.asarray(p["sig"]),
                            jnp.asarray(p["sig"][order]))
    np.testing.assert_array_equal(to_np(got_j), np.asarray(want_j))


def test_jaccard_empty_vs_empty_is_one():
    z = torch.zeros((3, 4), dtype=torch.int32)
    np.testing.assert_array_equal(to_np(TM.jaccard_sig(z, z)), 1.0)
    full = torch.full((1, 2), -1, dtype=torch.int32)   # all 64 bits set
    np.testing.assert_array_equal(to_np(TM.popcount32(full)), [[32, 32]])
    np.testing.assert_array_equal(to_np(TM.jaccard_sig(full, z[:1, :2])),
                                  [0.0])


def test_edit_distance_equals_reference_and_host_oracle(pair_payloads):
    p, order = pair_payloads
    a, b = p["text"], p["text"][order]
    got = to_np(TM.edit_distance_impl(torch.from_numpy(a),
                                      torch.from_numpy(b)))
    want = np.asarray(RM.edit_distance_impl(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(got, want)
    for i in range(0, 400, 7):
        assert got[i] == RM.edit_distance_ref(a[i], b[i])
    np.testing.assert_array_equal(
        to_np(TM.edit_sim(torch.from_numpy(a), torch.from_numpy(b))),
        np.asarray(RM.edit_sim(jnp.asarray(a), jnp.asarray(b))))


@pytest.mark.parametrize("skip", [True, False], ids=["skip", "noskip"])
def test_cascade_combined_equals_reference(pair_payloads, skip):
    from _torch_parity import paper_cascades
    p, order = pair_payloads
    ref_m, port_m = paper_cascades()
    rp = {k: jnp.asarray(v) for k, v in p.items()}
    rq = {k: jnp.asarray(v[order]) for k, v in p.items()}
    tp = {k: torch.from_numpy(v.view(np.int32) if v.dtype == np.uint32
                              else v) for k, v in p.items()}
    tq = {k: v[torch.from_numpy(order)] for k, v in tp.items()}
    ws, we = ref_m.combined(rp, rq, skip=skip)
    gs, ge = port_m.combined(tp, tq, skip=skip)
    np.testing.assert_allclose(to_np(gs), np.asarray(ws), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(to_np(ge), np.asarray(we))
    assert TM.as_matcher(ref_m) == port_m
    assert TM.default_matcher() == TM.as_matcher(RM.default_matcher())
