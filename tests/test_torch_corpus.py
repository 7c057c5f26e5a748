"""Parity of the port's corpus sources and partition statistics
(``repro_torch.data.corpus``, ``repro_torch.core.partition``) with the
reference on the CPU: the chunked stream sources, the token corpus, its
entities and the dedup stage, and partition sizes / Gini / skewed bounds,
all bit-identical by seed."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import to_np  # noqa: E402
from repro.core import entities as RE  # noqa: E402
from repro.core import partition as RP  # noqa: E402
from repro.data import corpus as RC  # noqa: E402
from repro_torch import data as TD  # noqa: E402
from repro_torch.core import partition as TP  # noqa: E402


def _assert_same_ents(ref, port):
    """Reference and port entity dicts equal (signatures as bits)."""
    ref = RE.to_host(ref)
    for f in ("key", "eid", "valid"):
        got = to_np(port[f])
        assert got.dtype == np.asarray(ref[f]).dtype, f
        np.testing.assert_array_equal(got, ref[f])
    assert sorted(ref["payload"]) == sorted(port["payload"])
    for k, v in ref["payload"].items():
        got = to_np(port["payload"][k])
        if k == "sig":
            assert got.dtype == np.int32
            got = got.view(np.uint32)
        assert got.dtype == v.dtype, k
        np.testing.assert_array_equal(got, v)


@pytest.mark.parametrize("kw", [dict(text_len=0), dict(text_len=8, skew=0.3,
                                                       n_keys=40)])
def test_synth_entity_chunks_match_reference(kw):
    ref = list(RC.synth_entity_chunks(3, 230, 64, **kw))
    port = list(TD.synth_entity_chunks(3, 230, 64, **kw))
    assert [int(c["key"].shape[0]) for c in port] == [64, 64, 64, 38]
    for a, b in zip(ref, port):
        _assert_same_ents(a, b)
    with pytest.raises(ValueError, match="chunk"):
        next(TD.synth_entity_chunks(0, 10, 0))


def test_zipf_entity_chunks_match_reference():
    kw = dict(n_clusters=16, exponent=1.0, cluster_width=2)
    ref = list(RC.zipf_entity_chunks(4, 300, 128, **kw))
    port = list(TD.zipf_entity_chunks(4, 300, 128, **kw))
    assert len(port) == 3
    for a, b in zip(ref, port):
        _assert_same_ents(a, b)
    with pytest.raises(ValueError, match="chunk"):
        next(TD.zipf_entity_chunks(0, 10, 0))


def test_synth_corpus_and_doc_entities_match_reference():
    docs = RC.synth_corpus(5, 120, doc_len=16, vocab=300)
    got = TD.synth_corpus(5, 120, doc_len=16, vocab=300)
    assert got.dtype == docs.dtype == np.int32
    np.testing.assert_array_equal(got, docs)
    _assert_same_ents(RC.doc_entities(docs, sig_words=4, feat_dim=16),
                      TD.doc_entities(docs, sig_words=4, feat_dim=16))


@pytest.mark.parametrize("balance", [True, False])
def test_dedup_corpus_matches_reference(balance):
    docs = RC.synth_corpus(0, 400, doc_len=32, dup_frac=0.3)
    ref = RC.dedup_corpus(docs, r=4, window=8, threshold=0.9,
                          balance=balance)
    port = TD.dedup_corpus(docs, r=4, window=8, threshold=0.9,
                           balance=balance, device="cpu")
    np.testing.assert_array_equal(port.keep, ref.keep)
    assert (port.n_pairs, port.n_dropped, port.overflow) == \
        (ref.n_pairs, ref.n_dropped, ref.overflow)
    assert port.gini == ref.gini
    assert port.n_pairs > 0


def test_partition_statistics_match_reference():
    rng = np.random.default_rng(7)
    keys = rng.integers(0, 5000, size=900).astype(np.int32)
    valid = rng.random(900) < 0.8
    bounds = np.asarray([700, 1500, 3200], np.int32)
    for v in (None, valid):
        ref = np.asarray(RP.partition_sizes(bounds, keys, valid=v))
        got = TP.partition_sizes(torch.as_tensor(bounds),
                                 torch.as_tensor(keys),
                                 valid=None if v is None
                                 else torch.as_tensor(v))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)
        assert TP.gini(got) == RP.gini(ref)
    np.testing.assert_array_equal(
        TP.partition_sizes(bounds, torch.as_tensor(keys), r=6).numpy(),
        np.asarray(RP.partition_sizes(bounds, keys, r=6)))
    assert TP.gini([]) == RP.gini([]) == 0.0
    assert TP.gini([0, 0]) == 0.0
    assert TP.gini([5, 5, 5]) == pytest.approx(0.0)
    for hot in (0.4, 0.85):
        ref = np.asarray(RP.skewed_partition(1 << 13, 8, hot, keys))
        got = TP.skewed_partition(1 << 13, 8, hot, torch.as_tensor(keys))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)
