"""The frozen generators against the program's, bit for bit, and the
seeded corpora and streams made from them."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from erbench import harness  # noqa: E402
from erbench.data import corpus, generators as G  # noqa: E402


def _same(a: dict, b: dict):
    for k in ("key", "eid", "valid"):
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
    assert set(a["payload"]) == set(b["payload"])
    for k in a["payload"]:
        x, y = np.asarray(a["payload"][k]), np.asarray(b["payload"][k])
        assert x.dtype == y.dtype or {x.dtype, y.dtype} <= {
            np.dtype(np.uint32), np.dtype(np.int32)}
        np.testing.assert_array_equal(x.view(y.dtype) if
                                      x.dtype != y.dtype else x, y)


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11])
@pytest.mark.parametrize("kw", [
    dict(n_keys=17576, dup_frac=0.2, text_len=16),
    dict(n_keys=50, dup_frac=0.3, skew=0.2)], ids=["pubs", "skew"])
def test_synth_arrays_is_the_programs(seed, kw):
    from repro_torch.core import entities as E
    _same(G.synth_arrays(np.random.default_rng(seed), 3000, **kw),
          E.synth_arrays(np.random.default_rng(seed), 3000, **kw))


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11])
@pytest.mark.parametrize("kw", [
    dict(n_clusters=256, exponent=1.0, dup_frac=0.2),
    dict(n_clusters=16, exponent=1.5, cluster_width=3,
         shuffle_clusters=True)], ids=["zipf", "wide"])
def test_zipf_arrays_is_the_programs(seed, kw):
    from repro_torch.core import entities as E
    from repro_torch.data.corpus import zipf_entities
    _same(G.zipf_arrays(seed, 3000, **kw),
          E.to_numpy(zipf_entities(seed, 3000, **kw)))


# a skewed corpus of the frozen zipf generator, which no configuration
# uses yet
ZIPF = {"corpus": {"generator": "zipf", "n": 4000, "n_clusters": 256,
                   "exponent": 1.0, "dup_frac": 0.2, "cluster_width": 1,
                   "feat_dim": 32, "sig_words": 8}}


@pytest.mark.parametrize("cfg", [harness.config("pubs-1.4m"), ZIPF],
                         ids=["pubs-1.4m", "zipf"])
def test_corpus_is_a_function_of_the_seed(cfg):
    a, b = corpus.make(cfg, 2**33 + 5, n=4000), \
        corpus.make(cfg, 2**33 + 5, n=4000)
    _same(a, b)
    c = corpus.make(cfg, 2**33 + 6, n=4000)
    assert not np.array_equal(a["payload"]["feat"], c["payload"]["feat"])
    x = corpus.batch(cfg, 3, 5, 200, 10_000)
    _same(x, corpus.batch(cfg, 3, 5, 200, 10_000))
    np.testing.assert_array_equal(x["eid"], np.arange(10_000, 10_200))


def test_graded_copies_spread_over_the_threshold():
    from erbench.reference import sn
    cfg = harness.config("pubs-1.4m")
    host = corpus.make(cfg, 1, n=20_000)
    order = sn.sorted_order(host["key"], host["eid"])
    s = np.concatenate([sn.scores(host["payload"], order[:-d], order[d:],
                                  cfg["matcher"]) for d in range(1, 10)])
    near = np.abs(s - cfg["matcher"]["threshold"]) < 0.02
    assert near.sum() >= 20
    feat = host["payload"]["feat"]
    np.testing.assert_allclose(np.linalg.norm(feat, axis=1), 1.0,
                               atol=1e-5)
