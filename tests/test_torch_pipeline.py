"""The port's deprecated free-function pipeline (``repro_torch.core.
pipeline``) against the reference's (``repro.core.pipeline``) on one numpy
corpus: the shims of ``tests/test_api_facade.py:229-251`` for the port, and
their pair sets bit for bit (packed uint64) beside the reference's.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import gloo_mesh, port_ents  # noqa: E402,F401

N, R, W, NK = 260, 4, 6, 64
VARIANTS = ("srp", "repsn", "jobsn")


@pytest.fixture(scope="module")
def corpus():
    from repro.core import entities as E
    from repro.core import partition as P
    ents = E.synth_entities(np.random.default_rng(11), N, n_keys=NK,
                            dup_frac=0.25)
    return ents, P.balanced_partition(np.asarray(ents["key"]), R)


@pytest.fixture(scope="module")
def one_shard(corpus):
    """Bounds of one partition (the world-size-1 mesh's)."""
    from repro.core import partition as P
    return P.balanced_partition(np.asarray(corpus[0]["key"]), 1)


def _packed(pairs) -> np.ndarray:
    from repro_torch.api.results import pack_pair_set
    return np.sort(pack_pair_set(set(pairs)))


def _quiet(fn, *args, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return fn(*args, **kw)


def _three_sets(PL, out):
    return {"blocked": _packed(_quiet(PL.blocked_pairs, out)),
            "matched": _packed(_quiet(PL.result_pairs, out)),
            "main": _packed(PL.extract_pairs(out["main"]))}


@pytest.mark.parametrize("return_scores", [False, True])
@pytest.mark.parametrize("variant", VARIANTS)
def test_shims_equal_reference(corpus, variant, return_scores):
    from repro.core import pipeline as RPL
    from repro_torch.core import pipeline as TPL
    ents, bounds = corpus
    ref = _three_sets(RPL, _quiet(RPL.run_vmap, ents, R, bounds, RPL.SNConfig(
        window=W, variant=variant, return_scores=return_scores)))
    port = _three_sets(TPL, _quiet(
        TPL.run_vmap, port_ents(ents), R, bounds,
        TPL.SNConfig(window=W, variant=variant,
                     return_scores=return_scores), device="cpu"))
    for k in ref:
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
    assert ref["blocked"].size > 0 and ref["matched"].size > 0


def test_old_pipeline_entry_points_still_work(corpus):
    """tests/test_api_facade.py's shim test, for the port."""
    from repro_torch import api
    from repro_torch.core import pipeline as PL
    ents, bounds = corpus
    tents = port_ents(ents)
    cfg = PL.SNConfig(window=W, variant="jobsn")
    assert cfg.matcher == PL.default_matcher()
    out = _quiet(PL.run_vmap, tents, R, bounds, cfg, device="cpu")
    res = api.resolve(tents, api.ERConfig(
        window=W, variant="jobsn", runner="vmap", num_shards=R,
        band_engine="scan"), bounds=bounds, device="cpu")
    np.testing.assert_array_equal(_packed(_quiet(PL.blocked_pairs, out)),
                                  _packed(res.blocking.pairs))
    np.testing.assert_array_equal(_packed(_quiet(PL.result_pairs, out)),
                                  _packed(res.matches))
    with pytest.raises(ValueError, match="unknown SN variant"):
        PL.sn_shard(tents, bounds, R, "sn", PL.SNConfig(variant="bogus"))


@pytest.mark.parametrize("old", ["run_vmap", "run_shard_map", "blocked_pairs",
                                 "result_pairs"])
def test_old_entry_points_warn(corpus, one_shard, gloo_mesh,  # noqa: F811
                               old):
    from repro_torch.core import pipeline as PL
    ents, bounds = corpus
    tents = port_ents(ents)
    cfg = PL.SNConfig(window=3)
    call = {
        "run_vmap": lambda: PL.run_vmap(tents, R, bounds, cfg, device="cpu"),
        "run_shard_map": lambda: PL.run_shard_map(
            tents, gloo_mesh, "data", one_shard, cfg, device="cpu"),
        "blocked_pairs": lambda: PL.blocked_pairs(
            _quiet(PL.run_vmap, tents, R, bounds, cfg, device="cpu")),
        "result_pairs": lambda: PL.result_pairs(
            _quiet(PL.run_vmap, tents, R, bounds, cfg, device="cpu")),
    }[old]
    with pytest.warns(DeprecationWarning,
                      match=rf"repro_torch\.core\.pipeline\.{old} is "
                            rf"deprecated; use repro_torch\.api"):
        call()


@pytest.mark.parametrize("variant", VARIANTS)
def test_run_shard_map_world_size_1(corpus, one_shard,
                                    gloo_mesh, variant):  # noqa: F811
    """``run_shard_map`` over a world-size-1 gloo mesh equals ``run_vmap``
    with one shard, and the reference's ``run_vmap`` with one shard."""
    from repro.core import pipeline as RPL
    from repro_torch.core import pipeline as TPL
    ents, one = corpus[0], one_shard
    tents = port_ents(ents)
    cfg = TPL.SNConfig(window=W, variant=variant)
    sm = _three_sets(TPL, _quiet(TPL.run_shard_map, tents, gloo_mesh, "data",
                                 one, cfg, device="cpu"))
    vm = _three_sets(TPL, _quiet(TPL.run_vmap, tents, 1, one, cfg,
                                 device="cpu"))
    ref = _three_sets(RPL, _quiet(RPL.run_vmap, ents, 1, one, RPL.SNConfig(
        window=W, variant=variant)))
    for k in ref:
        np.testing.assert_array_equal(sm[k], vm[k], err_msg=k)
        np.testing.assert_array_equal(sm[k], ref[k], err_msg=k)
