"""The slice as a whole: the port's ``api.resolve`` / ``api.link`` against
the reference's, bit-identical in pairs, matches, ``load`` and every
counter (``_torch_parity.assert_same_result``), across 3 variants x
{scan, pallas} x {band, pairs} x {sequential, vmap}, with the paper's
cascade (edit distance on ``text``), and the shard_map runner at world
size 1.

The reference runs its pallas engine with ``band_interpret=None`` (its
plain jnp cheap band); one case forces its interpreted Pallas kernel."""
import dataclasses

import jax  # noqa: F401  (the reference; JAX_PLATFORMS=cpu)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as RA  # noqa: E402
from repro.core import entities as RE  # noqa: E402
from repro_torch import api as TA  # noqa: E402

from _torch_parity import (assert_same_result, gloo_mesh,  # noqa: E402
                           paper_cascades, port_ents)

N, R, WIN, NK = 160, 4, 5, 40


@pytest.fixture(scope="module")
def ents():
    return RE.synth_entities(np.random.default_rng(11), N, n_keys=NK,
                             dup_frac=0.3, text_len=8)


def _both(ents, **kw):
    ref_m, port_m = paper_cascades()
    ref = RA.resolve(ents, RA.ERConfig(matcher=ref_m, **kw))
    port = TA.resolve(port_ents(ents), TA.ERConfig(matcher=port_m, **kw),
                      device="cpu")
    return ref, port


GRID = [(v, e, m, rn) for v in ("srp", "repsn", "jobsn")
        for e in ("scan", "pallas") for m in ("band", "pairs")
        for rn in ("sequential", "vmap")]


@pytest.mark.parametrize("variant,engine,emit,runner", GRID,
                         ids=["-".join(g) for g in GRID])
def test_resolve_bit_identical(ents, variant, engine, emit, runner):
    ref, port = _both(ents, window=WIN, variant=variant, band_engine=engine,
                      emit=emit, runner=runner, num_shards=R, hops=R - 1)
    assert_same_result(ref, port)
    assert port.matches and port.blocking.pairs
    assert port.resilience == ref.resilience


def test_interpreted_kernel_case(ents):
    """The reference's interpreted Pallas kernel agrees too."""
    ref, port = _both(ents, window=WIN, variant="repsn", hops=R - 1,
                      band_engine="pallas", band_interpret=True,
                      num_shards=R, cand_cap=64)
    assert_same_result(ref, port)


@pytest.mark.parametrize("cap", [4, 64, 4096], ids=["tight", "mid", "roomy"])
def test_cand_cap_overflow_accounting(ents, cap):
    ref, port = _both(ents, window=WIN, variant="srp", num_shards=R,
                      band_engine="pallas", cand_cap=cap, emit="pairs")
    assert_same_result(ref, port)
    if cap == 4:
        assert port.blocking.cand_overflow > 0


def test_pair_cap_overflow_and_retry_ladder(ents):
    kw = dict(window=WIN, variant="repsn", hops=R - 1, num_shards=R,
              emit="pairs", band_engine="pallas", pair_cap=8)
    ref, port = _both(ents, **kw)
    assert_same_result(ref, port)
    assert port.blocking.pair_overflow > 0
    ref, port = _both(ents, on_overflow="retry", retry_limit=5,
                      **dict(kw, pair_cap=160))
    assert_same_result(ref, port)
    assert port.resilience == ref.resilience
    assert port.resilience.retries > 0


@pytest.mark.parametrize("variant", ["srp", "repsn", "jobsn"])
def test_link_bit_identical(variant):
    rng = np.random.default_rng(5)
    lhs = RE.synth_entities(rng, 120, n_keys=30, dup_frac=0.0, text_len=8)
    take = rng.permutation(120)[:50]
    rhs = RE.make_entities(
        np.asarray(lhs["key"])[take], np.arange(50, dtype=np.int32),
        payload={k: np.asarray(v)[take] for k, v in lhs["payload"].items()})
    ref_m, port_m = paper_cascades()
    kw = dict(window=4, variant=variant, num_shards=R, hops=R - 1,
              band_engine="pallas", emit="pairs", compute_metrics=True)
    ref = RA.link(lhs, rhs, RA.ERConfig(matcher=ref_m, **kw))
    port = TA.link(port_ents(lhs), port_ents(rhs),
                   TA.ERConfig(matcher=port_m, **kw), device="cpu")
    assert_same_result(ref, port)
    assert port.matches
    assert port.metrics.pairs_completeness == ref.metrics.pairs_completeness
    assert port.metrics.reduction_ratio == ref.metrics.reduction_ratio


def test_metrics_and_balance_equal_reference(ents):
    ref, port = _both(ents, window=WIN, variant="repsn", num_shards=R,
                      hops=R - 1, compute_metrics=True)
    assert_same_result(ref, port)
    for f in ("reduction_ratio", "pairs_completeness", "oracle_pairs",
              "total_comparisons"):
        assert getattr(port.metrics, f) == getattr(ref.metrics, f)
    # different classes of the two packages: compare field values
    assert dataclasses.astuple(port.balance) == \
        dataclasses.astuple(ref.balance)


@pytest.mark.parametrize("engine", ["scan", "pallas"])
def test_evidence_pruning_equal_reference(ents, engine):
    ref, port = _both(ents, window=WIN, variant="jobsn", num_shards=R,
                      band_engine=engine, prune_policy="evidence",
                      prune_threshold=0.6)
    assert_same_result(ref, port)
    assert port.blocking.pruned > 0


@pytest.mark.parametrize("partitioner", ["balanced", "range", "sample"])
def test_legacy_partitioners_equal_reference(ents, partitioner):
    ref, port = _both(ents, window=WIN, variant="repsn", num_shards=R,
                      hops=R - 1, partitioner=partitioner, emit="pairs",
                      band_engine="pallas")
    assert_same_result(ref, port)


@pytest.mark.parametrize("variant", ["srp", "repsn", "jobsn"])
def test_shard_map_runner_equals_reference(ents, gloo_mesh, variant):
    """``runner="shard_map"`` on the port's world-size-1 gloo mesh against
    the reference's shard_map on its one CPU device (every counter), and
    against the port's vmap runner at one shard."""
    kw = dict(window=WIN, variant=variant, band_engine="pallas",
              emit="pairs", num_shards=1, hops=1)
    ref_m, port_m = paper_cascades()
    ref = RA.resolve(ents, RA.ERConfig(matcher=ref_m, runner="shard_map",
                                       **kw))
    port = TA.resolve(port_ents(ents), TA.ERConfig(
        matcher=port_m, runner="shard_map", **kw), mesh=gloo_mesh,
        device="cpu")
    vm = TA.resolve(port_ents(ents), TA.ERConfig(matcher=port_m, **kw),
                    device="cpu")
    assert ref.blocking.num_shards == port.blocking.num_shards == 1
    assert_same_result(ref, port)
    assert_same_result(vm, port)
    assert port.blocking.runner == "shard_map"


def test_config_validation_matches_reference():
    for bad in (dict(band_engine="pallass"), dict(window=1),
                dict(band_engine="pallas", window=300, band_block=256),
                dict(cand_cap=-1), dict(emit="pairs", return_scores=True),
                dict(partitioner="nope"), dict(window_max=12),
                dict(prune_threshold=0.5)):
        with pytest.raises(ValueError):
            RA.ERConfig(**bad)
        with pytest.raises(ValueError):
            TA.ERConfig(**bad)
    cfg = TA.ERConfig(window=7, band_engine="pallas")
    assert cfg.with_(window=9).window == 9
    ref_cfg = RA.ERConfig(window=7, band_engine="pallas")
    assert cfg.static_fingerprint()[1:5] == ref_cfg.static_fingerprint()[1:5]


@pytest.mark.parametrize("n", [0, 1, 2, 1000], ids=lambda n: f"n{n}")
def test_unique_packed_equals_np_unique(n):
    from repro_torch.api.results import unique_packed
    x = np.random.default_rng(n).integers(0, 50, size=n).astype(np.uint64)
    np.testing.assert_array_equal(unique_packed(x), np.unique(x))
