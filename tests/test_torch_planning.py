"""The profile planners (``uniform``, ``blocksplit``, ``pairrange``) and
their registry: the port against the reference, mirroring
``tests/test_balance.py``.

  * every ``ShardPlan`` field equals the reference's, to the integer, on a
    synth corpus, a Zipfian corpus and a Zipfian corpus whose hot key is
    larger than a shard's fair share (blocksplit splits it mid-block);
  * resolves under each planner are bit-identical in pairs, matches,
    ``load`` and every counter across 3 variants x {scan, pallas} x
    {sequential, vmap}, and their ``BalanceMetrics`` are equal;
  * a planner registered by the user works through ``ERConfig``;
  * halo truncation is refused with the reference's messages, and
    ``cap_factor`` overflow is counted as the reference counts it, both on
    the plan's exact ``cap_link`` and after the retry ladder lifts it.

The reference's pallas engine runs its plain jnp cheap band
(``band_interpret=None``), as in ``tests/test_torch_resolve.py``."""
import dataclasses

import jax  # noqa: F401  (the reference; JAX_PLATFORMS=cpu)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as RA  # noqa: E402
from repro import balance as RB  # noqa: E402
from repro.core import entities as RE  # noqa: E402
from repro.core import sn  # noqa: E402
from repro.data.corpus import zipf_entities as ref_zipf  # noqa: E402
from repro_torch import api as TA  # noqa: E402
from repro_torch import balance as TB  # noqa: E402

from _torch_parity import assert_same_result, port_ents  # noqa: E402

N, R, W = 1400, 8, 8
PLANNERS = ["uniform", "blocksplit", "pairrange"]
PLAN_FIELDS = ("bounds", "rank_bounds", "planned_load",
               "planned_comparisons", "halo", "dest")

CORPORA = {
    "synth": lambda: RE.synth_entities(np.random.default_rng(4), N,
                                       n_keys=300, dup_frac=0.2),
    "zipf": lambda: ref_zipf(7, N, n_clusters=64, exponent=1.1,
                             dup_frac=0.25),
    # one key holds ~45% of the corpus: more than a shard's fair share
    "zipf_oversized": lambda: ref_zipf(3, N, n_clusters=40, exponent=2.2,
                                       dup_frac=0.0),
}


@pytest.fixture(scope="module")
def corpora():
    return {name: make() for name, make in CORPORA.items()}


@pytest.fixture(scope="module")
def ents(corpora):
    return corpora["zipf"]


def _kw(**kw):
    kw.setdefault("window", W)
    kw.setdefault("num_shards", R)
    kw.setdefault("variant", "repsn")
    kw.setdefault("hops", R - 1)
    return kw


def _plans(ents, **kw):
    kw = _kw(**kw)
    return (RB.plan_shards(ents, RA.ERConfig(**kw), kw["num_shards"]),
            TB.plan_shards(port_ents(ents), TA.ERConfig(**kw),
                           kw["num_shards"]))


def assert_same_plan(ref, port) -> None:
    """Every ShardPlan field equal, dtypes included."""
    for f in PLAN_FIELDS:
        a, b = getattr(ref, f), getattr(port, f)
        assert (a is None) == (b is None), f
        if a is not None:
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=f)
    for f in ("partitioner", "num_shards", "cap_link", "rank_granular",
              "straggler"):
        assert getattr(ref, f) == getattr(port, f), f
    np.testing.assert_equal(port.imbalance, ref.imbalance)    # nan == nan


def _both(ents, bounds=None, **kw):
    kw = _kw(**kw)
    ref = RA.resolve(ents, RA.ERConfig(**kw), bounds=bounds)
    port = TA.resolve(port_ents(ents), TA.ERConfig(**kw), device="cpu",
                      bounds=bounds)
    return ref, port


@pytest.mark.parametrize("corpus", list(CORPORA))
@pytest.mark.parametrize("planner", PLANNERS + ["balanced"])
def test_plan_fields_equal_reference(corpora, corpus, planner):
    ref, port = _plans(corpora[corpus], partitioner=planner)
    assert_same_plan(ref, port)
    if corpus == "zipf_oversized" and planner == "blocksplit":
        assert port.dest is not None and port.rank_granular   # split


@pytest.mark.parametrize("planner", PLANNERS)
def test_plan_from_profile_equals_reference(ents, planner):
    """The profile-only planning hook, and its empty-profile branch."""
    keys = np.asarray(ents["key"])
    ref = RB.plan_from_profile(RB.profile_keys(keys, window=W), planner, R)
    port = TB.plan_from_profile(TB.profile_keys(keys, window=W), planner, R)
    assert_same_plan(ref, port)
    assert port.dest is None and port.cap_link is None
    assert_same_plan(RB.plan_from_profile(RB.KeyProfile.empty(W), planner, R),
                     TB.plan_from_profile(TB.KeyProfile.empty(W), planner, R))


def test_every_entity_assigned_once_monotone_in_rank(ents):
    for planner in PLANNERS:
        plan = _plans(ents, partitioner=planner)[1]
        assign = plan.assignment(np.asarray(ents["key"]),
                                 np.asarray(ents["valid"]))
        np.testing.assert_array_equal(np.bincount(assign, minlength=R),
                                      plan.planned_load)
        order = np.lexsort((np.asarray(ents["eid"]), np.asarray(ents["key"])))
        assert (np.diff(assign[order]) >= 0).all()


GRID = [(p, v, e, rn) for p in PLANNERS for v in ("srp", "repsn", "jobsn")
        for e in ("scan", "pallas") for rn in ("sequential", "vmap")]


@pytest.mark.parametrize("planner,variant,engine,runner", GRID,
                         ids=["-".join(g) for g in GRID])
def test_resolve_bit_identical_under_planner(ents, planner, variant, engine,
                                             runner):
    ref, port = _both(ents, partitioner=planner, variant=variant,
                      band_engine=engine, runner=runner, emit="pairs")
    assert_same_result(ref, port)
    assert port.matches and port.blocking.pairs
    assert port.resilience == ref.resilience
    if variant != "srp":
        oracle = sn.sequential_sn_pairs(np.asarray(ents["key"]),
                                        np.asarray(ents["eid"]), W)
        assert set(port.blocking.pairs) == oracle


@pytest.mark.parametrize("planner", PLANNERS)
def test_balance_metrics_equal_reference(corpora, planner):
    ref, port = _both(corpora["zipf_oversized"], partitioner=planner,
                      band_engine="pallas", compute_metrics=True)
    assert_same_result(ref, port)
    assert dataclasses.astuple(port.balance) == \
        dataclasses.astuple(ref.balance)
    assert port.balance.realized_load == port.balance.planned_load
    assert port.metrics.pairs_completeness == 1.0


def test_explicit_plan_equals_derived(ents):
    cfg = TA.ERConfig(**_kw(partitioner="blocksplit"))
    pents = port_ents(ents)
    plan = TB.plan_shards(pents, cfg, R)
    a = TA.resolve(pents, cfg, device="cpu")
    b = TA.resolve(pents, cfg, bounds=plan, device="cpu")
    assert_same_result(a, b)
    assert a.balance == b.balance


def test_registered_partitioner_usable_through_config(ents):
    from repro_torch.balance.planners import (_PLANNERS,
                                              PairRangePartitioner)

    @TB.register_partitioner("pairrange_port_alias")
    class AliasPlanner(PairRangePartitioner):
        pass

    try:
        assert "pairrange_port_alias" in TA.available_partitioners()
        assert isinstance(TA.get_partitioner("pairrange_port_alias"),
                          AliasPlanner)
        pents = port_ents(ents)
        res = TA.resolve(pents, TA.ERConfig(**_kw(
            partitioner="pairrange_port_alias")), device="cpu")
        ref = RA.resolve(ents, RA.ERConfig(**_kw(partitioner="pairrange")))
        assert_same_result(ref, res)
        assert res.balance.planned_load == ref.balance.planned_load
    finally:
        _PLANNERS.pop("pairrange_port_alias", None)
    with pytest.raises(ValueError, match="unknown partitioner"):
        TA.ERConfig(partitioner="pairrange_port_alias")
    with pytest.raises(ValueError) as ref_err:
        RB.get_partitioner("nope")
    with pytest.raises(ValueError) as port_err:
        TB.get_partitioner("nope")
    assert str(port_err.value) == str(ref_err.value)


def _same_error(ents, **kw):
    """Both packages refuse ``kw`` with the same ValueError text."""
    with pytest.raises(ValueError) as ref_err:
        RA.resolve(ents, RA.ERConfig(**_kw(**kw)))
    with pytest.raises(ValueError) as port_err:
        TA.resolve(port_ents(ents), TA.ERConfig(**_kw(**kw)), device="cpu")
    assert str(port_err.value) == str(ref_err.value)
    return str(port_err.value)


def test_halo_truncation_rejected_with_reference_messages():
    ents = ref_zipf(1, 40, n_clusters=16, exponent=0.5, dup_frac=0.0)
    assert "hops" in _same_error(ents, window=12, hops=1,
                                 partitioner="pairrange")
    assert "JobSN" in _same_error(ents, window=12, variant="jobsn",
                                  partitioner="pairrange")
    assert "hops" in _same_error(ents, window=12, hops=1,
                                 partitioner="balanced")
    # the suggested fix works and loses nothing
    ref, port = _both(ents, window=12, hops=7, partitioner="pairrange")
    assert_same_result(ref, port)
    assert set(port.blocking.pairs) == sn.sequential_sn_pairs(
        np.asarray(ents["key"]), np.asarray(ents["eid"]), 12)


def test_skewed_uniform_hop_check_equals_reference(corpora):
    """Uniform under skew leaves small shards behind its oversized first
    one: the hop check names the same least hops as the reference, and
    that many hops resolve equal to it."""
    ents = corpora["zipf_oversized"]
    assert "Set hops>=3" in _same_error(ents, partitioner="uniform", hops=1)
    ref, port = _plans(ents, partitioner="uniform", hops=3)
    assert_same_plan(ref, port)
    assert port.imbalance > 2.0
    ref, port = _both(ents, partitioner="uniform", hops=3,
                      band_engine="pallas", emit="pairs")
    assert_same_result(ref, port)


@pytest.mark.parametrize("planner", PLANNERS)
def test_cap_factor_overflow_counted_as_reference(ents, planner):
    """An explicit cap_factor overrides the plan's exact cap_link: a tight
    one overflows, counted, exactly as in the reference."""
    ref, port = _both(ents, partitioner=planner, variant="srp",
                      cap_factor=0.6)
    assert_same_result(ref, port)
    assert port.blocking.overflow > 0
    assert port.blocking.total_load + port.blocking.overflow == N
    ref, port = _both(ents, partitioner=planner, variant="srp")
    assert_same_result(ref, port)
    assert port.blocking.overflow == 0


def test_retry_ladder_lifts_exact_cap_link(ents):
    """A pair_cap overflow under a plan with an exact cap_link: the retry
    drops cap_link (cap_factor's full capacity takes over) and the rerun
    equals the reference's, resilience counters included."""
    kw = dict(partitioner="pairrange", emit="pairs", band_engine="pallas",
              pair_cap=40, on_overflow="retry", retry_limit=6)
    ref, port = _both(ents, **kw)
    assert_same_result(ref, port)
    assert port.resilience == ref.resilience
    assert port.resilience.retries > 0
    assert port.blocking.pair_overflow == 0
    ref, port = _both(ents, **dict(kw, on_overflow="count"))
    assert_same_result(ref, port)
    assert port.blocking.pair_overflow > 0
