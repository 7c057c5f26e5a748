"""Port parity for the shard programs with the shard dim explicit
(``repro_torch.core.srp``/``repsn``/``jobsn`` through
``api.VmapRunner.run_raw``) against the reference's vmapped programs, plus
DESIGN.md invariants 1-6 on the port."""
import jax  # noqa: F401  (the reference; JAX_PLATFORMS=cpu)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as RA  # noqa: E402
from repro.core import entities as RE  # noqa: E402
from repro.core import partition as RP  # noqa: E402
from repro.core import sn as RSN  # noqa: E402
from repro_torch import api as TA  # noqa: E402
from repro_torch.core import partition as TP  # noqa: E402

from _torch_parity import port_ents, to_np  # noqa: E402

N, R, W, NK = 150, 4, 5, 24


@pytest.fixture(scope="module")
def ents():
    return RE.synth_entities(np.random.default_rng(2), N, n_keys=NK,
                             dup_frac=0.3)


RAW_CASES = [("srp", 1, 0.0), ("repsn", 1, 0.0), ("repsn", R - 1, 0.0),
             ("jobsn", 1, 0.0), ("srp", 1, 1.0)]


@pytest.mark.parametrize("variant,hops,cap_factor", RAW_CASES,
                         ids=["srp", "repsn-h1", "repsn-h3", "jobsn",
                              "srp-tight-cap"])
def test_run_raw_equals_reference(ents, variant, hops, cap_factor):
    """Every valid slot of every shard (key, eid), every band, and the
    overflow/load telemetry equal the reference's vmapped program."""
    kw = dict(window=W, variant=variant, hops=hops, num_shards=R,
              cap_factor=cap_factor)
    bounds = RP.range_partition(NK, R)
    want = RA.VmapRunner(R).run_raw(ents, bounds, RA.ERConfig(**kw))
    got = TA.VmapRunner(R, device="cpu").run_raw(
        port_ents(ents), TP.range_partition(NK, R), TA.ERConfig(**kw))
    np.testing.assert_array_equal(to_np(got["overflow"]),
                                  np.asarray(want["overflow"]))
    np.testing.assert_array_equal(to_np(got["load"]),
                                  np.asarray(want["load"]))
    for part in [p for p in ("main", "boundary") if p in want]:
        g, w = got[part], want[part]
        valid = np.asarray(w["ents"]["valid"])
        np.testing.assert_array_equal(to_np(g["ents"]["valid"]), valid)
        for f in ("key", "eid"):
            np.testing.assert_array_equal(
                to_np(g["ents"][f])[valid], np.asarray(w["ents"][f])[valid])
        for f in ("mask", "match"):
            np.testing.assert_array_equal(to_np(g[f]), np.asarray(w[f]))
        assert (np.asarray(w["halo_len"]) == g["halo_len"]).all()


# -- DESIGN.md invariants on the port ----------------------------------------------

SEED_GRID = [(40, 2, 2, 16, 0), (97, 4, 3, 64, 1), (200, 8, 8, 256, 2),
             (150, 4, 5, 16, 3)]


@pytest.mark.parametrize("n,r,w,n_keys,seed", SEED_GRID,
                         ids=[f"n{g[0]}-r{g[1]}-w{g[2]}" for g in SEED_GRID])
def test_inv1_inv4_pair_completeness(n, r, w, n_keys, seed):
    """INV1: RepSN (hops=r-1, so INV4's tiny partitions are covered) and
    JobSN equal the sequential oracle (JobSN when partitions hold w-1)."""
    ref = RE.synth_entities(np.random.default_rng(seed), n, n_keys=n_keys)
    oracle = RSN.sequential_sn_pairs(np.asarray(ref["key"]),
                                     np.asarray(ref["eid"]), w)
    bounds = TP.range_partition(n_keys, r)
    for variant, hops in [("repsn", r - 1), ("jobsn", 1)]:
        res = TA.resolve(port_ents(ref), TA.ERConfig(
            window=w, variant=variant, hops=hops, num_shards=r),
            bounds=bounds, device="cpu")
        got = set(res.blocking.pairs)
        if variant == "jobsn" and not all(x >= w - 1
                                          for x in res.blocking.load):
            assert got <= oracle
        else:
            assert got == oracle
        assert res.blocking.overflow == 0


@pytest.mark.parametrize("seed,r,w", [(0, 2, 2), (1, 4, 3), (2, 4, 6)],
                         ids=["r2w2", "r4w3", "r4w6"])
def test_inv2_srp_miss_formula(seed, r, w):
    n = 40 * r + w * r
    ref = RE.synth_entities(np.random.default_rng(seed), n, n_keys=64)
    oracle = RSN.sequential_sn_pairs(np.asarray(ref["key"]),
                                     np.asarray(ref["eid"]), w)
    sizes = np.bincount(np.searchsorted(
        np.asarray(RP.range_partition(64, r)), np.asarray(ref["key"])),
        minlength=r)
    assert (sizes >= w).all()
    res = TA.resolve(port_ents(ref), TA.ERConfig(
        window=w, variant="srp", num_shards=r),
        bounds=TP.range_partition(64, r), device="cpu")
    got = set(res.blocking.pairs)
    assert len(oracle - got) == RSN.srp_missed_boundary_pairs(r, w)
    assert not (got - oracle)


def test_inv3_replication_bound(ents):
    cfg = TA.ERConfig(window=W, variant="repsn", num_shards=R)
    out = TA.VmapRunner(R, device="cpu").run_raw(
        port_ents(ents), TP.range_partition(NK, R), cfg)
    halo_valid = to_np(out["main"]["ents"]["valid"])[:, :W - 1]
    assert halo_valid.sum() <= (R - 1) * (W - 1)


@pytest.mark.parametrize("skew", [0.0, 0.9], ids=["even", "skewed"])
def test_inv5_no_entity_silently_lost(skew):
    ref = RE.synth_entities(np.random.default_rng(0), 128, n_keys=16,
                            skew=skew)
    res = TA.resolve(port_ents(ref), TA.ERConfig(
        window=3, variant="srp", cap_factor=1.0, num_shards=4),
        bounds=TP.range_partition(16, 4), device="cpu")
    assert res.blocking.total_load + res.blocking.overflow == 128
    if skew:
        assert res.blocking.overflow > 0


def test_inv6_every_variant_runner_agrees(ents):
    """INV6: the boundary-complete variants give one pair set under both
    runners (and SRP agrees with its own per-partition oracle)."""
    sets = {}
    for variant in ("srp", "repsn", "jobsn"):
        for runner in ("sequential", "vmap"):
            res = TA.resolve(port_ents(ents), TA.ERConfig(
                window=W, variant=variant, runner=runner, num_shards=R,
                hops=R - 1), device="cpu")
            sets[variant, runner] = res.blocking.pairs
    assert sets["srp", "sequential"] == sets["srp", "vmap"]
    full = {sets[k] for k in sets if k[0] != "srp"}
    assert len(full) == 1


def test_partition_functions_equal_reference():
    keys = np.random.default_rng(4).integers(0, 500, size=2000) \
        .astype(np.int32)
    keys[:700] = 250                                    # a hot key
    for r in (1, 2, 5, 8):
        np.testing.assert_array_equal(
            to_np(TP.balanced_partition(keys, r)),
            np.asarray(RP.balanced_partition(keys, r)))
        np.testing.assert_array_equal(to_np(TP.range_partition(500, r)),
                                      np.asarray(RP.range_partition(500, r)))
        np.testing.assert_array_equal(
            to_np(TP.sample_partition(torch.from_numpy(keys), r)),
            np.asarray(RP.sample_partition(keys, r)))
        b = RP.balanced_partition(keys, r)
        np.testing.assert_array_equal(
            to_np(TP.shard_of(torch.from_numpy(np.array(b)),
                              torch.from_numpy(keys))),
            np.asarray(RP.shard_of(b, keys)))
