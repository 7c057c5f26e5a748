"""The port's executable cache (``repro_torch.perf``) against the
reference's (``repro.perf``) on the CPU.

The cases of ``tests/test_exec_cache.py`` on the port: after one warm call
a same-shaped call builds and traces nothing; bounds values are not keyed;
each static config change and each shape change misses; ``jit_cache=False``
bypasses the cache; LRU eviction bounds it; the sequential scorer's padded
tail reuses one program.  Then parity: ``PerfStats`` of one sequence of
calls equal the reference's field by field (both caches emptied first),
and the emitted pairs equal the band extraction and the reference's for
every variant x {vmap, shard_map} x {scan, pallas}.  On the CPU the
port's cache holds built callables; the card's CUDA graphs are held by
``tests/test_torch_kernels_gpu.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import clear_caches, gloo_mesh, port_ents  # noqa: E402
from repro import api as RA  # noqa: E402
from repro.core import entities as RE  # noqa: E402
from repro.core import partition as RP  # noqa: E402
from repro_torch import api as TA  # noqa: E402
from repro_torch.api.runners import _to_host  # noqa: E402
from repro_torch.perf import ExecutableCache, executable_cache  # noqa: E402

N, R, WIN, NK = 240, 4, 6, 64
VARIANTS = ["srp", "repsn", "jobsn"]
ENGINES = ["scan", "pallas"]


@pytest.fixture(scope="module")
def ents():
    return RE.synth_entities(np.random.default_rng(7), N, n_keys=NK,
                             dup_frac=0.25, text_len=12)


@pytest.fixture(scope="module")
def tents(ents):
    return port_ents(ents)


@pytest.fixture(scope="module")
def bounds(ents):
    return np.asarray(RP.balanced_partition(np.asarray(ents["key"]), R),
                      np.int32)


def _kw(**kw):
    kw.setdefault("window", WIN)
    kw.setdefault("num_shards", R)
    kw.setdefault("hops", R - 1)
    return kw


def _cfg(**kw):
    return TA.ERConfig(**_kw(**kw))


def _resolve(ents, cfg, **kw):
    return TA.resolve(ents, cfg, device="cpu", **kw)


# -- the reference's cache cases, on the port --------------------------------

def test_second_call_zero_new_traces(tents, bounds):
    executable_cache().clear()
    cfg = _cfg(variant="repsn", runner="vmap")
    first = _resolve(tents, cfg, bounds=bounds)
    assert first.perf.cache_misses >= 1
    assert first.perf.traces == first.perf.cache_misses
    second = _resolve(tents, cfg, bounds=bounds)
    assert second.perf.traces == 0 and second.perf.cache_misses == 0
    assert second.perf.cache_hits >= 1 and second.perf.steady_state
    assert second.blocking.pairs == first.blocking.pairs
    assert second.matches == first.matches


def test_bounds_values_are_traced_not_keyed(tents, bounds):
    """Replanned boundaries of the same shape share one program."""
    cfg = _cfg(variant="srp", runner="vmap")
    _resolve(tents, cfg, bounds=bounds)
    moved = _resolve(tents, cfg, bounds=bounds + 1)
    assert moved.perf.traces == 0 and moved.perf.steady_state


@pytest.mark.parametrize("change", [
    {"window": WIN + 1},
    {"band_engine": "pallas"},
    {"cand_cap": 64, "band_engine": "pallas"},
    {"emit": "pairs"},
], ids=["window", "engine", "cand_cap", "emit"])
def test_static_cfg_change_misses(tents, bounds, change):
    cfg = _cfg(variant="repsn", runner="vmap")
    _resolve(tents, cfg, bounds=bounds)
    assert _resolve(tents, cfg, bounds=bounds).perf.steady_state
    changed = _resolve(tents, cfg.with_(**change), bounds=bounds)
    assert changed.perf.cache_misses >= 1
    assert changed.perf.traces == changed.perf.cache_misses


def test_shape_change_misses(tents, bounds):
    cfg = _cfg(variant="repsn", runner="vmap")
    _resolve(tents, cfg, bounds=bounds)
    smaller = port_ents(RE.synth_entities(np.random.default_rng(8), N - 40,
                                          n_keys=NK, dup_frac=0.25,
                                          text_len=12))
    assert _resolve(smaller, cfg, bounds=bounds).perf.cache_misses >= 1


def test_jit_cache_off_bypasses(tents, bounds):
    cfg = _cfg(variant="repsn", runner="vmap", jit_cache=False)
    on = _resolve(tents, cfg.with_(jit_cache=True), bounds=bounds)
    off = _resolve(tents, cfg, bounds=bounds)
    assert (off.perf.cache_hits, off.perf.cache_misses,
            off.perf.traces) == (0, 0, 0)
    assert not off.perf.steady_state
    assert off.blocking.pairs == on.blocking.pairs
    assert off.matches == on.matches


def test_shard_map_second_call_steady(tents, gloo_mesh):
    cfg = _cfg(variant="jobsn", runner="shard_map", num_shards=1, hops=1)
    b = TA.default_bounds(tents, cfg, 1)
    _resolve(tents, cfg, bounds=b, mesh=gloo_mesh)
    res = _resolve(tents, cfg, bounds=b, mesh=gloo_mesh)
    assert res.perf.steady_state and res.perf.cache_hits >= 1


def test_lru_eviction_bounds_cache():
    cache = ExecutableCache(max_entries=2)
    calls = []
    for k in ["a", "b", "c"]:
        cache.get_or_build(k, lambda k=k: lambda: calls.append(k))()
    assert calls == ["a", "b", "c"] and cache.stats.traces == 3
    assert len(cache) == 2 and cache.stats.evictions == 1
    cache.get_or_build("c", lambda: (lambda: None))      # hit, no rebuild
    assert cache.stats.hits == 1
    cache.get_or_build("a", lambda: (lambda: None))      # evicted: rebuilds
    assert cache.stats.misses == 4
    cache.clear()
    assert len(cache) == 0 and cache.stats.misses == 4


def test_graph_budget_leaves_cpu_entries(monkeypatch):
    """The graph byte budget evicts only graphs on a card: CPU entries hold
    none, so a budget of 0 bytes keeps them all."""
    from repro_torch.perf import cache as PC
    monkeypatch.setattr(PC, "GRAPH_MEMORY_SHARE", 0.0)
    cache = ExecutableCache()
    x = torch.ones(4)
    for k in ["a", "b", "c"]:
        assert torch.equal(cache.get_or_build(k, lambda: torch.neg)(x), -x)
    assert len(cache) == 3 and cache.stats.evictions == 0
    assert cache.stats.snapshot() == (0, 3, 3)
    assert cache.graph_bytes("cpu") == 0


def test_seq_match_tail_padding_one_program(tents, bounds):
    """A chunk size that does not divide the pair count pads the tail: the
    same matches, one scorer program, then pure hits."""
    cache = executable_cache()
    cfg = _cfg(variant="repsn", runner="sequential")
    big = TA.SequentialRunner(num_shards=R).resolve(tents, bounds, cfg)
    cache.clear()
    h0, m0, t0 = cache.stats.snapshot()
    small = TA.SequentialRunner(num_shards=R, match_chunk=128).resolve(
        tents, bounds, cfg)
    h1, m1, t1 = cache.stats.snapshot()
    assert len(small.blocked) > 128          # more than one chunk
    assert small.matched == big.matched and small.blocked == big.blocked
    assert m1 - m0 == 1 and t1 - t0 == 1
    TA.SequentialRunner(num_shards=R, match_chunk=128).resolve(
        tents, bounds, cfg)
    h2, m2, t2 = cache.stats.snapshot()
    assert m2 == m1 and t2 == t1 and h2 > h1


def test_tree_fingerprint_keys_shape_dtype_device():
    from repro_torch.perf import tree_fingerprint
    a = {"x": torch.zeros(3, dtype=torch.int32), "y": (torch.ones(2),)}
    assert tree_fingerprint(a) == tree_fingerprint(
        {"y": (torch.zeros(2),), "x": torch.ones(3, dtype=torch.int32)})
    assert tree_fingerprint(a) != tree_fingerprint(
        {"x": torch.zeros(4, dtype=torch.int32), "y": (torch.ones(2),)})
    assert tree_fingerprint(a) != tree_fingerprint(
        {"x": torch.zeros(3, dtype=torch.int64), "y": (torch.ones(2),)})
    assert tree_fingerprint(torch.zeros(1)) != \
        tree_fingerprint(torch.zeros(1, device="meta"))


# -- parity with the reference's cache ------------------------------------------

def test_perf_stats_equal_reference(ents, bounds, gloo_mesh):
    """One sequence of calls — cold, warm, replanned, a static change, the
    sequential scorer, the shard_map runner, a link — gives
    the reference's ``PerfStats`` after each call, field by field."""
    lhs = RE.host_take(RE.to_host(ents), slice(0, 140))
    rhs = RE.host_take(RE.to_host(ents), slice(140, N))
    mk = lambda h: RE.make_entities(h["key"], h["eid"], payload=h["payload"],
                                    valid=h["valid"])
    steps = [
        ("resolve", _kw(variant="repsn", runner="vmap"), bounds),
        ("resolve", _kw(variant="repsn", runner="vmap"), bounds),
        ("resolve", _kw(variant="repsn", runner="vmap"), bounds + 1),
        ("resolve", _kw(variant="repsn", runner="vmap", emit="pairs",
                        band_engine="pallas"), None),
        ("resolve", _kw(variant="jobsn", runner="sequential"), bounds),
        ("resolve", _kw(variant="jobsn", runner="sequential"), bounds),
        ("resolve", _kw(variant="srp", runner="shard_map", num_shards=1,
                        hops=1), None),
        ("resolve", _kw(variant="srp", runner="shard_map", num_shards=1,
                        hops=1), None),
        ("link", _kw(variant="repsn", runner="vmap"), None),
        ("resolve", _kw(variant="repsn", runner="vmap", emit="pairs",
                        band_engine="pallas"), None),
    ]
    clear_caches()
    for i, (kind, kw, b) in enumerate(steps):
        if kind == "resolve":
            ref = RA.resolve(ents, RA.ERConfig(**kw), bounds=b)
            port = TA.resolve(port_ents(ents), TA.ERConfig(**kw), bounds=b,
                              mesh=gloo_mesh, device="cpu")
        else:
            ref = RA.link(mk(lhs), mk(rhs), RA.ERConfig(**kw))
            port = TA.link(port_ents(mk(lhs)), port_ents(mk(rhs)),
                           TA.ERConfig(**kw), device="cpu")
        assert dataclasses.astuple(port.perf) == \
            dataclasses.astuple(ref.perf), (i, kind, ref.perf, port.perf)
        assert port.blocking.pairs == ref.blocking.pairs
        assert port.matches == ref.matches


def _runner(pkg, name, mesh=None):
    if name == "vmap":
        return pkg.VmapRunner(R) if pkg is RA else \
            pkg.VmapRunner(R, device="cpu")
    return pkg.ShardMapRunner() if pkg is RA else \
        pkg.ShardMapRunner(mesh=mesh, device="cpu")


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("runner_name", ["vmap", "shard_map"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_emitted_pairs_bit_identical(ents, bounds, gloo_mesh, variant,
                                     runner_name, engine):
    """Device-emitted packed pairs equal the band extraction, bit for bit,
    and both equal the reference's."""
    r = R if runner_name == "vmap" else 1
    kw = _kw(variant=variant, runner=runner_name, num_shards=r,
             hops=max(r - 1, 1), band_engine=engine,
             cand_cap=256 if engine == "pallas" else 0)
    b = bounds if r == R else np.zeros((0,), np.int32)
    got = {}
    for pkg in (RA, TA):
        runner = _runner(pkg, runner_name, gloo_mesh)
        cfg = pkg.ERConfig(**kw)
        v = pkg.get_variant(variant)
        e = ents if pkg is RA else port_ents(ents)
        host = (lambda o: o) if pkg is RA else _to_host
        got[pkg] = [v.collect(host(runner.run_raw(e, b, c)))
                    for c in (cfg, cfg.with_(emit="pairs"))]
    (ref_band, ref_idx), (band, idx) = got[RA], got[TA]
    for a, c in ((band, idx), (ref_band, band), (ref_idx, idx)):
        np.testing.assert_array_equal(a.blocked, c.blocked)
        np.testing.assert_array_equal(a.matched, c.matched)
    assert idx.blocked.size > 0
