"""Parity of the port's out-of-core streaming (``repro_torch.stream``)
with the reference's ``repro.stream`` on the CPU.

The same numpy chunks go through both packages (JAX on the CPU, the
pallas engine as the reference's own tests run it); every field of the
result contract, every ``StreamStats`` field (the executable-cache
counters too: both caches are emptied before each pair of runs), the
overflow-recovery stats and the metrics must be identical:

  * every variant x band engine at a fixed chunking, random chunkings
    (chunk_size < w included), spooled and in-memory runs
  * SRP under each planner, the sequential runner, multi-pass, adaptive
    (and pruned) streams, metrics, ``link_stream``
  * a second stream of the same shapes replays every chunk (zero traces)
  * a stream on the shard_map runner's world-size-1 gloo mesh
  * the units: sorted runs, ``merged_blocks``, ``rechunk``, ``ChunkStore``
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import (assert_same_stream, clear_caches,  # noqa: E402
                           gloo_mesh)
from repro import api as RA  # noqa: E402
from repro import stream as RS  # noqa: E402
from repro.core import entities as RE  # noqa: E402
from repro_torch import api as TA  # noqa: E402
from repro_torch import stream as TS  # noqa: E402
from repro_torch.core import entities as TE  # noqa: E402

N, R, W = 700, 4, 6
VARIANTS = ["srp", "repsn", "jobsn"]
ENGINES = ["scan", "pallas"]


def _kw(**kw):
    kw.setdefault("window", W)
    kw.setdefault("num_shards", R)
    kw.setdefault("variant", "repsn")
    kw.setdefault("hops", R - 1)
    kw.setdefault("runner", "vmap")
    return kw


def _passes(pkg):
    return (pkg.SortKeySpec(name="key"),
            pkg.SortKeySpec(name="text1", source="text", kind="prefix",
                            offset=1, width=2))


@pytest.fixture(scope="module")
def host():
    """The reference's synthetic corpus as one host numpy dict."""
    ents = RE.synth_entities(np.random.default_rng(5), N, n_keys=90,
                             dup_frac=0.25, text_len=8)
    return RE.to_host(ents)


def _chunks_of(h, sizes):
    out, s = [], 0
    for sz in sizes:
        out.append(RE.host_take(h, slice(s, s + sz)))
        s += sz
    assert s == h["key"].shape[0]
    return out


def _even(h, sz):
    n = int(h["key"].shape[0])
    return [RE.host_take(h, slice(s, min(s + sz, n)))
            for s in range(0, n, sz)]


def _both(chunks, kw, ref_kw=None, **stream_kw):
    """(reference, port) StreamResults of the same chunks under one kwargs
    dict (``ref_kw`` overrides reference-only stream arguments), both
    from an empty executable cache."""
    clear_caches()
    ref = RS.resolve_stream(chunks, RA.ERConfig(**kw),
                            **dict(stream_kw, **(ref_kw or {})))
    port = TS.resolve_stream(chunks, TA.ERConfig(**kw), device="cpu",
                             **stream_kw)
    return ref, port


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_stream_matches_reference(host, variant, engine):
    ref, port = _both(_even(host, 175), _kw(variant=variant,
                                            band_engine=engine),
                      chunk_size=175)
    assert_same_stream(ref, port)
    assert port.stream.chunks == 4 and port.stream.entities == N
    assert port.stream.carry_entities == (W - 1) * 3
    assert port.stream.chunk_device_bytes < port.stream.corpus_bytes / 2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_chunkings_match_reference(host, seed):
    """Random input chunk sizes and a random device chunk_size — below the
    window for seed 0 (on the first 240 rows: one device call a chunk),
    so every chunk of that boundary-complete run collapses to one
    shard."""
    rng = np.random.default_rng(seed)
    h = RE.host_take(host, slice(0, 240)) if seed == 0 else host
    sizes, left = [], int(h["key"].shape[0])
    while left:
        s = int(rng.integers(1, min(left, 130) + 1))
        sizes.append(s)
        left -= s
    chunk_size = int(rng.integers(2, W)) if seed == 0 else \
        int(rng.integers(40, 240))
    ref, port = _both(_chunks_of(h, sizes),
                      _kw(variant=["jobsn", "srp", "repsn"][seed],
                          band_engine="pallas"),
                      chunk_size=chunk_size)
    assert_same_stream(ref, port)
    if seed == 0:
        assert port.stream.degenerate_chunks == port.stream.chunks


def test_spooled_stream_matches_reference(host, tmp_path):
    """Spooled runs write the reference's files: the same spool bytes,
    and the same pairs as the in-memory run."""
    kw = _kw(band_engine="pallas")
    ref, port = _both(_even(host, 175), kw, chunk_size=175,
                      ref_kw={"spool_dir": str(tmp_path / "ref")},
                      spool_dir=str(tmp_path / "port"))
    assert_same_stream(ref, port)
    assert port.stream.spooled_bytes > 0
    mem = TS.resolve_stream(_even(host, 175), TA.ERConfig(**kw),
                            chunk_size=175, device="cpu")
    assert mem.pairs == port.pairs and mem.matches == port.matches
    assert mem.stream.spooled_bytes == 0
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "ref"))


@pytest.mark.parametrize("partitioner",
                         ["balanced", "uniform", "blocksplit", "pairrange"])
def test_srp_stream_under_each_planner(host, partitioner):
    """SRP's pair set depends on the plan: the merged profile must give
    the reference's global plan and rank routing under every planner."""
    ref, port = _both(_even(host, 200), _kw(variant="srp",
                                            partitioner=partitioner),
                      chunk_size=160)
    assert_same_stream(ref, port)


def test_srp_stream_metrics(host):
    ref, port = _both(_even(host, 175), _kw(variant="srp",
                                            compute_metrics=True),
                      chunk_size=175)
    assert_same_stream(ref, port)
    assert port.metrics.pairs_completeness < 1.0


def test_sequential_runner_stream(host):
    ref, port = _both(_even(host, 180), _kw(variant="srp",
                                            runner="sequential"),
                      chunk_size=180)
    assert_same_stream(ref, port)


def test_multipass_stream(host, tmp_path):
    clear_caches()
    ref = RS.resolve_stream(_even(host, 175), RA.ERConfig(
        **_kw(passes=_passes(RA))), chunk_size=175,
        spool_dir=str(tmp_path / "ref"))
    port = TS.resolve_stream(_even(host, 175), TA.ERConfig(
        **_kw(passes=_passes(TA))), chunk_size=175,
        spool_dir=str(tmp_path / "port"), device="cpu")
    assert_same_stream(ref, port)
    assert len(port.pairs) > len(port.passes[0].pairs)


@pytest.mark.parametrize("variant,engine,prune",
                         [("repsn", "pallas", False), ("srp", "scan", True),
                          ("jobsn", "pallas", True)])
def test_adaptive_stream(host, variant, engine, prune):
    kw = _kw(variant=variant, band_engine=engine, window=3,
             window_policy="adaptive", window_max=10)
    if prune:
        kw.update(prune_policy="evidence", prune_threshold=0.55)
    ref, port = _both(_chunks_of(host, [130, 7, 300, 263]), kw,
                      chunk_size=150)
    assert_same_stream(ref, port)
    assert port.stream.carry_entities == 9 * (port.stream.chunks - 1)
    if prune:
        assert port.blocking.pruned > 0


def test_link_stream_matches_reference():
    rng = np.random.default_rng(12)
    lhs = RE.to_host(RE.synth_entities(rng, 260, n_keys=50))
    rhs = RE.to_host(RE.synth_entities(rng, 220, n_keys=50))
    kw = _kw(compute_metrics=True)
    clear_caches()
    ref = RS.link_stream(_even(lhs, 100), _even(rhs, 90),
                         RA.ERConfig(**kw), chunk_size=150)
    port = TS.link_stream(_even(lhs, 100), _even(rhs, 90),
                          TA.ERConfig(**kw), chunk_size=150, device="cpu")
    assert_same_stream(ref, port)
    assert all(0 <= a < 260 and 0 <= b < 220 for a, b in port.pairs)


def test_port_entity_chunks_stream_like_host_chunks(host):
    """Chunks given as port tensors stream exactly like host numpy."""
    kw = _kw(band_engine="pallas")
    chunks = _even(host, 175)
    a = TS.resolve_stream(chunks, TA.ERConfig(**kw), chunk_size=175,
                          device="cpu")
    b = TS.resolve_stream([TE.from_numpy(c, "cpu") for c in chunks],
                          TA.ERConfig(**kw), chunk_size=175, device="cpu")
    assert a.pairs == b.pairs and a.matches == b.matches


def test_stream_refuses_what_is_not_ported(host):
    cfg = TA.ERConfig(**_kw())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TS.resolve_stream(_even(host, 350), cfg)


def test_second_stream_is_steady(host):
    """Zero-retrace (DESIGN.md invariant 10): after one stream, a second of
    the same shapes rebuilds and retraces nothing — every chunk steady,
    as the reference's."""
    kw = _kw(band_engine="pallas")
    clear_caches()
    for pkg, stream, extra in ((RA, RS, {}), (TA, TS, {"device": "cpu"})):
        first = stream.resolve_stream(_even(host, 175), pkg.ERConfig(**kw),
                                      chunk_size=175, **extra)
        again = stream.resolve_stream(_even(host, 175), pkg.ERConfig(**kw),
                                      chunk_size=175, **extra)
        st = again.stream
        assert st.traces == 0 and st.cache_misses == 0
        assert st.steady_chunks == st.chunks and st.cache_hits >= st.chunks
        assert again.pairs == first.pairs and again.matches == first.matches
        assert first.stream.traces >= 1
        if pkg is RA:
            ref_first, ref_again = first, again
    assert_same_stream(ref_first, first)
    assert_same_stream(ref_again, again)


@pytest.mark.parametrize("variant", VARIANTS)
def test_stream_with_mesh_equals_vmap_stream(host, gloo_mesh, variant):
    """``mesh=`` reaches the shard_map runner: at world size 1 its stream
    gives the vmap stream's pairs, matches and accounting."""
    kw = _kw(variant=variant, band_engine="pallas", num_shards=1, hops=1)
    vm = TS.resolve_stream(_even(host, 175), TA.ERConfig(**kw),
                           chunk_size=175, device="cpu")
    sm = TS.resolve_stream(_even(host, 175), TA.ERConfig(
        **dict(kw, runner="shard_map")), chunk_size=175, mesh=gloo_mesh,
        device="cpu")
    assert sm.pairs == vm.pairs and sm.matches == vm.matches
    for f in ("load", "overflow", "cand_count", "cand_overflow",
              "matcher_evals", "pair_overflow"):
        assert getattr(sm.blocking, f) == getattr(vm.blocking, f), f
    assert sm.blocking.runner == "shard_map"


def test_stream_rejects_what_monolithic_rejects():
    keys = np.arange(12, dtype=np.int32) % 4 * 3
    small = {"key": keys, "eid": np.arange(12, dtype=np.int32),
             "valid": np.ones(12, bool),
             "payload": {"feat": np.ones((12, 4), np.float32)}}
    kw = dict(window=8, variant="repsn", hops=1, runner="vmap",
              num_shards=4, partitioner="uniform")
    with pytest.raises(ValueError, match="hops"):
        RS.resolve_stream([small], RA.ERConfig(**kw), chunk_size=6)
    with pytest.raises(ValueError, match="hops"):
        TS.resolve_stream([small], TA.ERConfig(**kw), chunk_size=6,
                          device="cpu")


# -- units --------------------------------------------------------------------

def _assert_same_host(a, b):
    """Two host entity dicts equal, signatures compared as bits."""
    for f in ("key", "eid", "valid"):
        np.testing.assert_array_equal(a[f], b[f])
    assert sorted(a["payload"]) == sorted(b["payload"])
    for k in a["payload"]:
        x, y = np.asarray(a["payload"][k]), np.asarray(b["payload"][k])
        if x.dtype != y.dtype:
            assert {x.dtype, y.dtype} == {np.dtype(np.uint32),
                                          np.dtype(np.int32)}, k
            y = y.view(x.dtype)
        np.testing.assert_array_equal(x, y)


def _runs(host, sizes):
    """The same chunks as sorted runs by each package (device sorts)."""
    from repro.stream.store import ChunkStore as RStore
    ref_runs, port_runs = RStore(), TS.ChunkStore()
    for c in _chunks_of(host, sizes):
        ref_runs.append(RE.sort_chunk(RE.make_entities(
            c["key"], c["eid"], payload=c["payload"], valid=c["valid"])))
        port_runs.append(TE.sort_chunk(TE.from_numpy(c, "cpu")))
    return ref_runs, port_runs


def test_sorted_runs_and_merge_match_reference(host):
    from repro.stream.external_sort import merged_blocks as ref_merged
    ref_runs, port_runs = _runs(host, [200, 300, 150, 50])
    for i in range(len(ref_runs)):
        _assert_same_host(ref_runs.load(i), port_runs.load(i))
    ref_blocks = list(ref_merged(ref_runs, 128))
    port_blocks = list(TS.merged_blocks(port_runs, 128))
    assert len(ref_blocks) == len(port_blocks)
    for a, b in zip(ref_blocks, port_blocks):
        _assert_same_host(a, b)
    merged = TE.host_concat(port_blocks)
    order = np.lexsort((host["eid"], host["key"]))
    np.testing.assert_array_equal(merged["eid"], host["eid"][order])
    with pytest.raises(ValueError, match="block"):
        next(TS.merged_blocks(port_runs, 0))


def test_rechunk_matches_reference(host):
    from repro.stream.external_sort import rechunk as ref_rechunk
    sizes = [37, 211, 3, 149, 300]
    ref = list(ref_rechunk(iter(_chunks_of(host, sizes)), 128))
    port = list(TS.rechunk(iter(_chunks_of(host, sizes)), 128))
    assert [int(c["key"].shape[0]) for c in port] == \
        [int(c["key"].shape[0]) for c in ref] == [128] * 5 + [60]
    for a, b in zip(ref, port):
        _assert_same_host(a, b)
    with pytest.raises(ValueError, match="size"):
        next(TS.rechunk(iter(ref), 0))


def test_chunk_store_files_match_reference(host, tmp_path):
    """The port's spool files hold the reference's members and dtypes
    (uint32 signatures on disk), and each package reads the other's."""
    from repro.stream.store import ChunkStore as RStore
    chunks = _chunks_of(host, [300, 400])
    ref = RStore(str(tmp_path / "ref"))
    port = TS.ChunkStore(str(tmp_path / "port"))
    for c in chunks:
        ref.append(c)
        # the port's own host form: int32 signature views
        port.append(TE.to_host(TE.from_numpy(c, "cpu")))
    assert port.spooled_bytes == ref.spooled_bytes
    assert port.n_entities == ref.n_entities == N
    for name in sorted(os.listdir(tmp_path / "ref")):
        with np.load(tmp_path / "ref" / name) as a, \
                np.load(tmp_path / "port" / name) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k])
    cross = TS.ChunkStore.attach(str(tmp_path / "ref"), "chunk", count=2)
    for i, c in enumerate(chunks):
        got = cross.load(i)
        assert got["payload"]["sig"].dtype == np.int32
        _assert_same_host(c, got)
        idx = cross.load_index(i)
        np.testing.assert_array_equal(idx["key"], c["key"])
        np.testing.assert_array_equal(idx["eid"], c["eid"])
        assert cross.load_field(i, "sig").dtype == np.int32
    assert cross.payload_fields() == ref.payload_fields()
