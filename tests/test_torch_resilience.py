"""Parity of the port's checkpointed streaming and fault injection
(``repro_torch.resilience``, ``repro_torch.api.resume``) with the
reference on the CPU (invariant 11).

  * kill at every chunk boundary, alternating a clean kill after the
    commit and a torn kill between spool and commit, for every variant x
    band engine: the resumed port run equals the reference's
    uninterrupted stream (every result and stream field, the executable-
    cache counters included: each killed run starts from an empty cache)
  * a mid-ingest kill (``flaky_chunks``), re-running the same call as a
    resume, resuming a finished run, multi-pass checkpoints
  * the resume guards: config and chunk-grid drift, ``compute_metrics``
    with a checkpoint, ``fault_plan`` without one, missing spool files
  * across packages: a checkpoint the reference wrote and killed resumes
    in the port to the reference's union and to the reference's own
    resume of it, and the two packages write the same manifest and the
    same file members for the same run
  * ``api.resume`` with ``mesh=``: the shard_map runner's resume
  * the overflow ladder on a stream, ``ChunkStore`` crash hygiene, and
    the fault plans themselves
"""
import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import (assert_same_result, assert_same_stream,  # noqa: E402,E501
                           clear_caches, gloo_mesh)
from repro import api as RA  # noqa: E402
from repro import resilience as RZ  # noqa: E402
from repro import stream as RS  # noqa: E402
from repro.core import entities as RE  # noqa: E402
from repro_torch import api as TA  # noqa: E402
from repro_torch import resilience as TZ  # noqa: E402
from repro_torch import stream as TS  # noqa: E402
from repro_torch.perf import executable_cache  # noqa: E402

N, R, W = 360, 4, 6
CHUNK = 60
N_CHUNKS = N // CHUNK
VARIANTS = ["srp", "repsn", "jobsn"]
ENGINES = ["scan", "pallas"]


def _kw(**kw):
    kw.setdefault("window", W)
    kw.setdefault("num_shards", R)
    kw.setdefault("variant", "repsn")
    kw.setdefault("hops", R - 1)
    kw.setdefault("runner", "vmap")
    return kw


@pytest.fixture(scope="module")
def host():
    ents = RE.synth_entities(np.random.default_rng(11), N, n_keys=60,
                             dup_frac=0.25, text_len=8)
    return RE.to_host(ents)


def _chunks(h, sz=CHUNK):
    n = int(h["key"].shape[0])
    return [RE.host_take(h, slice(s, min(s + sz, n)))
            for s in range(0, n, sz)]


def _fault(pkg, k):
    """Clean kill after chunk k's commit for even k, torn kill between its
    spool and its commit for odd k: both seams get every index."""
    return pkg.FaultPlan(crash_after_chunk=k) if k % 2 == 0 \
        else pkg.FaultPlan(crash_before_commit=k)


def _ref_stream(h, kw, d):
    """The reference's uninterrupted run, checkpointed into ``d`` so its
    spool bytes are counted like the port's checkpointed runs; both
    packages' caches are emptied first."""
    clear_caches()
    return RS.resolve_stream(_chunks(h), RA.ERConfig(**kw),
                             chunk_size=CHUNK, checkpoint_dir=str(d))


def _port_stream(h, kw, **stream_kw):
    return TS.resolve_stream(_chunks(h), TA.ERConfig(**kw),
                             chunk_size=CHUNK, device="cpu", **stream_kw)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_kill_at_every_chunk_boundary(tmp_path, host, variant, engine):
    kw = _kw(variant=variant, band_engine=engine)
    ref = _ref_stream(host, kw, tmp_path / "ref")
    for k in range(N_CHUNKS):
        d = str(tmp_path / f"{variant}-{engine}-{k}")
        executable_cache().clear()      # the uninterrupted run's start
        with pytest.raises(TZ.InjectedFault):
            _port_stream(host, kw, checkpoint_dir=d,
                         fault_plan=_fault(TZ, k))
        res = TA.resume(d, device="cpu")
        assert_same_stream(ref, res)


def test_mid_ingest_kill_resumes_with_fresh_iterator(tmp_path, host):
    kw = _kw()
    ref = _ref_stream(host, kw, tmp_path / "ref")
    d = str(tmp_path / "ingest")
    with pytest.raises(TZ.InjectedFault):
        TS.resolve_stream(TZ.flaky_chunks(_chunks(host), 3),
                          TA.ERConfig(**kw), chunk_size=CHUNK,
                          checkpoint_dir=d, device="cpu")
    with pytest.raises(ValueError, match="re-supplied"):
        TA.resume(d, device="cpu")
    res = TA.resume(d, chunks=_chunks(host), device="cpu")
    assert_same_stream(ref, res)


def test_rerunning_same_call_is_a_resume(tmp_path, host):
    kw = _kw(band_engine="pallas")
    ref = _ref_stream(host, kw, tmp_path / "ref")
    d = str(tmp_path / "rerun")
    with pytest.raises(TZ.InjectedFault):
        _port_stream(host, kw, checkpoint_dir=d,
                     fault_plan=TZ.FaultPlan(crash_after_chunk=2))
    assert_same_stream(ref, _port_stream(host, kw, checkpoint_dir=d))
    # a finished checkpoint replays to the identical result
    assert_same_stream(ref, TA.resume(d, device="cpu"))


def test_multipass_checkpoint_resume(tmp_path, host):
    def passes(pkg):
        return (pkg.SortKeySpec(name="fwd", source="key"),
                pkg.SortKeySpec(name="sig", source="text", kind="prefix",
                                width=3))
    ref = _ref_stream(host, _kw(passes=passes(RA)), tmp_path / "ref")
    cfg = TA.ERConfig(**_kw(passes=passes(TA)))
    d = str(tmp_path / "mp")
    with pytest.raises(TZ.InjectedFault):
        TS.resolve_stream(
            _chunks(host), cfg, chunk_size=CHUNK, checkpoint_dir=d,
            fault_plan=TZ.FaultPlan(crash_after_chunk=1, label="sig"),
            device="cpu")
    assert_same_stream(ref, TA.resume(d, device="cpu"))


def test_resume_guards(tmp_path, host):
    kw = _kw()
    cfg = TA.ERConfig(**kw)
    with pytest.raises(FileNotFoundError):
        TA.resume(str(tmp_path / "nowhere"), device="cpu")
    d = str(tmp_path / "guards")
    _port_stream(host, kw, checkpoint_dir=d)
    with pytest.raises(ValueError, match="fingerprint"):
        TZ.resume_stream(d, cfg=cfg.with_(window=W + 2), device="cpu")
    with pytest.raises(ValueError, match="chunk_size"):
        TS.resolve_stream(_chunks(host), cfg, chunk_size=CHUNK + 1,
                          checkpoint_dir=d, device="cpu")
    with pytest.raises(ValueError, match="fingerprint|setup"):
        TZ.resume_stream(d, cfg=cfg.with_(num_shards=R * 2), device="cpu")
    # spool files deleted behind the manifest's back
    os.remove(os.path.join(d, "raw", "raw000003.npz"))
    with pytest.raises(FileNotFoundError, match="committed"):
        TA.resume(d, device="cpu")
    with pytest.raises(ValueError, match="compute_metrics"):
        _port_stream(host, _kw(compute_metrics=True),
                     checkpoint_dir=str(tmp_path / "m"))
    with pytest.raises(ValueError, match="checkpoint_dir"):
        _port_stream(host, kw, fault_plan=TZ.FaultPlan(crash_after_chunk=0))
    # a manifest from a newer format is refused, not misread
    d2 = str(tmp_path / "version")
    _port_stream(host, kw, checkpoint_dir=d2)
    path = os.path.join(d2, "MANIFEST.json")
    with open(path) as f:
        manifest = json.load(f)
    manifest["version"] = 2
    with open(path, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(ValueError, match="version"):
        TA.resume(d2, device="cpu")


# -- across packages ----------------------------------------------------------

@pytest.mark.parametrize("engine", ENGINES)
def test_reference_checkpoint_resumes_in_port(tmp_path, host, engine):
    kw = _kw(variant="repsn" if engine == "pallas" else "srp",
             band_engine=engine)
    ref = _ref_stream(host, kw, tmp_path / "ref")
    for k in range(N_CHUNKS):
        d = str(tmp_path / f"{engine}-{k}")
        with pytest.raises(RZ.InjectedFault):
            RS.resolve_stream(_chunks(host), RA.ERConfig(**kw),
                              chunk_size=CHUNK, checkpoint_dir=d,
                              fault_plan=_fault(RZ, k))
        shutil.copytree(d, d + "-ref")
        # the reference's cache counters of the committed chunks carry
        # over; a resume from an empty cache rebuilds its first program,
        # in either package
        clear_caches()
        own = RA.resume(d + "-ref")
        res = TA.resume(d, device="cpu")
        assert_same_result(ref, res)
        assert_same_stream(own, res)


def test_manifest_without_pruned_resumes(tmp_path, host):
    """A pass manifest written before evidence pruning has no ``pruned``
    counter: the resume counts it from 0, so the result holds the pruning
    of the chunks resolved after the kill only, in both packages, and
    every pair set is the uninterrupted run's."""
    kw = _kw(variant="jobsn", band_engine="pallas",
             prune_policy="evidence", prune_threshold=0.55)
    full = _ref_stream(host, kw, tmp_path / "ref")
    d = str(tmp_path / "old")
    with pytest.raises(RZ.InjectedFault):
        RS.resolve_stream(_chunks(host), RA.ERConfig(**kw),
                          chunk_size=CHUNK, checkpoint_dir=d,
                          fault_plan=RZ.FaultPlan(crash_after_chunk=2))
    manifest = _manifest(d)
    committed = manifest["passes"]["key"].pop("pruned")
    assert committed > 0
    with open(os.path.join(d, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f)
    shutil.copytree(d, d + "-ref")
    clear_caches()
    own = RA.resume(d + "-ref")
    res = TA.resume(d, device="cpu")
    assert_same_stream(own, res)
    assert res.pairs == full.pairs and res.matches == full.matches
    assert res.blocking.pruned == full.blocking.pruned - committed


def _manifest(d):
    with open(os.path.join(d, "MANIFEST.json")) as f:
        return json.load(f)


def test_checkpoint_files_match_reference(tmp_path, host):
    kw = _kw(band_engine="pallas", window_policy="adaptive", window=3,
             window_max=8)
    dr, dp = str(tmp_path / "ref"), str(tmp_path / "port")
    clear_caches()
    ref = RS.resolve_stream(_chunks(host), RA.ERConfig(**kw),
                            chunk_size=CHUNK, checkpoint_dir=dr)
    port = _port_stream(host, kw, checkpoint_dir=dp)
    assert_same_stream(ref, port)
    assert _manifest(dp) == _manifest(dr)
    names = sorted(os.path.relpath(os.path.join(a, f), dr)
                   for a, _, fs in os.walk(dr) for f in fs)
    assert names == sorted(os.path.relpath(os.path.join(a, f), dp)
                           for a, _, fs in os.walk(dp) for f in fs)
    for name in names:
        if not name.endswith(".npz"):
            continue
        with np.load(os.path.join(dr, name)) as a, \
                np.load(os.path.join(dp, name)) as b:
            assert sorted(a.files) == sorted(b.files), name
            for k in a.files:
                assert a[k].dtype == b[k].dtype, (name, k)
                np.testing.assert_array_equal(a[k], b[k])


# -- overflow ladder, store hygiene, fault plans ------------------------------

def test_retry_ladder_on_a_stream_matches_reference(host):
    kw = _kw(variant="srp", emit="pairs", partitioner="uniform",
             pair_cap=32, on_overflow="retry", retry_limit=8)
    clear_caches()
    ref = RS.resolve_stream(_chunks(host), RA.ERConfig(**kw),
                            chunk_size=CHUNK)
    port = _port_stream(host, kw)
    assert_same_stream(ref, port)
    assert port.resilience.retries > 0
    assert port.blocking.pair_overflow == 0
    tiny = TZ.micro_caps(TA.ERConfig(**kw), pair_cap=8)
    assert (tiny.cand_cap, tiny.pair_cap) == (2, 8)


@pytest.mark.parametrize("variant", VARIANTS)
def test_resume_on_a_mesh(tmp_path, host, gloo_mesh, variant):
    """``api.resume(mesh=...)`` resumes a killed shard_map stream on the
    world-size-1 gloo mesh to the uninterrupted run's result."""
    kw = _kw(variant=variant, band_engine="pallas", runner="shard_map",
             num_shards=1, hops=1)
    whole = _port_stream(host, kw, mesh=gloo_mesh)
    d = str(tmp_path / variant)
    executable_cache().clear()
    with pytest.raises(TZ.InjectedFault):
        _port_stream(host, kw, mesh=gloo_mesh, checkpoint_dir=d,
                     fault_plan=TZ.FaultPlan(crash_before_commit=3))
    res = TA.resume(d, mesh=gloo_mesh, device="cpu")
    assert_same_result(whole, res)
    assert res.blocking.runner == "shard_map"


def test_chunk_store_crash_hygiene(tmp_path, host):
    from repro_torch.stream.store import atomic_savez
    store = TS.ChunkStore(str(tmp_path), prefix="c")
    hs = _chunks(host, 90)
    for h in hs:
        store.append(h)
    assert sorted(os.listdir(tmp_path)) == \
        [f"c{i:06d}.npz" for i in range(len(hs))]
    (tmp_path / "c000099.npz.tmp").write_bytes(b"torn")
    att = TS.ChunkStore.attach(str(tmp_path), "c", count=2)
    assert len(att) == 2
    assert sorted(os.listdir(tmp_path)) == ["c000000.npz", "c000001.npz"]
    np.testing.assert_array_equal(att.load(1)["key"], hs[1]["key"])
    with pytest.raises(FileNotFoundError, match="committed"):
        TS.ChunkStore.attach(str(tmp_path), "c", count=5)
    os.remove(tmp_path / "c000000.npz")
    att.dispose()                            # a missing file is no error
    assert os.listdir(tmp_path) == [] and att.spooled_bytes == 0
    p = str(tmp_path / "x.npz")
    atomic_savez(p, a=np.arange(4))
    atomic_savez(p, a=np.arange(9))
    with np.load(p) as z:
        assert z["a"].shape == (9,)
    assert not os.path.exists(p + ".tmp")


def test_fault_plans_match_reference():
    for pkg in (RZ, TZ):
        plan = pkg.FaultPlan(crash_before_commit=1, label="key")
        plan.before_commit("other", 1)           # another pass: no crash
        plan.after_commit("key", 1)
        with pytest.raises(pkg.InjectedFault, match="before committing"):
            plan.before_commit("key", 1)
        assert list(pkg.flaky_chunks(iter(range(5)), 9)) == list(range(5))
        with pytest.raises(pkg.InjectedFault, match="after 2"):
            list(pkg.flaky_chunks(iter(range(5)), 2))
        with pytest.raises(ValueError, match="kind"):
            pkg.ChaosEvent(batch=0, kind="boom")
        chaos = pkg.ChaosPlan(events=(pkg.ChaosEvent(batch=3, kind="error"),
                                      pkg.ChaosEvent(batch=1,
                                                     kind="latency")))
        chaos.on_batch(1)
        with pytest.raises(pkg.InjectedFault, match="batch 3"):
            chaos.on_batch(3)
    assert sorted(TZ.__all__) == sorted(RZ.__all__)
