"""The port's CUDA kernels on the card, against their plain PyTorch
versions, and the main path on the card against the CPU.  Every test is
marked ``gpu`` and skips where there is no CUDA card.  This file imports
no JAX, so it runs on a machine without it:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import api as TA  # noqa: E402
from repro_torch.core import entities as TE  # noqa: E402
from repro_torch.core.match import paper_cascade  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

from _torch_parity import cuda, to_np  # noqa: E402,F401

TOL = 1e-5     # tests/test_kernels.py's fused-band tolerance, < GATE_EPS


@pytest.mark.gpu
@pytest.mark.parametrize("m,window,w_cos,w_jac", [
    (1000, 9, 0.25, 0.25), (777, 9, 1.0, 0.0), (777, 9, 0.0, 2.0),
    (700, 256, 0.5, 0.5), (5, 9, 0.5, 0.5)],
    ids=["both", "cos-only", "jac-only", "w256", "m-below-window"])
def test_fused_band_kernel_matches_plain_version(cuda, m, window, w_cos,
                                                 w_jac):
    rng = np.random.default_rng(m + window)
    feat = torch.from_numpy(rng.normal(size=(2, m, 32))
                            .astype(np.float32)).to(cuda)
    sig = torch.from_numpy(rng.integers(-2**31, 2**31, size=(2, m, 8))
                           .astype(np.int32)).to(cuda)
    before = ops.launch_counts()["fused_band"]
    got = ops.fused_cheap_band(feat, sig, window=window, w_cos=w_cos,
                               w_jac=w_jac)
    want = ops.fused_cheap_band_ref(feat, sig, window=window, w_cos=w_cos,
                                    w_jac=w_jac)
    torch.cuda.synchronize()
    assert ops.launch_counts()["fused_band"] == before + 1
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=0, atol=TOL)


def _launched_once(name, fn):
    before = ops.launch_counts()[name]
    out = fn()
    torch.cuda.synchronize()
    assert ops.launch_counts()[name] == before + 1
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("s,m,f,window,dtype", [
    (3, 1000, 32, 9, "f32"), (1, 300, 32, 10, "f32"),
    (1, 128, 256, 128, "f32"), (1, 1024, 256, 200, "f32"),
    (1, 8, 16, 16, "f32"), (2, 1000, 32, 9, "bf16"),
    (1, 1024, 128, 200, "bf16"), (2, 1001, 33, 9, "f32"),
    (2, 999, 64, 9, "f32"), (1, 700, 64, 256, "f32"),
    (2, 1001, 33, 9, "bf16"), (3, 1000, 31, 7, "f32")],
    ids=["shards", "m300", "window-eq-block", "f256-w200", "m-below-window",
         "bf16", "bf16-w200", "f33-unaligned", "f64-wide-rows",
         "f64-w256-halved", "bf16-f33", "f31-window7"])
def test_banded_sim_kernel_matches_plain_version(cuda, s, m, f, window,
                                                 dtype):
    """K2 against its plain version: 1e-5 / atol 1e-4 in f32, 2e-2 / atol
    2e-1 in bf16 (tests/test_kernels.py's tolerances), also at the corners
    of its staged loads and stores: spans not 16-byte aligned (element
    loads, scalar store head and tail), rows wider than the registers
    hold, and a window that halves the row tile."""
    tol = 1e-5 if dtype == "f32" else 2e-2
    feat = torch.from_numpy(np.random.default_rng(m + window).normal(
        size=(s, m, f)).astype(np.float32)).to(cuda)
    if dtype == "bf16":
        feat = feat.bfloat16()
    got = _launched_once("banded_sim", lambda: ops.banded_dot_band(
        feat, window=window))
    want = ref.banded_sim_ref(feat, window=window)
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=tol,
                               atol=tol * 10)


@pytest.mark.gpu
@pytest.mark.parametrize("s,m,words,window,zero", [
    (3, 1000, 8, 9, False), (1, 130, 2, 8, False), (1, 192, 16, 32, False),
    (1, 8, 4, 16, False), (2, 513, 8, 9, True), (2, 1001, 3, 9, False),
    (2, 999, 16, 9, False), (1, 700, 3, 256, False), (3, 1000, 5, 7, False),
    (8, 20_000, 8, 9, False)],
    ids=["shards", "m130", "words16", "m-below-window", "all-zero",
         "words3-unaligned", "words16-wide-rows", "words3-w256",
         "words5-window7", "main-widths"])
def test_jaccard_band_kernel_matches_plain_version(cuda, s, m, words,
                                                   window, zero):
    """K3 against its plain version (1e-6), and bit for bit: integer
    counts, the union by inclusion-exclusion, one IEEE division; also at
    the corners of its staged loads and stores and at the main path's
    widths.  All-zero signatures give 0.0."""
    sig = torch.from_numpy(np.random.default_rng(m).integers(
        -2**31, 2**31, size=(s, m, words)).astype(np.int32)).to(cuda)
    if zero:
        sig.zero_()
    got = _launched_once("jaccard_band", lambda: ops.jaccard_band(
        sig, window=window))
    want = ref.jaccard_band_ref(sig, window=window)
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=1e-6,
                               atol=1e-6)
    assert torch.equal(got, want)
    if zero:
        assert not to_np(got).any()


@pytest.mark.gpu
@pytest.mark.parametrize("bh,s,d,window,softcap", [
    (4, 512, 64, 128, 0.0), (2, 1024, 128, 256, 0.0),
    (2, 512, 64, 100, 0.0), (1, 256, 128, 256, 0.0),
    (3, 768, 64, 384, 0.0), (2, 256, 64, 128, 20.0),
    (2, 512, 256, 300, 50.0), (1, 100, 64, 1000, 0.0)],
    ids=["bh4", "d128", "w100", "w-eq-s", "bh3-w384", "softcap", "d256",
         "ragged-s"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_local_attn_kernel_matches_plain_version(cuda, bh, s, d, window,
                                                 softcap, dtype):
    """K4 against its plain version: 2e-5 in f32, 3e-2 in bf16 (TF32 is
    off for the plain version's einsums)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    tdt, tol = (torch.float32, 2e-5) if dtype == "f32" \
        else (torch.bfloat16, 3e-2)
    rng = np.random.default_rng(bh * s + d)
    q, k, v = (torch.from_numpy(rng.normal(size=(bh, s, d)).astype(
        np.float32)).to(cuda).to(tdt) for _ in range(3))
    got = _launched_once("local_attn", lambda: ops.local_attn(
        q, k, v, window=window, softcap=softcap))
    want = ref.local_attention_ref(q, k, v, window=window, softcap=softcap)
    assert got.dtype == tdt and got.shape == q.shape
    np.testing.assert_allclose(to_np(got.float()), to_np(want.float()),
                               rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["srp", "repsn", "jobsn"])
def test_resolve_on_card_equals_cpu(cuda, variant):
    ents = TE.synth_entities(np.random.default_rng(3), 3000, n_keys=300,
                             text_len=16)
    cfg = TA.ERConfig(window=10, num_shards=8, hops=7, variant=variant,
                      band_engine="pallas", emit="pairs",
                      matcher=paper_cascade())
    ops.reset_launch_counts()
    card = TA.resolve(ents, cfg, device=cuda)
    assert ops.launch_counts()["fused_band"] >= 1
    host = TA.resolve(ents, cfg, device="cpu")
    assert card.blocking.pairs == host.blocking.pairs
    assert card.matches == host.matches
    assert card.blocking.cand_count == host.blocking.cand_count


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["srp", "repsn", "jobsn"])
def test_stream_kill_resume_on_card_equals_cpu(cuda, tmp_path, variant):
    """A stream on the card, killed between chunk 1's spool and commit and
    resumed there, equals the same stream on the CPU, with K1 launched on
    each chunk the card resolved."""
    from repro_torch import stream as TS
    from repro_torch.core.entities import host_take, to_host
    h = to_host(TE.synth_entities(np.random.default_rng(4), 3000,
                                  n_keys=300, text_len=16))
    chunks = lambda: [host_take(h, slice(s, s + 500))
                      for s in range(0, 3000, 500)]
    cfg = TA.ERConfig(window=10, num_shards=8, hops=7, variant=variant,
                      band_engine="pallas", emit="pairs",
                      matcher=paper_cascade())
    host = TS.resolve_stream(chunks(), cfg, chunk_size=1000, device="cpu")
    d = str(tmp_path / "ckpt")
    ops.reset_launch_counts()
    with pytest.raises(TA.InjectedFault):
        TS.resolve_stream(chunks(), cfg, chunk_size=1000, device=cuda,
                          checkpoint_dir=d,
                          fault_plan=TA.FaultPlan(crash_before_commit=1))
    card = TA.resume(d, cfg=cfg, device=cuda)
    assert ops.launch_counts()["fused_band"] >= 2 + 2
    assert card.blocking.pairs == host.blocking.pairs
    assert card.matches == host.matches
    assert card.blocking.cand_count == host.blocking.cand_count
    assert card.stream.chunks == 3


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["repsn", "jobsn"])
def test_traced_resolve_on_card_equals_untraced(cuda, variant):
    """Invariant 12 on the card: a traced resolve gives the untraced sets,
    and its ``shard_program`` span (fenced by a synchronize) holds the K1
    launch."""
    ents = TE.synth_entities(np.random.default_rng(5), 3000, n_keys=300,
                             text_len=16)
    cfg = TA.ERConfig(window=10, num_shards=8, hops=7, variant=variant,
                      band_engine="pallas", emit="pairs",
                      matcher=paper_cascade())
    plain = TA.resolve(ents, cfg, device=cuda)
    ops.reset_launch_counts()
    traced = TA.resolve(ents, cfg.with_(trace=True), device=cuda)
    assert ops.launch_counts()["fused_band"] >= 1
    assert traced.blocking.pairs == plain.blocking.pairs
    assert traced.matches == plain.matches
    names = [s.name for s in traced.trace.spans]
    assert names.count("shard_program") == 1 and "collect" in names
    assert traced.trace.registry["transfer_bytes"]["value"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["srp", "repsn"])
def test_served_sequence_on_card_equals_cpu(cuda, variant):
    """The same inserts and deletes served on the card and on the CPU: the
    same served sets, edits and pair ids after every op, the card's
    service on its worker thread, with K1 launched on every delta call."""
    from repro_torch.core.entities import host_take, to_host
    h = to_host(TE.synth_entities(np.random.default_rng(6), 2400,
                                  n_keys=200, text_len=16))
    cfg = TA.ERConfig(window=10, num_shards=8, hops=7, variant=variant,
                      band_engine="pallas", emit="pairs",
                      matcher=paper_cascade(), trace=True)
    host = TA.serve(cfg, initial=host_take(h, slice(0, 2000)), start=False,
                    device="cpu")
    ops.reset_launch_counts()
    card = TA.serve(cfg, initial=host_take(h, slice(0, 2000)), device=cuda)
    try:
        rng = np.random.default_rng(7)
        live = np.arange(2400) < 2000
        for i, lo in enumerate(range(2000, 2400, 100)):
            batch = host_take(h, slice(lo, lo + 100))
            got = card.submit_insert(batch).result(timeout=120)
            want = host.resolve_incremental(batch)
            live[lo:lo + 100] = True
            assert (got.new_pairs, got.retired_pairs, got.new_matches,
                    got.pair_ids) == (want.new_pairs, want.retired_pairs,
                                      want.new_matches, want.pair_ids)
            if i % 2:
                rows = rng.choice(np.flatnonzero(live), 25, replace=False)
                live[rows] = False
                gone = h["eid"][rows]
                got = card.submit_delete(gone).result(timeout=120)
                want = host.delete(gone)
                assert got.retired_pairs == want.retired_pairs
                assert got.new_pairs == want.new_pairs
            assert card.pairs == host.pairs and card.matches == host.matches
        calls = card.stats().device_calls
        spans = [s for s in card.trace_report().spans
                 if s.name == "shard_program"]
        assert calls == len(spans) > 0
        assert ops.launch_counts()["fused_band"] == calls
    finally:
        card.close(timeout=120)


def _k1_per_program(variant):
    """K1 launches in one shard program: JobSN bands its main part and its
    boundary part."""
    return 2 if variant == "jobsn" else 1


def _small_case(seed, variant, **kw):
    ents = TE.synth_entities(np.random.default_rng(seed), 3000, n_keys=300,
                             text_len=16)
    cfg = TA.ERConfig(window=10, num_shards=8, hops=7, variant=variant,
                      band_engine="pallas", emit="pairs",
                      matcher=paper_cascade(), **kw)
    return ents, cfg


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["srp", "repsn", "jobsn"])
def test_replayed_resolve_equals_eager(cuda, variant):
    """A resolve replayed from its captured CUDA graph equals the same
    resolve run eagerly (``jit_cache=False``); K1's count grows by its
    launches in one program per replay; a replay's outputs survive the
    next replay."""
    from repro_torch.perf import executable_cache
    executable_cache().clear()
    ents, cfg = _small_case(8, variant)
    eager = TA.resolve(ents, cfg.with_(jit_cache=False), device=cuda)
    cold = TA.resolve(ents, cfg, device=cuda)
    assert (cold.perf.cache_misses, cold.perf.traces) == (1, 1)
    for _ in range(2):
        before = ops.launch_counts()["fused_band"]
        hot = TA.resolve(ents, cfg, device=cuda)
        torch.cuda.synchronize()
        assert ops.launch_counts()["fused_band"] == \
            before + _k1_per_program(variant)
        assert hot.perf.steady_state
        for res in (cold, hot):
            assert res.blocking.pairs == eager.blocking.pairs
            assert res.matches == eager.matches
            assert res.blocking.cand_count == eager.blocking.cand_count
    runner = TA.VmapRunner(8, device=cuda)
    b = np.asarray(TA.default_bounds(ents, cfg, 8), np.int32)
    runner.run_raw(ents, b, cfg)                 # the capture
    first = runner.run_raw(ents, b, cfg)         # a replay
    runner.run_raw(ents, b + 1, cfg)             # a replay, other bounds
    want = runner.run_raw(ents, b, cfg.with_(jit_cache=False))
    for f in ("mask_idx", "mask_n", "match_idx", "match_n"):
        assert torch.equal(first["main"][f], want["main"][f]), f


@pytest.mark.gpu
def test_replay_is_seen_by_the_profiler(cuda):
    """A replayed shard program's kernels, K1 among them, show under
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    ents, cfg = _small_case(9, "repsn")
    TA.resolve(ents, cfg, device=cuda)
    TA.resolve(ents, cfg, device=cuda)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = TA.resolve(ents, cfg, device=cuda)
        torch.cuda.synchronize()
    assert res.perf.steady_state
    names = [e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert any("fused_band" in n for n in names), names[:20]


@pytest.mark.gpu
def test_cache_eviction_and_clear_return_pool_memory(cuda):
    """With one entry allowed, capturing key after key returns each
    evicted graph's pool (reserved memory stays flat), and ``clear()``
    returns the last one."""
    from repro_torch.perf import ExecutableCache, executable_cache
    executable_cache().clear()
    cache = ExecutableCache(max_entries=1)
    x = torch.rand((1 << 24,), device=cuda)        # 64 MiB

    def program(v):    # deterministic ops only (a float cumsum is not)
        return {"z": v * 2.0 + 1.0, "n": (v > 0.5).sum()}

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    reserved = []
    for k in range(4):
        fn = cache.get_or_build(("k", k), lambda: program)
        fn(x)                                      # warm-up + capture
        out = fn(x)                                # replay
        want = program(x)
        assert torch.equal(out["z"], want["z"]) and \
            int(out["n"]) == int(want["n"])
        del out, want
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved.append(torch.cuda.memory_reserved())
    assert cache.stats.evictions == 3 and len(cache) == 1
    assert max(reserved) <= reserved[0] + x.nbytes, reserved
    cache.clear()
    assert torch.cuda.memory_reserved() <= base + x.nbytes // 4, \
        (base, reserved, torch.cuda.memory_reserved())


@pytest.mark.gpu
def test_graph_byte_budget_evicts_before_a_warm_up(cuda, monkeypatch):
    """With a budget of 0 bytes a new program's first call evicts the
    graph kept on the card, and returns its pool, before its warm-up; the
    new graph replays, and the evicted key captures again on its next
    use."""
    from repro_torch.perf import ExecutableCache, executable_cache
    from repro_torch.perf import cache as PC
    monkeypatch.setattr(PC, "GRAPH_MEMORY_SHARE", 0.0)
    executable_cache().clear()
    cache = ExecutableCache()
    x = torch.rand((1 << 24,), device=cuda)        # 64 MiB

    def program(v):
        return {"z": v * 2.0 + 1.0}

    cache.get_or_build("a", lambda: program)(x)
    assert cache.graph_bytes(cuda) >= 2 * x.nbytes   # inputs + output
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    b = cache.get_or_build("b", lambda: program)
    b(x)                                           # evicts a, captures b
    assert cache.stats.evictions == 1 and len(cache) == 1
    assert torch.equal(b(x)["z"], program(x)["z"])  # b's replay
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_reserved() <= reserved + 2 * x.nbytes
    traces = cache.stats.traces
    cache.get_or_build("a", lambda: program)(x)    # evicts b, captures a
    assert cache.stats.traces == traces + 1 and cache.stats.evictions == 2
    cache.clear()
    assert cache.graph_bytes(cuda) == 0


@pytest.mark.gpu
def test_shard_map_nccl_world1_equals_vmap(cuda):
    """``runner="shard_map"`` on a world-size-1 NCCL mesh on the card
    equals the vmap runner at one shard, for every variant; its second
    call hits the cache and launches K1."""
    import torch.distributed as dist

    from repro_torch.launch import make_mesh_compat
    from repro_torch.perf import executable_cache
    assert not dist.is_initialized()
    mesh = make_mesh_compat((1,), ("data",), device=cuda)
    try:
        assert dist.get_backend() == "nccl"
        for variant in ("srp", "repsn", "jobsn"):
            ents, cfg = _small_case(10, variant)
            cfg = cfg.with_(num_shards=1, hops=1)
            vm = TA.resolve(ents, cfg, device=cuda)
            smc = cfg.with_(runner="shard_map")
            TA.resolve(ents, smc, mesh=mesh, device=cuda)
            before = ops.launch_counts()["fused_band"]
            sm = TA.resolve(ents, smc, mesh=mesh, device=cuda)
            torch.cuda.synchronize()
            assert ops.launch_counts()["fused_band"] == \
                before + _k1_per_program(variant)
            assert sm.perf.cache_hits >= 1 and sm.perf.cache_misses == 0
            assert sm.blocking.pairs == vm.blocking.pairs
            assert sm.matches == vm.matches
            assert sm.blocking.load == vm.blocking.load
    finally:
        executable_cache().clear()
        dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("f,words,m,window", [
    (33, 3, 1001, 9), (32, 8, 1000, 7), (32, 8, 700, 256),
    (64, 16, 700, 256), (32, 8, 1001, 9), (64, 16, 999, 9)],
    ids=["f33-w3-unaligned", "window7", "window256", "window256-halved",
         "m-not-rows", "wide-rows"])
def test_fused_band_kernel_widths(cuda, f, words, m, window):
    """K1's staged loads and stores at their corners: rows whose spans are
    not 16-byte aligned (4-byte loads, scalar store head and tail), a
    window that halves the row tile once the output tile is counted, M
    not a multiple of the tile, and rows wider than the registers hold."""
    rng = np.random.default_rng(f * window + m)
    feat = torch.from_numpy(rng.normal(size=(2, m, f))
                            .astype(np.float32)).to(cuda)
    sig = torch.from_numpy(rng.integers(-2**31, 2**31, size=(2, m, words))
                           .astype(np.int32)).to(cuda)
    kw = dict(window=window, w_cos=0.5, w_jac=0.5)
    got = _launched_once("fused_band",
                         lambda: ops.fused_cheap_band(feat, sig, **kw))
    want = ops.fused_cheap_band_ref(feat, sig, **kw)
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=0, atol=TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("bh,s,d,window,softcap", [
    (2, 200, 256, 150, 30.0), (2, 256, 128, 1, 0.0),
    (1, 300, 128, 512, 0.0), (2, 640, 128, 100, 0.0),
    (3, 1000, 64, 333, 0.0)],
    ids=["d256-s200-softcap", "window1", "window-over-s", "w100-mid-tile",
         "d64-s1000"])
def test_local_attn_tensor_core_corners(cuda, bh, s, d, window, softcap):
    """The bf16 wgmma kernel at its corners, at the bf16 tolerance 3e-2:
    S not a multiple of the 64-row warpgroup tile, a window of one key,
    a window over S, and a kv walk that starts inside a tile."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(bh * s + d + window)
    q, k, v = (torch.from_numpy(rng.normal(size=(bh, s, d)).astype(
        np.float32)).to(cuda).bfloat16() for _ in range(3))
    # block_q = block_k = S: the reference's block contract holds for any S
    got = _launched_once("local_attn", lambda: ops.local_attn(
        q, k, v, window=window, softcap=softcap, block_q=s, block_k=s))
    want = ref.local_attention_ref(q, k, v, window=window, softcap=softcap)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    np.testing.assert_allclose(to_np(got.float()), to_np(want.float()),
                               rtol=3e-2, atol=3e-2)


@pytest.mark.gpu
def test_local_attn_model_shape_head(cuda):
    """One head of the Mixtral-8x22B sliding-window layer (S 8192, D 128,
    window 4096) in bf16, at chip_smoke.py's model-shape tolerance: rtol
    1e-2 (one bf16 ulp), atol 2e-3."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(13)
    q, k, v = (torch.randn((1, 8192, 128), generator=g, device=cuda)
               .bfloat16() for _ in range(3))
    got = _launched_once("local_attn", lambda: ops.local_attn(
        q, k, v, window=4096))
    want = ref.local_attention_ref(q, k, v, window=4096)
    np.testing.assert_allclose(to_np(got.float()), to_np(want.float()),
                               rtol=1e-2, atol=2e-3)


@pytest.mark.gpu
def test_banded_sim_dot_equals_fused_band_cosine_half(cuda):
    """K2's dot and K1's cosine half run one FMA chain in one order, so
    K1 with only its cosine half equals clip(0.5 * (K2 + 1)) bit for
    bit."""
    rng = np.random.default_rng(15)
    feat = torch.from_numpy(rng.normal(size=(2, 5000, 32))
                            .astype(np.float32)).to(cuda)
    sig = torch.zeros((2, 5000, 1), dtype=torch.int32, device=cuda)
    k1 = ops.fused_cheap_band(feat, sig, window=9, w_cos=1.0, w_jac=0.0)
    k2 = ops.banded_dot_band(feat, window=9)
    m = torch.arange(5000, device=cuda)[:, None] + 1 + \
        torch.arange(9, device=cuda) < 5000
    cos = torch.where(m, torch.clamp(0.5 * (k2 + 1.0), 0.0, 1.0), 0.0)
    assert torch.equal(k1, cos)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_attention_k4_route_matches_plain_scan(cuda, dtype):
    """``models.attention.flash_attention`` on the card at a small
    Gemma-2-shaped case (GQA 4:2, head dim 256, window, softcap 50) takes
    K4 (one launch) and equals the plain chunk-pair scan on the same
    tensors: 2e-5 in f32, 3e-2 in bf16 (K4's tolerances)."""
    from repro_torch.models import attention as A
    torch.backends.cuda.matmul.allow_tf32 = False
    tdt, tol = (torch.float32, 2e-5) if dtype == "f32" \
        else (torch.bfloat16, 3e-2)
    rng = np.random.default_rng(256)
    q = torch.from_numpy(rng.normal(size=(2, 512, 4, 256)).astype(
        np.float32)).to(cuda).to(tdt)
    k, v = (torch.from_numpy(rng.normal(size=(2, 512, 2, 256)).astype(
        np.float32)).to(cuda).to(tdt) for _ in range(2))
    kw = dict(causal=True, window=192, logit_softcap=50.0)
    assert A.local_attn_route(q.shape, k.shape, causal=True, window=192)
    got = _launched_once("local_attn", lambda: A.flash_attention(
        q, k, v, **kw))
    want = A.flash_attention_scan(q, k, v, chunk_q=128, chunk_kv=256, **kw)
    assert got.dtype == tdt and got.shape == q.shape
    np.testing.assert_allclose(to_np(got.float()), to_np(want.float()),
                               rtol=tol, atol=tol)


@pytest.mark.gpu
def test_lm_forward_on_card_equals_cpu(cuda):
    """A Gemma-2-patterned LM (head dim 64, window 64) in f32 on the card,
    its local layers through K4, equals the same weights on the CPU (the
    plain scan everywhere) within 1e-4; K4 runs once per local layer."""
    import dataclasses
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models import lm
    from repro_torch.models.modules import tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(smoke_variant(get_config("gemma2-9b")),
                              head_dim=64, window_size=64)
    cpu = lm.lm_init(0, cfg, torch.float32, device="cpu")
    card = tree_map(lambda x: x.to(cuda), cpu)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(2, 256)).astype(np.int32))
    before = ops.launch_counts()["local_attn"]
    got, _, _ = lm.forward(card, cfg, tokens=toks, device=cuda)
    torch.cuda.synchronize()
    assert ops.launch_counts()["local_attn"] - before == cfg.n_groups
    want, _, _ = lm.forward(cpu, cfg, tokens=toks, device="cpu")
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=0, atol=1e-4)
