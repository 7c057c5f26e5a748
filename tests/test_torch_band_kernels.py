"""Port parity for kernels K2 (banded dot) and K3 (Jaccard band): the
port's ``kernels.ops.banded_dot_band`` / ``jaccard_band`` (plain versions
on the CPU) against the reference Pallas kernels run in interpret mode, on
the same seeded numpy inputs, at the tolerances of ``tests/test_kernels.py``
(K2: 1e-5 / atol 1e-4 in f32, 2e-2 / atol 2e-1 in bf16; K3: 1e-6).

The CUDA kernels themselves run only on a card: their tests are in
``test_torch_kernels_gpu.py``."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as rops  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

from _torch_parity import to_np  # noqa: E402

RNG = np.random.default_rng(11)
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _sig(rng, shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint64) \
        .astype(np.uint32)


def _port_sig(sig):
    return torch.from_numpy(np.ascontiguousarray(sig).view(np.int32))


def _ref_dot(feat, jdtype, **kw):
    return np.asarray(rops.banded_dot_band(jnp.asarray(feat, jdtype),
                                           interpret=True, **kw))


def _ref_jac(sig, **kw):
    return np.asarray(rops.jaccard_band(jnp.asarray(sig), interpret=True,
                                        **kw))


@pytest.mark.parametrize("m,f,w,bi", [
    (256, 128, 16, 256),
    (512, 64, 64, 256),
    (300, 32, 10, 128),      # non-multiple M (the reference pads)
    (128, 256, 128, 128),    # window == block
    (1024, 128, 200, 256),
], ids=["m256", "m512-w64", "m300-pad", "window-eq-block", "f128-w200"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_banded_dot_band_equals_reference_kernel(m, f, w, bi, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    feat = RNG.normal(size=(m, f)).astype(np.float32)
    want = _ref_dot(feat, jdt, window=w, block_i=bi)
    got = tops.banded_dot_band(torch.from_numpy(feat).to(tdt), window=w,
                               block_i=bi)
    assert got.shape == (m, w) and got.dtype == torch.float32
    np.testing.assert_allclose(to_np(got), want, rtol=tol, atol=tol * 10)


@pytest.mark.parametrize("m,words,w,bi", [
    (256, 8, 16, 256),
    (512, 4, 64, 256),
    (192, 16, 32, 64),
    (130, 2, 8, 128),        # the reference pads
], ids=["m256", "m512-w64", "words16", "m130-pad"])
def test_jaccard_band_equals_reference_kernel(m, words, w, bi):
    sig = _sig(RNG, (m, words))
    want = _ref_jac(sig, window=w, block_i=bi)
    got = tops.jaccard_band(_port_sig(sig), window=w, block_i=bi)
    assert got.shape == (m, w) and got.dtype == torch.float32
    np.testing.assert_allclose(to_np(got), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_batched_banded_dot_equals_reference_per_shard(dtype):
    jdt, tdt, tol = DTYPES[dtype]
    feat = RNG.normal(size=(3, 130, 32)).astype(np.float32)
    got = to_np(tops.banded_dot_band(torch.from_numpy(feat).to(tdt),
                                     window=9))
    assert got.shape == (3, 130, 9)
    for s in range(3):
        np.testing.assert_allclose(got[s], _ref_dot(feat[s], jdt, window=9),
                                   rtol=tol, atol=tol * 10)


def test_batched_jaccard_equals_reference_per_shard():
    sig = _sig(RNG, (3, 130, 8))
    got = to_np(tops.jaccard_band(_port_sig(sig), window=9))
    assert got.shape == (3, 130, 9)
    for s in range(3):
        np.testing.assert_allclose(got[s], _ref_jac(sig[s], window=9),
                                   rtol=1e-6, atol=1e-6)


def test_small_m_grows_the_block_like_reference():
    """M below the window: the reference grows its block to the window and
    pads; the port computes the band directly.  Both agree."""
    m, f, w = 8, 16, 16
    feat = RNG.normal(size=(m, f)).astype(np.float32)
    got = tops.banded_dot_band(torch.from_numpy(feat), window=w, block_i=256)
    np.testing.assert_allclose(to_np(got),
                               _ref_dot(feat, jnp.float32, window=w),
                               rtol=1e-5, atol=1e-4)
    sig = _sig(RNG, (m, 4))
    got_j = tops.jaccard_band(_port_sig(sig), window=w, block_i=256)
    np.testing.assert_allclose(to_np(got_j), _ref_jac(sig, window=w),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kernel", ["banded_dot_band", "jaccard_band"])
def test_window_exceeding_block_raises_like_reference(kernel):
    x_ref = jnp.zeros((512, 8), jnp.float32 if kernel == "banded_dot_band"
                      else jnp.uint32)
    x_port = torch.zeros((512, 8), dtype=torch.float32
                         if kernel == "banded_dot_band" else torch.int32)
    with pytest.raises(ValueError, match="window=300 exceeds block_i=256"):
        getattr(rops, kernel)(x_ref, window=300, block_i=256, interpret=True)
    with pytest.raises(ValueError, match="window=300 exceeds block_i=256"):
        getattr(tops, kernel)(x_port, window=300, block_i=256)


def test_empty_signatures_jaccard_zero_fused_one():
    """All-zero signatures: K3 gives 0.0 for empty vs empty (as the
    reference kernel does), K1's Jaccard half gives 1.0."""
    m, w = 64, 4
    sig = np.zeros((m, 4), np.uint32)
    ok = (np.arange(m)[:, None] + 1 + np.arange(w)[None, :]) < m
    jac = to_np(tops.jaccard_band(_port_sig(sig), window=w, block_i=64))
    np.testing.assert_array_equal(jac, _ref_jac(sig, window=w, block_i=64))
    np.testing.assert_array_equal(jac, np.zeros((m, w), np.float32))
    fused = to_np(tops.fused_cheap_band(torch.zeros((m, 8)), _port_sig(sig),
                                        window=w, w_cos=0.0, w_jac=1.0,
                                        block_i=64))
    np.testing.assert_array_equal(fused, np.where(ok, 1.0, 0.0))


def test_band_kernel_matches_window_module():
    """Port of the reference test of the same name: clip(0.5*(K2+1), 0, 1)
    equals the window module's cosine band where the band mask holds, and
    K2 equals the reference kernel on the same sorted entities."""
    from repro.core import entities as RE
    from repro_torch.core import entities as TE
    from repro_torch.core import window as TW
    from repro_torch.core.match import CascadeMatcher, Matcher
    n, w = 256, 9
    ents = RE.sort_entities(RE.synth_entities(np.random.default_rng(3), n,
                                              n_keys=32))
    port = TE.from_numpy(ents, "cpu")
    matcher = CascadeMatcher(
        matchers=(Matcher(field="feat", kind="cosine", weight=1.0),),
        threshold=0.75)
    scores, mask = TW.band_scores(port, w, matcher)      # (w-1, M)
    dot = tops.banded_dot_band(port["payload"]["feat"], window=w - 1)
    np.testing.assert_allclose(
        to_np(dot), _ref_dot(np.asarray(ents["payload"]["feat"]),
                             jnp.float32, window=w - 1),
        rtol=1e-5, atol=1e-4)
    cos = np.clip(0.5 * (to_np(dot) + 1.0), 0.0, 1.0)
    mask = to_np(mask)
    np.testing.assert_allclose(np.where(mask, to_np(scores), 0.0),
                               np.where(mask, cos.T, 0.0), rtol=1e-5,
                               atol=1e-5)


def test_band_from_tiles_equals_reference():
    tiles = RNG.normal(size=(300, 256)).astype(np.float32)
    for w, bi in [(9, 128), (128, 128), (1, 128)]:
        want = np.asarray(rops.band_from_tiles(jnp.asarray(tiles), window=w,
                                               block_i=bi))
        got = tops.band_from_tiles(torch.from_numpy(tiles), window=w,
                                   block_i=bi)
        np.testing.assert_array_equal(to_np(got), want)


@pytest.mark.parametrize("m,window,block_i", [
    (1000, 9, 256), (8, 16, 256), (300, 10, 128), (128, 128, 128),
    (5, 1, 64)])
def test_resolve_block_i_equals_reference(m, window, block_i):
    assert tops.resolve_block_i(m, window, block_i) == \
        rops.resolve_block_i(m, window, block_i)


def test_plain_versions_match_kernels_ops():
    """The wrappers on the CPU are exactly the plain versions."""
    feat = torch.from_numpy(RNG.normal(size=(2, 40, 8)).astype(np.float32))
    sig = _port_sig(_sig(RNG, (2, 40, 3)))
    assert torch.equal(tops.banded_dot_band(feat, window=5),
                       tref.banded_sim_ref(feat, window=5))
    assert torch.equal(tops.jaccard_band(sig, window=5),
                       tref.jaccard_band_ref(sig, window=5))


def test_band_wrappers_check_inputs():
    feat = torch.zeros((2, 20, 8))
    with pytest.raises(TypeError):
        tops.banded_dot_band(feat.double(), window=3)
    with pytest.raises(TypeError):
        tops.jaccard_band(feat, window=3)
    with pytest.raises(ValueError, match="takes"):
        tops.banded_dot_band(torch.zeros(20), window=3)
    with pytest.raises(ValueError, match="contiguous"):
        tops.banded_dot_band(feat.transpose(0, 1), window=3)
    with pytest.raises(ValueError, match="window=0"):
        tops.jaccard_band(torch.zeros((20, 2), dtype=torch.int32), window=0)
    with pytest.raises(ValueError, match="no kernel"):
        tops.banded_dot_band(torch.zeros((20, 2), device="meta"), window=3)


def test_cpu_path_counts_no_launch():
    tops.reset_launch_counts()
    tops.banded_dot_band(torch.zeros((20, 4)), window=3)
    tops.jaccard_band(torch.zeros((20, 2), dtype=torch.int32), window=3)
    assert tops.launch_counts()["banded_sim"] == 0
    assert tops.launch_counts()["jaccard_band"] == 0


@pytest.mark.parametrize("words", [1, 3, 8])
def test_popcount_union_by_inclusion_exclusion(words):
    """The arithmetic K3's kernel relies on: popc(a | b) = popc(a) +
    popc(b) - popc(a & b) word by word (sign-bit words among them), so
    that a row's count taken once gives every union; and K3's plain
    version equals inter / max(P(a) + P(b) - inter, 1) bit for bit."""
    from repro_torch.core.match import popcount32
    rng = np.random.default_rng(words)
    edge = np.array([0, -1, -2**31, 2**31 - 1, 1, -2], np.int32)
    a = np.concatenate([rng.integers(-2**31, 2**31, 4000), edge,
                        edge[::-1]]).astype(np.int32)
    b = np.concatenate([rng.integers(-2**31, 2**31, 4000), edge[::-1],
                        edge]).astype(np.int32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert torch.equal(popcount32(ta | tb),
                       popcount32(ta) + popcount32(tb) - popcount32(ta & tb))
    want = np.array([bin(int(x) & 0xFFFFFFFF).count("1") for x in a])
    np.testing.assert_array_equal(to_np(popcount32(ta)), want)

    m, window = 500, 9
    sig = torch.from_numpy(rng.integers(-2**31, 2**31, size=(2, m, words))
                           .astype(np.int32))
    sig[:, ::7] = 0                                    # empty rows
    pop = popcount32(sig).sum(dim=-1)
    cols = []
    for d in range(1, window + 1):
        inter = popcount32(sig & torch.roll(sig, -d, dims=-2)).sum(dim=-1)
        uni = pop + torch.roll(pop, -d, dims=-1) - inter
        jac = inter.float() / torch.clamp_min(uni.float(), 1.0)
        cols.append(torch.where(torch.arange(m) + d < m, jac, 0.0))
    assert torch.equal(torch.stack(cols, dim=-1),
                       tref.jaccard_band_ref(sig, window=window))


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("s,m,f,window", [(3, 200, 32, 9), (1, 50, 7, 12)])
def test_bmm_yardstick_computes_the_k2_band(s, m, f, window):
    """chip_smoke.py's library yardstick for K2 (torch.bmm of each row
    against a strided view of its successors, the band masked outside the
    call) computes K2's function: equal to the plain version at K2's f32
    tolerance, also where the view runs across shards."""
    feat = torch.from_numpy(np.random.default_rng(m).normal(
        size=(s, m, f)).astype(np.float32))
    call, band = _chip_smoke()._bmm_band(feat, window)
    got = band(call())
    np.testing.assert_allclose(to_np(got),
                               to_np(tref.banded_sim_ref(feat, window=window)),
                               rtol=1e-5, atol=1e-4)
