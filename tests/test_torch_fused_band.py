"""Port parity for kernel K1, the fused cheap-cascade band: the port's
``kernels.ops.fused_cheap_band`` (plain version on the CPU) against the
reference Pallas kernel run in interpret mode, at the tolerance of
``tests/test_kernels.py`` (1e-5, below the cascade gate's GATE_EPS).

The CUDA kernel itself runs only on a card: its tests are in
``test_torch_kernels_gpu.py``."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as rops  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

from _torch_parity import to_np  # noqa: E402

RNG = np.random.default_rng(7)
TOL = 1e-5


def _inputs(rng, m, f, words, lead=()):
    feat = rng.normal(size=lead + (m, f)).astype(np.float32)
    sig = rng.integers(0, 2**32, size=lead + (m, words), dtype=np.uint64) \
        .astype(np.uint32)
    return feat, sig


def _port(feat, sig, device="cpu"):
    return (torch.from_numpy(feat).to(device),
            torch.from_numpy(sig.view(np.int32)).to(device))


def _ref(feat, sig, **kw):
    return np.asarray(rops.fused_cheap_band(
        jnp.asarray(feat), jnp.asarray(sig), interpret=True, **kw))


@pytest.mark.parametrize("m,f,words,w,bi", [
    (256, 64, 8, 16, 256),
    (300, 32, 4, 10, 128),   # non-multiple M (the reference pads)
    (64, 32, 8, 48, 64),     # window fills most of the block
], ids=["m256", "m300-pad", "wide-window"])
@pytest.mark.parametrize("w_cos,w_jac", [(0.5, 0.5), (1.0, 0.0), (0.0, 2.0)],
                         ids=["both", "cos-only", "jac-only"])
def test_plain_band_equals_reference_kernel(m, f, words, w, bi, w_cos,
                                            w_jac):
    feat, sig = _inputs(RNG, m, f, words)
    want = _ref(feat, sig, window=w, w_cos=w_cos, w_jac=w_jac, block_i=bi)
    got = tops.fused_cheap_band(*_port(feat, sig), window=w, w_cos=w_cos,
                                w_jac=w_jac, block_i=bi)
    assert got.shape == (m, w) and got.dtype == torch.float32
    np.testing.assert_allclose(to_np(got), want, rtol=TOL, atol=TOL)


def test_empty_signature_convention():
    """All-zero signatures: empty vs empty Jaccard is 1.0 in both."""
    m, w = 64, 4
    feat = np.zeros((m, 8), np.float32)
    sig = np.zeros((m, 4), np.uint32)
    want = _ref(feat, sig, window=w, w_cos=0.0, w_jac=1.0, block_i=64)
    got = tops.fused_cheap_band(*_port(feat, sig), window=w, w_cos=0.0,
                                w_jac=1.0, block_i=64)
    np.testing.assert_allclose(to_np(got), want)
    ok = (np.arange(m)[:, None] + 1 + np.arange(w)[None, :]) < m
    np.testing.assert_array_equal(to_np(got), np.where(ok, 1.0, 0.0))


def test_dummy_inputs_for_disabled_halves():
    """A zero weight disables its half: an (S, M, 1) dummy stands in."""
    feat, sig = _inputs(RNG, 50, 16, 4, lead=(2,))
    tf, ts = _port(feat, sig)
    dummy_f = torch.zeros((2, 50, 1))
    dummy_s = torch.zeros((2, 50, 1), dtype=torch.int32)
    cos = tops.fused_cheap_band(tf, dummy_s, window=5, w_cos=1.0, w_jac=0.0)
    jac = tops.fused_cheap_band(dummy_f, ts, window=5, w_cos=0.0, w_jac=1.0)
    both = tops.fused_cheap_band(tf, ts, window=5, w_cos=1.0, w_jac=1.0)
    np.testing.assert_allclose(to_np(cos + jac), to_np(both), atol=1e-6)


def test_batched_equals_reference_per_shard():
    """(S, M, .) input == the reference applied shard by shard."""
    feat, sig = _inputs(RNG, 130, 32, 8, lead=(3,))
    got = to_np(tops.fused_cheap_band(*_port(feat, sig), window=9,
                                      w_cos=0.25, w_jac=0.25))
    assert got.shape == (3, 130, 9)
    for s in range(3):
        want = _ref(feat[s], sig[s], window=9, w_cos=0.25, w_jac=0.25,
                    block_i=256)
        np.testing.assert_allclose(got[s], want, rtol=TOL, atol=TOL)


def test_window_exceeding_block_raises_like_reference():
    feat, sig = _port(*_inputs(RNG, 512, 8, 2))
    with pytest.raises(ValueError, match="window=300 exceeds block_i=256"):
        tops.fused_cheap_band(feat, sig, window=300, w_cos=1.0, w_jac=1.0,
                              block_i=256)
    with pytest.raises(ValueError, match="window=300 exceeds block_i=256"):
        rops.fused_cheap_band(jnp.zeros((512, 8)),
                              jnp.zeros((512, 2), jnp.uint32), window=300,
                              w_cos=1.0, w_jac=1.0, block_i=256)


def test_wrapper_checks_inputs():
    feat, sig = _port(*_inputs(RNG, 20, 8, 2, lead=(2,)))
    with pytest.raises(TypeError):
        tops.fused_cheap_band(feat.double(), sig, window=3, w_cos=1.0,
                              w_jac=1.0)
    with pytest.raises(ValueError, match="matching S, M"):
        tops.fused_cheap_band(feat, sig[:, :10], window=3, w_cos=1.0,
                              w_jac=1.0)
    with pytest.raises(ValueError, match="contiguous"):
        tops.fused_cheap_band(feat.transpose(0, 1).contiguous()
                              .transpose(0, 1), sig, window=3, w_cos=1.0,
                              w_jac=1.0)


def test_cpu_path_counts_no_launch():
    """The plain version on CPU tensors is not a kernel launch."""
    tops.reset_launch_counts()
    feat, sig = _port(*_inputs(RNG, 20, 8, 2))
    tops.fused_cheap_band(feat, sig, window=3, w_cos=1.0, w_jac=1.0)
    assert tops.launch_counts()["fused_band"] == 0
