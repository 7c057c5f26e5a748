"""Port parity for kernel K4, causal sliding-window flash attention: the
port's ``kernels.ops.local_attn`` (plain version on the CPU) against the
reference Pallas kernel run in interpret mode, on the same seeded numpy
inputs, at the tolerances of ``tests/test_kernels.py`` (2e-5 in f32, 3e-2
in bf16).

The CUDA kernel itself runs only on a card: its tests are in
``test_torch_kernels_gpu.py``."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as rops  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

from _torch_parity import to_np  # noqa: E402

RNG = np.random.default_rng(13)
DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _qkv(rng, bh, s, d):
    return [rng.normal(size=(bh, s, d)).astype(np.float32) for _ in range(3)]


def _ref(qkv, jdtype, **kw):
    q, k, v = (jnp.asarray(x, jdtype) for x in qkv)
    return rops.local_attn(q, k, v, interpret=True, **kw)


def _port(qkv, tdtype, **kw):
    q, k, v = (torch.from_numpy(x).to(tdtype) for x in qkv)
    return tops.local_attn(q, k, v, **kw)


def _f32(x):
    return np.asarray(to_np(x.float()) if hasattr(x, "detach")
                      else np.asarray(x, np.float32), np.float32)


@pytest.mark.parametrize("bh,s,d,w,blk", [
    (4, 512, 64, 128, 128),
    (2, 1024, 128, 256, 256),
    (2, 512, 64, 100, 128),   # window not a multiple of the block
    (1, 256, 128, 256, 128),  # window == S (dense causal)
    (3, 768, 64, 384, 128),
], ids=["bh4", "d128", "w100", "w-eq-s", "bh3-w384"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_local_attn_equals_reference_kernel(bh, s, d, w, blk, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    qkv = _qkv(RNG, bh, s, d)
    want = _ref(qkv, jdt, window=w, block_q=blk, block_k=blk)
    got = _port(qkv, tdt, window=w, block_q=blk, block_k=blk)
    assert got.shape == (bh, s, d) and got.dtype == tdt
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def test_local_attn_softcap_equals_reference_kernel():
    qkv = _qkv(RNG, 2, 256, 64)
    kw = dict(window=128, block_q=128, block_k=128, softcap=20.0)
    np.testing.assert_allclose(to_np(_port(qkv, torch.float32, **kw)),
                               np.asarray(_ref(qkv, jnp.float32, **kw)),
                               rtol=2e-5, atol=2e-5)


def test_window_at_least_s_is_dense_causal():
    """A window of S or more keeps every earlier key: the result is dense
    causal softmax attention, in both packages."""
    bh, s, d = 2, 128, 64
    q, k, v = _qkv(RNG, bh, s, d)
    sc = np.einsum("bqd,bkd->bqk", q.astype(np.float64), k) / np.sqrt(d)
    sc = np.where(np.tril(np.ones((s, s), bool)), sc, -np.inf)
    p = np.exp(sc - sc.max(-1, keepdims=True))
    dense = np.einsum("bqk,bkd->bqd", p / p.sum(-1, keepdims=True), v)
    for w in (s, 3 * s):
        got = _port((q, k, v), torch.float32, window=w, block_q=64,
                    block_k=64)
        np.testing.assert_allclose(to_np(got), dense, rtol=2e-5, atol=2e-5)
        want = _ref((q, k, v), jnp.float32, window=w, block_q=64, block_k=64)
        np.testing.assert_allclose(np.asarray(want), dense, rtol=2e-5,
                                   atol=2e-5)


def test_s_not_multiple_of_block_raises_in_both():
    qkv = _qkv(RNG, 1, 200, 64)
    with pytest.raises(AssertionError):
        _ref(qkv, jnp.float32, window=32, block_q=128, block_k=128)
    with pytest.raises(ValueError, match="not a multiple of the block"):
        _port(qkv, torch.float32, window=32, block_q=128, block_k=128)
    # the block is min(block_q, block_k, S): S below the block is one block
    got = _port(qkv, torch.float32, window=32, block_q=256, block_k=256)
    want = _ref(qkv, jnp.float32, window=32, block_q=256, block_k=256)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_local_attn_checks_inputs():
    q = torch.zeros((1, 64, 64))
    with pytest.raises(ValueError, match="window=0"):
        tops.local_attn(q, q, q, window=0)
    with pytest.raises(TypeError):
        tops.local_attn(q, q.bfloat16(), q, window=4)
    with pytest.raises(TypeError):
        tops.local_attn(q.double(), q.double(), q.double(), window=4)
    with pytest.raises(ValueError, match="one shape"):
        tops.local_attn(q, q[:, :32], q, window=4)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros((1, 64, 64)).transpose(1, 2)
        tops.local_attn(t, t, t, window=4)
    m = torch.zeros((1, 64, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tops.local_attn(m, m, m, window=4)


def test_cpu_path_counts_no_launch():
    tops.reset_launch_counts()
    q = torch.zeros((1, 64, 64))
    tops.local_attn(q, q, q, window=4)
    assert tops.launch_counts()["local_attn"] == 0
