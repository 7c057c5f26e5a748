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
