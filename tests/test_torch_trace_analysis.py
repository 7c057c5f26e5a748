"""The port's op-trace analyzer (``repro_torch.perf.trace_analysis``)
against the reference's HLO analyzer (``repro.perf.hlo_analysis``) on
single-op programs: a matmul, a batched matmul, and one of each collective
(the reference's ``shard_map`` with ``psum``, ``all_gather``,
``psum_scatter``, ``all_to_all`` and ``ppermute`` on 4 forced XLA host
devices; the port's c10d ops on rank 0 of a 4-rank fake group).  Dot
FLOPs, dot bytes and each collective kind's bytes and count are equal
exactly.  Both programs run in processes of their own, started together
(``tests/_torch_dryrun.py port-ops`` / ``reference-ops``).  K4's FLOPs are
read here from a traced ``repro_torch::local_attn`` call on fake CUDA
tensors.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_dryrun as DR  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
OPS = ("mm", "bmm") + DR.COLLECTIVES


@pytest.fixture(scope="module")
def analyses(tmp_path_factory):
    """{"port": {op: analysis}, "reference": {op: analysis}}."""
    d = tmp_path_factory.mktemp("ops")
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(REPO / "src"),
                                           str(REPO / "tests")]),
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    script = str(REPO / "tests" / "_torch_dryrun.py")
    procs = {k: subprocess.Popen(
        [sys.executable, script, f"{k}-ops", str(d / f"{k}.json")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for k in ("port", "reference")}
    for k, p in procs.items():
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, f"{k}: {out[-2000:]}\n{err[-2000:]}"
    return {k: json.loads((d / f"{k}.json").read_text()) for k in procs}


@pytest.mark.parametrize("op", OPS)
def test_single_op_equals_reference(analyses, op):
    from repro_torch.perf.trace_analysis import COLLECTIVE_OPS
    got, want = analyses["port"][op], analyses["reference"][op]
    assert got["dot_flops"] == want["dot_flops"]
    assert got["dot_bytes"] == want["dot_bytes"]
    for kind in COLLECTIVE_OPS:
        g, w = got["collectives"][kind], want["collectives"][kind]
        assert (g["bytes"], g["count"]) == (w["bytes"], w["count"]), kind
        assert g["bytes_bf16adj"] == w.get("bytes_bf16adj", 0.0), kind
    assert got["collective_bytes"] == want["collective_bytes"]
    if op in DR.COLLECTIVES:
        assert got["collective_bytes"] > 0
    else:
        assert got["dot_flops"] > 0


@pytest.mark.parametrize("bh,s,d,window", [(4, 512, 64, 128),
                                          (2, 256, 128, 1024),
                                          (1, 768, 256, 300)])
def test_local_attn_kernel_flops(bh, s, d, window):
    """A fake-CUDA call of K4 is one recorded op whose work is
    4 * BH * kept pairs * D, the kept pairs counted here by brute force;
    it adds nothing to the dot FLOPs and launches nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import ops
    from repro_torch.perf import trace_analysis as T
    q_pos, k_pos = np.meshgrid(np.arange(s), np.arange(s), indexing="ij")
    kept = int(((k_pos <= q_pos) & (k_pos > q_pos - window)).sum())
    ops.reset_launch_counts()
    rec = T.OpRecorder()
    with FakeTensorMode(), rec:
        q = torch.empty((bh, s, d), dtype=torch.bfloat16, device="cuda")
        out = ops.local_attn(q, q, q, window=window)
        assert out.shape == q.shape and out.device.type == "cuda"
    assert rec.kernel_flops == 4 * bh * kept * d
    assert rec.ops["repro_torch.local_attn.default"] == 1
    assert rec.dot_flops == 0
    assert ops.launch_counts()["local_attn"] == 0
