"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's (``repro.launch.dryrun``) and against a real run, on the CPU.

Six processes start together (``tests/_torch_dryrun.py``): the port's fake
traces, the reference on 4 forced XLA host devices, and four gloo ranks.

  * smoke cells (``CELLS``: a dense arch's train step and prefill, a MoE
    arch's train step) on a (2, 2) mesh: the port traced on rank 0 of a
    4-rank fake group, the reference compiled on an ``Auto``-axis mesh of
    4 host devices (``make_production_mesh`` fails on this box's jax, so
    the reference's ``build_cell`` is composed with its ``run_cell``'s
    compile and analysis lines).  The argument bytes are equal exactly;
    the dot FLOPs within DOT_FLOPS_RTOL (below);
  * the dense train cell run for real on four gloo ranks and recorded on
    rank 0 by the same recorder: its collectives per kind and its dot
    FLOPs equal the fake trace's exactly;
  * smoke cells on both production meshes of the 512-rank fake world (a
    decode on the multi-pod mesh among them), to ``status == "ok"``, the
    record's keys the reference's (those with a counterpart here);
  * on a world-size-1 (1, 1) mesh a smoke prefill and a smoke MoE train
    step traced under a fake mode and run for real record the same op
    counts, FLOPs and memory (the card's phase ``dryrun`` holds this at
    full width, with K4 and the allocator's peak);
  * ``make_production_mesh`` without a group raises, naming the ranks it
    needs, and starts no group; ``fake_pg`` imports.
"""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import _torch_dryrun as DR  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
JOIN_S = 300
# The port's train steps do a little more dot work than the reference's
# compiled ones, all of it in the backward's recompute: XLA's remat
# recomputes each checkpointed group once and drops what the backward
# does not read, where the port's eager checkpoints recompute a group's
# projections once more when the backward unpacks them and recompute each
# attention chunk pair again (its own checkpoint inside the group's).
# Measured: +1.92% at phi4-mini (train), +1.65% at qwen3-moe (train),
# 0 at the prefill (no backward).
DOT_FLOPS_RTOL = 0.05
# the reference's run_cell keys without a counterpart, and their stand-ins
NO_COUNTERPART = {"cost_analysis", "bytes_accessed", "hlo_ops", "lower_s",
                  "compile_s", "error", "traceback", "artifact"}
STAND_INS = {"ops", "trace_s", "build_s"}


def _wait(procs):
    try:
        logs = [p.communicate(timeout=JOIN_S) for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail(f"a process did not finish within {JOIN_S} s")
    for p, (out, err) in zip(procs, logs):
        assert p.returncode == 0, f"rc {p.returncode}:\n{out[-3000:]}\n" \
                                  f"{err[-3000:]}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"port", "reference", "gloo"}: the three programs' results."""
    d = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(REPO / "src"),
                                           str(REPO / "tests")]),
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    script = str(REPO / "tests" / "_torch_dryrun.py")
    out = {k: str(d / f"{k}.json") for k in ("port", "reference", "gloo")}
    run = lambda *a: subprocess.Popen(  # noqa: E731
        [sys.executable, script, *a], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    procs = [run("port", out["port"]), run("reference", out["reference"])]
    procs += [run("rank", str(r), str(WORLD), str(d / "store"), out["gloo"])
              for r in range(WORLD)]
    _wait(procs)
    return {k: json.loads(Path(p).read_text()) for k, p in out.items()}


@pytest.mark.parametrize("i", range(len(DR.CELLS)),
                         ids=[f"{a}-{k}" for a, k, *_ in DR.CELLS])
def test_smoke_cell_matches_reference(runs, i):
    got, want = runs["port"]["cells"][i], runs["reference"]["cells"][i]
    assert got["status"] == "ok", got.get("traceback")
    assert got["memory_analysis"]["argument_size_in_bytes"] == \
        want["memory_analysis"]["argument_size_in_bytes"]
    g, w = got["analysis"]["dot_flops"], want["analysis"]["dot_flops"]
    assert w > 0 and g == pytest.approx(w, rel=DOT_FLOPS_RTOL), (g, w)
    if DR.CELLS[i][1] == "prefill":
        assert g == w
    assert got["analysis"]["whiles"] == []
    assert got["analysis"]["n_computations"] > 0
    assert got["flops"] >= g


def test_fake_trace_equals_real_gloo_step(runs):
    fake = runs["port"]["cells"][DR.GLOO]["analysis"]
    real = runs["gloo"]["analysis"]
    assert real["collectives"] == fake["collectives"]
    assert sum(c["count"] for c in real["collectives"].values()) > 0
    assert real["dot_flops"] == fake["dot_flops"]
    assert real["kernel_flops"] == fake["kernel_flops"] == 0


@pytest.mark.parametrize("i", range(len(DR.PLAIN)),
                         ids=[f"{a}-{k}" for a, k, *_ in DR.PLAIN])
def test_fake_trace_equals_real_step_on_one_rank(runs, i):
    """The CPU's form of the card's gate: on a (1, 1) mesh a fake trace and
    the real step record the same ops, FLOPs and memory."""
    got = runs["port"]["plain"][i]
    fake, real = got["fake"], got["real"]
    assert fake["ops"] == real["ops"] and sum(real["ops"].values()) > 0
    assert fake["analysis"] == real["analysis"]
    assert fake["memory_analysis"] == real["memory_analysis"]


@pytest.mark.parametrize("i", range(len(DR.PRODUCTION)),
                         ids=[f"{m}-{a}-{k}" for m, a, k, *_ in DR.PRODUCTION])
def test_production_mesh_cell(runs, i):
    rec = runs["port"]["production"][i]
    mesh = DR.PRODUCTION[i][0]
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["devices"] == {"single": 256, "multi": 512}[mesh]
    src = (REPO / "src" / "repro" / "launch" / "dryrun.py").read_text()
    body = src[src.index("def run_cell"):src.index("def main")]
    ref_keys = set(re.findall(r'rec\["(\w+)"\]', body)) | set(
        re.findall(r'"(\w+)": ', body[body.index("rec = {"):
                                       body.index("try:")]))
    assert set(rec) == (ref_keys - NO_COUNTERPART) | STAND_INS
    assert rec["analysis"]["dot_flops"] > 0
    assert rec["memory_analysis"]["argument_size_in_bytes"] > 0


def test_production_mesh_needs_a_group(runs):
    msgs = runs["port"]["no_group"]
    assert "256" in msgs["False"] and "512" in msgs["True"]
    assert runs["port"]["initialized_after"] is False


def test_fake_pg_imports():
    from torch.testing._internal.distributed import fake_pg
    assert hasattr(fake_pg, "FakeStore")
