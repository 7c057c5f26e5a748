"""The port's shard_map runner (``repro_torch.api.ShardMapRunner`` over
``torch.distributed``) against the reference's ``shard_map`` on the CPU.

  * world size 1, in this process (gloo on an in-process store): every
    variant x band engine equals the port's ``VmapRunner(1)`` and the
    reference's ``ShardMapRunner()`` on its one CPU device, output for
    output and counter for counter
  * world size 4, four spawned ranks on a FileStore
    (``tests/_torch_multirank.py``): every variant x engine and one
    dual-source linkage give, on every rank, the reference's ``shard_map``
    on 4 forced XLA host devices (a subprocess, as
    ``test_distributed_cpu.py`` runs it) and the port's ``VmapRunner(4)``:
    blocked and matched sets, ``load``, overflow and every counter;
    repsn and jobsn equal the sequential SN oracle
  * the mesh helpers of ``repro_torch.launch``

Every process group has a 60 s timeout and every process a join timeout:
a hang fails the test.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_multirank as MR  # noqa: E402
from _torch_parity import assert_same_result, gloo_mesh, port_ents  # noqa: E402,F401,E501
from repro import api as RA  # noqa: E402
from repro.core import entities as RE  # noqa: E402
from repro_torch import api as TA  # noqa: E402
from repro_torch.api.runners import _to_host  # noqa: E402
from repro_torch.core import entities as TE  # noqa: E402
from repro_torch.core import sn  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
JOIN_S = 300
VARIANTS = ["srp", "repsn", "jobsn"]
ENGINES = ["scan", "pallas"]


# -- world size 1, in process -------------------------------------------------

@pytest.fixture(scope="module")
def ents():
    return RE.synth_entities(np.random.default_rng(3), 300, n_keys=60,
                             dup_frac=0.3, text_len=8)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, np.asarray(tree)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_world1_equals_vmap_and_reference(ents, gloo_mesh, variant, engine):
    kw = dict(window=5, variant=variant, band_engine=engine, num_shards=1,
              hops=1, emit="pairs")
    cfg = TA.ERConfig(**kw)
    b = TA.default_bounds(port_ents(ents), cfg, 1)
    sm = TA.ShardMapRunner(mesh=gloo_mesh, device="cpu")
    assert sm.shards == 1 and sm.name == "shard_map"
    got = _to_host(sm.run_raw(port_ents(ents), b, cfg))
    want = _to_host(TA.VmapRunner(1, device="cpu").run_raw(port_ents(ents),
                                                           b, cfg))
    assert dict(_leaves(got)).keys() == dict(_leaves(want)).keys()
    for (path, a), (_, c) in zip(_leaves(got), _leaves(want)):
        np.testing.assert_array_equal(a, c, err_msg=path)
    ref = RA.resolve(ents, RA.ERConfig(runner="shard_map", **kw))
    port = TA.resolve(port_ents(ents), TA.ERConfig(runner="shard_map", **kw),
                      mesh=gloo_mesh, device="cpu")
    assert_same_result(ref, port)


def test_world1_link_equals_reference(gloo_mesh):
    ents, lhs, rhs = MR.corpus(RE.synth_entities, RE.make_entities)
    kw = dict(window=MR.W_LINK, variant="jobsn", runner="shard_map",
              num_shards=1, hops=1)
    ref = RA.link(lhs, rhs, RA.ERConfig(**kw))
    port = TA.link(port_ents(lhs), port_ents(rhs), TA.ERConfig(**kw),
                   mesh=gloo_mesh, device="cpu")
    assert_same_result(ref, port)
    assert port.blocking.pairs


def test_mesh_helpers(gloo_mesh):
    from repro_torch.launch import Mesh, make_host_mesh, make_mesh_compat
    assert gloo_mesh.shape == {"data": 1}
    assert make_mesh_compat((1,), ("data",)) == gloo_mesh    # one key
    host = make_host_mesh()
    assert host.shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="ranks"):
        make_mesh_compat((2,), ("data",))
    with pytest.raises(ValueError, match="ranks"):
        make_mesh_compat((2, 2), ("data", "model"))
    with pytest.raises(ValueError, match="model"):
        make_host_mesh(model=2)
    # two axes above 1 are a mesh for the LM's rules; the SN runner, one
    # shard per rank, refuses them
    grid = Mesh(group=gloo_mesh.group, axis_names=("data", "model"),
                sizes=(2, 2))
    with pytest.raises(ValueError, match="one axis"):
        TA.ShardMapRunner(mesh=grid, axis="data", device="cpu")
    runner = TA.ShardMapRunner(mesh=host, axis="data", device="cpu")
    assert runner.shards == 1
    assert TA.make_runner(TA.ERConfig(runner="shard_map"), mesh=gloo_mesh,
                          device="cpu").mesh == gloo_mesh


@pytest.mark.parametrize("how", ["runner-default", "runner-cuda",
                                 "make_runner"])
def test_gloo_mesh_refused_by_a_card_runner(gloo_mesh, how):
    """A card runner (``device`` None or "cuda") refuses a gloo group: its
    collectives would go through host memory."""
    with pytest.raises(ValueError, match="needs nccl"):
        if how == "runner-default":
            TA.ShardMapRunner(mesh=gloo_mesh)
        elif how == "runner-cuda":
            TA.ShardMapRunner(mesh=gloo_mesh, device="cuda")
        else:
            TA.make_runner(TA.ERConfig(runner="shard_map"), mesh=gloo_mesh)


def test_mesh_defaults_to_the_card():
    """With no process group, a mesh built without ``device`` is the card's
    (NCCL), as every entry point of the port; without a card it raises and
    starts no group — in a fresh interpreter."""
    code = ("import pytest, torch\n"
            "import torch.distributed as dist\n"
            "from repro_torch.launch import make_host_mesh, "
            "make_mesh_compat\n"
            "if torch.cuda.is_available():\n"
            "    mesh = make_host_mesh()\n"
            "    assert dist.get_backend(mesh.group) == 'nccl'\n"
            "    dist.destroy_process_group()\n"
            "else:\n"
            "    for make in (make_host_mesh,\n"
            "                 lambda: make_mesh_compat((1,), ('data',))):\n"
            "        with pytest.raises(RuntimeError, match='no CUDA'):\n"
            "            make()\n"
            "    assert not dist.is_initialized()\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.stdout.strip() == "ok", out.stderr[-2000:]


def test_mesh_needs_processes_for_more_shards():
    """Without a process group a mesh of more than one shard is refused
    (it would need that many processes), in a fresh interpreter."""
    code = ("import pytest\n"
            "from repro_torch.launch import make_mesh_compat\n"
            "with pytest.raises(ValueError, match='processes'):\n"
            "    make_mesh_compat((4,), ('data',), device='cpu')\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.stdout.strip() == "ok", out.stderr[-2000:]


# -- world size 4, spawned ranks ---------------------------------------------

def _wait(procs):
    """Join every process (each within JOIN_S); a hang kills them all and
    fails."""
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
def world4(tmp_path_factory):
    """{"ranks": [4 rank results], "reference": its results}, from four
    port ranks and the reference's subprocess, all started together."""
    d = tmp_path_factory.mktemp("world4")
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(REPO / "src"),
                                           str(REPO / "tests")]))
    env.pop("XLA_FLAGS", None)
    script = str(REPO / "tests" / "_torch_multirank.py")
    ranks = [str(d / f"rank{r}.npz") for r in range(WORLD)]
    ref = str(d / "reference.npz")
    procs = [subprocess.Popen(
        [sys.executable, script, "rank", str(r), str(WORLD),
         str(d / "store"), ranks[r]], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(WORLD)]
    procs.append(subprocess.Popen(
        [sys.executable, script, "reference", str(WORLD), ref], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    _wait(procs)
    load = lambda p: dict(np.load(p))
    return {"ranks": [load(p) for p in ranks], "reference": load(ref)}


@pytest.fixture(scope="module")
def port_corpus():
    return MR.corpus(lambda *a, **k: TE.synth_entities(*a, device="cpu",
                                                       **k),
                     lambda *a, **k: TE.make_entities(*a, device="cpu",
                                                      **k))


def _fields(results, name):
    return {k.split(":", 1)[1]: v for k, v in results.items()
            if k.split(":", 1)[0] == name}


@pytest.mark.parametrize("name", list(MR.CASES))
def test_world4_equals_reference_and_vmap(world4, port_corpus, name):
    case = MR.CASES[name]
    got = [_fields(r, name) for r in world4["ranks"]]
    for other in got[1:]:                       # every rank holds it all
        for f, v in got[0].items():
            np.testing.assert_array_equal(other[f], v, err_msg=f)
    ref = _fields(world4["reference"], name)
    assert got[0].keys() == ref.keys()
    for f, v in ref.items():
        np.testing.assert_array_equal(got[0][f], v, err_msg=f"ref {f}")
    ents, lhs, rhs = port_corpus
    cfg = TA.ERConfig(**MR.config_kw(case, WORLD, "vmap"))
    vm = TA.link(lhs, rhs, cfg, device="cpu") if case.get("link") else \
        TA.resolve(ents, cfg, device="cpu")
    out = {}
    MR.record(out, name, vm)
    for f, v in _fields(out, name).items():
        np.testing.assert_array_equal(got[0][f], v, err_msg=f"vmap {f}")
    assert got[0]["overflow"] == 0 and got[0]["blocked"].size
    if case["variant"] != "srp" and not case.get("link"):
        h = TE.to_host(ents)
        oracle = sn.sequential_sn_pairs(h["key"], h["eid"], MR.W)
        assert set(map(tuple, got[0]["blocked"].tolist())) == oracle
