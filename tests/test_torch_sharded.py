"""The LM scaffold's sharded half on four ranks: the port's sharding rules
over a (2, 2) ("data", "model") DTensor mesh of four gloo ranks
(``tests/_torch_sharded.py rank``) against the reference's rules on a
(2, 2) ``jax.sharding.Mesh`` of four forced XLA host devices
(``_torch_sharded.py reference``), all five processes started together
on one inputs file:

  * the expert-parallel and the width-parallel MoE with rules on a
    skewed input, so that tokens drop: the output, aux loss, drop
    fraction and the gradients of ``sum(y**2) + aux`` of every weight
    (a doubled backward of the sum over "model" shows here);
  * one FSDP train step at smoke Gemma-2 (two micro-batches) and smoke
    Qwen3-MoE from the reference's state: loss, grad norm, every param
    and moment after the step;
  * prefill and decode with ``seq_shard_kv``: the greedy tokens;
  * a checkpoint the ranks wrote after the sharded step: the reference
    restores it, the port restores it onto the mesh;
  * the train launcher at ``--model-axis 2`` against ``--model-axis 1``;
  * the recurrent mixers (RG-LRU, mLSTM / sLSTM) with rules against the
    port's own unsharded loss and gradients.

The bounds are the reference's own for its sharded MoE against one device
(``test_distributed_cpu.py::test_moe_distributed_matches_single_device``)
and, for the train step, ``tests/_torch_train.py``'s: f32 sums of the
same products in another order.  Every process has a join timeout.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_sharded as SH  # noqa: E402
from _torch_train import (GRAD_RTOL, LOSS_ATOL, NORM_RTOL,  # noqa: E402
                          assert_state_close)

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
JOIN_S = 400
# the reference's bounds for its sharded MoE against one device
MOE_RTOL, AUX_ATOL = 2e-4, 1e-5
# the launcher's bf16 training at (2, 2) against (1, 1): the contractions
# split over "model" round their bf16 partial sums in other places
LAUNCH_LOSS_ATOL = 2e-3


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
    """{"ranks": [4 rank results], "reference": its results, "dir"}."""
    d = tmp_path_factory.mktemp("sharded")
    inputs = str(d / "inputs.pkl")
    SH.write_inputs(inputs)
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(REPO / "src"),
                                           str(REPO / "tests")]),
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    script = str(REPO / "tests" / "_torch_sharded.py")
    ranks = [str(d / f"rank{r}.pkl") for r in range(WORLD)]
    ref = str(d / "reference.pkl")
    procs = [subprocess.Popen(
        [sys.executable, script, "rank", str(r), str(WORLD),
         str(d / "store"), inputs, ranks[r], str(d / "ckpt")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)]
    procs.append(subprocess.Popen(
        [sys.executable, script, "reference", inputs, ref], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    _wait(procs)

    def load(p):
        with open(p, "rb") as f:
            return pickle.load(f)
    with open(inputs, "rb") as f:
        data = pickle.load(f)
    return {"ranks": [load(p) for p in ranks], "reference": load(ref),
            "dir": d, "inputs": data}


@pytest.mark.parametrize("name", list(SH.MOE))
def test_moe_matches_reference_with_drops(runs, name):
    want = runs["reference"][f"moe/{name}"]
    assert want["drop"] > 0                     # the skew drops tokens
    for got in (r[f"moe/{name}"] for r in runs["ranks"]):
        scale = max(float(np.abs(want["y"]).max()), 1.0)
        np.testing.assert_allclose(got["y"], want["y"], rtol=0,
                                   atol=MOE_RTOL * scale)
        assert abs(got["aux"] - want["aux"]) < AUX_ATOL
        assert got["drop"] == pytest.approx(want["drop"], abs=1e-7)
        assert got["grads"].keys() == want["grads"].keys()
        for k, g in want["grads"].items():
            gs = max(float(np.abs(g).max()), 1e-30)
            np.testing.assert_allclose(got["grads"][k], g, rtol=0,
                                       atol=MOE_RTOL * gs, err_msg=k)


@pytest.mark.parametrize("arch", list(SH.TRAIN))
def test_train_step_matches_reference(runs, arch):
    want = runs["reference"][f"train/{arch}"]
    for got in (r[f"train/{arch}"] for r in runs["ranks"]):
        for k in ("loss", "ce", "aux"):
            assert abs(got["metrics"][k] - want["metrics"][k]) <= \
                LOSS_ATOL, k
        assert got["metrics"]["grad_norm"] == pytest.approx(
            want["metrics"]["grad_norm"], rel=NORM_RTOL)
        assert got["metrics"]["lr"] == pytest.approx(want["metrics"]["lr"],
                                                     rel=1e-7)
        # the reference's gradients: its first moment after one step is
        # (1 - b1) * the clipped gradient, so any leaf of m bounds them
        grads = {k[len("['opt']['m']"):]: v for k, v in want["state"].items()
                 if k.startswith("['opt']['m']")}
        assert_state_close(got["state"], want["state"], grads, SH.OPT["lr"])


@pytest.mark.parametrize("arch", list(SH.RECURRENT))
def test_recurrent_mixers_under_rules(runs, arch):
    """The recurrent mixers with rules (each rank's rows, whole weights)
    give the port's unsharded loss and gradients on the same params."""
    for r in runs["ranks"]:
        got, want = r[f"recurrent/{arch}"]["rules"], \
            r[f"recurrent/{arch}"]["plain"]
        assert abs(got["loss"] - want["loss"]) <= LOSS_ATOL
        for k, g in want["grads"].items():
            gs = max(float(np.abs(g).max()), 1e-30)
            np.testing.assert_allclose(got["grads"][k], g, rtol=0,
                                       atol=GRAD_RTOL * gs, err_msg=k)


def test_serve_steps_match_reference(runs):
    want = runs["reference"]["serve"]["tokens"]
    assert want.shape == (SH.SERVE_B, SH.DECODE + 1)
    for r in runs["ranks"]:
        np.testing.assert_array_equal(r["serve"]["tokens"], want)
        # the global layer's cache is split over "model" on T
        assert r["serve"]["cache_local_t"] == SH.SERVE_T // SH.MESH[1]


def test_sharded_checkpoint_crosses_packages(runs):
    """The ranks' checkpoint after the sharded step: the port restored it
    onto the mesh in the resolved placements, and the reference restores
    it (f32) to the state the ranks held."""
    import jax
    from repro.train.checkpoint import Checkpointer as RCheckpointer
    for r in runs["ranks"]:
        assert r["ckpt"] == {"placements_equal": True,
                             "values_equal": True}
    like = runs["inputs"]["train"]["gemma2-9b"]["state"]
    back = RCheckpointer(runs["dir"] / "ckpt").restore(1, like)
    got = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
           jax.tree_util.tree_flatten_with_path(back)[0]}
    want = runs["ranks"][0]["train/gemma2-9b"]["state"]
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_launcher_model_axis_2_matches_model_axis_1(runs, tmp_path):
    from repro_torch.launch import train as tlaunch
    stats = tlaunch.main(SH.launch_argv(str(tmp_path), 1) +
                         ["--device", "cpu"])
    assert len(stats.losses) == SH.LAUNCH["steps"]
    for r in runs["ranks"]:
        np.testing.assert_allclose(r["launch"]["losses"], stats.losses,
                                   rtol=0, atol=LAUNCH_LOSS_ATOL)
