"""The port's train launcher, ``python -m repro_torch.launch.train``, at
``--preset smoke --device cpu --dedup``: its dedup stage, batches and
losses against the reference's pieces composed the same way
(``synth_corpus`` -> ``dedup_corpus`` -> ``TokenBatcher`` ->
``make_train_step`` -> ``Checkpointer`` + ``train_loop``) from the same
bf16 state.  The reference's own ``main`` stops at its mesh on the jax
this suite runs (ROADMAP "Reference-side facts"), so the test composes
its pieces."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS as RARCHS  # noqa: E402
from repro.configs import smoke_variant as rsmoke  # noqa: E402
from repro.configs.base import RunConfig as RRun  # noqa: E402
from repro.configs.base import ShapeConfig as RShape  # noqa: E402
from repro.data import corpus as rcorpus  # noqa: E402
from repro.train import optim as ropt  # noqa: E402
from repro.train import steps as rsteps  # noqa: E402
from repro.train.checkpoint import Checkpointer as RCheckpointer  # noqa: E402
from repro.train.loop import LoopConfig as RLoopConfig  # noqa: E402
from repro.train.loop import train_loop as rtrain_loop  # noqa: E402
from repro_torch.configs import ARCHS, smoke_variant  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models.convert import train_state_from_reference  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

from _torch_train import np_tree, ref_jit  # noqa: E402

ARCH, STEPS, EVERY, SEQ, BATCH = "phi4-mini-3.8b", 8, 4, 64, 4
# bf16 training, port against reference: each side rounds its bf16
# matmuls and elementwise chains in its own places, and the losses (~5.56,
# f32 means over 256 tokens of logits from bf16 products) parted by
# 3.1e-5 at most over the run's 8 steps when this was written
LAUNCH_LOSS_ATOL = 1e-3


def _reference_run(rcfg, tmp):
    """The reference launcher's body with one device and no rules."""
    docs = rcorpus.synth_corpus(0, n_docs=4096, doc_len=SEQ,
                                vocab=rcfg.vocab_size, dup_frac=0.25)
    res = rcorpus.dedup_corpus(docs, r=4, window=10)
    batcher = rcorpus.TokenBatcher(docs[res.keep], seq_len=SEQ,
                                   global_batch=BATCH)
    run = RRun(model=rcfg, shape=RShape("cli", SEQ, BATCH, "train"),
               remat="block", microbatch=0)
    oc = ropt.OptConfig(lr=3e-4, warmup_steps=max(STEPS // 20, 5),
                        total_steps=STEPS)
    step = ref_jit(rsteps.make_train_step(rcfg, run, None, oc))
    state = rsteps.train_state_init(jax.random.PRNGKey(0), rcfg,
                                    jnp.bfloat16)
    _, stats = rtrain_loop(step, state, batcher,
                           RCheckpointer(tmp, async_save=True),
                           RLoopConfig(total_steps=STEPS, ckpt_every=EVERY))
    return res, state, stats


def test_launcher_matches_reference_pieces(tmp_path, monkeypatch, capsys):
    rcfg, cfg = rsmoke(RARCHS[ARCH]), smoke_variant(ARCHS[ARCH])
    res, ref_state, ref_stats = _reference_run(rcfg, tmp_path / "ref")
    capsys.readouterr()
    # the launcher's own init draws the port's weights; start it from the
    # reference's to compare the runs
    start = train_state_from_reference(np_tree(ref_state), cfg,
                                       device="cpu")
    monkeypatch.setattr(tsteps, "train_state_init",
                        lambda key, c, dtype, device=None: start)
    stats = tlaunch.main([
        "--arch", ARCH, "--preset", "smoke", "--device", "cpu", "--dedup",
        "--steps", str(STEPS), "--ckpt-every", str(EVERY),
        "--seq-len", str(SEQ), "--batch", str(BATCH),
        "--ckpt-dir", str(tmp_path / "port")])
    out = capsys.readouterr().out
    pairs, dropped = map(int, re.search(
        r"\[dedup\] pairs=(\d+) dropped=(\d+)", out).groups())
    assert (pairs, dropped) == (res.n_pairs, res.n_dropped)
    assert f"steps={STEPS}" in out and "restores=0" in out
    assert stats.steps == ref_stats.steps == STEPS
    np.testing.assert_allclose(stats.losses, ref_stats.losses, rtol=0,
                               atol=LAUNCH_LOSS_ATOL)
    assert sorted(p.name for p in (tmp_path / "port").glob("step_*")) == \
        sorted(p.name for p in (tmp_path / "ref").glob("step_*"))


def test_launcher_refuses_a_model_axis(tmp_path):
    """A model axis that does not divide the world (one process here) has
    no mesh; the process group the launcher started is gone after."""
    import torch.distributed as dist
    started = not dist.is_initialized()
    with pytest.raises(ValueError, match="world size"):
        tlaunch.main(["--device", "cpu", "--model-axis", "2",
                      "--ckpt-dir", str(tmp_path)])
    assert dist.is_initialized() != started


def test_hundred_m_variant_matches_reference():
    from repro.launch.train import hundred_m_variant as rhundred
    for name in sorted(ARCHS):
        want = rhundred(RARCHS[name])
        got = tlaunch.hundred_m_variant(ARCHS[name])
        assert got.param_count() == want.param_count(), name
        assert (got.n_layers, got.d_model, got.vocab_size) == \
            (want.n_layers, want.d_model, want.vocab_size)
