"""The port's ``train.checkpoint.Checkpointer`` and ``train.loop.
train_loop``: roundtrip, atomic writes, GC, async saves, checkpoints that
cross between the packages both ways (bf16 included: the reference's
``|V2`` words restored bit for bit), and the loop's fault injection,
resume determinism and falling loss, as ``tests/test_checkpoint_loop.py``
holds them for the reference — with the port's loop losses against the
reference's on the same state and data."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS as RARCHS  # noqa: E402
from repro.configs import smoke_variant as rsmoke  # noqa: E402
from repro.configs.base import RunConfig as RRun  # noqa: E402
from repro.configs.base import ShapeConfig as RShape  # noqa: E402
from repro.data.corpus import TokenBatcher as RBatcher  # noqa: E402
from repro.data.corpus import synth_corpus  # noqa: E402
from repro.train import optim as ropt  # noqa: E402
from repro.train import steps as rsteps  # noqa: E402
from repro.train.checkpoint import Checkpointer as RCheckpointer  # noqa: E402
from repro.train.loop import LoopConfig as RLoopConfig  # noqa: E402
from repro.train.loop import train_loop as rtrain_loop  # noqa: E402
from repro_torch.configs import ARCHS, smoke_variant  # noqa: E402
from repro_torch.configs.base import RunConfig, ShapeConfig  # noqa: E402
from repro_torch.data.corpus import TokenBatcher  # noqa: E402
from repro_torch.models.convert import train_state_from_reference  # noqa: E402
from repro_torch.models.modules import tree_items, tree_map  # noqa: E402
from repro_torch.sharding import local as SL  # noqa: E402
from repro_torch.train import optim as topt  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402
from repro_torch.train.checkpoint import Checkpointer  # noqa: E402
from repro_torch.train.loop import LoopConfig, train_loop  # noqa: E402

from _torch_train import keyed, np_tree, ref_jit  # noqa: E402

ARCH = "phi4-mini-3.8b"
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=50)
# f32 loop losses, port against reference, after up to 12 steps of the
# same data: per-step loss error ~1e-6, compounded through Adam's updates
LOOP_LOSS_ATOL = 1e-4


@pytest.fixture()
def setup(tmp_path):
    rcfg, cfg = rsmoke(RARCHS[ARCH]), smoke_variant(ARCHS[ARCH])
    run = RunConfig(model=cfg, shape=ShapeConfig("t", 32, 4, "train"),
                    fsdp=False, remat="none")
    step = tsteps.make_train_step(cfg, run, None, topt.OptConfig(**OPT))
    ref = np_tree(rsteps.train_state_init(jax.random.PRNGKey(0), rcfg,
                                          jnp.float32))
    state = train_state_from_reference(ref, cfg, device="cpu")
    docs = synth_corpus(0, 256, doc_len=32, vocab=cfg.vocab_size)
    batcher = TokenBatcher(docs, seq_len=32, global_batch=4)
    return rcfg, cfg, step, ref, state, batcher, tmp_path


@contextlib.contextmanager
def _host_rules():
    """``Rules`` on the port's (1, 1) mesh of a world-size-1 gloo group,
    destroyed after unless one existed before."""
    import torch.distributed as dist

    from repro_torch.launch import make_host_mesh
    from repro_torch.sharding import Rules
    started = not dist.is_initialized()
    try:
        yield Rules(make_host_mesh(device="cpu"))
    finally:
        if started:
            dist.destroy_process_group()


def clone(state):
    return tree_map(torch.clone, state)


def assert_equal_states(a, b):
    items_a, items_b = tree_items(a), tree_items(b)
    assert [k for k, _ in items_a] == [k for k, _ in items_b]
    for (k, x), (_, y) in zip(items_a, items_b):
        assert x.dtype == y.dtype and torch.equal(x, y), k


def test_checkpoint_roundtrip(setup):
    _, _, step, _, state, batcher, tmp = setup
    ck = Checkpointer(tmp / "ck")
    state2, _ = step(state, batcher.batch(0))
    ck.save(1, state2)
    assert ck.latest_step() == 1
    restored = ck.restore(1, state2, device="cpu")
    assert_equal_states(restored, state2)
    shapes = tree_map(lambda t: tsteps.ShapeDtype(tuple(t.shape), t.dtype),
                      state2)
    assert_equal_states(ck.restore(1, shapes, device="cpu"), state2)
    # onto a (1, 1) mesh, whose layouts are whole tensors: plain tensors
    # (a mesh axis above 1 gives DTensors: test_torch_sharded.py)
    cfg = setup[1]
    with _host_rules() as rules:
        sh = tsteps.resolve_shardings(rules, tsteps.train_state_specs(cfg),
                                      shapes)
        back = ck.restore(1, shapes, device="cpu", shardings=sh)
        assert not any(SL.is_dtensor(t) for _, t in tree_items(back))
        assert_equal_states(back, state2)


def test_atomic_no_partial_checkpoints(setup):
    *_, state, _, tmp = setup
    ck = Checkpointer(tmp / "ck")
    ck.save(5, state)
    # a stale tmp file (simulated crash mid-write) must not be visible
    (tmp / "ck" / "step_9.npz.tmp").write_bytes(b"garbage")
    assert ck.latest_step() == 5
    assert not list((tmp / "ck").glob("manifest.json.tmp"))


def test_gc_keeps_the_newest(setup):
    *_, state, _, tmp = setup
    ck = Checkpointer(tmp / "ck", keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, state)
    assert sorted(p.name for p in (tmp / "ck").glob("step_*")) == \
        ["step_3.npz", "step_4.npz"]
    assert ck.latest_step() == 4
    (tmp / "ck" / "manifest.json").unlink()
    assert ck.latest_step() == 4            # from the files alone


def test_async_save_takes_host_copies_first(setup):
    _, _, step, _, state, batcher, tmp = setup
    ck = Checkpointer(tmp / "ck", async_save=True)
    before = clone(state)
    ck.save(1, state)
    step(state, batcher.batch(0))           # updates the state in place
    ck.save(2, state)
    ck.wait()
    assert ck.latest_step() == 2
    assert_equal_states(ck.restore(1, state, device="cpu"), before)
    assert_equal_states(ck.restore(2, state, device="cpu"), state)


def test_f32_checkpoints_cross_both_ways(setup):
    _, _, step, ref, state, batcher, tmp = setup
    RCheckpointer(tmp / "ref").save(3, ref)
    got = Checkpointer(tmp / "ref").restore(3, state, device="cpu")
    assert_equal_states(got, train_state_from_reference(
        ref, smoke_variant(ARCHS[ARCH]), device="cpu"))
    step(state, batcher.batch(0))
    Checkpointer(tmp / "port").save(4, state)
    back = RCheckpointer(tmp / "port").restore(4, jax.eval_shape(
        lambda: jax.tree.map(jnp.asarray, ref)))
    want = {k: t.numpy() for k, t in tree_items(state)}
    for k, x in keyed(back).items():
        np.testing.assert_array_equal(x, want[k], err_msg=k)


def test_bf16_checkpoints_cross_bit_for_bit(tmp_path):
    """The reference writes bf16 leaves as raw |V2 words; the port restores
    them bit for bit and writes the same file back."""
    rcfg, cfg = rsmoke(RARCHS[ARCH]), smoke_variant(ARCHS[ARCH])
    ref = rsteps.train_state_init(jax.random.PRNGKey(1), rcfg, jnp.bfloat16)
    RCheckpointer(tmp_path / "ref").save(7, ref)
    like = tsteps.train_state_init(0, cfg, torch.bfloat16, device="cpu")
    got = Checkpointer(tmp_path / "ref").restore(7, like, device="cpu")
    want, dtypes = keyed(ref), {k: t.dtype for k, t in tree_items(like)}
    for k, t in tree_items(got):
        assert t.dtype == dtypes[k]
        w = want[k]
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(
                t.view(torch.int16).numpy(), w.view(np.int16), err_msg=k)
        else:
            np.testing.assert_array_equal(t.numpy(), w, err_msg=k)
    Checkpointer(tmp_path / "port").save(7, got)
    with np.load(tmp_path / "ref" / "step_7.npz") as a, \
            np.load(tmp_path / "port" / "step_7.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            assert a[k].tobytes() == b[k].tobytes(), k
        assert a["['params']['embed']['table']"].dtype.str == "|V2"


def test_fault_injection_recovers(setup):
    """A mid-run device failure restores from the last checkpoint and the
    run completes with the same step count — with the reference's losses
    for the same fault."""
    rcfg, _, step, ref, state, batcher, tmp = setup
    ck = Checkpointer(tmp / "ckf")
    lc = LoopConfig(total_steps=12, ckpt_every=4, log_every=100)
    _, stats = train_loop(step, state, batcher, ck, lc, inject_fault_at=6)
    assert stats.restores == 1
    assert ck.latest_step() == 12
    assert len(stats.losses) >= 12

    rrun = RRun(model=rcfg, shape=RShape("t", 32, 4, "train"), fsdp=False,
                remat="none")
    rstep = ref_jit(rsteps.make_train_step(rcfg, rrun, None,
                                           ropt.OptConfig(**OPT)))
    _, rstats = rtrain_loop(
        rstep, jax.tree.map(jnp.asarray, ref),
        RBatcher(batcher.docs, seq_len=32, global_batch=4),
        RCheckpointer(tmp / "ref"),
        RLoopConfig(total_steps=12, ckpt_every=4, log_every=100),
        inject_fault_at=6)
    assert rstats.restores == stats.restores
    np.testing.assert_allclose(stats.losses, rstats.losses, rtol=0,
                               atol=LOOP_LOSS_ATOL)


def test_resume_determinism(setup):
    """10 steps straight vs 5 + resume: identical final state, bit for bit
    (deterministic data order + checkpointed optimizer state)."""
    _, _, step, _, state, batcher, tmp = setup
    ck_a = Checkpointer(tmp / "a")
    la = LoopConfig(total_steps=10, ckpt_every=5, log_every=100)
    final_a, _ = train_loop(step, clone(state), batcher, ck_a, la)

    ck_b = Checkpointer(tmp / "b")
    lb = LoopConfig(total_steps=5, ckpt_every=5, log_every=100)
    train_loop(step, clone(state), batcher, ck_b, lb)
    lb2 = LoopConfig(total_steps=10, ckpt_every=5, log_every=100)
    final_b, stats_b = train_loop(step, clone(state), batcher, ck_b, lb2)
    assert stats_b.steps == 5
    assert_equal_states(final_a, final_b)


def test_loss_decreases_over_training(setup):
    *_, step, _, state, batcher, tmp = setup
    ck = Checkpointer(tmp / "ld")
    lc = LoopConfig(total_steps=40, ckpt_every=50, log_every=100)
    _, stats = train_loop(step, state, batcher, ck, lc)
    first = np.mean(stats.losses[:5])
    last = np.mean(stats.losses[-5:])
    assert last < first, (first, last)


def test_loop_shardings_not_ported(setup):
    """``train_loop(shardings=)`` on a (1, 1) mesh: a fault restores the
    checkpoint by its shardings, and the run ends on the unsharded run's
    state."""
    _, cfg, step, _, state, batcher, tmp = setup
    lc = LoopConfig(total_steps=4, ckpt_every=2, log_every=100)
    want, _ = train_loop(step, clone(state), batcher,
                         Checkpointer(tmp / "plain"), lc)
    run = RunConfig(model=cfg, shape=ShapeConfig("t", 32, 4, "train"),
                    fsdp=False, remat="none")
    with _host_rules() as rules:
        sh = tsteps.resolve_shardings(rules, tsteps.train_state_specs(cfg),
                                      state)
        got, stats = train_loop(
            tsteps.make_train_step(cfg, run, rules, topt.OptConfig(**OPT)),
            tsteps.place_tree(clone(state), sh), batcher,
            Checkpointer(tmp / "s"), lc, shardings=sh, inject_fault_at=3)
        assert stats.restores == 1
        # the (1, 1) mesh's layouts are whole tensors: kept plain
        assert not any(SL.is_dtensor(t) for _, t in tree_items(got))
    for (k, x), (_, y) in zip(tree_items(got), tree_items(want)):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-5, msg=k)
