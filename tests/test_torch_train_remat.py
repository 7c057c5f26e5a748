"""Port parity for the train step's ``remat`` and micro-batches, at one
dense arch (phi4, pattern period 1) and one multi-block-pattern arch
(gemma2: local + global), against the reference's ``make_train_step``
with the same ``RunConfig``; and that ``remat`` really recomputes: the
blocks run again in the backward (more often under the nested
checkpoints of a period above 1), with the same numbers as without it.
Tolerances in ``tests/_torch_train.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS as RARCHS  # noqa: E402
from repro.configs import smoke_variant as rsmoke  # noqa: E402
from repro.configs.base import RunConfig as RRun  # noqa: E402
from repro.configs.base import ShapeConfig as RShape  # noqa: E402
from repro.train import optim as ropt  # noqa: E402
from repro_torch.configs import ARCHS, smoke_variant  # noqa: E402
from repro_torch.configs.base import RunConfig, ShapeConfig  # noqa: E402
from repro_torch.models import blocks  # noqa: E402
from repro_torch.models.modules import tree_items  # noqa: E402
from repro_torch.train import optim as topt  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

from _torch_train import (LOSS_ATOL, NORM_RTOL, PARAM_ATOL,  # noqa: E402
                          batch, keyed, port_grads, ref_state, ref_step)

OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
# the share of params allowed beyond PARAM_ATOL (a few elements of the
# ~10^5 at these sizes; the most read when this was written: 2)
FLIP_SHARE = 1e-4
ARCH_NAMES = ("phi4-mini-3.8b", "gemma2-9b")


def _runs(name, b, s, **kw):
    rcfg, cfg = rsmoke(RARCHS[name]), smoke_variant(ARCHS[name])
    return (rcfg, RRun(model=rcfg, shape=RShape("t", s, b, "train"),
                       fsdp=False, **kw),
            cfg, RunConfig(model=cfg, shape=ShapeConfig("t", s, b, "train"),
                           fsdp=False, **kw))


def _check_against_reference(name, b, s, **kw):
    """The port's step against the reference's make_train_step for one
    RunConfig: loss, grad norm, lr and the updated params (both sides sum
    the same micro-batch gradients)."""
    rcfg, rrun, cfg, run = _runs(name, b, s, **kw)
    ref, state = ref_state(rcfg)
    bt = batch(cfg, b, s)
    want_state, want_m = ref_step(rcfg, rrun, ropt.OptConfig(**OPT))(ref, bt)
    got_state, got_m = tsteps.make_train_step(
        cfg, run, None, topt.OptConfig(**OPT))(state, bt)
    for k in ("loss", "ce", "aux"):
        assert abs(float(got_m[k]) - float(want_m[k])) <= LOSS_ATOL, k
    assert float(got_m["grad_norm"]) == pytest.approx(
        float(want_m["grad_norm"]), rel=NORM_RTOL)
    assert float(got_m["lr"]) == float(want_m["lr"])
    want = keyed(want_state)
    far = total = 0
    for k, t in tree_items(got_state["params"]):
        d = np.abs(t.numpy() - want["['params']" + k])
        # each element within one Adam step of lr; beyond PARAM_ATOL only
        # where its gradient is zero up to rounding (see FLIP_GRAD)
        assert d.max() <= 2.2 * OPT["lr"], k
        far += int((d > PARAM_ATOL).sum())
        total += d.size
    assert far <= FLIP_SHARE * total, (far, total)


@pytest.mark.parametrize("remat", ["none", "block", "full"])
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_remat_matches_reference(name, remat):
    _check_against_reference(name, 2, 16, remat=remat)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_microbatch_matches_reference(name):
    _check_against_reference(name, 4, 16, remat="block", microbatch=2)


@pytest.mark.parametrize("remat", ["block", "full"])
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_remat_recomputes_and_keeps_the_numbers(name, remat, monkeypatch):
    _, _, cfg, run = _runs(name, 2, 16, remat="none")
    _, state = ref_state(rsmoke(RARCHS[name]))
    bt = batch(cfg, 2, 16)
    calls = []
    apply = blocks.block_apply

    def counted(*args, **kw):
        calls.append(1)
        return apply(*args, **kw)

    monkeypatch.setattr(blocks, "block_apply", counted)
    want_m, want_g = port_grads(cfg, run, state["params"], bt)
    n_blocks = len(calls)
    assert n_blocks == cfg.n_layers
    calls.clear()
    got_m, got_g = port_grads(cfg, RunConfig(model=cfg, shape=run.shape,
                                             remat=remat),
                              state["params"], bt)
    # the group's recompute runs each block once more; with a period
    # above 1 each block is checkpointed inside it too and recomputed in
    # its own backward again (the group's recompute stops early, at the
    # last block's checkpoint)
    if len(cfg.pattern) == 1:
        assert len(calls) == 2 * n_blocks
    else:
        assert len(calls) > 2 * n_blocks
    assert got_m == want_m
    for k in want_g:
        assert (got_g[k] == want_g[k]).all(), k


def test_k4_route_excludes_operands_that_require_grad():
    """K4 has no backward: its route takes no operand that requires grad,
    and the kernel's wrapper refuses one (here its plain version, on the
    CPU, as on the card)."""
    from repro_torch.kernels import ops
    from repro_torch.models import attention as A
    shape = (1, 256, 2, 64)
    kw = dict(causal=True, window=128)
    assert A.local_attn_route(shape, shape, **kw)
    assert not A.local_attn_route(shape, shape, requires_grad=True, **kw)
    q = torch.zeros((2, 256, 64), requires_grad=True)
    with pytest.raises(ValueError, match="no backward"):
        ops.local_attn(q, q.detach(), q.detach(), window=128)
