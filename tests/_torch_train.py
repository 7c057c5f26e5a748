"""Shared helpers for the LM training parity tests
(``tests/test_torch_train*.py``): one train state (the reference's
``train_state_init``, carried into the port with
``models.convert.train_state_from_reference``), seeded batches, the
reference's gradients (one jitted call) and step, and the stated
tolerances."""
from __future__ import annotations

import numpy as np

# f32 parity of one train step at smoke sizes, port (torch on the CPU)
# against the reference (XLA on the CPU): the loss and its parts are O(1)
# sums of the same f32 products in another order; the gradients, the grad
# norm and the moments are compared relative to the leaf's largest entry.
# The updated params move by lr * (an O(1) Adam step g / (|g| + eps)),
# within PARAM_ATOL of the reference's, except where |g| is near eps:
# there the step's derivative is ~1 / eps, so an element whose reference
# gradient is below FLIP_GRAD of its leaf's largest may move anywhere up
# to the largest Adam step (2.2 x lr).
LOSS_ATOL = 2e-5
GRAD_RTOL = 2e-4
NORM_RTOL = 1e-5
PARAM_ATOL = 2e-6
FLIP_GRAD = 1e-3

# the reference's jitted functions here are compiled with XLA's cheaper CPU
# code generation: the same function for a third to a half less compile
# time (the recurrent archs' gradients took 20-30 s without it)
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def ref_jit(fn):
    """``jax.jit(fn)`` with FAST_COMPILE."""
    import jax
    return jax.jit(fn, compiler_options=FAST_COMPILE)


def np_tree(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


def ref_state(rcfg, seed=0):
    """(the reference's f32 train state as numpy, the same as the port's
    on the CPU)."""
    import jax
    import jax.numpy as jnp
    from repro.train import steps as rsteps
    from repro_torch.models.convert import train_state_from_reference
    ref = np_tree(rsteps.train_state_init(jax.random.PRNGKey(seed), rcfg,
                                          jnp.float32))
    return ref, train_state_from_reference(ref, rcfg, device="cpu")


def batch(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((b, 1), -1, np.int32)],
                            axis=1)
    if cfg.frontend:
        return {"embeds": rng.normal(size=(b, s, cfg.d_model))
                .astype(np.float32), "labels": labels}
    return {"tokens": toks, "labels": labels}


def ref_step(rcfg, rrun, oc):
    """The reference's ``make_train_step``, jitted: ``fn(state, batch) ->
    (new state, metrics)``."""
    from repro.train import steps as rsteps
    return ref_jit(rsteps.make_train_step(rcfg, rrun, None, oc))


def ref_grads_and_update(rcfg, rrun, oc, state, b):
    """The reference's gradients through ``jax.value_and_grad(repro.models.
    lm.lm_loss)`` (jitted), and the train step they make without
    micro-batches (``make_train_step``'s own body: ``optim.adamw_update``
    of them, run op by op): (new state, metrics, grads).  One compile
    instead of the two of ``ref_step`` plus the gradients."""
    import jax
    from repro.models import lm as rlm
    from repro.train import optim as ropt
    vg = ref_jit(jax.value_and_grad(
        lambda p, bb: rlm.lm_loss(p, rcfg, bb, remat=rrun.remat,
                                  chunk_q=rrun.attn_chunk_q,
                                  chunk_kv=rrun.attn_chunk_kv),
        has_aux=True))
    (_, metrics), grads = vg(state["params"], b)
    params, opt, om = ropt.adamw_update(grads, state["opt"], state["params"],
                                        oc)
    return {"params": params, "opt": opt}, dict(metrics, **om), grads


def port_grads(cfg, run, params, b):
    """The port's loss metrics and gradients (autograd) of ``params`` on
    their device, as floats and numpy arrays keyed as ``tree_items`` keys
    them."""
    import torch
    from repro_torch.models import lm
    from repro_torch.models.modules import tree_items
    items = tree_items(params)
    for _, p in items:
        p.requires_grad_(True)
    try:
        loss, metrics = lm.lm_loss(params, cfg, b, remat=run.remat,
                                   chunk_q=run.attn_chunk_q,
                                   chunk_kv=run.attn_chunk_kv,
                                   device=lm.params_device(params))
        grads = torch.autograd.grad(loss, [p for _, p in items],
                                    materialize_grads=True)
    finally:
        for _, p in items:
            p.requires_grad_(False)
    return ({k: float(v.detach()) for k, v in metrics.items()},
            {k: g.cpu().numpy() for (k, _), g in zip(items, grads)})


def keyed(tree):
    """{keystr: numpy leaf} of a reference tree (numpy or jax leaves)."""
    import jax
    return {jax.tree_util.keystr(p): np.asarray(x) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_grads_close(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=k)


def assert_state_close(got: dict, want: dict, grads: dict, lr: float):
    """``got`` / ``want``: {keystr: array} of two train states after one
    step from the same state with reference gradients ``grads`` (keyed by
    the params' keys); tolerances as stated above."""
    assert got.keys() == want.keys()
    for k in want:
        if k.startswith("['opt']['step']"):
            assert got[k] == want[k]
            continue
        d = np.abs(got[k].astype(np.float64) - want[k].astype(np.float64))
        if not k.startswith("['params']"):
            scale = max(float(np.abs(want[k]).max()), 1e-30)
            assert d.max() <= GRAD_RTOL * scale, (k, d.max(), scale)
            continue
        g = np.abs(grads[k[len("['params']"):]])
        far = d > PARAM_ATOL
        assert np.all(g[far] <= FLIP_GRAD * g.max()), \
            (k, far.sum(), d.max(), g[far].max(), g.max())
        assert d.max() <= 2.2 * lr, (k, d.max())


# -- the train step of one arch, port against reference ----------------------

RECURRENT = ("recurrentgemma-9b", "xlstm-350m")
STEP_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
STEP_B, STEP_S = 2, 16


def check_train_step(name):
    """The port's ``make_train_step`` at ``name``'s smoke variant (f32, no
    remat) against the reference's gradients and step
    (``ref_grads_and_update``) from one state and batch."""
    import pytest
    from repro.configs import ARCHS as RARCHS
    from repro.configs import smoke_variant as rsmoke
    from repro.configs.base import RunConfig as RRun
    from repro.configs.base import ShapeConfig as RShape
    from repro.train import optim as ropt
    from repro_torch.configs import ARCHS, smoke_variant
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.models.modules import tree_items
    from repro_torch.train import optim as topt
    from repro_torch.train import steps as tsteps
    rcfg, cfg = rsmoke(RARCHS[name]), smoke_variant(ARCHS[name])
    rrun = RRun(model=rcfg, shape=RShape("t", STEP_S, STEP_B, "train"),
                fsdp=False, remat="none")
    run = RunConfig(model=cfg, shape=ShapeConfig("t", STEP_S, STEP_B,
                                                 "train"),
                    fsdp=False, remat="none")
    ref, state = ref_state(rcfg)
    b = batch(cfg, STEP_B, STEP_S)
    want_state, want_m, want_g = ref_grads_and_update(
        rcfg, rrun, ropt.OptConfig(**STEP_OPT), ref, b)
    metrics, grads = port_grads(cfg, run, state["params"], b)
    assert_grads_close(grads, keyed(want_g))
    step = tsteps.make_train_step(cfg, run, None,
                                  topt.OptConfig(**STEP_OPT))
    got_state, got_m = step(state, b)
    assert got_state is state
    for k in ("loss", "ce", "aux"):
        assert float(got_m[k]) == pytest.approx(metrics[k], abs=1e-7)
        assert abs(float(got_m[k]) - float(want_m[k])) <= LOSS_ATOL, k
    assert float(got_m["grad_norm"]) == pytest.approx(
        float(want_m["grad_norm"]), rel=NORM_RTOL)
    assert float(got_m["lr"]) == float(want_m["lr"])
    assert int(got_state["opt"]["step"]) == 1
    assert_state_close({k: t.numpy() for k, t in tree_items(got_state)},
                       keyed(want_state), keyed(want_g), STEP_OPT["lr"])
