"""The LM's training path on the card: a Gemma-2-shaped config (head dim
256, local layers with a 128-token window, S = 256) trains through the
plain chunk-pair scan, never K4 (which has no backward), with the CPU's
gradients; K4 itself refuses an operand that requires grad.  Every test
is marked ``gpu`` and skips where there is no CUDA card.  This file
imports no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_train_gpu.py
"""
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, smoke_variant  # noqa: E402
from repro_torch.configs.base import RunConfig, ShapeConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.modules import tree_map  # noqa: E402
from repro_torch.train import optim, steps  # noqa: E402

from _torch_parity import cuda  # noqa: E402,F401
from _torch_train import port_grads  # noqa: E402

B, S = 2, 256
# f32 gradients (PyTorch keeps TF32 off for matmuls by default), card
# against CPU: the same products summed in another order, relative to the
# leaf's largest entry
GRAD_RTOL = 1e-4


def _gemma_shaped():
    cfg = replace(smoke_variant(ARCHS["gemma2-9b"]), head_dim=256,
                  window_size=128)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    return cfg, {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}


@pytest.mark.gpu
def test_gemma_shaped_config_trains_on_the_card_without_k4(cuda):
    cfg, batch = _gemma_shaped()
    cpu = lm.lm_init(0, cfg, torch.float32, device="cpu")
    card = tree_map(lambda t: t.to(cuda), cpu)
    run = RunConfig(model=cfg, shape=ShapeConfig("t", S, B, "train"))
    ops.reset_launch_counts()
    got_m, grads = port_grads(cfg, run, card, batch)
    torch.cuda.synchronize()
    assert ops.launch_counts()["local_attn"] == 0
    want_m, want = port_grads(cfg, run, cpu, batch)
    assert got_m["loss"] == pytest.approx(want_m["loss"], rel=1e-5)
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        np.testing.assert_allclose(grads[k], want[k], rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=k)
    # a train step on the card runs the same path and launches no K4
    state = {"params": card, "opt": optim.adamw_init(card)}
    _, metrics = steps.make_train_step(cfg, run)(state, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert ops.launch_counts()["local_attn"] == 0
    # without a gradient the local layers' prefill takes K4's route
    with torch.no_grad():
        lm.forward(card, cfg, tokens=batch["tokens"], device=cuda)
    torch.cuda.synchronize()
    n_local = cfg.pattern.count("attn_local") * cfg.n_groups
    assert ops.launch_counts()["local_attn"] == n_local


@pytest.mark.gpu
def test_local_attn_refuses_an_operand_that_requires_grad(cuda):
    q = torch.randn((2, 256, 64), device=cuda)
    k, v = torch.randn_like(q), torch.randn_like(q)
    before = ops.launch_counts()["local_attn"]
    with pytest.raises(ValueError, match="no backward"):
        ops.local_attn(q.requires_grad_(), k, v, window=64)
    assert ops.launch_counts()["local_attn"] == before


@pytest.mark.gpu
def test_sharded_steps_on_the_card_mesh(cuda):
    """The sharding rules on the card's (1, 1) NCCL mesh (plain tensors):
    the prefill runs K4 on each local layer and gives the unsharded
    prefill's tokens; a train step gives the unsharded step's loss and
    grad norm."""
    import torch.distributed as dist

    from repro_torch.launch import make_host_mesh
    from repro_torch.sharding import Rules
    cfg, batch = _gemma_shaped()
    run = RunConfig(model=cfg, shape=ShapeConfig("t", S, B, "train"))
    n_local = cfg.pattern.count("attn_local") * cfg.n_groups
    started = not dist.is_initialized()
    try:
        rules = Rules(make_host_mesh(device=cuda), fsdp=True)
        params = lm.lm_init(0, cfg, torch.float32, device=cuda)
        want, _ = steps.make_prefill_step(cfg, run)(
            params, batch, lm.cache_init(cfg, B, S, torch.float32,
                                         device=cuda))
        sp = steps.place_tree(params, steps.resolve_shardings(
            rules, lm.lm_specs(cfg), params))
        cache = lm.cache_init(cfg, B, S, torch.float32, device=cuda)
        cache = steps.place_tree(cache, steps.resolve_shardings(
            rules, lm.cache_specs(cfg), cache))
        ops.reset_launch_counts()
        got, _ = steps.make_prefill_step(cfg, run, rules)(sp, batch, cache)
        torch.cuda.synchronize()
        assert ops.launch_counts()["local_attn"] == n_local
        assert torch.equal(got, want)
        state = {"params": params, "opt": optim.adamw_init(params)}
        placed = steps.place_tree(tree_map(torch.clone, state),
                                  steps.resolve_shardings(
                                      rules, steps.train_state_specs(cfg),
                                      state))
        _, m_want = steps.make_train_step(cfg, run)(state, batch)
        _, m_got = steps.make_train_step(cfg, run, rules)(placed, batch)
        assert float(m_got["loss"]) == pytest.approx(
            float(m_want["loss"]), rel=1e-5)
        assert float(m_got["grad_norm"]) == pytest.approx(
            float(m_want["grad_norm"]), rel=1e-4)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
