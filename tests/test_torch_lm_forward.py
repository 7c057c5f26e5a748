"""Port parity for the LM's forward (``repro_torch.models.lm``): the
logits and aux loss of every one of the ten architectures' smoke variants,
and ``lm_loss``, against the reference (``repro.models.lm``) with the
reference's own f32 weights carried across (``models.convert``), within
``LOGIT_ATOL`` (``tests/_torch_lm.py``: the reference's own 2e-4)."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS as RARCHS  # noqa: E402
from repro.configs import smoke_variant as rsmoke  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro_torch.configs import ARCHS, smoke_variant  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402

from _torch_lm import (LOGIT_ATOL, MODULE_ATOL, close, embeds,  # noqa: E402
                       ref_forward, ref_lm, tokens)

ARCH_NAMES = sorted(ARCHS)


def _inputs(cfg, b, s):
    if cfg.frontend:
        x = embeds(cfg, b, s)
        return dict(embeds=jnp.asarray(x)), dict(embeds=torch.from_numpy(x))
    t = tokens(cfg, b, s)
    return dict(tokens=jnp.asarray(t)), dict(tokens=torch.from_numpy(t))


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_forward_logits_match_reference(name):
    rcfg, cfg = rsmoke(RARCHS[name]), smoke_variant(ARCHS[name])
    ref_p, port_p = ref_lm(rcfg)
    rin, tin = _inputs(cfg, 2, 32)
    want, _, raux = ref_forward(rcfg)(ref_p, rin)
    got, cache, aux = tlm.forward(port_p, cfg, device="cpu", **tin)
    assert got.shape == (2, 32, cfg.vocab_size) and got.dtype == torch.float32
    assert cache is None
    assert bool(torch.isfinite(got).all())
    close(got, want, LOGIT_ATOL)
    close(aux, raux, MODULE_ATOL)
    # logits_last_only: the last position's logits
    last, _, _ = tlm.forward(port_p, cfg, device="cpu",
                             logits_last_only=True, **tin)
    assert last.shape == (2, 1, cfg.vocab_size)
    close(last[:, 0], np.asarray(want)[:, -1], LOGIT_ATOL)


@pytest.mark.parametrize("name", ["gemma2-9b", "qwen3-moe-235b-a22b",
                                  "llava-next-34b"])
def test_lm_loss_matches_reference(name):
    rcfg, cfg = rsmoke(RARCHS[name]), smoke_variant(ARCHS[name])
    ref_p, port_p = ref_lm(rcfg, seed=1)
    rin, tin = _inputs(cfg, 2, 16)
    labels = tokens(cfg, 2, 16, seed=5)
    labels[0, :3] = -1                      # masked positions
    rloss, rm = rlm.lm_loss(ref_p, rcfg, dict(rin, labels=jnp.asarray(labels)),
                            remat="none")
    tloss, tm = tlm.lm_loss(port_p, cfg,
                            dict(tin, labels=torch.from_numpy(labels)),
                            device="cpu")
    close(tloss, rloss, LOGIT_ATOL)
    for k in ("loss", "ce", "aux"):
        close(tm[k], rm[k], LOGIT_ATOL)


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(2, 7, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, size=(2, 7)).astype(np.int32)
    mask = rng.random((2, 7)) > 0.3
    for m in (None, mask):
        want = rlm.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                 None if m is None else jnp.asarray(m))
        got = tlm.cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(labels),
                                None if m is None else torch.from_numpy(m))
        close(got, want, MODULE_ATOL)
