"""Shared helpers for the LM scaffold's parity tests
(``tests/test_torch_lm_*.py``): the reference's weights and caches carried
into the port with ``repro_torch.models.convert``, seeded numpy inputs,
and the stated tolerances."""
from __future__ import annotations

import numpy as np

# f32 parity at smoke sizes: module outputs (O(1) values) and the LM's
# logits / losses.  The reference's own prefill/decode test holds its two
# paths to atol 2e-4; the port is held to the same against the reference.
MODULE_ATOL = 2e-5
MODULE_RTOL = 1e-5
LOGIT_ATOL = 2e-4


def np_tree(tree):
    """A reference (JAX) tree with numpy leaves."""
    import jax
    return jax.tree.map(np.asarray, tree)


def ref_lm(cfg, seed=0):
    """(reference params, the same params as the port's, on the CPU) in
    f32."""
    import jax
    import jax.numpy as jnp
    from repro.models import lm as rlm
    from repro_torch.models.convert import from_reference_params
    ref = rlm.lm_init(jax.random.PRNGKey(seed), cfg, jnp.float32)
    return ref, from_reference_params(np_tree(ref), cfg, device="cpu")


def tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def embeds(cfg, b, s, seed=0):
    return np.random.default_rng(seed).normal(
        size=(b, s, cfg.d_model)).astype(np.float32)


def close(got, want, atol, rtol=0.0):
    got = got.detach().cpu().numpy() if hasattr(got, "detach") else \
        np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def ref_forward(rcfg, **static):
    """The reference's ``lm.forward`` for ``rcfg``, jitted (one compile per
    input shape instead of the op-by-op dispatch of every layer):
    ``fn(params, inputs, cache=None, cache_pos=None)`` with ``inputs`` a
    dict of ``tokens`` or ``embeds``."""
    import jax
    from repro.models import lm as rlm

    @jax.jit
    def fn(params, inputs, cache=None, cache_pos=None):
        return rlm.forward(params, rcfg, cache=cache, cache_pos=cache_pos,
                           remat="none", **inputs, **static)
    return fn
