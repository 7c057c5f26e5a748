"""Port parity for the LM's serving path: prefill into a cache then
decode step by step, for the reference's ``test_prefill_decode_matches_full``
families (local, MoE, xLSTM, hybrid and global caches), against the
reference on the same seeded tokens and the reference's own f32 weights,
within ``LOGIT_ATOL`` (``tests/_torch_lm.py``).  The serve steps, the ring
cache and the conversions are in ``test_torch_lm_steps.py``."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS as RARCHS  # noqa: E402
from repro.configs import smoke_variant as rsmoke  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro_torch.configs import ARCHS, smoke_variant  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402

from _torch_lm import (LOGIT_ATOL, close, np_tree, ref_forward,  # noqa: E402
                       ref_lm, tokens)

FAMILIES = ["gemma2-9b", "mixtral-8x22b", "xlstm-350m", "recurrentgemma-9b",
            "qwen3-moe-235b-a22b"]


def _cfgs(name):
    return rsmoke(RARCHS[name]), smoke_variant(ARCHS[name])


@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_decode_matches_reference(name):
    """Prefill 16 tokens into a 32-token cache, then decode the other 16
    one at a time: each step's logits equal the reference's same step and
    the port's own full forward (the cache semantics)."""
    rcfg, cfg = _cfgs(name)
    ref_p, port_p = ref_lm(rcfg)
    rfwd = ref_forward(rcfg)
    b, s, p = 2, 32, 16
    toks = tokens(cfg, b, s, seed=2)
    full, _, _ = tlm.forward(port_p, cfg, tokens=torch.from_numpy(toks),
                             device="cpu")
    rcache = rlm.cache_init(rcfg, b, s, jnp.float32)
    cache = tlm.cache_init(cfg, b, s, torch.float32, device="cpu")
    rpre, rcache, _ = rfwd(ref_p, {"tokens": jnp.asarray(toks[:, :p])},
                           rcache)
    pre, cache, _ = tlm.forward(port_p, cfg, tokens=torch.from_numpy(
        toks[:, :p]), cache=cache, device="cpu")
    close(pre, rpre, LOGIT_ATOL)
    close(pre, full[:, :p], LOGIT_ATOL)
    for t in range(p, s):
        rstep, rcache, _ = rfwd(ref_p, {"tokens": jnp.asarray(
            toks[:, t:t + 1])}, rcache, jnp.int32(t + 1))
        pos = t + 1 if t % 2 else torch.tensor(t + 1, dtype=torch.int32)
        step, cache, _ = tlm.forward(
            port_p, cfg, tokens=torch.from_numpy(toks[:, t:t + 1]),
            cache=cache, cache_pos=pos, device="cpu")
        close(step[:, 0], np.asarray(rstep)[:, 0], LOGIT_ATOL)
        close(step[:, 0], full[:, t], LOGIT_ATOL)
    # the caches agree leaf for leaf at the end
    rcache = np_tree(rcache)
    for blk, leaves in cache.items():
        for leaf, got in leaves.items():
            close(got, rcache[blk][leaf], LOGIT_ATOL)
