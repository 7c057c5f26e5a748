"""Port parity for the LM's serve steps: the greedy tokens of
``train.steps.make_prefill_step`` / ``make_decode_step``, a prompt of whole
windows into a ring cache, a reference cache carried into the port
(``models.convert``), the serve shapes, and the card's Gemma-2-9B
configuration counted without allocating — against the reference on the
same seeded tokens and the reference's own f32 weights, within
``LOGIT_ATOL`` (``tests/_torch_lm.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS as RARCHS  # noqa: E402
from repro.configs import smoke_variant as rsmoke  # noqa: E402
from repro.configs.base import RunConfig as RRun  # noqa: E402
from repro.configs.base import ShapeConfig as RShape  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro.train import steps as rsteps  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, smoke_variant  # noqa: E402
from repro_torch.configs.base import RunConfig, ShapeConfig  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.convert import (cache_from_reference,  # noqa: E402
                                        from_reference_params)
from repro_torch.models.modules import tree_leaves  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

from _torch_lm import (LOGIT_ATOL, close, np_tree, ref_forward,  # noqa: E402
                       ref_lm, tokens)


def _cfgs(name):
    return rsmoke(RARCHS[name]), smoke_variant(ARCHS[name])


def test_ring_cache_prefill_longer_than_window():
    """A prompt of whole windows fills the ring cache of a local layer
    (S > window, S % window == 0), then decode wraps around it."""
    rcfg, cfg = _cfgs("mixtral-8x22b")             # window 8, every layer
    ref_p, port_p = ref_lm(rcfg, seed=3)
    b, s, p = 1, 40, 24
    toks = tokens(cfg, b, s, seed=4)
    full, _, _ = ref_forward(rcfg)(ref_p, {"tokens": jnp.asarray(toks)})
    cache = tlm.cache_init(cfg, b, s, torch.float32, device="cpu")
    assert cache["b0"]["k"].shape[2] == cfg.window_size
    pre, cache, _ = tlm.forward(port_p, cfg, tokens=torch.from_numpy(
        toks[:, :p]), cache=cache, device="cpu")
    close(pre, np.asarray(full)[:, :p], LOGIT_ATOL)
    for t in range(p, s):
        step, cache, _ = tlm.forward(
            port_p, cfg, tokens=torch.from_numpy(toks[:, t:t + 1]),
            cache=cache, cache_pos=t + 1, device="cpu")
        close(step[:, 0], np.asarray(full)[:, t], LOGIT_ATOL)
    with pytest.raises(ValueError, match="multiple of the window"):
        tlm.forward(port_p, cfg, tokens=torch.from_numpy(toks[:, :12]),
                    cache=tlm.cache_init(cfg, b, s, torch.float32,
                                         device="cpu"), device="cpu")


@pytest.mark.parametrize("name", ["gemma2-9b", "recurrentgemma-9b",
                                  "phi4-mini-3.8b"])
def test_serve_steps_greedy_tokens_equal_reference(name):
    """make_prefill_step then make_decode_step, greedy: the same tokens as
    the reference's steps, each step's argmax."""
    rcfg, cfg = _cfgs(name)
    ref_p, port_p = ref_lm(rcfg, seed=5)
    b, p, n, max_len = 2, 16, 8, 32
    run = RunConfig(model=cfg, shape=ShapeConfig("smoke", max_len, b,
                                                 "decode"))
    rrun = RRun(model=rcfg, shape=RShape("smoke", max_len, b, "decode"))
    prompt = tokens(cfg, b, p, seed=6)
    rpre = jax.jit(rsteps.make_prefill_step(rcfg, rrun, None))
    rdec = jax.jit(rsteps.make_decode_step(rcfg, rrun, None))
    tpre = tsteps.make_prefill_step(cfg, run)
    tdec = tsteps.make_decode_step(cfg, run)
    rtok, rcache = rpre(ref_p, {"tokens": jnp.asarray(prompt)},
                        rlm.cache_init(rcfg, b, max_len, jnp.float32))
    ttok, tcache = tpre(port_p, {"tokens": torch.from_numpy(prompt)},
                        tlm.cache_init(cfg, b, max_len, torch.float32,
                                       device="cpu"))
    rtoks, ttoks = [np.asarray(rtok)], [ttok.numpy()]
    for t in range(p, p + n):
        rtok, rcache = rdec(ref_p, rtok[:, None], rcache, jnp.int32(t + 1))
        ttok, tcache = tdec(port_p, ttok[:, None], tcache, t + 1)
        rtoks.append(np.asarray(rtok))
        ttoks.append(ttok.numpy())
    assert ttoks[0].dtype == np.int32
    np.testing.assert_array_equal(np.stack(ttoks), np.stack(rtoks))


def test_cache_from_reference_continues_the_decode():
    """A reference cache after its prefill, carried into the port, decodes
    the next tokens to the reference's logits."""
    rcfg, cfg = _cfgs("gemma2-9b")
    ref_p, port_p = ref_lm(rcfg, seed=7)
    b, s, p = 2, 24, 16
    toks = tokens(cfg, b, s, seed=8)
    rfwd = ref_forward(rcfg)
    _, rcache, _ = rfwd(ref_p, {"tokens": jnp.asarray(toks[:, :p])},
                        rlm.cache_init(rcfg, b, s, jnp.float32))
    cache = cache_from_reference(np_tree(rcache), cfg, device="cpu")
    for t in range(p, s):
        rstep, rcache, _ = rfwd(ref_p, {"tokens": jnp.asarray(
            toks[:, t:t + 1])}, rcache, jnp.int32(t + 1))
        step, cache, _ = tlm.forward(
            port_p, cfg, tokens=torch.from_numpy(toks[:, t:t + 1]),
            cache=cache, cache_pos=t + 1, device="cpu")
        close(step, rstep, LOGIT_ATOL)
    with pytest.raises(ValueError, match="groups"):
        cache_from_reference({k: {kk: vv[:1] for kk, vv in v.items()}
                              for k, v in np_tree(rcache).items()}, cfg,
                             device="cpu")


def test_from_reference_params_bf16_and_checks():
    rcfg, cfg = _cfgs("recurrentgemma-9b")
    ref = np_tree(rlm.lm_init(jax.random.PRNGKey(0), rcfg, jnp.bfloat16))
    port = from_reference_params(ref, cfg, device="cpu")
    emb = port["embed"]["table"]
    assert emb.dtype == torch.bfloat16
    assert torch.equal(emb.float(), torch.from_numpy(
        ref["embed"]["table"].astype(np.float32)))
    lam = port["groups"]["b0"]["mixer"]["lam"]
    assert lam.dtype == torch.float32
    with pytest.raises(ValueError, match="keys"):
        from_reference_params({"embed": ref["embed"]}, cfg, device="cpu")
    with pytest.raises(ValueError, match="groups"):
        from_reference_params(dict(ref, groups={"b0": ref["groups"]["b0"]}),
                              cfg, device="cpu")


@pytest.mark.parametrize("name", ["gemma2-9b", "llava-next-34b",
                                  "xlstm-350m"])
def test_serve_shapes_equal_reference(name):
    rcfg, cfg = RARCHS[name], ARCHS[name]
    for shape in ("prefill_32k", "decode_32k"):
        run = RunConfig(model=cfg, shape=SHAPES[shape])
        rrun = RRun(model=rcfg, shape=RShape(**vars(SHAPES[shape])))
        for decode in (False, True):
            got = tsteps.serve_batch_shapes(cfg, run, decode=decode)
            want = rsteps.serve_batch_shapes(rcfg, rrun, decode=decode)
            assert set(got) == set(want)
            for k in got:
                assert got[k].shape == want[k].shape
                assert str(got[k].dtype).split(".")[1] == str(want[k].dtype)
            assert tsteps.serve_batch_spec(cfg, decode=decode) == \
                rsteps.serve_batch_spec(rcfg, decode=decode)
        got = tsteps.cache_shapes(cfg, run)
        want = rsteps.cache_shapes(rcfg, rrun)
        assert set(got) == set(want)
        for blk in got:
            assert set(got[blk]) == set(want[blk])
            for leaf, s in got[blk].items():
                w = want[blk][leaf]
                assert (s.shape, str(s.dtype).split(".")[1]) == \
                    (w.shape, str(w.dtype)), (blk, leaf)


def test_gemma2_9b_cache_and_params_at_full_width():
    """The card's configuration, counted without allocating: 9.24B
    parameters, an 11.3 GB global and 1.4 GB local bf16 cache at batch 2,
    32,768 tokens."""
    cfg = ARCHS["gemma2-9b"]
    assert cfg.param_count() == 9_241_100_288
    run = RunConfig(model=cfg, shape=ShapeConfig("lm", 32_768, 2, "decode"))
    shapes = tsteps.cache_shapes(cfg, run)
    nbytes = {b: sum(int(np.prod(s.shape)) * 2 for s in tree_leaves(t))
              for b, t in shapes.items()}
    assert shapes["b1"]["k"].shape == (21, 2, 32_768, 8, 256)
    assert shapes["b0"]["k"].shape == (21, 2, 4_096, 8, 256)
    assert nbytes["b1"] == 11_274_289_152
    assert nbytes["b0"] == 1_409_286_144
