"""Port parity for the LM scaffold's modules (``repro_torch.models``):
dense, norms, embedding, activations, RoPE, the chunk-pair list, chunk-pair
flash attention, dense and decode attention, MoE and the recurrent mixers,
each against the reference (``repro.models``) on the same seeded numpy
inputs and the reference's own weights, in f32 at smoke sizes, within
``MODULE_ATOL`` / ``MODULE_RTOL`` (``tests/_torch_lm.py``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS as RARCHS  # noqa: E402
from repro.configs import smoke_variant as rsmoke  # noqa: E402
from repro.models import attention as RA  # noqa: E402
from repro.models import modules as RM  # noqa: E402
from repro.models import moe as RMOE  # noqa: E402
from repro.models import recurrent as RR  # noqa: E402
from repro_torch.configs import ARCHS, smoke_variant  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import modules as TM  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.models import recurrent as TR  # noqa: E402
from repro_torch.models.modules import tree_map  # noqa: E402
from repro_torch.sharding import local as SL  # noqa: E402

from _torch_lm import MODULE_ATOL, MODULE_RTOL, close, np_tree  # noqa: E402

KEY = jax.random.PRNGKey(3)


def _cfgs(name):
    """(reference smoke config, port smoke config) of one arch."""
    return rsmoke(RARCHS[name]), smoke_variant(ARCHS[name])


def _t(tree):
    """numpy leaves -> CPU tensors."""
    return tree_map(lambda x: torch.from_numpy(np.array(x)), tree) \
        if isinstance(tree, dict) else torch.from_numpy(np.array(tree))


def _near(got, want):
    close(got, want, MODULE_ATOL, MODULE_RTOL)


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def test_configs_equal_the_reference():
    assert sorted(ARCHS) == sorted(RARCHS)
    for name in ARCHS:
        for ours, ref in ((ARCHS[name], RARCHS[name]),
                          _cfgs(name)[::-1]):
            assert dataclasses.asdict(ours) == dataclasses.asdict(ref), name
            assert ours.param_count() == ref.param_count()
            assert ours.active_param_count() == ref.active_param_count()


def test_registry_equals_the_reference():
    from repro import configs as rc
    from repro_torch import configs as tc
    assert set(tc.LONG_CONTEXT_OK) == set(rc.LONG_CONTEXT_OK)
    assert {k: dataclasses.asdict(v) for k, v in tc.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in rc.SHAPES.items()}
    for inc in (False, True):
        assert [(a.name, s.name, skip) for a, s, skip in tc.cells(inc)] == \
            [(a.name, s.name, skip) for a, s, skip in rc.cells(inc)]
    assert tc.get_config("gemma2-9b").name == "gemma2-9b"
    with pytest.raises(KeyError, match="unknown arch"):
        tc.get_config("nope")
    from repro_torch.configs import gemma2_9b
    assert gemma2_9b.SMOKE == smoke_variant(gemma2_9b.CONFIG)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm_dense_embed_act(kind):
    rng = np.random.default_rng(0)
    x = _normal(rng, 2, 5, 16)
    p = np_tree(RM.norm_init(KEY, 16, jnp.float32, kind=kind))
    p = {k: v + _normal(rng, 16) * 0.1 for k, v in p.items()}
    _near(TM.norm_apply(_t(p), _t(x), kind=kind, eps=1e-5),
          RM.norm_apply(p, jnp.asarray(x), kind=kind, eps=1e-5))
    d = np_tree(RM.dense_init(KEY, 16, 8, jnp.float32, bias=True))
    d["b"] = _normal(rng, 8)
    _near(TM.dense_apply(_t(d), _t(x)), RM.dense_apply(d, jnp.asarray(x)))
    e = np_tree(RM.embed_init(KEY, 32, 16, jnp.float32))
    tok = rng.integers(0, 32, size=(2, 5)).astype(np.int32)
    _near(TM.embed_apply(_t(e), torch.from_numpy(tok)),
          RM.embed_apply(e, jnp.asarray(tok)))
    _near(TM.unembed_apply(_t(e), _t(x)), RM.unembed_apply(e, jnp.asarray(x)))
    for name in ("silu", "gelu", "relu"):
        _near(TM.act_fn(name)(_t(x)), RM.act_fn(name)(jnp.asarray(x)))
    for cap in (0.0, 2.0):
        _near(TM.softcap(_t(x) * 4, cap), RM.softcap(jnp.asarray(x) * 4, cap))
    assert TM.param_count(_t(d)) == RM.param_count(d)
    assert TM.param_bytes(_t(d)) == RM.param_bytes(d)


def test_rope():
    rng = np.random.default_rng(1)
    x = _normal(rng, 2, 12, 4, 16)
    pos = rng.integers(0, 5000, size=(2, 12)).astype(np.int32)
    for theta in (10_000.0, 1_000_000.0):
        _near(TA.rope_apply(_t(x), torch.from_numpy(pos), theta),
              RA.rope_apply(jnp.asarray(x), jnp.asarray(pos), theta))


@pytest.mark.parametrize("args", [
    (64, 64, 16, 32, True, 0, 0), (64, 64, 16, 16, True, 20, 0),
    (50, 70, 16, 32, True, 24, 20), (40, 40, 8, 8, False, 0, 0),
    (33, 33, 16, 16, False, 10, 0), (8192, 8192, 512, 1024, True, 4096, 0)])
def test_chunk_pairs(args):
    s_q, s_kv, cq, ckv, causal, window, off = args
    got = TA.chunk_pairs(s_q, s_kv, cq, ckv, causal=causal, window=window,
                         q_offset=off)
    want = RA.chunk_pairs(s_q, s_kv, cq, ckv, causal=causal, window=window,
                          q_offset=off)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


ATTN_CASES = {          # (B, S, T, H, KH, D, causal, window, softcap, off)
    "causal": (2, 40, 40, 4, 2, 16, True, 0, 0.0, 0),
    "windowed": (2, 48, 48, 4, 2, 16, True, 10, 0.0, 0),
    "softcapped": (1, 32, 32, 4, 4, 16, True, 0, 5.0, 0),
    "window_softcap_gqa": (2, 64, 64, 8, 2, 16, True, 12, 20.0, 0),
    "padded": (2, 37, 37, 4, 2, 16, True, 9, 0.0, 0),
    "non_causal_padded": (1, 21, 29, 2, 1, 16, False, 0, 0.0, 0),
    "q_offset": (1, 16, 48, 4, 2, 16, True, 20, 0.0, 32),
}


def _qkv(case, seed=2):
    b, s, t, h, kh, d = ATTN_CASES[case][:6]
    rng = np.random.default_rng(seed)
    return _normal(rng, b, s, h, d), _normal(rng, b, t, kh, d), \
        _normal(rng, b, t, kh, d)


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_flash_attention(case):
    causal, window, cap, off = ATTN_CASES[case][6:]
    q, k, v = _qkv(case)
    kw = dict(causal=causal, window=window, logit_softcap=cap,
              chunk_q=8, chunk_kv=16, q_offset=off)
    want = RA.flash_attention(*(jnp.asarray(x) for x in (q, k, v)), **kw)
    got = TA.flash_attention(*(_t(x) for x in (q, k, v)), **kw)
    _near(got, want)
    # the default chunks (one pair) give the same function
    kw.pop("chunk_q"), kw.pop("chunk_kv")
    _near(TA.flash_attention(*(_t(x) for x in (q, k, v)), **kw), want)


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_dense_attention(case):
    causal, window, cap, off = ATTN_CASES[case][6:]
    q, k, v = _qkv(case, seed=4)
    kw = dict(causal=causal, window=window, logit_softcap=cap, q_offset=off)
    _near(TA.dense_attention(*(_t(x) for x in (q, k, v)), **kw),
          RA.dense_attention(*(jnp.asarray(x) for x in (q, k, v)), **kw))


@pytest.mark.parametrize("window,ring,pos", [
    (0, False, 7), (0, False, 24), (5, False, 13), (8, True, 6),
    (8, True, 8), (8, True, 21)])
def test_decode_attention(window, ring, pos):
    rng = np.random.default_rng(pos)
    t = 8 if ring else 24
    q = _normal(rng, 2, 1, 4, 16)
    kc, vc = _normal(rng, 2, t, 2, 16), _normal(rng, 2, t, 2, 16)
    for cp in (pos, torch.tensor(pos, dtype=torch.int32)):
        got = TA.decode_attention(_t(q), _t(kc), _t(vc), cp, window=window,
                                  logit_softcap=30.0, ring=ring)
        _near(got, RA.decode_attention(
            jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
            jnp.int32(pos), window=window, logit_softcap=30.0, ring=ring))


def test_local_attn_route_shapes():
    """The K4 route's predicate: exactly causal, windowed, no q offset,
    S == T, S % 256 == 0 and D in (64, 128, 256); the CPU never takes it
    (the plain scan runs), whatever the shape."""
    ok = dict(causal=True, window=4096, q_offset=0)
    assert TA.local_attn_route((2, 28672, 16, 256), (2, 28672, 8, 256), **ok)
    for d in (64, 128, 256):
        assert TA.local_attn_route((1, 256, 4, d), (1, 256, 2, d), **ok)
        assert TA.local_attn_route((1, 512, 4, d), (1, 512, 4, d),
                                   causal=True, window=1)
    refused = [
        ((2, 8192, 16, 256), (2, 8192, 8, 256), dict(ok, causal=False)),
        ((2, 8192, 16, 256), (2, 8192, 8, 256), dict(ok, window=0)),
        ((2, 8192, 16, 256), (2, 8192, 8, 256), dict(ok, q_offset=256)),
        ((2, 256, 16, 256), (2, 512, 8, 256), ok),
        ((2, 300, 16, 256), (2, 300, 8, 256), ok),
        ((2, 128, 16, 256), (2, 128, 8, 256), ok),
        ((2, 8192, 16, 160), (2, 8192, 8, 160), ok),
        ((2, 8192, 16, 32), (2, 8192, 8, 32), ok),
        ((2, 1, 16, 256), (2, 1, 8, 256), ok),
    ]
    for qs, ks, kw in refused:
        assert not TA.local_attn_route(qs, ks, **kw), (qs, ks, kw)
    # on the CPU a shape the route takes runs the scan: equal to it exactly
    rng = np.random.default_rng(5)
    q, k, v = (_t(_normal(rng, 1, 256, 2, 64)) for _ in range(3))
    got = TA.flash_attention(q, k, v, window=100, logit_softcap=50.0)
    want = TA.flash_attention_scan(q, k, v, window=100, logit_softcap=50.0)
    assert torch.equal(got, want)


def test_rules_are_refused_until_m12b():
    """With rules on a mesh axis above 1 the sharded forms take DTensors
    laid out on the rules' mesh (``train.steps.place_tree``): plain
    tensors are refused.  On a mesh of size-1 axes the tensors are plain:
    attention runs as without rules, the MoE takes its capacity body."""
    from types import SimpleNamespace

    from repro_torch.sharding import Rules

    def rules(n):
        return Rules(SimpleNamespace(axis_names=("data", "model"),
                                     shape={"data": n, "model": n}))
    rng = np.random.default_rng(6)
    q = _t(_normal(rng, 1, 8, 2, 16))
    with pytest.raises(ValueError, match="DTensor"):
        TA.flash_attention(q, q, q, rules=rules(2))
    assert torch.equal(TA.flash_attention(q, q, q, rules=rules(1)),
                       TA.flash_attention(q, q, q))
    cfg = smoke_variant(ARCHS["mixtral-8x22b"])
    p = TMOE.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32)
    x = torch.zeros(1, 4, cfg.d_model)
    with pytest.raises(ValueError, match="DTensor"):
        TMOE.moe_apply(p, x, cfg, rules=rules(2))
    y, _, drop = TMOE.moe_apply(p, x, cfg, rules=rules(1))
    assert y.shape == x.shape and not SL.is_dtensor(y) and 0 <= drop < 1


@pytest.mark.parametrize("name", ["mixtral-8x22b", "qwen3-moe-235b-a22b"])
def test_moe_apply_with_aux(name):
    rcfg, cfg = _cfgs(name)
    rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(
        rcfg.moe, n_shared_experts=1))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_shared_experts=1))
    p = np_tree(RMOE.moe_init(KEY, rcfg, jnp.float32))
    x = _normal(np.random.default_rng(7), 2, 10, cfg.d_model)
    for act in ("silu", "gelu"):
        ry, raux, rdrop = RMOE.moe_apply(p, jnp.asarray(x), rcfg,
                                         act_name=act)
        ty, taux, tdrop = TMOE.moe_apply(_t(p), _t(x), cfg, act_name=act)
        _near(ty, ry)
        _near(taux, raux)
        _near(tdrop, rdrop)


def _rec_case(name, init, state_init, s, state_seed):
    """(reference cfg, port cfg, reference weights, x, an incoming state:
    the zero state, or perturbed where ``state_seed`` is set)."""
    rcfg, cfg = _cfgs(name)
    p = np_tree(init(KEY, rcfg, jnp.float32))
    rng = np.random.default_rng(state_seed)
    x = _normal(rng, 2, s, cfg.d_model)
    st = np_tree(state_init(rcfg, 2))
    if state_seed:      # a non-trivial incoming state
        st = {k: (v + _normal(rng, *v.shape) * 0.1).astype(np.float32)
              for k, v in st.items()}
    return rcfg, cfg, p, x, st


@pytest.mark.parametrize("s,chunk,seeded", [
    (20, 8, False), (16, 8, True), (1, 256, True), (40, 256, False)])
def test_mlstm(s, chunk, seeded):
    rcfg, cfg, p, x, st = _rec_case("xlstm-350m", RR.mlstm_init,
                                    RR.mlstm_state_init, s, 8 * seeded)
    if seeded:
        st["m"] = np.full_like(st["m"], -0.5)
    ry, rst = RR.mlstm_apply(p, jnp.asarray(x), rcfg, state=st, chunk=chunk)
    ty, tst = TR.mlstm_apply(_t(p), _t(x), cfg, state=_t(st), chunk=chunk)
    _near(ty, ry)
    for k in rst:
        _near(tst[k], rst[k])
    # no state given: the zero state
    _near(TR.mlstm_apply(_t(p), _t(x), cfg, chunk=chunk)[0],
          RR.mlstm_apply(p, jnp.asarray(x), rcfg, chunk=chunk)[0])


@pytest.mark.parametrize("s,seeded", [(12, False), (1, True), (9, True)])
def test_slstm(s, seeded):
    rcfg, cfg, p, x, st = _rec_case("xlstm-350m", RR.slstm_init,
                                    RR.slstm_state_init, s, 9 * seeded)
    ry, rst = RR.slstm_apply(p, jnp.asarray(x), rcfg, state=st)
    ty, tst = TR.slstm_apply(_t(p), _t(x), cfg, state=_t(st))
    _near(ty, ry)
    for k in rst:
        _near(tst[k], rst[k])


@pytest.mark.parametrize("s,seeded", [(17, False), (1, True), (32, True)])
def test_rglru(s, seeded):
    rcfg, cfg, p, x, st = _rec_case("recurrentgemma-9b", RR.rglru_init,
                                    RR.rglru_state_init, s, 10 * seeded)
    ry, rst = RR.rglru_apply(p, jnp.asarray(x), rcfg, state=st)
    ty, tst = TR.rglru_apply(_t(p), _t(x), cfg, state=_t(st))
    _near(ty, ry)
    for k in rst:
        _near(tst[k], rst[k])
    _near(TR.rglru_apply(_t(p), _t(x), cfg)[0],
          RR.rglru_apply(p, jnp.asarray(x), rcfg)[0])


def test_linear_scan_matches_the_loop():
    rng = np.random.default_rng(11)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, size=(2, 37, 5))
                         .astype(np.float32))
    b = torch.from_numpy(_normal(rng, 2, 37, 5))
    h, hs = torch.zeros(2, 5), []
    for t in range(37):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    _near(TR.linear_scan(a, b), torch.stack(hs, dim=1))


def test_port_init_draws_from_its_generator():
    """The port's own init: one seed gives one set of weights, with the
    reference's tree, shapes and dtypes."""
    from repro.models import lm as rlm
    from repro_torch.models import lm as tlm
    for name in ("gemma2-9b", "recurrentgemma-9b", "qwen3-moe-235b-a22b"):
        rcfg, cfg = _cfgs(name)
        a = tlm.lm_init(7, cfg, torch.bfloat16, device="cpu")
        b = tlm.lm_init(torch.Generator().manual_seed(7), cfg,
                        torch.bfloat16, device="cpu")
        ref = rlm.lm_init(KEY, rcfg, jnp.bfloat16)
        ra = jax.tree_util.tree_flatten_with_path(ref)[0]
        flat = {jax.tree_util.keystr(k): v for k, v in ra}

        def walk(t, u, path=""):
            if isinstance(t, dict):
                assert set(t) == set(u)
                for k in t:
                    walk(t[k], u[k], f"{path}['{k}']")
            else:
                assert torch.equal(t, u), path
                want = flat[path]
                assert tuple(t.shape) == want.shape, path
                assert str(t.dtype).split(".")[1] == str(want.dtype), path
        walk(a, b)
        assert TM.param_count(a) == RM.param_count(ref)
