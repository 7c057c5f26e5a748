"""Block composition: (sequence mixer) + (channel mixer) with pre/post
norms — port of ``repro.models.blocks``.

A *group* is one period of ``cfg.pattern`` (e.g. gemma2: (local, global);
recurrentgemma: (rglru, rglru, attn_local)); the LM loops over stacked
groups.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import recurrent as rec
from repro_torch.models.modules import (act_fn, dense_apply, dense_init,
                                        dense_specs, norm_apply, norm_init,
                                        norm_specs)
from repro_torch.sharding import local as SL

ATTN_KINDS = ("attn_global", "attn_local")


# -- dense MLP -----------------------------------------------------------------

def mlp_init(key, cfg, dtype):
    d, f = cfg.d_model, cfg.d_ff
    down_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    if cfg.mlp in ("swiglu", "geglu"):
        return {"w_gate": dense_init(key, d, f, dtype),
                "w_up": dense_init(key, d, f, dtype),
                "w_down": dense_init(key, f, d, dtype, scale=down_scale)}
    return {"w_up": dense_init(key, d, f, dtype),
            "w_down": dense_init(key, f, d, dtype, scale=down_scale)}


def mlp_specs(cfg):
    if cfg.mlp in ("swiglu", "geglu"):
        return {"w_gate": dense_specs("embed", "d_ff"),
                "w_up": dense_specs("embed", "d_ff"),
                "w_down": dense_specs("d_ff", "embed")}
    return {"w_up": dense_specs("embed", "d_ff"),
            "w_down": dense_specs("d_ff", "embed")}


def mlp_apply(p, x, cfg, *, rules=None):
    act = act_fn("silu" if cfg.mlp == "swiglu" else "gelu")
    if cfg.mlp in ("swiglu", "geglu"):
        h = act(dense_apply(p["w_gate"], x)) * dense_apply(p["w_up"], x)
    else:
        h = act(dense_apply(p["w_up"], x))
    if rules is not None:
        h = rules.constrain(h, ("batch", None, "d_ff"))
    return dense_apply(p["w_down"], h)


# -- one block -------------------------------------------------------------------

_MIXER_INIT = {
    "attn_global": attn.attn_init,
    "attn_local": attn.attn_init,
    "mlstm": rec.mlstm_init,
    "slstm": rec.slstm_init,
    "rglru": rec.rglru_init,
}

_MIXER_SPECS = {
    "attn_global": attn.attn_specs,
    "attn_local": attn.attn_specs,
    "mlstm": rec.mlstm_specs,
    "slstm": rec.slstm_specs,
    "rglru": rec.rglru_specs,
}


def block_has_mlp(cfg, kind: str) -> bool:
    # xLSTM blocks carry their own projections; d_ff == 0 disables the MLP.
    if cfg.d_ff == 0 and cfg.moe is None:
        return False
    return True


def block_init(key, cfg, kind: str, dtype):
    p: dict[str, Any] = {
        "norm1": norm_init(key, cfg.d_model, dtype, kind=cfg.norm),
        "mixer": _MIXER_INIT[kind](key, cfg, dtype),
    }
    if cfg.post_block_norm:
        p["norm1_post"] = norm_init(key, cfg.d_model, dtype, kind=cfg.norm)
    if block_has_mlp(cfg, kind):
        if not cfg.parallel_block:
            p["norm2"] = norm_init(key, cfg.d_model, dtype, kind=cfg.norm)
        if cfg.moe is not None:
            p["mlp"] = moe_mod.moe_init(key, cfg, dtype)
        else:
            p["mlp"] = mlp_init(key, cfg, dtype)
        if cfg.post_block_norm:
            p["norm2_post"] = norm_init(key, cfg.d_model, dtype,
                                        kind=cfg.norm)
    return p


def block_specs(cfg, kind: str):
    s: dict[str, Any] = {"norm1": norm_specs(cfg.norm),
                         "mixer": _MIXER_SPECS[kind](cfg)}
    if cfg.post_block_norm:
        s["norm1_post"] = norm_specs(cfg.norm)
    if block_has_mlp(cfg, kind):
        if not cfg.parallel_block:
            s["norm2"] = norm_specs(cfg.norm)
        s["mlp"] = moe_mod.moe_specs(cfg) if cfg.moe is not None \
            else mlp_specs(cfg)
        if cfg.post_block_norm:
            s["norm2_post"] = norm_specs(cfg.norm)
    return s


def block_cache_init(cfg, kind: str, batch: int, max_len: int,
                     dtype=torch.bfloat16, *, device=None):
    if kind in ATTN_KINDS:
        return attn.make_attn_cache(cfg, batch, max_len, dtype,
                                    local=(kind == "attn_local"),
                                    device=device)
    if kind == "mlstm":
        return rec.mlstm_state_init(cfg, batch, device=device)
    if kind == "slstm":
        return rec.slstm_state_init(cfg, batch, device=device)
    if kind == "rglru":
        return rec.rglru_state_init(cfg, batch, device=device)
    raise ValueError(kind)


def block_cache_specs(kind: str):
    if kind in ATTN_KINDS:
        return attn.attn_cache_specs()
    if kind == "mlstm":
        return rec.mlstm_state_specs()
    if kind == "slstm":
        return rec.slstm_state_specs()
    if kind == "rglru":
        return rec.rglru_state_specs()
    raise ValueError(kind)


def block_apply(p, x, cfg, kind: str, *, rules=None, cache=None,
                cache_pos=None, positions=None, chunk_q=512, chunk_kv=1024):
    """Returns (x_out, new_cache, aux_loss)."""
    aux = SL.replicated(
        torch.zeros((), dtype=torch.float32, device=x.device), x)
    h = norm_apply(p["norm1"], x, kind=cfg.norm, eps=cfg.norm_eps)

    if kind in ATTN_KINDS:
        mix, new_cache = attn.attn_apply(
            p["mixer"], h, cfg, rules=rules, local=(kind == "attn_local"),
            positions=positions, cache=cache, cache_pos=cache_pos,
            chunk_q=chunk_q, chunk_kv=chunk_kv)
    elif kind == "mlstm":
        mix, new_cache = rec.mlstm_apply(p["mixer"], h, cfg, state=cache,
                                         rules=rules)
    elif kind == "slstm":
        mix, new_cache = rec.slstm_apply(p["mixer"], h, cfg, state=cache,
                                         rules=rules)
    elif kind == "rglru":
        mix, new_cache = rec.rglru_apply(p["mixer"], h, cfg, state=cache,
                                         rules=rules)
    else:
        raise ValueError(kind)
    if rules is not None:
        # the mixer's output projection leaves partial sums over the model
        # axis: reduce them here, as the reference's XLA does after the
        # projection (left to DTensor, the partial sums would ride through
        # the norm into the MLP, whose weights it then gathers whole)
        mix = rules.constrain(mix, ("batch", "residual_seq", None))

    if cfg.post_block_norm:
        mix = norm_apply(p["norm1_post"], mix, kind=cfg.norm, eps=cfg.norm_eps)

    if cfg.parallel_block and block_has_mlp(cfg, kind):
        # shared-norm parallel attn+mlp (gptj/stablelm style)
        if cfg.moe is not None:
            mo, aux, _ = moe_mod.moe_apply(p["mlp"], h, cfg, rules=rules)
        else:
            mo = mlp_apply(p["mlp"], h, cfg, rules=rules)
        x = x + mix + mo
        if rules is not None:
            x = rules.constrain(x, ("batch", "residual_seq", None))
        return x, new_cache, aux

    x = x + mix
    if block_has_mlp(cfg, kind):
        h2 = norm_apply(p["norm2"], x, kind=cfg.norm, eps=cfg.norm_eps)
        if cfg.moe is not None:
            mo, aux, _ = moe_mod.moe_apply(p["mlp"], h2, cfg, rules=rules)
        else:
            mo = mlp_apply(p["mlp"], h2, cfg, rules=rules)
        if rules is not None:
            mo = rules.constrain(mo, ("batch", "residual_seq", None))
        if cfg.post_block_norm:
            mo = norm_apply(p["norm2_post"], mo, kind=cfg.norm,
                            eps=cfg.norm_eps)
        x = x + mo
    if rules is not None:
        x = rules.constrain(x, ("batch", "residual_seq", None))
    return x, new_cache, aux
