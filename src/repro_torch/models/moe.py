"""Mixture-of-Experts layer — port of ``repro.models.moe``, single-device
path.

``moe_apply`` with ``rules=None`` is the reference's single-device oracle
(``_local_moe_nodist``): softmax router in f32, top-k renormalized weights,
the load-balancing aux loss, every expert applied to every token and
weighted by its routing weight (no capacity, no drops), plus the shared
experts.  The reference's shard_map dispatch (capacity buffers, expert or
width partitions, one psum) comes with the sharding rules (M12b-2).
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.modules import _normal, act_fn, no_rules


def moe_init(key, cfg, dtype):
    d = cfg.d_model
    e = cfg.moe
    p = {
        "wg": _normal(key, (d, e.n_experts), torch.float32),  # router in f32
        "w_gate": _normal(key, (e.n_experts, d, e.expert_d_ff), dtype),
        "w_up": _normal(key, (e.n_experts, d, e.expert_d_ff), dtype),
        "w_down": _normal(
            key, (e.n_experts, e.expert_d_ff, d), dtype,
            0.02 / math.sqrt(2 * cfg.n_layers)),
    }
    if e.n_shared_experts:
        f = e.expert_d_ff * e.n_shared_experts
        p["shared"] = {
            "w_gate": _normal(key, (d, f), dtype),
            "w_up": _normal(key, (d, f), dtype),
            "w_down": _normal(key, (f, d), dtype,
                              0.02 / math.sqrt(2 * cfg.n_layers)),
        }
    return p


def moe_apply(p, x, cfg, *, rules=None, act_name: str = "silu"):
    """x: (B, S, D). Returns (y, aux_loss, drop_frac)."""
    no_rules(rules, "moe_apply")
    b, s, d = x.shape
    e = cfg.moe
    xf = x.reshape(b * s, d)
    out, aux, drop = _local_moe_nodist(xf, p, cfg, act_name)
    y = out.reshape(b, s, d)
    if e.n_shared_experts:
        sp = p["shared"]
        h = act_fn(act_name)(xf @ sp["w_gate"].to(x.dtype))
        u = xf @ sp["w_up"].to(x.dtype)
        y = y + ((h * u) @ sp["w_down"].to(x.dtype)).reshape(b, s, d)
    return y, aux, drop


def _local_moe_nodist(xf, p, cfg, act_name):
    """Single-device oracle (no collectives) — also the smoke-test path."""
    e = cfg.moe
    n, d = xf.shape
    k = e.top_k
    logits = xf.float() @ p["wg"]
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, k, dim=-1)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    me = torch.mean(probs, dim=0)
    ce = torch.zeros((e.n_experts,), dtype=torch.float32,
                     device=xf.device).index_add_(
        0, top_e.reshape(-1),
        torch.full((n * k,), 1.0 / (n * k), dtype=torch.float32,
                   device=xf.device))
    aux = e.router_aux_coef * e.n_experts * torch.sum(me * ce)

    out = torch.zeros((n, d), dtype=torch.float32, device=xf.device)
    act = act_fn(act_name)
    for ei in range(e.n_experts):
        w = torch.where(top_e == ei, top_w, 0.0).sum(-1)         # (N,)
        h = act(xf @ p["w_gate"][ei].to(xf.dtype))
        u = xf @ p["w_up"][ei].to(xf.dtype)
        y = (h * u) @ p["w_down"][ei].to(xf.dtype)
        out = out + y.float() * w[:, None]
    return out.to(xf.dtype), aux, torch.zeros((), device=xf.device)
