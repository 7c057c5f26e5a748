"""Mixture-of-Experts layer — port of ``repro.models.moe``.

``moe_apply`` with ``rules=None`` is the reference's single-device oracle
(``_local_moe_nodist``): softmax router in f32, top-k renormalized weights,
the load-balancing aux loss, every expert applied to every token and
weighted by its routing weight (no capacity, no drops), plus the shared
experts.

With ``rules`` it is the reference's ``shard_map`` dispatch
(``_local_moe`` on each rank's local tensors, ``sharding.local``; on a
mesh of size-1 axes on the plain tensors, with no collective): tokens
sharded over the batch axes that divide them and replicated over
"model"; expert weights sharded over "model" by expert
(``partition="ep"``) or by expert-FFN width (``"tp"``), and over "data" on
d_model under FSDP.  Each rank routes its tokens, keeps the assignments
of the experts it holds, compacts them into a fixed-capacity buffer per
expert by a stable local sort (capacity ``ceil(n_loc * k * cf / E)``,
overflow dropped), runs its experts, and the partial outputs are summed
over "model".  ``drop_frac`` is the largest dropped share of the model
ranks of the first data shard, as the reference reports it.
The capacity depends on the rank's token count, so the function (not
only its layout) depends on the data axes' size, as the reference's does.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.models.modules import _normal, act_fn
from repro_torch.sharding import local as SL
from repro_torch.sharding.rules import PartitionSpec as P


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


def moe_specs(cfg):
    e = cfg.moe
    if e.partition == "ep":
        w13 = ("experts", "embed", None)
        w2 = ("experts", None, "embed")
    else:  # tp: shard expert width
        w13 = (None, "embed", "d_ff")
        w2 = (None, "d_ff", "embed")
    s = {"wg": ("embed", None), "w_gate": w13, "w_up": w13, "w_down": w2}
    if e.n_shared_experts:
        s["shared"] = {"w_gate": ("embed", "d_ff"), "w_up": ("embed", "d_ff"),
                       "w_down": ("d_ff", "embed")}
    return s


def _local_moe(x, wg, w_gate, w_up, w_down, *, cfg, model_rank: int,
               model, data, fsdp_group, act_name: str = "silu"):
    """Per-shard MoE body (the reference's ``_local_moe``).

    x: (N_loc, D) local tokens (replicated over 'model'); weights: local
    slices per ``moe_specs``; ``model`` / ``data``: the process groups of
    the model axis and of the batch axes; ``fsdp_group``: the "data" group
    when the expert weights arrive sharded on d_model, else None.
    Returns (out_local (N_loc, D) — the sum over 'model', aux_loss,
    drop_frac)."""
    e = cfg.moe
    n_loc, d = x.shape
    if fsdp_group is not None:
        # FSDP: gather the d_model shards for compute, after the cast to
        # the compute dtype (half the bytes of gathering f32)
        w_gate = SL.all_gather(w_gate.to(x.dtype), fsdp_group, 1)
        w_up = SL.all_gather(w_up.to(x.dtype), fsdp_group, 1)
        w_down = SL.all_gather(w_down.to(x.dtype), fsdp_group, 2)

    ep = e.partition == "ep"
    e_loc = w_gate.shape[0]          # local expert count (EP) or all (TP)
    k = e.top_k
    n_experts = e.n_experts
    dev = x.device

    # --- routing (replicated over model axis) ---
    logits = x.float() @ wg                                  # (N, E)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, k, dim=-1)              # (N, K)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)

    # aux load-balancing loss (global over data axes)
    me = torch.mean(probs, dim=0)                            # (E,)
    ce = torch.zeros((n_experts,), dtype=torch.float32,
                     device=dev).index_add_(
        0, top_e.reshape(-1),
        torch.full((n_loc * k,), 1.0 / (n_loc * k), dtype=torch.float32,
                   device=dev))
    if data:
        n_data = SL.group_size(data)
        me = SL.all_reduce(me / n_data, data)
        ce = SL.all_reduce(ce / n_data, data)
    aux = e.router_aux_coef * n_experts * torch.sum(me * ce)

    # --- local compaction (partition by expert id, local stable sort) ---
    flat_e = top_e.reshape(-1)                               # (N*K,)
    flat_t = torch.arange(n_loc, dtype=torch.int64,
                          device=dev).repeat_interleave(k)
    flat_w = top_w.reshape(-1)
    if ep:
        first = model_rank * e_loc
        mine = (flat_e >= first) & (flat_e < first + e_loc)
        local_e = torch.where(mine, flat_e - first, e_loc)   # e_loc = dump
    else:
        local_e = flat_e
    cap = max(1, int(math.ceil(n_loc * k * e.capacity_factor / n_experts)))

    order = torch.argsort(local_e, stable=True)
    se = local_e[order]
    st = flat_t[order]
    sw = flat_w[order]
    # each id's first position in the sorted ids (the exclusive cumsum of
    # their counts), of a static shape, which bincount's is not
    offs = torch.searchsorted(se, torch.arange(e_loc + 1, device=dev,
                                               dtype=se.dtype))
    pos = torch.arange(se.shape[0], device=dev) - offs[se]
    keep = (pos < cap) & (se < e_loc)
    n_slots = e_loc * cap
    slot = torch.where(keep, se * cap + pos, n_slots)        # n_slots = drop

    xb = x.new_zeros((n_slots + 1, d)).index_put((slot,), x[st])
    xb = xb[:n_slots].reshape(e_loc, cap, d)

    h = torch.einsum("ecd,edf->ecf", xb, w_gate.to(x.dtype))
    u = torch.einsum("ecd,edf->ecf", xb, w_up.to(x.dtype))
    y = torch.einsum("ecf,efd->ecd", act_fn(act_name)(h) * u,
                     w_down.to(x.dtype))
    y_flat = y.reshape(n_slots, d)
    gathered = y_flat[torch.clamp(slot, max=n_slots - 1)]
    # keep is in sorted order (as are st / sw / slot); se < e_loc, the
    # sorted-order ownership mask, is folded into it
    gathered = gathered * keep[:, None]

    out = torch.zeros((n_loc, d), dtype=torch.float32, device=dev) \
        .index_add(0, st, gathered.float() * sw[:, None])
    out = SL.all_reduce(out, model)

    # drop fraction telemetry (of this rank's assignments; sorted order)
    smine = se < e_loc
    dropped = torch.sum(smine & ~keep).float()
    total = torch.clamp(torch.sum(smine.float()), min=1.0)
    drop_frac = (dropped / total).detach()
    for grp in model:
        dist.all_reduce(drop_frac, op=dist.ReduceOp.MAX, group=grp)
    # the reference returns it as replicated (out spec P()) though each
    # data shard has its own: its value is the first shard's
    for grp in data:
        dist.broadcast(drop_frac, src=dist.get_global_rank(grp, 0),
                       group=grp)
    return out.to(x.dtype), aux, drop_frac


def _moe_sharded(p, xf, cfg, rules, act_name):
    """The reference's ``shard_map`` of ``_local_moe`` over the rules' mesh:
    DTensor (N, D) tokens in, DTensors (out, aux, drop_frac) out.  The
    cotangent of an output replicated over axes its spec does not name is
    divided by their size, and an input's is summed over the axes its spec
    does not name (``shard_map``'s transpose)."""
    mesh = rules.mesh
    axes = tuple(mesh.axis_names)
    dm = rules.device_mesh
    e = cfg.moe
    n = xf.shape[0]
    # decode/small batches: only shard the token dim over axes dividing it
    sz, kept = 1, []
    for a in (a for a in ("pod", "data") if a in axes):
        if n % (sz * mesh.shape[a]) == 0:
            kept.append(a)
            sz *= mesh.shape[a]
    tok = tuple(kept) if len(kept) > 1 else (kept[0] if kept else None)
    fsdp = rules.table["embed"] is not None
    fs = "data" if fsdp else None
    if e.partition == "ep":
        w13, w2 = P("model", fs, None), P("model", None, fs)
    else:
        w13, w2 = P(None, fs, "model"), P(None, "model", fs)
    tok_spec, whole = P(tok, None), P(None, None)

    def named(spec):
        return {a for entry in spec if entry is not None
                for a in ((entry,) if isinstance(entry, str) else entry)}

    def enter(t, spec):
        t = SL.to_local(t, rules.spec_placements(spec))
        return SL.psum_grad(t, SL.mesh_groups(
            dm, [a for a in axes if a not in named(spec)]))

    out, aux, drop = _local_moe(
        enter(xf, tok_spec), enter(p["wg"], whole), enter(p["w_gate"], w13),
        enter(p["w_up"], w13), enter(p["w_down"], w2), cfg=cfg,
        model_rank=dm.get_local_rank("model"),
        model=SL.mesh_groups(dm, ["model"]),
        data=SL.mesh_groups(dm, [a for a in ("pod", "data") if a in axes]),
        fsdp_group=(SL.mesh_groups(dm, ["data"]) or [None])[0]
        if fsdp else None,
        act_name=act_name)
    unnamed = [mesh.shape[a] for a in axes if a not in named(tok_spec)]
    out = SL.scale_grad(out, 1.0 / math.prod(unnamed))
    aux = SL.scale_grad(aux, 1.0 / math.prod(mesh.shape[a] for a in axes))
    rep = rules.spec_placements(P())
    return (SL.from_local(out, dm, rules.spec_placements(tok_spec),
                          tuple(xf.shape)),
            SL.from_local(aux, dm, rep, ()),
            SL.from_local(drop, dm, rep, ()))


def moe_apply(p, x, cfg, *, rules=None, act_name: str = "silu"):
    """x: (B, S, D). Returns (y, aux_loss, drop_frac)."""
    b, s, d = x.shape
    e = cfg.moe
    xf = x.reshape(b * s, d)
    if SL.on_mesh(x, rules, "moe_apply"):
        out, aux, drop = _moe_sharded(p, xf, cfg, rules, act_name)
        if tuple(out.placements) != tuple(xf.placements):
            # the tokens' split back to the rows' (it differs where the
            # rows did not divide over the batch axes but the tokens do)
            out = out.redistribute(out.device_mesh, xf.placements)
    elif rules is not None:
        # a mesh of size-1 axes: the body on the whole tensors, no
        # collectives
        out, aux, drop = _local_moe(
            xf, p["wg"], p["w_gate"], p["w_up"], p["w_down"], cfg=cfg,
            model_rank=0, model=[], data=[], fsdp_group=None,
            act_name=act_name)
    else:
        # single-device path: emulate one shard, no collectives
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
