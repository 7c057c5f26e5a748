"""Top-level language model: embedding -> loop over layer groups -> head —
port of ``repro.models.lm``.

One ``forward`` serves three modes:
  eval:     tokens/embeds (B,S)  -> logits (B,S,V)
  prefill:  + cache buffers      -> logits, filled cache
  decode:   (B,1) + cache + pos  -> logits (B,1,V), updated cache

The layer groups (one period of ``cfg.pattern``) are stacked on a leading
group axis of every leaf of ``params["groups"]`` (and of the cache), as
the reference's ``lax.scan`` consumes them; the port loops over that axis.
The cache is written in place and returned.  Forward only: the training
half (backward, remat, optimizer) comes with M12b.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models.modules import (_normal, embed_apply, embed_init,
                                        no_rules, norm_apply, norm_init,
                                        stack_init, tree_map)


def _generator(key, device) -> torch.Generator:
    """A seed (int) becomes a generator on ``device``; a generator must
    live there already."""
    if isinstance(key, torch.Generator):
        if key.device.type != device.type:
            raise ValueError(f"a {key.device.type} generator for a "
                             f"{device.type} init")
        return key
    return torch.Generator(device).manual_seed(int(key))


def group_init(key, cfg, dtype):
    return {f"b{i}": B.block_init(key, cfg, kind, dtype)
            for i, kind in enumerate(cfg.pattern)}


def lm_init(key, cfg, dtype=torch.bfloat16, *, device=None):
    """Random weights of ``cfg`` drawn from ``key`` (a seed or a
    ``torch.Generator``) on ``device`` (default: the CUDA card)."""
    key = _generator(key, resolve_device(device))
    params: dict[str, Any] = {
        "embed": embed_init(key, cfg.vocab_size, cfg.d_model, dtype),
        "groups": stack_init(lambda k: group_init(k, cfg, dtype), key,
                             cfg.n_groups),
        "final_norm": norm_init(key, cfg.d_model, dtype, kind=cfg.norm),
    }
    if not cfg.tie_embeddings:
        params["head"] = {"w": _normal(key, (cfg.d_model, cfg.vocab_size),
                                       dtype)}
    return params


def params_device(params) -> torch.device:
    return params["final_norm"]["scale"].device


def cache_init(cfg, batch: int, max_len: int, dtype=torch.bfloat16, *,
               device=None):
    """Stacked (G, ...) cache tree matching the group structure, on
    ``device`` (default: the CUDA card)."""
    dev = device if str(device) == "meta" else resolve_device(device)
    one = {f"b{i}": B.block_cache_init(cfg, kind, batch, max_len, dtype,
                                       device=dev)
           for i, kind in enumerate(cfg.pattern)}
    return tree_map(lambda x: x.unsqueeze(0).repeat(
        (cfg.n_groups,) + (1,) * x.dim()), one)


def _store(dst, src) -> None:
    """Write a block's new cache into its group's slice of the stacked
    cache (attention caches were written in place already)."""
    if isinstance(dst, dict):
        for k in dst:
            _store(dst[k], src[k])
    elif dst.data_ptr() != src.data_ptr():
        dst.copy_(src)


def forward(params, cfg, *, tokens=None, embeds=None, cache=None,
            cache_pos=None, positions=None, rules=None,
            remat: str = "block", chunk_q: int = 512, chunk_kv: int = 1024,
            logits_last_only: bool = False, device=None):
    """Returns (logits, new_cache, aux_loss).

    Runs on ``device`` (default: the CUDA card), where ``params`` (and the
    cache) must already be; tokens or embeds are moved there.  ``remat``
    is the reference's keyword and changes nothing in a forward pass."""
    no_rules(rules, "forward")
    del remat
    dev = resolve_device(device)
    if params_device(params).type != dev.type:
        raise ValueError(f"params on {params_device(params)}, forward on "
                         f"{dev}")
    if embeds is not None:
        x = torch.as_tensor(embeds, device=dev)
        bsz, s = x.shape[:2]
    else:
        tokens = torch.as_tensor(tokens, device=dev)
        x = embed_apply(params["embed"], tokens)
        bsz, s = tokens.shape
    x = x.to(params["final_norm"]["scale"].dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=dev)
    if positions is None:
        if cache_pos is not None and s == 1:
            positions = (cache_pos - 1) * torch.ones(
                (bsz, 1), dtype=torch.int32, device=dev)
        else:
            positions = torch.arange(s, dtype=torch.int32,
                                     device=dev)[None].expand(bsz, s)

    aux = torch.zeros((), dtype=torch.float32, device=dev)
    for g in range(cfg.n_groups):
        gparams = tree_map(lambda t: t[g], params["groups"])
        gcache = tree_map(lambda t: t[g], cache) if cache is not None \
            else None
        for i, kind in enumerate(cfg.pattern):
            c = gcache[f"b{i}"] if gcache is not None else None
            x, nc, a = B.block_apply(
                gparams[f"b{i}"], x, cfg, kind, cache=c,
                cache_pos=cache_pos, positions=positions, chunk_q=chunk_q,
                chunk_kv=chunk_kv)
            aux = aux + a
            if c is not None:
                _store(c, nc)

    x = norm_apply(params["final_norm"], x, kind=cfg.norm, eps=cfg.norm_eps)
    if logits_last_only and x.shape[1] > 1:
        x = x[:, -1:]
    if cfg.tie_embeddings:
        logits = x @ params["embed"]["table"].to(x.dtype).T
    else:
        logits = x @ params["head"]["w"].to(x.dtype)
    logits = logits.float()
    if cfg.final_logit_softcap:
        # cap * tanh(logits / cap), in place: (B, S, V) f32 logits are the
        # largest tensor of a full-sequence forward
        cap = cfg.final_logit_softcap
        logits.div_(cap).tanh_().mul_(cap)
    return logits, cache, aux


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits: (B,S,V) f32; labels: (B,S) int; mask: (B,S) or None."""
    lse = torch.logsumexp(logits, dim=-1)
    true_logit = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - true_logit
    if mask is None:
        mask = torch.ones_like(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def lm_loss(params, cfg, batch, *, rules=None, remat="block",
            chunk_q=512, chunk_kv=1024, device=None):
    """batch: dict with tokens (B,S) [or embeds] and labels (B,S); labels <0
    are masked.  Returns (loss, metrics).  A forward pass only."""
    logits, _, aux = forward(
        params, cfg, tokens=batch.get("tokens"), embeds=batch.get("embeds"),
        rules=rules, remat=remat, chunk_q=chunk_q, chunk_kv=chunk_kv,
        device=device)
    labels = torch.as_tensor(batch["labels"], device=logits.device)
    mask = labels >= 0
    ce = cross_entropy(logits, torch.clamp(labels, min=0), mask)
    loss = ce + aux
    return loss, {"loss": loss, "ce": ce, "aux": aux}
