"""Top-level language model: embedding -> loop over layer groups -> head —
port of ``repro.models.lm``.

One ``forward`` serves three modes:
  eval:     tokens/embeds (B,S)  -> logits (B,S,V)
  prefill:  + cache buffers      -> logits, filled cache
  decode:   (B,1) + cache + pos  -> logits (B,1,V), updated cache

The layer groups (one period of ``cfg.pattern``) are stacked on a leading
group axis of every leaf of ``params["groups"]`` (and of the cache), as
the reference's ``lax.scan`` consumes them; the port loops over that axis.
The cache is written in place and returned.  PyTorch's autograd
differentiates ``forward`` and ``lm_loss``; ``remat`` checkpoints the
layer groups (``torch.utils.checkpoint``) as the reference's
``jax.checkpoint`` does.

With ``rules`` the params (and the cache) are DTensors laid out by
``lm_specs`` (``cache_specs``) on the rules' mesh
(``train.steps.place_tree``); the tokens, embeds and labels are given
whole on every rank and each rank keeps its rows.  The logits come back
as a DTensor.  On a mesh of size-1 axes the tensors stay plain, and the
rules change only what the reference's do there: the one-hot embedding
and the MoE's capacity dispatch.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models.modules import (_normal, embed_apply, embed_init,
                                        embed_onehot_apply, embed_specs,
                                        matmul, norm_apply, norm_init,
                                        norm_specs, prepend_layer_axis,
                                        softcap, stack_init, tree_leaves,
                                        tree_map)
from repro_torch.sharding import local as SL


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


def group_specs(cfg):
    return {f"b{i}": B.block_specs(cfg, kind)
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


def lm_specs(cfg):
    s: dict[str, Any] = {
        "embed": embed_specs(),
        "groups": prepend_layer_axis(group_specs(cfg)),
        "final_norm": norm_specs(cfg.norm),
    }
    if not cfg.tie_embeddings:
        s["head"] = {"w": (None, "vocab")}
    return s


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


def cache_specs(cfg):
    s = {f"b{i}": B.block_cache_specs(kind)
         for i, kind in enumerate(cfg.pattern)}
    return prepend_layer_axis(s)


def _store(dst, src) -> None:
    """Write a block's new cache into its group's slice of the stacked
    cache (attention caches were written in place already)."""
    if isinstance(dst, dict):
        for k in dst:
            _store(dst[k], src[k])
    elif dst is src:
        return
    elif SL.is_dtensor(dst):
        dst.to_local().copy_(SL.to_local(src, dst.placements))
    elif dst.data_ptr() != src.data_ptr():
        dst.copy_(src)


def _remat(fn):
    """``fn`` checkpointed: its activations are recomputed in the backward
    instead of kept (the forward draws nothing random)."""
    return functools.partial(checkpoint, fn, use_reentrant=False,
                             preserve_rng_state=False)


def forward(params, cfg, *, tokens=None, embeds=None, cache=None,
            cache_pos=None, positions=None, rules=None,
            remat: str = "block", chunk_q: int = 512, chunk_kv: int = 1024,
            logits_last_only: bool = False, device=None):
    """Returns (logits, new_cache, aux_loss).

    Runs on ``device`` (default: the CUDA card), where ``params`` (and the
    cache) must already be; tokens or embeds are moved there.

    ``remat`` acts where autograd records (grad mode on, and the params
    or the inputs requiring grad): with ``"block"`` or ``"full"``
    each layer group is checkpointed, and with a pattern period above 1
    each block inside it too (the reference's nested remat: the group's
    backward would otherwise keep every block's intermediates).  The
    reference's ``"block"`` saves the products of activations with
    weights (``dots_with_no_batch_dims_saveable``) where ``"full"`` saves
    nothing; the port recomputes them under both, which gives the same
    numbers for less memory.  ``"none"`` keeps every activation.

    ``rules``: the sharded forward (module docstring); a multi-token
    input is embedded as one-hot @ table (``embed_onehot_apply``), as the
    reference's is."""
    dev = resolve_device(device)
    if params_device(params).type != dev.type:
        raise ValueError(f"params on {params_device(params)}, forward on "
                         f"{dev}")
    if embeds is not None:
        x = SL.as_device(embeds, dev)
        if rules is not None:
            x = rules.shard_input(x, ("batch", None, None))
        bsz, s = x.shape[:2]
    else:
        tokens = SL.as_device(tokens, dev)
        bsz, s = tokens.shape
        if rules is not None:
            tokens = rules.shard_input(tokens, ("batch", None))
        if rules is not None and s > 1:
            x = embed_onehot_apply(params["embed"], tokens, rules)
        else:
            x = embed_apply(params["embed"], tokens)
    x = x.to(params["final_norm"]["scale"].dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=dev)
    if rules is not None:
        x = rules.constrain(x, ("batch", "residual_seq", None))
    if positions is None:
        if cache_pos is not None and s == 1:
            positions = (cache_pos - 1) * torch.ones(
                (bsz, 1), dtype=torch.int32, device=dev)
        else:
            positions = torch.arange(s, dtype=torch.int32,
                                     device=dev)[None].expand(bsz, s)
    # checkpoint only where autograd records: a forward whose params and
    # inputs need no gradient (serving) skips the wrappers' host work
    remat_on = remat in ("block", "full") and torch.is_grad_enabled() and (
        x.requires_grad or any(t.requires_grad
                               for t in tree_leaves(params["groups"])))

    def make_block_fn(kind):
        def f(p, x, c):
            return B.block_apply(
                p, x, cfg, kind, rules=rules, cache=c, cache_pos=cache_pos,
                positions=positions, chunk_q=chunk_q, chunk_kv=chunk_kv)
        return _remat(f) if remat_on and len(cfg.pattern) > 1 else f

    block_fns = [make_block_fn(kind) for kind in cfg.pattern]

    def group(gparams, x, gcache):
        aux = SL.replicated(torch.zeros((), dtype=torch.float32, device=dev),
                            x)
        for i, fn in enumerate(block_fns):
            c = gcache[f"b{i}"] if gcache is not None else None
            x, nc, a = fn(gparams[f"b{i}"], x, c)
            aux = aux + a
            if c is not None:
                _store(c, nc)
        return x, aux

    group_fn = _remat(group) if remat_on else group
    aux = SL.replicated(torch.zeros((), dtype=torch.float32, device=dev), x)
    for g in range(cfg.n_groups):
        gparams = tree_map(lambda t: t[g], params["groups"])
        gcache = tree_map(lambda t: t[g], cache) if cache is not None \
            else None
        x, a = group_fn(gparams, x, gcache)
        aux = aux + a

    x = norm_apply(params["final_norm"], x, kind=cfg.norm, eps=cfg.norm_eps)
    if logits_last_only and x.shape[1] > 1:
        x = x[:, -1:]
    if cfg.tie_embeddings:
        logits = matmul(x, params["embed"]["table"].to(x.dtype).T)
    else:
        logits = matmul(x, params["head"]["w"].to(x.dtype))
    if rules is not None:
        logits = rules.constrain(logits, ("batch", None, "vocab"))
    logits = logits.float()
    if cfg.final_logit_softcap:
        cap = cfg.final_logit_softcap
        if logits.requires_grad:
            logits = softcap(logits, cap)
        else:
            # cap * tanh(logits / cap), in place: (B, S, V) f32 logits
            # are the largest tensor of a full-sequence forward
            logits.div_(cap).tanh_().mul_(cap)
    return logits, cache, aux


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits: (B,S,V) f32; labels: (B,S) int; mask: (B,S) or None.

    Each token's ``logsumexp - true logit`` (the reference's) as
    ``F.cross_entropy``'s log-softmax: its backward holds the saved
    log-probabilities and two tensors of their size, where a logsumexp's
    holds four (the f32 logits are 3.28 GB at a 4,096-token Phi-4-mini
    sequence)."""
    v = logits.shape[-1]
    nll = torch.nn.functional.cross_entropy(
        logits.reshape(-1, v), labels.reshape(-1).long(),
        reduction="none").reshape(labels.shape)
    if mask is None:
        mask = torch.ones_like(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def lm_loss(params, cfg, batch, *, rules=None, remat="block",
            chunk_q=512, chunk_kv=1024, device=None):
    """batch: dict with tokens (B,S) [or embeds] and labels (B,S); labels <0
    are masked.  Returns (loss, metrics); autograd differentiates the
    loss (``train.steps.make_train_step``)."""
    logits, _, aux = forward(
        params, cfg, tokens=batch.get("tokens"), embeds=batch.get("embeds"),
        rules=rules, remat=remat, chunk_q=chunk_q, chunk_kv=chunk_kv,
        device=device)
    labels = SL.as_device(batch["labels"], logits.device)
    if rules is not None:
        labels = rules.shard_input(labels, ("batch", None))
    mask = labels >= 0
    ce = cross_entropy(logits, torch.clamp(labels, min=0), mask)
    if SL.is_dtensor(ce):
        # whole scalars on every rank (differentiable gathers)
        ce, aux = ce.full_tensor(), aux.full_tensor()
    loss = ce + aux
    return loss, {"loss": loss, "ce": ce, "aux": aux}
