"""Step functions of the LM scaffold — port of ``repro.train.steps``:
the train state and ``make_train_step``, ``make_prefill_step`` and
``make_decode_step``, with the shapes of their inputs and of the cache.

A step runs where its params are (``models.lm.lm_init`` puts them on the
CUDA card unless told otherwise).  The train step differentiates
``models.lm.lm_loss`` with PyTorch's autograd and updates the state in
place (``train.optim.adamw_update``); the serve steps write the cache in
place.  Shapes are ``ShapeDtype(shape, dtype)`` records, the port's
counterpart of ``jax.ShapeDtypeStruct``.

Sharded: ``train_state_specs`` / ``lm.cache_specs`` give the logical
specs, ``resolve_shardings`` resolves them against the shapes on the
rules' mesh, and ``place_tree`` lays a tree out by them (the reference's
``jax.device_put`` of each leaf).  The steps built with ``rules`` take
that layout and whole batches.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import lm
from repro_torch.models.modules import tree_leaves, tree_map
from repro_torch.sharding import local as SL
from repro_torch.sharding.rules import tree_shardings
from repro_torch.train import optim


class ShapeDtype(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype


# -- state -----------------------------------------------------------------------

def train_state_init(key, cfg: ModelConfig, dtype=torch.bfloat16, *,
                     device=None):
    """``{"params", "opt": {"m", "v", "step"}}``: ``lm_init``'s params
    drawn from ``key`` (a seed or a ``torch.Generator``) and zero AdamW
    state, on ``device`` (default: the CUDA card)."""
    params = lm.lm_init(key, cfg, dtype, device=device)
    return {"params": params, "opt": optim.adamw_init(params)}


def train_state_specs(cfg: ModelConfig):
    ps = lm.lm_specs(cfg)
    return {"params": ps, "opt": optim.adamw_specs(ps)}


# -- logical->sharding resolution ---------------------------------------------------

def resolve_shardings(rules, spec_tree, shape_tree):
    """spec_tree of logical tuples + a tree of tensors (or ``ShapeDtype``
    records) -> ``sharding.NamedSharding``s, one per leaf."""
    return tree_shardings(rules, spec_tree, shape_tree)


def place_tree(tree, shardings):
    """Every leaf of ``tree`` (whole on every rank) as a DTensor laid out
    by its ``NamedSharding``: each rank keeps its own shards, nothing is
    communicated (the reference's ``jax.device_put`` per leaf).  On a mesh
    of size-1 axes a leaf stays the plain tensor it is."""
    from torch.distributed.tensor import Shard, distribute_tensor
    if isinstance(tree, dict):
        return {k: place_tree(tree[k], shardings[k]) for k in tree}
    if SL.is_dtensor(tree):
        tree = tree.full_tensor()
    if not shardings.dtensors:
        return tree
    mesh, pl = shardings.device_mesh, shardings.placements
    if all(mesh.size(i) == 1 for i, p in enumerate(pl)
           if isinstance(p, Shard)):
        # every rank's shard is the whole leaf: wrap it, no copy
        return SL.from_local(tree, mesh, pl, tuple(tree.shape))
    return distribute_tensor(tree, mesh, pl, src_data_rank=None)


# -- train -------------------------------------------------------------------------

def make_train_step(cfg: ModelConfig, run: RunConfig, rules=None,
                    oc: Optional[optim.OptConfig] = None):
    """``train_step(state, batch) -> (state, metrics)``, the reference's
    step: the loss's gradient over every param leaf (autograd, with
    ``run.remat`` and the attention chunks of ``run``), summed in f32 over
    ``run.microbatch`` micro-batches and divided by their count where it
    is above 1 (the metrics averaged), then ``adamw_update``.

    The state is updated in place: the returned state holds the tensors
    it was given.  A caller that needs the state from before a step
    clones it first.  ``batch`` holds ``tokens`` (or ``embeds``) and
    ``labels``, numpy arrays or tensors; they go to the params' device.

    With ``rules`` the state is laid out by ``train_state_specs``
    (``place_tree``), every rank passes the whole batch, and each
    gradient is brought to its param's placements (the f32 micro-batch
    sums take them too); the metrics are whole on every rank."""
    oc = oc or optim.OptConfig()

    def loss_and_grads(params, leaves, batch):
        loss, metrics = lm.lm_loss(
            params, cfg, batch, rules=rules, remat=run.remat,
            chunk_q=run.attn_chunk_q, chunk_kv=run.attn_chunk_kv,
            device=lm.params_device(params))
        # a leaf the loss does not read (a frontend arch's embedding
        # table) gets zeros, as jax.grad gives it
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        if rules is not None and rules.dtensors:
            # one leaf at a time: each old gradient is freed as its
            # redistributed one is made
            grads = list(grads)
            for i, p in enumerate(leaves):
                if tuple(grads[i].placements) != tuple(p.placements):
                    grads[i] = grads[i].redistribute(p.device_mesh,
                                                     p.placements)
        return grads, {k: v.detach() for k, v in metrics.items()}

    def train_step(state, batch):
        params = state["params"]
        dev = lm.params_device(params)
        batch = {k: SL.as_device(v, dev) for k, v in batch.items()}
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            if run.microbatch and run.microbatch > 1:
                nmb = run.microbatch
                b = batch["tokens" if "tokens" in batch else "embeds"] \
                    .shape[0]
                if b % nmb:
                    raise ValueError(f"batch {b} is not a multiple of "
                                     f"microbatch {nmb}")
                acc = [torch.zeros_like(p, dtype=torch.float32)
                       for p in leaves]
                per_mb = []
                for i in range(nmb):
                    mbatch = {k: v[i * (b // nmb):(i + 1) * (b // nmb)]
                              for k, v in batch.items()}
                    grads, metrics = loss_and_grads(params, leaves, mbatch)
                    for a, g in zip(acc, grads):
                        a.add_(g)
                    del grads
                    per_mb.append(metrics)
                grads = [a.div_(nmb) for a in acc]
                metrics = {k: torch.stack([m[k] for m in per_mb]).mean()
                           for k in per_mb[0]}
            else:
                grads, metrics = loss_and_grads(params, leaves, batch)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        it = iter(grads)
        grad_tree = tree_map(lambda _: next(it), params)
        del grads
        _, _, om = optim.adamw_update(grad_tree, state["opt"], params, oc)
        return state, dict(metrics, **om)

    return train_step


def train_batch_spec(cfg: ModelConfig, run: RunConfig):
    """Logical sharding spec tree of a train batch (pure data)."""
    if cfg.frontend:
        return {"embeds": ("batch", None, None), "labels": ("batch", None)}
    return {"tokens": ("batch", None), "labels": ("batch", None)}


def train_batch_shapes(cfg: ModelConfig, run: RunConfig):
    b, s = run.shape.global_batch, run.shape.seq_len
    if cfg.frontend:
        return {"embeds": ShapeDtype((b, s, cfg.d_model), torch.bfloat16),
                "labels": ShapeDtype((b, s), torch.int32)}
    return {"tokens": ShapeDtype((b, s), torch.int32),
            "labels": ShapeDtype((b, s), torch.int32)}


# -- serve: prefill ---------------------------------------------------------------

def _next_token(logits):
    """Greedy next token of each row, whole on every rank."""
    last = logits[:, -1]
    if SL.is_dtensor(last):
        last = last.full_tensor()
    return torch.argmax(last, dim=-1).to(torch.int32)


def make_prefill_step(cfg: ModelConfig, run: RunConfig, rules=None):
    """``prefill_step(params, batch, cache)``; with ``rules`` the params
    and cache are laid out by ``lm_specs`` / ``cache_specs``
    (``place_tree``) and the batch is whole on every rank."""
    def prefill_step(params, batch, cache):
        """batch: {"tokens": (B,S)} or {"embeds": (B,S,D)}.  Returns
        (next_tok (B,) int32, the filled cache)."""
        logits, new_cache, _ = lm.forward(
            params, cfg, tokens=batch.get("tokens"),
            embeds=batch.get("embeds"), cache=cache, rules=rules,
            remat="none", chunk_q=run.attn_chunk_q,
            chunk_kv=run.attn_chunk_kv, logits_last_only=True,
            device=lm.params_device(params))
        return _next_token(logits), new_cache
    return prefill_step


# -- serve: decode ----------------------------------------------------------------

def make_decode_step(cfg: ModelConfig, run: RunConfig, rules=None):
    """``decode_step(params, tokens, cache, cache_pos)``, laid out as
    ``make_prefill_step``'s."""
    def decode_step(params, tokens, cache, cache_pos):
        """tokens: (B,1) int32 — current token; cache_pos: int or 0-d int32
        = number of tokens so far including this one.  Returns (next_tok,
        new_cache)."""
        logits, new_cache, _ = lm.forward(
            params, cfg, tokens=tokens, cache=cache, cache_pos=cache_pos,
            rules=rules, remat="none", device=lm.params_device(params))
        return _next_token(logits), new_cache
    return decode_step


def serve_batch_shapes(cfg: ModelConfig, run: RunConfig, *, decode: bool):
    b, s = run.shape.global_batch, run.shape.seq_len
    if decode:
        return {"tokens": ShapeDtype((b, 1), torch.int32)}
    if cfg.frontend:
        return {"embeds": ShapeDtype((b, s, cfg.d_model), torch.bfloat16)}
    return {"tokens": ShapeDtype((b, s), torch.int32)}


def serve_batch_spec(cfg: ModelConfig, *, decode: bool):
    """Logical sharding spec tree of a serve batch."""
    if decode:
        return {"tokens": ("batch", None)}
    if cfg.frontend:
        return {"embeds": ("batch", None, None)}
    return {"tokens": ("batch", None)}


def cache_shapes(cfg: ModelConfig, run: RunConfig, dtype=torch.bfloat16):
    """``ShapeDtype`` tree of the cache (nothing allocated: built on the
    meta device)."""
    meta = lm.cache_init(cfg, run.shape.global_batch, run.shape.seq_len,
                         dtype, device="meta")
    return tree_map(lambda x: ShapeDtype(tuple(x.shape), x.dtype), meta)
