"""Step functions of the LM scaffold — port of ``repro.train.steps``,
serving half: ``make_prefill_step`` and ``make_decode_step`` with the
shapes of their inputs and of the cache.

A step runs where its params are (``models.lm.lm_init`` puts them on the
CUDA card unless told otherwise) and writes the cache in place.  Shapes
are ``ShapeDtype(shape, dtype)`` records, the port's counterpart of
``jax.ShapeDtypeStruct``.  The training half (``make_train_step`` and its
state, specs and shardings) comes with M12b.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import lm
from repro_torch.models.modules import no_rules, tree_map


class ShapeDtype(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype


# -- serve: prefill ---------------------------------------------------------------

def make_prefill_step(cfg: ModelConfig, run: RunConfig, rules=None):
    no_rules(rules, "make_prefill_step")

    def prefill_step(params, batch, cache):
        """batch: {"tokens": (B,S)} or {"embeds": (B,S,D)}.  Returns
        (next_tok (B,) int32, the filled cache)."""
        logits, new_cache, _ = lm.forward(
            params, cfg, tokens=batch.get("tokens"),
            embeds=batch.get("embeds"), cache=cache, remat="none",
            chunk_q=run.attn_chunk_q, chunk_kv=run.attn_chunk_kv,
            logits_last_only=True, device=lm.params_device(params))
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok, new_cache
    return prefill_step


# -- serve: decode ----------------------------------------------------------------

def make_decode_step(cfg: ModelConfig, run: RunConfig, rules=None):
    no_rules(rules, "make_decode_step")

    def decode_step(params, tokens, cache, cache_pos):
        """tokens: (B,1) int32 — current token; cache_pos: int or 0-d int32
        = number of tokens so far including this one.  Returns (next_tok,
        new_cache)."""
        logits, new_cache, _ = lm.forward(
            params, cfg, tokens=tokens, cache=cache, cache_pos=cache_pos,
            remat="none", device=lm.params_device(params))
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok, new_cache
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
