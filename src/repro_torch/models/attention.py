"""Attention: RoPE, chunk-pair flash attention, decode attention — port of
``repro.models.attention``.

Prefill runs *chunk-pair flash attention*: the (q-chunk, kv-chunk) pairs
that can hold unmasked entries are enumerated statically (``chunk_pairs``:
the causal triangle, or the sliding-window band) and one loop runs over
that list with running-softmax accumulators in f32, as the reference's
``lax.scan`` does.

On the card, the sliding-window case goes through K4, the hand-written
local-attention kernel (``repro_torch.kernels.ops.local_attn``, which
replaces the reference's Pallas ``_local_attn_kernel``); see
``flash_attention`` for exactly when.  Every other call, the CPU's and
every call that carries a gradient included, runs the plain chunk-pair
scan (``flash_attention_scan``), which PyTorch's autograd differentiates.

Decode attends one query against the KV cache.  The cache buffers are
written in place: a decode or prefill call returns the tensors it was
given, updated.  The sharded forms (``rules``) come with M12b-2.
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.models.modules import dense_apply, dense_init, no_rules
from repro_torch.models.modules import softcap as _softcap

NEG_INF = -0.7 * float(np.finfo(np.float32).max)

# K4's block: a sequence it takes is a multiple of it
LOCAL_ATTN_BLOCK = 256


# -- RoPE ---------------------------------------------------------------------

def rope_apply(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D) with positions (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angle = positions[..., None].float() * freq                  # (..., S, half)
    cos = torch.cos(angle)[..., None, :]                         # (..., S, 1, half)
    sin = torch.sin(angle)[..., None, :]
    x1, x2 = torch.split(x.float(), half, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- static chunk-pair enumeration ---------------------------------------------

def chunk_pairs(s_q: int, s_kv: int, cq: int, ckv: int, *, causal: bool,
                window: int, q_offset: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Static list of (q_chunk, kv_chunk) pairs that contain unmasked work.

    q position p_q = q_offset + i_global; kv position p_k = j_global.
    Mask admits p_k <= p_q (causal) and p_k > p_q - window (if window>0).
    """
    n_q = math.ceil(s_q / cq)
    n_kv = math.ceil(s_kv / ckv)
    pi, pj = [], []
    for i in range(n_q):
        q_lo = q_offset + i * cq
        q_hi = q_offset + min((i + 1) * cq, s_q) - 1
        for j in range(n_kv):
            k_lo = j * ckv
            k_hi = min((j + 1) * ckv, s_kv) - 1
            if causal and k_lo > q_hi:
                continue
            if window and k_hi <= q_lo - window:
                continue
            pi.append(i)
            pj.append(j)
    return np.asarray(pi, np.int32), np.asarray(pj, np.int32)


# -- flash attention (train / prefill) -----------------------------------------

def local_attn_route(q_shape, k_shape, *, causal: bool, window: int,
                     q_offset: int = 0, requires_grad: bool = False) -> bool:
    """Whether ``flash_attention`` on CUDA tensors of these shapes goes
    through K4: causal, a sliding window, no query offset, as many queries
    as keys, S a multiple of K4's block and a head dim K4 is built for,
    and no operand that requires grad (K4 has no backward, as the
    reference's kernel has none: training takes the plain scan).  The CPU
    never takes the route."""
    s, d = q_shape[1], q_shape[3]
    return (bool(causal) and window > 0 and q_offset == 0
            and s == k_shape[1] and s % LOCAL_ATTN_BLOCK == 0
            and d in ops.ATTN_HEAD_DIMS and not requires_grad)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    logit_softcap: float = 0.0,
                    chunk_q: int = 512, chunk_kv: int = 1024,
                    q_offset: int = 0, rules=None) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, T, KH, D).  Returns (B, S, H, D).

    Route: on CUDA tensors, when ``local_attn_route`` holds (causal,
    ``window > 0``, ``q_offset == 0``, ``S == T``, ``S % 256 == 0``,
    ``D`` in (64, 128, 256), no operand requiring grad), the call is
    K4's: each KV head is repeated for its ``H / KH`` query heads (query
    head h reads KV head h // G, as in the scan) and the operands go to
    ``kernels.ops.local_attn`` as contiguous (B*H, S, D).  K4 keeps the
    scan's mask, 1/sqrt(D) scale and softcap, and the chunk sizes do not
    change the function.  The route is never taken on an error: a failing
    build or launch raises.  Every other call runs
    ``flash_attention_scan``."""
    no_rules(rules, "flash_attention")
    if q.device.type == "cuda" and local_attn_route(
            q.shape, k.shape, causal=causal, window=window,
            q_offset=q_offset, requires_grad=(
                q.requires_grad or k.requires_grad or v.requires_grad)):
        return _local_attn_k4(q, k, v, window, logit_softcap)
    return flash_attention_scan(q, k, v, causal=causal, window=window,
                                logit_softcap=logit_softcap, chunk_q=chunk_q,
                                chunk_kv=chunk_kv, q_offset=q_offset)


def _local_attn_k4(q, k, v, window: int, logit_softcap: float):
    b, s, h, d = q.shape
    g = h // k.shape[2]

    def heads(x):                                   # (B, S, H, D) -> (B*H, S, D)
        return x.transpose(1, 2).reshape(b * h, s, d).contiguous()

    out = ops.local_attn(heads(q), heads(k.repeat_interleave(g, dim=2)),
                         heads(v.repeat_interleave(g, dim=2)),
                         window=window, softcap=logit_softcap)
    return out.reshape(b, h, s, d).transpose(1, 2)


def _pair_step(oi, mi, li, qi, kj, vj, mask, scale: float,
               logit_softcap: float):
    """One (q-chunk, kv-chunk) pair of the scan: the running max ``mi``,
    sum ``li`` and output ``oi`` of the q-chunk's (B, KH, G*cq) rows after
    the kv-chunk's scores; ``mask`` is the pair's (cq, ckv) kept entries,
    or None where every entry is kept.  Returns the new (o, m, l)."""
    sc = torch.matmul(qi, kj.transpose(-1, -2)) * scale
    if logit_softcap:
        sc = torch.tanh(sc / logit_softcap) * logit_softcap
    if mask is not None:
        # (cq, ckv) -> the (G*cq, ckv) rows of every query head
        b, kh, rows, ckv = sc.shape
        sc = sc.view(b, kh, rows // mask.shape[0], mask.shape[0], ckv) \
            .masked_fill(~mask, NEG_INF).view(b, kh, rows, ckv)
    m_new = torch.maximum(mi, sc.amax(dim=-1))
    alpha = torch.exp(mi - m_new)
    p = torch.exp(sc - m_new[..., None])
    l_new = li * alpha + p.sum(dim=-1)
    o_new = oi * alpha[..., None] + torch.matmul(p, vj)
    return o_new, m_new, l_new


def flash_attention_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         logit_softcap: float = 0.0, chunk_q: int = 512,
                         chunk_kv: int = 1024,
                         q_offset: int = 0) -> torch.Tensor:
    """The plain chunk-pair scan (the reference's ``flash_attention``): f32
    scores and accumulators, one step per pair of ``chunk_pairs``.  A pair
    whose every (query, key) is kept skips the mask; the result is the
    same.  Where q, k or v carries a gradient, each pair step is
    checkpointed (``torch.utils.checkpoint``), as the reference's
    ``jax.checkpoint`` of its scan body: the backward recomputes a pair's
    f32 scores and probabilities instead of keeping them for every pair."""
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    cq = min(chunk_q, s)
    ckv = min(chunk_kv, t)
    scale = 1.0 / math.sqrt(d)
    s_pad = math.ceil(s / cq) * cq
    t_pad = math.ceil(t / ckv) * ckv
    if s_pad != s or t_pad != t:
        # pad to chunk multiples (masked out below via positions)
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, s_pad - s))
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, t_pad - t))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, t_pad - t))
    n_q, n_kv = s_pad // cq, t_pad // ckv
    pi, pj = chunk_pairs(s, t, cq, ckv, causal=causal, window=window,
                         q_offset=q_offset)

    # (n_q, B, KH, G*cq, D) and (n_kv, B, KH, ckv, D) f32 chunked operands
    qc = q.reshape(b, n_q, cq, kh, g, d).permute(1, 0, 3, 4, 2, 5) \
        .float().reshape(n_q, b, kh, g * cq, d)
    kc = k.reshape(b, n_kv, ckv, kh, d).permute(1, 0, 3, 2, 4).float() \
        .contiguous()
    vc = v.reshape(b, n_kv, ckv, kh, d).permute(1, 0, 3, 2, 4).float() \
        .contiguous()
    dev = q.device
    pos = torch.arange(max(s_pad, t_pad), dtype=torch.int32, device=dev)
    step = _pair_step
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        step = functools.partial(checkpoint, _pair_step, use_reentrant=False,
                                 preserve_rng_state=False)

    # the running (o, m, l) of each q-chunk
    o = [torch.zeros((b, kh, g * cq, d), dtype=torch.float32, device=dev)
         for _ in range(n_q)]
    m = [torch.full((b, kh, g * cq), NEG_INF, dtype=torch.float32,
                    device=dev) for _ in range(n_q)]
    l = [torch.zeros((b, kh, g * cq), dtype=torch.float32, device=dev)
         for _ in range(n_q)]
    for i, j in zip(pi.tolist(), pj.tolist()):
        q_lo, q_hi = q_offset + i * cq, q_offset + (i + 1) * cq - 1
        k_lo, k_hi = j * ckv, (j + 1) * ckv - 1
        mask = None
        if not ((not causal or k_hi <= q_lo)
                and (not window or k_lo > q_hi - window) and k_hi < t):
            qp = q_offset + pos[i * cq:(i + 1) * cq]
            kp = pos[j * ckv:(j + 1) * ckv]
            mask = (kp < t)[None, :]
            if causal:
                mask = mask & (kp[None, :] <= qp[:, None])
            if window:
                mask = mask & (kp[None, :] > qp[:, None] - window)
        o[i], m[i], l[i] = step(o[i], m[i], l[i], qc[i], kc[j], vc[j], mask,
                                scale, logit_softcap)
    out = torch.stack([(oi / torch.where(li == 0.0, 1.0, li)[..., None])
                       .to(q.dtype) for oi, li in zip(o, l)])
    # (n_q, B, KH, G*cq, D) -> (B, S, H, D)
    out = out.reshape(n_q, b, kh, g, cq, d).permute(1, 0, 4, 2, 3, 5) \
        .reshape(b, s_pad, h, d)
    return out[:, :s]


def dense_attention(q, k, v, *, causal=True, window=0, logit_softcap=0.0,
                    q_offset: int = 0) -> torch.Tensor:
    """Reference (materialized-scores) attention — oracle + small shapes."""
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    qg = q.reshape(b, s, kh, g, d)
    sc = torch.einsum("bskgd,btkd->bkgst", qg.float(),
                      k.float()) / math.sqrt(d)
    if logit_softcap:
        sc = _softcap(sc, logit_softcap)
    qp = q_offset + torch.arange(s, device=q.device)[:, None]
    kp = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= kp > qp - window
    sc = torch.where(mask, sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return out.reshape(b, s, h, d).to(q.dtype)


# -- decode attention ------------------------------------------------------------

def decode_attention(q, k_cache, v_cache, cache_pos, *, window: int = 0,
                     logit_softcap: float = 0.0,
                     ring: bool = False) -> torch.Tensor:
    """q: (B, 1, H, D); caches: (B, T, KH, D); cache_pos: int or 0-d int
    tensor — number of tokens generated so far *including* the current
    token (already written).

    ``ring=True``: the cache is a rotating window buffer of size T == window;
    slot j holds the most recent position p with p % T == j, so every written
    slot is in-window and the mask reduces to slot-written."""
    b, _, h, d = q.shape
    t, kh = k_cache.shape[1], k_cache.shape[2]
    g = h // kh
    qg = q.reshape(b, kh, g, d).float()

    def heads_f32(c):           # (B, T, KH, D) -> contiguous (B, KH, T, D) f32
        return c.permute(0, 2, 1, 3).to(torch.float32,
                                         memory_format=torch.contiguous_format)

    # (B, KH, G, D) @ (B, KH, D, T)
    sc = torch.matmul(qg, heads_f32(k_cache).transpose(-1, -2)) / math.sqrt(d)
    if logit_softcap:
        sc = _softcap(sc, logit_softcap)
    pos = torch.arange(t, dtype=torch.int32, device=q.device)
    mask = pos < cache_pos                  # ring: pre-wrap; post-wrap all valid
    if not ring and window:
        mask &= pos > cache_pos - 1 - window
    sc = torch.where(mask, sc, NEG_INF)
    mx = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - mx)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p / l, heads_f32(v_cache))               # (B,KH,G,D)
    return out.reshape(b, 1, h, d).to(q.dtype)


# -- full attention module ---------------------------------------------------------

def attn_init(key, cfg, dtype):
    d, h, kh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": dense_init(key, d, h * hd, dtype, bias=cfg.qkv_bias),
        "wk": dense_init(key, d, kh * hd, dtype, bias=cfg.qkv_bias),
        "wv": dense_init(key, d, kh * hd, dtype, bias=cfg.qkv_bias),
        "wo": dense_init(key, h * hd, d, dtype,
                         scale=0.02 / math.sqrt(2 * cfg.n_layers)),
    }


def _write_slot(buf: torch.Tensor, idx, x: torch.Tensor) -> None:
    """buf[:, idx] = x[:, 0] in place; ``idx`` an int or a 0-d tensor."""
    if isinstance(idx, torch.Tensor):
        buf.index_copy_(1, idx.reshape(1).long(), x.to(buf.dtype))
    else:
        buf[:, idx:idx + 1].copy_(x)


def attn_apply(p, x, cfg, *, rules=None, local: bool = False,
               positions=None, cache=None, cache_pos=None,
               chunk_q=512, chunk_kv=1024):
    """Returns (out, new_cache).  cache: dict(k,v) each (B, T, KH, D) or None.

    Modes: cache is None            -> train/prefill without cache retention
           cache given, S > 1       -> prefill writing into cache
           cache given, S == 1      -> decode (cache_pos = entries incl. current)
    The cache's buffers are written in place and returned as the new cache.
    """
    no_rules(rules, "attn_apply")
    b, s, _ = x.shape
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    window = cfg.window_size if local else 0
    q = dense_apply(p["wq"], x).reshape(b, s, h, hd)
    k = dense_apply(p["wk"], x).reshape(b, s, kh, hd)
    v = dense_apply(p["wv"], x).reshape(b, s, kh, hd)
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device)[None, :]
    if cfg.rope:
        q = rope_apply(q, positions, cfg.rope_theta)
        k = rope_apply(k, positions, cfg.rope_theta)

    new_cache = None
    if cache is not None and s == 1:
        # decode: write current kv (ring-indexed for window caches)
        kc, vc = cache["k"], cache["v"]
        t_cache = kc.shape[1]
        ring = bool(window) and t_cache == window
        idx = (cache_pos - 1) % t_cache if ring else cache_pos - 1
        _write_slot(kc, idx, k)
        _write_slot(vc, idx, v)
        out = decode_attention(q, kc, vc, cache_pos, window=window,
                               logit_softcap=cfg.attn_logit_softcap, ring=ring)
        new_cache = {"k": kc, "v": vc}
    else:
        out = flash_attention(
            q, k, v, causal=True, window=window,
            logit_softcap=cfg.attn_logit_softcap,
            chunk_q=chunk_q, chunk_kv=chunk_kv)
        if cache is not None:
            # prefill: persist kv into the cache buffer (last t_cache tokens
            # for ring/window caches; requires s % t_cache == 0 so that ring
            # slot j keeps holding positions p with p % t_cache == j)
            kc, vc = cache["k"], cache["v"]
            t_cache = kc.shape[1]
            if t_cache < s:
                if s % t_cache:
                    raise ValueError(
                        f"prefill of {s} tokens into a ring cache of "
                        f"{t_cache}: S must be a multiple of the window")
                k_w, v_w = k[:, s - t_cache:], v[:, s - t_cache:]
            else:
                k_w, v_w = k, v
            kc[:, :k_w.shape[1]].copy_(k_w)
            vc[:, :v_w.shape[1]].copy_(v_w)
            new_cache = {"k": kc, "v": vc}

    out = out.reshape(b, s, h * hd)
    out = dense_apply(p["wo"], out)
    return out, new_cache


def make_attn_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                    *, local: bool = False, device=None):
    """Cache buffers for one attention layer.  Local layers cap at window."""
    t = min(max_len, cfg.window_size) if (local and cfg.window_size) else max_len
    kh, hd = cfg.n_kv_heads, cfg.head_dim
    return {"k": torch.zeros((batch, t, kh, hd), dtype=dtype, device=device),
            "v": torch.zeros((batch, t, kh, hd), dtype=dtype, device=device)}
