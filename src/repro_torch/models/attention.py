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
given, updated.

With ``rules`` (DTensors on the rules' mesh) the projections run under
DTensor dispatch, and attention itself runs on each rank's own rows and
KV heads (with their query heads): where the model axis splits the KV
heads evenly, each rank's share of the projections as it stands; where
it does not, the layout the reference pins for its chunk-pair scan,
uneven chunks of every rank's rows.  K4 takes a rank's local heads in
both.  On a
mesh of size-1 axes the tensors are plain and run as without rules.  A
sequence-sharded cache (``seq_shard_kv``) is written only on the rank
whose shard holds the position, and decode reduces its softmax over the
shards (distributed flash-decode).
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.models.modules import dense_apply, dense_init, dense_specs
from repro_torch.models.modules import softcap as _softcap
from repro_torch.sharding import local as SL

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
    ``flash_attention_scan``.

    ``rules``: q, k and v are DTensors laid out by them (plain tensors on
    a mesh of size-1 axes, which run as without rules), and the attention
    runs on each rank's own rows and KV heads (``_heads_local``); the
    route above is taken on a rank's local heads, whether the model axis
    splits the KV heads evenly or in uneven chunks."""
    if SL.on_mesh(q, rules, "flash_attention"):
        return _heads_local(q, k, v, rules, causal=causal, window=window,
                            logit_softcap=logit_softcap, chunk_q=chunk_q,
                            chunk_kv=chunk_kv, q_offset=q_offset)
    return _flash_local(q, k, v, causal=causal, window=window,
                        logit_softcap=logit_softcap, chunk_q=chunk_q,
                        chunk_kv=chunk_kv, q_offset=q_offset)


def _flash_local(q, k, v, *, causal, window, logit_softcap, chunk_q,
                 chunk_kv, q_offset):
    if q.device.type == "cuda" and local_attn_route(
            q.shape, k.shape, causal=causal, window=window,
            q_offset=q_offset, requires_grad=(
                q.requires_grad or k.requires_grad or v.requires_grad)):
        return _local_attn_k4(q, k, v, window, logit_softcap)
    return flash_attention_scan(q, k, v, causal=causal, window=window,
                                logit_softcap=logit_softcap, chunk_q=chunk_q,
                                chunk_kv=chunk_kv, q_offset=q_offset)


def _model_chunk(n: int, rules) -> Tuple[int, int]:
    """[lo, hi) of this rank's share of ``n`` items split over the model
    axis in DTensor's ``Shard`` chunks (ceil(n / m) each, the last ones
    shorter or empty)."""
    m = rules.axis_size(rules.table["heads"])
    if m == 1:
        return 0, n
    c = -(-n // m)
    lo = min(rules.device_mesh.get_local_rank("model") * c, n)
    return lo, min(lo + c, n)


def _rows(rules, shape):
    """Placements of a (B, ...) activation split only on its rows (the
    batch axes that divide B)."""
    return rules.placements(("batch",) + (None,) * (len(shape) - 1),
                            tuple(shape))


def _head_split(rules, shape):
    """Placements of a (B, S, n, D) activation, or of its (B, S, n * D)
    projection, split on its rows and on its heads (the model axis, where
    it divides n: a chunk of whole heads)."""
    return rules.placements(("batch", None, "heads", None)[:len(shape)],
                            tuple(shape))


def _even_heads(rules, kh: int) -> bool:
    """Whether the model axis splits ``kh`` KV heads evenly."""
    return kh % rules.axis_size(rules.table["heads"]) == 0


def _heads_local(q, k, v, rules, **kw):
    """Attention of DTensors q (B, S, H, D), k, v (B, T, KH, D) on each
    rank's own rows and KV heads with their query heads.

    Where the model axis splits the KV heads evenly, each rank takes its
    own heads' shard (nothing is gathered where q, k and v come split so)
    and the output keeps that layout.  Else (the reference's pinned case:
    uneven ``Shard`` chunks of ceil(KH / m)) each rank takes its rows with
    every head and attends with its share, its gradient there a partial
    sum over the model axis, and the output is gathered whole.  K4's
    route is open on the rank's heads in both."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    b, s, h, d = q.shape
    kh = k.shape[2]
    mesh = q.device_mesh
    if _even_heads(rules, kh):
        qp, kp = _head_split(rules, q.shape), _head_split(rules, k.shape)
        out = _flash_local(SL.to_local(q, qp), SL.to_local(k, kp),
                           SL.to_local(v, kp), **kw)
        return SL.from_local(out, mesh, qp, (b, s, h, d))
    g = h // kh
    heads = rules.spec(("heads",))[0]
    model = [mesh.mesh_dim_names.index(a) for a in
             ((heads,) if isinstance(heads, str) else heads or ())
             if rules.mesh.shape[a] > 1]
    rows = _rows(rules, q.shape)

    def on_model(pl_model):
        """``rows`` with ``pl_model`` on the mesh dims the heads split
        over."""
        return tuple(pl_model if i in model else pl
                     for i, pl in enumerate(rows))
    grad = on_model(Partial())
    ql = SL.to_local(q, rows, grad)
    kl = SL.to_local(k, _rows(rules, k.shape), grad)
    vl = SL.to_local(v, _rows(rules, v.shape), grad)
    lo, hi = _model_chunk(kh, rules)
    if hi == lo:
        # no KV head on this rank: an empty output that still reads q, k
        # and v, so that every rank's backward runs the same collectives
        out = ql[:, :, :0] + (kl[:, :, :0].sum() + vl[:, :, :0].sum())
    else:
        out = _flash_local(ql[:, :, lo * g:hi * g], kl[:, :, lo:hi],
                           vl[:, :, lo:hi], **kw)
    # every rank's heads in place, zero elsewhere, summed
    full = torch.cat([out.new_zeros(out.shape[:2] + (lo * g, d)), out,
                      out.new_zeros(out.shape[:2] + ((kh - hi) * g, d))],
                     dim=2)
    return SL.from_local(full, mesh, on_model(Partial()),
                         (b, s, h, d)).redistribute(mesh,
                                                    on_model(Replicate()))


def _merge_heads(x):
    """DTensor (B, S, H, D) -> (B, S, H * D) in the same placements (a
    split of H is a split of H * D in the same chunks)."""
    b, s, h, d = x.shape
    xl = x.to_local()
    return SL.from_local(xl.reshape(xl.shape[0], s, xl.shape[2] * d),
                         x.device_mesh, x.placements, (b, s, h * d))


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
                     logit_softcap: float = 0.0, ring: bool = False,
                     slot_offset: int = 0, groups=()) -> torch.Tensor:
    """q: (B, 1, H, D); caches: (B, T, KH, D); cache_pos: int or 0-d int
    tensor — number of tokens generated so far *including* the current
    token (already written).

    ``ring=True``: the cache is a rotating window buffer of size T == window;
    slot j holds the most recent position p with p % T == j, so every written
    slot is in-window and the mask reduces to slot-written.

    ``groups``: the caches are this rank's shard of a cache split on T
    over these process groups, starting at slot ``slot_offset``; the
    softmax's max, its sum and the output are reduced over them
    (distributed flash-decode)."""
    import torch.distributed as dist
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
    pos = slot_offset + torch.arange(t, dtype=torch.int32, device=q.device)
    mask = pos < cache_pos                  # ring: pre-wrap; post-wrap all valid
    if not ring and window:
        mask &= pos > cache_pos - 1 - window
    sc = torch.where(mask, sc, NEG_INF)
    mx = sc.amax(dim=-1, keepdim=True)
    for grp in groups:
        dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=grp)
    p = torch.exp(sc - mx)
    l = p.sum(dim=-1, keepdim=True)
    for grp in groups:
        dist.all_reduce(l, group=grp)
    out = torch.matmul(p / l, heads_f32(v_cache))               # (B,KH,G,D)
    for grp in groups:
        dist.all_reduce(out, group=grp)
    return out.reshape(b, 1, h, d).to(q.dtype)


# -- the cache ---------------------------------------------------------------------

def _cache_shard(buf):
    """(first slot, slots) of this rank's shard of DTensor cache ``buf``
    on its T dim."""
    shape, offset = SL.local_shape_and_offset(buf.shape, buf.device_mesh,
                                              buf.placements)
    return int(offset[1]), int(shape[1])


def _write_cache(buf, start, x) -> None:
    """buf[:, start:start + L] = x (B, L, KH, D) in place; ``start`` an int
    or a 0-d tensor (a decode's slot).  On a DTensor cache ``x`` is this
    rank's rows, and each rank writes the slots its shard holds, and only
    those."""
    if SL.is_dtensor(buf):
        start = int(start)
        lo, n = _cache_shard(buf)
        a, z = max(lo, start), min(lo + n, start + x.shape[1])
        if a < z:
            buf.to_local()[:, a - lo:z - lo].copy_(
                x[:, a - start:z - start])
    elif isinstance(start, torch.Tensor):
        buf.index_copy_(1, start.reshape(1).long(), x.to(buf.dtype))
    else:
        buf[:, start:start + x.shape[1]].copy_(x)


def _decode_slot(window: int, t_cache: int, cache_pos):
    """(ring, slot) of a decode's token in a cache of ``t_cache`` slots."""
    ring = bool(window) and t_cache == window
    return ring, (cache_pos - 1) % t_cache if ring else cache_pos - 1


def _prefill_start(s: int, t_cache: int) -> int:
    """The first of a prefill's ``s`` tokens its cache keeps: the last
    ``t_cache`` for a ring (window) cache, which needs s % t_cache == 0 so
    that ring slot j keeps holding positions p with p % t_cache == j."""
    if t_cache >= s:
        return 0
    if s % t_cache:
        raise ValueError(f"prefill of {s} tokens into a ring cache of "
                         f"{t_cache}: S must be a multiple of the window")
    return s - t_cache


def _decode_local(ql, kc, vc, cache_pos, **kw):
    """``decode_attention`` of this rank's rows ``ql`` against its shard of
    the DTensor caches, the softmax reduced over the ranks that split T."""
    from torch.distributed.tensor import Shard
    mesh = kc.device_mesh
    seq = [i for i, p in enumerate(kc.placements)
           if isinstance(p, Shard) and p.dim == 1 and mesh.size(i) > 1]
    return decode_attention(ql, kc.to_local(), vc.to_local(), cache_pos,
                            slot_offset=_cache_shard(kc)[0],
                            groups=[mesh.get_group(i) for i in seq], **kw)


# -- full attention module ---------------------------------------------------------

def _qkv_on_mesh(p, x, cfg, rules, positions, *, own_heads: bool):
    """q, k and v of DTensor ``x`` (B, S, D) as this rank's local
    (B_l, S, n_l, D) tensors with RoPE applied, and ``lift(t, n)``, which
    puts such a local tensor of n heads in all back on the mesh.  The rank takes its rows; with
    ``own_heads`` only its own heads (the projection's shard of the qkv
    dim, where the model axis splits the KV heads evenly), else every
    head (gathered over the model axis)."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    mesh = x.device_mesh
    split = _head_split if own_heads else _rows

    def local(w, n):
        t = SL.to_local(dense_apply(w, x), split(rules, (b, s, n, hd)))
        return t.reshape(t.shape[0], s, -1, hd)

    def lift(t, n):
        """Local (B_l, L, n_l, D) -> the (B, L, n, D) DTensor."""
        return SL.from_local(t, mesh, split(rules, (b, s, n, hd)),
                             (b, t.shape[1], n, hd))

    q, k, v = (local(p["wq"], cfg.n_heads), local(p["wk"], cfg.n_kv_heads),
               local(p["wv"], cfg.n_kv_heads))
    if cfg.rope:
        r0 = SL.local_shape_and_offset((b, s), mesh,
                                       _rows(rules, (b, s)))[1][0]
        pos = positions[r0:r0 + q.shape[0]] if positions.shape[0] == b \
            else positions
        q = rope_apply(q, pos, cfg.rope_theta)
        k = rope_apply(k, pos, cfg.rope_theta)
    return q, k, v, lift


def attn_init(key, cfg, dtype):
    d, h, kh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": dense_init(key, d, h * hd, dtype, bias=cfg.qkv_bias),
        "wk": dense_init(key, d, kh * hd, dtype, bias=cfg.qkv_bias),
        "wv": dense_init(key, d, kh * hd, dtype, bias=cfg.qkv_bias),
        "wo": dense_init(key, h * hd, d, dtype,
                         scale=0.02 / math.sqrt(2 * cfg.n_layers)),
    }


def attn_specs(cfg):
    return {
        "wq": dense_specs("embed", "qkv", bias=cfg.qkv_bias),
        "wk": dense_specs("embed", "qkv", bias=cfg.qkv_bias),
        "wv": dense_specs("embed", "qkv", bias=cfg.qkv_bias),
        "wo": dense_specs("qkv", "embed"),
    }


def attn_apply(p, x, cfg, *, rules=None, local: bool = False,
               positions=None, cache=None, cache_pos=None,
               chunk_q=512, chunk_kv=1024):
    """Returns (out, new_cache).  cache: dict(k,v) each (B, T, KH, D) or None.

    Modes: cache is None            -> train/prefill without cache retention
           cache given, S > 1       -> prefill writing into cache
           cache given, S == 1      -> decode (cache_pos = entries incl. current)
    The cache's buffers are written in place and returned as the new cache.

    With ``rules`` and DTensors (module docstring) the projections run
    under DTensor dispatch and the rest on each rank's rows: a prefill on
    its own heads where the model axis splits the KV heads evenly (every
    KV head is gathered only for the cache write), else and in decode
    with every head.
    """
    b, s, _ = x.shape
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    window = cfg.window_size if local else 0
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device)[None, :]
    decode = cache is not None and s == 1
    sharded = SL.on_mesh(x, rules, "attn_apply")
    if sharded:
        own = not decode and _even_heads(rules, kh)
        q, k, v, lift = _qkv_on_mesh(p, x, cfg, rules, positions,
                                     own_heads=own)
    else:
        q = dense_apply(p["wq"], x).reshape(b, s, h, hd)
        k = dense_apply(p["wk"], x).reshape(b, s, kh, hd)
        v = dense_apply(p["wv"], x).reshape(b, s, kh, hd)
        if cfg.rope:
            q = rope_apply(q, positions, cfg.rope_theta)
            k = rope_apply(k, positions, cfg.rope_theta)

    new_cache = None
    kw = dict(window=window, logit_softcap=cfg.attn_logit_softcap)
    if decode:
        # write the current kv (ring-indexed for window caches)
        kc, vc = cache["k"], cache["v"]
        ring, idx = _decode_slot(window, kc.shape[1], cache_pos)
        _write_cache(kc, idx, k)
        _write_cache(vc, idx, v)
        if sharded:
            kc = rules.constrain(kc, ("batch", "kv_seq", None, None))
            vc = rules.constrain(vc, ("batch", "kv_seq", None, None))
            out = lift(_decode_local(q, kc, vc, cache_pos, ring=ring, **kw),
                       h)
        else:
            out = decode_attention(q, kc, vc, cache_pos, ring=ring, **kw)
        new_cache = {"k": kc, "v": vc}
    else:
        if sharded:
            out = flash_attention(lift(q, h), lift(k, kh), lift(v, kh),
                                  causal=True, chunk_q=chunk_q,
                                  chunk_kv=chunk_kv, rules=rules, **kw)
        else:
            out = flash_attention(q, k, v, causal=True, chunk_q=chunk_q,
                                  chunk_kv=chunk_kv, **kw)
        if cache is not None:
            # prefill: persist kv into the cache buffer
            kc, vc = cache["k"], cache["v"]
            start = _prefill_start(s, kc.shape[1])
            if sharded and own:
                # the cache holds every KV head of the rank's rows
                k = SL.to_local(lift(k, kh), _rows(rules, (b, s, kh, hd)))
                v = SL.to_local(lift(v, kh), _rows(rules, (b, s, kh, hd)))
            _write_cache(kc, 0, k[:, start:])
            _write_cache(vc, 0, v[:, start:])
            if sharded:
                kc = rules.constrain(kc, ("batch", "kv_seq", None, None))
                vc = rules.constrain(vc, ("batch", "kv_seq", None, None))
            new_cache = {"k": kc, "v": vc}

    if sharded:
        out = rules.constrain(_merge_heads(out), ("batch", None, "qkv"))
    else:
        out = out.reshape(b, s, h * hd)
    return dense_apply(p["wo"], out), new_cache


def attn_cache_specs():
    return {"k": ("batch", "kv_seq", None, None),
            "v": ("batch", "kv_seq", None, None)}


def make_attn_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                    *, local: bool = False, device=None):
    """Cache buffers for one attention layer.  Local layers cap at window."""
    t = min(max_len, cfg.window_size) if (local and cfg.window_size) else max_len
    kh, hd = cfg.n_kv_heads, cfg.head_dim
    return {"k": torch.zeros((batch, t, kh, hd), dtype=dtype, device=device),
            "v": torch.zeros((batch, t, kh, hd), dtype=dtype, device=device)}
