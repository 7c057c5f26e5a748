"""Plain PyTorch versions of the band and attention kernels — port of
``repro.kernels.ref``, with its names and semantics.

They are the allclose targets of the tests and of the card-side checks in
``chip_smoke.py``.  The wrappers in ``kernels.ops`` take them only for
tensors on the CPU; nothing on a CUDA path calls them.  Each accepts extra
leading dims (stacked shards or heads) where the reference takes one."""
from __future__ import annotations

import math

import torch

from repro_torch.core.match import popcount32


def banded_sim_ref(feat: torch.Tensor, *, window: int) -> torch.Tensor:
    """(..., M, F) f32 or bf16 -> band (..., M, window) f32:
    ``band[..., i, d] = <feat[i], feat[i+1+d]>`` (raw dot, no clip), zero
    past the end."""
    m = feat.shape[-2]
    f32 = feat.float()
    i = torch.arange(m, device=feat.device)
    cols = []
    for d in range(1, window + 1):
        s = (f32 * torch.roll(f32, -d, dims=-2)).sum(dim=-1)
        cols.append(torch.where(i + d < m, s, 0.0))
    return torch.stack(cols, dim=-1)


def jaccard_band_ref(sig: torch.Tensor, *, window: int) -> torch.Tensor:
    """(..., M, W) int32 bit views -> band (..., M, window) f32 of
    ``popc(a & b) / max(popc(a | b), 1)``.  Empty vs empty is 0.0 here,
    unlike ``core.match.jaccard_sig`` (1.0), exactly as in the reference
    kernel."""
    m = sig.shape[-2]
    i = torch.arange(m, device=sig.device)
    cols = []
    for d in range(1, window + 1):
        o = torch.roll(sig, -d, dims=-2)
        inter = popcount32(sig & o).sum(dim=-1).float()
        union = popcount32(sig | o).sum(dim=-1).float()
        jac = inter / torch.clamp_min(union, 1.0)
        cols.append(torch.where(i + d < m, jac, 0.0))
    return torch.stack(cols, dim=-1)


def local_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, window: int, softcap: float = 0.0) -> torch.Tensor:
    """(BH, S, D) causal sliding-window attention with materialized (BH, S,
    S) f32 scores: key kp is kept for query qp iff qp - window < kp <= qp;
    scale 1/sqrt(D); optional ``softcap * tanh(s / softcap)``; masked
    scores are -1e30.  Output in q's dtype."""
    s, d = q.shape[-2], q.shape[-1]
    sc = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / math.sqrt(d)
    if softcap:
        sc = softcap * torch.tanh(sc / softcap)
    qp = torch.arange(s, device=q.device)[:, None]
    kp = torch.arange(s, device=q.device)[None, :]
    mask = (kp <= qp) & (kp > qp - window)
    p = torch.softmax(torch.where(mask, sc, -1e30), dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)
