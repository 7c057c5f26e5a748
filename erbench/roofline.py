"""Peaks of the card and the work of kernel K1, computed from shapes.

K1 (``repro_torch/kernels/csrc/fused_band.cu``) scores the cheap part of
the cascade over each sorted shard's band: for every row and each of the
next ``window - 1`` rows, ``w_cos * cosine + w_jac * jaccard``.  Its work
is counted from what the corpus needs, never from the padded shard
capacity the program launches it with: the ``n`` records plus each
shard's ``window - 1`` halo rows, each input byte read once (an f32
embedding of ``feat_dim`` and ``sig_words`` 32-bit signature words a
row), each output byte written once (one f32 score per band slot), and
per band pair ``2 * feat_dim`` operations for the dot product and
``6 * sig_words`` for the two popcounts of each word.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def k1_work(n: int, shards: int, window: int, feat_dim: int,
            sig_words: int) -> dict:
    """Bytes and operations K1 needs for ``n`` records in ``shards`` sorted
    shards at ``window`` (the band holds ``window - 1`` slots a row)."""
    band = window - 1
    rows = n + shards * band
    # each shard of m rows has m*band - band*(band+1)/2 in-range pairs
    pairs = rows * band - shards * band * (band + 1) // 2
    n_bytes = rows * (4 * feat_dim + 4 * sig_words) + rows * band * 4
    n_ops = pairs * (2 * feat_dim + 6 * sig_words)
    return {"rows": rows, "pairs": pairs, "bytes": n_bytes, "ops": n_ops}


def bound_s(n_bytes: float, n_ops: float,
            ops_per_s: float = F32_OPS_PER_S) -> float:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the operations over the peak rate."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s)
