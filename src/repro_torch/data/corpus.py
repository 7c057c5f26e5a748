"""Synthetic entity corpora (port of ``zipf_entities`` from
``repro.data.corpus``; the same numpy draws in the same order, so one
seed gives the reference's arrays bit for bit)."""
from __future__ import annotations

import numpy as np

from repro_torch.core import entities as E


def zipf_entities(seed: int, n: int, *, n_clusters: int = 256,
                  exponent: float = 1.1, dup_frac: float = 0.2,
                  cluster_width: int = 1, key_space: int = 1 << 20,
                  feat_dim: int = 32, sig_words: int = 8,
                  shuffle_clusters: bool = False, device="cpu") -> dict:
    """Skewed entity corpus: Zipfian sort-key clusters (the hot-key workload
    the balance planners exist for).

    Cluster c (1-based rank) receives mass ∝ c^-exponent over
    ``n_clusters`` clusters.  Each cluster occupies ``cluster_width``
    adjacent sort keys (1 = a single hot key, exercising mid-block splits),
    and clusters sit in rank order along the key space — hot keys
    contiguous at the low end — unless ``shuffle_clusters``.  ``dup_frac``
    of the entities are planted near-duplicates (same key, near-identical
    payload).  Made with numpy on the host, then moved to ``device``."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, n_clusters + 1, dtype=np.float64)
    p = ranks ** -float(exponent)
    p /= p.sum()
    cluster = rng.choice(n_clusters, size=n, p=p)
    order = rng.permutation(n_clusters) if shuffle_clusters \
        else np.arange(n_clusters)
    stride = max(key_space // n_clusters, cluster_width)
    keys = (order[cluster] * stride
            + rng.integers(0, cluster_width, size=n)).astype(np.int32)
    feat = rng.normal(size=(n, feat_dim)).astype(np.float32)
    sig = rng.integers(0, 2 ** 32, size=(n, sig_words),
                       dtype=np.uint64).astype(np.uint32)
    n_dup = int(n * dup_frac)
    if n_dup:
        src = rng.integers(0, n, size=n_dup)
        dst = rng.integers(0, n, size=n_dup)
        keys[dst] = keys[src]
        feat[dst] = feat[src] + 0.01 * rng.normal(
            size=(n_dup, feat_dim)).astype(np.float32)
        sig[dst] = sig[src]
    feat /= np.linalg.norm(feat, axis=1, keepdims=True) + 1e-9
    return E.make_entities(keys, np.arange(n, dtype=np.int32),
                           payload={"feat": feat, "sig": sig}, device=device)
