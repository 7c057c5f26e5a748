"""Partition functions p: key -> reducer index (paper §4.1) — port of
``repro.core.partition``, with the partition-size statistics (sizes, Gini)
of the corpus-dedup stage.

A partitioner is a monotonically non-decreasing map from blocking keys to
shard ids, represented by r-1 int32 upper boundaries: shard i receives
keys in (bounds[i-1], bounds[i]].  Monotonicity gives sorted reduce
partitions (SRP).  Boundary arrays are int32 tensors on the host.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def shard_of(bounds: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """bounds: (r-1,) sorted upper bounds -> shard id in [0, r), int32."""
    bounds = torch.as_tensor(bounds, dtype=torch.int32, device=keys.device)
    return torch.searchsorted(bounds.contiguous(), keys.contiguous(),
                              side="left").to(torch.int32)


def range_partition(key_space: int, r: int) -> torch.Tensor:
    """Evenly split the KEY SPACE into r intervals (paper's Even8/Even10)."""
    edges = (np.arange(1, r) * key_space) // r
    return torch.as_tensor(edges.astype(np.int32))


def manual_partition(edges: Sequence[int]) -> torch.Tensor:
    return torch.as_tensor(np.asarray(sorted(edges), np.int32)
                           .reshape(-1))


def sample_partition(sample_keys: torch.Tensor, r: int) -> torch.Tensor:
    """Equi-depth boundaries from sampled keys (sample-sort splitters)."""
    s = torch.sort(torch.as_tensor(sample_keys)).values
    n = s.shape[0]
    idx = (torch.arange(1, r, device=s.device) * n) // r
    return s[idx].to(torch.int32)


def balanced_partition(keys: np.ndarray, r: int) -> torch.Tensor:
    """Histogram-based equi-depth boundaries that respect duplicate keys
    (host-side): keys with mass >= total/r get their own shards, the light
    mass is split equi-depth.  A single key's mass is never split across
    shards (MapReduce-inherent, paper §5.3).  Boundaries are INCLUSIVE
    upper bounds under ``shard_of``."""
    ks = np.asarray(keys)
    uniq, counts = np.unique(ks, return_counts=True)
    total = int(counts.sum())
    hot = counts >= total / r
    n_hot = int(hot.sum())
    light_total = total - int(counts[hot].sum())
    light_shards = max(r - n_hot, 1)
    light_target = max(light_total / light_shards, 1.0)

    edges: list[int] = []
    acc = 0
    for u, c in zip(uniq, counts):
        if len(edges) >= r - 1:
            break
        u = int(u)
        if c >= total / r:                  # hot key: own shard
            if acc > 0:
                edges.append(u - 1)         # close the light shard before it
                acc = 0
            if len(edges) < r - 1:
                edges.append(u)             # close the hot key's shard
            continue
        acc += int(c)
        if acc >= light_target:
            edges.append(u)
            acc = 0
    hi = int(uniq[-1]) if len(uniq) else 0
    while len(edges) < r - 1:               # pad with unused bounds
        hi += 1
        edges.append(hi)
    edges = sorted(set(edges))
    while len(edges) < r - 1:               # dedup may shrink; repad
        edges.append(edges[-1] + 1)
    return torch.as_tensor(np.asarray(edges[:r - 1], np.int32).reshape(-1))


def partition_sizes(bounds, keys: torch.Tensor, valid=None,
                    r: int = None) -> torch.Tensor:
    """(r,) int32 count of (valid) keys per partition under ``bounds``."""
    keys = torch.as_tensor(keys)
    r = r if r is not None else int(torch.as_tensor(bounds).shape[0]) + 1
    sid = shard_of(bounds, keys).to(torch.int64)
    w = torch.ones_like(sid, dtype=torch.int32) if valid is None \
        else torch.as_tensor(valid, device=keys.device).to(torch.int32)
    return torch.zeros(r, dtype=torch.int32, device=keys.device) \
        .index_add_(0, sid, w)


def gini(sizes) -> float:
    """Gini coefficient of partition sizes (paper §5.3):
    g = 2*sum(i*y_i)/(n*sum(y_i)) - (n+1)/n with y sorted ascending."""
    sizes = sizes.cpu().numpy() if torch.is_tensor(sizes) else sizes
    y = np.sort(np.asarray(sizes).astype(np.float64))
    n = len(y)
    tot = y.sum()
    if tot == 0 or n == 0:
        return 0.0
    i = np.arange(1, n + 1)
    return float(2.0 * (i * y).sum() / (n * tot) - (n + 1) / n)


def skewed_partition(key_space: int, r: int, hot_frac: float,
                     keys) -> torch.Tensor:
    """Paper's Even8_40..Even8_85: boundaries chosen so that ``hot_frac`` of
    the entities land in the LAST partition, the rest evenly split."""
    keys = keys.cpu().numpy() if torch.is_tensor(keys) else keys
    ks = np.sort(np.asarray(keys))
    n = len(ks)
    cut = ks[min(int(n * (1.0 - hot_frac)), n - 1)]
    inner = np.linspace(0, cut, r, dtype=np.int64)[1:]      # r-1 edges <= cut
    return torch.as_tensor(inner.astype(np.int32))
