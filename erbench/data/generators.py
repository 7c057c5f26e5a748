"""Frozen copies of the port's corpus generators, as host numpy arrays.

``synth_arrays`` is ``repro_torch.core.entities.synth_arrays`` and
``zipf_arrays`` the array half of ``repro_torch.data.corpus.zipf_entities``,
copied so that a change to the program cannot change the benchmark's data.
``erbench/tests/test_erbench_data.py`` holds both bit-identical to the
program's generators at the same seed.
"""
from __future__ import annotations

import numpy as np


def synth_arrays(rng: np.random.Generator, n: int, *, n_keys: int = 1000,
                 sig_words: int = 8, feat_dim: int = 32,
                 dup_frac: float = 0.2, skew: float = 0.0,
                 text_len: int = 0) -> dict:
    """Uniform keys over ``n_keys`` (the paper's title-prefix key), a unit
    f32 embedding, a bit-packed uint32 trigram signature and, with
    ``text_len``, a padded lowercase title; ``dup_frac`` of the rows are
    planted near-duplicates of another row (same key, embedding plus 0.01
    noise, same signature, the title with one typo)."""
    keys = rng.integers(0, n_keys, size=n).astype(np.int32)
    if skew > 0:
        hot = rng.random(n) < skew
        keys[hot] = n_keys - 1
    feat = rng.normal(size=(n, feat_dim)).astype(np.float32)
    sig = rng.integers(0, 2**32, size=(n, sig_words), dtype=np.uint64) \
        .astype(np.uint32)
    text = rng.integers(ord("a"), ord("z") + 1, size=(n, text_len)) \
        .astype(np.uint8) if text_len else None
    n_dup = int(n * dup_frac)
    if n_dup:
        src = rng.integers(0, n, size=n_dup)
        dst = rng.integers(0, n, size=n_dup)
        keys[dst] = keys[src]
        feat[dst] = feat[src] + 0.01 * rng.normal(size=(n_dup, feat_dim)) \
            .astype(np.float32)
        sig[dst] = sig[src]
        if text is not None:
            text[dst] = text[src]
            typo_pos = rng.integers(0, text_len, size=n_dup)
            text[dst, typo_pos] = rng.integers(
                ord("a"), ord("z") + 1, size=n_dup).astype(np.uint8)
    feat /= np.linalg.norm(feat, axis=1, keepdims=True) + 1e-9
    payload = {"feat": feat, "sig": sig}
    if text is not None:
        payload["text"] = text
    return {"key": keys, "eid": np.arange(n, dtype=np.int32),
            "valid": np.ones(n, bool), "payload": payload}


def zipf_arrays(seed: int, n: int, *, n_clusters: int = 256,
                exponent: float = 1.1, dup_frac: float = 0.2,
                cluster_width: int = 1, key_space: int = 1 << 20,
                feat_dim: int = 32, sig_words: int = 8,
                shuffle_clusters: bool = False) -> dict:
    """Zipfian sort-key clusters: cluster c (1-based rank) gets mass
    proportional to c^-exponent, ``cluster_width`` adjacent keys each, hot
    clusters at the low end of the key space unless ``shuffle_clusters``;
    ``dup_frac`` planted near-duplicates as in ``synth_arrays`` (no
    title)."""
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
    return {"key": keys, "eid": np.arange(n, dtype=np.int32),
            "valid": np.ones(n, bool),
            "payload": {"feat": feat, "sig": sig}}
