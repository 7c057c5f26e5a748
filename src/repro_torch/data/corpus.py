"""Synthetic corpora, the corpus-dedup stage and the LM's token batcher
(port of ``repro.data.corpus``).  The same numpy draws in the same order,
so one seed gives the reference's arrays bit for bit.

  * ``synth_corpus``         token documents with planted near-duplicates
  * ``zipf_entities``        the skewed hot-key entity corpus
  * ``synth_entity_chunks`` / ``zipf_entity_chunks``
                             the chunked out-of-core sources of
                             ``repro_torch.stream``
  * ``doc_entities``, ``dedup_corpus``
                             documents -> entities, and the paper's
                             workflow as a dedup stage (``DedupResult``)
  * ``TokenBatcher``         the LM train loop's batches, a pure function
                             of (seed, step)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.core import entities as E
from repro_torch.core import partition as P


def synth_corpus(seed: int, n_docs: int, *, doc_len: int = 64,
                 vocab: int = 1000, dup_frac: float = 0.25,
                 near_dup_noise: int = 2) -> np.ndarray:
    """Token documents (n_docs, doc_len) int32 with planted
    near-duplicates."""
    rng = np.random.default_rng(seed)
    docs = rng.integers(1, vocab, size=(n_docs, doc_len), dtype=np.int32)
    n_dup = int(n_docs * dup_frac)
    src = rng.integers(0, n_docs, size=n_dup)
    dst = rng.integers(0, n_docs, size=n_dup)
    docs[dst] = docs[src]
    # near-duplicates: perturb a few tokens
    for d in dst[: n_dup // 2]:
        pos = rng.integers(0, doc_len, size=near_dup_noise)
        docs[d, pos] = rng.integers(1, vocab, size=near_dup_noise)
    return docs


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


def _with_eids(ents: dict, start: int) -> dict:
    """``ents`` with globally unique eids ``start, start+1, ...``."""
    n = int(ents["key"].shape[0])
    return dict(ents, eid=torch.arange(start, start + n, dtype=torch.int32,
                                       device=ents["key"].device))


def synth_entity_chunks(seed: int, n: int, chunk: int, *,
                        n_keys: int = 1000, sig_words: int = 8,
                        feat_dim: int = 32, dup_frac: float = 0.2,
                        skew: float = 0.0, text_len: int = 0,
                        device="cpu") -> Iterator[dict]:
    """Chunked ``entities.synth_entities``: the out-of-core corpus source
    for ``repro_torch.stream`` (yields ceil(n / chunk) entity chunks on
    ``device``, generated one at a time — nothing larger than ``chunk`` is
    ever materialized).

    Eids are globally unique (chunk c owns ``[c*chunk, c*chunk+len)``);
    duplicates are planted WITHIN each chunk (near-identical payloads),
    while cross-chunk near-neighbors arise from the shared key space —
    exactly the layout an external sort has to repair."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    rng = np.random.default_rng(seed)
    for start in range(0, n, chunk):
        size = min(chunk, n - start)
        ents = E.synth_entities(rng, size, n_keys=n_keys,
                                sig_words=sig_words, feat_dim=feat_dim,
                                dup_frac=dup_frac, skew=skew,
                                text_len=text_len, device=device)
        yield _with_eids(ents, start)


def zipf_entity_chunks(seed: int, n: int, chunk: int, *,
                       n_clusters: int = 256, exponent: float = 1.1,
                       dup_frac: float = 0.2, cluster_width: int = 1,
                       key_space: int = 1 << 20, feat_dim: int = 32,
                       sig_words: int = 8, device="cpu") -> Iterator[dict]:
    """Chunked ``zipf_entities``: the skewed out-of-core corpus (hot-key
    clusters in every chunk) that exercises the streaming per-chunk
    planning hook.  Eids are globally unique, one chunk at a time."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    for i, start in enumerate(range(0, n, chunk)):
        size = min(chunk, n - start)
        ents = zipf_entities(seed + i, size, n_clusters=n_clusters,
                             exponent=exponent, dup_frac=dup_frac,
                             cluster_width=cluster_width,
                             key_space=key_space, feat_dim=feat_dim,
                             sig_words=sig_words, device=device)
        yield _with_eids(ents, start)


def doc_entities(docs: np.ndarray, *, sig_words: int = 8,
                 feat_dim: int = 64, device="cpu") -> dict:
    """Documents -> entity records on ``device``: blocking key from the
    leading tokens, minhash-style bit signature + mean-pooled hashed
    features as payload."""
    n, L = docs.shape
    # blocking key: first two tokens folded into <2^30 (the 'title prefix')
    key = (docs[:, 0].astype(np.int64) * 1009 + docs[:, 1]) % (1 << 24)
    rng = np.random.default_rng(0)
    proj = rng.normal(size=(1024, feat_dim)).astype(np.float32) / 8.0
    feat = proj[docs.astype(np.int64) % 1024].mean(axis=1)
    feat /= np.linalg.norm(feat, axis=1, keepdims=True) + 1e-9
    # token-set bit signature
    bits = (docs.astype(np.int64) * 2654435761 % (sig_words * 32)).astype(
        np.int64)
    sig = np.zeros((n, sig_words), np.uint32)
    rows = np.repeat(np.arange(n), L)
    w = bits.reshape(-1) // 32
    b = bits.reshape(-1) % 32
    np.bitwise_or.at(sig, (rows, w), (1 << b.astype(np.uint32)))
    return E.make_entities(key.astype(np.int32), np.arange(n, dtype=np.int32),
                           payload={"feat": feat, "sig": sig}, device=device)


@dataclass
class DedupResult:
    keep: np.ndarray                 # (n_docs,) bool
    n_pairs: int
    n_dropped: int
    gini: float
    overflow: int


def dedup_corpus(docs: np.ndarray, *, r: int = 4, window: int = 10,
                 variant: str = "repsn", threshold: float = 0.9,
                 balance: bool = True, device=None) -> DedupResult:
    """The paper's workflow as a corpus-dedup stage.  Keeps the lowest-eid
    member of every matched pair (union-find-free greedy: drop the higher).
    ``device`` as in ``api.resolve`` (None = the CUDA card)."""
    from dataclasses import replace

    from repro_torch import api
    from repro_torch.core.match import default_matcher
    ents = doc_entities(docs)
    keys_np = ents["key"].numpy()
    bounds = P.balanced_partition(keys_np, r) if balance else \
        P.range_partition(1 << 24, r)
    matcher = replace(default_matcher(), threshold=threshold)
    cfg = api.ERConfig(window=window, variant=variant, matcher=matcher,
                       runner="vmap", num_shards=r)
    res = api.resolve(ents, cfg, bounds=bounds, device=device)
    keep = np.ones(docs.shape[0], bool)
    for a, b in sorted(res.matches):
        if keep[a]:
            keep[b] = False
    sizes = P.partition_sizes(bounds, ents["key"], r=r)
    return DedupResult(keep=keep, n_pairs=len(res.matches),
                       n_dropped=int((~keep).sum()),
                       gini=P.gini(sizes), overflow=res.blocking.overflow)


# -- deterministic token batcher ---------------------------------------------

@dataclass
class TokenBatcher:
    """batch(step) is a pure function of (seed, step): crash recovery replays
    the exact data order (fault tolerance requires deterministic data)."""
    docs: np.ndarray                  # (n_docs, L) post-dedup
    seq_len: int
    global_batch: int
    seed: int = 0

    def __post_init__(self):
        flat = self.docs.reshape(-1)
        n_tok = (flat.shape[0] // self.seq_len) * self.seq_len
        self.stream = flat[:n_tok].reshape(-1, self.seq_len)

    @property
    def n_sequences(self) -> int:
        return self.stream.shape[0]

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed << 20) ^ step)
        idx = rng.integers(0, self.n_sequences, size=self.global_batch)
        toks = self.stream[idx].astype(np.int32)
        labels = np.concatenate(
            [toks[:, 1:], np.full((toks.shape[0], 1), -1, np.int32)], axis=1)
        return {"tokens": toks, "labels": labels}
