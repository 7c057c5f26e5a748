"""Labeled corpus generator — entities with KNOWN duplicate clusters (port
of ``repro.data.truth``; the same numpy draws in the same order, so one
seed gives the reference's corpus and gold set bit for bit).

  * entities come in UNITS: singletons and duplicate clusters of size
    2..max_cluster, sizes drawn with P(s) ∝ s^-size_skew; one
    max_cluster-sized cluster is always planted first;
  * each unit owns a distinct blocking key, so a cluster of size c is a key
    block of density c — the signal ``window_policy="adaptive"`` reads;
  * ``typo_rate`` corrupts the KEY of cluster members 1.. (member 0 keeps
    it); the ``alt`` payload field carries each unit's uncorrupted
    secondary key, so an ``identity``-on-``alt`` pass wins those pairs back;
  * payloads follow the matcher schema (unit-norm ``feat`` float32,
    bit-signature ``sig``): cluster members share a signature and a lightly
    noised feature vector.

Gold pairs are all intra-cluster pairs, as a frozenset of (lo, hi) eid
tuples and packed uint64 (``(lo << 32) | hi``, sorted unique).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import FrozenSet, Tuple

import numpy as np

from repro_torch.core import entities as E


@dataclass(frozen=True)
class TruthCorpus:
    """A labeled corpus: entities + their complete gold duplicate pair set.

    ents         port entity dict (key/eid/valid/payload with feat, sig, alt)
    gold         frozenset of (lo, hi) gold eid pairs (all intra-cluster)
    gold_packed  the same pairs packed uint64, sorted unique
    n            entity count
    n_units      generated units (clusters + singletons)
    max_cluster  largest planted cluster size
    max_block    largest key-block density (one unit per key)
    n_typos      cluster members whose key was corrupted
    """
    ents: dict
    gold: FrozenSet[Tuple[int, int]]
    gold_packed: np.ndarray
    n: int
    n_units: int
    max_cluster: int
    max_block: int
    n_typos: int


def _gold_packed(unit_pos, inv: np.ndarray) -> np.ndarray:
    """All intra-unit eid pairs, packed and sorted: units of one size are
    gathered into one (units, size) eid array and paired through its upper
    triangle (the reference's per-pair loop, vectorized; no draws).  Units
    are disjoint, so the pairs are distinct and a sort makes them unique."""
    by_size = {}
    for ps in unit_pos:
        if ps.size >= 2:
            by_size.setdefault(ps.size, []).append(ps)
    chunks = [np.empty((0,), np.uint64)]
    for s, units in by_size.items():
        eids = np.sort(inv[np.stack(units)], axis=1).astype(np.uint64)
        a, b = np.triu_indices(s, k=1)
        chunks.append(((eids[:, a] << np.uint64(32)) | eids[:, b]).ravel())
    return np.sort(np.concatenate(chunks))


def labeled_corpus(seed: int, n: int, *, max_cluster: int = 12,
                   cluster_rate: float = 0.35, size_skew: float = 1.0,
                   typo_rate: float = 0.0, feat_dim: int = 32,
                   sig_words: int = 8, key_space: int = 1 << 20,
                   device="cpu") -> TruthCorpus:
    """Deterministic labeled corpus of ``n`` entities (see module doc),
    made with numpy on the host; ``ents`` is moved to ``device``.

    ``cluster_rate`` is the probability each new unit is a cluster (vs a
    singleton); ``size_skew`` shapes the cluster-size distribution
    P(s) ∝ s^-size_skew over 2..max_cluster."""
    if max_cluster < 2:
        raise ValueError(f"max_cluster must be >= 2, got {max_cluster}")
    if not 0.0 <= typo_rate < 1.0:
        raise ValueError(f"typo_rate must be in [0, 1), got {typo_rate}")
    rng = np.random.default_rng(seed)

    sizes_choices = np.arange(2, max_cluster + 1)
    size_p = sizes_choices.astype(np.float64) ** -float(size_skew)
    size_p /= size_p.sum()

    unit_sizes = []
    pos = 0
    while pos < n:
        room = n - pos
        if not unit_sizes and room >= max_cluster:
            s = max_cluster                       # the tail always exists
        elif room >= 2 and rng.random() < cluster_rate:
            s = min(int(rng.choice(sizes_choices, p=size_p)), room)
        else:
            s = 1
        unit_sizes.append(s)
        pos += s
    n_units = len(unit_sizes)

    stride = max(key_space // (n_units + 2), 2)
    keys = np.empty(n, np.int64)
    alt = np.empty(n, np.int32)
    feat = np.empty((n, feat_dim), np.float32)
    sig = np.empty((n, sig_words), np.uint32)
    unit_pos = []                                 # member positions per unit
    n_typos = 0
    pos = 0
    for u, s in enumerate(unit_sizes):
        ps = np.arange(pos, pos + s)
        unit_pos.append(ps)
        keys[ps] = (u + 1) * stride
        alt[ps] = u
        base = rng.normal(size=feat_dim).astype(np.float32)
        usig = rng.integers(0, 2 ** 32, size=sig_words,
                            dtype=np.uint64).astype(np.uint32)
        if s == 1:
            feat[ps] = base
            sig[ps] = rng.integers(0, 2 ** 32, size=sig_words,
                                   dtype=np.uint64).astype(np.uint32)
        else:
            feat[ps] = base[None, :] + 0.01 * rng.normal(
                size=(s, feat_dim)).astype(np.float32)
            sig[ps] = usig[None, :]
            if typo_rate:
                # corrupt keys of members 1.. (member 0 keeps the true key)
                bad = ps[1:][rng.random(s - 1) < typo_rate]
                keys[bad] = (rng.integers(1, n_units + 1, size=bad.size)
                             * stride
                             + rng.integers(1, stride, size=bad.size))
                n_typos += int(bad.size)
        pos += s
    feat /= np.linalg.norm(feat, axis=1, keepdims=True) + 1e-9

    perm = rng.permutation(n)                     # eid != generation order
    inv = np.argsort(perm)                        # original pos -> eid
    ents = E.make_entities(
        keys[perm].astype(np.int32), np.arange(n, dtype=np.int32),
        payload={"feat": feat[perm], "sig": sig[perm],
                 "alt": alt[perm]}, device=device)

    gold_packed = _gold_packed(unit_pos, inv)
    lo = (gold_packed >> np.uint64(32)).astype(np.int64)
    hi = (gold_packed & np.uint64(0xFFFFFFFF)).astype(np.int64)
    return TruthCorpus(ents=ents, gold=frozenset(zip(lo.tolist(),
                                                     hi.tolist())),
                       gold_packed=gold_packed, n=n, n_units=n_units,
                       max_cluster=max_cluster,
                       max_block=max(unit_sizes), n_typos=n_typos)
