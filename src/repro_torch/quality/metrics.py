"""Ground-truth blocking quality metrics (port of
``repro.quality.metrics``): the blocking-survey quartet computed against a
GOLD duplicate pair set (Papadakis et al., arXiv:1905.06167):

  pairs_completeness  |blocked ∩ gold| / |gold|      (recall of blocking)
  pairs_quality       |blocked ∩ gold| / |blocked|   (precision of blocking)
  reduction_ratio     1 − |blocked| / total_comparisons
  f_measure           harmonic mean of PC and PQ

All set algebra runs on packed uint64 pair arrays (``(lo << 32) | hi``).
``repro_torch.api.results`` is imported inside functions: the api
package's init pulls the facade, which imports this package.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np


@dataclass(frozen=True)
class QualityMetrics:
    """Blocking quality against a gold duplicate pair set, with the raw
    counts so any derived number can be recomputed."""
    pairs_completeness: float
    pairs_quality: float
    reduction_ratio: float
    f_measure: float
    gold_pairs: int
    blocked_pairs: int
    true_positives: int
    total_comparisons: int


def _as_packed(pairs) -> np.ndarray:
    """Anything pair-shaped -> deduplicated packed uint64 array: a resolve
    result (anything with ``.pairs`` or ``.blocking.pairs``), a set of
    (lo, hi) tuples, or an already-packed uint64 array."""
    from repro_torch.api import results as RES

    if hasattr(pairs, "blocking"):
        pairs = pairs.blocking.pairs
    elif hasattr(pairs, "pairs"):
        pairs = pairs.pairs
    if isinstance(pairs, np.ndarray):
        return RES.unique_packed(pairs)
    return RES.pack_pair_set(pairs)


def _gold_packed(truth) -> np.ndarray:
    """A TruthCorpus (``gold_packed``/``gold``) or raw pair collection ->
    packed gold array."""
    if hasattr(truth, "gold_packed"):
        return np.asarray(truth.gold_packed)
    if hasattr(truth, "gold"):
        truth = truth.gold
    return _as_packed(truth)


def evaluate(result, truth, total_comparisons: int = None) -> QualityMetrics:
    """Score a resolve result's BLOCKED pair set against ground truth.

    ``truth`` is a ``repro_torch.data.truth.TruthCorpus`` (or any gold
    pair collection); ``total_comparisons`` defaults to the corpus's full
    comparison space n·(n−1)/2 (required when ``truth`` is a bare pair
    set)."""
    blocked = _as_packed(result)
    gold = _gold_packed(truth)
    if total_comparisons is None:
        n = getattr(truth, "n", None)
        if n is None:
            raise ValueError(
                "total_comparisons is required when truth carries no "
                "entity count (pass a TruthCorpus or give it explicitly)")
        total_comparisons = n * (n - 1) // 2
    tp = int(np.intersect1d(blocked, gold, assume_unique=True).size)
    nb, ng = int(blocked.size), int(gold.size)
    pc = 1.0 if ng == 0 else tp / ng
    pq = 1.0 if nb == 0 else tp / nb
    rr = 1.0 if total_comparisons <= 0 else 1.0 - nb / total_comparisons
    f = 0.0 if pc + pq == 0 else 2.0 * pc * pq / (pc + pq)
    return QualityMetrics(pairs_completeness=pc, pairs_quality=pq,
                          reduction_ratio=rr, f_measure=f,
                          gold_pairs=ng, blocked_pairs=nb,
                          true_positives=tp,
                          total_comparisons=int(total_comparisons))


def attach(result, truth, total_comparisons: int = None):
    """Evaluate and surface the quality metrics on ``result.metrics
    .quality``, returning the updated (replaced) result.  Without oracle
    metrics (``compute_metrics=False``) an ``ERMetrics`` is synthesized
    from the ground-truth numbers: pairs completeness AGAINST GOLD."""
    from repro_torch.api import results as RES

    q = evaluate(result, truth, total_comparisons)
    if result.metrics is None:
        metrics = RES.ERMetrics(
            reduction_ratio=q.reduction_ratio,
            pairs_completeness=q.pairs_completeness,
            oracle_pairs=q.gold_pairs,
            total_comparisons=q.total_comparisons,
            quality=q)
    else:
        metrics = replace(result.metrics, quality=q)
    return replace(result, metrics=metrics)
