"""Sorted Neighborhood blocking and the cascade matcher, in plain NumPy.

The benchmark's yardstick for ``correct``: it takes the host corpus the
benchmark made, sorts it by (key, eid) itself, blocks every pair of rows
fewer than ``window`` places apart (Kolb, Thor & Rahm, arXiv:1010.3053
§4, Figure 4), and scores each blocked pair with the configuration's
matcher spec: the weighted mean of cosine (on unit embeddings, mapped to
[0, 1]), Jaccard (on bit-packed signatures) and edit similarity (on
padded byte strings), accepted at the threshold.  Pairs travel as sorted
uint64 arrays ``(lo << 32) | hi`` of eids.

``precision`` is "f64" for the reference and "bf16" for the control: the
same arithmetic with every input and every intermediate rounded to
bfloat16 (products of two bfloat16 values are exact in float32, sums are
accumulated in float32 and rounded once), as a bfloat16 kernel would.

Nothing here imports the program under test.
"""
from __future__ import annotations

import numpy as np

PRECISIONS = ("f64", "bf16")


def pack(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Eid pairs -> packed uint64 ``(min << 32) | max``."""
    a = np.asarray(a, np.uint64)
    b = np.asarray(b, np.uint64)
    return (np.minimum(a, b) << np.uint64(32)) | np.maximum(a, b)


def sorted_order(keys: np.ndarray, eids: np.ndarray) -> np.ndarray:
    """Row order by (key, eid)."""
    return np.lexsort((eids, keys))


def _bf16(x) -> np.ndarray:
    """Round float32 values to the nearest bfloat16 (ties to even)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    u = (u + (np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1)))) \
        & np.uint32(0xFFFF0000)
    return u.view(np.float32)


def _rounder(precision: str):
    if precision == "f64":
        return lambda x: np.asarray(x, np.float64)
    if precision == "bf16":
        return _bf16
    raise ValueError(f"unknown precision {precision!r}; one of {PRECISIONS}")


def cosine(fa: np.ndarray, fb: np.ndarray, precision: str) -> np.ndarray:
    """0.5 * (a . b + 1), clipped to [0, 1]."""
    r = _rounder(precision)
    if precision == "f64":
        dot = np.einsum("ij,ij->i", fa.astype(np.float64, copy=False),
                        fb.astype(np.float64, copy=False))
    else:
        dot = r(np.einsum("ij,ij->i", r(fa), r(fb)))
    return np.clip(r(0.5 * r(dot + 1.0)), 0.0, 1.0)


def jaccard(sa: np.ndarray, sb: np.ndarray, precision: str) -> np.ndarray:
    """|a & b| / |a | b| of bit-packed sets; two empty sets score 1."""
    r = _rounder(precision)
    inter = np.bitwise_count(sa & sb).sum(axis=1, dtype=np.int64)
    union = np.bitwise_count(sa | sb).sum(axis=1, dtype=np.int64)
    out = np.ones(inter.shape, np.float64)
    nz = union > 0
    out[nz] = inter[nz] / union[nz]
    return r(out)


def edit_distance(ta: np.ndarray, tb: np.ndarray) -> np.ndarray:
    """Levenshtein distance of zero-padded byte strings, row by row of the
    dynamic programme, vectorised over pairs."""
    m, width = ta.shape
    la = (ta > 0).sum(axis=1)
    lb = (tb > 0).sum(axis=1)
    prev = np.broadcast_to(np.arange(width + 1, dtype=np.int32),
                           (m, width + 1)).copy()
    ans = lb.astype(np.int32).copy()             # la == 0
    rows = np.arange(m)
    for i in range(1, width + 1):
        cur = np.empty_like(prev)
        cur[:, 0] = i
        ca = ta[:, i - 1]
        for j in range(1, width + 1):
            sub = prev[:, j - 1] + (ca != tb[:, j - 1])
            cur[:, j] = np.minimum(np.minimum(prev[:, j], cur[:, j - 1]) + 1,
                                   sub)
        done = la == i
        ans[done] = cur[rows[done], lb[done]]
        prev = cur
    return ans


def edit_sim(ta: np.ndarray, tb: np.ndarray, precision: str) -> np.ndarray:
    """1 - distance / the longer length (1 for two empty strings)."""
    r = _rounder(precision)
    longer = np.maximum((ta > 0).sum(axis=1), (tb > 0).sum(axis=1))
    d = edit_distance(ta, tb)
    return np.clip(r(1.0 - r(d / np.maximum(longer, 1))), 0.0, 1.0)


_SIM = {"cosine": cosine, "jaccard": jaccard, "edit": edit_sim}


def scores(payload: dict, a: np.ndarray, b: np.ndarray, matcher: dict,
           precision: str = "f64") -> np.ndarray:
    """The matcher's weighted score of rows ``a`` against rows ``b``
    (index arrays or slices).  The expensive similarities (edit) are
    computed only where the cheap ones leave the threshold in reach;
    elsewhere the score is the cheap part (a pair that cannot reach the
    threshold stays below it)."""
    r = _rounder(precision)
    ms = sorted(matcher["matchers"], key=lambda x: x["cost"])
    wsum = float(sum(x["weight"] for x in ms))
    acc, rest = None, wsum
    for x in ms:
        field, kind, w = x["field"], x["kind"], float(x["weight"])
        fa, fb = payload[field][a], payload[field][b]
        if acc is None:
            acc = np.zeros(fa.shape[0], np.float64)
        if kind == "edit":
            reach = r(r(acc + rest) / wsum) >= matcher["threshold"]
            s = np.zeros(fa.shape[0], np.float64)
            if reach.any():
                s[reach] = _SIM[kind](fa[reach], fb[reach], precision)
        else:
            s = _SIM[kind](fa, fb, precision)
        acc = r(acc + r(w * s))
        rest -= w
    return r(acc / wsum)


def resolve(host: dict, window: int, matcher: dict,
            precision: str = "f64"):
    """(blocked, matched) packed sorted pair arrays of the valid rows of a
    host corpus under sequential Sorted Neighborhood with ``window``."""
    valid = np.asarray(host["valid"], bool)
    order = sorted_order(host["key"][valid], host["eid"][valid])
    eids = host["eid"][valid][order]
    wide = np.float64 if precision == "f64" else np.float32
    payload = {k: v[valid][order].astype(
        wide if v.dtype.kind == "f" else v.dtype)
        for k, v in host["payload"].items()}
    n = eids.size
    blocked, matched = [], []
    for d in range(1, min(window, n)):
        a, b = slice(0, n - d), slice(d, n)
        pairs = pack(eids[a], eids[b])
        blocked.append(pairs)
        hit = scores(payload, a, b, matcher, precision) >= \
            matcher["threshold"]
        matched.append(pairs[hit])
    cat = lambda xs: np.sort(np.concatenate(xs)) if xs \
        else np.empty((0,), np.uint64)
    return cat(blocked), cat(matched)


def sym_diff(a: np.ndarray, b: np.ndarray) -> int:
    """Size of the symmetric difference of two sorted distinct arrays."""
    if a.size == 0 or b.size == 0:
        return int(a.size + b.size)
    i = np.minimum(np.searchsorted(b, a), b.size - 1)
    common = int((b[i] == a).sum())
    return int(a.size + b.size - 2 * common)


def unpack(packed: np.ndarray):
    """Packed pairs -> (lo, hi) int64 arrays."""
    packed = np.asarray(packed, np.uint64)
    return ((packed >> np.uint64(32)).astype(np.int64),
            (packed & np.uint64(0xFFFFFFFF)).astype(np.int64))


def sym_diff_set(pairs, packed: np.ndarray) -> int:
    """Size of the symmetric difference of a set of (lo, hi) eid tuples
    and a sorted distinct packed array (the set is read as it is, in C,
    without converting its tuples)."""
    lo, hi = unpack(packed)
    extra = len(pairs.difference(zip(lo.tolist(), hi.tolist())))
    return 2 * extra + packed.size - len(pairs)
