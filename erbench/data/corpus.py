"""The corpora a configuration describes, made from a seed on the host.

A configuration's ``corpus`` block names a generator of
``erbench.data.generators`` and its arguments; its ``graded`` block plants
graded near-duplicates on top (``plant_graded``).  Every stream of random
numbers derives from the run's seed, so one seed gives one corpus, one
insert stream and one delete stream, whatever the rate of the run.
"""
from __future__ import annotations

import numpy as np

from erbench.data import generators as G

# sub-streams of one seed (numpy SeedSequence spawn keys)
BASE, GRADED, INSERTS, DELETES = 0, 1, 2, 3


def rng(seed: int, stream: int, *more: int) -> np.random.Generator:
    """A generator for one sub-stream of ``seed`` (any integer)."""
    return np.random.default_rng([seed % 2**64, stream, *more])


def _generate(spec: dict, seed: int, n: int, stream: tuple) -> dict:
    kw = {k: v for k, v in spec.items() if k not in ("generator", "n")}
    if spec["generator"] == "synth":
        return G.synth_arrays(rng(seed, *stream), n, **kw)
    if spec["generator"] == "zipf":
        return G.zipf_arrays(int(np.random.SeedSequence(
            [seed % 2**64, *stream]).generate_state(1)[0]), n, **kw)
    raise ValueError(f"unknown generator {spec['generator']!r}")


def plant_graded(host: dict, g: np.random.Generator, *, frac: float,
                 max_gap: int, max_dot_drop: float, max_bit_flip: float,
                 max_typos: int) -> dict:
    """Overwrite ``frac`` of the rows with graded near-duplicates of the row
    ``1..max_gap`` places before them (same key, adjacent eids, so the pair
    lies inside any window wider than ``max_gap``).  Each copy draws a level
    t in [0, 1): its embedding's cosine to the source is 1 - max_dot_drop*t,
    each signature bit flips with probability max_bit_flip*t, and
    floor((max_typos+1)*t) title characters are redrawn.  Their scores
    spread over the matcher's threshold, as real duplicates of unequal
    quality do.  Works in place; returns ``host``."""
    n = host["key"].shape[0]
    k = int(n * frac)
    if k == 0 or n <= max_gap:
        return host
    src = g.integers(0, n - max_gap, size=k)
    dst = src + g.integers(1, max_gap + 1, size=k)
    t = g.random(k)
    host["key"][dst] = host["key"][src]
    pay = host["payload"]
    f = pay["feat"][src].astype(np.float64)
    f /= np.linalg.norm(f, axis=1, keepdims=True)
    u = g.normal(size=f.shape)
    u -= (u * f).sum(axis=1, keepdims=True) * f
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    c = (1.0 - max_dot_drop * t)[:, None]
    pay["feat"][dst] = (c * f + np.sqrt(1.0 - c * c) * u).astype(np.float32)
    words = pay["sig"].shape[1]
    flip = g.random((k, words, 32)) < (max_bit_flip * t)[:, None, None]
    mask = (flip.astype(np.uint64) << np.arange(32, dtype=np.uint64)) \
        .sum(axis=2).astype(np.uint32)
    pay["sig"][dst] = pay["sig"][src] ^ mask
    if "text" in pay:
        text = pay["text"]
        text[dst] = text[src]
        typos = np.floor((max_typos + 1) * t).astype(np.int64)
        pos = g.integers(0, text.shape[1], size=(k, max_typos))
        chars = g.integers(ord("a"), ord("z") + 1, size=(k, max_typos))
        for j in range(max_typos):
            sel = typos > j
            text[dst[sel], pos[sel, j]] = chars[sel, j].astype(np.uint8)
    return host


def make(config: dict, seed: int, n: int | None = None) -> dict:
    """The configuration's corpus for ``seed`` (``n`` rows: the
    configuration's own count unless given), as host numpy arrays in the
    generators' dtypes (uint32 signatures)."""
    spec = config["corpus"]
    n = spec["n"] if n is None else n
    host = _generate(spec, seed, n, (BASE,))
    if config.get("graded"):
        plant_graded(host, rng(seed, GRADED), **config["graded"])
    return host


def batch(config: dict, seed: int, index: int, size: int,
          eid_start: int) -> dict:
    """Insert batch ``index`` of the seed's endless stream of fresh records:
    ``size`` rows from the configuration's generator and grading, eids from
    ``eid_start``."""
    spec = config["corpus"]
    host = _generate(spec, seed, size, (INSERTS, index))
    if config.get("graded"):
        plant_graded(host, rng(seed, GRADED, index + 1), **config["graded"])
    host["eid"] = np.arange(eid_start, eid_start + size, dtype=np.int32)
    return host


def concat(parts) -> dict:
    """Row-wise concatenation of host corpora of one schema."""
    parts = list(parts)
    cat = lambda f: np.concatenate([p[f] for p in parts])
    return {"key": cat("key"), "eid": cat("eid"), "valid": cat("valid"),
            "payload": {k: np.concatenate([p["payload"][k] for p in parts])
                        for k in parts[0]["payload"]}}


def rows(host: dict, idx) -> dict:
    """The rows ``idx`` (slice, mask or indices) of a host corpus."""
    return {"key": host["key"][idx], "eid": host["eid"][idx],
            "valid": host["valid"][idx],
            "payload": {k: v[idx] for k, v in host["payload"].items()}}
