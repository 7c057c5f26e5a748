"""Adaptive window sizing — duplicate-density-driven per-entity windows
(port of ``repro.quality.adaptive``).

Where the key profile shows a dense block (many entities sharing one
blocking key), the window grows to cover the whole block; in sparse
regions it stays small so the reduction ratio survives (Papadakis et al.,
arXiv:1905.06167).  The map is a pure function of the global
``KeyProfile``:

    weff(entity) = clip(count(entity.key), window, window_max)

weff rides the payload as a ``_weff`` field, so it follows entities
through shuffles and halos, while the band runs once at ``window_max``.
The pair (i, i+d) exists iff d < weff[i+d] — the LATER element owns the
comparison, the same ownership rule as the balance cost model.
"""
from __future__ import annotations

import numpy as np

from repro_torch.balance.profile import KeyProfile


def weff_for_keys(keys, profile: KeyProfile, window: int,
                  window_max: int) -> np.ndarray:
    """Per-entity effective windows: ``clip(block_count(key), window,
    window_max)`` for each entry of ``keys``, int32.

    Keys absent from the profile (possible only for padding slots — the
    profile is built from the same key set) fall back to ``window``."""
    keys = np.asarray(keys, np.int64)
    weff = np.full(keys.shape, window, np.int64)
    if profile.n_blocks:
        idx = np.searchsorted(profile.uniq, keys)
        idx = np.minimum(idx, profile.n_blocks - 1)
        found = profile.uniq[idx] == keys
        weff[found] = np.clip(profile.counts[idx][found], window, window_max)
    return weff.astype(np.int32)
