"""The comparison that decides ``correct``: the program's pair sets
against the reference's on the same corpus."""
from __future__ import annotations

import numpy as np

from erbench.reference import sn


def compare(host: dict, config: dict, blocked, matched, counts,
            limits: dict) -> dict:
    """{name: (value, limit)}.  ``blocked`` and ``matched`` are the sets of
    the answer compared in full, as sets of (lo, hi) eid tuples or as
    packed sorted arrays; ``counts`` the (blocked, matched) sizes of every
    other answer of the window, each held to the reference's sizes.
    ``blocked_diff`` and ``matched_diff`` are the widest number of pairs
    by which an answer and the reference differ."""
    ref_b, ref_m = sn.resolve(host, config["er"]["window"],
                              config["matcher"])
    diff = lambda got, ref: sn.sym_diff(got, ref) \
        if isinstance(got, np.ndarray) else sn.sym_diff_set(got, ref)
    b = diff(blocked, ref_b)
    m = diff(matched, ref_m)
    for nb, nm in counts:
        b = max(b, abs(nb - ref_b.size))
        m = max(m, abs(nm - ref_m.size))
    return {"blocked_diff": (b, limits["blocked_diff"]),
            "matched_diff": (m, limits["matched_diff"])}
