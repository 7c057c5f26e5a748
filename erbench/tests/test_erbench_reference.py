"""The reference against brute force on tiny corpora, and against the
program run on the CPU at a small size."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from erbench import harness  # noqa: E402
from erbench.data import corpus  # noqa: E402
from erbench.reference import check, sn  # noqa: E402


def _packed(pairs) -> np.ndarray:
    """A set of (lo, hi) eid tuples as a sorted packed array."""
    pairs = sorted(pairs)
    return np.sort(sn.pack([p[0] for p in pairs], [p[1] for p in pairs]))


def _edit(a: bytes, b: bytes) -> int:
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def _score(pay, i, j, matcher):
    total = wsum = 0.0
    for m in matcher["matchers"]:
        a, b = pay[m["field"]][i], pay[m["field"]][j]
        if m["kind"] == "cosine":
            s = min(1.0, max(0.0, 0.5 * (sum(float(x) * float(y)
                                              for x, y in zip(a, b)) + 1)))
        elif m["kind"] == "jaccard":
            inter = sum(bin(int(x) & int(y)).count("1") for x, y in zip(a, b))
            union = sum(bin(int(x) | int(y)).count("1") for x, y in zip(a, b))
            s = inter / union if union else 1.0
        else:
            sa, sb = bytes(a[a > 0].tolist()), bytes(b[b > 0].tolist())
            s = 1.0 - _edit(sa, sb) / max(len(sa), len(sb), 1)
        total += m["weight"] * s
        wsum += m["weight"]
    return total / wsum


def _brute(host, window, matcher):
    rows = sorted(range(len(host["key"])),
                  key=lambda r: (int(host["key"][r]), int(host["eid"][r])))
    blocked, matched = set(), set()
    for x in range(len(rows)):
        for y in range(x + 1, min(x + window, len(rows))):
            i, j = rows[x], rows[y]
            p = tuple(sorted((int(host["eid"][i]), int(host["eid"][j]))))
            blocked.add(p)
            if _score(host["payload"], i, j, matcher) >= \
                    matcher["threshold"]:
                matched.add(p)
    return _packed(blocked), _packed(matched)


@pytest.mark.parametrize("seed", [3, 2**32 + 1])
def test_reference_is_brute_force(seed):
    cfg = harness.config("pubs-1.4m")
    host = corpus.make(cfg, seed, n=400)
    host["key"] = host["key"] % 40          # small blocks: ties in keys
    got = sn.resolve(host, 6, cfg["matcher"])
    want = _brute(host, 6, cfg["matcher"])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert want[1].size > 0


def test_edit_distance_pads_and_lengths():
    a = np.array([[97, 98, 99, 0], [0, 0, 0, 0], [97, 0, 0, 0]], np.uint8)
    b = np.array([[97, 99, 0, 0], [97, 98, 0, 0], [0, 0, 0, 0]], np.uint8)
    np.testing.assert_array_equal(sn.edit_distance(a, b), [1, 2, 1])


def test_bf16_rounding():
    x = np.array([1.0, 1.0 + 2**-9, 1.0 + 3 * 2**-9, 0.75], np.float32)
    np.testing.assert_array_equal(sn._bf16(x),
                                  [1.0, 1.0, 1.0 + 2**-7, 0.75])


def test_sym_diff():
    a = np.array([1, 3, 5], np.uint64)
    b = np.array([3, 4], np.uint64)
    assert sn.sym_diff(a, b) == 3
    assert sn.sym_diff(a, a) == 0
    assert sn.sym_diff(a, b[:0]) == 3
    pa = sn.pack([1, 2, 9], [2, 7, 4])
    got = {(1, 2), (2, 7), (3, 5)}
    assert sn.sym_diff_set(frozenset(got), np.sort(pa)) == 2
    assert sn.sym_diff_set(frozenset(got), pa[:0]) == 3
    np.testing.assert_array_equal(_packed(got),
                                  np.sort(sn.pack([1, 2, 3], [2, 7, 5])))


def test_reference_equals_the_program_on_the_cpu():
    from repro_torch import api
    from repro_torch.core import entities as E
    cfg = harness.config("pubs-1.4m")
    host = corpus.make(cfg, 11, n=4000)
    res = api.resolve(E.from_numpy(host, "cpu"), harness.er_config(cfg),
                      device="cpu")
    checks = check.compare(host, cfg, res.pairs, res.matches, [],
                           {"blocked_diff": 0, "matched_diff": 0})
    assert checks == {"blocked_diff": (0, 0), "matched_diff": (0, 0)}
    assert len(res.matches) > 0
