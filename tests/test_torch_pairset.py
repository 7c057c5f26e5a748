"""The port's public pair set, ``PairSet`` (``repro_torch.api.results``),
held to the ``frozenset`` of (lo, hi) tuples built from the same sorted
packed array, on the CPU.

  * random packed arrays, the empty set, one pair and eids near 2^32 - 1:
    ``==``, ``!=`` and ``hash`` both ways, ``len``/``bool``, ``in`` (members,
    ``(hi, lo)``, numpy-int tuples, non-pairs), iteration order and the
    Python ``int``s it yields, a pickle round trip, the read-only array,
    the public constructor (sorts, drops repeats, copies, refuses a
    non-canonical pair) and weak references
  * every operator (and its reflected form) and every frozenset method
    name against a ``frozenset``, a ``set``, a ``PairSet``, a bare ``zip``
    iterator and a set holding items no ``PairSet`` can (``(hi, lo)``,
    non-pairs), each result checked against the frozenset's
  * the ``pairs_boxed`` counter: 0 through a traced resolve and a traced
    stream read only by their sizes, ``len`` of the set after one
    iteration
  * the benchmark's ``correct`` check (``erbench.reference``) gives the
    same values for a ``PairSet`` as for the frozenset of its pairs
"""
import gc
import json
import operator
import pickle
import weakref
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import api as TA  # noqa: E402
from repro_torch import obs as TO  # noqa: E402
from repro_torch import stream as TS  # noqa: E402
from repro_torch.api.results import (PairSet, pack_pairs,  # noqa: E402
                                     unique_packed, unpack_pairs)
from repro_torch.core import entities as TE  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOP = 2**32 - 1


def _packed(rng, n, lo, hi):
    a = rng.integers(lo, hi + 1, n)
    b = rng.integers(lo, hi + 1, n)
    keep = a != b
    return unique_packed(pack_pairs(a[keep], b[keep]))


def _frozen(packed):
    lo, hi = unpack_pairs(packed)
    return frozenset(zip(lo.tolist(), hi.tolist()))


def _cases():
    """name -> (the set's packed array, another that overlaps it)."""
    rng = np.random.default_rng(29)
    out = {"empty": (np.empty((0,), np.uint64), _packed(rng, 5, 0, 9)),
           "one": (pack_pairs(np.array([3]), np.array([7])),
                   unique_packed(pack_pairs(np.array([3, 1]),
                                            np.array([7, 2]))))}
    for name, n, lo, hi in (("dense", 60, 0, 30), ("random", 3000, 0, 10**6),
                            ("top", 400, TOP - 40, TOP)):
        a = _packed(rng, n, lo, hi)
        b = unique_packed(np.concatenate(
            [a[rng.random(a.size) < 0.5], _packed(rng, n // 2, lo, hi)]))
        out[name] = (a, b)
    return out


CASES = _cases()


def _others(b):
    """kind -> a fresh ``other`` built from the packed array ``b``."""
    lo, hi = unpack_pairs(b)
    return {
        "frozenset": lambda: _frozen(b),
        "set": lambda: set(_frozen(b)),
        "PairSet": lambda: PairSet(b),
        "zip": lambda: zip(lo.tolist(), hi.tolist()),
        "foreign": lambda: set(_frozen(b)) | {(9, 4), "ab", (1, 2, 3),
                                              (TOP + 1, TOP + 2), (-1, 5)},
    }


KINDS = ("frozenset", "set", "PairSet", "zip", "foreign")
SETS = {"frozenset", "set", "PairSet", "foreign"}


def _same(got, want, where):
    if isinstance(want, bool):
        assert type(got) is bool and got == want, where
        return
    assert isinstance(want, frozenset)
    assert frozenset(got) == want, where
    assert got == want and want == got, where
    if all(isinstance(p, tuple) and len(p) == 2 and 0 <= p[0] < p[1] <= TOP
           for p in want):
        assert isinstance(got, PairSet), where


# -- equality, hash, membership, iteration -----------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_equal_and_hash_both_ways(case):
    a, b = CASES[case]
    ps, fs = PairSet(a), _frozen(a)
    for other in (fs, set(fs), PairSet(a.copy())):
        assert ps == other and other == ps
        assert not (ps != other) and not (other != ps)
    assert hash(ps) == hash(fs) == hash(ps)
    assert len(ps) == len(fs) and bool(ps) == bool(fs)
    differ = _frozen(b)
    assert (ps == differ) == (fs == differ) == (differ == ps)
    assert (ps != differ) == (fs != differ) == (differ != ps)
    assert (ps == PairSet(b)) == (fs == differ)
    assert ps != list(fs) and not ps == None  # noqa: E711
    assert ps != fs | {(5, 2)} and fs | {(5, 2)} != ps


@pytest.mark.parametrize("case", sorted(CASES))
def test_membership(case):
    a, b = CASES[case]
    ps, fs = PairSet(a), _frozen(a)
    for lo, hi in sorted(fs | _frozen(b)):
        assert ((lo, hi) in ps) == ((lo, hi) in fs)
        assert (hi, lo) not in ps and (hi, lo) not in fs
        for cast in (np.int64, np.uint64, np.uint32, float):
            assert ((cast(lo), cast(hi)) in ps) == ((lo, hi) in fs)
    for item in ("ab", (1,), (1, 2, 3), None, 7, (0.5, 2), ("1", "2"),
                 (-1, 3), (TOP, TOP + 1), (1 << 70, 1 << 71)):
        assert item not in ps and item not in fs
    for item in ([3, 7], np.array([3, 7]), {3: 7}):   # unhashable pairs
        assert item not in ps


@pytest.mark.parametrize("case", sorted(CASES))
def test_iteration_order_and_types(case):
    a, _ = CASES[case]
    got = list(PairSet(a))
    assert got == sorted(_frozen(a))
    assert all(type(lo) is int and type(hi) is int for lo, hi in got)
    lo, hi = unpack_pairs(a)
    assert got == list(zip(lo.tolist(), hi.tolist()))


@pytest.mark.parametrize("case", sorted(CASES))
def test_pickle_round_trip(case):
    ps = PairSet(CASES[case][0])
    back = pickle.loads(pickle.dumps(ps))
    assert type(back) is PairSet and back == ps and hash(back) == hash(ps)
    assert np.array_equal(back.packed, ps.packed)
    assert not back.packed.flags.writeable


@pytest.mark.parametrize("case", sorted(CASES))
def test_array_is_read_only(case):
    a, _ = CASES[case]
    src = a.copy()
    ps = PairSet(src)
    assert ps.packed.dtype == np.uint64 and np.array_equal(ps.packed, a)
    assert not ps.packed.flags.writeable
    with pytest.raises(ValueError):
        ps.packed[:1] = 0
    assert ps.copy() is ps


@pytest.mark.parametrize("case", sorted(CASES))
def test_constructor_sorts_dedups_and_copies(case):
    a, _ = CASES[case]
    rng = np.random.default_rng(7)
    src = rng.permutation(np.concatenate([a, a[: a.size // 2]]))
    ps = PairSet(src)
    assert np.array_equal(ps.packed, a) and ps == _frozen(a)
    src[:] = 0
    assert np.array_equal(ps.packed, a)
    if a.size:
        assert type(ps.__contains__(tuple(next(iter(ps))))) is bool


@pytest.mark.parametrize("lo, hi", [(7, 3), (5, 5), (TOP, 0)])
def test_constructor_refuses_a_non_canonical_pair(lo, hi):
    bad = np.array([(lo << 32) | hi], np.uint64)
    with pytest.raises(ValueError):
        PairSet(np.concatenate([CASES["one"][0], bad]))


@pytest.mark.parametrize("case", sorted(CASES))
def test_weak_reference(case):
    ps = PairSet(CASES[case][0])
    ref = weakref.ref(ps)
    assert ref() is ps
    del ps
    gc.collect()
    assert ref() is None


# -- set algebra --------------------------------------------------------------

BINARY = {"|": operator.or_, "&": operator.and_, "-": operator.sub,
          "^": operator.xor, "<=": operator.le, "<": operator.lt,
          ">=": operator.ge, ">": operator.gt}
METHODS = ("union", "intersection", "difference", "symmetric_difference",
           "issubset", "issuperset", "isdisjoint")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("op", sorted(BINARY))
def test_operator(op, kind):
    fn = BINARY[op]
    for case, (a, b) in CASES.items():
        other = _others(b)[kind]
        ps, fs = PairSet(a), _frozen(a)
        where = (case, op, kind)
        if kind not in SETS:
            with pytest.raises(TypeError):
                fn(fs, other())
            with pytest.raises(TypeError):
                fn(ps, other())
            continue
        o = other()
        _same(fn(ps, o), fn(fs, frozenset(o)), where)
        _same(fn(o, ps), fn(frozenset(o), fs), where + ("reflected",))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("method", METHODS)
def test_method(method, kind):
    for case, (a, b) in CASES.items():
        other = _others(b)[kind]
        ps, fs = PairSet(a), _frozen(a)
        _same(getattr(ps, method)(other()), getattr(fs, method)(other()),
              (case, method, kind))


@pytest.mark.parametrize("method", ("union", "intersection", "difference"))
def test_method_many_others(method):
    for case, (a, b) in CASES.items():
        others = _others(b)
        args = lambda: (others["zip"](), others["PairSet"](),
                        _frozen(a[::2]))
        ps, fs = PairSet(a), _frozen(a)
        _same(getattr(ps, method)(*args()), getattr(fs, method)(*args()),
              (case, method))
        _same(getattr(ps, method)(), getattr(fs, method)(), (case, method))


# -- the counter --------------------------------------------------------------

N, R, W, CHUNK = 480, 4, 6, 120


@pytest.fixture(scope="module")
def host():
    ents = TE.synth_entities(np.random.default_rng(290), N, n_keys=60,
                             dup_frac=0.25, text_len=8)
    return TE.to_host(ents)


def _cfg(**kw):
    return TA.ERConfig(window=W, num_shards=R, variant="repsn", hops=R - 1,
                       runner="vmap", **kw)


def _boxed(tracer):
    return tracer.metrics.to_dict()["pairs_boxed"]["value"]


def _resolve(host):
    return TA.resolve(TE.from_numpy(host, "cpu"), _cfg(trace=True),
                      device="cpu")


def _stream(host):
    chunks = [TE.host_take(host, slice(s, s + CHUNK))
              for s in range(0, N, CHUNK)]
    return TS.resolve_stream(iter(chunks), _cfg(trace=True),
                             chunk_size=CHUNK, device="cpu")


@pytest.mark.parametrize("run", [_resolve, _stream], ids=["resolve", "stream"])
def test_pairs_boxed_counts_only_iteration(host, run):
    own = run(host)                 # the run's own trace: sizes only
    assert own.trace.registry["pairs_boxed"]["value"] == 0
    tracer = TO.Tracer()
    with TO.activate(tracer):
        res = run(host)
        sizes = len(res.pairs), len(res.matches)
        assert _boxed(tracer) == 0
        assert sizes[0] > 0 and isinstance(res.pairs, PairSet)
        walked = sum(1 for _ in res.pairs)
        assert walked == len(res.pairs) == _boxed(tracer)
    assert res.pairs == own.pairs and res.matches == own.matches
    sum(1 for _ in res.matches)     # no tracer active: nothing counted
    assert _boxed(tracer) == len(res.pairs)


# -- the benchmark's check ----------------------------------------------------

SEED = 2**31 + 2929


@pytest.fixture(scope="module")
def bench():
    from erbench.data import corpus
    from erbench.reference import sn
    config = json.loads((ROOT / "erbench/configs/pubs-1.4m.json").read_text())
    limits = json.loads(
        (ROOT / "erbench/limits/pubs-1.4m.resolve.json").read_text())
    host = corpus.make(config, SEED, n=600)
    ref = sn.resolve(host, config["er"]["window"], config["matcher"])
    return config, limits, host, ref


@pytest.fixture(scope="module")
def answers(bench):
    from erbench.harness import er_config
    config, _, host, (ref_b, ref_m) = bench
    rng = np.random.default_rng(2929)
    extra = _packed(rng, 6, 0, 599)
    off = lambda r: unique_packed(np.concatenate(
        [r[rng.random(r.size) < 0.95], extra]))
    res = TA.resolve(TE.from_numpy(host, "cpu"), er_config(config),
                     device="cpu")
    return {"reference": (PairSet(ref_b), PairSet(ref_m)),
            "altered": (PairSet(off(ref_b)), PairSet(off(ref_m))),
            "port": (res.pairs, res.matches)}


@pytest.mark.parametrize("answer", ["reference", "altered", "port"])
def test_check_reads_a_pairset_as_its_frozenset(bench, answers, answer):
    from erbench.reference import check, sn
    config, limits, host, (ref_b, ref_m) = bench
    blocked, matched = answers[answer]
    assert isinstance(blocked, PairSet)
    fb, fm = frozenset(blocked), frozenset(matched)
    for got, frozen, ref in ((blocked, fb, ref_b), (matched, fm, ref_m)):
        want = sn.sym_diff(got.packed, ref)
        assert sn.sym_diff_set(got, ref) == sn.sym_diff_set(frozen, ref) \
            == want
    counts = [(len(blocked), len(matched))] * 3
    assert check.compare(host, config, blocked, matched, counts, limits) \
        == check.compare(host, config, fb, fm, counts, limits)
    if answer == "altered":
        assert check.compare(host, config, blocked, matched, counts,
                             limits)["blocked_diff"][0] > 0
