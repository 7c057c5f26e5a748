"""Typed result objects + host-side pair extraction (port of
``repro.api.results``; host numpy, but for the device twins of the pair
extraction, ``packed_pairs_device`` and ``unique_packed_device``).

Replaces the raw nested dicts the old pipeline returned: results carry the
pair sets, per-shard load, overflow accounting, and (optionally) blocking
quality metrics computed against the sequential oracle.

Internally pairs travel as PACKED uint64 arrays — ``(lo << 32) | hi`` with
``lo < hi`` eids — deduplicated by ``unique_packed`` (one sort).  Collection is then one
batched nonzero + pack + unique (linear, vectorized) instead of building
millions of Python tuples.  At the public ``RunnerOutcome``/
``BlockingResult`` boundary the arrays become ``PairSet``s: read-only sets
of (lo, hi) tuples that box a pair only when a caller iterates.
"""
from __future__ import annotations

from collections.abc import Set as AbstractSet
from dataclasses import dataclass
from typing import NamedTuple, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch import obs as OBS
from repro_torch.resilience.retry import ResilienceStats

Pair = Tuple[int, int]

PACKED_DTYPE = np.uint64


def pack_pairs(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Elementwise (a, b) eid pairs -> canonical packed uint64
    ``(min << 32) | max``.  Eids must be non-negative and < 2^32."""
    a = np.asarray(a, PACKED_DTYPE)
    b = np.asarray(b, PACKED_DTYPE)
    lo = np.minimum(a, b)
    hi = np.maximum(a, b)
    return (lo << PACKED_DTYPE(32)) | hi


def _drop_repeats(s: np.ndarray) -> np.ndarray:
    """The distinct values of a sorted 1-D array, in order."""
    if s.size < 2:
        return s
    keep = np.empty(s.shape, bool)
    keep[0] = True
    np.not_equal(s[1:], s[:-1], out=keep[1:])
    return s[keep]


def sort_unique(a: np.ndarray) -> np.ndarray:
    """``np.unique(a)`` of a 1-D array (same values, same dtype): one sort
    and a neighbour compare.  Newer numpy releases route ``np.unique`` —
    and with it ``setdiff1d``, ``union1d``, ``intersect1d`` and ``isin`` —
    through a hash table, which measured ~9 s per call on 12.6M pairs
    against under 1 s for the sort (a profile of ``chip_smoke.py``'s main
    path), so the port spells the sort out here and in the sorted set
    operations below."""
    return _drop_repeats(np.sort(np.asarray(a).reshape(-1)))


def unique_packed(packed: np.ndarray) -> np.ndarray:
    """Sorted distinct values of a packed pair array (``sort_unique`` as
    uint64)."""
    return sort_unique(np.asarray(packed, PACKED_DTYPE))


def isin_sorted(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``np.isin(a, b)`` where ``b`` is sorted and distinct (``a`` any 1-D
    array): one ``searchsorted`` of ``a`` into ``b``."""
    a, b = np.asarray(a), np.asarray(b)
    if a.size == 0 or b.size == 0:
        return np.zeros(a.shape, bool)
    i = np.searchsorted(b, a)
    np.minimum(i, b.size - 1, out=i)
    return b[i] == a


def setdiff_sorted(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``np.setdiff1d(a, b)`` for sorted distinct ``a`` and ``b`` (the
    values of ``a`` not in ``b``, in ``a``'s dtype)."""
    a = np.asarray(a)
    return a[~isin_sorted(a, b)]


def intersect_sorted(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``np.intersect1d(a, b)`` for sorted distinct ``a`` and ``b`` of one
    dtype."""
    a = np.asarray(a)
    return a[isin_sorted(a, b)]


def union_sorted(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``np.union1d(a, b)`` for sorted distinct ``a`` and ``b`` of one
    dtype: the two runs merged by one stable sort (a single merge pass
    over two sorted runs) and the values they share dropped."""
    return _drop_repeats(np.sort(np.concatenate([a, b]), kind="stable"))


def unpack_pairs(packed: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Packed uint64 -> (lo, hi) int64 arrays."""
    packed = np.asarray(packed, PACKED_DTYPE)
    lo = (packed >> PACKED_DTYPE(32)).astype(np.int64)
    hi = (packed & PACKED_DTYPE(0xFFFFFFFF)).astype(np.int64)
    return lo, hi


def pack_pair_set(pairs: Set[Pair]) -> np.ndarray:
    """Host pair set -> sorted deduplicated packed array (a ``PairSet``'s
    own array)."""
    if isinstance(pairs, PairSet):
        return pairs.packed
    if not pairs:
        return np.empty((0,), PACKED_DTYPE)
    flat = np.fromiter((c for p in pairs for c in p), np.int64,
                       2 * len(pairs)).reshape(-1, 2)
    return unique_packed(pack_pairs(flat[:, 0], flat[:, 1]))


_EID_LIMIT = 1 << 32
_ITER_BLOCK = 1 << 16


def _eid(x) -> Optional[int]:
    """``x`` as the Python int it equals (a numpy int, a bool, an integral
    float), or None where no int equals it."""
    try:
        i = int(x)
        return i if i == x else None
    except (TypeError, ValueError, OverflowError):
        return None


def _pack_iterable(pairs) -> Tuple[np.ndarray, list]:
    """Any iterable -> (sorted distinct packed array of its canonical
    ``(lo, hi)`` pairs, the items that are not such a pair).  One
    ``fromiter`` over the pairs, packed as they come; the items left over
    are what no ``PairSet`` holds and no member equals: a non-pair,
    ``(hi, lo)``, an eid outside [0, 2^32)."""
    rest = []

    def packed():
        for p in pairs:
            if isinstance(p, tuple) and len(p) == 2:
                a, b = p
                if type(a) is not int or type(b) is not int:
                    a, b = _eid(a), _eid(b)
                    if a is None or b is None:
                        rest.append(p)
                        continue
                if 0 <= a < b < _EID_LIMIT:
                    yield (a << 32) | b
                    continue
            rest.append(p)

    return unique_packed(np.fromiter(packed(), PACKED_DTYPE)), rest


class PairSet(AbstractSet):
    """Immutable set of ``(lo, hi)`` eid tuples held as the sorted distinct
    packed ``uint64`` array the program computed (``.packed``, read-only).

    Behaves as the ``frozenset`` of the same tuples: ``len`` and ``bool``
    are O(1), ``in`` is one ``searchsorted`` (``(hi, lo)`` and non-pairs
    are not members), iteration yields Python-int tuples in ascending
    packed order, ``==`` and ``hash`` agree with the frozenset's, and the
    operators and frozenset method names return a ``PairSet``: between two
    ``PairSet``s on the arrays alone, against any other iterable after one
    packing pass.  Where a result would hold what no ``PairSet`` can (a
    union with ``(hi, lo)``, say), it is a ``frozenset`` instead.  Pairs
    become tuples only while a caller iterates; under an active tracer
    they are counted in its ``pairs_boxed`` counter.  One ``in`` costs a
    few microseconds, more than a frozenset's hash probe: to test many
    pairs, pack them (``pack_pairs``) and test them all at once with
    ``isin_sorted(queries, s.packed)``."""

    __slots__ = ("_a", "_h", "__weakref__")

    def __init__(self, packed: Optional[np.ndarray] = None):
        """``packed``: canonical packed pairs (``lo < hi``), in any order
        and with repeats; held as a sorted, distinct, read-only copy.
        Raises ValueError on a value that packs no canonical pair."""
        a = np.empty((0,), PACKED_DTYPE) if packed is None \
            else np.array(packed, PACKED_DTYPE).reshape(-1)
        if a.size > 1 and not (a[1:] > a[:-1]).all():
            a = unique_packed(a)
        if a.size and not ((a >> np.uint64(32))
                           < (a & np.uint64(_EID_LIMIT - 1))).all():
            raise ValueError("PairSet: a packed value has lo >= hi")
        self._hold(a)

    @classmethod
    def _of(cls, packed: np.ndarray) -> "PairSet":
        """A ``PairSet`` over ``packed``, which must already be sorted,
        distinct and canonical (as from ``unique_packed``), held as a
        read-only view: pass a copy if its owner may write it later."""
        s = cls.__new__(cls)
        s._hold(np.asarray(packed, PACKED_DTYPE).reshape(-1))
        return s

    def _hold(self, a: np.ndarray) -> None:
        a = a.view()
        a.flags.writeable = False
        self._a = a
        self._h = None

    @property
    def packed(self) -> np.ndarray:
        """The sorted distinct packed uint64 array (read-only)."""
        return self._a

    def __len__(self) -> int:
        return self._a.size

    def __contains__(self, item) -> bool:
        if not (isinstance(item, tuple) and len(item) == 2):
            return False
        lo, hi = item
        if type(lo) is not int or type(hi) is not int:
            lo, hi = _eid(lo), _eid(hi)
            if lo is None or hi is None:
                return False
        if not 0 <= lo < hi < _EID_LIMIT:
            return False
        a, v = self._a, PACKED_DTYPE((lo << 32) | hi)
        i = a.searchsorted(v)
        return i < a.size and bool(a[i] == v)

    def __iter__(self):
        a = self._a
        for s in range(0, a.size, _ITER_BLOCK):
            lo, hi = unpack_pairs(a[s:s + _ITER_BLOCK])
            t = OBS.current_tracer()
            if t is not None:
                t.metrics.counter("pairs_boxed").inc(lo.size)
            yield from zip(lo.tolist(), hi.tolist())

    def __repr__(self) -> str:
        if len(self) > 8:
            return f"PairSet(<{len(self)} pairs>)"
        return "PairSet({" + ", ".join(map(repr, self)) + "})" if self \
            else "PairSet()"

    def __reduce__(self):
        return PairSet, (self._a,)

    def __hash__(self) -> int:
        if self._h is None:
            self._h = AbstractSet._hash(self)
        return self._h

    @staticmethod
    def _packed(other) -> Tuple[np.ndarray, list]:
        """``other``'s canonical pairs packed, and its other items."""
        if isinstance(other, PairSet):
            return other._a, []
        return _pack_iterable(other)

    # -- comparisons ------------------------------------------------------

    def __eq__(self, other):
        if isinstance(other, PairSet):
            return np.array_equal(self._a, other._a)
        if not isinstance(other, AbstractSet):
            return NotImplemented
        if len(other) != len(self):
            return False
        o, rest = self._packed(other)
        return not rest and np.array_equal(self._a, o)

    def issubset(self, other) -> bool:
        return bool(isin_sorted(self._a, self._packed(other)[0]).all())

    def issuperset(self, other) -> bool:
        o, rest = self._packed(other)
        return not rest and bool(isin_sorted(o, self._a).all())

    def isdisjoint(self, other) -> bool:
        return not isin_sorted(self._packed(other)[0], self._a).any()

    def _proper_subset(self, other) -> bool:
        o, rest = self._packed(other)
        return bool(isin_sorted(self._a, o).all()) and \
            (bool(rest) or o.size > self._a.size)

    def _proper_superset(self, other) -> bool:
        o, rest = self._packed(other)
        return not rest and o.size < self._a.size and \
            bool(isin_sorted(o, self._a).all())

    # -- set algebra --------------------------------------------------------

    def union(self, *others):
        out, rest = self._a, []
        for other in others:
            o, r = self._packed(other)
            out = union_sorted(out, o)
            rest += r
        return frozenset(PairSet._of(out)).union(rest) if rest else PairSet._of(out)

    def intersection(self, *others):
        out = self._a
        for other in others:
            out = intersect_sorted(out, self._packed(other)[0])
        return PairSet._of(out)

    def difference(self, *others):
        out = self._a
        for other in others:
            out = setdiff_sorted(out, self._packed(other)[0])
        return PairSet._of(out)

    def symmetric_difference(self, other):
        o, rest = self._packed(other)
        out = PairSet._of(union_sorted(setdiff_sorted(self._a, o),
                                   setdiff_sorted(o, self._a)))
        return frozenset(out).union(rest) if rest else out

    def copy(self) -> "PairSet":
        return self

    def _rdifference(self, other):
        """``other - self``."""
        o, rest = self._packed(other)
        out = PairSet._of(setdiff_sorted(o, self._a))
        return frozenset(out).union(rest) if rest else out

    def _operator(method):
        def op(self, other):
            return method(self, other) if isinstance(other, AbstractSet) \
                else NotImplemented
        return op

    __le__ = _operator(issubset)
    __lt__ = _operator(_proper_subset)
    __ge__ = _operator(issuperset)
    __gt__ = _operator(_proper_superset)
    __or__ = __ror__ = _operator(union)
    __and__ = __rand__ = _operator(intersection)
    __xor__ = __rxor__ = _operator(symmetric_difference)
    __sub__ = _operator(difference)
    __rsub__ = _operator(_rdifference)
    del _operator


def packed_to_frozenset(packed: np.ndarray) -> AbstractSet[Pair]:
    """Packed array -> the public pair set: a ``PairSet`` over the array,
    which boxes no pair until a caller iterates it.  The name is kept from
    when this built a ``frozenset``; so is its ``frozensets`` span, which
    also registers the active tracer's ``pairs_boxed`` counter."""
    with OBS.span("frozensets", pairs=len(packed)):
        t = OBS.current_tracer()
        if t is not None:
            t.metrics.counter("pairs_boxed")
        return PairSet._of(packed)


class CollectedPairs(NamedTuple):
    """Deduplicated packed uint64 pair arrays (see ``pack_pairs``)."""
    blocked: np.ndarray
    matched: np.ndarray


@dataclass(frozen=True)
class BalanceMetrics:
    """Planned vs realized per-shard load under a ShardPlan (skew
    telemetry: wall-clock is the MAX of
    per-shard matcher work, so the imbalance ratio max/mean is the direct
    parallel-efficiency loss).

    planned_*            what the partition planner promised (profile-based)
    realized_*           what the run delivered (post-shuffle valid counts;
                         comparisons re-derived through the window cost
                         model from the realized contiguous rank layout)
    imbalance_*          max/mean of per-shard comparison counts (1.0 =
                         perfectly level)
    straggler_shard      shard id with the largest realized comparison load
    halo_entities        total entities replicated across boundaries
    cap_link             planned per-(mapper, dest) shuffle capacity
                         (None: capacity derived from cfg.cap_factor)
    """
    partitioner: str
    planned_load: Tuple[int, ...]
    realized_load: Tuple[int, ...]
    planned_comparisons: Tuple[int, ...]
    realized_comparisons: Tuple[int, ...]
    imbalance_planned: float
    imbalance_realized: float
    straggler_shard: int
    halo_entities: int
    cap_link: Optional[int] = None


@dataclass(frozen=True)
class PerfStats:
    """Execution-cache telemetry for one ``resolve``/``link`` call
    (``repro_torch.perf``: on the card an executable is a captured CUDA
    graph).

    cache_hits      executables reused from the cache (graph replays)
    cache_misses    executables built by this call
    traces          first runs / graph captures actually performed (a
                    healthy cache has traces == cache_misses)
    cache_entries   total executables resident after the call
    """
    cache_hits: int
    cache_misses: int
    traces: int
    cache_entries: int

    @property
    def steady_state(self) -> bool:
        """True when the call ran entirely from cached executables — at
        least one hit and no build/trace.  A bypassed cache (jit_cache=
        False) reports all-zero counters and is NOT steady state: it ran
        every program eagerly."""
        return self.cache_hits > 0 and self.traces == 0 and \
            self.cache_misses == 0


@dataclass(frozen=True)
class ERMetrics:
    """Blocking quality vs the sequential-SN oracle (the standard blocking
    metrics; the paper reports |B| and completeness of the variants).

    reduction_ratio     1 - |blocked| / |all comparable pairs|
    pairs_completeness  |blocked ∩ oracle| / |oracle|
    balance             planned-vs-realized shard load (profile-backed runs)
    resilience          overflow-recovery telemetry (retries / escalations /
                        final caps — DESIGN.md §11)
    """
    reduction_ratio: float
    pairs_completeness: float
    oracle_pairs: int
    total_comparisons: int
    balance: Optional[BalanceMetrics] = None
    resilience: Optional[ResilienceStats] = None
    quality: Optional[object] = None  # quality.QualityMetrics vs gold
    #                                   pairs (quality.attach)


@dataclass(frozen=True)
class BlockingResult:
    """Outcome of the blocking stage (candidate generation)."""
    pairs: AbstractSet[Pair]        # blocked (candidate) pairs, (lo, hi) eids
    load: Tuple[int, ...]           # per-shard valid counts (skew telemetry)
    overflow: int                   # entities dropped by capacity limits
    variant: str
    runner: str
    window: int
    num_shards: int
    cand_count: Tuple[int, ...] = ()  # per-shard gate survivors (pallas)
    cand_overflow: int = 0          # cascade survivors dropped by cand_cap
    matcher_evals: int = 0          # full-cascade evaluations actually run
    pair_overflow: int = 0          # emitted pair-index slots dropped by
    #                                 pair_cap (emit="pairs"; can lose
    #                                 blocked pairs AND matches — counted,
    #                                 never silent)
    pruned: int = 0                 # band slots dropped by meta-blocking
    #                                 comparison pruning (prune_policy=
    #                                 "evidence"): deliberate low-evidence
    #                                 filtering, accounted like overflow but
    #                                 never retried

    @property
    def max_load(self) -> int:
        """Largest per-shard valid count — the straggler's load (wall-clock
        scales with this, not the mean)."""
        return max(self.load) if self.load else 0

    @property
    def total_load(self) -> int:
        """Sum of per-shard valid counts (== entities that survived the
        shuffle; compare with the input n to spot capacity overflow)."""
        return sum(self.load)


@dataclass(frozen=True)
class ERResult:
    """Full entity-resolution outcome: blocking + matching (+ metrics).

    ``balance`` is populated whenever the run executed under a profile-
    backed ShardPlan (any ``cfg.partitioner`` default-bounds run); runs on
    explicit raw bounds have no plan to compare against and carry None."""
    blocking: BlockingResult
    matches: AbstractSet[Pair]      # matcher-accepted pairs
    metrics: Optional[ERMetrics] = None
    balance: Optional[BalanceMetrics] = None
    perf: Optional[PerfStats] = None  # executable-cache telemetry for this
    #                                   call (hits / misses / traces)
    resilience: Optional[ResilienceStats] = None  # overflow-recovery
    #                                   telemetry (retries / escalations /
    #                                   final caps — DESIGN.md §11)
    trace: Optional[object] = None  # repro_torch.obs.TraceReport when
    #                                 the run executed under trace=True

    @property
    def pairs(self) -> AbstractSet[Pair]:
        """The blocked (candidate) pair set — sugar for blocking.pairs."""
        return self.blocking.pairs


@dataclass(frozen=True)
class MultiPassResult:
    """Outcome of a multi-pass run (``ERConfig.passes`` non-empty).

    One full ER pipeline execution per ``SortKeySpec``; the top-level
    ``blocking``/``matches`` hold the UNION across passes, while ``passes``
    keeps each pass's complete single-pass ``ERResult``.  The union
    ``blocking`` sums overflow / cand_overflow / pair_overflow /
    matcher_evals / pruned and leaves ``load`` empty (per-pass shard loads
    live on ``passes[i].blocking.load``).  ``metrics`` (when requested)
    compares the union pair set against the union of the per-pass
    sequential oracles."""
    passes: Tuple[ERResult, ...]
    pass_names: Tuple[str, ...]
    blocking: BlockingResult
    matches: AbstractSet[Pair]
    metrics: Optional[ERMetrics] = None
    resilience: Optional[ResilienceStats] = None  # summed across passes
    trace: Optional[object] = None  # repro_torch.obs.TraceReport spanning
    #                                 every pass (trace=True)

    @property
    def pairs(self) -> AbstractSet[Pair]:
        """The union blocked pair set — sugar for blocking.pairs."""
        return self.blocking.pairs

    def pass_result(self, name: str) -> ERResult:
        """The single-pass ERResult for the pass named ``name``."""
        try:
            return self.passes[self.pass_names.index(name)]
        except ValueError:
            raise KeyError(f"no pass named {name!r}; passes: "
                           f"{self.pass_names}") from None


# -- pair extraction (band mask -> host pairs) --------------------------------------

def _host(x) -> np.ndarray:
    """An array, or a tensor on any device, as a host numpy array."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") \
        else np.asarray(x)


def packed_pairs_from_idx(part: dict, field: str = "match") -> np.ndarray:
    """Device-emitted packed indices -> deduplicated packed pair array.

    ``part``: stacked per-shard output with ``eid`` (r, M) plus the emitted
    buffers ``<field>_idx`` (r, cap) int32 flat band indices ``(d-1)*M+i``
    and ``<field>_n`` (r,) valid counts (window.emit_band_indices).  Eid
    translation is vectorized: one mask + two fancy gathers + ``unique_packed``
    over ~cap slots instead of an O(r*w*M) band scan."""
    eid = _host(part["eid"] if "eid" in part
                else part["ents"]["eid"])                 # (r, M)
    idx = _host(part[field + "_idx"])                     # (r, cap)
    cnt = _host(part[field + "_n"]).reshape(-1)           # (r,)
    m = eid.shape[1]
    keep = np.arange(idx.shape[1])[None, :] < cnt[:, None]
    ss, pp = np.nonzero(keep)
    if ss.size == 0:
        return np.empty((0,), PACKED_DTYPE)
    flat = idx[ss, pp].astype(np.int64)
    d = flat // m + 1
    i = flat % m
    a = eid[ss, i]
    b = eid[ss, i + d]              # in-bounds: band masks force i + d < M
    return unique_packed(pack_pairs(a, b))


def packed_pairs_from_part(part: dict, field: str = "match") -> np.ndarray:
    """Collect a part through whichever representation it carries:
    device-emitted index buffers (emit="pairs") or boolean bands."""
    if field + "_idx" in part:
        return packed_pairs_from_idx(part, field)
    return packed_pairs_from_band(part, field)


def packed_pairs_from_band(part: dict, field: str = "match") -> np.ndarray:
    """Vectorized band -> deduplicated packed pair array (the hot host path).

    ``part``: stacked per-shard output dict with ``ents`` (eid: (r, M)) and a
    boolean band ``field`` of shape (r, w-1, M); band[s, d-1, i] pairs slot i
    with slot i+d of shard s.  One batched nonzero + pack + ``unique_packed`` —
    no Python pair objects anywhere on the path."""
    eid = _host(part["ents"]["eid"])                      # (r, M)
    band = _host(part[field])                             # (r, w-1, M)
    ss, ds, iis = np.nonzero(band)
    if ss.size == 0:
        return np.empty((0,), PACKED_DTYPE)
    a = eid[ss, iis]
    b = eid[ss, iis + ds + 1]       # in-bounds: masks force i + d < M
    return unique_packed(pack_pairs(a, b))


# -- the same extraction where the runner's output lives (torch) -------------

def packed_pairs_device(part: dict, field: str = "match") -> torch.Tensor:
    """``packed_pairs_from_part`` on the part's own device, before the
    dedup: the packed pairs of every valid slot as int64 (repeats kept).
    Eids are non-negative int32, so each value is below 2^63 and the int64
    order is the uint64 order.  Index buffers are cut to their longest
    valid prefix (``_n``), as ``runners._to_host`` cuts them."""
    eid = part["eid"] if "eid" in part else part["ents"]["eid"]   # (r, M)
    m = eid.shape[-1]
    eid = eid.reshape(-1)
    if field + "_idx" in part:
        cnt = part[field + "_n"].reshape(-1)                      # (r,)
        used = int(cnt.max()) if cnt.numel() else 0
        ss, pp = (torch.arange(used, device=eid.device) < cnt[:, None]) \
            .nonzero(as_tuple=True)
        flat = part[field + "_idx"][ss, pp].to(torch.int64)
        d0 = flat.div(m, rounding_mode="floor")         # d - 1
        ia = flat.remainder_(m).add_(ss.mul_(m))        # s*M + i
    else:
        ss, d0, ii = torch.nonzero(part[field], as_tuple=True)
        ia = ss.mul_(m).add_(ii)
    a = eid[ia]
    b = eid[ia.add_(d0).add_(1)]    # in-bounds: band masks force i + d < M
    return torch.minimum(a, b).to(torch.int64).bitwise_left_shift_(32) \
        .bitwise_or_(torch.maximum(a, b))


def unique_packed_device(packed: torch.Tensor) -> np.ndarray:
    """``unique_packed`` of an int64 packed tensor, sorted and deduplicated
    on its device, then copied to the host once as uint64."""
    uniq = torch.unique_consecutive(torch.sort(packed).values)
    return uniq.cpu().numpy().view(PACKED_DTYPE)


def pairs_from_band(part: dict, field: str = "match") -> Set[Pair]:
    """Band -> Python pair set: the public surface of
    ``packed_pairs_from_band`` (the collection hot path)."""
    return set(packed_to_frozenset(packed_pairs_from_band(part, field)))


def compute_metrics(blocked: AbstractSet[Pair], oracle: Set[Pair],
                    total_comparisons: int) -> ERMetrics:
    """Standard blocking-quality metrics of ``blocked`` against the
    sequential-SN ``oracle`` pair set: reduction ratio = 1 − |blocked| /
    ``total_comparisons`` (the full comparison space) and pairs
    completeness = |blocked ∩ oracle| / |oracle| (1.0 when no oracle pair
    was lost; degenerate inputs score 1.0 by convention)."""
    n_oracle = len(oracle)
    pc = 1.0 if n_oracle == 0 else len(blocked & oracle) / n_oracle
    rr = 1.0 if total_comparisons <= 0 else \
        1.0 - len(blocked) / total_comparisons
    return ERMetrics(reduction_ratio=rr, pairs_completeness=pc,
                     oracle_pairs=n_oracle,
                     total_comparisons=total_comparisons)
