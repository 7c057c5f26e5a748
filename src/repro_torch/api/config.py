"""ERConfig — the single frozen configuration for an entity-resolution run
(port of ``repro.api.config``).

The port accepts every field and every config string of the reference and
repeats its validation, so one kwargs dict builds both packages' configs
(``matcher`` may be either package's cascade: it is converted to this
package's ``CascadeMatcher``).  ``runner="shard_map"`` runs one shard
per rank of a ``torch.distributed`` process group (``api.ShardMapRunner``).
``jit_cache`` routes the device runners' shard programs through the
port's executable cache (``repro_torch.perf``: CUDA graphs on the card);
``band_interpret`` steers the reference's Pallas interpreter, which the
port does not have: it is accepted and has no effect.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

from repro_torch.core.match import (CascadeMatcher, as_matcher,
                                    default_matcher)

VARIANTS = ("srp", "repsn", "jobsn")
RUNNERS = ("sequential", "vmap", "shard_map")
# legacy boundary derivations + the built-in profile planners (any name
# registered with balance.register_partitioner is accepted too)
PARTITIONERS = ("balanced", "range", "sample",
                "uniform", "blocksplit", "pairrange")
BAND_ENGINES = ("scan", "pallas")
EMIT_MODES = ("band", "pairs")
SORT_KEY_KINDS = ("identity", "prefix", "word")
OVERFLOW_POLICIES = ("count", "retry", "raise")
WINDOW_POLICIES = ("fixed", "adaptive")
PRUNE_POLICIES = ("off", "evidence")


@dataclass(frozen=True)
class SortKeySpec:
    """One blocking pass of multi-pass SN: how the sort key is derived.

    Multi-pass Sorted Neighborhood (Papadakis et al., arXiv:1905.06167 —
    the standard recall lever over single-key SN) runs the whole blocking
    workflow once per sort key and unions the pair sets.  A spec names one
    derivation, resolved by ``core.keys.derive_sort_key``:

      kind="identity"  use the entity's own ``key`` field (source="key") or
                       a 1-D integer payload field named by ``source``
      kind="prefix"    pack ``width`` characters of the padded-byte payload
                       field ``source``, starting at ``offset``
                       (``core.keys.prefix_key`` — the paper's "first
                       letters of the title" key family; shifting ``offset``
                       per pass is the classic multi-pass choice)
      kind="word"      column ``index`` of a 2-D integer payload field
                       ``source`` (e.g. one word of the bit-packed trigram
                       signature), masked into the int32 key space

    Derived keys are always non-negative int32 < 2^30 (the entities.py key
    schema).  Specs are frozen/hashable; ``name`` labels the pass in
    ``MultiPassResult``.
    """
    name: str = "key"
    source: str = "key"
    kind: str = "identity"
    offset: int = 0
    width: int = 2
    index: int = 0

    def __post_init__(self):
        if self.kind not in SORT_KEY_KINDS:
            raise ValueError(f"unknown sort-key kind {self.kind!r}; choose "
                             f"from {SORT_KEY_KINDS}")
        if self.kind == "prefix" and not 1 <= self.width <= 5:
            raise ValueError(f"prefix width must be in 1..5 (int32 key "
                             f"space), got {self.width}")
        if self.offset < 0 or self.index < 0:
            raise ValueError("offset/index must be >= 0")
        # parameters that would be silently ignored are rejected — a pass
        # with a mis-applied offset/index quietly derives the WRONG key
        if self.kind != "prefix" and self.offset:
            raise ValueError(f"offset only applies to kind='prefix' "
                             f"(got kind={self.kind!r})")
        if self.kind != "word" and self.index:
            raise ValueError(f"index only applies to kind='word' "
                             f"(got kind={self.kind!r})")


@dataclass(frozen=True)
class ERConfig:
    """Frozen configuration for ``repro_torch.api.resolve``.

    The fields, their defaults and their validation are the reference's
    (``repro.api.config.ERConfig`` documents each).  What they do here:

      window, variant, hops, cap_factor, matcher, return_scores
                   blocking and matching (paper §4), as in the reference
      band_engine  "scan" (w-1 full-matcher passes, the oracle) | "pallas"
                   (the fused cheap-band CUDA kernel -> cumsum candidate
                   compaction -> expensive matcher on survivors only)
      band_block   only its contract window-1 <= band_block is kept
      cand_cap, emit, pair_cap, on_overflow, retry_limit
                   capacities, device-side pair emission and the overflow
                   ladder, as in the reference (None caps auto-size)
      runner       "sequential" (host oracle) | "vmap" (r shards on one
                   device, as an explicit shard dim) | "shard_map" (one
                   shard per rank of a ``torch.distributed`` process group)
      num_shards, partitioner (legacy "balanced" | "range" | "sample",
                   the planners "uniform" | "blocksplit" | "pairrange", or
                   a registered planner), linkage, compute_metrics
      passes       multi-pass blocking: one resolve per SortKeySpec and
                   the union (a ``MultiPassResult``)
      window_policy, window_max
                   "adaptive" grows each entity's window from ``window``
                   to its key block's density, capped at ``window_max``
      trace        record a span/metrics ``TraceReport`` and attach it
                   as ``result.trace`` (resolve / link / resolve_stream /
                   link_stream; a served config keeps one tracer for the
                   service's lifetime, read by ``trace_report()``).
                   Excluded from ``static_fingerprint``
      prune_policy, prune_threshold
                   evidence pruning, as in the reference
      band_interpret
                   no effect (no Pallas interpreter)
      jit_cache    route the device runners' shard programs (and the
                   sequential scorer) through the ``repro_torch.perf``
                   executable cache: captured once as a CUDA graph on the
                   card and replayed; built once and run eagerly on the
                   CPU.  False runs every program eagerly
    """
    window: int = 10
    variant: str = "repsn"
    hops: int = 1
    cap_factor: float = 0.0
    matcher: CascadeMatcher = field(default_factory=default_matcher)
    return_scores: bool = False

    band_engine: str = "scan"
    band_block: int = 256
    cand_cap: Optional[int] = None
    band_interpret: Optional[bool] = None

    emit: str = "band"
    pair_cap: Optional[int] = None
    jit_cache: bool = True

    on_overflow: str = "count"
    retry_limit: int = 3

    runner: str = "vmap"
    num_shards: int = 8
    partitioner: str = "balanced"

    linkage: bool = False
    compute_metrics: bool = False
    passes: Tuple[SortKeySpec, ...] = ()

    trace: bool = False

    window_policy: str = "fixed"
    window_max: int = 0
    prune_policy: str = "off"
    prune_threshold: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "matcher", as_matcher(self.matcher))
        if not isinstance(self.passes, tuple) or any(
                not isinstance(p, SortKeySpec) for p in self.passes):
            raise ValueError("passes must be a tuple of SortKeySpec")
        if len({p.name for p in self.passes}) != len(self.passes):
            raise ValueError("pass names must be unique")
        if self.window < 2:
            raise ValueError(f"window must be >= 2, got {self.window}")
        if self.runner not in RUNNERS:
            raise ValueError(f"unknown runner {self.runner!r}; "
                             f"choose from {RUNNERS}")
        if self.partitioner not in PARTITIONERS:
            # planners registered via balance.register_partitioner are
            # first-class citizens of the config surface
            from repro_torch.balance.planners import available_partitioners
            if self.partitioner not in available_partitioners():
                raise ValueError(
                    f"unknown partitioner {self.partitioner!r}; choose from "
                    f"{PARTITIONERS} or a registered planner "
                    f"({available_partitioners()})")
        if self.num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {self.num_shards}")
        if self.band_engine not in BAND_ENGINES:
            raise ValueError(f"unknown band engine {self.band_engine!r}; "
                             f"choose from {BAND_ENGINES}")
        if self.band_block < 1:
            raise ValueError(f"band_block must be >= 1, got {self.band_block}")
        if self.cand_cap is not None and self.cand_cap < 0:
            raise ValueError(f"cand_cap must be >= 0 (0 = unbounded, "
                             f"None = auto), got {self.cand_cap}")
        if self.emit not in EMIT_MODES:
            raise ValueError(f"unknown emit mode {self.emit!r}; choose from "
                             f"{EMIT_MODES}")
        if self.pair_cap is not None and self.pair_cap < 0:
            raise ValueError(f"pair_cap must be >= 0 (0 = full band, never "
                             f"overflows; None = auto), got {self.pair_cap}")
        if self.on_overflow not in OVERFLOW_POLICIES:
            raise ValueError(f"unknown on_overflow policy "
                             f"{self.on_overflow!r}; choose from "
                             f"{OVERFLOW_POLICIES}")
        if self.retry_limit < 0:
            raise ValueError(f"retry_limit must be >= 0, "
                             f"got {self.retry_limit}")
        if self.emit == "pairs" and self.return_scores:
            raise ValueError(
                "emit='pairs' transfers packed pair indices instead of "
                "bands, so per-slot scores are not materialized on host; "
                "use emit='band' with return_scores=True")
        if self.window_policy not in WINDOW_POLICIES:
            raise ValueError(f"unknown window_policy {self.window_policy!r}; "
                             f"choose from {WINDOW_POLICIES}")
        if self.window_policy == "adaptive":
            if self.linkage:
                raise ValueError(
                    "window_policy='adaptive' does not support linkage "
                    "mode (the dual-source oracle has no per-entity "
                    "window form yet); use a fixed window")
            if self.window_max < self.window:
                raise ValueError(
                    f"window_policy='adaptive' needs window_max >= window "
                    f"(the per-entity effective window grows FROM window UP "
                    f"TO window_max), got window_max={self.window_max} < "
                    f"window={self.window}")
            if self.band_engine == "pallas" \
                    and self.window_max - 1 > self.band_block:
                raise ValueError(
                    f"band_engine='pallas' under window_policy='adaptive' "
                    f"compiles the band at window_max={self.window_max}, "
                    f"whose band width ({self.window_max - 1}) must fit one "
                    f"row block, but band_block={self.band_block}")
        elif self.window_max:
            raise ValueError(
                f"window_max only applies to window_policy='adaptive' "
                f"(got window_policy={self.window_policy!r} with "
                f"window_max={self.window_max})")
        if self.prune_policy not in PRUNE_POLICIES:
            raise ValueError(f"unknown prune_policy {self.prune_policy!r}; "
                             f"choose from {PRUNE_POLICIES}")
        if self.prune_policy == "evidence":
            if not 0.0 <= self.prune_threshold < 1.0:
                raise ValueError(
                    f"prune_threshold must be in [0, 1) (a normalized "
                    f"cheap-evidence fraction), got {self.prune_threshold}")
        elif self.prune_threshold:
            raise ValueError(
                f"prune_threshold only applies to prune_policy='evidence' "
                f"(got prune_policy={self.prune_policy!r} with "
                f"prune_threshold={self.prune_threshold})")
        if self.band_engine == "pallas" and self.window - 1 > self.band_block:
            # the band kernels need the whole w-1 band inside one row block
            # (plus its successor); catching this here beats a kernel assert
            raise ValueError(
                f"band_engine='pallas' needs the band width (window-1="
                f"{self.window - 1}) to fit one row block, but band_block="
                f"{self.band_block}; raise band_block (VMEM grows as "
                f"band_block^2), lower window, or use band_engine='scan'")
        # variant names are validated lazily by the registry (so configs can
        # be built before a plugin variant registers itself)

    def with_(self, **kw) -> "ERConfig":
        """Functional update (dataclasses.replace sugar)."""
        return replace(self, **kw)

    def static_fingerprint(self) -> tuple:
        """Hashable key of every field that shapes the shard program (the
        reference's executable-cache key, and the port's).
        Host-side fields — runner, num_shards, partitioner,
        compute_metrics, jit_cache, passes, on_overflow, retry_limit,
        trace — are excluded."""
        return ("ERConfig", self.window, self.variant, self.hops,
                self.cap_factor, self.matcher, self.return_scores,
                self.band_engine, self.band_block, self.cand_cap,
                self.band_interpret, self.emit, self.pair_cap, self.linkage,
                self.window_policy, self.window_max,
                self.prune_policy, self.prune_threshold)
