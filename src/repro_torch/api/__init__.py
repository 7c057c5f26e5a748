"""``repro_torch.api`` — the public entity-resolution facade of the port.

    from repro_torch import api
    from repro_torch.core import entities as E

    ents = E.synth_entities(np.random.default_rng(0), 2_000, n_keys=512)
    res = api.resolve(ents, api.ERConfig(variant="repsn", num_shards=8))
    res.blocking.pairs      # PairSet of blocked (candidate) pairs
    res.matches             # PairSet of matcher-accepted pairs
    res.matches.packed      # the same set as its sorted packed uint64 array

Runs on the CUDA card unless ``device="cpu"`` is passed.  Under
``ERConfig(passes=...)`` ``resolve`` returns a ``MultiPassResult``;
``resume`` continues a checkpointed ``repro_torch.stream`` run; ``serve``
starts a ``ResolutionService`` (``repro_torch.serve``);
``ERConfig(trace=True)`` attaches a ``TraceReport`` (``repro_torch.obs``);
``ERConfig(runner="shard_map")`` runs one shard per rank of a process
group (``ShardMapRunner``, ``repro_torch.launch``).
"""
# repro_torch.obs is a leaf (stdlib/numpy only at import), so the eager
# import is cycle-safe — unlike serve/resilience, which resolve lazily below
from repro_torch.obs import (SCHEMA_VERSION, TraceReport, Tracer, pack_stats,
                             unpack_stats)
from repro_torch.api.config import ERConfig, SortKeySpec
from repro_torch.api.facade import default_bounds, link, make_runner, \
    resolve, resume, serve
from repro_torch.api.linkage import sequential_link_pairs, tag_sources
from repro_torch.api.results import (BalanceMetrics, BlockingResult,
                                     ERMetrics, ERResult, MultiPassResult,
                                     PairSet, PerfStats, ResilienceStats,
                                     pack_pairs,
                                     packed_pairs_from_band,
                                     packed_pairs_from_idx,
                                     packed_pairs_from_part,
                                     packed_to_frozenset, pairs_from_band,
                                     unpack_pairs)
from repro_torch.api.runners import (PackedOutcome, Runner, RunnerOutcome,
                                     SequentialRunner, ShardMapRunner,
                                     VmapRunner, shard_input)
from repro_torch.api.variants import (available_variants, get_variant,
                                      register_variant)
from repro_torch.balance import (KeyProfile, ShardPlan,
                                 available_partitioners, get_partitioner,
                                 plan_shards, profile_keys,
                                 register_partitioner)
from repro_torch.core.window import (available_band_engines,
                                     get_band_engine, register_band_engine)

_SERVE_TYPES = ("ResolutionService", "IncrementalResult", "ServeStats")
_RESILIENCE_TYPES = ("StreamCheckpoint", "FaultPlan", "InjectedFault",
                     "CapacityOverflowError")


def __getattr__(name):
    # the serve/resilience types resolve lazily (PEP 562): both packages
    # reach repro_torch.api submodules, so an eager import here would be a
    # cycle
    if name in _SERVE_TYPES:
        import repro_torch.serve as _serve
        return getattr(_serve, name)
    if name in _RESILIENCE_TYPES:
        import repro_torch.resilience as _resilience
        return getattr(_resilience, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "ERConfig", "SortKeySpec",
    "resolve", "link", "serve", "resume", "make_runner", "default_bounds",
    "ResolutionService", "IncrementalResult", "ServeStats",
    "ResilienceStats", "StreamCheckpoint", "FaultPlan", "InjectedFault",
    "CapacityOverflowError",
    "BlockingResult", "ERResult", "ERMetrics", "BalanceMetrics", "PerfStats",
    "MultiPassResult", "PairSet",
    "pairs_from_band",
    "packed_pairs_from_band", "packed_pairs_from_idx",
    "packed_pairs_from_part", "pack_pairs", "unpack_pairs",
    "packed_to_frozenset",
    "Runner", "RunnerOutcome", "PackedOutcome",
    "SequentialRunner", "VmapRunner", "ShardMapRunner", "shard_input",
    "register_variant", "get_variant", "available_variants",
    "register_band_engine", "get_band_engine", "available_band_engines",
    "KeyProfile", "ShardPlan", "profile_keys", "plan_shards",
    "register_partitioner", "get_partitioner", "available_partitioners",
    "tag_sources", "sequential_link_pairs",
    "Tracer", "TraceReport", "pack_stats", "unpack_stats", "SCHEMA_VERSION",
]
