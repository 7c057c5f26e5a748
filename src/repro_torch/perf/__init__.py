"""``repro_torch.perf`` — the executable cache (``perf/cache.py``): the
shard programs built once and, on the card, replayed as CUDA graphs."""
from repro_torch.perf.cache import CacheStats, ExecutableCache, \
    executable_cache, tree_fingerprint

__all__ = ["CacheStats", "ExecutableCache", "executable_cache",
           "tree_fingerprint"]
