"""``repro_torch.perf`` — the executable-cache seam (``perf/cache.py``);
the cache itself is ROADMAP M11."""
from repro_torch.perf.cache import CacheStats, ExecutableCache, \
    executable_cache

__all__ = ["CacheStats", "ExecutableCache", "executable_cache"]
