"""The executable-cache seam of ``repro.perf.cache``, counting nothing.

The reference compiles each shard program once and counts cache hits,
misses and traces; the stream resolver meters every chunk with
``executable_cache().stats.snapshot()`` / ``.delta()``.  PyTorch runs the
shard program eagerly and the port has no cache of compiled callables yet
(ROADMAP M11), so these counters stay 0: ``StreamStats.steady_chunks``,
``cache_hits``, ``cache_misses`` and ``traces`` read 0, as the facade's
``PerfStats`` do.  M11 replaces this module."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class CacheStats:
    """Process-wide (hits, misses, traces): always 0 until M11."""
    hits: int = 0
    misses: int = 0
    traces: int = 0

    def snapshot(self) -> Tuple[int, int, int]:
        """Current (hits, misses, traces)."""
        return (self.hits, self.misses, self.traces)

    def delta(self, since: Tuple[int, int, int]) -> Tuple[int, int, int]:
        """(hits, misses, traces) accrued since a ``snapshot()``."""
        h, m, t = since
        return (self.hits - h, self.misses - m, self.traces - t)


@dataclass(frozen=True)
class ExecutableCache:
    """A cache that holds no executables; only its ``stats`` are read."""
    stats: CacheStats = CacheStats()


_CACHE = ExecutableCache()


def executable_cache() -> ExecutableCache:
    """The process-wide cache (its counters stay 0 until M11)."""
    return _CACHE
