"""``repro_torch.obs`` — unified tracing + metrics (port of ``repro.obs``,
DESIGN.md §12).

One observability substrate for the whole port:

  * ``span(name, **attrs)``   the instrumentation primitive: a context
                              manager that is a shared no-op singleton
                              when no tracer is active (one thread-local
                              lookup) and records monotonic timing +
                              nesting when one is
  * ``Tracer`` / ``activate`` per-run span collector, installed
                              per-thread; ``export_chrome`` writes a
                              Chrome/Perfetto ``trace.json``
  * ``Counter`` / ``Gauge`` / ``Histogram`` / ``MetricsRegistry``
                              typed metrics behind one ``to_dict`` schema
                              (``Histogram`` is a bounded ring buffer —
                              the serve latency window rides on it)
  * ``TraceReport``           the per-run artifact ``ERConfig.trace=True``
                              attaches to results: spans + metrics + the
                              five stats types unified behind
                              ``metrics()`` (``pack_stats``/
                              ``unpack_stats`` round-trip them losslessly)

Every module here is a leaf (stdlib + numpy; no ``torch``), so
``repro_torch.api``, ``stream``, ``serve`` and ``resilience`` import it
without cycles; the schema's class lookups resolve lazily at unpack
time.  Device spans (``shard_program``) are fenced with
``torch.cuda.synchronize`` by their call site, only while a tracer is
active.  While any tracer is active each CPython collection is a ``gc``
span on the collecting thread's tracer (``trace.py``).  The
``pairs_boxed`` counter, registered by every traced ``packed_to_frozenset``
call, counts the (lo, hi) tuples a public ``PairSet`` yields while it is
iterated under an active tracer (0 where a caller reads only sizes).

Invariant 12: tracing never changes pair sets.
"""
from repro_torch.obs.metrics import Counter, Gauge, Histogram, \
    MetricsRegistry
from repro_torch.obs.report import TraceReport
from repro_torch.obs.schema import (SCHEMA_VERSION, STATS_KINDS, pack_stats,
                                    unpack_stats)
from repro_torch.obs.trace import (NOOP_SPAN, SpanRecord, Tracer, activate,
                                   current_tracer, span, write_chrome)

__all__ = [
    "span", "Tracer", "activate", "current_tracer", "SpanRecord",
    "NOOP_SPAN", "write_chrome",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "TraceReport", "pack_stats", "unpack_stats", "SCHEMA_VERSION",
    "STATS_KINDS",
]
