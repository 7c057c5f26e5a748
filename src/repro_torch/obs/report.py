"""``TraceReport`` — the per-run observability artifact (port of
``repro.obs.report``).

When ``ERConfig.trace`` is set, the owning call (``facade.resolve`` /
``link``, ``stream.resolve_stream``, or ``ResolutionService.
trace_report()``) attaches one of these to its result: the run's spans,
its metrics registry export, and every legacy stats object the run
produced — all behind the ONE ``metrics()`` accessor of DESIGN.md §12,
without touching the existing ``result.perf`` / ``.balance`` / ``.stream``
/ ``.resilience`` fields (those keep working; the report UNIFIES them, it
does not replace them).
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import List, Mapping, Tuple

from repro_torch.obs.schema import SCHEMA_VERSION, pack_stats, unpack_stats
from repro_torch.obs.trace import Tracer, write_chrome


@dataclass(frozen=True)
class TraceReport:
    """One traced run: spans + metrics + unified legacy stats.

    ``spans``      the tracer's SpanRecords, in start order
    ``wall``       seconds from tracer creation to report capture
    ``stats``      the run's legacy stats objects, packed through the
                   unified schema and keyed by kind ("PerfStats", ...)
    ``registry``   the tracer's MetricsRegistry export (counters/gauges/
                   histograms under the one ``to_dict`` schema)
    """
    spans: Tuple = ()
    wall: float = 0.0
    stats: Mapping[str, dict] = field(default_factory=dict)
    registry: Mapping[str, dict] = field(default_factory=dict)

    @classmethod
    def from_tracer(cls, tracer: Tracer, stats=(), wall=None
                    ) -> "TraceReport":
        """Capture ``tracer``'s current spans/metrics plus any legacy
        stats objects (Nones are skipped; each is packed under its kind).
        ``wall`` defaults to the tracer's elapsed time."""
        packed = {}
        for obj in stats:
            if obj is None:
                continue
            d = pack_stats(obj)
            packed[d["kind"]] = d
        return cls(spans=tracer.spans(),
                   wall=tracer.wall() if wall is None else wall,
                   stats=packed, registry=tracer.metrics.to_dict())

    def metrics(self) -> dict:
        """The unified JSON-able view of the whole run — schema version,
        wall clock, span count, every registered metric, and all legacy
        stats types behind one schema.  ``unpack_stats`` on any entry of
        ``["stats"]`` reconstructs the original typed object."""
        return {"schema_version": SCHEMA_VERSION,
                "wall_s": self.wall,
                "spans": len(self.spans),
                "metrics": dict(self.registry),
                "stats": {k: dict(v) for k, v in self.stats.items()}}

    def stat(self, kind: str):
        """The run's legacy stats object of ``kind`` ("PerfStats",
        "StreamStats", ...), reconstructed as its original type; KeyError
        when this run produced none of that kind."""
        return unpack_stats(dict(self.stats[kind]))

    def self_times(self) -> List[Tuple[str, float]]:
        """Total SELF time per span name (duration minus direct children),
        sorted descending — the top-spans view of ``tools/
        trace_report.py``."""
        child_sum: dict = defaultdict(float)
        for s in self.spans:
            if s.parent >= 0 and s.dur is not None:
                child_sum[s.parent] += s.dur
        agg: dict = defaultdict(float)
        for s in self.spans:
            if s.dur is None:
                continue
            agg[s.name] += max(0.0, s.dur - child_sum.get(s.index, 0.0))
        return sorted(agg.items(), key=lambda kv: -kv[1])

    def span_totals(self) -> dict:
        """Per-name aggregate {name: {"count", "total_s"}} over all
        finished spans (inclusive durations)."""
        out: dict = {}
        for s in self.spans:
            if s.dur is None:
                continue
            e = out.setdefault(s.name, {"count": 0, "total_s": 0.0})
            e["count"] += 1
            e["total_s"] += s.dur
        return out

    def coverage(self) -> float:
        """Fraction of the first root span's duration covered by its
        DIRECT children — the DESIGN.md §12 accounting-completeness check
        (a healthy instrumented run keeps this >= 0.9, i.e. per-phase /
        per-chunk spans sum to within ~10%% of the measured wall).  A
        collector pass (``gc``) that ran before the root opened is no
        root.  Returns 0.0 when there is no finished root span."""
        roots = [s for s in self.spans
                 if s.parent < 0 and s.dur and s.name != "gc"]
        if not roots:
            return 0.0
        root = roots[0]
        kids = sum(s.dur for s in self.spans
                   if s.parent == root.index and s.dur is not None)
        return kids / root.dur

    def export_chrome(self, path: str) -> None:
        """Write this report as a Chrome/Perfetto ``trace.json`` with the
        full ``metrics()`` blob under the ``"repro"`` key."""
        write_chrome(path, self.spans, repro=self.metrics())
