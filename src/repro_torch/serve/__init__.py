"""``repro_torch.serve`` — online incremental entity resolution (port of
``repro.serve``).

Keeps a corpus resolved while it changes, in four layers:

  1. **index** — a persistent sorted index (``SortedIndex``): the corpus
     as sorted runs in a ``stream.store.ChunkStore`` + a resident flat
     rank index of live ``(key << 32) | eid`` composites + an
     incrementally merged ``balance.KeyProfile``; tombstone deletes,
     threshold-triggered compaction through the external-sort machinery.
  2. **delta** — neighborhood-delta matching (``DeltaMatcher``): a
     mutation only changes pairs inside merged w-neighborhood intervals
     around the mutated ranks, so each micro-batch costs shape-bucketed
     shard-program calls over those intervals on the card (K1 on every
     call) plus host set algebra — never a re-resolve.
  3. **service** — the micro-batched front end (``ResolutionService``):
     bounded queue, request coalescing, per-request futures, stable pair
     ids, latency telemetry (``ServeStats``).
  4. **admission** — the overload policy: queue policies (block / reject
     / shed_oldest) behind ``AdmissionConfig``, per-request deadlines,
     the brownout watermark controller that degrades the delta path under
     pressure, the stuck-batch watchdog, and the typed error taxonomy
     (``OverloadError``, ``DeadlineExceededError``, ``BatchTimeoutError``).

Invariant: after any interleaving of inserts and deletes,
``service.pairs``/``service.matches`` are bit-identical to a from-scratch
``api.resolve`` over the live entities under the same config, for all
three variants and both band engines.  Under brownout the invariant
relaxes to EVENTUALLY-exact (DESIGN.md §13): blocked pairs stay exact
throughout, new matches may be deferred, and ``repair()`` restores full
bit-parity once pressure drops.  Snapshots use the reference's files, so
a snapshot either package wrote restores in the other.
"""
from repro_torch.serve.admission import (AdmissionConfig, AdmissionError,
                                         BatchTimeoutError,
                                         DeadlineExceededError,
                                         OverloadError, WatermarkController)
from repro_torch.serve.delta import DeltaMatcher, DeltaStats, \
    srp_straddle_packed
from repro_torch.serve.index import SortedIndex
from repro_torch.serve.service import (IncrementalResult, ResolutionService,
                                       ServeStats)

__all__ = [
    "SortedIndex", "DeltaMatcher", "DeltaStats", "srp_straddle_packed",
    "ResolutionService", "IncrementalResult", "ServeStats",
    "AdmissionConfig", "AdmissionError", "OverloadError",
    "DeadlineExceededError", "BatchTimeoutError", "WatermarkController",
]
