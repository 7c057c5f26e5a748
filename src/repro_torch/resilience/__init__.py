"""``repro_torch.resilience`` — fault tolerance for long-running resolution
(port of ``repro.resilience``).

  * checkpoint    ``StreamCheckpoint`` — the versioned on-disk manifest
                  behind ``resolve_stream(checkpoint_dir=...)``: ingested
                  chunks, sorted runs, the merged ``KeyProfile``, the w-1
                  seam halo, and a per-chunk packed-pair spool, all written
                  crash-atomically after every completed chunk.
                  ``resume_stream`` (== ``api.resume``) picks a killed run
                  up at the last committed chunk; the resumed pair union is
                  bit-identical to an uninterrupted run (invariant 11).
  * retry         the ``ERConfig.on_overflow`` escalation ladder and
                  ``autosize_caps``.
  * faults        the deterministic ``FaultPlan`` injection harness the
                  kill/resume tests drive, ``flaky_chunks``, ``micro_caps``,
                  and ``ChaosPlan`` for the serving layer
                  (``repro_torch.serve``).
"""
from repro_torch.resilience.checkpoint import StreamCheckpoint, \
    resume_stream
from repro_torch.resilience.faults import (ChaosEvent, ChaosPlan,
                                           FaultPlan, InjectedFault,
                                           flaky_chunks, micro_caps)
from repro_torch.resilience.retry import (CapacityOverflowError,
                                          ResilienceStats, autosize_caps,
                                          run_with_recovery)

__all__ = [
    "StreamCheckpoint", "resume_stream",
    "FaultPlan", "InjectedFault", "flaky_chunks", "micro_caps",
    "ChaosEvent", "ChaosPlan",
    "CapacityOverflowError", "ResilienceStats", "autosize_caps",
    "run_with_recovery",
]
