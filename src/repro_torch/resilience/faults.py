"""Deterministic fault injection — the harness behind kill/resume tests
(port of ``repro.resilience.faults``; pure host logic, no device).

Real preemption is nondeterministic; the parity tests need the opposite: a
crash at an EXACT point in the pipeline, repeatable for every chunk index.
``FaultPlan`` injects those crashes from inside ``resolve_stream``'s chunk
loop, and ``flaky_chunks`` wraps an ingest iterator so it dies mid-ingest —
together they cover every durability seam the checkpoint protocol has:

  * ``crash_after_chunk=k``    raise AFTER chunk k's checkpoint committed
                               (clean kill: resume continues at chunk k+1)
  * ``crash_before_commit=k``  raise after chunk k's pair spool was written
                               but BEFORE the manifest committed it (torn
                               kill: resume must redo chunk k, atomically
                               overwriting the orphaned spool file)
  * ``flaky_chunks(it, fail_after=j)``  the ingest iterator raises after
                               yielding j chunks (resume re-supplies the
                               iterator and skips the j committed chunks)

The SERVING layer generalizes the same idea past checkpoint labels:
``ChaosPlan`` injects latency spikes, worker stalls, and matcher errors
at exact micro-batch indices inside ``ResolutionService``'s batch-apply
path (``repro_torch.serve``).  The service consults the plan BEFORE any
state mutation, so an injected error fails only the batch that hit it —
the chaos property tests sweep injection schedules against every
``queue_policy`` and assert no future ever hangs or silently disappears
(DESIGN.md §13).

Overflow-forcing micro-caps are just configuration — build them with
``micro_caps``.  Injected crashes raise ``InjectedFault`` so tests can
catch exactly the planned failure and nothing else.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Iterable, Iterator, Optional, Tuple

CHAOS_KINDS = ("latency", "stall", "error")


class InjectedFault(RuntimeError):
    """A crash raised by a FaultPlan / flaky iterator (never by real code
    paths) — tests catch this exact type so an unplanned error still
    fails them loudly."""


@dataclass(frozen=True)
class FaultPlan:
    """Deterministic crash points for one streaming run (see module doc).

    Chunk indices are 0-based within the streaming pass named ``label``
    (None = any pass — single-pass runs have exactly one, labelled "key").
    A plan is consulted, never mutated: the resumed run simply passes no
    plan (or a different one) instead."""
    crash_after_chunk: Optional[int] = None
    crash_before_commit: Optional[int] = None
    label: Optional[str] = None

    def _matches(self, label: str) -> bool:
        return self.label is None or self.label == label

    def before_commit(self, label: str, chunk: int) -> None:
        """Called between a chunk's pair-spool write and its manifest
        commit — the torn-write injection point."""
        if self._matches(label) and self.crash_before_commit == chunk:
            raise InjectedFault(
                f"injected crash before committing chunk {chunk} "
                f"(pass {label!r}): spool written, manifest not updated")

    def after_commit(self, label: str, chunk: int) -> None:
        """Called after a chunk's checkpoint fully committed — the clean
        kill injection point."""
        if self._matches(label) and self.crash_after_chunk == chunk:
            raise InjectedFault(
                f"injected crash after committing chunk {chunk} "
                f"(pass {label!r})")


@dataclass(frozen=True)
class ChaosEvent:
    """One injected disturbance at an exact serving micro-batch index.

    ``kind="latency"``  sleep ``seconds`` before the batch's delta call —
                        a straggler batch (inflates p95, drives the
                        brownout watermark) that still completes normally;
    ``kind="stall"``    same sleep, but sized to outlive the service's
                        ``batch_timeout_s`` — the watchdog fixture (a
                        stall without a watchdog is just a big latency);
    ``kind="error"``    raise ``InjectedFault`` — a matcher/delta error.
                        The service consults the plan before mutating any
                        state, so the error is request-level: the batch's
                        futures fail, the service keeps serving.
    """
    batch: int
    kind: str
    seconds: float = 0.0

    def __post_init__(self) -> None:
        if self.kind not in CHAOS_KINDS:
            raise ValueError(f"kind={self.kind!r} not in {CHAOS_KINDS}")
        if self.batch < 0 or self.seconds < 0:
            raise ValueError("batch and seconds must be >= 0")


@dataclass(frozen=True)
class ChaosPlan:
    """Deterministic disturbance schedule for one ``ResolutionService``
    (the serving analogue of ``FaultPlan``).  Batch indices are 0-based
    over the batches the service applies, in order — the same counter
    ``ServeStats.batches`` reports.  A plan is consulted, never mutated;
    ``on_batch`` is the single hook the service calls at the top of its
    batch-apply path."""
    events: Tuple[ChaosEvent, ...] = ()

    def on_batch(self, index: int) -> None:
        """Apply every event scheduled at ``index``: sleeps first (a
        stalled worker that THEN errors is the worst case), then at most
        one raise."""
        hit = [ev for ev in self.events if ev.batch == index]
        for ev in hit:
            if ev.kind in ("latency", "stall"):
                time.sleep(ev.seconds)
        for ev in hit:
            if ev.kind == "error":
                raise InjectedFault(
                    f"injected matcher error at serving batch {index}")


def flaky_chunks(chunks: Iterable[dict], fail_after: int) -> Iterator[dict]:
    """Wrap an ingest iterator to raise ``InjectedFault`` after yielding
    ``fail_after`` chunks — the mid-ingest kill.  The resumed run gets a
    FRESH (deterministic) iterator; the checkpoint skips the chunks it
    already committed."""
    for i, c in enumerate(chunks):
        if i == fail_after:
            raise InjectedFault(
                f"injected mid-ingest failure after {fail_after} chunks")
        yield c


def micro_caps(cfg, *, cand_cap: int = 2, pair_cap: int = 2):
    """An overflow-forcing config: absurdly small finite caps that make
    every realistic chunk overflow — the fixture the zero-dropped-pairs
    retry tests (and BENCH_resilience's retry column) run under."""
    return cfg.with_(cand_cap=cand_cap, pair_cap=pair_cap)
