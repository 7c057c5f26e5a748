"""Admission control + graceful degradation policy for the serving layer
(port of ``repro.serve.admission``; host-side policy only).

``ResolutionService`` melts under sustained overload without this module:
the bounded queue blocks every submitter forever, requests have no
deadlines, and one slow batch stalls every caller behind it.  The source
paper leans on MapReduce because the framework absorbs stragglers and
task failures transparently (§2); serving has no framework, so the same
absorb-don't-collapse behavior must live at the REQUEST layer.  This
module is that policy, kept separate from the service mechanics:

  * ``AdmissionConfig``      the frozen policy knobs — queue policy
                             (``block`` | ``reject`` | ``shed_oldest``),
                             default per-request deadline, brownout
                             watermarks, stuck-batch watchdog timeout
  * ``WatermarkController``  queue-depth/p95-latency hysteresis deciding
                             when the service browns out to the degraded
                             delta path (and when it recovers)
  * the typed error taxonomy — every way a request can fail under
    pressure is a distinct exception type, so callers (and the chaos
    property tests) can tell "shed by policy" from "worker died"

Health is derived, never stored: ``derive_health`` maps the service's
observable state to ``ok | degraded | overloaded | failed`` for
``ServeStats.health``.

Invariant 13 (DESIGN.md §13): admission control changes WHEN work is
refused or deferred, never WHAT correct results contain — after pressure
drops and ``repair()`` drains the dirty ranges, the served sets are
bit-identical to a from-scratch resolve of the live corpus.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

QUEUE_POLICIES = ("block", "reject", "shed_oldest")

HEALTH_STATES = ("ok", "degraded", "overloaded", "failed")


class AdmissionError(RuntimeError):
    """Base of the admission-control error taxonomy.  Every subclass is a
    REQUEST-level outcome: the future that carries it was refused or
    abandoned by policy while the service itself keeps serving (contrast
    with a service-level failure, which poisons all further work)."""


class OverloadError(AdmissionError):
    """The request was refused because the queue was full: raised at
    ``submit`` time under ``queue_policy="reject"``, or set on the OLDEST
    queued future under ``queue_policy="shed_oldest"`` (the newest request
    wins the slot — fresh work is worth more than stale work that has
    already blown its latency budget)."""


class DeadlineExceededError(AdmissionError):
    """The request's deadline passed while it waited in the queue: set on
    the future at batch-formation time, before any work is spent on it.
    A request that ENTERS a batch runs to completion — deadlines bound
    queue wait, not compute."""


class BatchTimeoutError(AdmissionError):
    """A batch exceeded the stuck-batch watchdog (``batch_timeout_s``) or
    requests were still queued when ``close(timeout=...)`` expired.  For
    the watchdog case the service also marks itself failed: the abandoned
    batch thread may still mutate state, so parity can no longer be
    guaranteed (DESIGN.md §13)."""


@dataclass(frozen=True)
class AdmissionConfig:
    """Admission policy for one ``ResolutionService`` (all fields are
    service-level — none participate in ``ERConfig.static_fingerprint``,
    because none may change what a correct resolve produces).

    ``queue_policy``        ``"block"`` (legacy backpressure — submitters
                            wait, but now fail fast if the worker dies),
                            ``"reject"`` (full queue raises
                            ``OverloadError`` at submit), or
                            ``"shed_oldest"`` (evict + fail the oldest
                            queued future to admit the new request).
    ``default_deadline_ms`` deadline applied to every request that does
                            not pass its own ``deadline_ms`` (None = no
                            deadline).
    ``brownout_high``       queue-depth fraction (depth / queue_cap) at or
                            above which the brownout engages; the p95
                            batch latency crossing ``brownout_p95_ms``
                            (when set) also engages it.
    ``brownout_low``        depth fraction at or below which an engaged
                            brownout releases — the hysteresis gap
                            [low, high] prevents flapping.  Latency does
                            NOT gate release: the p95 window decays
                            slowly, so recovery is driven by the queue
                            actually draining.
    ``brownout_p95_ms``     optional latency watermark for engagement.
    ``batch_timeout_s``     stuck-batch watchdog: a batch that runs longer
                            than this fails with ``BatchTimeoutError``
                            instead of hanging the worker (None = off;
                            the zero-overhead inline path is kept).
    """
    queue_policy: str = "block"
    default_deadline_ms: Optional[float] = None
    brownout_high: float = 0.75
    brownout_low: float = 0.25
    brownout_p95_ms: Optional[float] = None
    batch_timeout_s: Optional[float] = None

    def __post_init__(self) -> None:
        if self.queue_policy not in QUEUE_POLICIES:
            raise ValueError(
                f"queue_policy={self.queue_policy!r} not in "
                f"{QUEUE_POLICIES}")
        if self.brownout_low > self.brownout_high:
            raise ValueError(
                f"brownout_low={self.brownout_low} must be <= "
                f"brownout_high={self.brownout_high}")
        if self.default_deadline_ms is not None \
                and self.default_deadline_ms < 0:
            raise ValueError("default_deadline_ms must be >= 0")
        if self.batch_timeout_s is not None and self.batch_timeout_s <= 0:
            raise ValueError("batch_timeout_s must be > 0")


class WatermarkController:
    """Hysteresis gate for the brownout state (DESIGN.md §13).

    ``update(depth, p95_ms)`` folds one observation and returns the
    current brownout decision: OFF -> ON when the queue-depth fraction
    reaches ``brownout_high`` or p95 batch latency reaches
    ``brownout_p95_ms``; ON -> OFF only when the depth fraction falls to
    ``brownout_low`` (see ``AdmissionConfig`` for why latency never gates
    release).  The controller is intentionally dumb — no EWMA, no clock:
    deterministic given the observation sequence, which is what the
    brownout unit tests pin."""

    def __init__(self, cfg: AdmissionConfig, queue_cap: int):
        self.cfg = cfg
        self.queue_cap = max(int(queue_cap), 1)
        self.engaged = False
        self.transitions = 0

    def update(self, depth: int, p95_ms: float) -> bool:
        """Fold one observation (current queue depth, p95 batch latency
        in ms) and return the brownout decision: engage when the depth
        fraction reaches ``brownout_high`` or p95 reaches
        ``brownout_p95_ms``; release only when depth falls to
        ``brownout_low`` (hysteresis — latency never gates release)."""
        frac = depth / self.queue_cap
        if self.engaged:
            if frac <= self.cfg.brownout_low:
                self.engaged = False
                self.transitions += 1
        else:
            hot = frac >= self.cfg.brownout_high
            if self.cfg.brownout_p95_ms is not None:
                hot = hot or p95_ms >= self.cfg.brownout_p95_ms
            if hot:
                self.engaged = True
                self.transitions += 1
        return self.engaged


def derive_health(*, failure: bool, brownout: bool, dirty_ranges: int,
                  depth_frac: float, high: float) -> str:
    """Map observable service state to the ``ServeStats.health`` value.

    Precedence: ``failed`` (the service refuses all work) over
    ``overloaded`` (queue at/above the high watermark RIGHT NOW) over
    ``degraded`` (brownout engaged, or repair debt outstanding — served
    matches may lag until ``repair()`` drains) over ``ok``."""
    if failure:
        return "failed"
    if depth_frac >= high:
        return "overloaded"
    if brownout or dirty_ranges:
        return "degraded"
    return "ok"
