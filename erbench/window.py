"""The measured window, and under ``--trace 1`` what it records.

``Window.open`` marks the start of the measured window (after set-up) and
``Window.close`` its end.  A traced window also runs ``torch.profiler``
(CUDA activity for the device's operations, CPU activity for one marker
that ties the profiler's clock to the host's) and activates a
``repro_torch.obs`` tracer on the calling thread, so every span the
program opens on that thread lands in it; a driver whose program traces
on its own thread hands those spans over with ``add_spans``.  Nothing is
written to disk: the events are reduced in memory to device intervals,
span intervals and the run's ``breakdown``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

MARK = "erbench.window"


@dataclass
class Span:
    name: str
    t0: float            # host seconds (time.perf_counter)
    t1: float
    self_s: float
    depth: int


def spans_from(records, epoch: float) -> list:
    """``repro_torch.obs`` span records (start relative to their tracer's
    ``epoch``) as finished ``Span``s on the host clock, with self times."""
    kids: dict = {}
    for s in records:
        if s.parent >= 0 and s.dur is not None:
            kids[s.parent] = kids.get(s.parent, 0.0) + s.dur
    return [Span(s.name, epoch + s.t0, epoch + s.t0 + s.dur,
                 max(0.0, s.dur - kids.get(s.index, 0.0)), s.depth)
            for s in records if s.dur is not None]


def union_seconds(intervals, lo: float, hi: float) -> float:
    """Seconds of [lo, hi] covered by any of the (start, end) intervals."""
    total, end = 0.0, lo
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def idle_gaps(intervals, lo: float, hi: float) -> list:
    """(start, end) of every stretch of [lo, hi] that no interval covers."""
    gaps, end = [], lo
    for a, b in sorted(intervals):
        if a > end:
            gaps.append((end, min(a, hi)))
        end = max(end, b)
        if end >= hi:
            break
    if end < hi:
        gaps.append((end, hi))
    return [(a, b) for a, b in gaps if b > a]


def innermost(spans, times) -> list:
    """For each of the ascending ``times``, the name of the innermost span
    open then (``client`` where none is).  Spans nest, so one sweep with a
    stack answers every query."""
    spans = sorted(spans, key=lambda s: (s.t0, s.depth))
    out, stack, i = [], [], 0
    for t in times:
        while i < len(spans) and spans[i].t0 <= t:
            while stack and stack[-1].t1 <= spans[i].t0:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1].t1 <= t:
            stack.pop()
        out.append(stack[-1].name if stack else "client")
    return out


def segments(spans, lo: float, hi: float) -> list:
    """[(start, end, name)] covering [lo, hi]: the innermost span open
    over each stretch (``client`` where none is)."""
    cuts = sorted({lo, hi} | {t for s in spans for t in (s.t0, s.t1)
                              if lo < t < hi})
    mids = [0.5 * (a + b) for a, b in zip(cuts, cuts[1:])]
    return [(a, b, name) for a, b, name in
            zip(cuts, cuts[1:], innermost(spans, mids))]


@dataclass
class Window:
    """One run's measured window (see the module docstring)."""
    trace: bool
    device: str
    t0: float = 0.0
    t1: float = 0.0
    peak_setup_bytes: int = 0
    peak_window_bytes: int = 0
    spans: list = field(default_factory=list)
    device_ops: list = field(default_factory=list)   # (name, t0, t1)
    _prof: object = None
    _mark: object = None
    _mark_host: float = 0.0
    _tracer: object = None
    _active: object = None

    def open(self) -> float:
        import torch
        if self.device == "cuda":
            torch.cuda.synchronize()
            self.peak_setup_bytes = torch.cuda.max_memory_reserved()
            torch.cuda.reset_peak_memory_stats()
        if self.trace:
            from repro_torch import obs
            from torch.profiler import ProfilerActivity, profile, \
                record_function
            acts = [ProfilerActivity.CPU]
            if self.device == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
            self._tracer = obs.Tracer()
            self._active = obs.activate(self._tracer)
            self._active.__enter__()
            self._mark = record_function(MARK)
            self._mark_host = time.perf_counter()
            self._mark.__enter__()
        self.t0 = time.perf_counter()
        return self.t0

    def close(self) -> float:
        import torch
        if self.device == "cuda":
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        if self.device == "cuda":
            self.peak_window_bytes = torch.cuda.max_memory_reserved()
        if self.trace:
            self._mark.__exit__(None, None, None)
            epoch = time.perf_counter() - self._tracer.wall()
            self._active.__exit__(None, None, None)
            self._prof.__exit__(None, None, None)
            self.add_spans(self._tracer.spans(), epoch)
            self._read_profile()
        return self.t1

    def add_spans(self, records, epoch: float) -> None:
        """Keep the spans of ``records`` (tracer-relative, ``epoch`` their
        tracer's start on the host clock) that started in the window."""
        self.spans += [s for s in spans_from(records, epoch)
                       if s.t0 >= self.t0]

    def _read_profile(self) -> None:
        import torch
        events = list(self._prof.profiler.kineto_results.events())
        cuda = torch.autograd.DeviceType.CUDA
        mark = [e for e in events
                if e.name() == MARK and e.device_type() != cuda]
        if not mark:
            raise RuntimeError("the profiler recorded no window marker")
        shift = self._mark_host - mark[0].start_ns() / 1e9
        # the marker's own range is mirrored on the device's timeline;
        # it is no operation
        self.device_ops = [
            (e.name(), e.start_ns() / 1e9 + shift,
             (e.start_ns() + e.duration_ns()) / 1e9 + shift)
            for e in events if e.device_type() == cuda and e.name() != MARK]

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def busy_s(self) -> float:
        return union_seconds([(a, b) for _, a, b in self.device_ops],
                             self.t0, self.t1)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the window's
        idle time by the innermost host span open over it (``client``
        where none is)."""
        by_op: dict = {}
        for name, a, b in self.device_ops:
            by_op[name[:120]] = by_op.get(name[:120], 0.0) + (b - a)
        gaps = idle_gaps([(a, b) for _, a, b in self.device_ops],
                         self.t0, self.t1)
        by_span: dict = {}
        segs, i = segments(self.spans, self.t0, self.t1), 0
        for a, b in gaps:
            while i < len(segs) and segs[i][1] <= a:
                i += 1
            j = i
            while j < len(segs) and segs[j][0] < b:
                lo, hi, label = segs[j]
                by_span[label] = by_span.get(label, 0.0) + \
                    min(hi, b) - max(lo, a)
                j += 1
        rank = lambda d: sorted(([k, v] for k, v in d.items()),
                                key=lambda kv: -kv[1])[:top]
        return {"device_ops": rank(by_op), "idle_gaps": rank(by_span)}
