"""Span tracer — the wall-clock attribution half of ``repro_torch.obs``
(port of ``repro.obs.trace``).

A ``Tracer`` records a flat list of ``SpanRecord``s (monotonic start +
duration, thread id, nesting depth, parent index, free-form attrs) and is
installed per-thread with ``activate(tracer)``.  Instrumented code calls
the module-level ``span(name, **attrs)`` context manager, which is the
whole overhead story:

  * **disabled** (no tracer active on this thread — the default): ``span``
    returns one shared no-op singleton after a single thread-local lookup.
    No allocation, no timestamp, no lock.  This is the near-zero-cost
    contract DESIGN.md §12 pins at <= 1% on a steady-state resolve.
  * **enabled**: one ``time.perf_counter`` pair per span plus one lock
    acquisition to append the record.  Device sections (``device=True``
    attrs) are additionally fenced with ``torch.cuda.synchronize`` BY THE
    INSTRUMENTATION SITE (not here) so asynchronous kernel launches cannot
    under-report them.

While at least one tracer is active on any thread, a ``gc.callbacks``
hook records each CPython collection as a ``gc`` span (attrs
``generation``, ``collected``, ``uncollectable``) on the collecting
thread's active tracer, under whatever span is open there; the first
``activate`` installs it and the last one out removes it, so an untraced
process runs no callback at all.  A collection can start inside any
allocation, the tracer's own locked sections included, so the tracer's
lock is re-entrant.

Invariant 12 (DESIGN.md): tracing never changes pair sets or retrace
counts — spans only read clocks; ``cfg.trace`` is excluded from
``static_fingerprint``.

``export_chrome`` / ``write_chrome`` emit the Chrome/Perfetto
``trace.json`` format (``ph="X"`` complete events, microsecond
timestamps), with the repro metrics blob tucked under a ``"repro"``
top-level key that trace viewers ignore and ``tools/trace_report.py``
reads back.
"""
from __future__ import annotations

import gc
import json
import threading
import time
from typing import Optional

from repro_torch.obs.metrics import MetricsRegistry

_active = threading.local()


def current_tracer() -> Optional["Tracer"]:
    """The tracer active on the calling thread, or None when tracing is
    disabled (the default) — the ONE lookup every ``span()`` call pays."""
    return getattr(_active, "tracer", None)


class activate:
    """Install ``tracer`` as the calling thread's active tracer for the
    duration of the ``with`` block (restoring whatever was active before).
    Worker threads (the serve worker, stream helpers) activate their
    owner's tracer explicitly — thread-locality is what keeps unrelated
    concurrent runs from writing into each other's traces."""

    def __init__(self, tracer: "Tracer"):
        self.tracer = tracer
        self._prev: Optional[Tracer] = None

    def __enter__(self) -> "Tracer":
        self._prev = getattr(_active, "tracer", None)
        _hook_gc(+1)
        _active.tracer = self.tracer
        return self.tracer

    def __exit__(self, *exc) -> bool:
        _active.tracer = self._prev
        _hook_gc(-1)
        return False


_gc_lock = threading.RLock()
_gc_users = 0


def _hook_gc(delta: int) -> None:
    """Count active tracers; ``_on_gc`` is in ``gc.callbacks`` exactly
    while the count is above zero."""
    global _gc_users
    with _gc_lock:
        _gc_users += delta
        if delta > 0 and _gc_users == 1:
            gc.callbacks.append(_on_gc)
        elif delta < 0 and _gc_users == 0:
            gc.callbacks.remove(_on_gc)


def _on_gc(phase: str, info: dict) -> None:
    """One ``gc`` span per collection on the collecting thread's active
    tracer (none: nothing).  Collections never nest, so a thread has at
    most one open; records spans only, never metrics."""
    if phase == "start":
        t = getattr(_active, "tracer", None)
        if t is not None:
            sp = _Span(t, "gc", {"generation": info["generation"]})
            sp.__enter__()
            _active.gc_span = sp
        return
    sp = getattr(_active, "gc_span", None)
    if sp is not None:
        _active.gc_span = None
        sp._rec.attrs["collected"] = info["collected"]
        sp._rec.attrs["uncollectable"] = info["uncollectable"]
        sp.__exit__(None, None, None)


class _NoopSpan:
    """The shared disabled-path span: every method is a no-op and
    ``enabled`` is False so call sites can skip computing expensive attrs
    (byte counts, device blocking) entirely."""
    __slots__ = ()
    enabled = False

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        """No-op (attrs are dropped when tracing is disabled)."""


NOOP_SPAN = _NoopSpan()


def span(name: str, /, **attrs):
    """Open a span named ``name`` on the calling thread's active tracer.

    Returns the shared no-op singleton when no tracer is active — the
    disabled path is one thread-local lookup.  ``attrs`` become the span's
    Chrome-trace ``args`` (the span name is positional-only, so ``name``
    is a legal attr key); the reserved attr ``device=True`` marks a
    device section (call sites block on the result inside the span)."""
    t = getattr(_active, "tracer", None)
    if t is None:
        return NOOP_SPAN
    return t.span(name, **attrs)


class SpanRecord:
    """One finished (or open) span: ``name``, start ``t0`` (seconds since
    the tracer's epoch), ``dur`` (seconds; None while open), small-int
    thread id ``tid``, nesting ``depth``, its ``index`` in the tracer's
    record list, the ``parent`` span's index (-1 for roots), and the
    free-form ``attrs`` dict."""
    __slots__ = ("name", "t0", "dur", "tid", "depth", "index", "parent",
                 "attrs")

    def __init__(self, name: str, tid: int, depth: int, parent: int,
                 attrs: dict):
        self.name = name
        self.tid = tid
        self.depth = depth
        self.parent = parent
        self.attrs = attrs
        self.index = -1
        self.t0 = 0.0
        self.dur: Optional[float] = None

    def __repr__(self) -> str:
        d = "open" if self.dur is None else f"{self.dur * 1e3:.3f}ms"
        return (f"SpanRecord({self.name!r}, t0={self.t0:.6f}, {d}, "
                f"tid={self.tid}, depth={self.depth}, "
                f"parent={self.parent})")


class _Span:
    """The enabled-path span context manager (see ``Tracer.span``)."""
    __slots__ = ("_tracer", "_rec", "name", "attrs")
    enabled = True

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self._rec: Optional[SpanRecord] = None

    def __enter__(self) -> "_Span":
        tr = self._tracer
        st = tr._thread_state()
        stack = st["stack"]
        parent = stack[-1].index if stack else -1
        rec = SpanRecord(self.name, tid=st["tid"], depth=len(stack),
                         parent=parent, attrs=self.attrs)
        with tr._lock:
            rec.index = len(tr._records)
            tr._records.append(rec)
        stack.append(rec)
        self._rec = rec
        rec.t0 = time.perf_counter() - tr._epoch   # last: excludes setup
        return self

    def __exit__(self, *exc) -> bool:
        end = time.perf_counter() - self._tracer._epoch
        rec = self._rec
        rec.dur = end - rec.t0
        st = self._tracer._thread_state()
        if st["stack"] and st["stack"][-1] is rec:
            st["stack"].pop()
        return False

    def set(self, **attrs) -> None:
        """Attach/overwrite attrs on the open span (call sites use this to
        record quantities known only after the work ran — transfer bytes,
        per-shard loads — guarded by ``if sp.enabled`` so the disabled
        path never computes them)."""
        self._rec.attrs = dict(self._rec.attrs, **attrs)


class Tracer:
    """Thread-safe span collector + metrics registry for one run.

    Create one per traced run (the facade/stream/serve owners do this when
    ``cfg.trace`` is set), install with ``activate``, and read the result
    as ``spans()`` / ``metrics`` / ``export_chrome``.  Span nesting is
    tracked per-thread (each thread gets its own parent stack and a small
    stable ``tid``), records land in ONE ordered list under a re-entrant
    lock (a ``gc`` span can open inside any locked section)."""

    def __init__(self):
        self.metrics = MetricsRegistry()
        self._lock = threading.RLock()
        self._records: list = []
        self._tls = threading.local()
        self._tids: dict = {}
        self._epoch = time.perf_counter()

    def _thread_state(self) -> dict:
        st = getattr(self._tls, "state", None)
        if st is None:
            with self._lock:
                tid = self._tids.setdefault(threading.get_ident(),
                                            len(self._tids))
            st = {"tid": tid, "stack": []}
            self._tls.state = st
        return st

    def span(self, name: str, /, **attrs) -> _Span:
        """Open a span on this tracer (prefer the module-level ``span``,
        which resolves the active tracer and has the no-op fast path)."""
        return _Span(self, name, attrs)

    def spans(self) -> tuple:
        """Snapshot of every recorded span, in start order."""
        with self._lock:
            return tuple(self._records)

    def wall(self) -> float:
        """Seconds elapsed since this tracer was created."""
        return time.perf_counter() - self._epoch

    def export_chrome(self, path: str, *, extra: Optional[dict] = None
                      ) -> None:
        """Write the recorded spans as a Chrome/Perfetto ``trace.json``
        (plus this tracer's metrics under the ``"repro"`` key; ``extra``
        entries are merged into that blob)."""
        blob = {"schema_version": _schema_version(),
                "metrics": self.metrics.to_dict()}
        if extra:
            blob.update(extra)
        write_chrome(path, self.spans(), repro=blob)


def _schema_version() -> int:
    from repro_torch.obs.schema import SCHEMA_VERSION
    return SCHEMA_VERSION


def _jsonable(v):
    """Coerce an attr value to something json.dump accepts losslessly-ish
    (numpy scalars -> Python scalars, tuples survive as lists, anything
    exotic falls back to repr)."""
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    if hasattr(v, "item") and getattr(v, "ndim", 1) == 0:
        return v.item()
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return repr(v)


def write_chrome(path: str, spans, *, repro: Optional[dict] = None) -> None:
    """Write ``spans`` (SpanRecords) as Chrome/Perfetto ``trace.json``:
    one ``ph="X"`` complete event per finished span (microsecond ts/dur),
    span index/parent carried in ``args`` so ``tools/trace_report.py`` can
    rebuild the tree exactly.  ``repro`` lands under a top-level
    ``"repro"`` key trace viewers ignore."""
    events = []
    for rec in spans:
        if rec.dur is None:
            continue                    # open span: nothing to draw
        args = {k: _jsonable(v) for k, v in rec.attrs.items()}
        args["index"], args["parent"] = rec.index, rec.parent
        events.append({"name": rec.name, "ph": "X", "pid": 0,
                       "tid": rec.tid, "ts": rec.t0 * 1e6,
                       "dur": rec.dur * 1e6, "args": args})
    blob = {"traceEvents": events, "displayTimeUnit": "ms"}
    if repro is not None:
        blob["repro"] = repro
    with open(path, "w") as f:
        json.dump(blob, f)
