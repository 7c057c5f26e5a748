"""The unified stats schema — pack/unpack for the five stats types (port
of ``repro.obs.schema``; the same kinds, fields and version, so a packed
dict of either package unpacks in the other).

The five stats types (``BalanceMetrics``, ``PerfStats``, ``StreamStats``,
``ServeStats``, ``ResilienceStats``) share ONE serialization:
``pack_stats`` turns any of them into a plain JSON-able dict tagged with
its ``"kind"``, and ``unpack_stats`` reconstructs the original typed
object — a lossless round trip
(``unpack(json.loads(json.dumps(pack(x)))) == x``) that
``TraceReport.metrics()`` rides.

Imports are deliberately lazy: this module sits UNDER ``repro_torch.obs``
(a leaf every instrumented subsystem imports), so pulling
``repro_torch.api`` / ``repro_torch.serve`` in at module scope would close
an import cycle.  The class table resolves at the first ``unpack_stats``
call instead.

``SCHEMA_VERSION`` stamps every serialized artifact of the observability
layer — Chrome-trace ``"repro"`` blobs and ``TraceReport.metrics()`` — so
consumers can fail loudly on drift instead of KeyError-ing into a
half-parsed blob.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

SCHEMA_VERSION = 1

#: the stats types the unified schema covers (class name == "kind" tag)
STATS_KINDS: Tuple[str, ...] = ("BalanceMetrics", "PerfStats",
                                "StreamStats", "ServeStats",
                                "ResilienceStats")


def _plain(v):
    """JSON-able coercion: numpy scalars -> Python scalars, tuples ->
    lists (JSON has no tuple; unpack re-tuples from the class's types)."""
    if hasattr(v, "item") and getattr(v, "ndim", 1) == 0:
        return _plain(v.item())
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return v


def pack_stats(obj) -> dict:
    """One of the five typed stats objects -> plain dict tagged with its
    ``"kind"`` (the class name), every field JSON-able.  Dataclasses pack
    via ``dataclasses.asdict``, NamedTuples via ``_asdict``; anything else
    raises (the schema is a closed set — register new kinds here)."""
    kind = type(obj).__name__
    if kind not in STATS_KINDS:
        raise TypeError(
            f"{kind} is not a unified-schema stats type; known kinds: "
            f"{STATS_KINDS}")
    if dataclasses.is_dataclass(obj):
        d = dataclasses.asdict(obj)
    elif hasattr(obj, "_asdict"):
        d = dict(obj._asdict())
    else:
        raise TypeError(f"{kind} is neither a dataclass nor a NamedTuple")
    return {"kind": kind, **{k: _plain(v) for k, v in d.items()}}


def _stats_class(kind: str):
    """Resolve a ``"kind"`` tag to its class (lazy imports — see module
    doc)."""
    if kind in ("BalanceMetrics", "PerfStats"):
        from repro_torch.api import results as RES
        return getattr(RES, kind)
    if kind == "StreamStats":
        from repro_torch.stream.resolver import StreamStats
        return StreamStats
    if kind == "ServeStats":
        from repro_torch.serve.service import ServeStats
        return ServeStats
    if kind == "ResilienceStats":
        from repro_torch.resilience.retry import ResilienceStats
        return ResilienceStats
    raise KeyError(f"unknown stats kind {kind!r}; known: {STATS_KINDS}")


def _retuple(v):
    """Invert JSON's tuple->list flattening (lists become tuples,
    recursively — every sequence field on the five stats types is a
    tuple in the typed originals)."""
    if isinstance(v, list):
        return tuple(_retuple(x) for x in v)
    return v


def unpack_stats(d: dict):
    """A ``pack_stats`` dict (possibly after a JSON round trip) -> the
    original typed stats object, equal to what was packed."""
    cls = _stats_class(d["kind"])
    kw = {k: _retuple(v) for k, v in d.items() if k != "kind"}
    return cls(**kw)
