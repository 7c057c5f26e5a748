"""What the readers of the host spans share: a span's seconds per request,
and 0.0 where the window held none of it from a program that opens it."""
from erbench.metrics.spans import per_request

# every traced resolve and serve batch of a program with the host spans
# builds its public sets in ``frozensets`` spans; a program without them
# opens none, and its readings are left out
MARK = "frozensets"


def seconds(reading, name: str):
    """Seconds of the ``name`` spans (their whole durations) in the window
    per request; 0.0 where there were none (a short window may hold no
    collection or compaction); None for a program without the spans."""
    v = per_request(reading, name)
    if v is not None or not reading.outcome.calls:
        return v
    if any(s.name == MARK for s in reading.window.spans):
        return 0.0
    return None


def milliseconds(reading, name: str):
    """``seconds`` in milliseconds."""
    v = seconds(reading, name)
    return None if v is None else 1e3 * v
