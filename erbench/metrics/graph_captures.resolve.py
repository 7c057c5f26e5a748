"""Shard programs first run and captured inside the window (the
``PerfStats.traces`` of its resolves); 0 in a steady window."""


def read(reading):
    calls = reading.outcome.calls
    return sum(c["traces"] for c in calls) if calls else None
