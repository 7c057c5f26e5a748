"""Seconds a resolve spends in ``frozensets`` spans: the public pair sets
built from the packed pairs (``api.results.packed_to_frozenset``), the
collector passes inside them included."""
from erbench.metrics.host_spans import seconds


def read(reading):
    return seconds(reading, "frozensets")
