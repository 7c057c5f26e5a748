"""Seconds a stream spends in ``frozensets`` spans: the public pair sets
built from the union's packed pairs, the collector passes inside them
included."""
from erbench.metrics.host_spans import seconds


def read(reading):
    return seconds(reading, "frozensets")
