"""Seconds a stream spends in ``gc`` spans: CPython's collector passes,
wherever they fall in the window."""
from erbench.metrics.host_spans import seconds


def read(reading):
    return seconds(reading, "gc")
