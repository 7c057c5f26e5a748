"""Seconds a resolve spends in the ``collect`` span (device output to
packed host pairs)."""
from erbench.metrics.spans import per_request


def read(reading):
    return per_request(reading, "collect")
