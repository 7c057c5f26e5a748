"""Milliseconds a serve request spends in ``gc`` spans: CPython's
collector passes on the service's worker and on the client."""
from erbench.metrics.host_spans import milliseconds


def read(reading):
    return milliseconds(reading, "gc")
