"""Milliseconds a serve request spends in ``compact`` spans: the serving
index's runs rewritten into one generation."""
from erbench.metrics.host_spans import milliseconds


def read(reading):
    return milliseconds(reading, "compact")
