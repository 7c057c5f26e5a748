"""Milliseconds a serve request spends in ``index`` spans: the regions
gathered from the serving index, and its insert or delete."""
from erbench.metrics.host_spans import milliseconds


def read(reading):
    return milliseconds(reading, "index")
