"""Milliseconds a serve request spends in ``set_algebra`` spans: the
maintained pair sets restricted to the regions, differenced and united
with the regions' new pairs."""
from erbench.metrics.host_spans import milliseconds


def read(reading):
    return milliseconds(reading, "set_algebra")
