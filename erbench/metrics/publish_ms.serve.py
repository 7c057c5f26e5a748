"""Milliseconds a serve request spends in ``publish`` spans: the served
sets' update and diffs, the pair ids and the result's frozensets."""
from erbench.metrics.host_spans import milliseconds


def read(reading):
    return milliseconds(reading, "publish")
