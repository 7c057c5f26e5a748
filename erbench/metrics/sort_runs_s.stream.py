"""Seconds a stream spends in its ``sort_runs`` span: each raw chunk read
back, sorted on the device and spooled as a sorted run."""
from erbench.metrics.spans import per_request


def read(reading):
    return per_request(reading, "sort_runs")
