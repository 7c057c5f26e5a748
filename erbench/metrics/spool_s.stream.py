"""Seconds a stream spends in ``spool`` spans: the disk spool's writes of
the raw chunks and the sorted runs and its reads of them, wherever they
fall (under ``ingest``, ``sort_runs`` or ``merge``); none for a program
without the span."""
from erbench.metrics.spans import per_request


def read(reading):
    return per_request(reading, "spool")
