"""Seconds a stream spends in ``merge`` spans: the k-way host merge of the
sorted runs and its re-blocking into native chunks, the spool reads of
the runs it opens included."""
from erbench.metrics.spans import per_request


def read(reading):
    return per_request(reading, "merge")
