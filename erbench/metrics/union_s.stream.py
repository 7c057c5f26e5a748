"""Seconds a stream spends in its ``union`` span: the chunks' packed pairs
concatenated and deduplicated (``unique_packed``); the public frozensets
are ``frozensets_s.stream``'s."""
from erbench.metrics.spans import per_request


def read(reading):
    return per_request(reading, "union")
