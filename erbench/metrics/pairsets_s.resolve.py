"""Seconds a resolve spends in the ``attempt`` span's own time: the public
frozensets built from the packed pairs (``PackedOutcome.to_outcome``)."""
from erbench.metrics.spans import per_request


def read(reading):
    return per_request(reading, "attempt", own=True)
