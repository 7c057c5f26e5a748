"""Seconds a resolve spends in the ``plan`` span (profile, plan, caps)."""
from erbench.metrics.spans import per_request


def read(reading):
    return per_request(reading, "plan")
