"""Seconds a resolve spends in the ``shard_program`` span, which the
program fences with a synchronize while traced."""
from erbench.metrics.spans import per_request


def read(reading):
    return per_request(reading, "shard_program")
