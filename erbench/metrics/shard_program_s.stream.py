"""Seconds a stream spends in ``shard_program`` spans, its chunks' summed
(the program fences each with a synchronize while traced)."""
from erbench.metrics.spans import per_request


def read(reading):
    return per_request(reading, "shard_program")
