"""Milliseconds per delta call: the ``shard_program`` spans of the
window's batches, total over calls (fenced while traced)."""


def read(reading):
    found = [s for s in reading.window.spans if s.name == "shard_program"]
    if not found:
        return None
    return 1e3 * sum(s.t1 - s.t0 for s in found) / len(found)
