"""Realized max / mean of the per-shard loads, averaged over the window's
resolves (1.0 is level)."""


def read(reading):
    ratios = [max(c["load"]) * len(c["load"]) / sum(c["load"])
              for c in reading.outcome.calls if sum(c["load"])]
    return sum(ratios) / len(ratios) if ratios else None
