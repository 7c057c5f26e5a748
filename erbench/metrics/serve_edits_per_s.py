"""Records inserted plus records deleted per second of the window, every
request answered (one producer waiting on each call: the inverse of the
mean batch latency)."""


def read(reading):
    out = reading.outcome
    return out.edits / reading.window.seconds if out.edits else None
